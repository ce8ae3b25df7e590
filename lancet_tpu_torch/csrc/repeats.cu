// Repeat gates for Hopper (sm_90a): for every window and every k, whether
// the window's reference sequence repeats an exact k-mer at a later offset
// (isRepeat) or a (k+1)-long stretch with at most max_mismatch mismatches
// (isAlmostRepeat). One kernel, repeat_gates, one launch per batch. Plain
// C interface, loaded with ctypes by gpu/repeats.py; the entry point
// returns cudaGetLastError() after its launch.
//
// Replaces lancet_tpu/tpu/repeats.py::gates_impl (:37-73, an XLA lax.scan
// over the L-1 shifts that builds [W, nk, L+1] window counts at every
// shift; no Pallas). gpu/repeats.py::gates_plain is that scan step for
// step in PyTorch; this kernel computes the same function another way.
//
// For a shift s (1 <= s < len) let neq[p] = seq[p+s] != seq[p]. The scan's
// valid offsets confine an exact k-window to [0, len-1-s) and an "almost"
// (k+1)-window to [0, len-s) (the reference's quirks: the last offset
// len-k is excluded, and the almost window is k+1 long). So, with
//   Z = max_s the longest run of zeros of neq inside [0, len-1-s),
//   A = max_s the longest stretch inside [0, len-s) holding at most
//       max_mismatch ones,
//   exact[k] = Z >= k,  gates[k] = exact[k] or A > k.
// Z is -1 for a window with no shift (len < 2), A is 0 for one with no
// shift or a negative max_mismatch, so a window of length 0 is never
// gated; any k >= 0 and any max_mismatch are taken, in any order.
//
// Both verdicts are monotone in k, so clamping Z to [kmin-1, kmax] and A
// to [kmin, kmax+1] (kmin, kmax the least and largest k; Z >= 0 once len
// >= 2) keeps every verdict. A stretch then never has to be followed past
// H = kmax+1 positions (kmax without an A budget), so any split of a
// shift's window starts into tiles is exact, each tile reading H positions
// past its last start and each stretch counted by the tile of its start.
//
// Inputs: seq [W, L] uint8 (a window's bytes, latin-1, zero padded), lens
// [W] int32 (clamped to [0, L]), ks [nk] int32 (each >= 0). Outputs:
// gates, exact [W, nk] bool (one byte each, 0 or 1).
//
// What bounds it: the input is W*L bytes (3.1 MB on the default corpus);
// the function holds sum over windows of len*(len-1)/2 (shift, position)
// pairs (0.93 G there), so the SMs' integer issue rate bounds it, not
// memory; the device graph path's batches of a few hundred windows (or a
// few) must still fill the card. The design:
// 1. deals a window's (shift, start) plane evenly over the threads of a
//    cluster of S blocks (gpu/repeats.py::gates_plan picks S, the block
//    and the tile G from W, L and kmax, so that small batches still fill
//    the card): shift 1+i is paired with shift maxp-i, whose starts laid
//    end to end make maxp+1 for every pair, and tile t is the G starts
//    (t / npairs) * G ... of pair t % npairs, so every tile but a pair's
//    last holds G starts, and a warp's lanes read neighbouring shifts at
//    the same positions (broadcast and neighbouring shared words);
// 2. builds the mismatch bits 32 positions at a time: from the window's
//    two bit planes where it holds only A, C, G and T (a funnel shift and
//    an xor a plane: ~10 instructions a word), else from 32-bit words of
//    its bytes (neq32, as csrc/walks.cu's K3: a funnel shift aligns the
//    word at q + s, a carry-free byte test and a multiply gather 4 bits);
//    a thread holds two words in registers and builds up to NW (2-5, a
//    template parameter: windows up to 32*(NW-1) wide) only when a
//    window reaches them, so a tile's halo costs a word;
// 3. finds each bar by a growing window: starting at the clamp's floor
//    (kmin-1 for Z, kmin for A), a window of bar+1 bits at a start is a
//    funnel shift and a popcount; if its count is within the budget (0 for
//    Z, max_mismatch for A) the bar grows and the same start is tested
//    again, else the next count - budget - 1 starts are skipped (a count
//    drops by at most one a start; for windows wider than a word, not
//    before the start passes a mismatch). A zero run of 11 or more holds
//    two zero nibbles side by side, so a chunk of 32 starts whose two
//    words hold none tests no Z window, and a test alone in its chunk runs
//    in a lean loop: random sequence costs one A test every ~7 positions;
// 4. shares the bars over the cluster (after each tile the warp's bars,
//    pushed by one lane to every block's shared pair through distributed
//    shared memory where they grew): later tiles start from the bar
//    reached, and every thread stops once both bars reach their caps.
// The chunk's tests run before the lanes slide in a new word, so the
// lanes of a warp build their words together and only the test loops
// diverge. A k list whose widest window passes 128 positions (or a
// window too long to stage with its pad) takes NW = 0: the same tiles,
// each scanned one position at a time (a zero run and a two-pointer
// stretch from the tile's first start), for any width.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 8;
constexpr int kMaxWords = 5;  // windows up to 128 positions in registers
constexpr int kPad = 64;      // bytes past a window neq32 may read
constexpr size_t kSmemLimit = 232448;  // bytes a block may use on Hopper

// The neq bits of 32 positions: bit j = s[q + j] != s[b + j], for q = 4 *
// qw (a multiple of 16 bytes: the two 16-byte loads) and b = q + s; as
// csrc/walks.cu's neq32.
__device__ __forceinline__ uint32_t neq32(const uint32_t* __restrict__ w,
                                          int qw, int b) {
  const uint4 a0 = *reinterpret_cast<const uint4*>(w + qw);
  const uint4 a1 = *reinterpret_cast<const uint4*>(w + qw + 4);
  const uint32_t a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const uint32_t* bw = w + (b >> 2);
  const uint32_t sh = (b & 3) * 8;
  uint32_t lo = bw[0], bits = 0;
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const uint32_t hi = bw[g + 1];
    const uint32_t x = a[g] ^ __funnelshift_r(lo, hi, sh);
    // bit 7 of each byte: the byte of x is not 0 (no carry leaves a byte)
    const uint32_t m = (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
    // bits 7, 15, 23, 31 -> 28, 29, 30, 31; the cross terms stay below 24
    bits |= (m * 0x00204081u) >> 28 << (4 * g);
    lo = hi;
  }
  return bits;
}

// The same 32 bits from the window's two bit planes (A, C, G and T only:
// code (byte >> 1) & 3, one per base; pl[i] holds bit 0 and bit 1 of the
// codes of positions 32 i ... 32 i + 31): two bases are equal exactly
// when both planes agree. q is a multiple of 32, b = q + s.
__device__ __forceinline__ uint32_t neq32_planes(const uint2* __restrict__ pl,
                                                 int q, int b) {
  const uint2 a = pl[q >> 5];
  const uint2 b0 = pl[b >> 5], b1 = pl[(b >> 5) + 1];
  const uint32_t sh = b & 31;
  return (a.x ^ __funnelshift_r(b0.x, b1.x, sh)) |
         (a.y ^ __funnelshift_r(b0.y, b1.y, sh));
}

// The ones among bits [r, r + width) of the words x (bit j of x[i] is
// position 32 i + j); 0 <= r < 32, 1 <= width <= 32 * (NW - 1).
template <int NW>
__device__ __forceinline__ int window_count(const uint32_t (&x)[NW], int r,
                                            int width) {
  int c = 0;
#pragma unroll
  for (int i = 0; i + 1 < NW; ++i) {
    const int rem = width - 32 * i;
    if (rem > 0) {
      const uint32_t v = __funnelshift_r(x[i], x[i + 1], r);
      c += __popc(rem >= 32 ? v : v & ((1u << rem) - 1u));
    }
  }
  return c;
}

// The longest stretch from bit r of the words x holding at most budget
// ones (budget >= 0), up to 32 * (NW - 1) bits.
template <int NW>
__device__ __forceinline__ int run_from(const uint32_t (&x)[NW], int r,
                                        int budget) {
  int run = 0;
#pragma unroll
  for (int i = 0; i + 1 < NW; ++i) {
    uint32_t v = __funnelshift_r(x[i], x[i + 1], r);
    const int c = __popc(v);
    if (c <= budget) {
      budget -= c;
      run += 32;
      continue;
    }
    for (int k = 0; k < budget; ++k) v &= v - 1u;  // past budget ones
    return run + __ffs(v) - 1;
  }
  return run;
}

// Work counters of a thread (the plan's count for the card's bound): the
// mismatch words built from bytes (NW = 0: positions scanned), the window
// tests, and the words built from bit planes.
struct Work {
  unsigned words = 0, tests = 0, plane_words = 0;
};

// Whether bits [0, 64) of x0:x1 hold two zero nibbles side by side (at
// positions 4i .. 4i+7): every run of 11 or more zeros does, so a chunk
// without them holds no start of a zero run of 11 to 32.
__device__ __forceinline__ bool zero_pair(uint32_t x0, uint32_t x1) {
  uint32_t t0 = x0 | (x0 >> 1), t1 = x1 | (x1 >> 1);
  t0 |= t0 >> 2;
  t1 |= t1 >> 2;
  const uint32_t z0 = ~t0 & 0x11111111u, z1 = ~t1 & 0x11111111u;
  return ((z0 & (z0 >> 4)) | (z1 & (z1 >> 4)) | ((z0 >> 28) & z1)) != 0;
}

// One tile of shift s: the window starts [pstart, pend), raising the bars
// bz (Z, capped at zcap) and ba (A, capped at acap). Word j of the tile
// holds positions p0 + 32 j ... (p0 <= pstart < p0 + 32, p0 a multiple of
// 32); a word at or past the almost region's end ea is never inside a
// tested window and is left unbuilt, all ones (mismatches: it passes no
// filter). A thread holds x[0] and x[1], and the words past them only
// once a window wider than one word reaches them. The tests of a chunk
// of 32 starts (x[0]'s) run first, then every lane still in its tile
// slides in one new word: the lanes of a warp build their words together
// (one broadcast word and consecutive words of shared memory), and only
// the short test loop diverges.
template <int NW, bool kPlanes>
__device__ __forceinline__ void scan_tile(const uint32_t* __restrict__ sw,
                                          const uint2* __restrict__ pl,
                                          int s, int n, int p0, int pstart,
                                          int pend, int mm, int zcap,
                                          int acap, int& bz, int& ba,
                                          Work& work) {
  const int ez = n - 1 - s, ea = n - s;  // the exact and almost regions
  const int qw = p0 >> 2;
  uint32_t x[NW];
  int next = 0;  // the next word to build
  auto build = [&]() -> uint32_t {
    const int q = p0 + 32 * next;
    const int j = next++;
    if (q >= ea) return ~0u;
    if constexpr (kPlanes) {
      ++work.plane_words;
      return neq32_planes(pl, q, q + s);
    } else {
      ++work.words;
      return neq32(sw, qw + 8 * j, q + s);
    }
  };
  // x[0] and x[1] are always built; x[2..] only when a window reaches them
#pragma unroll
  for (int j = 2; j < NW; ++j) x[j] = ~0u;
  x[0] = build();
  x[1] = build();
  int have = 2;
  // the last start whose window of the bar's width fits (-1: none), and
  // the widths' masks where both fit in one word
  int zlim, alim;
  uint32_t mz, ma;
  auto widths = [&]() {
    zlim = bz < zcap ? ez - (bz + 1) : -1;
    alim = ba < acap ? ea - (ba + 1) : -1;
    mz = bz + 1 <= 32 ? 0xffffffffu >> (31 - bz) : 0u;
    ma = ba + 1 <= 32 ? 0xffffffffu >> (31 - ba) : 0u;
  };
  widths();
  int base = p0;       // x[0]'s first position
  int r = pstart - p0;  // the start tested, base + r
  for (;;) {
    // the starts of x[0]'s chunk; past the tile or past both limits (the
    // widths only grow) no later start fits. A zero run of 11 to 32 bits
    // starting in the chunk lies in x[0]:x[1] and needs a zero-nibble
    // pair there: without one the chunk's Z tests are skipped.
    int p = base + r;
    const bool zskip = bz + 1 >= 11 && mz != 0 && !zero_pair(x[0], x[1]);
    if (zskip) zlim = -1;
    // one test alone in the chunk, its window in one word (the common
    // case: Z filtered out): skip its failing starts in a lean loop, and
    // leave a start that passes to the loop below, which raises the bar
    if (zlim < p && ma != 0) {
      const int lim = min(pend - 1, alim);
      while (r < 32 && p <= lim) {
        ++work.tests;
        const int c = __popc(__funnelshift_r(x[0], x[1], r) & ma);
        if (c <= mm) break;
        r += c - mm;
        p += c - mm;
      }
    } else if (alim < p && mz != 0) {
      const int lim = min(pend - 1, zlim);
      while (r < 32 && p <= lim) {
        ++work.tests;
        const int c = __popc(__funnelshift_r(x[0], x[1], r) & mz);
        if (c == 0) break;
        r += c;
        p += c;
      }
    }
    while (r < 32 && p < pend && (p <= zlim || p <= alim)) {
      int step = INT_MAX;
      int cz, ca;
      const uint32_t v = __funnelshift_r(x[0], x[1], r);
      if ((mz != 0 || zlim < p) && (ma != 0 || alim < p)) {
        // both windows in one word (a test without a limit is not used)
        cz = __popc(v & mz);
        ca = __popc(v & ma);
      } else {
        // a wider window: build the words it reaches
        const int need = min((r + max(p <= zlim ? bz + 1 : 0,
                                      p <= alim ? ba + 1 : 0) + 31) >> 5,
                             NW);
#pragma unroll
        for (int j = 2; j < NW; ++j)
          if (j >= have && j < need) x[j] = build();
        have = max(have, need);
        cz = p <= zlim ? window_count<NW>(x, r, bz + 1) : 0;
        ca = p <= alim ? window_count<NW>(x, r, ba + 1) : 0;
      }
      // a window that passes raises its bar to the whole run or stretch
      // from p (every word built: up to 32 * (NW - 1), the region's end
      // and the cap; at least by one), and the same start is tested again
      if (p <= zlim) {
        ++work.tests;
        if (cz == 0) {
#pragma unroll
          for (int j = 2; j < NW; ++j)
            if (j >= have) x[j] = build();
          have = NW;
          bz = max(bz + 1, min(min(run_from<NW>(x, r, 0), ez - p), zcap));
          widths();
          continue;
        }
        step = cz;
      }
      if (p <= alim) {
        ++work.tests;
        if (ca <= mm) {
#pragma unroll
          for (int j = 2; j < NW; ++j)
            if (j >= have) x[j] = build();
          have = NW;
          ba = max(ba + 1, min(min(run_from<NW>(x, r, mm), ea - p), acap));
          widths();
          continue;
        }
        step = min(step, ca - mm);
      }
      // nor can a start before the first mismatch from p pass (this loop
      // holds the wide windows, which would crawl through a near repeat)
      step = max(step, __ffs(v));
      r += step;
      p += step;
    }
    if (zskip) {  // the chunk's Z tests were skipped: Z goes on after it
      zlim = bz < zcap ? ez - (bz + 1) : -1;
      if (r < 32) {
        r = 32;
        p = base + 32;
      }
    }
    if (r < 32 || p >= pend || (p > zlim && p > alim)) break;
#pragma unroll
    for (int j = 0; j + 1 < NW; ++j) x[j] = x[j + 1];
    if (--have < 2) {
      x[1] = build();
      have = 2;
    }
    base += 32;
    r -= 32;
  }
}

// The same tile one position at a time, for any width: the zero run and
// the stretch with at most mm ones ending at p, both starting at p0 or
// later, up to the last position a window starting before pend can reach.
__device__ __forceinline__ void scan_tile_plain(
    const uint8_t* __restrict__ sq, int s, int n, int p0, int pend, int mm,
    int zcap, int acap, int& bz, int& ba, Work& work) {
  const int zend = min(n - 1 - s, pend - 1 + zcap);
  const int aend = min(n - s, pend - 1 + acap);
  const int end = max(zend, aend);
  int run = 0;
  int left = p0, cnt = 0;
  for (int p = p0; p < end && (bz < zcap || ba < acap); ++p) {
    ++work.words;
    const bool ne = sq[p + s] != sq[p];
    if (p < zend) {
      run = ne ? 0 : run + 1;
      bz = max(bz, min(run, zcap));
    }
    if (p < aend && ba < acap) {
      cnt += ne;
      while (cnt > mm) {
        cnt -= sq[left + s] != sq[left];
        ++left;
      }
      ba = max(ba, min(p - left + 1, acap));
    }
  }
}

template <int NW>
__global__ void __launch_bounds__(kMaxThreads)
    repeat_gates_kernel(const uint8_t* __restrict__ seq,
                        const int32_t* __restrict__ lens,
                        const int32_t* __restrict__ ks,
                        uint8_t* __restrict__ gates,
                        uint8_t* __restrict__ exact,
                        unsigned long long* __restrict__ work_out, int L,
                        int nk, int mm, int kmin, int kmax, int G) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) uint32_t sw[];
  __shared__ int best[2];  // the cluster's bars: Z, A
  uint8_t* sq = reinterpret_cast<uint8_t*>(sw);
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int w = blockIdx.x / S;  // a cluster a window
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int n = min(max(lens[w], 0), L);
  uint8_t* g = gates + static_cast<size_t>(w) * nk;
  uint8_t* e = exact + static_cast<size_t>(w) * nk;
  if (n < 2) {  // no shift: Z = -1, A = 0, nothing gated (whole cluster)
    if (rank == 0)
      for (int j = tid; j < nk; j += T) g[j] = e[j] = 0;
    return;
  }
  // the bars at the clamp's floor, and their caps; without a budget A
  // stays 0 (its cap 0)
  const int zcap = kmax, acap = mm >= 0 ? kmax + 1 : 0;
  int bz = max(kmin - 1, 0), ba = mm >= 0 ? kmin : 0;
  // shift s holds the starts [0, maxp - s] of the first windows: Z's bz+1
  // bits inside [0, n-1-s), A's ba+1 inside [0, n-s)
  const int c0 = min(bz < zcap ? bz + 2 : INT_MAX, ba < acap ? ba + 1
                                                            : INT_MAX);
  const int maxp = c0 == INT_MAX ? 0 : n - c0;

  const uint8_t* row = seq + static_cast<size_t>(w) * L;
  bool acgt = true;
  for (int i = tid; i < n; i += T) {
    const uint8_t b = row[i];
    sq[i] = b;
    acgt &= b == 'A' || b == 'C' || b == 'G' || b == 'T';
  }
  if constexpr (NW > 0)
    for (int i = n + tid; i < n + kPad; i += T) sq[i] = 0;
  if (tid == 0) {
    best[0] = bz;
    best[1] = ba;
  }
  // a window of A, C, G and T only (the whole cluster decides alike) also
  // takes the two bit planes of its 2-bit codes, after the bytes
  uint2* pl = nullptr;
  if constexpr (NW > 0) {
    if (__syncthreads_and(acgt)) {
      pl = reinterpret_cast<uint2*>(sw + (n + kPad + 15) / 16 * 4);
      for (int i = tid; i < (n + kPad) / 32; i += T) {  // within the pad
        uint32_t lo = 0, hi = 0;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const uint32_t c = sq[32 * i + j] >> 1;
          lo |= (c & 1u) << j;
          hi |= ((c >> 1) & 1u) << j;
        }
        pl[i] = make_uint2(lo, hi);
      }
    }
  }
  cluster.sync();  // staged, and every bar set before any block raises it
  volatile int* vbest = best;
  Work work;
  // pair i: shifts s1 = 1+i and s2 = maxp-i, whose starts (maxp-i and
  // i+1; s2's none where s2 = s1) laid end to end make maxp+1; tile k of
  // a pair is [kG, (k+1)G) of that line
  const int npairs = (maxp + 1) / 2;
  const int tpp = (maxp + G) / G;
  const int ntiles = maxp >= 1 ? npairs * tpp : 0;
  for (int t = rank * T + tid; t < ntiles; t += S * T) {
    bz = max(bz, vbest[0]);
    ba = max(ba, vbest[1]);
    if (bz >= zcap && ba >= acap) break;  // every verdict is known
    const int pair = t % npairs;
    const int a = (t / npairs) * G;
    const int s1 = 1 + pair, s2 = maxp - pair;
    const int c1 = maxp - pair;              // s1's starts
    const int c2 = s2 == s1 ? 0 : pair + 1;  // s2's starts
    const int b = min(a + G, c1 + c2);
    for (int half = 0; half < 2; ++half) {
      const int s = half ? s2 : s1;
      const int lo = half ? max(a - c1, 0) : a;
      const int hi = half ? b - c1 : min(b, c1);
      if (lo >= hi) continue;
      if constexpr (NW > 0) {
        if (pl != nullptr)
          scan_tile<NW, true>(sw, pl, s, n, lo & ~31, lo, hi, mm, zcap,
                              acap, bz, ba, work);
        else
          scan_tile<NW, false>(sw, pl, s, n, lo & ~31, lo, hi, mm, zcap,
                               acap, bz, ba, work);
      } else {
        scan_tile_plain(sq, s, n, lo, hi, mm, zcap, acap, bz, ba, work);
      }
    }
    // the warp's bars; its first lane raises every block's where they
    // grew (one push a warp: remote atomics on two words serialize)
    const unsigned act = __activemask();
    bz = __reduce_max_sync(act, bz);
    ba = __reduce_max_sync(act, ba);
    if ((bz > vbest[0] || ba > vbest[1]) && (tid & 31) == __ffs(act) - 1) {
      for (int q = 0; q < S; ++q) {
        int* bb = cluster.map_shared_rank(best, q);
        atomicMax(bb, bz);
        atomicMax(bb + 1, ba);
      }
    }
  }
  if (work_out != nullptr) {
    atomicAdd(work_out, static_cast<unsigned long long>(work.words));
    atomicAdd(work_out + 1, static_cast<unsigned long long>(work.tests));
    atomicAdd(work_out + 2,
              static_cast<unsigned long long>(work.plane_words));
  }
  cluster.sync();  // the bars final; no block's memory is used after it
  if (rank == 0) {
    const int mz = best[0], ma = best[1];
    for (int j = tid; j < nk; j += T) {
      const int k = ks[j];
      const bool ex = mz >= k;
      e[j] = ex;
      g[j] = ex || ma > k;
    }
  }
}

template <int NW>
int launch(const void* seq, const void* lens, const void* ks, void* gates,
           void* exact, void* work, int W, int L, int nk, int mm, int kmin,
           int kmax, int blocks, int threads, int tile, size_t smem,
           cudaStream_t stream) {
  auto* kern = repeat_gates_kernel<NW>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(W * blocks));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(blocks);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int rc = static_cast<int>(cudaLaunchKernelEx(
      &cfg, kern, static_cast<const uint8_t*>(seq),
      static_cast<const int32_t*>(lens), static_cast<const int32_t*>(ks),
      static_cast<uint8_t*>(gates), static_cast<uint8_t*>(exact),
      static_cast<unsigned long long*>(work), L, nk, mm, kmin, kmax, tile));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// A block's dynamic shared memory (gpu/repeats.py::gates_smem computes the
// same): the window's bytes, rounded to 16, and, where words are built,
// kPad zeroed bytes past them and the two bit planes of as many positions.
size_t repeat_gates_smem(int L, int words) {
  if (words == 0) return (static_cast<size_t>(L) + 15) / 16 * 16;
  const size_t n = static_cast<size_t>(L) + kPad;
  return (n + 15) / 16 * 16 + (n + 31) / 32 * 8;
}

// One launch for W windows of width L and nk values of k, kmin and kmax
// their least and largest (both clamped to L + 1 by the caller); words
// 2-5 (windows up to 32 * (words - 1) wide: at least kmax + 1, or kmax
// for a negative max_mismatch) or 0 (the plain scan); a cluster of blocks
// (1-8) of threads (a multiple of 32, at most 1,024) a window; tiles of
// tile window starts (a multiple of 32); smem from repeat_gates_smem.
// work, where not null, is 3 unsigned 64-bit counters the kernel adds its
// words built from bytes (positions, for the plain scan), window tests and
// words built from bit planes to. Returns a
// cudaError_t (cudaErrorInvalidValue for arguments the kernel does not
// take).
int repeat_gates(const void* seq, const void* lens, const void* ks,
                 void* gates, void* exact, void* work, int W, int L, int nk,
                 int max_mismatch, int kmin, int kmax, int words, int blocks,
                 int threads, int tile, size_t smem, void* stream) {
  if (W < 1 || L < 1 || nk < 1 || kmin < 0 || kmin > kmax || kmax > L + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int widest = max_mismatch >= 0 ? kmax + 1 : kmax;
  if (blocks < 1 || blocks > kMaxCluster || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || tile < 32 ||
      tile % 32 != 0 || smem != repeat_gates_smem(L, words) ||
      smem > kSmemLimit - 16 ||
      static_cast<long long>(W) * blocks > INT_MAX ||
      (words != 0 && (words < 2 || words > kMaxWords ||
                      32 * (words - 1) < widest)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GATES_LAUNCH(NW_)                                                  \
  case NW_:                                                                \
    return launch<NW_>(seq, lens, ks, gates, exact, work, W, L, nk,        \
                       max_mismatch, kmin, kmax, blocks, threads, tile, smem, \
                       st);
  switch (words) {
    GATES_LAUNCH(0)
    GATES_LAUNCH(2)
    GATES_LAUNCH(3)
    GATES_LAUNCH(4)
    GATES_LAUNCH(5)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GATES_LAUNCH
}

}  // extern "C"
