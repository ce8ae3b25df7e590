// One window's unitig compression pass as a __device__ function of one
// block: the body of compress_kernel (csrc/compress.cu, whose head comment
// sets out the design) and of the compress rounds of tip_fixpoint
// (csrc/cleanup.cu). Built with -DCOMPRESS_STAMPS, each block also writes
// its clock64 at its start and at the end of each phase to a.stamps.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <utility>

namespace compress {


__host__ __device__ constexpr size_t round16(size_t x) {
  return (x + 15) / 16 * 16;
}

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <class T>
__device__ __forceinline__ T clampv(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// int64 sums and differences mod 2^64, as torch's int64 arithmetic
__device__ __forceinline__ long long add64(long long x, long long y) {
  return static_cast<long long>(static_cast<unsigned long long>(x) +
                                static_cast<unsigned long long>(y));
}

__device__ __forceinline__ long long sub64(long long x, long long y) {
  return static_cast<long long>(static_cast<unsigned long long>(x) -
                                static_cast<unsigned long long>(y));
}

constexpr size_t kSmemLimit = 232448;  // bytes a block may use on Hopper
// 512 threads a block leave each 128 registers: a block takes up to ~200
// KB of shared memory, so the L1 left cannot hold the local memory of
// spilled registers, whose loads would each go to L2
constexpr int kThreads = 512;
constexpr int kU = 4;          // loads in flight a thread, streaming loops
constexpr int kUI = 2;         // items a thread, the aggregates' loads
constexpr int kDBits = 13;     // dist bits of a pointer-jumping word
constexpr int kDMask = (1 << kDBits) - 1;
constexpr int kMaxStates = 1 << 18;  // state ids fit the packed word
constexpr long long kBig = 1LL << 30;
constexpr int kOkb = 14;       // okey bits of the edge renorm's key
constexpr long long kOkMax = (1LL << kOkb) - 1;
constexpr int kPhases = 16;    // clock64 stamps of the stamped build
#ifdef COMPRESS_STAMPS
constexpr bool kStamps = true;
#else
constexpr bool kStamps = false;
#endif
constexpr int kLanes = 8;      // item aggregates: merlen, csum[4], n_t, T, N
constexpr int kScanWarps = 8;  // warps a block scan runs on
// dynamic shared memory a block may take beside the scans' static arrays
constexpr size_t kDynLimit =
    kSmemLimit - kLanes * 32 * 8 - kLanes * kScanWarps * 32 * 8;

// item flags
constexpr uint32_t fAlive = 1, fSpecial = 2, fTandem = 4, fValid0 = 8,
                   fValid1 = 16, fFlip = 32, fAu = 64;

// Byte offsets of a block's dynamic shared memory (gpu/compress.py::
// compress_smem computes the same). Kept for the whole block: the items'
// flags, label, survivor, pos_u (int32), start_off and merlen (int64).
// Then one scratch region that each stage lays out for itself:
// - links, pointer jumping, merge: two state-word buffers, the per-label
//   min and max, the items' combo words;
// - items: the sort's keys and indices, run starts, each item's sorted
//   position, run ends, the labels' counts, eight lanes of inclusive sums,
//   the run base;
// - mers: the sort's keys and indices, run starts, run ends, widths (then
//   `before`), inclusive sums, the run base, `after`, the 64-bit mtot, the
//   member items' counts, each mer's item and rank;
// - edges: each edge's slot; the sources' degrees, cursors and offsets,
//   the buckets, each edge's clamped okey and source.
struct Layout {
  size_t fl, lab, sit, posu, soff, iml, scr;
  // links / jump / merge
  size_t p0, p1, cmin, citems, combo;
  // items
  size_t ik, ix, inr, kpos, rend, icnt, lanes, irb;
  size_t lane_ld;  // int64 elements between lanes
  // mers
  size_t mk, mx, mnr, mrend, wb, cw, mrb, maft, mtot, mcnt, mmi, mr;
  // edges
  size_t slot, deg, curs, off, bkt, ok2e, esrc;
  size_t total;
};

__host__ __device__ inline Layout layout(int NI, int EE, int NM) {
  Layout L{};
  const size_t ni = NI, ee = EE, nm = NM, S = 2 * ni;
  const size_t pi = pow2_at_least(NI), pm = pow2_at_least(NM);
  size_t o = 0;
  L.fl = o;   o += round16(4 * ni);
  L.lab = o;  o += round16(4 * ni);
  L.sit = o;  o += round16(4 * ni);
  L.posu = o; o += round16(4 * ni);
  L.soff = o; o += round16(8 * ni);
  L.iml = o;  o += round16(8 * ni);
  L.scr = o;
  size_t s = 0, need = 0;
  // links, pointer jumping, merge
  L.p0 = s;     s += round16(4 * S);
  L.p1 = s;     s += round16(4 * S);
  L.cmin = s;   s += round16(8 * ni);
  L.citems = s; s += round16(4 * ni);
  L.combo = s;  s += round16(8 * ni);
  need = s;
  // items
  s = 0;
  L.ik = s;    s += round16(8 * pi);
  L.ix = s;    s += round16(4 * pi);
  L.inr = s;   s += round16(ni);
  L.kpos = s;  s += round16(4 * ni);
  L.rend = s;  s += round16(4 * ni);
  L.icnt = s;  s += round16(4 * ni);
  L.lane_ld = round16(8 * ni) / 8;
  L.lanes = s; s += kLanes * round16(8 * ni);
  L.irb = s;   s += round16(8 * ni);
  need = s > need ? s : need;
  // mers
  s = 0;
  L.mk = s;    s += round16(8 * pm);
  L.mx = s;    s += round16(4 * pm);
  L.mnr = s;   s += round16(nm);
  L.mrend = s; s += round16(4 * nm);
  L.wb = s;    s += round16(8 * nm);
  L.cw = s;    s += round16(8 * nm);
  L.mrb = s;   s += round16(8 * nm);
  L.maft = s;  s += round16(8 * nm);
  L.mtot = s;  s += round16(8 * ni);
  L.mcnt = s;  s += round16(4 * ni);
  L.mmi = s;   s += round16(4 * nm);
  L.mr = s;    s += round16(8 * nm);
  need = s > need ? s : need;
  // edges
  s = 0;
  L.slot = s; s += round16(4 * ee);
  L.deg = s;  s += round16(4 * ni);
  L.curs = s; s += round16(4 * ni);
  L.off = s;  s += round16(8 * ni);
  L.bkt = s;  s += round16(4 * ee);
  L.ok2e = s; s += round16(4 * ee);
  L.esrc = s; s += round16(4 * ee);
  need = s > need ? s : need;
  L.total = o + need;
  return L;
}

// Inclusive scans, in place, of nl <= kLanes arrays of n int64 (lane l at
// a + l * ld): sums mod 2^64 or running maxima, all behind the same two
// barriers. The first kScanWarps warps take contiguous chunks of
// ceil(n / (32 kScanWarps)) elements, scan them serially, scan the chunks'
// totals across each warp with shuffles (kept in `part` [kLanes * 32
// kScanWarps]), and add the warps before theirs from `red` [kLanes * 32];
// the other warps wait at the barriers. One copy, not inlined, and the
// lanes in a loop: a block runs each stretch of its code about once, so
// code a call site or a lane would add costs its fetch.
template <bool kMax>
__device__ __noinline__ void block_scan(long long* a, size_t ld, int nl,
                                        int n, long long* red,
                                        long long* part) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  constexpr int kT = kScanWarps * 32;
  const long long ident = kMax ? LLONG_MIN : 0;
  auto op = [](long long x, long long y) -> long long {
    if (kMax) return x > y ? x : y;
    return add64(x, y);
  };
  const int c = (n + kT - 1) / kT;
  const int lo = min(tid * c, n), hi = min(lo + c, n);
  if (wid < kScanWarps) {
#pragma unroll 1
    for (int l = 0; l < nl; ++l) {
      long long* row = a + l * ld;
      long long incl = ident;
      for (int i = lo; i < hi; ++i) {
        incl = op(incl, row[i]);
        row[i] = incl;
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl = op(y, incl);
      }
      part[l * kT + tid] = incl;
      if (lane == 31) red[l * 32 + wid] = incl;
    }
  }
  __syncthreads();
  if (wid < kScanWarps) {
#pragma unroll 1
    for (int l = 0; l < nl; ++l) {
      long long* row = a + l * ld;
      long long pre = ident;
      for (int w = 0; w < wid; ++w) pre = op(pre, red[l * 32 + w]);
      if (lane) pre = op(pre, part[l * kT + tid - 1]);
      for (int i = lo; i < hi; ++i) row[i] = op(pre, row[i]);
    }
  }
  __syncthreads();
}

// Bitonic sort of P (a power of two) (key, index) pairs ascending, in
// place; with distinct indices this is the stable sort of the keys. Ends
// with a barrier.
__device__ __noinline__ void block_sort(long long* key, int* idx, int P) {
  for (int k = 2; k <= P; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < (P >> 1); i += blockDim.x) {
        const int x = ((i & ~(j - 1)) << 1) | (i & (j - 1)), y = x + j;
        const long long kx = key[x], ky = key[y];
        const int ix = idx[x], iy = idx[y];
        const bool gt = kx > ky || (kx == ky && ix > iy);
        if (gt == ((x & k) == 0)) {
          key[x] = ky;
          key[y] = kx;
          idx[x] = iy;
          idx[y] = ix;
        }
      }
      __syncthreads();
    }
}

// Run structure of n sorted keys (a run: equal key >> shift): nr[k] the
// run-start flag, then key[k] := the start of k's run, rend[start] := its
// last position. Overwrites the keys; ends with a barrier.
__device__ __noinline__ void runs(long long* key, int n, int shift,
                                  uint8_t* nr, int* rend, long long* red,
                                  long long* part) {
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    nr[k] = k == 0 || (key[k] >> shift) != (key[k - 1] >> shift);
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += blockDim.x) key[k] = nr[k] ? k : 0;
  __syncthreads();
  block_scan<true>(key, 0, 1, n, red, part);
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    if (k == n - 1 || nr[k + 1]) rend[key[k]] = k;
  __syncthreads();
}

struct Args {
  // inputs [W, NI] / [W, NI, 4] / [W, EE] / [W, NM]
  const uint8_t* alive;
  const uint8_t* special;
  const int64_t* rank;
  const int64_t* merlen;
  const int64_t* csum;
  const int64_t* n_t;
  const uint8_t* is_tumor;
  const uint8_t* is_normal;
  const int64_t* e_src;
  const int64_t* e_dst;
  const int64_t* e_dir;
  const uint8_t* e_alive;
  const int64_t* e_okey;
  const int64_t* mer_item;
  const uint8_t* mer_flip;
  const int64_t* mer_pos;
  const int64_t* keep_lo;
  const int64_t* keep_hi;
  // outputs, the same shapes, and fallback [W]
  uint8_t* o_alive;
  int64_t* o_merlen;
  int64_t* o_csum;
  int64_t* o_n_t;
  uint8_t* o_is_tumor;
  uint8_t* o_is_normal;
  int64_t* o_e_src;
  int64_t* o_e_dst;
  int64_t* o_e_dir;
  uint8_t* o_e_alive;
  int64_t* o_e_okey;
  int64_t* o_mer_item;
  uint8_t* o_mer_flip;
  int64_t* o_mer_pos;
  int64_t* o_keep_lo;
  int64_t* o_keep_hi;
  uint8_t* o_fallback;
  long long* stamps;  // [W, kPhases] clock64 at each phase's end (stamped)
  int NI, EE, NM, rounds, dcap;
  long long N, K, Dcap;
};

// Item i's aggregate G (merlen, csum[0..3], n_t, is_tumor, is_normal), and
// its output from its run's total `tot`.
template <int G>
__device__ __forceinline__ long long lane_value(const Args& a, size_t i) {
  if constexpr (G == 0) return a.merlen[i];
  else if constexpr (G <= 4) return a.csum[i * 4 + (G - 1)];
  else if constexpr (G == 5) return a.n_t[i];
  else if constexpr (G == 6) return a.is_tumor[i];
  else return a.is_normal[i];
}

template <int G>
__device__ __forceinline__ void lane_store(const Args& a, size_t i,
                                           long long tot, bool surv) {
  if constexpr (G == 0) {
    a.o_merlen[i] = tot;
    a.o_alive[i] = surv;
  } else if constexpr (G <= 4) {
    a.o_csum[i * 4 + (G - 1)] = tot;
  } else if constexpr (G == 5) {
    a.o_n_t[i] = tot;
  } else if constexpr (G == 6) {
    a.o_is_tumor[i] = tot > 0;
  } else {
    a.o_is_normal[i] = tot > 0;
  }
}

// the eight aggregates of item i, every index known at compile time (a
// runtime one would put the values in local memory)
template <int... L>
__device__ __forceinline__ void load_lanes(const Args& a, size_t i,
                                           long long* x,
                                           std::integer_sequence<int, L...>) {
  ((x[L] = lane_value<L>(a, i)), ...);
}

template <int... L>
__device__ __forceinline__ void store_lanes(const Args& a, size_t i,
                                            const long long* tot, bool surv,
                                            std::integer_sequence<int, L...>) {
  (lane_store<L>(a, i, tot[L], surv), ...);
}

// The pointer jumping's bound, as the plain loop's: 2^rounds reaches dcap.
__host__ inline void jump_bounds(int NI, int* rounds, int* dcap) {
  int bits = 0;
  for (long long v = NI + 8; v > 0; v >>= 1) ++bits;
  *rounds = bits > 2 ? bits : 2;
  *dcap = NI + 8 < kDMask ? NI + 8 : kDMask;
}

// The pass on window w, by a block of kThreads threads, its dynamic shared
// memory at smem (layout(NI, EE, NM).total bytes). Returns the window's
// fallback to every thread, and writes it to a.o_fallback[w] unless that is
// null. Every load of an input comes before the store of the same element
// to an output, behind a barrier where another thread stores it (each
// stage reads what it needs into shared memory before the next writes):
// a caller may pass one state as both the inputs and the outputs.
__device__ __forceinline__ bool body(const Args& a, int w,
                                     unsigned char* smem) {
  __shared__ long long red[kLanes * 32];
  __shared__ long long part[kLanes * kScanWarps * 32];
  const int tid = threadIdx.x, T = blockDim.x;
  const int NI = a.NI, EE = a.EE, NM = a.NM, S = 2 * NI;
  const Layout L = layout(NI, EE, NM);
  uint32_t* fl = reinterpret_cast<uint32_t*>(smem + L.fl);
  int* lab = reinterpret_cast<int*>(smem + L.lab);
  int* sit = reinterpret_cast<int*>(smem + L.sit);
  int* posu = reinterpret_cast<int*>(smem + L.posu);
  long long* soff = reinterpret_cast<long long*>(smem + L.soff);
  long long* iml = reinterpret_cast<long long*>(smem + L.iml);
  unsigned char* scr = smem + L.scr;
  const size_t io = static_cast<size_t>(w) * NI,
               eo = static_cast<size_t>(w) * EE,
               mo = static_cast<size_t>(w) * NM;
  auto stamp = [&](int ph) {
    if (kStamps && tid == 0)
      a.stamps[static_cast<size_t>(w) * kPhases + ph] = clock64();
  };
  stamp(0);

  // ---- links ------------------------------------------------------------
  int* p0 = reinterpret_cast<int*>(scr + L.p0);  // counts, then words
  int* p1 = reinterpret_cast<int*>(scr + L.p1);  // (dst, dest bit) words
  long long* combo = reinterpret_cast<long long*>(scr + L.combo);
  for (int i0 = tid; i0 < NI; i0 += T * kU) {
    uint8_t al[kU], sp[kU];
    long long rk[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * T;
      const bool in = i < NI;
      al[u] = in ? a.alive[io + i] : 0;
      sp[u] = in ? a.special[io + i] : 0;
      rk[u] = in ? a.rank[io + i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * T;
      if (i >= NI) break;
      fl[i] = (al[u] ? fAlive : 0u) | (sp[u] ? fSpecial : 0u);
      const long long r = rk[u] < a.N ? rk[u] : a.N;
      combo[i] = al[u] ? static_cast<long long>(
                             static_cast<unsigned long long>(r) * NI + i)
                       : kBig;
    }
  }
  for (int s = tid; s < S; s += T) p0[s] = 0;
  __syncthreads();
  for (int e0 = tid; e0 < EE; e0 += T * kU) {
    uint8_t al[kU];
    long long src[kU], dst[kU], dir[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * T;
      const bool in = e < EE;
      al[u] = in ? a.e_alive[eo + e] : 0;
      src[u] = in ? a.e_src[eo + e] : 0;
      dst[u] = in ? a.e_dst[eo + e] : 0;
      dir[u] = in ? a.e_dir[eo + e] : 0;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (!al[u]) continue;
      const int st = static_cast<int>(
          clampv<long long>(src[u] * 2 + (dir[u] >> 1), 0, S - 1));
      atomicAdd(&p0[st], 1);
      p1[st] = static_cast<int>(
          clampv<long long>(dst[u] * 2 + (dir[u] & 1), 0, S - 1));
      if (src[u] == dst[u])
        atomicOr(&fl[clampv<long long>(src[u], 0, NI - 1)], fTandem);
    }
  }
  __syncthreads();
  // a state's link: its one alive edge, to another regular item whose one
  // edge in the other direction comes back
  for (int i = tid; i < NI; i += T) {
    const uint32_t f = fl[i];
    uint32_t add = 0;
    if ((f & (fAlive | fSpecial | fTandem)) == fAlive) {
#pragma unroll
      for (int bit = 0; bit < 2; ++bit) {
        const int s = 2 * i + bit;
        if (p0[s] != 1) continue;
        const int v = p1[s] >> 1, b = p1[s] & 1;
        if (v == i) continue;
        const int vs = clampv(v, 0, NI - 1);
        if (fl[vs] & (fSpecial | fTandem)) continue;
        const int g = vs * 2 + (1 - b);
        if (p0[g] == 1 && (p1[g] >> 1) == i) add |= bit ? fValid1 : fValid0;
      }
    }
    if (add) atomicOr(&fl[i], add);
  }
  __syncthreads();
  for (int s = tid; s < S; s += T) {
    const bool v = fl[s >> 1] & ((s & 1) ? fValid1 : fValid0);
    p0[s] = v ? ((p1[s] << kDBits) | 1) : (s << kDBits);
  }
  __syncthreads();
  stamp(1);

  // ---- chain_jump: Jacobi rounds to the window's fixed point ------------
  int* cur = p0;
  int* nxt = p1;
  for (int r = 0; r < a.rounds; ++r) {
    int changed = 0;
    for (int s = tid; s < S; s += T) {
      const int p = cur[s];
      const int q = cur[p >> kDBits];
      const int d2 = min((p & kDMask) + (q & kDMask), a.dcap);
      const int p2 = (q & ~kDMask) | d2;
      nxt[s] = p2;
      changed |= p2 != p;
    }
    const int any = __syncthreads_or(changed);
    int* t = cur;
    cur = nxt;
    nxt = t;
    if (!any) break;
  }
  stamp(2);

  // ---- the chain merge ---------------------------------------------------
  long long* cmin = reinterpret_cast<long long*>(scr + L.cmin);
  int* citems = reinterpret_cast<int*>(scr + L.citems);
  int cyc = 0;
  for (int i = tid; i < NI; i += T) {
    const int wF = cur[2 * i], wR = cur[2 * i + 1];
    const int endF = (wF >> kDBits) >> 1, endR = (wR >> kDBits) >> 1;
    const int dF = wF & kDMask, dR = wR & kDMask;
    cyc |= dF > NI - 1 || dR > NI - 1;
    const int thi = max(endF, endR);
    lab[i] = min(endF, endR);
    posu[i] = endF == thi ? dR : dF;  // d_lo, until pos_u below
    if (endF != thi) fl[i] |= fAu;    // only this thread writes fl[i] here
    cmin[i] = kBig;
    citems[i] = 0;
  }
  cyc = __syncthreads_or(cyc);
  for (int i = tid; i < NI; i += T) {
    const bool al = fl[i] & fAlive;
    const int l = lab[i];
    atomicMin(&cmin[l], combo[i]);
    atomicMax(&citems[l], al ? posu[i] + 1 : 0);
  }
  __syncthreads();
  for (int i = tid; i < NI; i += T) {
    const uint32_t f = fl[i];
    const bool al = f & fAlive;
    int s = i;
    if (al) {
      long long m = cmin[lab[i]] % NI;
      if (m < 0) m += NI;
      s = static_cast<int>(m);
    }
    sit[i] = s;
    const bool as = fl[s] & fAu;
    const int dlo = posu[i];
    posu[i] = as ? citems[lab[i]] - 1 - dlo : dlo;
    if (al && (static_cast<bool>(f & fAu) != as)) atomicOr(&fl[i], fFlip);
  }
  __syncthreads();
  stamp(3);

  // ---- items: the (label, pos_u) order, start_off, the aggregates --------
  const int pi = pow2_at_least(NI);
  long long* ik = reinterpret_cast<long long*>(scr + L.ik);
  int* ix = reinterpret_cast<int*>(scr + L.ix);
  uint8_t* inr = scr + L.inr;
  int* kpos = reinterpret_cast<int*>(scr + L.kpos);
  int* rend = reinterpret_cast<int*>(scr + L.rend);
  long long* lanes = reinterpret_cast<long long*>(scr + L.lanes);
  long long* irb = reinterpret_cast<long long*>(scr + L.irb);
  int* icnt = reinterpret_cast<int*>(scr + L.icnt);
  const size_t ld = L.lane_ld;
  // The order by counting: an alive item goes to its label's run start
  // plus its pos_u, a dead one to the dead run's start plus the dead items
  // before it. That is the sort's order wherever each run's pos_u are
  // 0..n-1; where one is not (a mutual-buddy cycle's, a saturated dist)
  // the bitonic sort of the keys gives the order instead.
  for (int i = tid; i < NI; i += T) {
    icnt[i] = 0;
    ix[i] = -1;
  }
  __syncthreads();
  for (int i = tid; i < NI; i += T)
    if (fl[i] & fAlive) atomicAdd(&icnt[lab[i]], 1);
  __syncthreads();
  long long* ibase = lanes;       // inclusive sums of the labels' counts
  long long* idead = lanes + ld;  // inclusive counts of the dead items
  for (int i = tid; i < NI; i += T) {
    ibase[i] = icnt[i];
    idead[i] = !(fl[i] & fAlive);
  }
  __syncthreads();
  block_scan<false>(lanes, ld, 2, NI, red, part);
  const int n_alive = NI - static_cast<int>(idead[NI - 1]);
  int bad = 0;
  for (int i = tid; i < NI; i += T) {
    if (fl[i] & fAlive) {
      const int l = lab[i], c = icnt[l], p = posu[i];
      if (p < 0 || p >= c)
        bad = 1;
      else if (atomicExch(&ix[static_cast<int>(ibase[l]) - c + p], i) != -1)
        bad = 1;
    } else {
      ix[n_alive + static_cast<int>(idead[i]) - 1] = i;
    }
  }
  if (!__syncthreads_or(bad)) {
    for (int k = tid; k < NI; k += T) {
      const int i = ix[k];
      int s0 = n_alive, e0 = NI - 1;
      if (fl[i] & fAlive) {
        e0 = static_cast<int>(ibase[lab[i]]) - 1;
        s0 = e0 - icnt[lab[i]] + 1;
      }
      kpos[i] = k;
      ik[k] = s0;  // the start of k's run
      inr[k] = k == s0;
      if (k == s0) rend[s0] = e0;
    }
    __syncthreads();
  } else {
    for (int k = tid; k < pi; k += T) {
      if (k < NI) {
        ik[k] = (fl[k] & fAlive) ? (static_cast<long long>(lab[k]) << 13) |
                                       min(posu[k], 8191)
                                 : static_cast<long long>(NI) << 13;
        ix[k] = k;
      } else {
        ik[k] = LLONG_MAX;
        ix[k] = INT_MAX;
      }
    }
    __syncthreads();
    block_sort(ik, ix, pi);
    for (int k = tid; k < NI; k += T) kpos[ix[k]] = k;
    runs(ik, NI, 13, inr, rend, red, part);  // ik[k]: the start of k's run
  }
  stamp(4);
  // the eight aggregates: each item's values loaded in index order into
  // its sorted place, the inclusive sums, start_off, each survivor's run
  // totals
  for (int i0 = tid; i0 < NI; i0 += T * kUI) {
    long long v[kUI][kLanes];
#pragma unroll
    for (int u = 0; u < kUI; ++u) {
      const int i = i0 + u * T;
      load_lanes(a, io + (i < NI ? i : 0), v[u],
                 std::make_integer_sequence<int, kLanes>{});
    }
#pragma unroll
    for (int u = 0; u < kUI; ++u) {
      const int i = i0 + u * T;
      if (i >= NI) break;
      const int k = kpos[i];
#pragma unroll
      for (int l = 0; l < kLanes; ++l) lanes[l * ld + k] = v[u][l];
      iml[i] = v[u][0];
    }
  }
  __syncthreads();
  stamp(5);
  block_scan<false>(lanes, ld, kLanes, NI, red, part);
  stamp(6);
  // start_off = cumsum - merlen - cummax(run start ? cumsum - merlen : 0)
  for (int k = tid; k < NI; k += T) irb[k] = inr[k] && k ? lanes[k - 1] : 0;
  __syncthreads();
  block_scan<true>(irb, 0, 1, NI, red, part);
  for (int k = tid; k < NI; k += T)
    soff[ix[k]] = sub64(k ? lanes[k - 1] : 0, irb[k]);
  if (kStamps) __syncthreads();
  stamp(7);
  // a survivor takes its label's run total, every other item 0
  for (int i = tid; i < NI; i += T) {
    const bool surv = (fl[i] & fAlive) && sit[i] == i;
    const int k = kpos[i];
    const int s0 = static_cast<int>(ik[k]), e0 = rend[s0];
    long long tot[kLanes];
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      const long long* row = lanes + l * ld;
      tot[l] = surv ? sub64(row[e0], s0 ? row[s0 - 1] : 0) : 0;
    }
    store_lanes(a, io + i, tot, surv,
                std::make_integer_sequence<int, kLanes>{});
  }
  __syncthreads();
  stamp(8);

  // ---- mers: composition, then the junction trims by (item, new_pos) -----
  const int pm = pow2_at_least(NM);
  long long* mk = reinterpret_cast<long long*>(scr + L.mk);
  int* mx = reinterpret_cast<int*>(scr + L.mx);
  uint8_t* mnr = scr + L.mnr;
  int* mrend = reinterpret_cast<int*>(scr + L.mrend);
  long long* wb = reinterpret_cast<long long*>(scr + L.wb);
  long long* cw = reinterpret_cast<long long*>(scr + L.cw);
  long long* mrb = reinterpret_cast<long long*>(scr + L.mrb);
  long long* maft = reinterpret_cast<long long*>(scr + L.maft);
  unsigned long long* mtot =
      reinterpret_cast<unsigned long long*>(scr + L.mtot);
  long long* mbase = reinterpret_cast<long long*>(scr + L.mtot);
  int* mcnt = reinterpret_cast<int*>(scr + L.mcnt);
  int* mmi = reinterpret_cast<int*>(scr + L.mmi);
  long long* mr = reinterpret_cast<long long*>(scr + L.mr);
  const long long K = a.K;
  int negpos = 0;  // a member mer's new_pos below 0
  int mbad = 0;    // one outside [0, 8191]: the mers go by the sort
  for (int i = tid; i < NI; i += T) mcnt[i] = 0;
  for (int m = tid; m < NM; m += T) mx[m] = -1;
  __syncthreads();
  for (int m0 = tid; m0 < NM; m0 += T * kU) {
    long long it[kU], mp[kU], lo[kU], hi[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int m = m0 + u * T;
      const bool in = m < NM;
      it[u] = in ? a.mer_item[mo + m] : 0;
      mp[u] = in ? a.mer_pos[mo + m] : 0;
      lo[u] = in ? a.keep_lo[mo + m] : 0;
      hi[u] = in ? a.keep_hi[mo + m] : 0;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int m = m0 + u * T;
      if (m >= NM) break;
      const int mi = static_cast<int>(clampv<long long>(it[u], 0, NI - 1));
      const bool uf = fl[mi] & fFlip;
      const long long r = uf ? sub64(sub64(iml[mi], 1), mp[u]) : mp[u];
      const long long np = add64(soff[mi], r);
      const bool mem = sit[mi] != mi;
      wb[m] = sub64(hi[u], lo[u]);  // khi2 - klo2, flipped or not
      mmi[m] = mi;
      mr[m] = r;
      if (mem) atomicAdd(&mcnt[mi], 1);
      negpos |= mem && np < 0;
      mbad |= mem && (np < 0 || np > 8191);
    }
  }
  negpos = __syncthreads_or(negpos);
  mbad = __syncthreads_or(mbad);
  stamp(9);
  // The member mers' order by counting, as the items': a member item's
  // run start plus the mer's rank new_pos - start_off, where each member
  // item's ranks are 0..n-1 and every new_pos in [0, 8191]; non-members
  // (one run after every member run) need no place: their outputs read
  // no trim. Else the bitonic sort of every mer's key.
  if (!mbad) {
    for (int i = tid; i < NI; i += T) mbase[i] = mcnt[i];
    __syncthreads();
    block_scan<false>(mbase, 0, 1, NI, red, part);
    for (int m = tid; m < NM; m += T) {
      const int mi = mmi[m];
      if (sit[mi] == mi) continue;
      const int c = mcnt[mi];
      const long long r = mr[m];
      if (r < 0 || r >= c)
        mbad = 1;
      else if (atomicExch(&mx[static_cast<int>(mbase[mi]) - c + r], m) != -1)
        mbad = 1;
    }
    mbad = __syncthreads_or(mbad);
  }
  int n;  // the sorted positions the scans run over
  if (!mbad) {
    n = static_cast<int>(mbase[NI - 1]);
    for (int k = tid; k < n; k += T) {
      const int m = mx[k], mi = mmi[m];
      const int e0 = static_cast<int>(mbase[mi]) - 1, s0 = e0 - mcnt[mi] + 1;
      mk[k] = s0;  // the start of k's run
      mnr[k] = k == s0;
      if (k == s0) mrend[s0] = e0;
      cw[k] = wb[m];
    }
    __syncthreads();
  } else {
    n = NM;
    for (int m = tid; m < pm; m += T) {
      if (m >= NM) {
        mk[m] = LLONG_MAX;
        mx[m] = INT_MAX;
        continue;
      }
      const int mi = mmi[m];
      const long long np = add64(soff[mi], mr[m]);
      mk[m] = sit[mi] != mi ? (static_cast<long long>(mi) << 13) |
                                  (np < 8191 ? np : 8191LL)
                            : static_cast<long long>(NI) << 13;
      mx[m] = m;
    }
    __syncthreads();
    block_sort(mk, mx, pm);
    for (int k = tid; k < NM; k += T) cw[k] = wb[mx[k]];
    runs(mk, NM, 13, mnr, mrend, red, part);  // mk[k]: the start of k's run
    if (negpos) {  // mtot by item, as the plain version's scatter
      for (int i = tid; i < NI; i += T) mtot[i] = 0;
      __syncthreads();
      for (int m = tid; m < NM; m += T)
        if (sit[mmi[m]] != mmi[m])
          atomicAdd(&mtot[mmi[m]], static_cast<unsigned long long>(wb[m]));
      __syncthreads();
    }
  }
  stamp(10);
  block_scan<false>(cw, 0, 1, n, red, part);
  for (int k = tid; k < n; k += T) mrb[k] = mnr[k] && k ? cw[k - 1] : 0;
  __syncthreads();
  block_scan<true>(mrb, 0, 1, n, red, part);
  for (int k = tid; k < n; k += T) {
    const int m = mx[k];
    const long long ex = k ? cw[k - 1] : 0;
    const long long wk = sub64(cw[k], ex);
    const long long before = sub64(ex, mrb[k]);
    long long tot;
    if (negpos) {
      tot = static_cast<long long>(mtot[mmi[m]]);
    } else {
      const int s0 = static_cast<int>(mk[k]), e0 = mrend[s0];
      tot = sub64(cw[e0], s0 ? cw[s0 - 1] : 0);
    }
    maft[m] = sub64(sub64(tot, before), wk);
    mrb[k] = before;  // read back below through mx
  }
  __syncthreads();
  for (int k = tid; k < n; k += T) wb[mx[k]] = mrb[k];
  __syncthreads();
  stamp(11);
  for (int m0 = tid; m0 < NM; m0 += T * kU) {
    long long it[kU], mp[kU], lo[kU], hi[kU];
    uint8_t mf[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int m = m0 + u * T;
      const bool in = m < NM;
      it[u] = in ? a.mer_item[mo + m] : 0;
      mp[u] = in ? a.mer_pos[mo + m] : 0;
      lo[u] = in ? a.keep_lo[mo + m] : 0;
      hi[u] = in ? a.keep_hi[mo + m] : 0;
      mf[u] = in ? a.mer_flip[mo + m] : 0;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int m = m0 + u * T;
      if (m >= NM) break;
      const int mi = static_cast<int>(clampv<long long>(it[u], 0, NI - 1));
      const bool uf = fl[mi] & fFlip;
      const int s = sit[mi];
      const bool mem = s != mi;
      const long long np =
          add64(soff[mi], uf ? sub64(sub64(iml[mi], 1), mp[u]) : mp[u]);
      const long long klo2 = uf ? sub64(K, hi[u]) : lo[u];
      const long long khi2 = uf ? sub64(K, lo[u]) : hi[u];
      const long long width = sub64(khi2, klo2);
      const long long before = wb[m], after = maft[m];
      const bool facing_low = posu[mi] > posu[s];
      long long cut_lo = sub64(K - 1, before), cut_hi = sub64(K - 1, after);
      cut_lo = cut_lo < 0 ? 0 : cut_lo;
      cut_lo = cut_lo < width ? cut_lo : width;
      cut_hi = cut_hi < 0 ? 0 : cut_hi;
      cut_hi = cut_hi < width ? cut_hi : width;
      const size_t g = mo + m;
      a.o_mer_item[g] = s;
      a.o_mer_flip[g] = (mf[u] != 0) != uf;
      a.o_mer_pos[g] = np;
      a.o_keep_lo[g] = mem && facing_low ? add64(klo2, cut_lo) : klo2;
      a.o_keep_hi[g] = mem && !facing_low ? sub64(khi2, cut_hi) : khi2;
    }
  }
  __syncthreads();
  stamp(12);

  // ---- edges: per-source okey slots, then the rewiring -------------------
  int* slot = reinterpret_cast<int*>(scr + L.slot);
  int* deg = reinterpret_cast<int*>(scr + L.deg);
  int* curs = reinterpret_cast<int*>(scr + L.curs);
  long long* off = reinterpret_cast<long long*>(scr + L.off);
  int* bkt = reinterpret_cast<int*>(scr + L.bkt);
  int* ok2e = reinterpret_cast<int*>(scr + L.ok2e);
  int* esrc = reinterpret_cast<int*>(scr + L.esrc);
  // the renorm's order is (source, clamped okey, index) over the alive
  // edges: an edge's slot is its rank by (clamped okey, index) in its
  // source's bucket
  for (int i = tid; i < NI; i += T) deg[i] = 0;
  __syncthreads();
  for (int e0 = tid; e0 < EE; e0 += T * kU) {
    uint8_t al[kU];
    long long src[kU], ok[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * T;
      const bool in = e < EE;
      al[u] = in ? a.e_alive[eo + e] : 0;
      src[u] = in ? a.e_src[eo + e] : 0;
      ok[u] = in ? a.e_okey[eo + e] : 0;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * T;
      if (e >= EE) break;
      esrc[e] = -1;
      if (!al[u]) continue;
      long long ok2;
      if (ok[u] >= kBig - 2) {
        ok2 = ok[u] - (kBig - 2) + (kOkMax - 1);
        ok2 = ok2 < kOkMax ? ok2 : kOkMax;
      } else {
        ok2 = ok[u] < kOkMax - 2 ? ok[u] : kOkMax - 2;
      }
      const int s = static_cast<int>(clampv<long long>(src[u], 0, NI - 1));
      esrc[e] = s;
      ok2e[e] = static_cast<int>(ok2);
      atomicAdd(&deg[s], 1);
    }
  }
  __syncthreads();
  stamp(13);
  for (int i = tid; i < NI; i += T) off[i] = deg[i];
  __syncthreads();
  block_scan<false>(off, 0, 1, NI, red, part);
  for (int i = tid; i < NI; i += T)
    curs[i] = static_cast<int>(off[i]) - deg[i];
  __syncthreads();
  for (int e = tid; e < EE; e += T)
    if (esrc[e] >= 0) bkt[atomicAdd(&curs[esrc[e]], 1)] = e;
  __syncthreads();
  for (int e = tid; e < EE; e += T) {
    const int s = esrc[e];
    if (s < 0) continue;
    const int hi = static_cast<int>(off[s]), o = ok2e[e];
    int r = 0;
    for (int q = hi - deg[s]; q < hi; ++q) {
      const int b = bkt[q], ob = ok2e[b];
      r += ob < o || (ob == o && b < e);
    }
    slot[e] = r;
  }
  __syncthreads();
  stamp(14);
  int loop = 0;
  for (int e0 = tid; e0 < EE; e0 += T * kU) {
    uint8_t al[kU];
    long long src[kU], dst[kU], dir[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * T;
      const bool in = e < EE;
      al[u] = in ? a.e_alive[eo + e] : 0;
      src[u] = in ? a.e_src[eo + e] : 0;
      dst[u] = in ? a.e_dst[eo + e] : 0;
      dir[u] = in ? a.e_dir[eo + e] : 0;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * T;
      if (e >= EE) break;
      const long long sb = dir[u] >> 1, db = dir[u] & 1;
      bool consumed = false;
      if (al[u]) {
        const int st =
            static_cast<int>(clampv<long long>(src[u] * 2 + sb, 0, S - 1));
        consumed = fl[st >> 1] & ((st & 1) ? fValid1 : fValid0);
      }
      const int es = static_cast<int>(clampv<long long>(src[u], 0, NI - 1));
      const int ed = static_cast<int>(clampv<long long>(dst[u], 0, NI - 1));
      const long long nsb = sb ^ ((fl[es] & fFlip) ? 1 : 0);
      const long long ndb = db ^ ((fl[ed] & fFlip) ? 1 : 0);
      const int nsrc = sit[es], ndst = sit[ed];
      const bool nea = al[u] && !consumed;
      loop |= nea && nsrc == ndst && src[u] != dst[u];
      const bool moved = nea && nsrc != src[u];
      const bool side_f = posu[es] > posu[nsrc];
      const long long okr = al[u] ? slot[e] : kBig;
      const size_t g = eo + e;
      a.o_e_src[g] = nea ? nsrc : 0;
      a.o_e_dst[g] = nea ? ndst : 0;
      a.o_e_dir[g] = nea ? nsb * 2 + ndb : 0;
      a.o_e_alive[g] = nea;
      a.o_e_okey[g] = moved ? add64(a.Dcap * (side_f ? 1 : 2), okr) : okr;
    }
  }
  loop = __syncthreads_or(loop);
  if (tid == 0 && a.o_fallback != nullptr) a.o_fallback[w] = cyc || loop;
  stamp(15);
  return cyc || loop;
}

}  // namespace compress
