// The device graph engine's two screens for Hopper (sm_90a), one kernel
// each, one launch per call. Plain C interface, loaded with ctypes by
// gpu/screens.py; each entry point returns cudaGetLastError() after its
// launch.
//
// The JAX package runs each as one device loop inside its jitted attempt
// (XLA, no Pallas):
//   tandem_at    <- lancet_tpu/tpu/stages.py::tandem_at :630 (a lax.scan
//                   over string positions)
//   cycle_screen <- lancet_tpu/tpu/stages.py::cycle_screen :750 (two
//                   lax.while_loops, :796 and :820)
// The plain PyTorch versions (gpu/stages.py::tandem_at_plain and
// cycle_screen_plain) are those loops step for step, launched op by op
// from the host: tens of thousands of small ops a tandem_at call, and a
// host sync a round of the screen's two loops. Here each is one launch.
//
// What bounds them: a call reads about a megabyte (W <= 32 windows of the
// compact state, or 2,048 candidate strings of 64 codes), so on this card
// the bytes take well under a microsecond; the work is a few short serial
// chains per string (an offset table that advances only on a break) or per
// window (the rounds of two fixpoints). The designs cut each chain to what
// the function needs and run the independent chains side by side: a
// string's positions across a warp's lanes (a break test needs no chain
// state), a window's two fixpoints in the same rounds, one barrier a
// round. State stays on the SM (registers and shared memory); device
// memory is read once for the inputs and written once for the flags.
// Inputs are the engine's tensors as they are: int64 and bool (one byte, 0
// or 1).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__host__ __device__ constexpr size_t round16(size_t x) {
  return (x + 15) / 16 * 16;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo,
                                           int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

constexpr size_t kSmemLimit = 232448;  // bytes a block may use on Hopper
constexpr unsigned kFull = 0xffffffffu;

// __syncthreads_or over the block's first `count` threads (whole warps),
// on named barrier 1
__device__ __forceinline__ bool sync_or(int count, int pred) {
  unsigned r;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\tsetp.ne.s32 p, %1, 0;\n\t"
      "bar.red.or.pred q, 1, %2, p;\n\tselp.u32 %0, 1, 0, q;\n\t}"
      : "=r"(r)
      : "r"(pred), "r"(count)
      : "memory");
  return r != 0;
}

int set_smem(const void* kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// ---------------------------------------------------------------------------
// tandem_at: the findTandems replay (ref util.cc:574-758) asking whether
// position `pos` lies within dist_from_str of a reported tandem, for each
// of B strings [B, L] with lengths [B].
//
// The offset table entry offs[m][p] (unit length m, phase p) is read and
// written only at the positions i = p (mod m), and the answer is an OR
// over the hits: the chains (m, p), 1 <= m <= max_unit_len, 0 <= p < m,
// are independent (10 at unit length 4, 36 at 8). Nor does a chain's step
// need the chain's state: step i compares the m codes at i with those at
// offs[m][p], the chain's last break (p at first), and every step since
// matched, so those equal the m codes at max(i - m, p). Whether step i
// breaks is then a function of the string alone, and offs[m][p] at step i
// is the last break before i of i's chain (p if none): a segmented scan.
// One warp takes one string, kTandemWarps strings a block, no block
// barrier:
// - a string with lens <= 0 answers false and stages nothing (most of the
//   engine's rows);
// - the lanes stage the effective codes in shared memory in coalesced
//   loads (the code below lens, 100 + x % 50 past it; only the codes below
//   min(lens, L) are read) with the sentinels of the indices -1 and L to L
//   + max_unit_len - 2 beside them, then build the ml-mismatch prefix sums
//   (ml < max_unit_len) by a ballot scan;
// - for each unit length m, 32 positions at a time, one a lane: each lane
//   tests its step's break, a ballot of the breaks gives each lane its
//   chain's last break below it (the lanes of its chain are every m-th)
//   or, from the chunks before, the chain's carried one; a break long
//   enough to report runs the hit test on its lane;
// - the answer is __any_sync of the lanes' hits.
// Positions at or past lens change nothing (a hit and a table update both
// need i < lens), so a chain stops at min(lens, L). Codes are compared
// raw, as int64: 99 (an unfilled slot) matches 99, codes >= 4 compare like
// any other, and the out-of-range sentinels 300 + |x| % 97 of two indices
// past L may alias, as in the plain version; lens > L runs the match past
// L.
// ---------------------------------------------------------------------------

constexpr int kTandemWarps = 8;
constexpr int kTandemMaxUnit = 8;

// A string's shared memory: its codes with the sentinels a chain reads
// (L + max_unit_len int64) and max_unit_len - 1 prefix arrays of L + 1
// counts.
size_t tandem_warp_smem(int L, int max_unit) {
  const size_t mu = max_unit > 1 ? static_cast<size_t>(max_unit - 1) : 0;
  return round16(static_cast<size_t>(L + max_unit) * 8) +
         round16(mu * (static_cast<size_t>(L) + 1) * 4);
}

// Strings a block: kTandemWarps, or fewer where their rows would not fit
// (0: one string does not fit).
int tandem_warps(int L, int max_unit) {
  const size_t per = tandem_warp_smem(L, max_unit);
  if (per == 0) return kTandemWarps;
  const size_t fit = kSmemLimit / per;
  return static_cast<int>(fit < kTandemWarps ? fit : kTandemWarps);
}

// Dynamic shared memory of a tandem_at block (gpu/screens.py::tandem_smem
// computes the same).
size_t tandem_smem(int L, int max_unit) {
  return static_cast<size_t>(tandem_warps(L, max_unit)) *
         tandem_warp_smem(L, max_unit);
}

template <int MU>
__global__ void __launch_bounds__(kTandemWarps * 32) tandem_kernel(
    const int64_t* __restrict__ seqs, const int64_t* __restrict__ lens,
    uint8_t* __restrict__ out, int B, int L, long long pos,
    long long min_units, long long min_len, long long dist) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kMl = MU > 1 ? MU - 1 : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= B) return;  // no barrier below, only warp-wide ones
  const long long n = lens[row];
  if (n <= 0 || MU == 0) {
    if (lane == 0) out[row] = 0;
    return;
  }
  // g[x]: the base at x for x in [-1, L + MU - 2], every index a chain
  // reads (the code below lens, 100 + x % 50 past it, the out-of-range
  // sentinel 300 + |x| % 97 outside [0, L))
  const size_t ext = round16(static_cast<size_t>(L + MU) * 8);
  int64_t* g = reinterpret_cast<int64_t*>(smem + warp * ext) + 1;
  int* cs = reinterpret_cast<int*>(
      smem + (blockDim.x >> 5) * ext +
      static_cast<size_t>(warp) *
          round16(static_cast<size_t>(kMl) * (L + 1) * 4));
  const int64_t* src = seqs + static_cast<size_t>(row) * L;
  for (int x = lane - 1; x < L + MU - 1; x += 32)
    g[x] = x < 0    ? 301
           : x >= L ? static_cast<int64_t>(300 + x % 97)
           : x < n  ? src[x]
                    : static_cast<int64_t>(100 + x % 50);
  __syncwarp();

  // cs[ml - 1][k]: ml-mismatches (g[t] != g[t + ml], 1 for t >= L - ml)
  // over t < k, a ballot a 32 positions and unit length
  const unsigned below = (2u << lane) - 1u;  // lanes <= this one
  int before[kMl > 0 ? kMl : 1] = {};  // mismatches below the chunk
  if (lane < kMl) cs[lane * (L + 1)] = 0;
  for (int base = 0; base < L; base += 32) {
    const int k = base + lane;
    const int64_t gk = k < L ? g[k] : 0;
#pragma unroll
    for (int ml = 1; ml < MU; ++ml) {
      const bool mis = k < L && (k < L - ml ? gk != g[k + ml] : true);
      const unsigned bits = __ballot_sync(kFull, mis);
      if (k < L) cs[(ml - 1) * (L + 1) + k + 1] = before[ml - 1] +
                                                  __popc(bits & below);
      before[ml - 1] += __popc(bits);
    }
  }
  __syncwarp();

  // whether [a, b) holds no ml-mismatch (b <= a: none)
  auto periodic = [&](int ml, int a, int b) -> bool {
    if (b <= a) return true;
    const int* c = cs + (ml - 1) * (L + 1);
    return c[clampi(b, 0, L)] == c[clampi(a, 0, L)];
  };
  const int last = n < L ? static_cast<int>(n) : L;
  // lens where the tests i + jj < lens and i + j + 1 == lens (both sides
  // below L + MU + 1) cannot tell it from the true one
  const int nn = n < L + MU + 1 ? static_cast<int>(n) : L + MU + 1;
  // min_len where i - offset (in [0, L)) cannot tell it from the true one
  const int minl =
      static_cast<int>(min_len < 0 ? 0 : min_len > L ? L + 1 : min_len);
  const unsigned lower = (1u << lane) - 1u;  // lanes below this one
  bool hit = false;
#pragma unroll
  for (int m = 1; m <= MU; ++m) {
    // lanes of one chain in a chunk: every m-th, from the lowest
    unsigned every = 0;
    for (int b = 0; b < 32; b += m) every |= 1u << b;
    // each chain's last break before the chunk (p if none)
    int carry[MU > 0 ? MU : 1];
#pragma unroll
    for (int r = 0; r < MU; ++r) carry[r] = r;
    for (int base = 0; base < last; base += 32) {  // the same trips a warp
      const int i = base + lane, r = i % m;
      const bool in = i < last;
      const int ic = in ? i : last - 1;  // reads stay in g
      const int ref = ic < m ? ic : ic - m;
      int j = 0;
      bool still = true;
#pragma unroll
      for (int jj = 0; jj < m; ++jj) {
        still = still & (ic + jj < nn) & (g[ic + jj] == g[ref + jj]);
        j += still;
      }
      const bool brk = in && (j != m || i + j + 1 == nn);
      const unsigned bm = __ballot_sync(kFull, brk);
      const unsigned mine = bm & (every << (lane % m)) & lower;
      // offs[m][p] at step i: the chain's last break below i
      int offset = carry[0];
#pragma unroll
      for (int q = 1; q < m; ++q) offset = r == q ? carry[q] : offset;
      if (mine) offset = base + 31 - __clz(mine);
      if (brk && i - offset >= minl) {
        // a break (i < lens holds) of the reported length: a hit also
        // needs the report, the units and primitivity
        bool h = g[offset - 1] != g[offset + m - 1] &&
                 (i - offset) / m >= min_units;
#pragma unroll
        for (int ml = 1; ml < m; ++ml) {
          const int units = (i - offset + j) / ml;
          h = h && !periodic(ml, offset, offset + units * ml - ml);
        }
        hit = hit || (h && pos >= offset - dist && pos <= i + j + dist);
      }
      // carry each chain's last break in this chunk
#pragma unroll
      for (int q = 0; q < m; ++q) {
        const unsigned x = bm & (every << ((q - base % m + m) % m));
        if (x) carry[q] = base + 31 - __clz(x);
      }
    }
  }
  const bool ans = __any_sync(kFull, hit);
  if (lane == 0) out[row] = ans;
}

// ---------------------------------------------------------------------------
// cycle_screen: the conservative cycle screen, may_cycle [W, Cmax] (false
// proves that has_cycle_seq reports no cycle for the component): the
// reach of each alive anchor's two states over the active walk edges, a
// Kahn peel of the non-special walk digraph, then per component whether an
// item is reached in both orientations or left unpeeled and reached, or
// the reach did not converge.
//
// One block a window, both fixpoints in the same rounds, one barrier a
// round. Staging (two passes, a barrier each; a thread's first edge is
// loaded with the items): the items' flags, their component (0 unless in
// [1, Cmax]: the only slots the output keeps) and the labels below; then
// each active edge's state ids (srcs * 2 + startbit, dsts * 2 + destbit
// after clamping to [0, NI - 1]) packed in one word of a compacted list,
// the eact_p edges from the front and the reach-only ones (a special
// source) from the back, one atomic a warp and list; the in-degrees over
// eact_p, two 16-bit counts a word (~14 KB at NI 528, EE 1,568). The
// rounds run on just enough warps to hold the list one word a thread in a
// register (two warps at most for the engine's windows, which keep a few
// dozen active edges of 1,568), with a named barrier of their own. Round
// k = 0, 1, ... (at most T):
// - reach as round labels: dist[s] = r when state s is first reached in
//   round r, the roots 0. Round k + 1 reads only the edges whose source
//   has dist == k; a destination still unreached gets k + 1 (every writer
//   writes the same value). So {dist <= r} is the plain version's Jacobi
//   reach after r rounds, and a chain longer than T still flags.
// - the peel as Kahn layers: layer 0 is live & indeg == 0 at staging;
//   each eact_p edge out of layer k decrements its destination, and the
//   one that brings it to 0 (atomicSub returns 1) puts it in layer k + 1.
// Labels being written in a round are k + 1, never the k a reader tests,
// so one barrier-or of both change bits ends a round: a window runs
// max(reach rounds, peel rounds). The reach stops after a round that
// reaches nothing, the peel after an empty layer. Then `r_unconv` is T <=
// 0 or a state labelled T (the last round reached something), `leftover`
// the live states in no layer below T, as the plain version's loops leave
// them. Labels fit 16 bits: at most 2 NI - 1 rounds change anything.
// Preconditions (gpu/screens.py::cycle_screen_plan): NI <= 32767 (a state
// id in 16 bits), EE <= 65535 (an in-degree in 16 bits), 0 <= N and N +
// 2 (Cmax - 1) < NI (the anchors). An edge whose state id falls outside
// [0, 2 NI) (a direction outside [0, 3]; the plain version's gather raises
// there) is dropped.
// ---------------------------------------------------------------------------

constexpr int kScreenThreads = 1024;
constexpr int kScreenMaxItems = 32767;
constexpr int kScreenMaxEdges = 65535;
constexpr uint16_t kUnset = 0xffff;  // a label not given
constexpr uint32_t kNoEdge = 0xffffffffu;  // not an active edge

// Dynamic shared memory of a cycle_screen block (gpu/screens.py::
// cycle_screen_smem computes the same): the two list counters, the edge
// words (4 bytes an edge), the reach and layer labels (2 bytes a state
// each), the in-degrees (2), the items' flags (1) and components (2), two
// flags a component slot.
size_t cycle_screen_smem(int NI, int EE, int Cmax) {
  const size_t ni = static_cast<size_t>(NI);
  return 16 + round16(static_cast<size_t>(EE) * 4) + 3 * round16(ni * 4) +
         round16(ni) + round16(ni * 2) +
         2 * round16(static_cast<size_t>(Cmax) + 1);
}

__global__ void __launch_bounds__(kScreenThreads) cycle_screen_kernel(
    const int64_t* __restrict__ e_src, const int64_t* __restrict__ e_dst,
    const int64_t* __restrict__ e_dir, const uint8_t* __restrict__ e_alive,
    const uint8_t* __restrict__ alive, const uint8_t* __restrict__ special,
    const int64_t* __restrict__ comp, uint8_t* __restrict__ out, int NI,
    int EE, int N, int Cmax, int T) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t ni = static_cast<size_t>(NI);
  unsigned char* p = smem;
  int* count = reinterpret_cast<int*>(p);  // eact_p edges, reach-only edges
  p += 16;
  uint32_t* ew = reinterpret_cast<uint32_t*>(p);
  p += round16(static_cast<size_t>(EE) * 4);
  uint16_t* dist = reinterpret_cast<uint16_t*>(p);
  p += round16(ni * 4);
  uint16_t* lay = reinterpret_cast<uint16_t*>(p);
  p += round16(ni * 4);
  uint32_t* indeg = reinterpret_cast<uint32_t*>(p);  // states 2v, 2v + 1
  p += round16(ni * 4);
  uint8_t* fl = p;  // bit 0 alive, bit 1 special
  p += round16(ni);
  uint16_t* cm = reinterpret_cast<uint16_t*>(p);
  p += round16(ni * 2);
  uint8_t* flagged = p;
  p += round16(static_cast<size_t>(Cmax) + 1);
  uint8_t* present = p;

  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const size_t wi = static_cast<size_t>(blockIdx.x) * NI;
  const size_t we = static_cast<size_t>(blockIdx.x) * EE;
  // an edge's two state ids in one word, or kNoEdge for an edge that is
  // dead or whose state id leaves [0, 2 NI)
  auto pack = [&](int e, int64_t src, int64_t dst, int64_t dir,
                  uint8_t on) -> uint32_t {
    if (e >= EE || !on) return kNoEdge;
    src = clamp64(src, 0, NI - 1);
    dst = clamp64(dst, 0, NI - 1);
    const int64_t s = src * 2 + (dir >> 1), d = dst * 2 + (dir & 1);
    if (s < 0 || s >= 2 * NI || d < 0 || d >= 2 * NI) return kNoEdge;
    return static_cast<uint32_t>(s) | static_cast<uint32_t>(d) << 16;
  };
  auto load = [&](int e) -> uint32_t {
    const bool in = e < EE;
    return pack(e, in ? e_src[we + e] : 0, in ? e_dst[we + e] : 0,
                in ? e_dir[we + e] : 0, in ? e_alive[we + e] : 0);
  };
  auto flags = [&](int v) -> uint8_t {
    return (alive[wi + v] != 0) | (special[wi + v] != 0) << 1;
  };
  auto slot_of = [&](int64_t c) -> uint16_t {
    return static_cast<uint16_t>(c >= 1 && c <= Cmax ? c : 0);
  };
  auto item = [&](int v, uint8_t f, uint16_t c) {
    fl[v] = f;
    cm[v] = c;
    // the roots: both states of each alive anchor N + 2c, c < Cmax
    const bool root =
        (f & 1) && v >= N && ((v - N) & 1) == 0 && ((v - N) >> 1) < Cmax;
    dist[2 * v] = dist[2 * v + 1] = root ? 0 : kUnset;
    // layer 0 for every live state; the edge pass unsets those it enters
    lay[2 * v] = lay[2 * v + 1] = f == 1 ? 0 : kUnset;
    indeg[v] = 0;
  };
  // a thread's first edge and first item are read before either is used:
  // their loads are in flight together
  uint32_t word = load(tid);
  const uint8_t f0 = tid < NI ? flags(tid) : 0;
  const uint16_t c0 = slot_of(tid < NI ? comp[wi + tid] : 0);
  if (tid < 2) count[tid] = 0;
  for (int c = tid; c <= Cmax; c += nt) flagged[c] = present[c] = 0;
  if (tid < NI) item(tid, f0, c0);
  for (int v = tid + nt; v < NI; v += nt)
    item(v, flags(v), slot_of(comp[wi + v]));
  __syncthreads();

  // edges into the compacted list: eact_p ones from the front, reach-only
  // ones (a special source) from the back, a warp's slots taken by one
  // atomic a list
  const unsigned lower = (1u << lane) - 1u;
  for (int base = 0; base < EE; base += nt) {  // the same trips a warp
    if (base > 0) word = load(base + tid);
    int kind = 0;  // 3: eact_p, 1: reach-only
    if (word != kNoEdge) {
      const uint8_t fs = fl[(word & 0xffffu) >> 1], fd = fl[word >> 17];
      if ((fs & 1) && fd == 1) kind = fs & 2 ? 1 : 3;
    }
    const unsigned mp = __ballot_sync(kFull, kind == 3);
    const unsigned mr = __ballot_sync(kFull, kind == 1);
    int at_p = 0, at_r = 0;
    if (lane == 0 && mp) at_p = atomicAdd(&count[0], __popc(mp));
    if (lane == 0 && mr) at_r = atomicAdd(&count[1], __popc(mr));
    at_p = __shfl_sync(kFull, at_p, 0) + __popc(mp & lower);
    at_r = __shfl_sync(kFull, at_r, 0) + __popc(mr & lower);
    if (kind == 3) {
      const int d = word >> 16;
      ew[at_p] = word;
      atomicAdd(&indeg[d >> 1], d & 1 ? 0x10000u : 1u);
      lay[d] = kUnset;  // entered: not in layer 0
    } else if (kind == 1) {
      ew[EE - 1 - at_r] = word;
    }
  }
  __syncthreads();

  // the rounds run on the first R threads (whole warps, one list slot
  // each, its word in a register; R = nt takes the rest in turn), with a
  // barrier of their own: the engine's windows keep a few dozen active
  // edges of 1,568 and pay a barrier of a warp or two
  const int np = count[0], nl = np + count[1];
  const int R = min(nt, max(32, (nl + 31) / 32 * 32));
  if (tid < R) {
    auto slot = [&](int x) {  // the word of list slot x < nl
      return x < np ? ew[x] : ew[EE - nl + x];
    };
    // one edge's round k (kind 3: reach and peel, 1: reach, 0: none): its
    // loads first (a label written this round is k + 1 and fails the tests
    // either way), then the reach's store and the peel's decrement
    auto step = [&](uint32_t w, int kind, int k) -> int {
      const int sx = w & 0xffffu, d = w >> 16, sh = (d & 1) * 16;
      const bool reach =
          (kind != 0) & (dist[sx] == k) & (dist[d] == kUnset);
      const bool peel = ((kind & 2) != 0) & (lay[sx] == k);
      if (reach) dist[d] = static_cast<uint16_t>(k + 1);
      const unsigned old = peel ? atomicSub(&indeg[d >> 1], 1u << sh) : 0;
      if (peel && (old >> sh & 0xffffu) == 1) {
        lay[d] = static_cast<uint16_t>(k + 1);
        return 1;
      }
      return reach;
    };
    const int kind = tid < np ? 3 : (tid < nl ? 1 : 0);
    const uint32_t w = kind ? slot(tid) : 0;
    for (int k = 0; k < T; ++k) {
      int ch = step(w, kind, k);
      for (int x = R + tid; x < nl; x += R)
        ch |= step(slot(x), x < np ? 3 : 1, k);
      if (!sync_or(R, ch)) break;
    }
  }
  __syncthreads();

  // flag items: unpeeled and reached, or reached in both orientations;
  // every item with a component flags it if the reach did not converge
  int unconv = 0;
  for (int v = tid; v < NI; v += nt) {
    const uint16_t d0 = dist[2 * v], d1 = dist[2 * v + 1];
    if (T > 0 && T < kUnset && (d0 == T || d1 == T)) unconv = 1;
    const int c = cm[v];
    if (c == 0) continue;
    present[c] = 1;
    if (fl[v] != 1) continue;  // dead or special
    const bool r0 = d0 != kUnset, r1 = d1 != kUnset;
    const bool left0 = r0 && !(lay[2 * v] != kUnset && lay[2 * v] < T);
    const bool left1 = r1 && !(lay[2 * v + 1] != kUnset && lay[2 * v + 1] < T);
    if (left0 || left1 || (r0 && r1)) flagged[c] = 1;
  }
  unconv = __syncthreads_or(unconv) || T <= 0;
  for (int c = tid; c < Cmax; c += nt)
    out[blockIdx.x * static_cast<size_t>(Cmax) + c] =
        flagged[c + 1] || (unconv && present[c + 1]);
}

template <int MU>
int launch_tandem(const void* seqs, const void* lens, void* out, int B,
                  int L, long long pos, long long min_units,
                  long long min_len, long long dist, size_t smem,
                  cudaStream_t stream) {
  int rc = set_smem(reinterpret_cast<const void*>(tandem_kernel<MU>), smem);
  if (rc != 0) return rc;
  const int warps = tandem_warps(L, MU);
  tandem_kernel<MU><<<(B + warps - 1) / warps, warps * 32, smem, stream>>>(
      static_cast<const int64_t*>(seqs), static_cast<const int64_t*>(lens),
      static_cast<uint8_t*>(out), B, L, pos, min_units, min_len, dist);
  return static_cast<int>(cudaGetLastError());
}

using TandemLaunch = int (*)(const void*, const void*, void*, int, int,
                            long long, long long, long long, long long,
                            size_t, cudaStream_t);
constexpr TandemLaunch kTandemLaunch[kTandemMaxUnit + 1] = {
    launch_tandem<0>, launch_tandem<1>, launch_tandem<2>,
    launch_tandem<3>, launch_tandem<4>, launch_tandem<5>,
    launch_tandem<6>, launch_tandem<7>, launch_tandem<8>};

}  // namespace

extern "C" {

// tandem_at: B strings [B, L] int64 with lengths [B] int64, out [B] bytes;
// max_unit_len in [0, kTandemMaxUnit] (0: no unit length, every answer
// false); smem must equal tandem_smem(L, max_unit_len), one string's rows
// fitting a block.
int tandem_at(const void* seqs, const void* lens, void* out, int B, int L,
              int max_unit_len, long long pos, long long min_units,
              long long min_len, long long dist, size_t smem, void* stream) {
  if (B < 1 || L < 0 || max_unit_len < 0 || max_unit_len > kTandemMaxUnit ||
      tandem_warps(L, max_unit_len) < 1 || smem > kSmemLimit ||
      smem != tandem_smem(L, max_unit_len))
    return static_cast<int>(cudaErrorInvalidValue);
  return kTandemLaunch[max_unit_len](seqs, lens, out, B, L, pos, min_units,
                                     min_len, dist, smem,
                                     static_cast<cudaStream_t>(stream));
}

// cycle_screen: W windows of NI items and EE edges (int64 ids and
// directions, bool flags one byte), comp [W, NI] int64, out [W, Cmax]
// bytes; T rounds at most; smem must equal cycle_screen_smem.
int cycle_screen(const void* e_src, const void* e_dst, const void* e_dir,
                 const void* e_alive, const void* alive, const void* special,
                 const void* comp, void* out, int W, int NI, int EE, int N,
                 int Cmax, int T, size_t smem, void* stream) {
  if (W < 1 || NI < 1 || NI > kScreenMaxItems || EE < 0 ||
      EE > kScreenMaxEdges || Cmax < 0 || N < 0 ||
      (Cmax > 0 && N + 2 * (Cmax - 1) >= NI) || smem > kSmemLimit ||
      smem != cycle_screen_smem(NI, EE, Cmax))
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = set_smem(reinterpret_cast<const void*>(cycle_screen_kernel), smem);
  if (rc != 0) return rc;
  cycle_screen_kernel<<<W, kScreenThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(e_src), static_cast<const int64_t*>(e_dst),
      static_cast<const int64_t*>(e_dir), static_cast<const uint8_t*>(e_alive),
      static_cast<const uint8_t*>(alive), static_cast<const uint8_t*>(special),
      static_cast<const int64_t*>(comp), static_cast<uint8_t*>(out), NI, EE,
      N, Cmax, T);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
