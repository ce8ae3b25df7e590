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
// the bytes take well under a microsecond; the work is a serial chain per
// string (the offset table advances only on a break, so positions run in
// order) or per window (rounds of a fixpoint, a barrier each). The designs
// keep each chain's state on the SM (registers and shared memory) and
// touch device memory once to read the inputs and once to write the
// flags. Inputs are the engine's tensors as they are: int64 and bool (one
// byte, 0 or 1).

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
// The scan over positions i is serial: the offset table offs[m][p] (unit
// length m, phase p = i % m) advances only on a break. One thread walks one
// string, kTandemRows strings a block. The block first stages its strings'
// effective codes in shared memory (eff: the code below lens, 100 + x % 50
// past it; only the codes below min(lens, L) are read), then each thread
// builds its string's ml-mismatch prefix sums (ml < max_unit_len) beside
// them and scans. The offset table lives in registers as one ring a unit
// length, rotated a step each position so that the active phase is always
// slot 0: every index is a constant after unrolling. Positions at or past
// lens change nothing (a hit and a table update both need i < lens), so
// the scan stops at min(lens, L). Codes are compared raw, as int64: 99 (an
// unfilled slot) matches 99, codes >= 4 compare like any other, and the
// out-of-range sentinels 300 + |x| % 97 of two indices past L may alias,
// as in the plain version.
// ---------------------------------------------------------------------------

constexpr int kTandemRows = 32;
constexpr int kTandemMaxUnit = 8;

__host__ __device__ constexpr int tandem_stride(int L) { return L | 1; }

// Dynamic shared memory of a tandem_at block (gpu/screens.py::tandem_smem
// computes the same): the rows' codes (an odd stride of int64, so a warp's
// same-position loads spread over the banks) and each row's prefix sums,
// max_unit_len - 1 arrays of L + 1 counts.
size_t tandem_smem(int L, int max_unit) {
  const size_t mu = max_unit > 1 ? static_cast<size_t>(max_unit - 1) : 0;
  return round16(static_cast<size_t>(kTandemRows) * tandem_stride(L) * 8) +
         round16(static_cast<size_t>(kTandemRows) * mu * (L + 1) * 4);
}

template <int MU>
__global__ void __launch_bounds__(kTandemRows) tandem_kernel(
    const int64_t* __restrict__ seqs, const int64_t* __restrict__ lens,
    uint8_t* __restrict__ out, int B, int L, long long pos,
    long long min_units, long long min_len, long long dist) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = tandem_stride(L);
  int64_t* eff = reinterpret_cast<int64_t*>(smem);
  int* csm = reinterpret_cast<int*>(
      smem + round16(static_cast<size_t>(kTandemRows) * S * 8));
  const int r0 = blockIdx.x * kTandemRows;
  const int rows = B - r0 < kTandemRows ? B - r0 : kTandemRows;

  for (int t = threadIdx.x; t < rows * L; t += blockDim.x) {
    const int r = t / L, x = t - r * L;
    const long long n = lens[r0 + r];
    eff[r * S + x] = x < n ? seqs[static_cast<size_t>(r0 + r) * L + x]
                           : static_cast<int64_t>(100 + x % 50);
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r >= rows) return;  // no barrier below
  const long long n = lens[r0 + r];
  const int64_t* e = eff + r * S;
  constexpr int kMl = MU > 1 ? MU - 1 : 0;
  int* cs = csm + static_cast<size_t>(r) * kMl * (L + 1);

  // csm[ml][k]: ml-mismatches (e[t] != e[t + ml], 1 for t >= L - ml) over
  // t < k
#pragma unroll
  for (int ml = 1; ml < MU; ++ml) {
    int* c = cs + (ml - 1) * (L + 1);
    int acc = 0;
    c[0] = 0;
    for (int k = 0; k < L; ++k) {
      acc += k < L - ml ? (e[k] != e[k + ml]) : 1;
      c[k + 1] = acc;
    }
  }

  // the base at x; an index-unique sentinel out of [0, L)
  auto gb = [&](int x) -> int64_t {
    return (x >= 0 && x < L)
               ? e[x]
               : static_cast<int64_t>(300 + (x < 0 ? -x : x) % 97);
  };
  // whether [a, b) holds no ml-mismatch (b <= a: none)
  auto periodic = [&](int ml, int a, int b) -> bool {
    if (b <= a) return true;
    const int* c = cs + (ml - 1) * (L + 1);
    return c[clampi(b, 0, L)] == c[clampi(a, 0, L)];
  };

  int ring[MU + 1][MU > 0 ? MU : 1];
#pragma unroll
  for (int m = 1; m <= MU; ++m) {
#pragma unroll
    for (int p = 0; p < m; ++p) ring[m][p] = p;
  }
  bool ans = false;
  const int last = n < L ? static_cast<int>(n) : L;  // <= 0: no position
  for (int i = 0; i < last; ++i) {
#pragma unroll
    for (int m = 1; m <= MU; ++m) {
      const int offset = ring[m][0];
      int j = 0;
      bool still = true;
#pragma unroll
      for (int jj = 0; jj < m; ++jj) {
        still = still && (i + jj < n) && gb(i + jj) == gb(offset + jj);
        j += still;
      }
      const bool brk = (j != m) || (static_cast<long long>(i) + j + 1 == n);
      if (brk) {
        // i < lens holds: a hit needs the report, the units and
        // primitivity; the table takes i
        bool hit = gb(offset - 1) != gb(offset + m - 1) &&
                   (i - offset) / m >= min_units && (i - offset) >= min_len;
#pragma unroll
        for (int ml = 1; ml < m; ++ml) {
          const int units = (i - offset + j) / ml;
          hit = hit && !periodic(ml, offset, offset + units * ml - ml);
        }
        ans = ans || (hit && pos >= offset - dist && pos <= i + j + dist);
      }
      const int next = brk ? i : offset;
#pragma unroll
      for (int p = 0; p + 1 < m; ++p) ring[m][p] = ring[m][p + 1];
      ring[m][m - 1] = next;
    }
  }
  out[r0 + r] = ans;
}

// ---------------------------------------------------------------------------
// cycle_screen: the conservative cycle screen, may_cycle [W, Cmax] (false
// proves that has_cycle_seq reports no cycle for the component): the
// reach of each alive anchor's two states over the active walk edges, a
// Kahn peel of the non-special walk digraph, then per component whether an
// item is reached in both orientations or left unpeeled and reached, or
// the reach did not converge.
//
// One block a window. It stages the window's alive and special flags, each
// edge's state ids (srcs * 2 + startbit, dsts * 2 + destbit after clamping
// to [0, NI - 1]) packed in one word with the eact / eact_p bits beside
// it, and the in-degrees, in shared memory (~17 KB at NI 528, EE 1,568),
// and loops on the card, one barrier a phase:
// - reach, Jacobi rounds as the plain version's scatter: every edge reads
//   the round's old buffer and writes the new one, then the states compare
//   and copy back; a window stops after a round that changes nothing, or
//   after T rounds, and `r_unconv` is the last round's change bit (true
//   for T <= 0). An in-place update would converge sooner and flip the
//   verdict of a chain longer than T.
// - the peel, a whole layer a round: f = live & indeg == 0 over all
//   states, a barrier, then each eact_p edge out of a peeled state
//   decrements its destination, and live loses f; at most T rounds, the
//   last one with an empty f.
// A window's rounds are those of the JAX loops' global conditions: a
// window that stops changing stays unchanged in later rounds.
// Preconditions (gpu/screens.py::cycle_screen_plan): NI <= 32767 (a state
// id in 16 bits), 0 <= N and N + 2 (Cmax - 1) < NI (the anchors). An edge
// whose state id falls outside [0, 2 NI) (a direction outside [0, 3];
// the plain version's gather raises there) is dropped.
// ---------------------------------------------------------------------------

constexpr int kScreenThreads = 512;
constexpr int kScreenMaxItems = 32767;

// Dynamic shared memory of a cycle_screen block (gpu/screens.py::
// cycle_screen_smem computes the same): the edge words (4 bytes an edge)
// and flags (1), the items' alive and special flags (1 each), four byte
// arrays over the states (two reach buffers, live, the peel's layer), the
// in-degrees (4 a state) and the components' flags (Cmax + 2 bytes).
size_t cycle_screen_smem(int NI, int EE, int Cmax) {
  const size_t ns = 2 * static_cast<size_t>(NI);
  const size_t ee = static_cast<size_t>(EE);
  return round16(ee * 4) + round16(ee) + 2 * round16(NI) + 4 * round16(ns) +
         round16(ns * 4) + round16(static_cast<size_t>(Cmax) + 2);
}

__global__ void __launch_bounds__(kScreenThreads) cycle_screen_kernel(
    const int64_t* __restrict__ e_src, const int64_t* __restrict__ e_dst,
    const int64_t* __restrict__ e_dir, const uint8_t* __restrict__ e_alive,
    const uint8_t* __restrict__ alive, const uint8_t* __restrict__ special,
    const int64_t* __restrict__ comp, uint8_t* __restrict__ out, int NI,
    int EE, int N, int Cmax, int T) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int NS = 2 * NI;
  unsigned char* p = smem;
  uint32_t* ew = reinterpret_cast<uint32_t*>(p);
  p += round16(static_cast<size_t>(EE) * 4);
  uint8_t* ef = p;
  p += round16(EE);
  uint8_t* al = p;
  p += round16(NI);
  uint8_t* sp = p;
  p += round16(NI);
  uint8_t* ra = p;
  p += round16(NS);
  uint8_t* rb = p;
  p += round16(NS);
  uint8_t* live = p;
  p += round16(NS);
  uint8_t* f = p;
  p += round16(NS);
  int* indeg = reinterpret_cast<int*>(p);
  p += round16(static_cast<size_t>(NS) * 4);
  uint8_t* may = p;

  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t wi = static_cast<size_t>(blockIdx.x) * NI;
  const size_t we = static_cast<size_t>(blockIdx.x) * EE;
  for (int v = tid; v < NI; v += nt) {
    al[v] = alive[wi + v];
    sp[v] = special[wi + v];
  }
  for (int s = tid; s < NS; s += nt) {
    ra[s] = 0;
    rb[s] = 0;
    indeg[s] = 0;
  }
  for (int c = tid; c < Cmax + 2; c += nt) may[c] = 0;
  __syncthreads();

  // the roots: both states of each alive anchor N + 2c, in both buffers
  for (int c = tid; c < Cmax; c += nt) {
    const int item = N + 2 * c;
    if (al[item]) {
      ra[2 * item] = ra[2 * item + 1] = 1;
      rb[2 * item] = rb[2 * item + 1] = 1;
    }
  }
  for (int s = tid; s < NS; s += nt) live[s] = al[s >> 1] && !sp[s >> 1];
  for (int e = tid; e < EE; e += nt) {
    const int64_t src = clamp64(e_src[we + e], 0, NI - 1);
    const int64_t dst = clamp64(e_dst[we + e], 0, NI - 1);
    const int64_t dir = e_dir[we + e];
    const int64_t s = src * 2 + (dir >> 1), d = dst * 2 + (dir & 1);
    uint32_t word = 0;
    uint8_t fl = 0;
    if (s >= 0 && s < NS && d >= 0 && d < NS) {
      const bool act = e_alive[we + e] && al[src] && al[dst] && !sp[dst];
      const bool act_p = act && !sp[src];
      word = static_cast<uint32_t>(s) | static_cast<uint32_t>(d) << 16;
      fl = static_cast<uint8_t>(act | act_p << 1);
      if (act_p) atomicAdd(&indeg[d], 1);
    }
    ew[e] = word;
    ef[e] = fl;
  }
  __syncthreads();

  // reach: Jacobi rounds, ra the old buffer and rb the new one (equal at a
  // round's start)
  int unconv = 1;
  for (int r = 0; r < T && unconv; ++r) {
    for (int e = tid; e < EE; e += nt)
      if ((ef[e] & 1) && ra[ew[e] & 0xffffu]) rb[ew[e] >> 16] = 1;
    __syncthreads();
    int ch = 0;
    for (int s = tid; s < NS; s += nt)
      if (rb[s] != ra[s]) {
        ra[s] = rb[s];
        ch = 1;
      }
    unconv = __syncthreads_or(ch);
  }

  // the Kahn peel, a layer a round
  for (int r = 0; r < T; ++r) {
    int any = 0;
    for (int s = tid; s < NS; s += nt) {
      const uint8_t x = live[s] && indeg[s] == 0;
      f[s] = x;
      any |= x;
    }
    any = __syncthreads_or(any);
    for (int e = tid; e < EE; e += nt)
      if ((ef[e] & 2) && f[ew[e] & 0xffffu])
        atomicSub(&indeg[ew[e] >> 16], 1);
    for (int s = tid; s < NS; s += nt)
      if (f[s]) live[s] = 0;
    __syncthreads();
    if (!any) break;
  }

  // flag items: un-peeled and reached, or reached in both orientations (or
  // the reach did not converge); a component's flag is any of its items'
  for (int v = tid; v < NI; v += nt) {
    const int64_t c = comp[wi + v];
    if (c <= 0) continue;
    const bool r0 = ra[2 * v], r1 = ra[2 * v + 1];
    const bool left = (live[2 * v] && r0) || (live[2 * v + 1] && r1);
    const bool flag = ((left || (r0 && r1)) && al[v] && !sp[v]) || unconv;
    if (flag) may[c > Cmax + 1 ? Cmax + 1 : c] = 1;
  }
  __syncthreads();
  for (int c = tid; c < Cmax; c += nt)
    out[blockIdx.x * static_cast<size_t>(Cmax) + c] = may[c + 1];
}

template <int MU>
int launch_tandem(const void* seqs, const void* lens, void* out, int B,
                  int L, long long pos, long long min_units,
                  long long min_len, long long dist, size_t smem,
                  cudaStream_t stream) {
  int rc = set_smem(reinterpret_cast<const void*>(tandem_kernel<MU>), smem);
  if (rc != 0) return rc;
  tandem_kernel<MU><<<(B + kTandemRows - 1) / kTandemRows, kTandemRows, smem,
                      stream>>>(
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
// max_unit_len in [0, kTandemMaxUnit] (0 and below: no unit length, every
// answer false); smem must equal tandem_smem(L, max_unit_len).
int tandem_at(const void* seqs, const void* lens, void* out, int B, int L,
              int max_unit_len, long long pos, long long min_units,
              long long min_len, long long dist, size_t smem, void* stream) {
  if (B < 1 || L < 0 || max_unit_len < 0 || max_unit_len > kTandemMaxUnit ||
      smem > kSmemLimit || smem != tandem_smem(L, max_unit_len))
    return static_cast<int>(cudaErrorInvalidValue);
  return kTandemLaunch[max_unit_len](seqs, lens, out, B, L, pos, min_units,
                                     min_len, dist, smem,
                                     static_cast<cudaStream_t>(stream));
}

// cycle_screen: W windows of NI items and EE edges (int64 ids and
// directions, bool flags one byte), comp [W, NI] int64, out [W, Cmax]
// bytes; T rounds at most a loop; smem must equal cycle_screen_smem.
int cycle_screen(const void* e_src, const void* e_dst, const void* e_dir,
                 const void* e_alive, const void* alive, const void* special,
                 const void* comp, void* out, int W, int NI, int EE, int N,
                 int Cmax, int T, size_t smem, void* stream) {
  if (W < 1 || NI < 1 || NI > kScreenMaxItems || EE < 0 || Cmax < 0 ||
      N < 0 || (Cmax > 0 && N + 2 * (Cmax - 1) >= NI) || smem > kSmemLimit ||
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
