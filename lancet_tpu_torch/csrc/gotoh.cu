// Batched global affine-gap (Gotoh M/X/Y) alignment for Hopper (sm_90a):
// one fused kernel, gotoh_align, fills each pair's DP matrix and walks its
// traceback in the same thread block, one block per pair and one launch per
// batch. Plain C interface, loaded with ctypes by gpu/gotoh.py; the entry
// point returns cudaGetLastError() after its launch.
//
// Replaces lancet_tpu/tpu/pallas_gotoh.py::pallas_dp_fill (:113, the Pallas
// fill, and its lax.scan twin align_batch.py::_dp_fill) followed by the
// lax.scan traceback of lancet_tpu/tpu/align_batch.py::_dp_and_traceback
// (:143).
//
// Scores and tie rules are those of engine/align.py (the reference's
// align.cc:235-364): MATCH 2, MISMATCH -4, GAP_OPEN -8, GAP_EXTEND -1;
// X and Y extend only when the extend score is strictly greater than the
// open score; M keeps the diagonal unless X, then Y, is strictly greater.
//
// Inputs: S [P, N+1] and T [P, M+1] uint8, 1-indexed, and the lengths
// n_len, m_len [P] int32 (0 <= n <= N, 0 <= m <= M). Outputs: ops [P, N+M]
// uint8, the op codes back to front and zero past the count, and count [P]
// int32.
//
// What bounds it: its bytes are only S, T, the lengths, the ops and the
// count (a few kB a pair), so integer operations bound it: per interior
// cell 17 by hand (X: an add and an add-and-max; the bit "X opened": an
// add and an add-and-max; Y: an add, an add-and-max and a mask; the
// substitution: compare, select, add; M: a three-way max; M's tag: two
// adds and a three-way max; the code: three funnel shifts; without DPX
// each add-and-max and three-way max would be two), per traceback step
// about ten (the code word's address, its load, the nibble's extract, the
// state machine's tests, the moves of i and j, the op store). What limited
// the first port (two kernels) was latency, not either count: its fill ran
// one barrier per anti-diagonal with seven shared loads and a global byte
// store per cell, and its traceback one dependent device-memory load per
// step. This design:
//
// 1. Keeps the traceback codes on the SM. Four bits a cell, eight columns
//    of a row to a 32-bit word: a pair needs ceil(N/R)*R * ceil(M/8) * 4
//    bytes, 175,232 at the main path's 585 x 591 (R = 5), within the
//    232,448 a block may hold. Each word is written by the one thread that
//    owns its row, so no two threads share a word; the words of one column
//    word are laid out row after row, so a thread stores its R rows
//    together (as vectors where R allows). Shapes whose codes do not fit
//    take the same kernel with kGlobal: the words go to a scratch buffer in
//    device memory that the wrapper allocates, chosen by shape before the
//    launch (gpu/gotoh.py::plan).
//    A block holds at most 8,192 rows (32 a thread x 256 threads). Larger
//    N, or shapes whose shared-memory staging does not fit, take the strip
//    mode (kStrips): the block fills its rows in strips of 8,192, one after
//    the other. Each strip's last row (M and X of every column: all that
//    the next row reads from it) goes to a scratch row of M+1 entries in
//    device memory, and the next strip's first row reads it in place of
//    row 0's boundary. The codes of every strip stay in device memory for
//    the traceback; T's characters are read from device memory and the
//    ops written straight to it, so no shared buffer grows with N or M.
// 2. Fills with a register-resident striped wavefront. Thread t owns rows
//    t*R+1 .. t*R+R (R a template parameter: the fewest rows that keep the
//    block within 4 warps, one per scheduler of the SM) and keeps their M
//    and Y values, S characters and code words in registers. Lanes sweep
//    the columns skewed one column apart: at step s lane l computes column
//    s-l, taking the row above from lane l-1 by __shfl_up_sync. Between
//    warps, the bottom row (M, X) of each column passes through a ring in
//    shared memory; warp w runs its steps in tiles of kTile columns, one
//    tile and 32 steps behind warp w-1, with one __syncthreads() per tile
//    phase: ~(m + 32 W) / kTile + W barriers a pair instead of n + m. The T
//    character of a column comes from shared memory, one load per step for
//    R cells. No per-cell ring index or global store remains.
// 3. Does the max-plus arithmetic with Hopper's DPX: __viaddmax_s32
//    (max(a+b, c)) for X and Y and __vimax3_s32 for M (VIADDMNMX and
//    VIMNMX3 in the SASS). __vibmax_s32, whose predicate would give the
//    tie rule directly, compiles to a compare and two selects per call;
//    instead each score is kept times 8 and a tag in the low bits of a
//    second, tagged max gives the argmax with the tie rules (see kGO), so
//    no code bit needs a predicate. The chain from one row to the next is
//    three instructions (add, add-and-max, three-way max); the tags stay
//    off it.
// 4. Walks the traceback after the fill's last barrier in one thread,
//    which reads each step's code word from shared memory, having loaded
//    the words of the three cells the next step may reach before this
//    step's decision, and writes the op codes into shared memory; the whole
//    block then writes them out, with the zero tail, in coalesced bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMatch = 2;
constexpr int kMismatch = -4;
constexpr int kGapOpen = -8;
constexpr int kGapExtend = -1;
constexpr int kOpDiag = 1, kOpSGap = 2, kOpTGap = 3;

// Columns a warp runs per tile phase, and the slots of each ring between
// warps. In one phase warp w reads columns [c, c+kTile) while warp w-1
// writes columns up to c + 2*kTile, so the ring needs more than 2*kTile
// slots; a power of two keeps its index a mask.
constexpr int kTile = 16;
constexpr int kRing = 128;

// The fill keeps every score times 8, so that a tag in the three low bits
// makes a max also the argmax, with the reference's tie rules. M, X and Y
// themselves are kept clean (low bits 0); the tagged maxes only feed the
// cell's 4-bit code:
//   X opened: max(X above + GE, M above + GO + 1) has bit 0 set, a tie
//       opening;
//   Y opened: max(Y left + GE, M left + GO + 1) has bit 0 set, likewise;
//   M's tag: max(diagonal + s + 2, X + 1, Y) has low bits 2, 1 or 0, so M
//       keeps the diagonal unless X, then Y, is strictly greater.
// A cell's code is [Y opened, X opened, M's 2-bit tag] from its low bit
// up, pushed into the row's code word by three funnel shifts.
constexpr int kGO = kGapOpen * 8;
constexpr int kGE = kGapExtend * 8;
constexpr int kSubMatch = kMatch * 8;
constexpr int kSubMismatch = kMismatch * 8;
constexpr int kClean = ~7;
constexpr int kTagDiag = 2, kTagLeft = 1, kTagUp = 0;  // M's tags

__host__ __device__ constexpr size_t round16(size_t x) {
  return (x + 15) / 16 * 16;
}

// Rows of code words a pair keeps: N rounded up to whole threads, so that
// every thread that owns a row <= N stores all R of its rows.
__host__ __device__ constexpr int code_rows(int N, int R) {
  return (N + R - 1) / R * R;
}

// Byte offsets of the dynamic shared memory: the code words (shared mode
// only; word w of row i at (w * code_rows + i - 1) * 4), the rings between
// warps, T's characters and the staged ops (neither in the strip mode),
// and the op count. gpu/gotoh.py::smem_bytes and strip_smem_bytes compute
// the same totals.
struct Layout {
  size_t ring, ts, ops, count, total;
};

__host__ __device__ inline Layout layout(int N, int M, int R, int threads,
                                         bool global_codes,
                                         bool strips = false) {
  const size_t wpr = (static_cast<size_t>(M) + 7) / 8;
  Layout L;
  L.ring = global_codes ? 0 : round16(code_rows(N, R) * wpr * 4);
  L.ts = L.ring + round16(static_cast<size_t>(threads / 32 - 1) * kRing * 8);
  L.ops = L.ts + (strips ? 0 : round16(static_cast<size_t>(M) + 1));
  L.count = L.ops + (strips ? 0 : round16(static_cast<size_t>(N) + M));
  L.total = L.count + 16;
  return L;
}

// The strip mode's rows a strip: 32 rows a thread x 256 threads.
constexpr int kStripRows = 32 * 256;

template <int R, bool kGlobal, bool kStrips = false>
__global__ void __launch_bounds__(R < 32 ? 128 : 256)
    gotoh_align_kernel(const uint8_t* __restrict__ S,
                       const uint8_t* __restrict__ T,
                       const int32_t* __restrict__ n_len,
                       const int32_t* __restrict__ m_len,
                       uint8_t* __restrict__ ops,
                       int32_t* __restrict__ count, uint32_t* scratch, int N,
                       int M) {
  extern __shared__ __align__(16) uint8_t sh[];
  const Layout L = layout(N, M, R, blockDim.x, kGlobal, kStrips);
  const int p = blockIdx.x;
  const int n = n_len[p];
  const int m = m_len[p];
  const int nr = code_rows(N, R);
  const size_t wpr = (M + 7) >> 3;
  // code of cell (i, j): word ((j-1) / 8) * nr + i-1, nibble (j-1) % 8
  uint32_t* codes = kGlobal ? scratch + static_cast<size_t>(p) * nr * wpr
                            : reinterpret_cast<uint32_t*>(sh);
  // strip mode: the last row of the strip before, (M, X) at columns 0..M,
  // one row a pair after all pairs' codes
  int2* edge = kStrips ? reinterpret_cast<int2*>(
                             scratch + static_cast<size_t>(gridDim.x) * nr *
                                           wpr) +
                             static_cast<size_t>(p) * (M + 1)
                       : nullptr;
  int2* ring = reinterpret_cast<int2*>(sh + L.ring);
  uint8_t* Ts = sh + L.ts;
  uint8_t* out = ops + static_cast<size_t>(p) * (N + M);
  // the op codes are staged in shared memory, or go straight out
  uint8_t* op_s = kStrips ? out : sh + L.ops;
  int* k_s = reinterpret_cast<int*>(sh + L.count);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const uint8_t* Tp = T + static_cast<size_t>(p) * (M + 1);
  if constexpr (!kStrips) {
    for (int j = tid; j <= m; j += blockDim.x) Ts[j] = Tp[j];
  }
  const uint8_t* Sp = S + static_cast<size_t>(p) * (N + 1);

  // ---- fill: one strip of rows (several in strip mode, in turn) ----
  for (int r0 = 0; r0 < (kStrips ? n : 1); r0 += kStripRows) {
    const int i0 = r0 + tid * R + 1;  // first row of this thread
    const bool owns = i0 <= N;        // its rows have code words
    // warps that own a row <= n; the rest only keep the barriers
    const int ns = kStrips ? min(n - r0, kStripRows) : n;
    const int weff = (ns > 0 && m > 0) ? ((ns + R - 1) / R + 31) >> 5 : 0;
    const int phases =
        weff ? weff - 1 + (m + 32 * weff + kTile - 1) / kTile : 0;
    int s_ch[R], Ml[R], Yl[R];
    uint32_t acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r;
      s_ch[r] = i <= n ? Sp[i] : 0;
      Ml[r] = kGO + i * kGE;  // M(i, 0)
      Yl[r] = kGO + i * kGE;  // Y(i, 0)
      acc[r] = 0;
    }
    // M(i0-1, 0): the diagonal of the first row's first column
    int diag_top = i0 == 1 ? 0 : kGO + (i0 - 1) * kGE;
    int outM = 0, outX = 0;  // M and X of the bottom row, last column
    const int2* ring_in = ring + (w > 0 ? w - 1 : 0) * kRing;
    int2* ring_out = ring + w * kRing;
    const bool to_ring = lane == 31 && w + 1 < weff;
    // strip mode: the strip's last row goes to `edge` when a strip follows
    // (in each phase warp 0 reads columns that the last warp reaches only
    // 22 or more phases later, so the one row suffices), and the row above
    // a later strip's first row comes from it
    const bool to_edge =
        kStrips && tid == blockDim.x - 1 && r0 + kStripRows < n;
    const bool from_edge = kStrips && r0 > 0;
    __syncthreads();

    for (int ph = 0; ph < phases; ++ph) {
      if (w < weff) {
        const int s0 = (ph - w) * kTile - 32 * w;
        const int hi = min(s0 + kTile, m + 32);
        for (int s = max(s0, 1); s < hi; ++s) {
          const int j = s - lane;
          int upM = __shfl_up_sync(0xffffffffu, outM, 1);
          int upX = __shfl_up_sync(0xffffffffu, outX, 1);
          if (j < 1 || j > m) continue;
          // lane 0 takes the row above from warp w-1's ring, or row 0, where
          // M and X are GAP_OPEN + j * GAP_EXTEND (or the strip before's
          // last row); every lane reads lane 0's slot, so the read needs no
          // branch
          const int2 v = w > 0       ? ring_in[s & (kRing - 1)]
                         : from_edge ? edge[j]
                                     : make_int2(kGO + j * kGE, kGO + j * kGE);
          upM = lane == 0 ? v.x : upM;
          upX = lane == 0 ? v.y : upX;
          const int tj = kStrips ? Tp[j] : Ts[j];
          int dM = diag_top;  // M(i-1, j-1) of the thread's first row
          diag_top = upM;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            // X consumes S, from (i-1, j); Y consumes T, from (i, j-1). The
            // chain from row to row is three instructions: xo, x, mc.
            const int xo = upM + kGO;
            const int x = __viaddmax_s32(upX, kGE, xo);
            const int xb = __viaddmax_s32(upX, kGE, xo + 1);  // bit 0: opened
            const int y = __viaddmax_s32(Yl[r], kGE, Ml[r] + kGO + 1);
            const int yc = y & kClean;
            const int sub = dM + (s_ch[r] == tj ? kSubMatch : kSubMismatch);
            const int mc = __vimax3_s32(sub, x, yc);
            const int mt = __vimax3_s32(sub + kTagDiag, x + kTagLeft, yc);
            acc[r] = __funnelshift_r(acc[r], y, 1);   // Y opened
            acc[r] = __funnelshift_r(acc[r], xb, 1);  // X opened
            acc[r] = __funnelshift_r(acc[r], mt, 2);  // M's tag
            dM = Ml[r];
            Ml[r] = mc;
            Yl[r] = yc;
            upM = mc;
            upX = x;
          }
          outM = upM;
          outX = upX;
          if (to_ring) ring_out[j & (kRing - 1)] = make_int2(upM, upX);
          if (to_edge) edge[j] = make_int2(upM, upX);
          if (((j - 1) & 7) == 7 && owns) {
            uint32_t* dst = codes + ((j - 1) >> 3) * nr + i0 - 1;
            if constexpr (R % 4 == 0) {
#pragma unroll
              for (int q = 0; q < R; q += 4)
                *reinterpret_cast<uint4*>(dst + q) =
                    make_uint4(acc[q], acc[q + 1], acc[q + 2], acc[q + 3]);
            } else if constexpr (R % 2 == 0) {
#pragma unroll
              for (int q = 0; q < R; q += 2)
                *reinterpret_cast<uint2*>(dst + q) =
                    make_uint2(acc[q], acc[q + 1]);
            } else {
#pragma unroll
              for (int q = 0; q < R; ++q) dst[q] = acc[q];
            }
          }
        }
      }
      __syncthreads();
    }
    // the last, partial code word of each row
    if (w < weff && owns && ((m - 1) & 7) != 7) {
      const int shift = 4 * (7 - ((m - 1) & 7));
      uint32_t* dst = codes + ((m - 1) >> 3) * nr + i0 - 1;
#pragma unroll
      for (int r = 0; r < R; ++r) dst[r] = acc[r] >> shift;
    }
    __syncthreads();
  }

  // ---- traceback: the forced-gap state machine, from (n, m) to (0, 0) ----
  // The next step's cell is (i-1, j), (i, j-1) or (i-1, j-1); their words
  // are loaded before this step's decision, so a step waits on its decode
  // and not on a dependent shared-memory load. (An index below 0 belongs to
  // row or column 0, where the walk stops; it is clamped and never used.)
  if (tid == 0) {
    int i = n, j = m, k = 0;
    bool fx = false, fy = false;
    uint32_t cur = i > 0 && j > 0 ? codes[((j - 1) >> 3) * nr + i - 1] : 0;
    while (i > 0 && j > 0) {
      const int c = j - 1;
      const int at = (c >> 3) * nr + i - 1;
      const uint32_t w_above = codes[max(at - 1, 0)];
      const uint32_t w_left = codes[max(at - nr, 0)];
      const uint32_t w_diag = codes[max(at - nr - 1, 0)];
      const uint32_t t = cur >> (4 * (c & 7));
      const int tag = (t >> 2) & 3;
      const bool left = fx || tag == kTagLeft;         // S gap: to (i-1, j)
      const bool up = !left && (fy || tag == kTagUp);  // T gap: to (i, j-1)
      op_s[k++] = left ? kOpSGap : up ? kOpTGap : kOpDiag;
      if (left) fx = !(t & 2);  // X extended
      if (up) fy = !(t & 1);    // Y extended
      const bool wrap = (c & 7) == 0;  // column j-1 is in the word before
      cur = left ? w_above
                 : up ? (wrap ? w_left : cur) : (wrap ? w_diag : w_above);
      i -= !up;
      j -= !left;
    }
    for (; j > 0; --j) op_s[k++] = kOpTGap;  // row 0: only T is left
    for (; i > 0; --i) op_s[k++] = kOpSGap;  // column 0: only S is left
    *k_s = k;
  }
  __syncthreads();
  const int k = *k_s;
  if constexpr (kStrips) {
    for (int q = k + tid; q < N + M; q += blockDim.x) out[q] = 0;
  } else {
    for (int q = tid; q < N + M; q += blockDim.x)
      out[q] = q < k ? op_s[q] : 0;
  }
  if (tid == 0) count[p] = k;
}

template <int R, bool kGlobal, bool kStrips = false>
int launch(const void* S, const void* T, const void* n_len, const void* m_len,
           void* ops, void* count, void* scratch, int P, int N, int M,
           int threads, size_t smem, cudaStream_t stream) {
  auto* kern = gotoh_align_kernel<R, kGlobal, kStrips>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<P, threads, smem, stream>>>(
      static_cast<const uint8_t*>(S), static_cast<const uint8_t*>(T),
      static_cast<const int32_t*>(n_len), static_cast<const int32_t*>(m_len),
      static_cast<uint8_t*>(ops), static_cast<int32_t*>(count),
      static_cast<uint32_t*>(scratch), N, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One launch for a batch of P pairs. rows_per_thread (R) is one of the
// instantiations below (gpu/gotoh.py ROWS_PER_THREAD); threads a multiple
// of 32 with threads * R >= N; with global_codes the code words go to
// scratch (P * ceil(N/R)*R * ceil(M/8) uint32), else to shared memory;
// smem must equal the layout's total. Returns a cudaError_t
// (cudaErrorInvalidValue for arguments the kernel does not take).
int gotoh_align(const void* S, const void* T, const void* n_len,
                const void* m_len, void* ops, void* count, void* scratch,
                int P, int N, int M, int rows_per_thread, int threads,
                int global_codes, size_t smem, void* stream) {
  if (P < 1 || N < 1 || M < 1 || threads < 32 || threads % 32 != 0 ||
      threads * rows_per_thread < N ||
      threads > (rows_per_thread < 32 ? 128 : 256) ||
      smem != layout(N, M, rows_per_thread, threads, global_codes != 0)
                  .total ||
      (global_codes && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GOTOH_LAUNCH(R_)                                                     \
  case R_:                                                                   \
    return global_codes                                                      \
               ? launch<R_, true>(S, T, n_len, m_len, ops, count, scratch,   \
                                  P, N, M, threads, smem, st)                \
               : launch<R_, false>(S, T, n_len, m_len, ops, count, scratch,  \
                                   P, N, M, threads, smem, st);
  switch (rows_per_thread) {
    GOTOH_LAUNCH(4)
    GOTOH_LAUNCH(5)
    GOTOH_LAUNCH(6)
    GOTOH_LAUNCH(8)
    GOTOH_LAUNCH(10)
    GOTOH_LAUNCH(12)
    GOTOH_LAUNCH(16)
    GOTOH_LAUNCH(24)
    GOTOH_LAUNCH(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GOTOH_LAUNCH
}

// The strip mode, for any N and M: 32 rows a thread, 256 threads, the rows
// filled in strips of 8,192; scratch holds every pair's code words (P *
// code_rows(N, 32) * ceil(M/8) uint32) and then one edge row a pair (P *
// (M+1) int2); smem must equal the strip layout's total.
int gotoh_align_strips(const void* S, const void* T, const void* n_len,
                       const void* m_len, void* ops, void* count,
                       void* scratch, int P, int N, int M, size_t smem,
                       void* stream) {
  if (P < 1 || N < 1 || M < 1 || scratch == nullptr ||
      smem != layout(N, M, 32, 256, true, true).total)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<32, true, true>(S, T, n_len, m_len, ops, count, scratch, P,
                                N, M, 256, smem,
                                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
