// Repeat gates for Hopper (sm_90a): for every window and every k, whether
// the window's reference sequence repeats an exact k-mer at a later offset
// (isRepeat) or a (k+1)-long stretch with at most max_mismatch mismatches
// (isAlmostRepeat). One kernel, repeat_gates, one block per window, one
// launch per batch. Plain C interface, loaded with ctypes by
// gpu/repeats.py; the entry point returns cudaGetLastError() after its
// launch.
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
//   Z_s = the longest run of zeros of neq inside [0, len-1-s),
//   A_s = the longest stretch inside [0, len-s) holding at most
//         max_mismatch ones,
//   exact[k] = max_s Z_s >= k,  gates[k] = exact[k] or max_s A_s >= k+1.
// Z is -1 for a window with no shift (len < 2), A is 0 for one with no
// shift or a negative max_mismatch, so a window of length 0 is never
// gated; any k >= 0 and any max_mismatch are taken, in any order.
//
// Inputs: seq [W, L] uint8 (a window's bytes, latin-1, zero padded), lens
// [W] int32 (clamped to [0, L]), ks [nk] int32 (each >= 0). Outputs:
// gates, exact [W, nk] bool (one byte each, 0 or 1).
//
// What bounds it: the input is W*L bytes (3.1 MB on the default corpus)
// and the work is sum over windows of len*(len-1)/2 position-steps (0.93 G
// there), each a compare of two shared-memory bytes and a few integer
// operations, so the SM's integer issue rate bounds it, not memory. The
// design:
// 1. The window's bytes go to shared memory once; every shift reads them
//    from there. Neighbouring threads take neighbouring shifts at the same
//    position, so a warp reads one broadcast byte and 32 consecutive bytes
//    a step, without bank conflicts.
// 2. Each thread scans whole shifts, one serial pass each, pairing shift s
//    with len-s so that every thread's pair costs len-1 steps; the host
//    picks the block size so that the pairs divide evenly into rounds
//    (gpu/repeats.py::plan_threads).
// 3. One pass a shift keeps the positions of the last max_mismatch+1
//    mismatches in a shift register of registers (max_mismatch 0-7, a
//    template parameter): the longest stretch ending at p starts after the
//    oldest of them, the zero run ending at p after the newest, so a step
//    is a byte compare, max_mismatch+1 selects and two add-and-max
//    (VIADDMNMX). Larger max_mismatch takes a two-pointer pass instead.
// 4. A warp max (redux.sync) and one shared atomic per warp reduce Z and
//    A over the block; then one thread per k writes both rows.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRegisterRing = 8;  // max_mismatch 0..7: ring in registers
constexpr int kMaxThreads = 256;
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

// One position-step at p: the ring r (positions of the last MM+1
// mismatches up to p, r[0] the oldest, -1 before the first) takes p if it
// mismatches; the zero run ending at p is p - r[MM] long and the longest
// stretch ending at p with at most MM mismatches p - r[0].
template <int MM, bool kZ>
__device__ __forceinline__ void ring_step(const uint8_t* __restrict__ sq,
                                          int p, int s, int (&r)[MM + 1],
                                          int& z, int& a) {
  const bool ne = sq[p + s] != sq[p];
#pragma unroll
  for (int q = 0; q < MM; ++q) r[q] = ne ? r[q + 1] : r[q];
  r[MM] = ne ? p : r[MM];
  if (kZ) z = max(z, p - r[MM]);
  a = max(a, p - r[0]);
}

// One shift: Z_s into z and A_s into a (both >= 0; n = len - s >= 1).
// The exact window excludes the last position, n-1, so the loop stops
// before it and the last step updates A alone.
template <int MM>
__device__ __forceinline__ void scan_shift(const uint8_t* __restrict__ sq,
                                           int n, int s, int mm, int& z,
                                           int& a) {
  z = 0;
  a = 0;
  if constexpr (MM >= 0) {
    int r[MM + 1];
#pragma unroll
    for (int q = 0; q <= MM; ++q) r[q] = -1;
    for (int p = 0; p < n - 1; ++p) ring_step<MM, true>(sq, p, s, r, z, a);
    ring_step<MM, false>(sq, n - 1, s, r, z, a);
  } else {
    int left = 0, cnt = 0;  // the stretch [left, p] holds cnt <= mm ones
    int last = -1;          // the last mismatch up to p
    for (int p = 0; p < n; ++p) {
      const bool ne = sq[p + s] != sq[p];
      last = ne ? p : last;
      if (p < n - 1) z = max(z, p - last);
      cnt += ne;
      while (cnt > mm) {
        cnt -= sq[left + s] != sq[left];
        ++left;
      }
      a = max(a, p - left + 1);
    }
  }
}

template <int MM>
__global__ void __launch_bounds__(kMaxThreads)
    repeat_gates_kernel(const uint8_t* __restrict__ seq,
                        const int32_t* __restrict__ lens,
                        const int32_t* __restrict__ ks,
                        uint8_t* __restrict__ gates,
                        uint8_t* __restrict__ exact, int L, int nk, int mm) {
  extern __shared__ uint8_t sq[];
  __shared__ int red[2];  // max Z, max A over the block
  const int w = blockIdx.x;
  const int len = min(max(lens[w], 0), L);
  const uint8_t* row = seq + static_cast<size_t>(w) * L;
  for (int q = threadIdx.x; q < len; q += blockDim.x) sq[q] = row[q];
  if (threadIdx.x == 0) {
    red[0] = -1;
    red[1] = 0;
  }
  __syncthreads();

  // shifts 1..len-1 in pairs (i+1, len-1-i), i < len/2
  int bz = -1, ba = 0;
  for (int i = threadIdx.x; i < len / 2; i += blockDim.x) {
    int z, a;
    const int s1 = i + 1, s2 = len - 1 - i;
    scan_shift<MM>(sq, len - s1, s1, mm, z, a);
    bz = max(bz, z);
    ba = max(ba, a);
    if (s2 != s1) {
      scan_shift<MM>(sq, len - s2, s2, mm, z, a);
      bz = max(bz, z);
      ba = max(ba, a);
    }
  }
  bz = __reduce_max_sync(0xffffffffu, bz);
  ba = __reduce_max_sync(0xffffffffu, ba);
  if ((threadIdx.x & 31) == 0) {
    atomicMax(&red[0], bz);
    atomicMax(&red[1], ba);
  }
  __syncthreads();
  const int mz = red[0];
  const int ma = mm < 0 ? 0 : red[1];
  uint8_t* g = gates + static_cast<size_t>(w) * nk;
  uint8_t* e = exact + static_cast<size_t>(w) * nk;
  for (int j = threadIdx.x; j < nk; j += blockDim.x) {
    const int k = ks[j];
    const bool ex = mz >= k;
    e[j] = ex;
    g[j] = ex || ma > k;
  }
}

template <int MM>
int launch(const void* seq, const void* lens, const void* ks, void* gates,
           void* exact, int W, int L, int nk, int mm, int threads,
           cudaStream_t stream) {
  auto* kern = repeat_gates_kernel<MM>;
  const size_t smem = (static_cast<size_t>(L) + 15) / 16 * 16;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<W, threads, smem, stream>>>(
      static_cast<const uint8_t*>(seq), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(ks), static_cast<uint8_t*>(gates),
      static_cast<uint8_t*>(exact), L, nk, mm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One launch for W windows of width L and nk values of k. threads is a
// multiple of 32 in [32, 256]. Returns a cudaError_t (cudaErrorInvalidValue
// for arguments the kernel does not take).
int repeat_gates(const void* seq, const void* lens, const void* ks,
                 void* gates, void* exact, int W, int L, int nk,
                 int max_mismatch, int threads, void* stream) {
  if (W < 1 || L < 1 || nk < 1 || threads < 32 || threads % 32 != 0 ||
      threads > kMaxThreads || L > kSmemLimit - 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // a negative max_mismatch gates nothing on A; its Z pass is MM 0's
  const int mm = max_mismatch;
#define GATES_LAUNCH(MM_) \
  case MM_:               \
    return launch<MM_>(seq, lens, ks, gates, exact, W, L, nk, mm, threads, st);
  switch (mm < 0 ? 0 : (mm < kRegisterRing ? mm : -1)) {
    GATES_LAUNCH(0)
    GATES_LAUNCH(1)
    GATES_LAUNCH(2)
    GATES_LAUNCH(3)
    GATES_LAUNCH(4)
    GATES_LAUNCH(5)
    GATES_LAUNCH(6)
    GATES_LAUNCH(7)
    GATES_LAUNCH(-1)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GATES_LAUNCH
}

}  // extern "C"
