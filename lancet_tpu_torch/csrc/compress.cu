// The device graph engine's unitig compression pass for Hopper (sm_90a):
// one kernel, one launch per call. Plain C interface, loaded with ctypes by
// gpu/compress.py; each entry point returns cudaGetLastError() after its
// launch.
//
// The JAX package runs it inside its jitted attempt (XLA, no Pallas):
//   compress_round <- lancet_tpu/tpu/stages.py::compress_round :928, with
//                     edge_renorm, links and chain_jump (pointer jumping, a
//                     lax.while_loop at :369)
// The plain PyTorch version (gpu/stages.py::compress_round_plain) is that
// function op for op, launched from the host: ~390 small ops a call, and a
// host sync a round of its pointer jumping. Here it is one launch, a thread
// block cluster of C blocks a window (compress_body.cuh: rank 0 the item
// chain, the others the mers' and edges' ranges and orders), and nothing
// goes back to the host.
//
// What bounds it: a call moves ~17 MB (W 32 windows of NI 1,552 items,
// EE 3,872 edges and NM 1,536 mers, int64, in and out: ~5 us of this
// card's memory) and does little arithmetic; the work is a few serial
// chains per window: the rounds of the pointer jumping (at most 11), three
// orders (the edges by (source, okey), the items by (chain, position), the
// mers by (item, position)) and the scans over them. So a window's state
// stays in shared memory from its first load to its last store, its loads
// are issued a few at a time, and every scatter of the plain version whose
// targets collide becomes a scan over a sorted order. A block runs each
// stretch of its code about once, so the time also follows the code it
// executes (instruction fetch, compress_split.py): the scans are one
// shared function, the lanes a loop. One block a window left 100 of the
// 132 SMs idle at the engine's W 32 and ran the mers' and edges' phases
// (half a window's cycles) after the item chain; a cluster runs them on
// its other blocks while rank 0 runs the chain, so a window takes about
// the chain's time (the cluster's size: gpu/compress.py::compress_plan).
//
// The stages, as compress_round_plain orders them, and what each becomes:
// - links: an alive edge adds one to its start state's count (shared
//   atomics) and writes its (destination, dest bit) word there (a state
//   of count one has one writer, and no other state's word is read);
//   self-loops mark their item; a state's link is valid under the plain
//   version's tests;
// - chain_jump: the packed words (nxt << 13 | dist), double-buffered: a
//   round reads only the previous round's words (Jacobi), and a window
//   stops at its own fixed point or after `rounds` rounds; a window at its
//   fixed point stays there, so this equals the plain loop, which stops
//   when no window of the batch changes (a mutual-buddy cycle runs every
//   round);
// - the chain merge: each item's label (the lower end), d_lo and
//   orientation; the survivor, min(rank, N) * NI + item minimised per
//   label with 64-bit shared atomics, its index by floor modulo; flip,
//   n_items (an atomic max), pos_u;
// - the items in the plain version's stable-sort order of ((label << 13) |
//   pos_u) for alive items and NI << 13 for dead ones: by counting (a
//   label's run start plus pos_u; the dead run in index order) wherever
//   each run's pos_u are 0..n-1, else (a cycle, a saturated dist) by a
//   bitonic sort of (key, index) pairs in shared memory; the inclusive
//   sums of merlen in that order give start_off with the plain version's
//   run base (a max scan of the run starts' exclusive sums), bit for bit
//   whatever the values; every alive label is one run of that order, so
//   the eight item aggregates are run totals: differences of the inclusive
//   sums of each lane (mod 2^64, as torch's int64 adds);
// - the mers: new_pos, the flips and the kept interval, then the junction
//   trims in the order of ((item << 13) | min(new_pos, 8191)) for member
//   mers and NI << 13 for the others: by counting (the member item's run
//   start plus new_pos - start_off) wherever those are 0..n-1 and new_pos
//   in [0, 8191], non-members needing no place; else by the bitonic sort.
//   `before` is the plain version's cumsum-minus-run-base, `mtot` the
//   member item's run total (by 64-bit atomics where a member's new_pos is
//   negative and its key leaves the item's run);
// - the edges: the renorm's per-source slots, each alive edge's rank by
//   (clamped okey, index) in its source's bucket (the plain version's
//   stable sort of (source, clamped okey), since an alive okey is >= 0),
//   then each edge's rewiring, loopback and new okey.
// Inputs are the engine's tensors as they are: int64 and bool (one byte, 0
// or 1). The kernel assumes what the plain version's scatters need of an
// alive edge: its source and destination in [0, NI) and its direction in
// [0, 3]; and an alive edge's okey >= 0, as the engine's are (creation
// order, the anchors' 0, BIG-2 and BIG-1, Dcap * (1 or 2) + slot). Smem
// indices are clamped, so other data gives wrong answers, never a fault.
//
// Built with -DCOMPRESS_STAMPS (compress_split.py builds such a copy into
// build/), each block also writes its clock64 at its start and at the end
// of each phase to the buffer compress_set_stamps names.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "compress_body.cuh"

namespace {

using namespace compress;

int set_smem(const void* kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// A cluster of C blocks a window (window blockIdx.x / C), kThreads threads.
__global__ void __launch_bounds__(kThreads, 1)
    compress_kernel(const Args a, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  body(a, blockIdx.x / C, smem, C);
}

int check(int W, int NI, int EE, int NM, int C, size_t smem) {
  if (W < 1 || NI < 1 || 2LL * NI >= kMaxStates || EE < 0 || NM < 0 ||
      C < 1 || C > kMaxC || smem > kSmemLimit ||
      smem != cluster_smem(NI, EE, NM, C))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// the launch's configuration: W clusters of C blocks
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
};

void configure(Launch* l, int W, int C, size_t smem, void* stream) {
  l->cfg = cudaLaunchConfig_t{};
  l->attr[0].id = cudaLaunchAttributeClusterDimension;
  l->attr[0].val.clusterDim.x = C;
  l->attr[0].val.clusterDim.y = 1;
  l->attr[0].val.clusterDim.z = 1;
  l->cfg.gridDim = dim3(static_cast<unsigned>(W * C));
  l->cfg.blockDim = dim3(kThreads);
  l->cfg.dynamicSmemBytes = smem;
  l->cfg.stream = static_cast<cudaStream_t>(stream);
  l->cfg.attrs = l->attr;
  l->cfg.numAttrs = 1;
}

// the stamped build's buffer (compress_set_stamps)
long long* g_stamps = nullptr;

int launch(const void* const* ins, void* const* outs, int W, int NI, int EE,
           int NM, int C, long long N, long long K, long long Dcap,
           size_t smem, void* stream) {
  int rc = check(W, NI, EE, NM, C, smem);
  if (rc != 0) return rc;
  if (kStamps && g_stamps == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  const void* const* i = ins;
  a.alive = static_cast<const uint8_t*>(i[0]);
  a.special = static_cast<const uint8_t*>(i[1]);
  a.rank = static_cast<const int64_t*>(i[2]);
  a.merlen = static_cast<const int64_t*>(i[3]);
  a.csum = static_cast<const int64_t*>(i[4]);
  a.n_t = static_cast<const int64_t*>(i[5]);
  a.is_tumor = static_cast<const uint8_t*>(i[6]);
  a.is_normal = static_cast<const uint8_t*>(i[7]);
  a.e_src = static_cast<const int64_t*>(i[8]);
  a.e_dst = static_cast<const int64_t*>(i[9]);
  a.e_dir = static_cast<const int64_t*>(i[10]);
  a.e_alive = static_cast<const uint8_t*>(i[11]);
  a.e_okey = static_cast<const int64_t*>(i[12]);
  a.mer_item = static_cast<const int64_t*>(i[13]);
  a.mer_flip = static_cast<const uint8_t*>(i[14]);
  a.mer_pos = static_cast<const int64_t*>(i[15]);
  a.keep_lo = static_cast<const int64_t*>(i[16]);
  a.keep_hi = static_cast<const int64_t*>(i[17]);
  void* const* o = outs;
  a.o_alive = static_cast<uint8_t*>(o[0]);
  a.o_merlen = static_cast<int64_t*>(o[1]);
  a.o_csum = static_cast<int64_t*>(o[2]);
  a.o_n_t = static_cast<int64_t*>(o[3]);
  a.o_is_tumor = static_cast<uint8_t*>(o[4]);
  a.o_is_normal = static_cast<uint8_t*>(o[5]);
  a.o_e_src = static_cast<int64_t*>(o[6]);
  a.o_e_dst = static_cast<int64_t*>(o[7]);
  a.o_e_dir = static_cast<int64_t*>(o[8]);
  a.o_e_alive = static_cast<uint8_t*>(o[9]);
  a.o_e_okey = static_cast<int64_t*>(o[10]);
  a.o_mer_item = static_cast<int64_t*>(o[11]);
  a.o_mer_flip = static_cast<uint8_t*>(o[12]);
  a.o_mer_pos = static_cast<int64_t*>(o[13]);
  a.o_keep_lo = static_cast<int64_t*>(o[14]);
  a.o_keep_hi = static_cast<int64_t*>(o[15]);
  a.o_fallback = static_cast<uint8_t*>(o[16]);
  a.stamps = g_stamps;
  a.NI = NI;
  a.EE = EE;
  a.NM = NM;
  jump_bounds(NI, &a.rounds, &a.dcap);
  a.N = N;
  a.K = K;
  a.Dcap = Dcap;
  const void* kern = reinterpret_cast<const void*>(compress_kernel);
  rc = set_smem(kern, smem);
  if (rc != 0) return rc;
  Launch l;
  configure(&l, W, C, smem, stream);
  return static_cast<int>(cudaLaunchKernelEx(&l.cfg, compress_kernel, a, C));
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block of a C-block cluster
// (gpu/compress.py::cluster_smem).
size_t compress_smem(int NI, int EE, int NM, int C) {
  return cluster_smem(NI, EE, NM, C);
}

// The most clusters of C blocks at `smem` the card holds at once
// (cudaOccupancyMaxActiveClusters), or -1 - the error code.
int compress_max_clusters(int C, size_t smem) {
  const void* kern = reinterpret_cast<const void*>(compress_kernel);
  int rc = set_smem(kern, smem);
  if (rc != 0) return -1 - rc;
  Launch l;
  configure(&l, 1, C, smem, nullptr);
  int n = 0;
  rc = static_cast<int>(cudaOccupancyMaxActiveClusters(&n, kern, &l.cfg));
  return rc ? -1 - rc : n;
}

// compress_round: W windows, a cluster of C blocks each; ins the 18 input
// pointers and outs the 17 output pointers in the order of
// gpu/compress.py's INPUTS and OUTPUTS (then the fallback); smem must
// equal compress_smem(NI, EE, NM, C).
int compress_round(const void* const* ins, void* const* outs, int W, int NI,
                   int EE, int NM, int C, long long N, long long K,
                   long long Dcap, size_t smem, void* stream) {
  return launch(ins, outs, W, NI, EE, NM, C, N, K, Dcap, smem, stream);
}

#ifdef COMPRESS_STAMPS
// The stamped build: the int64 buffer [W, kMaxC, kPhases] on the card that
// each later launch of W windows writes its blocks' clock64 stamps to.
void compress_set_stamps(void* stamps) {
  g_stamps = static_cast<long long*>(stamps);
}

int compress_phases() { return kPhases; }
#endif

}  // extern "C"
