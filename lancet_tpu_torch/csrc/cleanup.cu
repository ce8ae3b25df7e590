// The device graph engine's cleanup loops for Hopper (sm_90a): two kernels,
// one launch per call each. Plain C interface, loaded with ctypes by
// gpu/cleanup.py; each entry point returns the launch's error code.
//
// The JAX package runs its cleanup (lancet_tpu/tpu/pipeline.py::cleanup,
// :103) inside its jitted attempt (XLA, no Pallas):
//   tip_fixpoint       <- the removeTips fixpoint, a lax.while_loop at :167
//                         (removal rounds, compress_round under lax.cond on
//                         a hit, :160), its verify pass under lax.cond
//                         (:182), and the removeShortLinks stage under
//                         lax.cond on pre.any() (:227)
//   short_link_strings <- the short-link stage's candidates and the STR
//                         guard's string assembly (:195-215 and
//                         _short_link_str_guard, :726, up to its probe)
// The plain PyTorch versions (gpu/pipeline.py::tip_fixpoint_plain and
// short_link_stage_plain) run those loops on the host, reading a bool from
// the card every round and for the stage's gate.
//
// tip_fixpoint: one cooperative launch of a thread block cluster of C
// blocks a window (the compression body's cluster, csrc/compress_body.cuh;
// this card takes the cluster and cooperative attributes together in one
// cudaLaunchKernelEx, tools/cluster_probe.py), the JAX loop over the whole
// batch:
// - the cluster's blocks first copy their window's state (the 16 keys the
//   passes rewrite) from the inputs to the outputs, each block a C-th of
//   each key (none where an output is its input: an in-place call, as the
//   cleanup's links call); every phase after that works on the outputs in
//   place, the window's own slice of device memory. The state stays in
//   device memory between phases, not in shared memory: the removal pass
//   stages a compact layout of its own (flags, keys, edge words) and the
//   compression pass another (orders, scans, over the cluster), so one
//   staged layout for both would change both bodies; a round's extra
//   traffic is the state's ~100 KB a window, read from L2;
// - round r (tips mode) runs the removal body (csrc/removal_body.cuh) on
//   rank 0 under the tips test; rank 0 writes its window's removed_any to
//   row r of a [rounds, W] flag table, then grid.sync(); every block ORs
//   the row: where the batch hit, every window's cluster runs the
//   compression body, as lax.cond(hit, compress_round) does. The loop goes
//   on while r < rounds and (r == 0 or the last round hit); after a last
//   round that hit, the verify pass (the removal body on rank 0, its state
//   not kept). fallback |= over of every pass | fb of every compression |
//   removed_any of the verify pass. The batch-wide flag, not a per-window
//   exit: a window whose graph no longer changes still takes the compress
//   of every round the batch hit, and with it that compress's fallback
//   (mutual-buddy cycles, mid-compress self-loops), as the JAX loop does;
// - the links mode is one round with no verify: the removal body under the
//   links test (mincov, thr, guard) on rank 0, a cluster barrier, then the
//   compression body, both only where the batch gate (any of
//   short_link_strings' per-window pre flags) is set; each block ORs the W
//   flags itself, so the gate needs no zeroed buffer and no host read.
// The removal body takes a 256-thread block's work on 512 threads (every
// barrier of it is reached by all), so the block fits the compression body
// (512 threads, __launch_bounds__(512, 1)). Shared memory is one region the
// phases reuse: the larger of the two bodies' layouts (the compression's at
// the engine's shapes). A cooperative launch needs every block resident at
// once: at one block an SM (the compression body's registers), at most the
// clusters cudaOccupancyMaxActiveClusters reports (30 of 4 blocks, 66 of 2,
// 132 of 1 on an H100 SXM; gpu/cleanup.py::tip_fixpoint_plan picks C and
// refuses more windows before a launch; the launch itself refuses too).
//
// short_link_strings: one block of kSlThreads a window. The window's
// short-link candidates (alive, not special, 0 < merlen < max_link), their
// initial degrees (alive edges by source) and pre = cand & deg >= 2 &
// mincov <= thr, its OR written per window; the first kSlItems candidates
// by item index take the slots (a block scan of the candidates' counts);
// then the [kSlItems, kSlCap] base strings: fill 99, mer m's base j
// (complemented where the mer is flipped) at clamp(mer_pos + j, 0, kSlCap
// - 1) of its item's slot, for j in its kept interval. Clamped positions
// can meet: the plain version's loop over j keeps, per cell, the write of
// the largest (j, mer index) (its scatter_reduce amax over the mer index,
// then a select that lets a later j win); here every write is a shared
// atomicMax of the packed key j << 24 | m, then one pass reads each cell's
// winning mer and base. It builds strings for every window (a window
// without pre changes nothing: the guard only gates kills), so the launch
// needs no host test.
//
// What bounds them: tip_fixpoint is the compression body's time a round
// (csrc/compress.cu, about its rank 0's item chain) plus the removal
// pass's and a grid barrier a round; short_link_strings moves
// a few tens of KB a window and its atomics. Inputs are the engine's
// tensors as they are: int64 and bool (one byte, 0 or 1). Preconditions:
// those of the two bodies (alive edges' endpoints in [0, NI), NI <= 32,767,
// okeys >= 0); for short_link_strings K <= 64 and NM <= 2^24 (the packed
// key), mer_base contiguous [W, NM, K].

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "compress_body.cuh"
#include "removal_body.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr size_t kSmemLimit = 232448;  // bytes a block may use on Hopper
constexpr int kThreads = compress::kThreads;  // a tip_fixpoint block
constexpr int kKeys = 16;  // the state keys the passes rewrite

// Dynamic shared memory of a tip_fixpoint block of a C-block cluster
// (gpu/cleanup.py::tip_fixpoint_smem computes the same): the larger of the
// compression body's and, behind the body's head (whose two bytes take
// the pass's flags), the removal body's.
size_t fixpoint_smem(int NI, int EE, int NM, int U, int C) {
  const size_t c = compress::cluster_smem(NI, EE, NM, C);
  const size_t r = compress::kHead + removal::smem_bytes(NI, EE, U);
  return c > r ? c : r;
}

struct FixArgs {
  compress::Args ca;  // the outputs as both inputs and outputs (in place)
  const uint8_t* src[kKeys];  // the input state, in compress::Args order
  uint8_t* dst[kKeys];        // the output state
  long long wbytes[kKeys];    // bytes a window of each key
  const int64_t* mincov;      // links mode [W, NI]
  const int64_t* thr;         // links mode [W]
  const uint8_t* guard;       // links mode [W, NI]
  const uint8_t* gate;        // links mode [W]: short_link_strings' pre
  const uint8_t* fb_in;       // [W] or null
  uint8_t* fb_out;            // [W]
  uint8_t* hits;              // tips mode [rounds, W]
  int W, C, U, D2, mode, rounds;
  long long max_len;
};

// Block `rank`'s C-th of one window's slice of each key, input to output,
// with 16-byte moves where both slices and the length allow; none for a
// key the call rewrites in place.
__device__ __forceinline__ void copy_window(const FixArgs& f, int w,
                                            int rank) {
  const int C = f.C;
  for (int k = 0; k < kKeys; ++k) {
    if (f.src[k] == f.dst[k]) continue;
    const size_t n = static_cast<size_t>(f.wbytes[k]);
    const uint8_t* s = f.src[k] + static_cast<size_t>(w) * n;
    uint8_t* d = f.dst[k] + static_cast<size_t>(w) * n;
    if (((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(d) |
          n) & 15) == 0) {
      const uint4* s4 = reinterpret_cast<const uint4*>(s);
      uint4* d4 = reinterpret_cast<uint4*>(d);
      const size_t per = (n / 16 + C - 1) / C, lo = rank * per;
      const size_t hi = lo + per < n / 16 ? lo + per : n / 16;
      for (size_t i = lo + threadIdx.x; i < hi; i += blockDim.x) d4[i] = s4[i];
    } else {
      const size_t per = (n + C - 1) / C, lo = rank * per;
      const size_t hi = lo + per < n ? lo + per : n;
      for (size_t i = lo + threadIdx.x; i < hi; i += blockDim.x) d[i] = s[i];
    }
  }
}

// a cluster of f.C blocks a window (window blockIdx.x / C)
__global__ void __launch_bounds__(kThreads, 1)
    tip_fixpoint_kernel(const FixArgs f) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = f.C, w = blockIdx.x / C, tid = threadIdx.x, W = f.W;
  const int rank = C > 1 ? compress::cluster_rank() : 0;
  compress::Head* head = reinterpret_cast<compress::Head*>(smem);
  unsigned char* rsm = smem + compress::kHead;  // the removal pass's
  const compress::Args& a = f.ca;
  const bool tips = f.mode == 0;
  copy_window(f, w, rank);
  int gate = 0;
  if (!tips)
    for (int i = tid; i < W; i += kThreads) gate |= f.gate[i];
  gate = __syncthreads_or(gate);  // also orders the copy before the passes
  if (C > 1 && (tips || gate))
    compress::cluster_sync_all();  // and the other blocks' copies
  // the fallback so far, in rank 0's head (the registers go to the passes)
  if (rank == 0 && tid == 0) head->fb = f.fb_in != nullptr && f.fb_in[w];
  bool last = true;
  const int nr = tips ? f.rounds : 1;
  for (int r = 0; r < nr && (r == 0 || last); ++r) {
    bool hit = gate;
    if ((tips || gate) && rank == 0) {
      removal::pass<kThreads>(
          a.o_alive, a.special, a.rank, a.o_merlen, a.o_e_src, a.o_e_dst,
          a.o_e_alive, f.mincov, f.thr, f.guard, a.o_alive, a.o_e_alive,
          &head->removal[0], &head->removal[1], w, a.NI, a.EE, f.U, f.D2,
          f.mode, f.max_len, rsm);
      if (tid == 0) head->fb |= head->removal[1] != 0;
      __syncthreads();
    }
    if (tips) {
      const size_t row = static_cast<size_t>(r) * W;
      if (rank == 0 && tid == 0) f.hits[row + w] = head->removal[0];
      cg::this_grid().sync();
      int h = 0;
      for (int i = tid; i < W; i += kThreads)
        h |= *reinterpret_cast<volatile const uint8_t*>(&f.hits[row + i]);
      hit = __syncthreads_or(h);
    } else if (gate && C > 1) {
      compress::cluster_sync_all();  // the links pass's state, to every block
    }
    if (hit) {
      const bool cfb = compress::body(a, w, smem, C);
      if (rank == 0 && tid == 0) head->fb |= cfb;
      __syncthreads();
    }
    last = hit;
  }
  if (tips && last && rank == 0) {  // the verify pass: one more must
    removal::pass<kThreads>(        // remove nothing
        a.o_alive, a.special, a.rank, a.o_merlen, a.o_e_src, a.o_e_dst,
        a.o_e_alive, nullptr, nullptr, nullptr, nullptr, nullptr,
        &head->removal[0], &head->removal[1], w, a.NI, a.EE, f.U, f.D2, 0,
        f.max_len, rsm);
    if (tid == 0)
      head->fb |= head->removal[0] != 0 || head->removal[1] != 0;
  }
  if (rank == 0 && tid == 0) f.fb_out[w] = head->fb;
}

// ---------------------------------------------------------------------------
// short_link_strings
// ---------------------------------------------------------------------------

constexpr int kSlItems = 64;   // candidates a window (gpu/pipeline _SL_ITEMS)
constexpr int kSlCap = 64;     // bases a string (_SL_CAP)
constexpr int kSlThreads = 256;
constexpr int kSlMaxK = 64;    // j < 64 fits the packed key's top bits
constexpr int kSlMaxMers = 1 << 24;

// Dynamic shared memory of a short_link_strings block (gpu/cleanup.py::
// strings_smem computes the same): the degrees and the slots (int32 an
// item), the cells' packed keys.
size_t strings_smem(int NI) {
  return 2 * removal::r16(static_cast<size_t>(NI) * 4) +
         static_cast<size_t>(kSlItems) * kSlCap * 4;
}

__global__ void __launch_bounds__(kSlThreads) short_link_strings_kernel(
    const uint8_t* __restrict__ alive, const uint8_t* __restrict__ special,
    const int64_t* __restrict__ merlen, const int64_t* __restrict__ e_src,
    const uint8_t* __restrict__ e_alive, const int64_t* __restrict__ mincov,
    const int64_t* __restrict__ thr, const int64_t* __restrict__ mer_item,
    const uint8_t* __restrict__ mer_flip,
    const int64_t* __restrict__ mer_pos, const int64_t* __restrict__ keep_lo,
    const int64_t* __restrict__ keep_hi,
    const int64_t* __restrict__ mer_base, int64_t* __restrict__ seqs,
    int64_t* __restrict__ lens, int64_t* __restrict__ slot_item,
    uint8_t* __restrict__ pre_any, int NI, int EE, int NM, int K,
    long long max_link) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int wsum[kSlThreads / 32];
  int* deg0 = reinterpret_cast<int*>(smem);
  int* slot_of = reinterpret_cast<int*>(
      smem + removal::r16(static_cast<size_t>(NI) * 4));
  int* key = reinterpret_cast<int*>(
      smem + 2 * removal::r16(static_cast<size_t>(NI) * 4));
  const int w = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const size_t bi = static_cast<size_t>(w) * NI;
  const size_t be = static_cast<size_t>(w) * EE;
  const size_t bm = static_cast<size_t>(w) * NM;
  const size_t bs = static_cast<size_t>(w) * kSlItems;

  for (int i = tid; i < NI; i += kSlThreads) deg0[i] = 0;
  for (int c = tid; c < kSlItems * kSlCap; c += kSlThreads) key[c] = -1;
  __syncthreads();
  for (int e = tid; e < EE; e += kSlThreads) {
    if (!e_alive[be + e]) continue;
    const long long s = e_src[be + e];
    if (s >= 0 && s < NI) atomicAdd(&deg0[s], 1);
  }
  __syncthreads();

  // the candidates, a contiguous chunk a thread; their slots by a block
  // scan of the chunks' counts
  const long long th = thr[w];
  const int chunk = (NI + kSlThreads - 1) / kSlThreads;
  const int lo = min(tid * chunk, NI), hi = min(lo + chunk, NI);
  int cnt = 0, pre = 0;
  for (int i = lo; i < hi; ++i) {
    const long long ml = merlen[bi + i];
    const bool cand =
        alive[bi + i] && !special[bi + i] && ml < max_link && ml > 0;
    slot_of[i] = cand;
    cnt += cand;
    pre |= cand && deg0[i] >= 2 && mincov[bi + i] <= th;
  }
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[wid] = incl;
  __syncthreads();
  int base = incl - cnt, n_cand = 0;
  for (int k = 0; k < kSlThreads / 32; ++k) {
    if (k < wid) base += wsum[k];
    n_cand += wsum[k];
  }
  for (int i = lo; i < hi; ++i) {
    if (slot_of[i]) {
      slot_of[i] = base < kSlItems ? base : -1;
      ++base;
    } else {
      slot_of[i] = -1;
    }
  }
  pre = __syncthreads_or(pre);
  if (tid == 0) pre_any[w] = pre != 0;
  for (int i = tid; i < NI; i += kSlThreads) {
    const int s = slot_of[i];
    if (s < 0) continue;
    slot_item[bs + s] = i;
    lens[bs + s] = merlen[bi + i] + K - 1;
  }
  for (int s = n_cand + tid; s < kSlItems; s += kSlThreads) {
    slot_item[bs + s] = -1;
    lens[bs + s] = 0;
  }

  // every kept base of a candidate's mers: the packed key of its write
  for (int m = tid; m < NM; m += kSlThreads) {
    const long long it = mer_item[bm + m];
    const int mi = static_cast<int>(it < 0 ? 0 : (it > NI - 1 ? NI - 1 : it));
    const int s = slot_of[mi];
    if (s < 0) continue;
    const long long klo = keep_lo[bm + m], khi = keep_hi[bm + m];
    const long long pos = mer_pos[bm + m];
    const int jlo = static_cast<int>(klo > 0 ? klo : 0);
    const int jhi = static_cast<int>(khi < K ? khi : K);
    for (int j = jlo; j < jhi; ++j) {
      const long long p = static_cast<long long>(
          static_cast<unsigned long long>(pos) + static_cast<unsigned>(j));
      const int t = static_cast<int>(p < 0 ? 0 : (p > kSlCap - 1 ? kSlCap - 1
                                                                 : p));
      atomicMax(&key[s * kSlCap + t], (j << 24) | m);
    }
  }
  __syncthreads();
  for (int c = tid; c < kSlItems * kSlCap; c += kSlThreads) {
    const int k = key[c];
    long long v = 99;
    if (k >= 0) {
      const int m = k & (kSlMaxMers - 1), j = k >> 24;
      const bool fl = mer_flip[bm + m];
      const long long b =
          mer_base[(bm + m) * static_cast<size_t>(K) + (fl ? K - 1 - j : j)];
      v = fl ? b ^ 3 : b;
    }
    seqs[bs * kSlCap + c] = v;
  }
}

int set_smem(const void* kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// tip_fixpoint's launch: W clusters of C blocks, cooperative
struct FixLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
};

void fix_configure(FixLaunch* l, int W, int C, size_t smem, void* stream) {
  l->cfg = cudaLaunchConfig_t{};
  l->attr[0].id = cudaLaunchAttributeClusterDimension;
  l->attr[0].val.clusterDim.x = C;
  l->attr[0].val.clusterDim.y = 1;
  l->attr[0].val.clusterDim.z = 1;
  l->attr[1].id = cudaLaunchAttributeCooperative;
  l->attr[1].val.cooperative = 1;
  l->cfg.gridDim = dim3(static_cast<unsigned>(W * C));
  l->cfg.blockDim = dim3(kThreads);
  l->cfg.dynamicSmemBytes = smem;
  l->cfg.stream = static_cast<cudaStream_t>(stream);
  l->cfg.attrs = l->attr;
  l->cfg.numAttrs = 2;
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block of each kernel (gpu/cleanup.py).
size_t tip_fixpoint_smem(int NI, int EE, int NM, int U, int C) {
  return fixpoint_smem(NI, EE, NM, U, C);
}

size_t short_link_strings_smem(int NI) { return strings_smem(NI); }

// The most clusters of C blocks at `smem` a cooperative launch of
// tip_fixpoint holds at once (cudaOccupancyMaxActiveClusters), or -1 -
// the error code.
int tip_fixpoint_max_clusters(int C, size_t smem) {
  const void* kern = reinterpret_cast<const void*>(tip_fixpoint_kernel);
  int rc = set_smem(kern, smem);
  if (rc != 0) return -1 - rc;
  FixLaunch l;
  fix_configure(&l, 1, C, smem, nullptr);
  int n = 0;
  rc = static_cast<int>(cudaOccupancyMaxActiveClusters(&n, kern, &l.cfg));
  return rc ? -1 - rc : n;
}

// tip_fixpoint: W windows, a cluster of C blocks each; ins and outs the 16
// state keys in the order of
// gpu/cleanup.py's STATE (compress_round's outputs); special and rank [W,
// NI]; the links mode (1) also mincov, thr, guard and gate (null in the
// tips mode, 0); a key's out may be its in (in place), no other overlap;
// fb_in [W] or null; fb_out [W]; hits [rounds, W] bytes of
// scratch (tips mode); smem must equal tip_fixpoint_smem(..., C). A grid
// that cannot be resident at once is refused
// (cudaErrorCooperativeLaunchTooLarge).
int tip_fixpoint(const void* const* ins, void* const* outs,
                 const void* special, const void* rank, const void* mincov,
                 const void* thr, const void* guard, const void* gate,
                 const void* fb_in, void* fb_out, void* hits, int W, int C,
                 int NI, int EE, int NM, int U, int D2, int mode, int rounds,
                 long long max_len, long long N, long long K, long long Dcap,
                 size_t smem, void* stream) {
  if (W < 1 || C < 1 || C > compress::kMaxC || NI < 1 ||
      NI > removal::kMaxItems ||
      2LL * NI >= compress::kMaxStates || EE < 0 || NM < 0 || U < 0 ||
      D2 < 1 || mode < 0 || mode > 1 || rounds < 0 ||
      (mode == 0 && rounds > 0 && hits == nullptr) ||
      (mode == 1 && (mincov == nullptr || thr == nullptr ||
                     guard == nullptr || gate == nullptr)) ||
      smem != fixpoint_smem(NI, EE, NM, U, C) || smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  FixArgs f{};
  compress::Args& a = f.ca;
  // compress::Args' inputs: alive, special, rank, merlen, csum, n_t,
  // is_tumor, is_normal, e_src, e_dst, e_dir, e_alive, e_okey, mer_item,
  // mer_flip, mer_pos, keep_lo, keep_hi; the state keys are its outputs
  void* const* o = outs;
  a.alive = static_cast<const uint8_t*>(o[0]);
  a.special = static_cast<const uint8_t*>(special);
  a.rank = static_cast<const int64_t*>(rank);
  a.merlen = static_cast<const int64_t*>(o[1]);
  a.csum = static_cast<const int64_t*>(o[2]);
  a.n_t = static_cast<const int64_t*>(o[3]);
  a.is_tumor = static_cast<const uint8_t*>(o[4]);
  a.is_normal = static_cast<const uint8_t*>(o[5]);
  a.e_src = static_cast<const int64_t*>(o[6]);
  a.e_dst = static_cast<const int64_t*>(o[7]);
  a.e_dir = static_cast<const int64_t*>(o[8]);
  a.e_alive = static_cast<const uint8_t*>(o[9]);
  a.e_okey = static_cast<const int64_t*>(o[10]);
  a.mer_item = static_cast<const int64_t*>(o[11]);
  a.mer_flip = static_cast<const uint8_t*>(o[12]);
  a.mer_pos = static_cast<const int64_t*>(o[13]);
  a.keep_lo = static_cast<const int64_t*>(o[14]);
  a.keep_hi = static_cast<const int64_t*>(o[15]);
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
  a.o_fallback = nullptr;
  a.stamps = nullptr;
  a.NI = NI;
  a.EE = EE;
  a.NM = NM;
  compress::jump_bounds(NI, &a.rounds, &a.dcap);
  a.N = N;
  a.K = K;
  a.Dcap = Dcap;
  // bytes a window: items 1/8/32/8/1/1, edges 8/8/8/1/8, mers 8/1/8/8/8
  const long long ni = NI, ee = EE, nm = NM;
  const long long wb[kKeys] = {ni,     8 * ni, 32 * ni, 8 * ni, ni,     ni,
                               8 * ee, 8 * ee, 8 * ee,  ee,     8 * ee, 8 * nm,
                               nm,     8 * nm, 8 * nm,  8 * nm};
  for (int k = 0; k < kKeys; ++k) {
    f.src[k] = static_cast<const uint8_t*>(ins[k]);
    f.dst[k] = static_cast<uint8_t*>(outs[k]);
    f.wbytes[k] = wb[k];
  }
  f.mincov = static_cast<const int64_t*>(mincov);
  f.thr = static_cast<const int64_t*>(thr);
  f.guard = static_cast<const uint8_t*>(guard);
  f.gate = static_cast<const uint8_t*>(gate);
  f.fb_in = static_cast<const uint8_t*>(fb_in);
  f.fb_out = static_cast<uint8_t*>(fb_out);
  f.hits = static_cast<uint8_t*>(hits);
  f.W = W;
  f.C = C;
  f.U = U;
  f.D2 = D2;
  f.mode = mode;
  f.rounds = rounds;
  f.max_len = max_len;
  const void* kern = reinterpret_cast<const void*>(tip_fixpoint_kernel);
  int rc = set_smem(kern, smem);
  if (rc != 0) return rc;
  FixLaunch l;
  fix_configure(&l, W, C, smem, stream);
  return static_cast<int>(cudaLaunchKernelEx(&l.cfg, tip_fixpoint_kernel, f));
}

// short_link_strings: W windows; ins alive, special, merlen [W, NI], e_src,
// e_alive [W, EE], mincov [W, NI], thr [W], mer_item, mer_flip, mer_pos,
// keep_lo, keep_hi [W, NM], mer_base [W, NM, K]; outs seqs [W, kSlItems,
// kSlCap], lens and slot_item [W, kSlItems] (int64), pre_any [W]; smem
// must equal short_link_strings_smem.
int short_link_strings(const void* const* ins, void* const* outs, int W,
                       int NI, int EE, int NM, int K, long long max_link,
                       size_t smem, void* stream) {
  if (W < 1 || NI < 1 || EE < 0 || NM < 0 || NM > kSlMaxMers || K < 1 ||
      K > kSlMaxK || smem != strings_smem(NI) || smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kern =
      reinterpret_cast<const void*>(short_link_strings_kernel);
  int rc = set_smem(kern, smem);
  if (rc != 0) return rc;
  const void* const* i = ins;
  short_link_strings_kernel<<<W, kSlThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(i[0]), static_cast<const uint8_t*>(i[1]),
      static_cast<const int64_t*>(i[2]), static_cast<const int64_t*>(i[3]),
      static_cast<const uint8_t*>(i[4]), static_cast<const int64_t*>(i[5]),
      static_cast<const int64_t*>(i[6]), static_cast<const int64_t*>(i[7]),
      static_cast<const uint8_t*>(i[8]), static_cast<const int64_t*>(i[9]),
      static_cast<const int64_t*>(i[10]), static_cast<const int64_t*>(i[11]),
      static_cast<const int64_t*>(i[12]), static_cast<int64_t*>(outs[0]),
      static_cast<int64_t*>(outs[1]), static_cast<int64_t*>(outs[2]),
      static_cast<uint8_t*>(outs[3]), NI, EE, NM, K, max_link);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
