// The device graph engine's component labels, its compaction and its
// low-coverage pass for Hopper (sm_90a): three kernels, one launch per
// call. Plain C interface, loaded with ctypes by gpu/graphstate.py; each
// entry point returns cudaGetLastError() after its launch.
//
// The JAX package runs them inside its jitted attempt (XLA, no Pallas):
//   components    <- lancet_tpu/tpu/stages.py::components :73 (its label
//                    propagation a lax.while_loop at :103)
//   compact_state <- lancet_tpu/tpu/stages.py::compact_state :406
//   low_cov_pass  <- lancet_tpu/tpu/stages.py::low_cov_pass :528, with
//                    item_mincovs :382 and remove_items :516
//   item_mincovs  <- lancet_tpu/tpu/stages.py::item_mincovs :382 (also
//                    cleanup's short-link stage)
// The plain PyTorch versions (gpu/stages.py::components_plain,
// compact_state_plain, low_cov_pass_plain, item_mincovs_plain) are those
// functions op for op, launched from the host: ~110, ~115 and ~60 small
// ops a call, a host sync a round of the label propagation and one for
// compact_state's hold-point. Here each is one launch, and nothing goes
// back to the host.
//
// What bounds them on this card:
// - components: a window's labels (NI 1,552 items, EE 3,872 edges at the
//   engine's first shape) are ~60 KB of int64 and bool in, 12 KB out: ~0.6
//   us of memory for W 32. The work is the serial rounds of the label
//   propagation, each a pass over the edges and three pointer jumps behind
//   block barriers, so the labels live in shared memory (int32) from the
//   first load to the last store, with the alive edges compacted beside
//   them. The rounds are the plain version's, Jacobi, double-buffered
//   (three buffers: the round's input, the relaxed labels, the jumps), and
//   a window stops at its own fixed point: a window there stays there, so
//   this equals the plain loop, which stops when no window of the batch
//   changes. The numbering (the stable argsort of each root's least alive
//   rank) ranks each root by counting over the roots, which are few.
// - compact_state: a gather; it writes ~110 KB a window (NC 528 items, EC
//   1,568 edges, NM 1,536 mers) and reads the flags and only the columns
//   of what it gathers: ~1-2 us of memory at W 32. Each block recomputes
//   the regular items' ranks (a block scan of NI flags) and then does one
//   of three parts, so a call runs 3 W blocks: the items, the edges (their
//   own scan), the mers.
// - low_cov_pass / item_mincovs: read only the kept positions of mer_totq
//   [W, NM, K] (int64: 16 MB at NM 1,536, K 41, W 32 if every position
//   were kept; the engine keeps ~1.1 a mer) and the mers' scalars: ~1.3 MB
//   a call at the engine's W 32, under 0.4 us of memory. The work is a
//   few dependent round trips, so the design cuts them: a window is a
//   thread block cluster of C blocks (gpu/graphstate.py::lowcov_plan; C 4
//   at W 32, 128 blocks), rank r taking a contiguous range of the mers,
//   the items and the edges; a lane takes a mer, loads its scalars, then
//   its kept positions (a kept window wider than kNarrow, a unitig's first
//   mer, by the whole warp, a lane a position) and keeps the minimum in a
//   register; one shared atomicMin a mer into its block's own minima; after
//   a cluster barrier each item's owner takes the minimum over the C
//   blocks' copies (DSMEM loads); low_cov_pass tests its items, keeps their
//   low flags in shared memory and, after a second barrier, clears each
//   edge of its range whose end's owner flags it. The items' and edges'
//   inputs, which wait on no minimum, are loaded beside the mers'. So a
//   call is two dependent global round trips (the scalars, then mer_totq),
//   two or three cluster barriers and the stores, where one block a window
//   (a warp a mer, eight mers' loads at a time) made ~15 dependent round
//   trips a warp and ran on 32 of 132 SMs.
// Built with -DLOWCOV_STAMPS (lowcov_split.py builds such a copy into
// build/), each low-coverage block also writes its clock64 at its start
// and at the end of each step to the buffer lowcov_set_stamps names.
//
// Inputs are the engine's tensors as they are: int64 and bool (one byte, 0
// or 1), float32 for the low-coverage threshold. Indices into shared
// memory are clamped, so data outside what the wrappers state gives wrong
// answers, never a fault.

#include <cuda_runtime.h>

#include <cstdint>

#ifndef CUDA_EMU
#include <cooperative_groups.h>
#endif

namespace {

__host__ __device__ constexpr size_t round16(size_t x) {
  return (x + 15) / 16 * 16;
}

template <class T>
__device__ __forceinline__ T clampv(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// int64 sums mod 2^64, as torch's int64 arithmetic
__device__ __forceinline__ long long add64(long long x, long long y) {
  return static_cast<long long>(static_cast<unsigned long long>(x) +
                                static_cast<unsigned long long>(y));
}

constexpr size_t kSmemLimit = 232448;  // bytes a block may use on Hopper
constexpr long long kBig = 1LL << 30;
constexpr int kBigI = 1 << 30;
constexpr int kThreads = 512;  // every kernel's block
constexpr int kMaxK = 64;      // k a mer row may have: two loads a lane
constexpr int kMaxC = 4;       // blocks a low-coverage window's cluster
// kept positions a lane loads itself; a mer's wider kept window is read by
// its warp (low_cov_pass, item_mincovs)
constexpr int kNarrow = 8;
constexpr unsigned kFull = 0xffffffffu;
// a low-coverage block's steps, stamped in the -DLOWCOV_STAMPS build
enum LowPhase {
  kLowStart, kLowInit, kLowMers, kLowSync1, kLowOwners, kLowSync2,
  kLowEdges, kLowEnd, kLowPhases
};

int set_smem(const void* kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// Exclusive ranks of the set flags f[0, n) in index order: out[i] = the
// flags set before i, for every i. Each thread counts a contiguous chunk,
// the chunks' counts are scanned across each warp with shuffles and across
// the warps through `wsum` [32]. Returns the total; ends with a barrier.
__device__ int block_exclusive(const uint8_t* f, int n, int* out,
                               int* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int T = blockDim.x, nw = T >> 5;
  const int c = (n + T - 1) / T;
  const int lo = min(tid * c, n), hi = min(lo + c, n);
  int cnt = 0;
  for (int i = lo; i < hi; ++i) cnt += f[i];
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[wid] = incl;
  __syncthreads();
  int pre = 0, total = 0;
  for (int q = 0; q < nw; ++q) {
    if (q < wid) pre += wsum[q];
    total += wsum[q];
  }
  int run = pre + incl - cnt;
  for (int i = lo; i < hi; ++i) {
    out[i] = run;
    run += f[i];
  }
  __syncthreads();
  return total;
}

// ---------------------------------------------------------------------------
// components
// ---------------------------------------------------------------------------

// Byte offsets of a components block's dynamic shared memory
// (gpu/graphstate.py::components_smem computes the same): three label
// buffers (int32), the alive edges' ends (int32), each label's least rank
// and the roots' keys (int64), the roots' items and each root's component
// (int32), the alive flags.
struct CompLayout {
  size_t lab0, lab1, lab2, es, ed, mr, rkey, ridx, cr, fl, total;
};

__host__ __device__ inline CompLayout comp_layout(int NI, int EE) {
  CompLayout L{};
  const size_t ni = NI, ee = EE;
  size_t o = 0;
  L.lab0 = o; o += round16(4 * ni);
  L.lab1 = o; o += round16(4 * ni);
  L.lab2 = o; o += round16(4 * ni);
  L.es = o;   o += round16(4 * ee);
  L.ed = o;   o += round16(4 * ee);
  L.mr = o;   o += round16(8 * ni);
  L.rkey = o; o += round16(8 * ni);
  L.ridx = o; o += round16(4 * ni);
  L.cr = o;   o += round16(4 * ni);
  L.fl = o;   o += round16(ni);
  L.total = o;
  return L;
}

struct CompArgs {
  const uint8_t* alive;    // [W, NI]
  const int64_t* e_src;    // [W, EE]
  const int64_t* e_dst;
  const uint8_t* e_alive;
  const int64_t* rank;     // [W, NI]
  int64_t* comp;           // [W, NI]
  int64_t* numcomp;        // [W]
  uint8_t* over;           // [W]
  int NI, EE;
  long long Cmax;
};

// out[i] = min(in[i], in[in[i]]) (an unlabelled item's BIG clamped to
// NI - 1, as the plain version's gather clamps it)
__device__ __forceinline__ void jump(const int* in, int* out, int NI) {
  for (int i = threadIdx.x; i < NI; i += blockDim.x) {
    const int l = in[i];
    out[i] = min(l, in[clampv(l, 0, NI - 1)]);
  }
}

// One block a window (blockIdx.x), kThreads threads.
__global__ void __launch_bounds__(kThreads) components_kernel(
    const CompArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_ne, s_nr;
  const int NI = a.NI, EE = a.EE, tid = threadIdx.x, T = blockDim.x;
  const size_t w = blockIdx.x;
  const CompLayout L = comp_layout(NI, EE);
  int* cur = reinterpret_cast<int*>(smem + L.lab0);
  int* nxt = reinterpret_cast<int*>(smem + L.lab1);
  int* tmp = reinterpret_cast<int*>(smem + L.lab2);
  int* es = reinterpret_cast<int*>(smem + L.es);
  int* ed = reinterpret_cast<int*>(smem + L.ed);
  long long* mr = reinterpret_cast<long long*>(smem + L.mr);
  long long* rkey = reinterpret_cast<long long*>(smem + L.rkey);
  int* ridx = reinterpret_cast<int*>(smem + L.ridx);
  int* cr = reinterpret_cast<int*>(smem + L.cr);
  uint8_t* fl = smem + L.fl;
  const uint8_t* alive = a.alive + w * NI;
  const int64_t* rank = a.rank + w * NI;
  const uint8_t* ea = a.e_alive + w * EE;
  const int64_t* src = a.e_src + w * EE;
  const int64_t* dst = a.e_dst + w * EE;

  if (tid == 0) {
    s_ne = 0;
    s_nr = 0;
  }
  for (int i = tid; i < NI; i += T) {
    const bool al = alive[i] != 0;
    fl[i] = al;
    cur[i] = al ? i : kBigI;
    mr[i] = kBig;
    cr[i] = 0;
  }
  __syncthreads();
  // the alive edges, in any order (a round's minima do not depend on it)
  for (int e = tid; e < EE; e += T) {
    if (ea[e]) {
      const int k = atomicAdd(&s_ne, 1);
      es[k] = static_cast<int>(clampv<long long>(src[e], 0, NI - 1));
      ed[k] = static_cast<int>(clampv<long long>(dst[e], 0, NI - 1));
    }
  }
  __syncthreads();
  const int ne = s_ne;

  // the plain version's rounds: relax every alive edge on the round's
  // labels, then three pointer jumps; until a round changes nothing
  for (;;) {
    for (int i = tid; i < NI; i += T) nxt[i] = cur[i];
    __syncthreads();
    for (int k = tid; k < ne; k += T) {
      const int s = es[k], d = ed[k];
      const int m = min(cur[s], cur[d]);
      atomicMin(&nxt[s], m);
      atomicMin(&nxt[d], m);
    }
    __syncthreads();
    jump(nxt, tmp, NI);
    __syncthreads();
    jump(tmp, nxt, NI);
    __syncthreads();
    jump(nxt, tmp, NI);  // a thread compares the items it wrote
    int ch = 0;
    for (int i = tid; i < NI; i += T) ch |= tmp[i] != cur[i];
    ch = __syncthreads_or(ch);
    int* t = cur;
    cur = tmp;
    tmp = t;
    if (!ch) break;
  }

  // each label's least alive rank (BIG the fill, as the plain scatter's)
  for (int i = tid; i < NI; i += T)
    if (fl[i]) atomicMin(&mr[clampv(cur[i], 0, NI - 1)],
                         static_cast<long long>(rank[i]));
  __syncthreads();
  for (int i = tid; i < NI; i += T) {
    if (fl[i] && cur[i] == i) {
      const int k = atomicAdd(&s_nr, 1);
      ridx[k] = i;
      rkey[k] = mr[i];
    }
  }
  __syncthreads();
  const int R = s_nr;
  // a root's place in the stable argsort of the root keys (BIG for every
  // other item): the roots before it by (key, index), and where its key
  // is BIG the other items before it
  for (int k = tid; k < R; k += T) {
    const long long key = rkey[k];
    const int r = ridx[k];
    int lt = 0, below = 0;
    for (int q = 0; q < R; ++q) {
      const long long kq = rkey[q];
      const int rq = ridx[q];
      lt += kq < key || (kq == key && rq < r);
      below += rq < r;
    }
    cr[r] = lt + (key == kBig ? r - below : 0) + 1;
  }
  __syncthreads();
  // an alive item's label is a root (its component's least alive index)
  int64_t* comp = a.comp + w * NI;
  for (int i = tid; i < NI; i += T)
    comp[i] = fl[i] ? cr[clampv(cur[i], 0, NI - 1)] : 0;
  if (tid == 0) {
    a.numcomp[w] = R;
    a.over[w] = R > a.Cmax;
  }
}

// ---------------------------------------------------------------------------
// compact_state
// ---------------------------------------------------------------------------

// Byte offsets of a compact_state block's dynamic shared memory
// (gpu/graphstate.py::compact_smem): the regular flags and ranks (then
// new_of) of the items, the alive flags and ranks of the edges.
struct CompactLayout {
  size_t fl, pos, efl, epos, total;
};

__host__ __device__ inline CompactLayout compact_layout(int NI, int EE) {
  CompactLayout L{};
  const size_t ni = NI, ee = EE;
  size_t o = 0;
  L.fl = o;   o += round16(ni);
  L.pos = o;  o += round16(4 * ni);
  L.efl = o;  o += round16(ee);
  L.epos = o; o += round16(4 * ee);
  L.total = o;
  return L;
}

struct CompactArgs {
  // inputs [W, NI] / [W, NI, 4] / [W, EE] / [W, NM]; comp may be null
  const uint8_t* alive;
  const uint8_t* special;
  const int64_t* rank;
  const int64_t* merlen;
  const int64_t* n_t;
  const uint8_t* is_tumor;
  const uint8_t* is_normal;
  const int64_t* comp;
  const int64_t* csum;
  const int64_t* e_src;
  const int64_t* e_dst;
  const int64_t* e_dir;
  const uint8_t* e_alive;
  const int64_t* e_okey;
  const int64_t* mer_item;
  const int64_t* keep_lo;
  const int64_t* keep_hi;
  // outputs [W, NC] / [W, NC, 4] / [W, EC] / [W, NM], then over and the
  // hold-point flag [W]
  uint8_t* o_alive;
  uint8_t* o_special;
  int64_t* o_rank;
  int64_t* o_merlen;
  int64_t* o_n_t;
  uint8_t* o_is_tumor;
  uint8_t* o_is_normal;
  int64_t* o_comp;
  int64_t* o_csum;
  int64_t* o_e_src;
  int64_t* o_e_dst;
  int64_t* o_e_dir;
  uint8_t* o_e_alive;
  int64_t* o_e_okey;
  int64_t* o_mer_item;
  int64_t* o_keep_hi;
  uint8_t* o_over;
  uint8_t* o_dead;
  int NI, EE, NM, N, Cmax, NCR, ECR;
};

// compact slot j of window w takes item i of the window (i < 0: the fill
// of a slot no item takes)
__device__ __forceinline__ void put_item(const CompactArgs& a, size_t w,
                                         int i, int j) {
  const size_t NI = a.NI, NC = a.NCR + 2 * a.Cmax;
  const size_t s = w * NI + i, d = w * NC + j;
  const bool on = i >= 0;
  a.o_alive[d] = on ? a.alive[s] : 0;
  a.o_special[d] = on ? a.special[s] : 0;
  a.o_rank[d] = on ? a.rank[s] : kBig;
  a.o_merlen[d] = on ? a.merlen[s] : 0;
  a.o_n_t[d] = on ? a.n_t[s] : 0;
  a.o_is_tumor[d] = on ? a.is_tumor[s] : 0;
  a.o_is_normal[d] = on ? a.is_normal[s] : 0;
  if (a.comp != nullptr) a.o_comp[d] = on ? a.comp[s] : 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) a.o_csum[d * 4 + q] = on ? a.csum[s * 4 + q] : 0;
}

// Grid (W, 3): block (w, 0) writes window w's items, (w, 1) its edges,
// over and hold-point flag, (w, 2) its mers; kThreads threads each.
__global__ void __launch_bounds__(kThreads) compact_kernel(
    const CompactArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int wsum[32];
  const int NI = a.NI, EE = a.EE, NM = a.NM, tid = threadIdx.x;
  const int T = blockDim.x, part = blockIdx.y;
  const int NCR = a.NCR, NC = NCR + 2 * a.Cmax, EC = a.ECR + 4 * a.Cmax;
  const size_t w = blockIdx.x;
  const CompactLayout L = compact_layout(NI, EE);
  uint8_t* fl = smem + L.fl;
  int* pos = reinterpret_cast<int*>(smem + L.pos);
  const uint8_t* alive = a.alive + w * NI;
  const uint8_t* special = a.special + w * NI;

  // regular items (alive, not special), packed in id order
  for (int i = tid; i < NI; i += T) fl[i] = alive[i] && !special[i];
  __syncthreads();
  const int n_reg = block_exclusive(fl, NI, pos, wsum);
  if (part == 0) {
    for (int i = tid; i < NI; i += T)
      if (fl[i] && pos[i] < NCR) put_item(a, w, i, pos[i]);
    for (int j = min(n_reg, NCR) + tid; j < NCR; j += T) put_item(a, w, -1, j);
    // the anchors' fixed slots, alive or not
    for (int c = tid; c < 2 * a.Cmax; c += T) put_item(a, w, a.N + c, NCR + c);
    return;
  }
  // new_of: a regular item's slot (clamped to NCR - 1), an anchor's fixed
  // slot, else -1
  for (int i = tid; i < NI; i += T) pos[i] = fl[i] ? min(pos[i], NCR - 1) : -1;
  __syncthreads();
  for (int c = tid; c < 2 * a.Cmax; c += T) pos[a.N + c] = NCR + c;
  __syncthreads();
  if (part == 2) {
    const int64_t* mi = a.mer_item + w * NM;
    const int64_t* lo = a.keep_lo + w * NM;
    const int64_t* hi = a.keep_hi + w * NM;
    int64_t* omi = a.o_mer_item + w * NM;
    int64_t* ohi = a.o_keep_hi + w * NM;
    for (int m = tid; m < NM; m += T) {
      const int nm = pos[clampv<long long>(mi[m], 0, NI - 1)];
      const bool dead = nm < 0;  // an empty donor interval, an inert slot
      omi[m] = dead ? NCR : nm;
      ohi[m] = dead ? lo[m] : hi[m];
    }
    return;
  }
  // the edges: alive ones packed in id order into EC rows
  uint8_t* efl = smem + L.efl;
  int* epos = reinterpret_cast<int*>(smem + L.epos);
  const uint8_t* ea = a.e_alive + w * EE;
  for (int e = tid; e < EE; e += T) efl[e] = ea[e] != 0;
  __syncthreads();
  const int n_e = block_exclusive(efl, EE, epos, wsum);
  const bool over = n_reg > NCR || n_e > EC;
  const int64_t* src = a.e_src + w * EE;
  const int64_t* dst = a.e_dst + w * EE;
  const size_t o = w * EC;
  int dead = 0;
  for (int e = tid; e < EE; e += T) {
    if (!efl[e] || epos[e] >= EC) continue;
    const size_t j = o + epos[e];
    const int ns = pos[clampv<long long>(src[e], 0, NI - 1)];
    const int nd = pos[clampv<long long>(dst[e], 0, NI - 1)];
    dead |= ns < 0 || nd < 0;
    a.o_e_src[j] = clampv(ns, 0, NC - 1);
    a.o_e_dst[j] = clampv(nd, 0, NC - 1);
    a.o_e_dir[j] = a.e_dir[w * EE + e];
    a.o_e_alive[j] = 1;
    a.o_e_okey[j] = a.e_okey[w * EE + e];
  }
  for (int j = min(n_e, EC) + tid; j < EC; j += T) {
    a.o_e_src[o + j] = 0;
    a.o_e_dst[o + j] = 0;
    a.o_e_dir[o + j] = 0;
    a.o_e_alive[o + j] = 0;
    a.o_e_okey[o + j] = kBig;
  }
  dead = __syncthreads_or(dead);
  if (tid == 0) {
    a.o_over[w] = over;
    // the hold-point, on a lane within the caps: an alive edge touches a
    // dead item (the plain version asserts it)
    a.o_dead[w] = dead && !over;
  }
}

// ---------------------------------------------------------------------------
// item_mincovs / low_cov_pass
// ---------------------------------------------------------------------------

// the cluster (tools/cuda_emu/cuda_runtime.h stands in for these on the CPU)
#ifndef CUDA_EMU
__device__ __forceinline__ int cluster_rank() {
  return static_cast<int>(cooperative_groups::this_cluster().block_rank());
}

// p, an address of this block's shared memory, in block `rank`'s
template <class T>
__device__ __forceinline__ T* peer(T* p, int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
#endif

__device__ __forceinline__ void cluster_sync_all() {
  cluster_arrive();
  cluster_wait();
}

// Byte offsets of a low-coverage block's dynamic shared memory
// (gpu/graphstate.py::lowcov_smem): the block's low flag (an int, ORed
// into the window's low.any), then over every item of the window its
// least mincov_qv (int64) of the mers this block takes, its least mincov
// (item_mincovs only), and the low flags of the items it owns
// (low_cov_pass only).
struct LowLayout {
  size_t any, qv, mc, low, total;
};

__host__ __device__ inline LowLayout low_layout(int NI, bool low) {
  LowLayout L{};
  const size_t ni = NI;
  size_t o = 0;
  L.any = o; o += 16;
  L.qv = o;  o += round16(8 * ni);
  L.mc = o;  o += low ? 0 : round16(8 * ni);
  L.low = o; o += low ? round16(ni) : 0;
  L.total = o;
  return L;
}

struct LowArgs {
  // mers [W, NM, K] / [W, NM]
  const int64_t* totq;
  const int64_t* tot;  // item_mincovs only
  const int64_t* keep_lo;
  const int64_t* keep_hi;
  const int64_t* mer_item;
  const uint8_t* mer_flip;
  // low_cov_pass only: items [W, NI] / [W, NI, 4], edges [W, EE], the
  // float threshold min_cov_ratio * avgcov [W]
  const uint8_t* alive;
  const uint8_t* special;
  const int64_t* csum;
  const int64_t* merlen;
  const int64_t* e_src;
  const int64_t* e_dst;
  const uint8_t* e_alive;
  const float* thr;
  // outputs: item_mincovs (mincov, mincov_qv) [W, NI]; low_cov_pass alive
  // [W, NI], e_alive [W, EE], low.any [W]
  int64_t* o_mincov;
  int64_t* o_mincov_qv;
  uint8_t* o_alive;
  uint8_t* o_e_alive;
  uint8_t* o_any;
  int NI, EE, NM, K;
  // the cluster's C blocks a window and each rank's range of the mers,
  // the items and the edges (rank r: [r * chunk, (r + 1) * chunk))
  int C, mch, ich, ech;
  long long totq_ws;  // mer_totq's window stride (the engine slices NM)
  long long low_cov_threshold;
#ifdef LOWCOV_STAMPS
  long long* stamps;  // [W, kMaxC, kLowPhases] clock64 stamps
#endif
};

// an item's inputs to the low test; an edge's to the removal
struct ItemIn {
  bool alive, special;
  long long merlen, tt, tn;
};

struct EdgeIn {
  bool alive;
  long long src, dst;
};

__device__ __forceinline__ ItemIn load_item(const LowArgs& a, size_t s) {
  const int64_t* cs = a.csum + s * 4;
  return {a.alive[s] != 0, a.special[s] != 0, a.merlen[s],
          add64(cs[0], cs[1]), add64(cs[2], cs[3])};
}

__device__ __forceinline__ EdgeIn load_edge(const LowArgs& a, size_t s) {
  return {a.e_alive[s] != 0, a.e_src[s], a.e_dst[s]};
}

// [r * chunk, (r + 1) * chunk) cut to [0, n)
struct Range {
  int lo, hi;
};

__device__ __forceinline__ Range range_of(int r, int chunk, int n) {
  const long long lo = min(static_cast<long long>(r) * chunk,
                           static_cast<long long>(n));
  return {static_cast<int>(lo),
          static_cast<int>(min(lo + chunk, static_cast<long long>(n)))};
}

// A cluster of C blocks a window (window blockIdx.x / C, rank blockIdx.x %
// C), kThreads threads each. Rank r takes the mers, items and edges of its
// ranges:
// 1. it issues the loads that wait on no minimum (its first items and
//    edges: low_cov_pass), sets its minima over all NI items to BIG;
// 2. a lane a mer: the mer's scalars, then its kept positions of mer_totq
//    (a narrow window by the lane itself, kNarrow loads in flight; a wider
//    one, found by a ballot, by the whole warp, a lane a position), the
//    minimum kept in a register, then one shared atomicMin into this
//    block's own minima (a mer of width <= 0 donates nothing; the plain
//    version scatters BIG, its fill, into item NI - 1);
// 3. cluster barrier; each item's minimum over the C blocks' minima, by
//    its owner (DSMEM loads): item_mincovs writes them; low_cov_pass tests
//    its items, keeps their low flags in its shared memory, ORs its block
//    flag;
// 4. low_cov_pass: cluster barrier; an edge is cleared where the owner of
//    either end flags it (DSMEM loads); rank 0 writes the OR of the
//    blocks' flags;
// 5. a last cluster barrier, so that no block leaves while another reads
//    its shared memory.
template <bool kLow>
__global__ void __launch_bounds__(kThreads) lowcov_kernel(const LowArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int NI = a.NI, NM = a.NM, K = a.K, C = a.C;
  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31;
  const int r = cluster_rank();
  const size_t w = blockIdx.x / C;
  const LowLayout L = low_layout(NI, kLow);
  int* any = reinterpret_cast<int*>(smem + L.any);
  long long* qv = reinterpret_cast<long long*>(smem + L.qv);
  long long* mc = reinterpret_cast<long long*>(smem + L.mc);
  uint8_t* low = smem + L.low;
  const Range mr = range_of(r, a.mch, NM), ir = range_of(r, a.ich, NI);
  // the stamped build's clock64 at the end of a step, when the block's
  // threads are all past it
  auto stamp = [&](int ph, bool sync) {
#ifdef LOWCOV_STAMPS
    if (sync) __syncthreads();
    if (tid == 0) a.stamps[(w * kMaxC + r) * kLowPhases + ph] = clock64();
#endif
  };
  stamp(kLowStart, false);

  // 1. the first pass's items and edges, in flight beside the mers'
  ItemIn it0{};
  EdgeIn ed0{};
  Range er{0, 0};
  if (kLow) {
    er = range_of(r, a.ech, a.EE);
    if (ir.lo + tid < ir.hi) it0 = load_item(a, w * NI + ir.lo + tid);
    if (er.lo + tid < er.hi) ed0 = load_edge(a, w * a.EE + er.lo + tid);
  }
  for (int i = tid; i < NI; i += T) {
    qv[i] = kBig;
    if (!kLow) mc[i] = kBig;
  }
  if (tid == 0) *any = 0;
  __syncthreads();
  stamp(kLowInit, false);

  // 2. the mers: lane l of warp q takes mer m0 + 32 q + l (then a block's
  // stride on), a warp-uniform loop
  const int64_t* totq = a.totq + w * a.totq_ws;
  for (int base = mr.lo + (tid & ~31); base < mr.hi; base += T) {
    const int m = base + lane;
    long long lo = 0, hi = 0, tot = 0, item = 0;
    bool f = false;
    if (m < mr.hi) {
      const size_t s = w * NM + m;
      lo = a.keep_lo[s];
      hi = a.keep_hi[s];
      f = a.mer_flip[s] != 0;
      item = a.mer_item[s];
      if (!kLow) tot = a.tot[s];
    }
    const bool on = m < mr.hi && hi - lo > 0;
    // the kept interval in the mer's canonical coordinates
    const int clo = static_cast<int>(clampv<long long>(f ? K - hi : lo, 0, K));
    const int chi = static_cast<int>(clampv<long long>(f ? K - lo : hi, 0, K));
    const int wd = on ? chi - clo : 0;
    const int64_t* row = totq + static_cast<size_t>(m) * K;
    long long v[kNarrow];
#pragma unroll
    for (int u = 0; u < kNarrow; ++u)
      v[u] = u < wd && wd <= kNarrow ? static_cast<long long>(row[clo + u])
                                    : kBig;
    long long x = kBig;
    // the wide windows (a unitig's first mer keeps up to K): a warp each
    unsigned wide = __ballot_sync(kFull, wd > kNarrow);
    while (wide) {
      const int src = __ffs(static_cast<int>(wide)) - 1;
      wide &= wide - 1;
      const int lo_u = __shfl_sync(kFull, clo, src);
      const int hi_u = __shfl_sync(kFull, chi, src);
      const int64_t* ru = totq + static_cast<size_t>(base + src) * K;
      long long y = kBig;
#pragma unroll
      for (int h = 0; h < kMaxK / 32; ++h) {
        const int j = lane + 32 * h;
        if (j >= lo_u && j < hi_u) y = min(y, static_cast<long long>(ru[j]));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        y = min(y, __shfl_xor_sync(kFull, y, o));
      if (lane == src) x = y;
    }
#pragma unroll
    for (int u = 0; u < kNarrow; ++u) x = min(x, v[u]);
    if (on) {
      const int mi = static_cast<int>(clampv<long long>(item, 0, NI - 1));
      atomicMin(&qv[mi], x);
      if (!kLow) atomicMin(&mc[mi], tot);
    }
  }
  stamp(kLowMers, true);
  cluster_sync_all();
  stamp(kLowSync1, false);

  // 3. the owners: each item's minima over the cluster's blocks
  const float thr = kLow ? a.thr[w] : 0.0f;
  int flag = 0;
  for (int i = ir.lo + tid, k = 0; i < ir.hi; i += T, ++k) {
    long long q = kBig, c = kBig;
#pragma unroll
    for (int b = 0; b < kMaxC; ++b) {
      if (b < C) {
        q = min(q, peer(qv, b)[i]);
        if (!kLow) c = min(c, peer(mc, b)[i]);
      }
    }
    const size_t s = w * NI + i;
    if (!kLow) {
      a.o_mincov[s] = c;
      a.o_mincov_qv[s] = q;
      continue;
    }
    // removeLowCov's test
    const ItemIn it = k == 0 ? it0 : load_item(a, s);
    const bool lo = it.alive && !it.special &&
                    (q <= a.low_cov_threshold || __ll2float_rn(q) <= thr ||
                     (it.tt == it.merlen && it.tn == it.merlen &&
                      it.merlen > 0));
    low[i] = lo;
    a.o_alive[s] = it.alive && !lo;
    flag |= lo;
  }
  stamp(kLowOwners, true);
  if (kLow) {
    if (flag) atomicOr(any, 1);
    cluster_sync_all();
    stamp(kLowSync2, false);
    // 4. the edges: an end's low flag is its owner's
    if (r == 0 && tid == 0) {
      int o = 0;
      for (int b = 0; b < C; ++b) o |= *peer(any, b);
      a.o_any[w] = o != 0;
    }
    for (int e = er.lo + tid, k = 0; e < er.hi; e += T, ++k) {
      const size_t s = w * a.EE + e;
      const EdgeIn ed = k == 0 ? ed0 : load_edge(a, s);
      bool keep = ed.alive;
      if (keep) {
        const int u = static_cast<int>(clampv<long long>(ed.src, 0, NI - 1));
        const int d = static_cast<int>(clampv<long long>(ed.dst, 0, NI - 1));
        keep = !peer(low, u / a.ich)[u] && !peer(low, d / a.ich)[d];
      }
      a.o_e_alive[s] = keep;
    }
    stamp(kLowEdges, true);
  }
  // 5. every DSMEM load of this block's shared memory done
  cluster_sync_all();
  stamp(kLowEnd, false);
}

template <class F>
int launch_checked(const void* kern, size_t smem, F&& go) {
  const int rc = set_smem(kern, smem);
  if (rc != 0) return rc;
  go();
  return static_cast<int>(cudaGetLastError());
}

// a low-coverage launch: W clusters of a.C blocks
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

// the ranges of W windows' clusters: C in [1, kMaxC], each range's chunk
// >= 1 and C chunks covering its axis
bool lowcov_ranges_ok(int C, long long NM, long long NI, long long EE,
                      const LowArgs& a) {
  return C >= 1 && C <= kMaxC && a.mch >= 1 && a.ich >= 1 && a.ech >= 1 &&
         C * static_cast<long long>(a.mch) >= NM &&
         C * static_cast<long long>(a.ich) >= NI &&
         C * static_cast<long long>(a.ech) >= EE;
}

#ifdef LOWCOV_STAMPS
long long* g_low_stamps = nullptr;
#endif

template <bool kLow>
int lowcov_launch(LowArgs a, int W, size_t smem, void* stream) {
#ifdef LOWCOV_STAMPS
  if (g_low_stamps == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  a.stamps = g_low_stamps;
#endif
  const void* kern = reinterpret_cast<const void*>(lowcov_kernel<kLow>);
  const int rc = set_smem(kern, smem);
  if (rc != 0) return rc;
  Launch l;
  configure(&l, W, a.C, smem, stream);
  return static_cast<int>(cudaLaunchKernelEx(&l.cfg, lowcov_kernel<kLow>, a));
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block (gpu/graphstate.py's *_smem).
size_t components_smem(int NI, int EE) { return comp_layout(NI, EE).total; }

size_t compact_smem(int NI, int EE) { return compact_layout(NI, EE).total; }

size_t lowcov_smem(int NI, int low) { return low_layout(NI, low != 0).total; }

// components: W windows; ins (alive, e_src, e_dst, e_alive, rank), outs
// (comp, numcomp, over); smem must equal components_smem.
int components(const void* const* ins, void* const* outs, int W, int NI,
               int EE, long long Cmax, size_t smem, void* stream) {
  if (W <= 0 || NI <= 0 || EE < 0 || smem != comp_layout(NI, EE).total ||
      smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  CompArgs a{};
  a.alive = static_cast<const uint8_t*>(ins[0]);
  a.e_src = static_cast<const int64_t*>(ins[1]);
  a.e_dst = static_cast<const int64_t*>(ins[2]);
  a.e_alive = static_cast<const uint8_t*>(ins[3]);
  a.rank = static_cast<const int64_t*>(ins[4]);
  a.comp = static_cast<int64_t*>(outs[0]);
  a.numcomp = static_cast<int64_t*>(outs[1]);
  a.over = static_cast<uint8_t*>(outs[2]);
  a.NI = NI;
  a.EE = EE;
  a.Cmax = Cmax;
  return launch_checked(
      reinterpret_cast<const void*>(components_kernel), smem, [&] {
        components_kernel<<<W, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(a);
      });
}

// compact_state: W windows; ins the 17 input pointers and outs the 18
// output pointers in the order of gpu/graphstate.py's COMPACT_INPUTS and
// COMPACT_OUTPUTS (comp and its output null where the state has none);
// smem must equal compact_smem.
int compact_state(const void* const* ins, void* const* outs, int W, int NI,
                  int EE, int NM, int N, int Cmax, int NCR, int ECR,
                  size_t smem, void* stream) {
  if (W <= 0 || NI <= 0 || EE < 0 || NM < 0 || NCR < 1 || ECR < 0 ||
      Cmax < 0 || N < 0 || N + 2 * Cmax > NI ||
      smem != compact_layout(NI, EE).total || smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  CompactArgs a{};
  const void* const* i = ins;
  a.alive = static_cast<const uint8_t*>(i[0]);
  a.special = static_cast<const uint8_t*>(i[1]);
  a.rank = static_cast<const int64_t*>(i[2]);
  a.merlen = static_cast<const int64_t*>(i[3]);
  a.n_t = static_cast<const int64_t*>(i[4]);
  a.is_tumor = static_cast<const uint8_t*>(i[5]);
  a.is_normal = static_cast<const uint8_t*>(i[6]);
  a.comp = static_cast<const int64_t*>(i[7]);
  a.csum = static_cast<const int64_t*>(i[8]);
  a.e_src = static_cast<const int64_t*>(i[9]);
  a.e_dst = static_cast<const int64_t*>(i[10]);
  a.e_dir = static_cast<const int64_t*>(i[11]);
  a.e_alive = static_cast<const uint8_t*>(i[12]);
  a.e_okey = static_cast<const int64_t*>(i[13]);
  a.mer_item = static_cast<const int64_t*>(i[14]);
  a.keep_lo = static_cast<const int64_t*>(i[15]);
  a.keep_hi = static_cast<const int64_t*>(i[16]);
  void* const* o = outs;
  a.o_alive = static_cast<uint8_t*>(o[0]);
  a.o_special = static_cast<uint8_t*>(o[1]);
  a.o_rank = static_cast<int64_t*>(o[2]);
  a.o_merlen = static_cast<int64_t*>(o[3]);
  a.o_n_t = static_cast<int64_t*>(o[4]);
  a.o_is_tumor = static_cast<uint8_t*>(o[5]);
  a.o_is_normal = static_cast<uint8_t*>(o[6]);
  a.o_comp = static_cast<int64_t*>(o[7]);
  a.o_csum = static_cast<int64_t*>(o[8]);
  a.o_e_src = static_cast<int64_t*>(o[9]);
  a.o_e_dst = static_cast<int64_t*>(o[10]);
  a.o_e_dir = static_cast<int64_t*>(o[11]);
  a.o_e_alive = static_cast<uint8_t*>(o[12]);
  a.o_e_okey = static_cast<int64_t*>(o[13]);
  a.o_mer_item = static_cast<int64_t*>(o[14]);
  a.o_keep_hi = static_cast<int64_t*>(o[15]);
  a.o_over = static_cast<uint8_t*>(o[16]);
  a.o_dead = static_cast<uint8_t*>(o[17]);
  if ((a.comp == nullptr) != (a.o_comp == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  a.NI = NI;
  a.EE = EE;
  a.NM = NM;
  a.N = N;
  a.Cmax = Cmax;
  a.NCR = NCR;
  a.ECR = ECR;
  return launch_checked(
      reinterpret_cast<const void*>(compact_kernel), smem, [&] {
        compact_kernel<<<dim3(W, 3), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(a);
      });
}

// item_mincovs: W windows, a cluster of C blocks each, rank r taking the
// mers [r mch, (r + 1) mch) and owning the items [r ich, (r + 1) ich);
// ins (mer_totq, mer_tot, keep_lo, keep_hi, mer_item, mer_flip), outs
// (mincov, mincov_qv); mer_totq's rows of K contiguous, totq_ws elements
// between its windows; smem must equal lowcov_smem(NI, 0).
int item_mincovs(const void* const* ins, void* const* outs, int W, int NI,
                 int NM, int K, int C, int mch, int ich, long long totq_ws,
                 size_t smem, void* stream) {
  LowArgs a{};
  a.C = C;
  a.mch = mch;
  a.ich = ich;
  a.ech = 1;
  if (W <= 0 || NI <= 0 || NM < 0 || K < 1 || K > kMaxK ||
      !lowcov_ranges_ok(C, NM, NI, 0, a) ||
      smem != low_layout(NI, false).total || smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  a.totq = static_cast<const int64_t*>(ins[0]);
  a.tot = static_cast<const int64_t*>(ins[1]);
  a.keep_lo = static_cast<const int64_t*>(ins[2]);
  a.keep_hi = static_cast<const int64_t*>(ins[3]);
  a.mer_item = static_cast<const int64_t*>(ins[4]);
  a.mer_flip = static_cast<const uint8_t*>(ins[5]);
  a.o_mincov = static_cast<int64_t*>(outs[0]);
  a.o_mincov_qv = static_cast<int64_t*>(outs[1]);
  a.NI = NI;
  a.NM = NM;
  a.K = K;
  a.totq_ws = totq_ws;
  return lowcov_launch<false>(a, W, smem, stream);
}

// low_cov_pass: W windows, a cluster of C blocks each, rank r taking the
// mers [r mch, (r + 1) mch) and the edges [r ech, (r + 1) ech) and owning
// the items [r ich, (r + 1) ich); ins (mer_totq, keep_lo, keep_hi,
// mer_item, mer_flip, alive, special, csum, merlen, e_src, e_dst, e_alive,
// thr), outs (alive, e_alive, any); mer_totq as item_mincovs takes it; smem
// must equal lowcov_smem(NI, 1).
int low_cov_pass(const void* const* ins, void* const* outs, int W, int NI,
                 int EE, int NM, int K, int C, int mch, int ich, int ech,
                 long long totq_ws, long long low_cov_threshold, size_t smem,
                 void* stream) {
  LowArgs a{};
  a.C = C;
  a.mch = mch;
  a.ich = ich;
  a.ech = ech;
  if (W <= 0 || NI <= 0 || EE < 0 || NM < 0 || K < 1 || K > kMaxK ||
      !lowcov_ranges_ok(C, NM, NI, EE, a) ||
      smem != low_layout(NI, true).total || smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  a.totq = static_cast<const int64_t*>(ins[0]);
  a.keep_lo = static_cast<const int64_t*>(ins[1]);
  a.keep_hi = static_cast<const int64_t*>(ins[2]);
  a.mer_item = static_cast<const int64_t*>(ins[3]);
  a.mer_flip = static_cast<const uint8_t*>(ins[4]);
  a.alive = static_cast<const uint8_t*>(ins[5]);
  a.special = static_cast<const uint8_t*>(ins[6]);
  a.csum = static_cast<const int64_t*>(ins[7]);
  a.merlen = static_cast<const int64_t*>(ins[8]);
  a.e_src = static_cast<const int64_t*>(ins[9]);
  a.e_dst = static_cast<const int64_t*>(ins[10]);
  a.e_alive = static_cast<const uint8_t*>(ins[11]);
  a.thr = static_cast<const float*>(ins[12]);
  a.o_alive = static_cast<uint8_t*>(outs[0]);
  a.o_e_alive = static_cast<uint8_t*>(outs[1]);
  a.o_any = static_cast<uint8_t*>(outs[2]);
  a.NI = NI;
  a.EE = EE;
  a.NM = NM;
  a.K = K;
  a.totq_ws = totq_ws;
  a.low_cov_threshold = low_cov_threshold;
  return lowcov_launch<true>(a, W, smem, stream);
}

#ifdef LOWCOV_STAMPS
// The stamped build: the int64 buffer [W, kMaxC, kLowPhases] on the card
// that each later low-coverage launch of W windows writes its blocks'
// clock64 stamps to.
void lowcov_set_stamps(void* stamps) {
  g_low_stamps = static_cast<long long*>(stamps);
}

int lowcov_phases() { return kLowPhases; }
#endif

}  // extern "C"
