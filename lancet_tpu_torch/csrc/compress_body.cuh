// One window's unitig compression pass as a __device__ function of a
// thread block cluster of C blocks (C = 1 to kMaxC): the body of
// compress_kernel (csrc/compress.cu, whose head comment sets out the
// design) and of the compress rounds of tip_fixpoint (csrc/cleanup.cu).
// Built with -DCOMPRESS_STAMPS, each block also writes its clock64 at its
// start and at the end of each of its steps to a.stamps.
//
// The cluster's roles (roles()): rank 0 runs the item chain (the links, the
// pointer jumping, the chain merge, the items' order, their aggregates,
// start_off and the item outputs) and keeps the window's item arrays; the
// other ranks are the workers, each holding one contiguous range of the
// edges and one of the mers; rank 1 owns the mers' order and rank C - 1
// the edges' (at C = 2 rank 1 both). A worker writes its range's keys into
// the owner's shared memory (stores, and shared atomics for the counts)
// and reads rank 0's item arrays where they are; an owner orders the whole
// window in one block. The steps follow the data, not the old phase
// order: the edges' keys and slots need only the edge inputs and run
// while rank 0 links and jumps; the edge outputs and the mers' keys (with
// the outputs no order moves: mer_item, mer_flip) need the merge and run
// while rank 0 orders its items; the mers' order by counting needs no
// start_off (a member mer's place is its item's run start plus its rank)
// and runs, with the kept intervals' junction trims it gives, while rank 0
// scans; after start_off rank 0 tests whether a member's new_pos leave
// [0, 8191] (in which case, or where counting failed, the owner sorts and
// trims again) while the workers write new_pos (start_off plus the rank
// the owner keeps). Seven cluster barriers (barrier.cluster.arrive.release /
// wait.acquire; the sort's only where it runs) order the steps; rank 0
// arrives early at those it does not feed and waits late. Each worker
// stages its mers' range of the five mer inputs in its shared memory with
// cp.async.bulk on an mbarrier, issued behind its edge loads. At C = 1 the
// one block runs every step in the old order, the mers' and edges' arrays
// in the scratch the items leave. Every order stays the one-block order: a
// member mer's place and an edge's slot do not depend on which rank
// counted what, the counts being totals (shared atomics into the owner)
// and an edge's slot its rank by (clamped okey, index) in its source's
// whole bucket.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <utility>

#ifndef CUDA_EMU
#include <cooperative_groups.h>
#endif

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
// 512 threads a block leave each 128 registers: a block takes up to ~220
// KB of shared memory, so the L1 left cannot hold the local memory of
// spilled registers, whose loads would each go to L2
constexpr int kThreads = 512;
constexpr int kMaxC = 4;       // blocks a window's cluster may take
constexpr int kU = 4;          // loads in flight a thread, streaming loops
constexpr int kUI = 2;         // items a thread, the aggregates' loads
constexpr int kUO = 2;         // mers or edges a thread, the owners' keys
constexpr int kDBits = 13;     // dist bits of a pointer-jumping word
constexpr int kDMask = (1 << kDBits) - 1;
constexpr int kMaxStates = 1 << 18;  // state ids fit the packed word
constexpr long long kBig = 1LL << 30;
constexpr int kOkb = 14;       // okey bits of the edge renorm's key
constexpr long long kOkMax = (1LL << kOkb) - 1;
// clock64 stamps of the stamped build, a rank: its start, then the end of
// each step (PHASES in compress_split.py), and after its first cluster
// barrier and the one start_off feeds
enum Phase {
  kStart, kLinks, kJump, kMerge, kItemOrder, kItemGather, kItemScan,
  kStartOff, kItemOut, kMerKeys, kMerOrder, kMerCheck, kMerOut, kEdgeKeys,
  kEdgeSlots, kEdgeOut, kEnd, kSync0, kSync4, kPhases
};
#ifdef COMPRESS_STAMPS
constexpr bool kStamps = true;
#else
constexpr bool kStamps = false;
#endif
constexpr int kLanes = 8;      // item aggregates: merlen, csum[4], n_t, T, N
constexpr int kScanWarps = 8;  // warps a block scan runs on
constexpr int kStaged = 5;     // mer inputs a worker stages (C >= 2)

// item flags
constexpr uint32_t fAlive = 1, fSpecial = 2, fTandem = 4, fValid0 = 8,
                   fValid1 = 16, fFlip = 32, fAu = 64;

// ---------------------------------------------------------------------------
// the cluster and the bulk copies (tools/cuda_emu/cuda_runtime.h stands in
// for them on the CPU)
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one thread: the staging barrier armed for `bytes` of bulk copies, after
// the generic proxy's earlier accesses (this block's shared memory, the
// state in device memory the last pass wrote)
__device__ __forceinline__ void stage_begin(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// one thread: `bytes` (a multiple of 16) from src to dst (both 16-aligned)
__device__ __forceinline__ void stage_copy(void* dst, const void* src,
                                           unsigned bytes,
                                           unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// one thread, once every thread has waited: the barrier invalidated, so
// that the next pass may initialise it again
__device__ __forceinline__ void stage_end(unsigned long long* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// every thread: until the staged bytes have landed
__device__ __forceinline__ void stage_wait(unsigned long long* bar) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(0)
        : "memory");
}

// one thread: `bytes` (a multiple of 16) at p (16-aligned) into L2
__device__ __forceinline__ void prefetch_l2(const void* p, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p),
               "r"(bytes)
               : "memory");
}
#else
using ::cluster_arrive;
using ::cluster_rank;
using ::cluster_wait;
using ::peer;
using ::prefetch_l2;
using ::stage_begin;
using ::stage_copy;
using ::stage_end;
using ::stage_wait;
#endif

__device__ __forceinline__ void cluster_sync_all() {
  cluster_arrive();
  cluster_wait();
}

// the 16-aligned span of device memory that holds [p, p + bytes)
__device__ __forceinline__ const unsigned char* span_lo(const void* p) {
  return reinterpret_cast<const unsigned char*>(
      reinterpret_cast<uintptr_t>(p) & ~static_cast<uintptr_t>(15));
}

__device__ __forceinline__ unsigned span_bytes(const void* p, size_t bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return static_cast<unsigned>(((a + bytes + 15) & ~static_cast<uintptr_t>(15))
                               - (a & ~static_cast<uintptr_t>(15)));
}

// ---------------------------------------------------------------------------
// layouts
// ---------------------------------------------------------------------------

// Every block's dynamic shared memory begins with a Head, then the block
// scans' scratch (red [nl * 32], part [nl * kScanWarps * 32] int64: nl =
// kLanes on rank 0, 1 on the others), then its role's arrays.
struct Head {
  unsigned long long bar;  // the staging's mbarrier (ranks >= 1, C >= 2)
  int loop;     // rank 0: a kept edge's ends meet (the edge workers OR it)
  int out;      // rank 0: a member item's new_pos leave [0, 8191]
  int mbad;     // the mers' owner: the order by counting failed
  int fb;       // tip_fixpoint, rank 0: the window's fallback so far
  uint8_t removal[2];  // tip_fixpoint: a removal pass's removed_any, over
};
constexpr size_t kHead = 64;
static_assert(sizeof(Head) <= kHead, "Head outgrew kHead");

__host__ __device__ constexpr size_t scan_bytes(int nl) {
  return static_cast<size_t>(nl) * (32 + kScanWarps * 32) * 8;
}

// rank 0's arrays (at C = 1 the whole window's), offsets from the block's
// base: the items' flags, label, survivor, pos_u (int32), start_off and
// merlen (int64), kept for the whole pass; then one scratch region each
// step lays out for itself:
// - links, pointer jumping, merge: two state-word buffers, the per-label
//   min and max, the items' combo words;
// - items: the sort's keys and indices, run starts, each item's sorted
//   position, run ends, the labels' counts, eight lanes of inclusive sums,
//   the run base;
// - at C = 1 also the mers' and the edges' (MerLayout, EdgeLayout).
struct Layout {
  size_t red, part;
  size_t fl, lab, sit, posu, soff, iml, scr;
  // links / jump / merge
  size_t p0, p1, cmin, citems, combo;
  // items
  size_t ik, ix, inr, kpos, rend, icnt, lanes, irb;
  size_t lane_ld;  // int64 elements between lanes
  size_t total;
};

// the mers' owner's arrays, offsets from its base: the sort's keys and
// indices (pm, a power of two), run starts, run ends, the widths, their
// inclusive sums, the run base, after and before (a mer each), the member
// items' width totals, run ends by count and counts (an item each), each
// mer's item (-1 - item for a non-member), rank, survivor, flags (its
// item flipped, a member, facing the survivor's low side) and kept
// interval's low end: what the mer outputs read, gathered beside the keys
struct MerLayout {
  size_t mk, mx, mnr, mrend, wb, cw, mrb, maft, mbef, mtot, mbase, mcnt,
      mmi, mr, msur, mflg, mklo, total;
};

// the edges' owner's: each edge's slot; the sources' degrees, cursors and
// offsets; the buckets, each edge's clamped okey and source
struct EdgeLayout {
  size_t slot, deg, curs, off, bkt, ok2e, esrc, total;
};

__host__ __device__ inline MerLayout mer_layout(int NI, int NM) {
  MerLayout L{};
  const size_t ni = NI, nm = NM, pm = pow2_at_least(NM);
  size_t s = 0;
  L.mk = s;    s += round16(8 * pm);
  L.mx = s;    s += round16(4 * pm);
  L.mnr = s;   s += round16(nm);
  L.mrend = s; s += round16(4 * nm);
  L.wb = s;    s += round16(8 * nm);
  L.cw = s;    s += round16(8 * nm);
  L.mrb = s;   s += round16(8 * nm);
  L.maft = s;  s += round16(8 * nm);
  L.mbef = s;  s += round16(8 * nm);
  L.mtot = s;  s += round16(8 * ni);
  L.mbase = s; s += round16(8 * ni);
  L.mcnt = s;  s += round16(4 * ni);
  L.mmi = s;   s += round16(4 * nm);
  L.mr = s;    s += round16(8 * nm);
  L.msur = s;  s += round16(4 * nm);
  L.mflg = s;  s += round16(nm);
  L.mklo = s;  s += round16(8 * nm);
  L.total = s;
  return L;
}

__host__ __device__ inline EdgeLayout edge_layout(int NI, int EE) {
  EdgeLayout L{};
  const size_t ni = NI, ee = EE;
  size_t s = 0;
  L.slot = s; s += round16(4 * ee);
  L.deg = s;  s += round16(4 * ni);
  L.curs = s; s += round16(4 * ni);
  L.off = s;  s += round16(8 * ni);
  L.bkt = s;  s += round16(4 * ee);
  L.ok2e = s; s += round16(4 * ee);
  L.esrc = s; s += round16(4 * ee);
  L.total = s;
  return L;
}

// rank 0's layout; `one`: C = 1, the mers' and edges' arrays in its scratch
__host__ __device__ inline Layout layout(int NI, int EE, int NM, bool one) {
  Layout L{};
  const size_t ni = NI, S = 2 * ni;
  const size_t pi = pow2_at_least(NI);
  size_t o = kHead;
  L.red = o;
  L.part = o + 32 * kLanes * 8;
  o += scan_bytes(kLanes);
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
  if (one) {
    const size_t m = mer_layout(NI, NM).total, e = edge_layout(NI, EE).total;
    need = m > need ? m : need;
    need = e > need ? e : need;
  }
  L.total = o + need;
  return L;
}

// the mers' and the edges' owners' arrays, offsets from their blocks' bases
// (at C = 1 both in rank 0's scratch, one after the other in time)
__host__ __device__ inline size_t mers_off(int NI, int EE, int NM, int C) {
  return C == 1 ? layout(NI, EE, NM, true).scr : kHead + scan_bytes(1);
}

__host__ __device__ inline size_t edges_off(int NI, int EE, int NM, int C) {
  return C == 1 ? layout(NI, EE, NM, true).scr
                : kHead + scan_bytes(1) +
                      (C == 2 ? mer_layout(NI, NM).total : 0);
}

// A worker's contiguous range of n elements: chunks of a multiple of 16
__host__ __device__ inline int range_chunk(int n, int nw) {
  const int c = (n + nw - 1) / nw;
  return (c + 15) / 16 * 16;
}

// the staged mers' range (C >= 2): mer_item, mer_pos, keep_lo, keep_hi
// (int64) and mer_flip (bytes), each in a buffer 16 bytes longer than its
// chunk (a slice's 16-aligned span)
__host__ __device__ inline size_t stage_key_bytes(int chunk, int k) {
  return round16(static_cast<size_t>(chunk) * (k < 4 ? 8 : 1)) + 16;
}

struct Roles {
  int nw, wi;               // workers, this worker's index
  bool items, mo, eo, stage;
  size_t red, part;         // the scans' scratch
  size_t ms, es, st;        // the mers', edges' and staged arrays
  size_t total;             // this block's bytes
};

__host__ __device__ inline Roles roles(int NI, int EE, int NM, int C,
                                       int rank) {
  Roles R{};
  R.nw = C > 1 ? C - 1 : 1;
  R.items = rank == 0;
  R.wi = C == 1 ? 0 : rank - 1;
  R.mo = C == 1 ? true : rank == 1;
  R.eo = C == 1 ? true : rank == C - 1;
  R.stage = C >= 2 && rank > 0;
  if (rank == 0) {
    const Layout L = layout(NI, EE, NM, C == 1);
    R.red = L.red;
    R.part = L.part;
    R.ms = R.es = L.scr;
    R.total = L.total;
    return R;
  }
  size_t o = kHead + scan_bytes(1);
  R.red = kHead;
  R.part = kHead + 32 * 8;
  if (R.mo) {
    R.ms = mers_off(NI, EE, NM, C);
    o = R.ms + mer_layout(NI, NM).total;
  }
  if (R.eo) {
    R.es = edges_off(NI, EE, NM, C);
    o = R.es + edge_layout(NI, EE).total;
  }
  if (R.stage) {
    R.st = o;
    const int ch = range_chunk(NM, R.nw);
    for (int k = 0; k < kStaged; ++k) o += stage_key_bytes(ch, k);
  }
  R.total = o;
  return R;
}

// the dynamic shared memory of a cluster of C blocks (every block takes
// the launch's one size): its largest rank's
__host__ __device__ inline size_t cluster_smem(int NI, int EE, int NM,
                                               int C) {
  size_t m = 0;
  for (int r = 0; r < C; ++r) {
    const size_t t = roles(NI, EE, NM, C, r).total;
    m = t > m ? t : m;
  }
  return m;
}

// ---------------------------------------------------------------------------
// block-wide scans and sorts
// ---------------------------------------------------------------------------

// Inclusive scans, in place, of nl <= kLanes arrays of n int64 (lane l at
// a + l * ld): sums mod 2^64 or running maxima, all behind the same two
// barriers. The first kScanWarps warps take contiguous chunks of
// ceil(n / (32 kScanWarps)) elements, scan them serially, scan the chunks'
// totals across each warp with shuffles (kept in `part` [nl * 32
// kScanWarps]), and add the warps before theirs from `red` [nl * 32]; the
// other warps wait at the barriers. One copy, not inlined, and the lanes
// in a loop: a block runs each stretch of its code about once, so code a
// call site or a lane would add costs its fetch.
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
  long long* stamps;  // [W, kMaxC, kPhases] clock64 (the stamped build)
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

// ---------------------------------------------------------------------------
// the steps
// ---------------------------------------------------------------------------

// rank 0's item arrays, in whichever block reads them
struct Items {
  const uint32_t* fl;
  const int* sit;
  const int* posu;
  const long long* soff;
  const long long* iml;
};

// from rank 0's base (this block's, or its peer address): the arrays of
// layout()'s keep region
__device__ __forceinline__ Items items_at(const unsigned char* base, int NI) {
  const size_t a = round16(4 * static_cast<size_t>(NI));
  const size_t b = round16(8 * static_cast<size_t>(NI));
  const unsigned char* k = base + kHead + scan_bytes(kLanes);
  Items it;
  it.fl = reinterpret_cast<const uint32_t*>(k);
  it.sit = reinterpret_cast<const int*>(k + 2 * a);
  it.posu = reinterpret_cast<const int*>(k + 3 * a);
  it.soff = reinterpret_cast<const long long*>(k + 4 * a);
  it.iml = reinterpret_cast<const long long*>(k + 4 * a + b);
  return it;
}

// the mers' owner's arrays
struct Mers {
  long long *mk, *wb, *cw, *mrb, *maft, *mbef, *mbase, *mr, *mklo;
  unsigned long long* mtot;
  int *mx, *mrend, *mcnt, *mmi, *msur;
  uint8_t *mnr, *mflg;
};

// a mer's flags (Mers::mflg)
constexpr uint8_t mFlip = 1, mMember = 2, mFacingLow = 4;

__device__ __forceinline__ Mers mers_at(unsigned char* base, int NI, int NM) {
  const MerLayout L = mer_layout(NI, NM);
  Mers m;
  m.mk = reinterpret_cast<long long*>(base + L.mk);
  m.mx = reinterpret_cast<int*>(base + L.mx);
  m.mnr = base + L.mnr;
  m.mrend = reinterpret_cast<int*>(base + L.mrend);
  m.wb = reinterpret_cast<long long*>(base + L.wb);
  m.cw = reinterpret_cast<long long*>(base + L.cw);
  m.mrb = reinterpret_cast<long long*>(base + L.mrb);
  m.maft = reinterpret_cast<long long*>(base + L.maft);
  m.mbef = reinterpret_cast<long long*>(base + L.mbef);
  m.mtot = reinterpret_cast<unsigned long long*>(base + L.mtot);
  m.mbase = reinterpret_cast<long long*>(base + L.mbase);
  m.mcnt = reinterpret_cast<int*>(base + L.mcnt);
  m.mmi = reinterpret_cast<int*>(base + L.mmi);
  m.mr = reinterpret_cast<long long*>(base + L.mr);
  m.msur = reinterpret_cast<int*>(base + L.msur);
  m.mflg = base + L.mflg;
  m.mklo = reinterpret_cast<long long*>(base + L.mklo);
  return m;
}

// the edges' owner's arrays
struct Edges {
  int *slot, *deg, *curs, *bkt, *ok2e, *esrc;
  long long* off;
};

__device__ __forceinline__ Edges edges_at(unsigned char* base, int NI,
                                          int EE) {
  const EdgeLayout L = edge_layout(NI, EE);
  Edges e;
  e.slot = reinterpret_cast<int*>(base + L.slot);
  e.deg = reinterpret_cast<int*>(base + L.deg);
  e.curs = reinterpret_cast<int*>(base + L.curs);
  e.off = reinterpret_cast<long long*>(base + L.off);
  e.bkt = reinterpret_cast<int*>(base + L.bkt);
  e.ok2e = reinterpret_cast<int*>(base + L.ok2e);
  e.esrc = reinterpret_cast<int*>(base + L.esrc);
  return e;
}

template <class T>
__device__ __forceinline__ T* at(unsigned char* p, size_t off) {
  return reinterpret_cast<T*>(p + off);
}

// the owners' counters, before any worker adds to them
__device__ __forceinline__ void mers_init(unsigned char* mob, int NI,
                                          int NM) {
  const Mers m = mers_at(mob, NI, NM);
  for (int i = threadIdx.x; i < NI; i += blockDim.x) {
    m.mcnt[i] = 0;
    m.mtot[i] = 0;
  }
  for (int k = threadIdx.x; k < NM; k += blockDim.x) m.mx[k] = -1;
}

__device__ __forceinline__ void edges_init(unsigned char* eob, int NI,
                                           int EE) {
  const Edges e = edges_at(eob, NI, EE);
  for (int i = threadIdx.x; i < NI; i += blockDim.x) e.deg[i] = 0;
}

// The item chain's first part (rank 0): links, the pointer jumping, the
// chain merge. Returns cyc (a dist past NI - 1) to every thread.
template <class F>
__device__ __forceinline__ int items_merge(const Args& a, const Layout& L,
                                           unsigned char* smem, size_t io,
                                           size_t eo, const F& stamp) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int NI = a.NI, EE = a.EE, S = 2 * NI;
  uint32_t* fl = at<uint32_t>(smem, L.fl);
  int* lab = at<int>(smem, L.lab);
  int* sit = at<int>(smem, L.sit);
  int* posu = at<int>(smem, L.posu);
  long long* iml = at<long long>(smem, L.iml);
  unsigned char* scr = smem + L.scr;

  // ---- links ------------------------------------------------------------
  int* p0 = reinterpret_cast<int*>(scr + L.p0);  // counts, then words
  int* p1 = reinterpret_cast<int*>(scr + L.p1);  // (dst, dest bit) words
  long long* combo = reinterpret_cast<long long*>(scr + L.combo);
  for (int i0 = tid; i0 < NI; i0 += T * kU) {
    uint8_t al[kU], sp[kU];
    long long rk[kU], ml[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * T;
      const bool in = i < NI;
      al[u] = in ? a.alive[io + i] : 0;
      sp[u] = in ? a.special[io + i] : 0;
      rk[u] = in ? a.rank[io + i] : 0;
      ml[u] = in ? a.merlen[io + i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * T;
      if (i >= NI) break;
      fl[i] = (al[u] ? fAlive : 0u) | (sp[u] ? fSpecial : 0u);
      iml[i] = ml[u];
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
  stamp(kLinks);

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
  stamp(kJump);

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
  stamp(kMerge);
  return cyc;
}

// The item chain's second part (rank 0): the (label, pos_u) order. Ends
// with a barrier.
template <class F>
__device__ __forceinline__ void items_order(const Args& a, const Layout& L,
                                            unsigned char* smem,
                                            const F& stamp) {
  const int tid = threadIdx.x, T = blockDim.x, NI = a.NI;
  const uint32_t* fl = at<uint32_t>(smem, L.fl);
  const int* lab = at<int>(smem, L.lab);
  const int* posu = at<int>(smem, L.posu);
  long long* red = at<long long>(smem, L.red);
  long long* part = at<long long>(smem, L.part);
  unsigned char* scr = smem + L.scr;
  const int pi = pow2_at_least(NI);
  long long* ik = reinterpret_cast<long long*>(scr + L.ik);
  int* ix = reinterpret_cast<int*>(scr + L.ix);
  uint8_t* inr = scr + L.inr;
  int* kpos = reinterpret_cast<int*>(scr + L.kpos);
  int* rend = reinterpret_cast<int*>(scr + L.rend);
  long long* lanes = reinterpret_cast<long long*>(scr + L.lanes);
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
  stamp(kItemOrder);
}

// The item chain's third part (rank 0): the eight aggregates, each item's
// values loaded in index order into its sorted place, their inclusive
// sums, start_off. Ends with a barrier.
template <class F>
__device__ __forceinline__ void items_sum(const Args& a, const Layout& L,
                                          unsigned char* smem, size_t io,
                                          const F& stamp) {
  const int tid = threadIdx.x, T = blockDim.x, NI = a.NI;
  long long* soff = at<long long>(smem, L.soff);
  long long* red = at<long long>(smem, L.red);
  long long* part = at<long long>(smem, L.part);
  unsigned char* scr = smem + L.scr;
  const int* ix = reinterpret_cast<int*>(scr + L.ix);
  const uint8_t* inr = scr + L.inr;
  const int* kpos = reinterpret_cast<int*>(scr + L.kpos);
  long long* lanes = reinterpret_cast<long long*>(scr + L.lanes);
  long long* irb = reinterpret_cast<long long*>(scr + L.irb);
  const size_t ld = L.lane_ld;
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
    }
  }
  __syncthreads();
  stamp(kItemGather);
  block_scan<false>(lanes, ld, kLanes, NI, red, part);
  stamp(kItemScan);
  // start_off = cumsum - merlen - cummax(run start ? cumsum - merlen : 0)
  for (int k = tid; k < NI; k += T) irb[k] = inr[k] && k ? lanes[k - 1] : 0;
  __syncthreads();
  block_scan<true>(irb, 0, 1, NI, red, part);
  for (int k = tid; k < NI; k += T)
    soff[ix[k]] = sub64(k ? lanes[k - 1] : 0, irb[k]);
  __syncthreads();
  stamp(kStartOff);
}

// The item outputs (rank 0): a survivor takes its label's run total,
// every other item 0.
template <class F>
__device__ __forceinline__ void items_out(const Args& a, const Layout& L,
                                          unsigned char* smem, size_t io,
                                          const F& stamp) {
  const int tid = threadIdx.x, T = blockDim.x, NI = a.NI;
  const uint32_t* fl = at<uint32_t>(smem, L.fl);
  const int* sit = at<int>(smem, L.sit);
  unsigned char* scr = smem + L.scr;
  const long long* ik = reinterpret_cast<long long*>(scr + L.ik);
  const int* kpos = reinterpret_cast<int*>(scr + L.kpos);
  const int* rend = reinterpret_cast<int*>(scr + L.rend);
  const long long* lanes = reinterpret_cast<long long*>(scr + L.lanes);
  const size_t ld = L.lane_ld;
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
  stamp(kItemOut);
}

// A worker's mer inputs m in [lo, hi): each key at p[m - lo], from its
// staged copy or from device memory.
struct MerIn {
  const int64_t *item, *pos, *klo, *khi;
  const uint8_t* flip;
};

// the device memory slices [lo, ...) of window offset mo
__device__ __forceinline__ MerIn mer_src(const Args& a, size_t mo, int lo) {
  return MerIn{a.mer_item + mo + lo, a.mer_pos + mo + lo,
               a.keep_lo + mo + lo, a.keep_hi + mo + lo,
               a.mer_flip + mo + lo};
}

// the inputs of a worker's range: where `st` (its staging buffers, chunk
// mch) the staged copies, each at its slice's offset in its 16-aligned
// span, else device memory
__device__ __forceinline__ MerIn mer_in(const Args& a, size_t mo, int lo,
                                        const unsigned char* st, int mch) {
  const MerIn g = mer_src(a, mo, lo);
  if (st == nullptr) return g;
  const void* src[kStaged] = {g.item, g.pos, g.klo, g.khi, g.flip};
  const unsigned char* dst[kStaged];
  size_t o = 0;
  for (int k = 0; k < kStaged; ++k) {
    dst[k] = st + o + (reinterpret_cast<uintptr_t>(src[k]) & 15);
    o += stage_key_bytes(mch, k);
  }
  return MerIn{reinterpret_cast<const int64_t*>(dst[0]),
               reinterpret_cast<const int64_t*>(dst[1]),
               reinterpret_cast<const int64_t*>(dst[2]),
               reinterpret_cast<const int64_t*>(dst[3]), dst[4]};
}

// The mers' keys (a worker, its range): each mer's item (-1 - item for a
// non-member, whose item survives), rank new_pos - start_off, width,
// survivor, flags and kept interval's low end into the owner's arrays; a
// member item's count and width total by the owner's shared atomics.
// Where the inputs are staged (C > 1) also the outputs no order moves:
// mer_item (the survivor) and mer_flip.
__device__ __forceinline__ void mer_keys(const Args& a, size_t mo_, int lo,
                                         int hi, const unsigned char* st,
                                         int mch, const unsigned char* r0,
                                         unsigned char* mob) {
  const int T = blockDim.x, NI = a.NI;
  const MerIn in = mer_in(a, mo_, lo, st, mch);
  const Items it = items_at(r0, NI);
  const Mers mo = mers_at(mob, NI, a.NM);
  for (int m0 = lo + threadIdx.x; m0 < hi; m0 += T * kUO) {
    long long ti[kUO], mp[kUO], kl[kUO], kh[kUO];
    uint8_t mf[kUO];
#pragma unroll
    for (int u = 0; u < kUO; ++u) {
      const int m = m0 + u * T;
      const bool on = m < hi;
      ti[u] = on ? in.item[m - lo] : 0;
      mp[u] = on ? in.pos[m - lo] : 0;
      kl[u] = on ? in.klo[m - lo] : 0;
      kh[u] = on ? in.khi[m - lo] : 0;
      mf[u] = on ? in.flip[m - lo] : 0;
    }
    int mi[kUO], s[kUO], pu[kUO], ps[kUO];
    uint32_t f[kUO];
    long long ml[kUO];
#pragma unroll
    for (int u = 0; u < kUO; ++u) {
      mi[u] = static_cast<int>(clampv<long long>(ti[u], 0, NI - 1));
      f[u] = it.fl[mi[u]];
      s[u] = it.sit[mi[u]];
      ml[u] = it.iml[mi[u]];
      pu[u] = it.posu[mi[u]];
    }
#pragma unroll
    for (int u = 0; u < kUO; ++u) ps[u] = it.posu[s[u]];
#pragma unroll
    for (int u = 0; u < kUO; ++u) {
      const int m = m0 + u * T;
      if (m >= hi) break;
      const bool uf = f[u] & fFlip, mem = s[u] != mi[u];
      const long long wd = sub64(kh[u], kl[u]);  // khi2 - klo2, flipped or not
      mo.wb[m] = wd;
      mo.mmi[m] = mem ? mi[u] : -1 - mi[u];
      mo.mr[m] = uf ? sub64(sub64(ml[u], 1), mp[u]) : mp[u];
      mo.msur[m] = s[u];
      mo.mflg[m] = (uf ? mFlip : 0) | (mem ? mMember : 0) |
                   (pu[u] > ps[u] ? mFacingLow : 0);
      mo.mklo[m] = uf ? sub64(a.K, kh[u]) : kl[u];
      if (st != nullptr) {  // staged: the outputs the order does not move
        a.o_mer_item[mo_ + m] = s[u];
        a.o_mer_flip[mo_ + m] = (mf[u] != 0) != uf;
      }
      if (mem) {
        atomicAdd(&mo.mcnt[mi[u]], 1);
        atomicAdd(&mo.mtot[mi[u]], static_cast<unsigned long long>(wd));
      }
    }
  }
}

// Rank 0, once start_off is known and the mers' keys counted (mcnt, the
// owner's): whether a member item's new_pos leave [0, 8191] under the
// order by counting, its member mers' ranks being 0..c - 1 (new_pos from
// start_off to start_off + c - 1; where the ranks are not, the counting
// fails and the sort is taken anyway). Returns it to every thread.
__device__ __forceinline__ int range_out(const unsigned char* smem,
                                         const int* mcnt, int NI) {
  const Items it = items_at(smem, NI);
  int out = 0;
  for (int i = threadIdx.x; i < NI; i += blockDim.x) {
    const int c = mcnt[i];
    if (c == 0) continue;
    const long long so = it.soff[i];
    out |= so < 0 || so > 8191 - (c - 1);
  }
  return __syncthreads_or(out);
}

// The scans over the mers' order (the owner): `before` is the plain
// version's cumsum-minus-run-base, `after` the run total (or, where a
// member's new_pos is negative, its item's width total) less before and
// the width. Ends with a barrier.
__device__ __forceinline__ void mer_scans(const Mers& m, int n, bool negpos,
                                          long long* red, long long* part) {
  const int tid = threadIdx.x, T = blockDim.x;
  block_scan<false>(m.cw, 0, 1, n, red, part);
  for (int k = tid; k < n; k += T) m.mrb[k] = m.mnr[k] && k ? m.cw[k - 1] : 0;
  __syncthreads();
  block_scan<true>(m.mrb, 0, 1, n, red, part);
  for (int k = tid; k < n; k += T) {
    const int j = m.mx[k];
    const long long ex = k ? m.cw[k - 1] : 0;
    const long long wk = sub64(m.cw[k], ex);
    const long long before = sub64(ex, m.mrb[k]);
    long long tot;
    if (negpos) {
      const int mm = m.mmi[j];
      tot = static_cast<long long>(m.mtot[mm >= 0 ? mm : -1 - mm]);
    } else {
      const int s0 = static_cast<int>(m.mk[k]), e0 = m.mrend[s0];
      tot = sub64(m.cw[e0], s0 ? m.cw[s0 - 1] : 0);
    }
    m.maft[j] = sub64(sub64(tot, before), wk);
    m.mbef[j] = before;
  }
  __syncthreads();
}

// The member mers' order by counting (the owner), as the items': a member
// item's run start plus the mer's rank, where each member item's ranks are
// 0..n-1; non-members (one run after every member run) need no place:
// their outputs read no trim. Needs no start_off; where the ranks are not
// 0..n-1 (mer_check then takes the sort) returns 1, else runs the scans.
__device__ __forceinline__ int mer_count(unsigned char* mob, int NI, int NM,
                                         long long* red, long long* part) {
  const int tid = threadIdx.x, T = blockDim.x;
  const Mers m = mers_at(mob, NI, NM);
  for (int i = tid; i < NI; i += T) m.mbase[i] = m.mcnt[i];
  __syncthreads();
  block_scan<false>(m.mbase, 0, 1, NI, red, part);
  int bad = 0;
  for (int j = tid; j < NM; j += T) {
    const int mi = m.mmi[j];
    if (mi < 0) continue;
    const int c = m.mcnt[mi];
    const long long r = m.mr[j];
    if (r < 0 || r >= c)
      bad = 1;
    else if (atomicExch(&m.mx[static_cast<int>(m.mbase[mi]) - c + r], j) != -1)
      bad = 1;
  }
  if (__syncthreads_or(bad)) return 1;
  const int n = static_cast<int>(m.mbase[NI - 1]);
  for (int k = tid; k < n; k += T) {
    const int j = m.mx[k], mi = m.mmi[j];
    const int e0 = static_cast<int>(m.mbase[mi]) - 1, s0 = e0 - m.mcnt[mi] + 1;
    m.mk[k] = s0;  // the start of k's run
    m.mnr[k] = k == s0;
    if (k == s0) m.mrend[s0] = e0;
    m.cw[k] = m.wb[j];
  }
  __syncthreads();
  mer_scans(m, n, false, red, part);
  return 0;
}

// The range check (the owner, once start_off is known): each member's
// new_pos (start_off plus its rank); where one lies outside [0, 8191] or the counting
// failed (`bad`), the bitonic sort of every mer's key ((item << 13) |
// min(new_pos, 8191) for members, NI << 13 for the others) gives the order,
// and a member's negative new_pos takes its item's width total as the run
// total.
__device__ __forceinline__ void mer_check(unsigned char* mob,
                                          const unsigned char* r0, int bad,
                                          int NI, int NM, long long* red,
                                          long long* part) {
  const int tid = threadIdx.x, T = blockDim.x;
  const Mers m = mers_at(mob, NI, NM);
  const Items it = items_at(r0, NI);
  int negpos = 0, out = 0;
  for (int j = tid; j < NM; j += T) {
    const int mi = m.mmi[j];
    if (mi < 0) continue;
    const long long np = add64(it.soff[mi], m.mr[j]);
    negpos |= np < 0;
    out |= np < 0 || np > 8191;
  }
  negpos = __syncthreads_or(negpos);
  if (!(__syncthreads_or(out) || bad)) return;
  const int pm = pow2_at_least(NM);
  for (int j = tid; j < pm; j += T) {
    if (j >= NM) {
      m.mk[j] = LLONG_MAX;
      m.mx[j] = INT_MAX;
      continue;
    }
    const int mi = m.mmi[j];
    const long long np = mi >= 0 ? add64(it.soff[mi], m.mr[j]) : 0;
    m.mk[j] = mi >= 0 ? (static_cast<long long>(mi) << 13) |
                            (np < 8191 ? np : 8191LL)
                      : static_cast<long long>(NI) << 13;
    m.mx[j] = j;
  }
  __syncthreads();
  block_sort(m.mk, m.mx, pm);
  for (int k = tid; k < NM; k += T) m.cw[k] = m.wb[m.mx[k]];
  runs(m.mk, NM, 13, m.mnr, m.mrend, red, part);  // mk[k]: its run's start
  mer_scans(m, NM, negpos, red, part);
}

// The mer outputs (a worker, its range): new_pos (start_off plus the
// rank), the flips, the kept interval and the junction trims by the
// owner's before and after. A mer's item, survivor, rank and flags were
// gathered beside its keys (mer_keys); here every value read from rank
// 0's and the owner's shared memory depends only on the mer and its
// staged item, so all are in flight at once.
__device__ __forceinline__ void mer_out(const Args& a, size_t mo_, int lo,
                                        int hi, const unsigned char* st,
                                        int mch, const unsigned char* r0,
                                        unsigned char* mob) {
  const int T = blockDim.x, NI = a.NI;
  const MerIn in = mer_in(a, mo_, lo, st, mch);
  const Items it = items_at(r0, NI);
  const Mers mo = mers_at(mob, NI, a.NM);
  const long long K = a.K;
  for (int m0 = lo + threadIdx.x; m0 < hi; m0 += T * kUO) {
    long long kl[kUO], kh[kUO], so[kUO], r[kUO], bef[kUO], aft[kUO];
    uint8_t mf[kUO], fg[kUO];
    int s[kUO];
#pragma unroll
    for (int u = 0; u < kUO; ++u) {
      const int m = m0 + u * T < hi ? m0 + u * T : lo;
      const int mi = static_cast<int>(
          clampv<long long>(in.item[m - lo], 0, NI - 1));
      kl[u] = in.klo[m - lo];
      kh[u] = in.khi[m - lo];
      mf[u] = in.flip[m - lo];
      so[u] = it.soff[mi];
      r[u] = mo.mr[m];
      bef[u] = mo.mbef[m];
      aft[u] = mo.maft[m];
      s[u] = mo.msur[m];
      fg[u] = mo.mflg[m];
    }
#pragma unroll
    for (int u = 0; u < kUO; ++u) {
      const int m = m0 + u * T;
      if (m >= hi) break;
      const bool uf = fg[u] & mFlip, mem = fg[u] & mMember;
      const bool facing_low = fg[u] & mFacingLow;
      const long long klo2 = uf ? sub64(K, kh[u]) : kl[u];
      const long long khi2 = uf ? sub64(K, kl[u]) : kh[u];
      const long long width = sub64(khi2, klo2);
      long long cut_lo = sub64(K - 1, bef[u]), cut_hi = sub64(K - 1, aft[u]);
      cut_lo = cut_lo < 0 ? 0 : cut_lo;
      cut_lo = cut_lo < width ? cut_lo : width;
      cut_hi = cut_hi < 0 ? 0 : cut_hi;
      cut_hi = cut_hi < width ? cut_hi : width;
      const size_t g = mo_ + m;
      a.o_mer_item[g] = s[u];
      a.o_mer_flip[g] = (mf[u] != 0) != uf;
      a.o_mer_pos[g] = add64(so[u], r[u]);
      a.o_keep_lo[g] = mem && facing_low ? add64(klo2, cut_lo) : klo2;
      a.o_keep_hi[g] = mem && !facing_low ? sub64(khi2, cut_hi) : khi2;
    }
  }
}

// The kept intervals (the mers' owner, every mer of the window, once the
// order is final): the junction trims by before and after, from the
// owner's own arrays (C > 1).
__device__ __forceinline__ void mer_keep(const Args& a, size_t mo_,
                                         unsigned char* mob) {
  const Mers mo = mers_at(mob, a.NI, a.NM);
  const long long K = a.K;
  for (int m = threadIdx.x; m < a.NM; m += blockDim.x) {
    const uint8_t fg = mo.mflg[m];
    const bool mem = fg & mMember, facing_low = fg & mFacingLow;
    const long long klo2 = mo.mklo[m], width = mo.wb[m];
    const long long khi2 = add64(klo2, width);
    long long cut_lo = sub64(K - 1, mo.mbef[m]);
    long long cut_hi = sub64(K - 1, mo.maft[m]);
    cut_lo = cut_lo < 0 ? 0 : cut_lo;
    cut_lo = cut_lo < width ? cut_lo : width;
    cut_hi = cut_hi < 0 ? 0 : cut_hi;
    cut_hi = cut_hi < width ? cut_hi : width;
    a.o_keep_lo[mo_ + m] = mem && facing_low ? add64(klo2, cut_lo) : klo2;
    a.o_keep_hi[mo_ + m] = mem && !facing_low ? sub64(khi2, cut_hi) : khi2;
  }
}

// The mers' new_pos (a worker, its range, once start_off is known; C >
// 1): start_off of the mer's (staged) item plus the rank the owner keeps,
// both read at once.
__device__ __forceinline__ void mer_pos_out(const Args& a, size_t mo_, int lo,
                                            int hi, const unsigned char* st,
                                            int mch, const unsigned char* r0,
                                            unsigned char* mob) {
  const MerIn in = mer_in(a, mo_, lo, st, mch);
  const Mers mo = mers_at(mob, a.NI, a.NM);
  const Items it = items_at(r0, a.NI);
  for (int m = lo + threadIdx.x; m < hi; m += blockDim.x) {
    const int mi = static_cast<int>(
        clampv<long long>(in.item[m - lo], 0, a.NI - 1));
    a.o_mer_pos[mo_ + m] = add64(it.soff[mi], mo.mr[m]);
  }
}

// The edges' keys (a worker, its range): each alive edge's source and
// clamped okey into the owner's arrays, its source's degree by the owner's
// shared atomics. The renorm's order is (source, clamped okey, index) over
// the alive edges.
__device__ __forceinline__ void edge_keys(const Args& a, int lo, int hi,
                                          size_t eo, unsigned char* eob) {
  const int T = blockDim.x, NI = a.NI;
  const Edges ed = edges_at(eob, NI, a.EE);
  for (int e0 = lo + threadIdx.x; e0 < hi; e0 += T * kU) {
    uint8_t al[kU];
    long long src[kU], ok[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * T;
      const bool on = e < hi;
      al[u] = on ? a.e_alive[eo + e] : 0;
      src[u] = on ? a.e_src[eo + e] : 0;
      ok[u] = on ? a.e_okey[eo + e] : 0;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * T;
      if (e >= hi) break;
      if (!al[u]) {
        ed.esrc[e] = -1;
        continue;
      }
      long long ok2;
      if (ok[u] >= kBig - 2) {
        ok2 = ok[u] - (kBig - 2) + (kOkMax - 1);
        ok2 = ok2 < kOkMax ? ok2 : kOkMax;
      } else {
        ok2 = ok[u] < kOkMax - 2 ? ok[u] : kOkMax - 2;
      }
      const int s = static_cast<int>(clampv<long long>(src[u], 0, NI - 1));
      ed.esrc[e] = s;
      ed.ok2e[e] = static_cast<int>(ok2);
      atomicAdd(&ed.deg[s], 1);
    }
  }
}

// The edges' slots (the owner): each alive edge's rank by (clamped okey,
// index) in its source's bucket (the plain version's stable sort of
// (source, clamped okey), an alive okey being >= 0). Ends with a barrier.
__device__ __forceinline__ void edge_slots(unsigned char* eob, int NI,
                                           int EE, long long* red,
                                           long long* part) {
  const int tid = threadIdx.x, T = blockDim.x;
  const Edges ed = edges_at(eob, NI, EE);
  for (int i = tid; i < NI; i += T) ed.off[i] = ed.deg[i];
  __syncthreads();
  block_scan<false>(ed.off, 0, 1, NI, red, part);
  for (int i = tid; i < NI; i += T)
    ed.curs[i] = static_cast<int>(ed.off[i]) - ed.deg[i];
  __syncthreads();
  for (int e = tid; e < EE; e += T)
    if (ed.esrc[e] >= 0) ed.bkt[atomicAdd(&ed.curs[ed.esrc[e]], 1)] = e;
  __syncthreads();
  for (int e = tid; e < EE; e += T) {
    const int s = ed.esrc[e];
    if (s < 0) continue;
    const int hi = static_cast<int>(ed.off[s]), o = ed.ok2e[e];
    int r = 0;
    for (int q = hi - ed.deg[s]; q < hi; ++q) {
      const int b = ed.bkt[q], ob = ed.ok2e[b];
      r += ob < o || (ob == o && b < e);
    }
    ed.slot[e] = r;
  }
  __syncthreads();
}

// The edge outputs (a worker, its range): the rewiring, the new okeys;
// returns to every thread whether a kept edge's new ends meet.
__device__ __forceinline__ int edge_out(const Args& a, int lo, int hi,
                                        size_t eo, const unsigned char* r0,
                                        unsigned char* eob) {
  const int T = blockDim.x, NI = a.NI, S = 2 * NI;
  const Items it = items_at(r0, NI);
  const Edges ed = edges_at(eob, NI, a.EE);
  int loop = 0;
  for (int e0 = lo + threadIdx.x; e0 < hi; e0 += T * kUO) {
    uint8_t al[kUO];
    long long src[kUO], dst[kUO], dir[kUO];
#pragma unroll
    for (int u = 0; u < kUO; ++u) {
      const int e = e0 + u * T;
      const bool on = e < hi;
      al[u] = on ? a.e_alive[eo + e] : 0;
      src[u] = on ? a.e_src[eo + e] : 0;
      dst[u] = on ? a.e_dst[eo + e] : 0;
      dir[u] = on ? a.e_dir[eo + e] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUO; ++u) {
      const int e = e0 + u * T;
      if (e >= hi) break;
      const long long sb = dir[u] >> 1, db = dir[u] & 1;
      bool consumed = false;
      if (al[u]) {
        const int st =
            static_cast<int>(clampv<long long>(src[u] * 2 + sb, 0, S - 1));
        consumed = it.fl[st >> 1] & ((st & 1) ? fValid1 : fValid0);
      }
      const int es = static_cast<int>(clampv<long long>(src[u], 0, NI - 1));
      const int ee = static_cast<int>(clampv<long long>(dst[u], 0, NI - 1));
      const long long nsb = sb ^ ((it.fl[es] & fFlip) ? 1 : 0);
      const long long ndb = db ^ ((it.fl[ee] & fFlip) ? 1 : 0);
      const int nsrc = it.sit[es], ndst = it.sit[ee];
      const bool nea = al[u] && !consumed;
      loop |= nea && nsrc == ndst && src[u] != dst[u];
      const bool moved = nea && nsrc != src[u];
      const bool side_f = it.posu[es] > it.posu[nsrc];
      const long long okr = al[u] ? ed.slot[e] : kBig;
      const size_t g = eo + e;
      a.o_e_src[g] = nea ? nsrc : 0;
      a.o_e_dst[g] = nea ? ndst : 0;
      a.o_e_dir[g] = nea ? nsb * 2 + ndb : 0;
      a.o_e_alive[g] = nea;
      a.o_e_okey[g] = moved ? add64(a.Dcap * (side_f ? 1 : 2), okr) : okr;
    }
  }
  return __syncthreads_or(loop);
}

// ---------------------------------------------------------------------------
// the pass
// ---------------------------------------------------------------------------

// The pass on window w by a cluster of C blocks of kThreads threads (C = 1:
// one block, no cluster barrier), each block's dynamic shared memory at
// smem (cluster_smem(NI, EE, NM, C) bytes). Returns the window's fallback
// to every thread of rank 0 (false on the other ranks), and rank 0 writes
// it to a.o_fallback[w] unless that is null. Every load of an input comes
// before the store of the same element to an output, behind a barrier
// where another thread or block stores it: rank 0 reads the items and the
// edges (links) before it arrives at the barrier after which the edge
// outputs are written; a worker reads the edges of its own range only, and
// its mers' range once, into its staged copy, before the barrier after
// which any mer output is written (at C = 1 the mer and edge outputs
// follow every load of theirs); the item outputs follow rank 0's last
// load of an item input: a caller may pass one state as both the inputs
// and the outputs. Every block of the cluster calls it; at C > 1 its last
// barrier is a cluster barrier, so the state it wrote is visible to the
// whole cluster on return.
__device__ __forceinline__ bool body(const Args& a, int w,
                                     unsigned char* smem, int C) {
  const int tid = threadIdx.x;
  const int NI = a.NI, EE = a.EE, NM = a.NM;
  const int rank = C > 1 ? cluster_rank() : 0;
  const Roles R = roles(NI, EE, NM, C, rank);
  Head* head = reinterpret_cast<Head*>(smem);
  long long* red = at<long long>(smem, R.red);
  long long* part = at<long long>(smem, R.part);
  const size_t io = static_cast<size_t>(w) * NI,
               eo = static_cast<size_t>(w) * EE,
               mo = static_cast<size_t>(w) * NM;
  auto stamp = [&](int ph) {
    if (kStamps && tid == 0)
      a.stamps[(static_cast<size_t>(w) * kMaxC + rank) * kPhases + ph] =
          clock64();
  };
  stamp(kStart);
  const Layout L = layout(NI, EE, NM, C == 1);
  // the worker's ranges
  const int ech = range_chunk(EE, R.nw), mch = range_chunk(NM, R.nw);
  const int elo = min(R.wi * ech, EE), ehi = min(elo + ech, EE);
  const int mlo = min(R.wi * mch, NM), mhi = min(mlo + mch, NM);

  if (C == 1) {
    unsigned char* scr = smem + L.scr;
    const int cyc = items_merge(a, L, smem, io, eo, stamp);
    items_order(a, L, smem, stamp);
    items_sum(a, L, smem, io, stamp);
    items_out(a, L, smem, io, stamp);
    mers_init(scr, NI, NM);
    __syncthreads();
    mer_keys(a, mo, 0, NM, nullptr, mch, smem, scr);
    __syncthreads();
    stamp(kMerKeys);
    const int bad = mer_count(scr, NI, NM, red, part);
    stamp(kMerOrder);
    mer_check(scr, smem, bad, NI, NM, red, part);
    stamp(kMerCheck);
    mer_out(a, mo, 0, NM, nullptr, mch, smem, scr);
    __syncthreads();
    stamp(kMerOut);
    edges_init(scr, NI, EE);
    __syncthreads();
    edge_keys(a, 0, EE, eo, scr);
    __syncthreads();
    stamp(kEdgeKeys);
    edge_slots(scr, NI, EE, red, part);
    stamp(kEdgeSlots);
    const int loop = edge_out(a, 0, EE, eo, smem, scr);
    stamp(kEdgeOut);
    if (tid == 0 && a.o_fallback != nullptr) a.o_fallback[w] = cyc || loop;
    stamp(kEnd);
    return cyc || loop;
  }

  // C > 1
  if (R.items && tid == 0) head->loop = 0;
  if (R.mo) mers_init(smem + R.ms, NI, NM);
  if (R.eo) edges_init(smem + R.es, NI, EE);

  unsigned char* mob = peer(smem, 1) + mers_off(NI, EE, NM, C);
  const Head* h0 = peer(head, 0);  // rank 0's
  const Head* h1 = peer(head, 1);  // the mers' owner's
  if (R.items) {
    // the cluster's first barrier (every block started, every counter
    // zeroed) and the second (the edges' keys) wait until the merge:
    // rank 0 reads nothing of the others' before
    cluster_arrive();  // 0
    const int cyc = items_merge(a, L, smem, io, eo, stamp);
    cluster_wait();
    stamp(kSync0);
    cluster_arrive();  // 1
    cluster_wait();
    if (tid == 0) {
      // the aggregates' window slices into L2 for items_sum's gather,
      // after the links' loads (at the start they would queue with them)
      const size_t n8[5] = {8, 32, 8, 1, 1};
      const void* p[5] = {a.merlen + io, a.csum + io * 4, a.n_t + io,
                          a.is_tumor + io, a.is_normal + io};
      for (int k = 0; k < 5; ++k)
        prefetch_l2(span_lo(p[k]), span_bytes(p[k], n8[k] * NI));
    }
    cluster_arrive();  // 2: the merge's flags, survivors and pos_u
    items_order(a, L, smem, stamp);
    cluster_wait();    // (the edges' slots)
    cluster_arrive();  // 3: rank 0 feeds no mer key
    items_sum(a, L, smem, io, stamp);
    cluster_wait();    // (the mers' keys, counted)
    const int out = range_out(smem, mers_at(mob, NI, NM).mcnt, NI);
    if (tid == 0) head->out = out;
    cluster_arrive();  // 4: start_off and the range test
    items_out(a, L, smem, io, stamp);
    cluster_wait();    // (the mers' order by counting)
    stamp(kSync4);
    if (h1->mbad || out) {
      cluster_arrive();  // 5: the owner's sort
      cluster_wait();
    }
    cluster_arrive();  // 6
    cluster_wait();
    const bool fb = cyc || head->loop;
    if (tid == 0 && a.o_fallback != nullptr) a.o_fallback[w] = fb;
    stamp(kEnd);
    return fb;
  }

  // a worker (and owner): rank 0's and the owners' blocks as it sees them
  cluster_sync_all();  // 0: every block started, every counter zeroed
  stamp(kSync0);
  const unsigned char* r0 = peer(smem, 0);
  unsigned char* eob = peer(smem, C - 1) + edges_off(NI, EE, NM, C);
  const unsigned char* st = R.stage ? smem + R.st : nullptr;
  edge_keys(a, elo, ehi, eo, eob);
  stamp(kEdgeKeys);
  // the staging, behind the edges' loads (it is read from the mers' keys)
  if (R.stage && tid == 0 && mhi > mlo) {
    const MerIn g = mer_src(a, mo, mlo);
    const void* src[kStaged] = {g.item, g.pos, g.klo, g.khi, g.flip};
    const size_t n = static_cast<size_t>(mhi - mlo);
    unsigned bytes = 0;
    for (int k = 0; k < kStaged; ++k)
      bytes += span_bytes(src[k], n * (k < 4 ? 8 : 1));
    stage_begin(&head->bar, bytes);
    size_t off = 0;
    for (int k = 0; k < kStaged; ++k) {
      stage_copy(smem + R.st + off, span_lo(src[k]),
                 span_bytes(src[k], n * (k < 4 ? 8 : 1)), &head->bar);
      off += stage_key_bytes(mch, k);
    }
  }
  cluster_sync_all();  // 1: the edges' keys
  if (R.eo) {
    edge_slots(smem + R.es, NI, EE, red, part);
    stamp(kEdgeSlots);
  }
  cluster_sync_all();  // 2: the slots; rank 0's merge
  const int loop = edge_out(a, elo, ehi, eo, r0, eob);
  if (tid == 0 && loop) atomicOr(peer(&head->loop, 0), 1);
  stamp(kEdgeOut);
  if (R.stage && mhi > mlo) stage_wait(&head->bar);
  mer_keys(a, mo, mlo, mhi, st, mch, r0, mob);
  stamp(kMerKeys);
  cluster_sync_all();  // 3: the mers' keys
  if (R.stage && mhi > mlo && tid == 0) stage_end(&head->bar);
  if (R.mo) {  // the order by counting and the kept intervals it gives
    const int bad = mer_count(smem + R.ms, NI, NM, red, part);
    if (tid == 0) head->mbad = bad;
    if (!bad) mer_keep(a, mo, smem + R.ms);
    stamp(kMerOrder);
  }
  cluster_sync_all();  // 4: rank 0's start_off and range test
  stamp(kSync4);
  mer_pos_out(a, mo, mlo, mhi, st, mch, r0, mob);
  stamp(kMerOut);
  if (h1->mbad || h0->out) {  // the sort, where counting cannot order
    if (R.mo) {
      mer_check(smem + R.ms, r0, h1->mbad, NI, NM, red, part);
      mer_keep(a, mo, smem + R.ms);
      stamp(kMerCheck);
    }
    cluster_sync_all();  // 5
  }
  cluster_sync_all();  // 6: every output written
  stamp(kEnd);
  return false;
}

}  // namespace compress
