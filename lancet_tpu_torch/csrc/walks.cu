// The device graph engine's four sequential walks for Hopper (sm_90a), one
// kernel each, one launch per call. Plain C interface, loaded with ctypes by
// gpu/walks.py; each entry point returns cudaGetLastError() after its launch.
//
// The JAX package writes each walk as a lockstep lax.while_loop or
// fori_loop over all windows of a chunk (XLA, no Pallas):
//   K1 path_cover          <- lancet_tpu/tpu/pipeline.py::path_cover :310-500
//   K2 seq_removal         <- lancet_tpu/tpu/stages.py::_seq_removal_pass
//                             :580-622
//   K3 almost_repeat_paths <- lancet_tpu/tpu/pipeline.py::
//                             _is_almost_repeat_paths :680-717
//   K4 cycle_dfs           <- lancet_tpu/tpu/stages.py::has_cycle_seq
//                             :839-926
// The plain PyTorch versions (gpu/pipeline.py::path_cover_plain,
// gpu/stages.py::seq_removal_pass_plain, gpu/pipeline.py::
// almost_repeat_plain, gpu/stages.py::cycle_dfs_plain) are those loops step
// for step.
//
// A window's result in the lockstep loops depends on its own lane only: a
// lane that becomes active stays active until its own exit, so its pops,
// steps and overflow flags are those of a walk of that window alone (for
// path_cover's POPMAX too: a lane pops min(its need, POPMAX) times). So each
// kernel walks one window (K3: one path string) per warp or block.
//
// What bounds them: these are branchy, pointer-chasing walks over a few KB
// of state per window; the bytes are small (kilobytes a window) and the
// work is a chain of dependent loads and branches, so latency and the
// per-window serial chain bound them, not memory bandwidth or issue rate.
// The designs keep each walk's state in shared memory (queues, stacks,
// degrees, colours), give the parallel part of a step to the lanes of a
// warp (K1: one lane per adjacency slot, a ballot and popc giving the FIFO
// order of the JAX cumsum; K2: the neighbour-degree decrements of a kill),
// and run many windows side by side, one block each. K1, K2 and K4 also
// stage the window's graph in shared memory before they walk, so that a
// step's chain of dependent loads stays on the SM (see each kernel's note);
// K2 runs the whole removal pass around its sweep as well.
//
// Integer inputs are int32 (K2: int64, the engine's state as it is),
// booleans one byte each (0 or 1).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "removal_body.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__host__ __device__ constexpr size_t round16(size_t x) {
  return (x + 15) / 16 * 16;
}

// ---------------------------------------------------------------------------
// K1 path_cover: the best-new-edge eka/BFS path cover (ref Graph.cc:
// 1299-1501), replacing lancet_tpu/tpu/pipeline.py::path_cover (:310).
//
// What bounds it: the serial chain of its longest window, not bytes. A
// window's rounds, each a BFS of up to POPMAX pops, run in order, and each
// pop waits on the one before (the FIFO's head and tail). In the first
// design each pop made three dependent round trips to device memory (the
// adjacency row, then each edge's direction, then its destination and the
// destination's special flag and merlen). This design stages the window's
// graph in shared memory first, with the whole block (kStageThreads): per
// adjacency slot one 8-byte word {edge id (-1: empty, or a direction
// whose start bit is neither 0 nor 1, which never matches), destination
// item << 2 | start bit << 1 | destination bit}, and per item its length
// delta (special ? 1 - K : merlen). Then one warp walks, lane l expanding
// slot l of the popped entry: a pop is a 16-byte shared load of the queue
// entry {item << 2 | dir << 1 | flag, edge, len, parent + 1 << 16 |
// score}, the lane's slot word, a ballot and popc giving the FIFO order of
// the JAX cumsum, then the covered bit and the delta, all in shared
// memory. Where the staged words do not fit next to the queue, they go to
// a scratch buffer in device memory ("global" mode, gpu/walks.py::
// path_cover_plan). Preconditions: adjacency entries are -1 or edge ids,
// e_dst names items in [0, NI), Q <= 65535.
// ---------------------------------------------------------------------------

constexpr int kStageThreads = 256;  // a walk block: stages with all threads

__global__ void __launch_bounds__(kStageThreads) path_cover_kernel(
    const int32_t* __restrict__ adj, const int32_t* __restrict__ e_dst,
    const int32_t* __restrict__ e_dir, const int32_t* __restrict__ merlen,
    const uint8_t* __restrict__ special, const uint8_t* __restrict__ runnable,
    const int32_t* __restrict__ numcomp, const int32_t* __restrict__ reflens,
    int32_t* __restrict__ sel_edges, int32_t* __restrict__ sel_hops,
    int32_t* __restrict__ sel_comp, int32_t* __restrict__ n_sel_out,
    uint8_t* __restrict__ fb_out, int2* stage_g, int NI, int D2, int EE,
    int K, int N, int Cmax, int dfs_limit, int max_indel, int Q, int POPMAX,
    int JMAX, int PN) {
  extern __shared__ __align__(16) uint8_t smb[];
  const int ncw = (EE + 31) / 32;
  int4* qe4 = reinterpret_cast<int4*>(smb);
  uint32_t* cov = reinterpret_cast<uint32_t*>(smb + round16(Q * 16));
  int32_t* hop = reinterpret_cast<int32_t*>(reinterpret_cast<uint8_t*>(cov) +
                                            round16(ncw * 4));
  uint8_t* staged = reinterpret_cast<uint8_t*>(hop) + round16(PN * 4);
  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t nslot = static_cast<size_t>(NI) * D2;
  if (stage_g != nullptr)
    staged = reinterpret_cast<uint8_t*>(stage_g) +
             static_cast<size_t>(w) * (nslot * 8 + round16(NI * 4));
  int2* slot = reinterpret_cast<int2*>(staged);
  int32_t* dl = reinterpret_cast<int32_t*>(staged + nslot * 8);

  // ---- staging, the whole block ----
  const int32_t* adj_w = adj + static_cast<size_t>(w) * nslot;
  const int32_t* dst_w = e_dst + static_cast<size_t>(w) * EE;
  const int32_t* dir_w = e_dir + static_cast<size_t>(w) * EE;
  const int32_t* ml_w = merlen + static_cast<size_t>(w) * NI;
  const uint8_t* sp_w = special + static_cast<size_t>(w) * NI;
  for (int i = tid; i < NI; i += kStageThreads)
    dl[i] = sp_w[i] ? 1 - K : ml_w[i];
#pragma unroll 4
  for (size_t j = tid; j < nslot; j += kStageThreads) {
    const int e = adj_w[j];
    int2 v = make_int2(-1, 0);
    if (e >= 0) {
      const int es = min(e, EE - 1);
      const int ed = dir_w[es];
      if ((ed >> 1) == 0 || (ed >> 1) == 1)
        v = make_int2(e, clampi(dst_w[es], 0, NI - 1) << 2 | (ed & 3));
    }
    slot[j] = v;
  }
  int32_t* se_w = sel_edges + static_cast<size_t>(w) * JMAX * PN;
  for (int i = tid; i < JMAX * PN; i += kStageThreads) se_w[i] = -1;
  for (int i = tid; i < JMAX; i += kStageThreads) {
    sel_hops[w * JMAX + i] = 0;
    sel_comp[w * JMAX + i] = 0;
  }
  for (int i = tid; i < ncw; i += kStageThreads) cov[i] = 0;
  __syncthreads();
  if (tid >= 32) return;  // one warp walks

  const int lane = tid;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int nc = numcomp[w];
  int n_sel = 0;
  bool fallback = false;
  int c_w = 1;
  const int outer = Cmax + JMAX + 2;
  for (int o = 0; o < outer; ++o) {
    const int cidx = clampi(c_w - 1, 0, Cmax - 1);
    const bool lane_on = c_w <= nc && runnable[w * Cmax + cidx] != 0;
    int bi = -1, bs = 0;
    bool over_q = false;
    if (lane_on) {
      const int src_item = N + 2 * (c_w - 1);
      const int sink_item = src_item + 1;
      const int reflen = reflens[w * Cmax + cidx];
      if (lane == 0) qe4[0] = make_int4(src_item << 2 | 1, -1, K, 0);
      __syncwarp();
      int head = 0, tail = 1, visits = 0;
      bool on = true;
      for (int pops = 0; pops < POPMAX && head < tail; ++pops) {
        if (++visits > dfs_limit) {
          on = false;
          break;
        }
        const int4 q = qe4[min(head, Q - 1)];
        const int it = q.x >> 2, dr = (q.x >> 1) & 1, ln = q.z;
        const int sc = q.w & 0xffff;
        const bool fl = q.x & 1;
        const bool at_sink = it == sink_item && !fl;
        if (at_sink && (bi < 0 || sc > bs)) {  // first-found best: strict >
          bi = head;
          bs = sc;
        }
        if (!at_sink && !(ln > reflen + max_indel)) {
          const int its = clampi(it, 0, NI - 1);
          const int2 v = lane < D2 ? slot[its * D2 + lane] : make_int2(-1, 0);
          const bool okc = v.x >= 0 && ((v.y >> 1) & 1) == dr;
          const unsigned bal = __ballot_sync(kFull, okc);
          const int cnt = __popc(bal);
          const int room = max(Q - tail, 0);
          if (okc) {
            const int tgt = tail + __popc(bal & lt_mask);
            if (tgt < Q) {
              const int es = min(v.x, EE - 1);
              const bool cov_e = (cov[es >> 5] >> (es & 31)) & 1u;
              const int dsts = v.y >> 2;
                  qe4[tgt] = make_int4(
                  dsts << 2 | (v.y & 1) << 1 | (fl && cov_e), v.x,
                  ln + dl[dsts],
                  static_cast<int>(static_cast<uint32_t>(head + 1) << 16 |
                                   (sc + (cov_e ? 0 : 1))));
            }
          }
          if (cnt > room) over_q = true;
          tail += min(cnt, room);
          __syncwarp();
        }
        ++head;
      }
      // POPMAX hit with work left = unfaithful enumeration
      if (on && head < tail) over_q = true;
    }
    fallback |= over_q;
    const bool has = lane_on && bi >= 0 && !over_q;
    // walk the parents of the best entry (one lane), marking covered; the
    // walk stops at the source (hop[p] past nh is never read)
    int cur = has ? bi : -1;
    int nh = 0;
    if (lane == 0) {
      for (int p = 0; p < PN && cur >= 0; ++p) {
        const int4 q = qe4[min(cur, Q - 1)];
        if (q.y < 0) {
          cur = -1;
          break;
        }
        const int ce = min(q.y, EE - 1);
        cov[ce >> 5] |= 1u << (ce & 31);
        hop[p] = q.y;
        ++nh;
        cur = static_cast<int>(static_cast<uint32_t>(q.w) >> 16) - 1;
      }
    }
    __syncwarp();
    cur = __shfl_sync(kFull, cur, 0);
    nh = __shfl_sync(kFull, nh, 0);
    if (cur >= 0) fallback = true;  // path longer than PN
    const bool over_j = has && n_sel >= JMAX;
    if (over_j) fallback = true;
    if (has && !over_j) {
      int32_t* row = se_w + n_sel * PN;
      for (int q = lane; q < PN; q += 32) {
        const int sp = nh - 1 - q;  // reverse: the walk collected sink-first
        row[q] = sp >= 0 ? hop[sp] : -1;
      }
      if (lane == 0) {
        sel_hops[w * JMAX + n_sel] = nh;
        sel_comp[w * JMAX + n_sel] = c_w;
      }
      ++n_sel;
    }
    __syncwarp();
    if (!(lane_on && has)) ++c_w;
  }
  if (c_w <= nc) fallback = true;  // still mid-walk after OUTER rounds
  if (lane == 0) {
    n_sel_out[w] = n_sel;
    fb_out[w] = fallback;
  }
}

// ---------------------------------------------------------------------------
// K2 seq_removal: one whole removal pass of removeTips (mode 0) or
// removeShortLinks (mode 1), replacing lancet_tpu/tpu/stages.py::
// _seq_removal_pass (:580-622), one block of kRemovalThreads a window. The
// pass itself (its design, what bounds it, its preconditions) is
// removal::pass in csrc/removal_body.cuh, which csrc/cleanup.cu's
// tip_fixpoint runs too.
// ---------------------------------------------------------------------------

constexpr int kRemovalThreads = 256;

__global__ void __launch_bounds__(kRemovalThreads) seq_removal_kernel(
    const uint8_t* __restrict__ alive, const uint8_t* __restrict__ special,
    const int64_t* __restrict__ rank, const int64_t* __restrict__ merlen,
    const int64_t* __restrict__ e_src, const int64_t* __restrict__ e_dst,
    const uint8_t* __restrict__ e_alive, const int64_t* __restrict__ mincov,
    const int64_t* __restrict__ thr, const uint8_t* __restrict__ guard,
    uint8_t* __restrict__ alive_out, uint8_t* __restrict__ e_alive_out,
    uint8_t* __restrict__ any_out, uint8_t* __restrict__ over_out, int NI,
    int EE, int U, int D2, int mode, long long max_len) {
  extern __shared__ __align__(16) uint8_t smb[];
  const int w = blockIdx.x;
  removal::pass<kRemovalThreads>(alive, special, rank, merlen, e_src, e_dst,
                                 e_alive, mincov, thr, guard, alive_out,
                                 e_alive_out, any_out + w, over_out + w, w,
                                 NI, EE, U, D2, mode, max_len, smb);
}

// ---------------------------------------------------------------------------
// K3 almost_repeat_paths: isAlmostRepeat of a path string (ref util.cc:
// 317-360), replacing lancet_tpu/tpu/pipeline.py::_is_almost_repeat_paths
// (:680): is there a shift d >= 1 and a window start p with p + d <= maxp
// = len - K - 1 whose (K+1)-windows at p and p+d differ in at most mm
// places?
//
// The identity it relies on: with neq[q] = s[q] != s[q+d], shift d hits
// exactly when some window [p, p+K] inside [0, len-d) holds at most mm
// ones of neq (never for mm < 0). A window's verdict needs only the neq
// bits of its own positions, so any split of a shift's starts into
// segments is exact, each segment read with its K-wide halo.
//
// What bounds it: first the longest thread's chain, then the integer issue
// rate of the SMs a string gets. The first design gave each of 256
// threads whole shifts d = 1+t, 257+t, ...: ~1,900 compared positions on
// thread 0's chain for a 600-base path while threads of large shifts
// idled, 256 threads an SM, and a hit seen only between shifts. This
// design deals the string's (shift, start) plane evenly over the threads
// of a cluster of S blocks (a call holds ~2 paths a window, so one block a
// string would leave most SMs idle; 8 blocks of 512 threads for the
// engine's strings): shift d is
// paired with shift maxp+1-d (their starts sum to maxp+1), each pair's
// starts cut into tiles of G starts (gpu/walks.py::almost_repeat_plan
// picks S, the block and G), tile t of pair t % npairs, segment t /
// npairs, so a warp's lanes read neighbouring shifts of one segment. Each
// block stages the string in its own shared memory; a hit is written to
// every block's flag of the cluster (distributed shared memory), and
// cluster rank 0 writes the verdict after the cluster's last barrier. Per
// tile the issue cost is cut two ways: the neq bits
// come 4 positions at a time from 32-bit words of the staged string (a
// funnel shift aligns the word at q + d, a carry-free byte test and a
// multiply gather the 4 mismatch bits), 32 bits a word; then each window
// start's count is two funnel shifts and two popcounts over the words,
// and since a count drops by at most one a start, a count c > mm skips the
// next c - mm - 1 starts, none of which can hit. Every thread polls its
// block's hit flag before each tile and each 32 starts.
// K <= 63 (a window's bits span two words); reads reach kArPad bytes past
// the string, zeroed in shared memory.
// ---------------------------------------------------------------------------

constexpr int kArMaxThreads = 1024;
constexpr int kArPad = 128;  // bytes past a string its tiles may read

// The neq bits of 32 positions: bit j = s[q + j] != s[q + d + j], for q =
// 4 * qw (a multiple of 16 bytes: the two 16-byte loads) and b = q + d.
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

__global__ void __launch_bounds__(kArMaxThreads) almost_repeat_kernel(
    const uint8_t* __restrict__ seq, const int32_t* __restrict__ lens,
    uint8_t* __restrict__ out, int LP, int K, int mm, int G) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) uint32_t sw[];
  __shared__ int found;
  uint8_t* s = reinterpret_cast<uint8_t*>(sw);
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / S;  // a cluster a string
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int len = min(max(lens[b], 0), LP);
  const int maxp = len - K - 1;
  if (mm < 0 || maxp < 1) {  // no budget, or no shift: the whole cluster
    if (rank == 0 && tid == 0) out[b] = 0;
    return;
  }
  const uint8_t* row = seq + static_cast<size_t>(b) * LP;
  for (int i = tid; i < len; i += T) s[i] = row[i];
  for (int i = len + tid; i < len + kArPad; i += T) s[i] = 0;
  if (tid == 0) found = 0;
  cluster.sync();  // every flag is 0 before any block may set it
  volatile int* vfound = &found;
  // a window's K+1 bits: the low word's, then the high word's
  const uint32_t mlo = K >= 31 ? 0xffffffffu : (2u << K) - 1u;
  const uint32_t mhi =
      K < 32 ? 0u : (K >= 63 ? 0xffffffffu : (1u << (K - 31)) - 1u);
  const bool third = K >= 33;  // start 31's window passes bit 63
  const int npairs = (maxp + 1) / 2;
  const int tpp = (maxp + G) / G + 1;  // tiles a pair: both shifts' segments
  const int ntiles = npairs * tpp;
  for (int t = rank * T + tid; t < ntiles && !*vfound; t += S * T) {
    const int pair = t % npairs;
    const int i = t / npairs;
    const int d1 = 1 + pair, d2 = maxp - pair;
    const int segs1 = (maxp - d1 + G) / G;
    int d = d1, seg = i;
    if (i >= segs1) {
      d = d2;
      seg = i - segs1;
      if (d2 == d1 || seg * G > maxp - d2) continue;  // an empty tile
    }
    const int p0 = seg * G;
    const int nv = min(G, maxp - d - p0 + 1);  // the tile's starts
    // word j of the tile: the neq bits of positions p0 + 32j ...
    const int qw = p0 >> 2, bq = p0 + d;
    uint32_t w0 = neq32(sw, qw, bq);
    uint32_t w1 = neq32(sw, qw + 8, bq + 32);
    uint32_t w2 = third ? neq32(sw, qw + 16, bq + 64) : 0u;
    bool hit = false;
    for (int c = 0;;) {
      const int nr = min(32, nv - 32 * c);
      for (int r = 0; r < nr;) {
        const int m = __popc(__funnelshift_r(w0, w1, r) & mlo) +
                      __popc(__funnelshift_r(w1, w2, r) & mhi);
        if (m <= mm) {
          hit = true;
          break;
        }
        r += m - mm;  // the next m - mm - 1 starts count more than mm
      }
      if (hit || 32 * ++c >= nv || *vfound) break;
      w0 = w1;
      if (third) {
        w1 = w2;
        w2 = neq32(sw, qw + 8 * (c + 2), bq + 32 * (c + 2));
      } else {
        w1 = neq32(sw, qw + 8 * (c + 1), bq + 32 * (c + 1));
      }
    }
    if (hit) {
      for (int r = 0; r < S; ++r)
        *static_cast<volatile int*>(cluster.map_shared_rank(&found, r)) = 1;
      break;
    }
  }
  cluster.sync();  // the flags final; no block's memory is read after it
  if (rank == 0 && tid == 0) out[b] = found != 0;
}

// ---------------------------------------------------------------------------
// K4 cycle_dfs: the exact hasCycleRec replay (ref Graph.cc:593-681),
// replacing lancet_tpu/tpu/stages.py::has_cycle_seq (:839). Per active
// component (lane_mask, source alive) two rooted searches, (source, F) then
// (source, R), sharing node colours (WHITE 0, GREY 1, BLACK 2); a GREY hit
// in either orientation is a cycle; specials are never entered.
//
// What bounds it: the serial chain of its longest component's DFS, not
// bytes. In the first design one thread a (window, component) block walked
// with four dependent device-memory loads a step (adjacency slot, the
// edge's direction, its destination, the destination's special flag), and
// W x Cmax blocks were launched, most of them empty. This design launches
// one block a window. Its threads first stage the window's graph in shared
// memory as a filtered successor list: item i's entries at i * D2, in slot
// order up to the first -1, each one packed word (destination item << 2 |
// start bit << 1 | destination bit), their count beside. Entries into a
// special item, and those whose start bit is neither 0 nor 1, are dropped
// there: special is fixed for the call and both skips only advance the
// slot, so the order of the visits, which decides the verdict through the
// shared colours, is kept. The start bit is tested in the walk (it depends
// on the frame's direction). A step is then two dependent shared loads
// (the entry, then the destination's colour and count side by side); the
// top frame stays in registers and the frames below it are packed words
// (item << 13 | count << 7 | slot << 1 | dir).
// The window's active components are walked by the block's warps, one lane
// each, each with its own colours and stack (components are not shown to
// colour disjoint items), as many at once as shared memory holds and the
// rest in turn. Where the staged list does not fit, it goes to a scratch
// buffer in device memory ("global" mode; gpu/walks.py::cycle_dfs_plan
// picks the mode and the number of walkers by bytes). D2 <= 63, NI < 2^19.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kStageThreads) cycle_dfs_kernel(
    const int32_t* __restrict__ adj, const int32_t* __restrict__ e_dst,
    const int32_t* __restrict__ e_dir, const uint8_t* __restrict__ alive,
    const uint8_t* __restrict__ special, const uint8_t* __restrict__ lane_mask,
    uint8_t* __restrict__ flags, uint32_t* ent_g, int NI, int D2, int EE,
    int N, int Cmax, int walkers) {
  extern __shared__ __align__(16) uint8_t smb[];
  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t ib = static_cast<size_t>(w) * NI;
  uint8_t* cnt = smb;
  int32_t* act = reinterpret_cast<int32_t*>(smb + round16(NI));
  int32_t* n_act = act + Cmax;
  uint32_t* ent = reinterpret_cast<uint32_t*>(
      smb + round16(NI) + round16((static_cast<size_t>(Cmax) + 1) * 4));
  uint8_t* region = reinterpret_cast<uint8_t*>(ent);
  if (ent_g != nullptr) {
    ent = ent_g + ib * D2;
  } else {
    region += round16(static_cast<size_t>(NI) * D2 * 4);
  }

  // the active components, in component order
  for (int c = tid; c < Cmax; c += kStageThreads) {
    const int src = N + 2 * c;
    const bool on =
        src < NI && alive[ib + src] != 0 && lane_mask[w * Cmax + c] != 0;
    act[c] = on;
    if (!on) flags[w * Cmax + c] = 0;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int c = 0; c < Cmax; ++c)
      if (act[c]) act[n++] = c;
    *n_act = n;
  }
  __syncthreads();
  const int na = *n_act;
  if (na == 0) return;

  // ---- staging, the whole block: each edge's packed word (0xffffffff:
  // dropped), then each item's filtered successor list ----
  uint32_t* ew = reinterpret_cast<uint32_t*>(region);  // the walkers' space
  const int32_t* dst_w = e_dst + static_cast<size_t>(w) * EE;
  const int32_t* dir_w = e_dir + static_cast<size_t>(w) * EE;
  for (int e = tid; e < EE; e += kStageThreads) {
    const int ed = dir_w[e];
    const int v = clampi(dst_w[e], 0, NI - 1);
    const bool keep =
        ((ed >> 1) == 0 || (ed >> 1) == 1) && special[ib + v] == 0;
    ew[e] = keep ? static_cast<uint32_t>(v) << 2 | (ed & 3) : 0xffffffffu;
  }
  __syncthreads();
  const int32_t* adj_w = adj + ib * D2;
  for (int i = tid; i < NI; i += kStageThreads) {
    const int32_t* row = adj_w + static_cast<size_t>(i) * D2;
    uint32_t* out = ent + static_cast<size_t>(i) * D2;
    int k = 0;
    bool open = true;  // no -1 seen yet in the row
#pragma unroll 4
    for (int q = 0; q < D2; ++q) {
      const int e = row[q];
      open = open && e >= 0;
      const uint32_t x = open ? ew[min(e, EE - 1)] : 0xffffffffu;
      if (x != 0xffffffffu) out[k++] = x;
    }
    cnt[i] = static_cast<uint8_t>(k);
  }
  __syncthreads();

  // ---- the walks: warp v < walkers, lane 0, components v, v + walkers,
  // ... of the active list ----
  const int wid = tid >> 5;
  const int lane = tid & 31;
  if (wid >= walkers) return;
  const size_t per = round16(static_cast<size_t>(NI) * 4) + round16(NI);
  uint32_t* stk = reinterpret_cast<uint32_t*>(region + wid * per);
  uint8_t* col = region + wid * per + round16(static_cast<size_t>(NI) * 4);
  for (int a = wid; a < na; a += walkers) {
    const int c = act[a];
    for (int i = lane * 16; i < NI; i += 32 * 16)
      *reinterpret_cast<uint4*>(col + i) = make_uint4(0, 0, 0, 0);
    __syncwarp();
    if (lane == 0) {
      const int src = N + 2 * c;
      bool cyc = false;
      for (int d0 = 0; d0 < 2 && !cyc; ++d0) {
        col[src] = 1;
        int item = src, dir = d0, depth = 0;
        int pos = item * D2, end = pos + cnt[item];
        for (;;) {
          if (pos == end) {  // exhausted: pop, node -> BLACK
            col[item] = 2;
            if (depth == 0) break;
            const uint32_t f = stk[--depth];
            item = static_cast<int>(f >> 13);
            dir = f & 1;
            const int base = item * D2;
            pos = base + ((f >> 1) & 63);
            end = base + ((f >> 7) & 63);
            continue;
          }
          const uint32_t x = ent[pos++];
          if (((x >> 1) & 1) != static_cast<uint32_t>(dir)) continue;
          const int v = static_cast<int>(x >> 2);
          const int vcnt = cnt[v];  // loaded beside the colour, not after
          const int vcol = col[v];
          if (vcol == 1) {
            cyc = true;
            break;
          }
          if (vcol == 0) {
            col[v] = 1;
            const int base = item * D2;
            stk[depth++] = static_cast<uint32_t>(item) << 13 |
                           static_cast<uint32_t>(end - base) << 7 |
                           static_cast<uint32_t>(pos - base) << 1 | dir;
            item = v;
            dir = x & 1;
            pos = v * D2;
            end = pos + vcnt;
          }
        }
      }
      flags[w * Cmax + c] = cyc;
    }
    __syncwarp();
  }
}

// A measurement probe, not a walk: one thread chases `steps` dependent
// loads through a ring in shared memory, so that the time of a launch over
// steps is the latency of one dependent shared load on this card
// (chip_smoke.py's chain floor of the walks).
__global__ void smem_chase_kernel(int steps, int* out) {
  __shared__ int ring[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    ring[i] = (i * 389 + 1) & 1023;
  __syncthreads();
  if (threadIdx.x != 0) return;
  int x = 0;
#pragma unroll 16
  for (int i = 0; i < steps; ++i) x = ring[x];
  *out = x;
}

int set_smem(const void* kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

constexpr size_t kSmemLimit = 232448;  // bytes a block may use on Hopper

// Dynamic shared memory of a K1 block (gpu/walks.py::path_cover_plan
// computes the same): the queue of 16-byte entries, the covered-edge bits,
// the hop buffer and, in shared mode, the staged slot words and deltas.
size_t path_cover_smem(int NI, int D2, int EE, int Q, int PN, bool global) {
  const size_t staged = static_cast<size_t>(NI) * D2 * 8 + round16(NI * 4);
  return round16(static_cast<size_t>(Q) * 16) +
         round16(static_cast<size_t>((EE + 31) / 32) * 4) +
         round16(static_cast<size_t>(PN) * 4) + (global ? 0 : staged);
}

// Dynamic shared memory of a K4 block (gpu/walks.py::cycle_dfs_plan
// computes the same): the per-item counts, the active list and its length,
// in shared mode
// the successor lists, then the walkers' stacks and colours, which the
// staging pass first uses for the edges' packed words.
size_t cycle_dfs_smem(int NI, int D2, int EE, int Cmax, int walkers,
                      bool global) {
  const size_t per = round16(static_cast<size_t>(NI) * 4) + round16(NI);
  const size_t region = static_cast<size_t>(walkers) * per;
  const size_t ew = round16(static_cast<size_t>(EE) * 4);
  return round16(NI) + round16((static_cast<size_t>(Cmax) + 1) * 4) +
         (global ? 0 : round16(static_cast<size_t>(NI) * D2 * 4)) +
         (region > ew ? region : ew);
}

// Dynamic shared memory of a K2 block (gpu/walks.py::seq_removal_smem
// computes the same): removal::smem_bytes.
constexpr int kRemovalMaxItems = removal::kMaxItems;

size_t seq_removal_smem(int NI, int EE, int U) {
  return removal::smem_bytes(NI, EE, U);
}

// Dynamic shared memory of a K3 block (gpu/walks.py::almost_repeat_smem
// computes the same): the string's bytes and kArPad bytes past them.
size_t almost_repeat_smem(int LP) {
  return round16(static_cast<size_t>(LP) + kArPad);
}

}  // namespace

extern "C" {

// K1: W windows, adjacency [W, NI, D2] (D2 <= 32), edges [W, EE]. With
// stage (global mode) the staged words go there, W * (NI * D2 * 8 +
// round16(NI * 4)) bytes; smem must equal path_cover_smem's total.
int path_cover(const void* adj, const void* e_dst, const void* e_dir,
               const void* merlen, const void* special, const void* runnable,
               const void* numcomp, const void* reflens, void* sel_edges,
               void* sel_hops, void* sel_comp, void* n_sel, void* fallback,
               void* stage, int W, int NI, int D2, int EE, int K, int N,
               int Cmax, int dfs_limit, int max_indel, int Q, int POPMAX,
               int JMAX, int PN, size_t smem, void* stream) {
  if (W < 1 || NI < 1 || D2 < 1 || D2 > 32 || EE < 1 || Q < 1 ||
      Q > 65535 || Cmax < 1 || JMAX < 1 || PN < 1 || smem > kSmemLimit ||
      smem != path_cover_smem(NI, D2, EE, Q, PN, stage != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = set_smem(reinterpret_cast<const void*>(path_cover_kernel), smem);
  if (rc != 0) return rc;
  path_cover_kernel<<<W, kStageThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(adj), static_cast<const int32_t*>(e_dst),
      static_cast<const int32_t*>(e_dir), static_cast<const int32_t*>(merlen),
      static_cast<const uint8_t*>(special),
      static_cast<const uint8_t*>(runnable),
      static_cast<const int32_t*>(numcomp),
      static_cast<const int32_t*>(reflens), static_cast<int32_t*>(sel_edges),
      static_cast<int32_t*>(sel_hops), static_cast<int32_t*>(sel_comp),
      static_cast<int32_t*>(n_sel), static_cast<uint8_t*>(fallback),
      static_cast<int2*>(stage), NI, D2, EE, K, N, Cmax, dfs_limit,
      max_indel, Q, POPMAX, JMAX, PN);
  return static_cast<int>(cudaGetLastError());
}

// K2: W windows of NI items and EE edges, the state in its own dtypes (bool
// one byte, int64); the tips mode (0) reads no mincov, thr or guard (null);
// smem must equal seq_removal_smem's total.
int seq_removal(const void* alive, const void* special, const void* rank,
                const void* merlen, const void* e_src, const void* e_dst,
                const void* e_alive, const void* mincov, const void* thr,
                const void* guard, void* alive_out, void* e_alive_out,
                void* any_out, void* over_out, int W, int NI, int EE, int U,
                int D2, int mode, long long max_len, size_t smem,
                void* stream) {
  if (W < 1 || NI < 1 || NI > kRemovalMaxItems || EE < 0 || U < 0 ||
      D2 < 1 || mode < 0 || mode > 1 ||
      (mode == 1 && (mincov == nullptr || thr == nullptr ||
                     guard == nullptr)) ||
      smem > kSmemLimit || smem != seq_removal_smem(NI, EE, U))
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = set_smem(reinterpret_cast<const void*>(seq_removal_kernel), smem);
  if (rc != 0) return rc;
  seq_removal_kernel<<<W, kRemovalThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(alive), static_cast<const uint8_t*>(special),
      static_cast<const int64_t*>(rank), static_cast<const int64_t*>(merlen),
      static_cast<const int64_t*>(e_src), static_cast<const int64_t*>(e_dst),
      static_cast<const uint8_t*>(e_alive),
      static_cast<const int64_t*>(mincov), static_cast<const int64_t*>(thr),
      static_cast<const uint8_t*>(guard), static_cast<uint8_t*>(alive_out),
      static_cast<uint8_t*>(e_alive_out), static_cast<uint8_t*>(any_out),
      static_cast<uint8_t*>(over_out), NI, EE, U, D2, mode, max_len);
  return static_cast<int>(cudaGetLastError());
}

// K3: B strings [B, LP] of base codes, lengths [B]; K <= 63; blocks a
// string (the cluster size, 1-8), threads a block (a multiple of 32, at
// most 1,024) and tile (window starts, a multiple of 32 and of 16 bytes)
// from gpu/walks.py::almost_repeat_plan; smem must equal
// almost_repeat_smem(LP).
int almost_repeat_paths(const void* seq, const void* lens, void* out, int B,
                        int LP, int K, int max_mismatch, int blocks,
                        int threads, int tile, size_t smem, void* stream) {
  if (B < 1 || LP < 1 || K < 0 || K > 63 || blocks < 1 || blocks > 8 ||
      threads < 32 || threads > kArMaxThreads || threads % 32 != 0 ||
      tile < 32 || tile % 32 != 0 || smem != almost_repeat_smem(LP) ||
      smem > kSmemLimit - 16 || static_cast<long long>(B) * blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = set_smem(reinterpret_cast<const void*>(almost_repeat_kernel), smem);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * blocks));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(blocks);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  rc = static_cast<int>(cudaLaunchKernelEx(
      &cfg, almost_repeat_kernel, static_cast<const uint8_t*>(seq),
      static_cast<const int32_t*>(lens), static_cast<uint8_t*>(out), LP, K,
      max_mismatch, tile));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// K4: W windows x Cmax components, adjacency [W, NI, D2] (D2 <= 63),
// edges [W, EE]; walkers (1-8) warps walk at once. With ent (global mode)
// the successor lists go there, W * NI * D2 uint32; smem must equal
// cycle_dfs_smem's total.
int cycle_dfs(const void* adj, const void* e_dst, const void* e_dir,
              const void* alive, const void* special, const void* lane_mask,
              void* flags, void* ent, int W, int NI, int D2, int EE, int N,
              int Cmax, int walkers, size_t smem, void* stream) {
  if (W < 1 || NI < 1 || NI >= (1 << 19) || D2 < 1 || D2 > 63 || EE < 1 ||
      Cmax < 1 || walkers < 1 || walkers > kStageThreads / 32 ||
      smem > kSmemLimit ||
      smem != cycle_dfs_smem(NI, D2, EE, Cmax, walkers, ent != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = set_smem(reinterpret_cast<const void*>(cycle_dfs_kernel), smem);
  if (rc != 0) return rc;
  cycle_dfs_kernel<<<W, kStageThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(adj), static_cast<const int32_t*>(e_dst),
      static_cast<const int32_t*>(e_dir), static_cast<const uint8_t*>(alive),
      static_cast<const uint8_t*>(special),
      static_cast<const uint8_t*>(lane_mask), static_cast<uint8_t*>(flags),
      static_cast<uint32_t*>(ent), NI, D2, EE, N, Cmax, walkers);
  return static_cast<int>(cudaGetLastError());
}

// The probe: one block of 32 threads; out one int32 on the card.
int smem_chase(int steps, void* out, void* stream) {
  if (steps < 0) return static_cast<int>(cudaErrorInvalidValue);
  smem_chase_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
