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
// gpu/stages.py::seq_removal_plain, gpu/pipeline.py::almost_repeat_plain,
// gpu/stages.py::cycle_dfs_plain) are those loops step for step.
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
// and run many windows side by side, one block each.
//
// Integer inputs are int32, booleans one byte each (0 or 1).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ---------------------------------------------------------------------------
// K1 path_cover: the best-new-edge eka/BFS path cover (ref Graph.cc:
// 1299-1501). One warp per window. The per-window scalars (component, head,
// tail, best entry) are uniform across the warp; lane l expands adjacency
// slot l of the popped entry. Shared memory: the Q-entry queue (item, dir,
// parent, edge, len, score, flag), the covered-edge bits and the parent
// walk's hop buffer.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32) path_cover_kernel(
    const int32_t* __restrict__ adj, const int32_t* __restrict__ e_dst,
    const int32_t* __restrict__ e_dir, const int32_t* __restrict__ merlen,
    const uint8_t* __restrict__ special, const uint8_t* __restrict__ runnable,
    const int32_t* __restrict__ numcomp, const int32_t* __restrict__ reflens,
    int32_t* __restrict__ sel_edges, int32_t* __restrict__ sel_hops,
    int32_t* __restrict__ sel_comp, int32_t* __restrict__ n_sel_out,
    uint8_t* __restrict__ fb_out, int NI, int D2, int EE, int K, int N,
    int Cmax, int dfs_limit, int max_indel, int Q, int POPMAX, int JMAX,
    int PN) {
  extern __shared__ int32_t sm[];
  int32_t* qi = sm;
  int32_t* qd = qi + Q;
  int32_t* qp = qd + Q;
  int32_t* qe = qp + Q;
  int32_t* ql = qe + Q;
  int32_t* qs = ql + Q;
  uint32_t* cov = reinterpret_cast<uint32_t*>(qs + Q);
  const int ncw = (EE + 31) / 32;
  int32_t* hop = reinterpret_cast<int32_t*>(cov + ncw);
  uint8_t* qf = reinterpret_cast<uint8_t*>(hop + PN);

  const int w = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int32_t* adj_w = adj + static_cast<size_t>(w) * NI * D2;
  const int32_t* dst_w = e_dst + static_cast<size_t>(w) * EE;
  const int32_t* dir_w = e_dir + static_cast<size_t>(w) * EE;
  const int32_t* ml_w = merlen + static_cast<size_t>(w) * NI;
  const uint8_t* sp_w = special + static_cast<size_t>(w) * NI;
  int32_t* se_w = sel_edges + static_cast<size_t>(w) * JMAX * PN;
  for (int i = lane; i < JMAX * PN; i += 32) se_w[i] = -1;
  for (int i = lane; i < JMAX; i += 32) {
    sel_hops[w * JMAX + i] = 0;
    sel_comp[w * JMAX + i] = 0;
  }
  for (int i = lane; i < ncw; i += 32) cov[i] = 0;
  __syncwarp();

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
      if (lane == 0) {
        qi[0] = src_item;
        qd[0] = 0;
        qp[0] = -1;
        qe[0] = -1;
        ql[0] = K;
        qs[0] = 0;
        qf[0] = 1;
      }
      __syncwarp();
      int head = 0, tail = 1, visits = 0;
      bool on = true;
      for (int pops = 0; pops < POPMAX && head < tail; ++pops) {
        if (++visits > dfs_limit) {
          on = false;
          break;
        }
        const int hs = min(head, Q - 1);
        const int it = qi[hs], dr = qd[hs], ln = ql[hs], sc = qs[hs];
        const bool fl = qf[hs] != 0;
        const bool at_sink = it == sink_item && !fl;
        if (at_sink && (bi < 0 || sc > bs)) {  // first-found best: strict >
          bi = head;
          bs = sc;
        }
        if (!at_sink && !(ln > reflen + max_indel)) {
          const int its = clampi(it, 0, NI - 1);
          const int e = lane < D2 ? adj_w[its * D2 + lane] : -1;
          int es = 0, ed = 0;
          bool okc = false;
          if (e >= 0) {
            es = min(e, EE - 1);
            ed = dir_w[es];
            okc = (ed >> 1) == dr;
          }
          const unsigned bal = __ballot_sync(kFull, okc);
          const int cnt = __popc(bal);
          const int room = max(Q - tail, 0);
          if (okc) {
            const int tgt = tail + __popc(bal & lt_mask);
            if (tgt < Q) {
              const int dst = dst_w[es];
              const int dsts = clampi(dst, 0, NI - 1);
              const bool cov_e = (cov[es >> 5] >> (es & 31)) & 1u;
              qi[tgt] = dst;
              qd[tgt] = ed & 1;
              qp[tgt] = head;
              qe[tgt] = e;
              ql[tgt] = ln + (sp_w[dsts] ? 1 - K : ml_w[dsts]);
              qs[tgt] = sc + (cov_e ? 0 : 1);
              qf[tgt] = fl && cov_e;
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
    // walk the parents of the best entry (one lane), marking covered
    int cur = has ? bi : -1;
    int nh = 0;
    if (lane == 0) {
      for (int p = 0; p < PN; ++p) {
        const int cs = clampi(cur, 0, Q - 1);
        const int e = cur >= 0 ? qe[cs] : -1;
        if (cur >= 0 && e >= 0) {
          const int ce = min(e, EE - 1);
          cov[ce >> 5] |= 1u << (ce & 31);
          hop[p] = e;
          ++nh;
          cur = qp[cs];
        } else {
          hop[p] = -1;
          cur = -1;
        }
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
// K2 seq_removal: one map-rank-order sweep of removeTips (mode 0: live
// degree <= 1 and merlen < max_len) or removeShortLinks (mode 1: degree >=
// 2, merlen < max_len, mincov <= thr and no STR guard). One warp per
// window walks the slots in order; a kill's neighbour-degree decrements
// (which commute) go one per lane. deg and removed live in shared memory.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32) seq_removal_kernel(
    const int32_t* __restrict__ slots, const int32_t* __restrict__ nbr,
    const int32_t* __restrict__ deg0, const int32_t* __restrict__ merlen,
    const int32_t* __restrict__ mincov, const uint8_t* __restrict__ guard,
    const int32_t* __restrict__ thr, uint8_t* __restrict__ removed_out, int U,
    int NI, int D2, int mode, int max_len) {
  extern __shared__ int32_t sm[];
  int32_t* deg = sm;
  uint8_t* rem = reinterpret_cast<uint8_t*>(deg + NI);
  const int w = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t base = static_cast<size_t>(w) * NI;
  for (int i = lane; i < NI; i += 32) {
    deg[i] = deg0[base + i];
    rem[i] = 0;
  }
  __syncwarp();
  const int th = thr[w];
  for (int i = 0; i < U; ++i) {
    const int it = slots[static_cast<size_t>(w) * U + i];
    if (it < 0) break;  // the valid slots are a prefix
    const int safe = min(it, NI - 1);
    const int d = deg[safe];
    bool kill = rem[safe] == 0 && merlen[base + safe] < max_len;
    if (mode == 0) {
      kill = kill && d <= 1;
    } else {
      kill = kill && d >= 2 && mincov[base + safe] <= th &&
             guard[base + safe] == 0;
    }
    if (kill) {
      if (lane < D2) {
        const int nb = nbr[(base + safe) * D2 + lane];
        if (nb >= 0 && nb != safe && rem[nb] == 0) atomicSub(&deg[nb], 1);
      }
      __syncwarp();
      if (lane == 0) rem[safe] = 1;
    }
    __syncwarp();
  }
  for (int i = lane; i < NI; i += 32) removed_out[base + i] = rem[i];
}

// ---------------------------------------------------------------------------
// K3 almost_repeat_paths: isAlmostRepeat of a path string (ref util.cc:
// 317-360): is there a shift d >= 1 and an offset p with p + d <= maxp =
// len - K - 1 whose (K+1)-windows at p and p+d differ in at most
// max_mismatch places? One block per string with its bytes in shared
// memory; each thread takes shifts d, slides the window over p keeping the
// mismatch count (add the entering position, drop the leaving one), and
// stops at a hit, which every thread then sees.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256) almost_repeat_kernel(
    const uint8_t* __restrict__ seq, const int32_t* __restrict__ lens,
    uint8_t* __restrict__ out, int LP, int K, int mm) {
  extern __shared__ uint8_t s[];
  __shared__ int found;
  const int b = blockIdx.x;
  const int len = min(max(lens[b], 0), LP);
  const uint8_t* row = seq + static_cast<size_t>(b) * LP;
  for (int i = threadIdx.x; i < len; i += blockDim.x) s[i] = row[i];
  if (threadIdx.x == 0) found = 0;
  __syncthreads();
  const int maxp = len - K - 1;
  for (int d = 1 + threadIdx.x; d <= maxp; d += blockDim.x) {
    if (*reinterpret_cast<volatile int*>(&found)) break;
    int m = 0;
    for (int q = 0; q <= K; ++q) m += s[q] != s[q + d];
    bool hit = m <= mm;
    for (int p = 1; !hit && p <= maxp - d; ++p) {
      m += (s[p + K] != s[p + K + d]) - (s[p - 1] != s[p - 1 + d]);
      hit = m <= mm;
    }
    if (hit) {
      found = 1;
      break;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) out[b] = found != 0;
}

// ---------------------------------------------------------------------------
// K4 cycle_dfs: the exact hasCycleRec replay (ref Graph.cc:593-681) for one
// component of one window per block: two rooted searches, (source, F) then
// (source, R), sharing node colours (WHITE 0, GREY 1, BLACK 2); a GREY hit
// in either orientation is a cycle; specials are never entered. The stack
// (NI+2 frames of node, dir, next adjacency slot) and the colours sit in
// shared memory (53.5 KB at the largest bucket's NI 4,112, opted in above
// the default 48 KB). One thread walks; the warp clears the colours.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32) cycle_dfs_kernel(
    const int32_t* __restrict__ adj, const int32_t* __restrict__ e_dst,
    const int32_t* __restrict__ e_dir, const uint8_t* __restrict__ alive,
    const uint8_t* __restrict__ special, const uint8_t* __restrict__ lane_mask,
    uint8_t* __restrict__ flags, int NI, int D2, int EE, int N, int Cmax) {
  extern __shared__ int32_t sm[];
  const int blk = blockIdx.x;
  const int w = blk / Cmax;
  const int c = blk % Cmax;
  const int src = N + 2 * c;
  const size_t ib = static_cast<size_t>(w) * NI;
  const bool active =
      src < NI && alive[ib + src] != 0 && lane_mask[w * Cmax + c] != 0;
  if (!active) {
    if (threadIdx.x == 0) flags[w * Cmax + c] = 0;
    return;
  }
  const int SD = NI + 2;
  int32_t* s_node = sm;
  int32_t* s_dir = s_node + SD;
  int32_t* s_ei = s_dir + SD;
  uint8_t* color = reinterpret_cast<uint8_t*>(s_ei + SD);
  for (int i = threadIdx.x; i < NI; i += blockDim.x) color[i] = 0;
  __syncwarp();
  if (threadIdx.x != 0) return;
  const int32_t* adj_w = adj + ib * D2;
  const int32_t* dst_w = e_dst + static_cast<size_t>(w) * EE;
  const int32_t* dir_w = e_dir + static_cast<size_t>(w) * EE;
  const uint8_t* sp_w = special + ib;
  bool cyc = false;
  for (int d0 = 0; d0 < 2 && !cyc; ++d0) {
    int sp = 1;
    s_node[0] = src;
    s_dir[0] = d0;
    s_ei[0] = 0;
    color[src] = 1;
    while (sp > 0 && !cyc) {
      const int tp = sp - 1;
      const int nds = clampi(s_node[tp], 0, NI - 1);
      const int dr = s_dir[tp];
      const int ei = s_ei[tp];
      const int e = ei < D2 ? adj_w[nds * D2 + ei] : -1;
      if (e < 0) {  // exhausted: pop, node -> BLACK
        color[nds] = 2;
        --sp;
        continue;
      }
      s_ei[tp] = ei + 1;
      const int es = min(e, EE - 1);
      const int ed = dir_w[es];
      if ((ed >> 1) != dr) continue;
      const int v = dst_w[es];
      const int vs = clampi(v, 0, NI - 1);
      if (sp_w[vs]) continue;
      const int vcol = color[vs];
      if (vcol == 1) {
        cyc = true;
      } else if (vcol == 0) {
        color[vs] = 1;
        const int ns = min(sp, SD - 1);
        s_node[ns] = v;
        s_dir[ns] = ed & 1;
        s_ei[ns] = 0;
        ++sp;
      }
    }
  }
  flags[w * Cmax + c] = cyc;
}

int set_smem(const void* kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

constexpr size_t kSmemLimit = 232448;  // bytes a block may use on Hopper

}  // namespace

extern "C" {

// K1: W windows, adjacency [W, NI, D2] (D2 <= 32), edges [W, EE].
int path_cover(const void* adj, const void* e_dst, const void* e_dir,
               const void* merlen, const void* special, const void* runnable,
               const void* numcomp, const void* reflens, void* sel_edges,
               void* sel_hops, void* sel_comp, void* n_sel, void* fallback,
               int W, int NI, int D2, int EE, int K, int N, int Cmax,
               int dfs_limit, int max_indel, int Q, int POPMAX, int JMAX,
               int PN, void* stream) {
  if (W < 1 || NI < 1 || D2 < 1 || D2 > 32 || EE < 1 || Q < 1 || Cmax < 1 ||
      JMAX < 1 || PN < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(Q) * 25 +
                      static_cast<size_t>((EE + 31) / 32) * 4 +
                      static_cast<size_t>(PN) * 4 + 16;
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  int rc = set_smem(reinterpret_cast<const void*>(path_cover_kernel), smem);
  if (rc != 0) return rc;
  path_cover_kernel<<<W, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(adj), static_cast<const int32_t*>(e_dst),
      static_cast<const int32_t*>(e_dir), static_cast<const int32_t*>(merlen),
      static_cast<const uint8_t*>(special),
      static_cast<const uint8_t*>(runnable),
      static_cast<const int32_t*>(numcomp),
      static_cast<const int32_t*>(reflens), static_cast<int32_t*>(sel_edges),
      static_cast<int32_t*>(sel_hops), static_cast<int32_t*>(sel_comp),
      static_cast<int32_t*>(n_sel), static_cast<uint8_t*>(fallback), NI, D2,
      EE, K, N, Cmax, dfs_limit, max_indel, Q, POPMAX, JMAX, PN);
  return static_cast<int>(cudaGetLastError());
}

// K2: W windows, slots [W, U], neighbours [W, NI, D2] (D2 <= 32).
int seq_removal(const void* slots, const void* nbr, const void* deg,
                const void* merlen, const void* mincov, const void* guard,
                const void* thr, void* removed, int W, int U, int NI, int D2,
                int mode, int max_len, void* stream) {
  if (W < 1 || U < 0 || NI < 1 || D2 < 1 || D2 > 32 || mode < 0 || mode > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(NI) * 5 + 16;
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  int rc = set_smem(reinterpret_cast<const void*>(seq_removal_kernel), smem);
  if (rc != 0) return rc;
  seq_removal_kernel<<<W, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(slots), static_cast<const int32_t*>(nbr),
      static_cast<const int32_t*>(deg), static_cast<const int32_t*>(merlen),
      static_cast<const int32_t*>(mincov), static_cast<const uint8_t*>(guard),
      static_cast<const int32_t*>(thr), static_cast<uint8_t*>(removed), U, NI,
      D2, mode, max_len);
  return static_cast<int>(cudaGetLastError());
}

// K3: B strings [B, LP] of base codes, lengths [B].
int almost_repeat_paths(const void* seq, const void* lens, void* out, int B,
                        int LP, int K, int max_mismatch, void* stream) {
  if (B < 1 || LP < 1 || K < 0 || static_cast<size_t>(LP) > kSmemLimit - 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(LP) + 15) / 16 * 16;
  int rc = set_smem(reinterpret_cast<const void*>(almost_repeat_kernel), smem);
  if (rc != 0) return rc;
  almost_repeat_kernel<<<B, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), static_cast<const int32_t*>(lens),
      static_cast<uint8_t*>(out), LP, K, max_mismatch);
  return static_cast<int>(cudaGetLastError());
}

// K4: W windows x Cmax components, adjacency [W, NI, D2], edges [W, EE].
int cycle_dfs(const void* adj, const void* e_dst, const void* e_dir,
              const void* alive, const void* special, const void* lane_mask,
              void* flags, int W, int NI, int D2, int EE, int N, int Cmax,
              void* stream) {
  if (W < 1 || NI < 1 || D2 < 1 || EE < 1 || Cmax < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(NI + 2) * 12 +
                      (static_cast<size_t>(NI) + 15) / 16 * 16;
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  int rc = set_smem(reinterpret_cast<const void*>(cycle_dfs_kernel), smem);
  if (rc != 0) return rc;
  cycle_dfs_kernel<<<W * Cmax, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(adj), static_cast<const int32_t*>(e_dst),
      static_cast<const int32_t*>(e_dir), static_cast<const uint8_t*>(alive),
      static_cast<const uint8_t*>(special),
      static_cast<const uint8_t*>(lane_mask), static_cast<uint8_t*>(flags), NI,
      D2, EE, N, Cmax);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
