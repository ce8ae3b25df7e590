// One window's removal pass of removeTips (mode 0) or removeShortLinks
// (mode 1) as a __device__ function of one block: the body of K2
// seq_removal (csrc/walks.cu) and of the removal rounds of tip_fixpoint
// (csrc/cleanup.cu). It replaces lancet_tpu/tpu/stages.py::
// _seq_removal_pass (:580-622): the map-rank slot order (_rank_slots), the
// neighbour lists and live degrees (_nbr_table), the sequential sweep and
// remove_items, on the engine's state tensors as they are (bool and
// int64). gpu/stages.py::seq_removal_pass_plain is the same pass in torch
// ops:
// - the slots: the live items (alive, not special) sorted stably by rank,
//   ties by item id; the sweep visits the first min(n, U); n > U sets over;
// - the degree: the count of all alive edges by source; an item's
//   neighbours are its first D2 alive edges in edge order; a source of
//   more than D2 alive edges sets over;
// - a slot's item is killed when it is not removed yet, its live degree
//   passes the mode's test (tips <= 1, links >= 2) and its static test
//   holds (merlen < max_len; links also mincov <= thr and no guard); a kill
//   lowers the degree of each listed neighbour nb != item not removed yet,
//   once an edge (a duplicate edge twice);
// - then every removed item dies, and every alive edge touching one.
//
// What bounds it: the sweep's serial chain, then the launch. The busiest
// window of the engine's largest call sweeps ~10 slots; the bytes are a
// few KB a window. The first design swept with one warp but loaded each
// slot's id and merlen from device memory on the chain, and the host ran
// the slot order, a [W, NI, D2] neighbour table and the removal as ~70
// torch ops around it. This design runs the pass in one block a window:
// 1. all threads stage the window in shared memory: a flag byte an item
//    (bit 0 alive, bit 1 removed, bit 2 its static test), its degree and
//    its first and last alive edge (shared atomics), a word an edge (src <<
//    16 | dst, clamped into [0, NI); kDeadEdge if dead), and the live
//    items' keys (rank << 16 | id) appended to a list; a thread issues the
//    loads of kUnroll items or edges before it uses any, so that the
//    staging waits on device memory about once a round, not once for each
//    dependent load (a first version, which loaded the static test's
//    inputs after the slot order and an edge's ends after its alive byte,
//    took longer on the engine's largest call);
// 2. all threads give each live item its slot, the count of keys below its
//    own (exact for any n; n is tens on the engine's data), and write the
//    slot's entry: the item where its static test holds, else -1 (a slot
//    that cannot kill changes nothing);
// 3. one warp sweeps the slots 32 at a time: a ballot of the candidates,
//    then each in order: its degree and flag (one shared word, broadcast);
//    on a kill the lanes read the item's edge words from its first to its
//    last alive edge, 32 at a time, a ballot and popc keeping the first D2
//    of its own in edge order, and decrement by shared atomics;
// 4. all threads write alive', e_alive' (unless the outputs are null: a
//    pass whose state is not kept), removed_any and over.
// No device-memory load lies on the sweep's chain. Every barrier is
// reached by all kT threads of the block (a block larger than the pass
// needs runs it whole, its other warps idle through the sweep).
//
// Its loads and stores are plain: a caller may pass the same tensor as an
// input and an output (the outputs are written after the last load, behind
// a barrier).
// Preconditions: live items' ranks in [-2^47, 2^30) (below BIG, the plain
// version's key of a dead item); alive edges' endpoints in [0, NI); NI <=
// kRemovalMaxItems (gpu/walks.py::seq_removal_plan).

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace removal {

constexpr int kUnroll = 4;  // items or edges a thread loads at once
constexpr uint32_t kDeadEdge = 0xffffffffu;  // its source 0xffff: no item
constexpr int kMaxItems = 32767;  // an item id fits 15 bits
constexpr unsigned kFullMask = 0xffffffffu;

__host__ __device__ constexpr size_t r16(size_t x) {
  return (x + 15) / 16 * 16;
}

// Dynamic shared memory of a pass (gpu/walks.py::seq_removal_smem computes
// the same): two counters, the live items' keys (8 bytes an item), the
// edge words (4 an edge), the degrees and first and last edges (12 an
// item), the slot entries (2 a slot, at most NI) and the flags (1 an item).
__host__ __device__ inline size_t smem_bytes(int NI, int EE, int U) {
  const size_t ni = static_cast<size_t>(NI);
  return 16 + r16(ni * 8) + r16(static_cast<size_t>(EE) * 4) + r16(ni * 12) +
         r16(static_cast<size_t>(U < NI ? U : NI) * 2) + r16(ni);
}

__device__ __forceinline__ int clamp_item(int64_t x, int NI) {
  return static_cast<int>(x < 0 ? 0 : (x > NI - 1 ? NI - 1 : x));
}

// The pass on window w of a block of kT threads (a multiple of 32, at least
// 32), its shared memory at smb (smem_bytes). The inputs are the [W, NI]
// and [W, EE] tensors (mincov, thr and guard only in mode 1); alive_out
// and e_alive_out the same shapes, or both null; removed_any and over one
// byte each, written by thread 0.
template <int kT>
__device__ __forceinline__ void pass(
    const uint8_t* alive, const uint8_t* special, const int64_t* rank,
    const int64_t* merlen, const int64_t* e_src, const int64_t* e_dst,
    const uint8_t* e_alive, const int64_t* mincov, const int64_t* thr,
    const uint8_t* guard, uint8_t* alive_out, uint8_t* e_alive_out,
    uint8_t* any_out, uint8_t* over_out, int w, int NI, int EE, int U,
    int D2, int mode, long long max_len, uint8_t* smb) {
  int32_t* hdr = reinterpret_cast<int32_t*>(smb);  // live count, deg over
  int64_t* key = reinterpret_cast<int64_t*>(smb + 16);
  uint32_t* ew = reinterpret_cast<uint32_t*>(
      reinterpret_cast<uint8_t*>(key) + r16(static_cast<size_t>(NI) * 8));
  int32_t* deg = reinterpret_cast<int32_t*>(
      reinterpret_cast<uint8_t*>(ew) + r16(static_cast<size_t>(EE) * 4));
  int32_t* efirst = deg + NI;
  int32_t* elast = efirst + NI;
  int16_t* slot = reinterpret_cast<int16_t*>(
      reinterpret_cast<uint8_t*>(deg) + r16(static_cast<size_t>(NI) * 12));
  uint8_t* flag = reinterpret_cast<uint8_t*>(slot) +
                  r16(static_cast<size_t>(min(U, NI)) * 2);
  const int tid = threadIdx.x;
  const size_t bi = static_cast<size_t>(w) * NI;
  const size_t be = static_cast<size_t>(w) * EE;

  // ---- 1. staging, the whole block ----
  const long long th = mode ? thr[w] : 0;
  if (tid == 0) {
    hdr[0] = 0;
    hdr[1] = 0;
  }
  for (int i = tid; i < NI; i += kT) {
    deg[i] = 0;
    efirst[i] = INT_MAX;
    elast[i] = -1;
  }
  __syncthreads();
  for (int i0 = tid; i0 < NI; i0 += kUnroll * kT) {
    uint8_t a[kUnroll], sp[kUnroll], gu[kUnroll];
    long long r[kUnroll], ml[kUnroll], mc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kT;
      const bool in = i < NI;
      a[u] = in ? alive[bi + i] : 0;
      sp[u] = in ? special[bi + i] : 0;
      r[u] = in ? rank[bi + i] : 0;
      ml[u] = in ? merlen[bi + i] : 0;
      mc[u] = in && mode ? mincov[bi + i] : 0;
      gu[u] = in && mode ? guard[bi + i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kT;
      if (i >= NI) break;
      const bool cand = ml[u] < max_len && (!mode || (mc[u] <= th && !gu[u]));
      flag[i] = a[u] ? (cand ? 5 : 1) : 0;  // bit 2: the static test holds
      if (a[u] && !sp[u]) {
        const int k = atomicAdd(&hdr[0], 1);
        key[k] = r[u] * 65536 + i;  // (rank, id) in one signed key
      }
    }
  }
  for (int e0 = tid; e0 < EE; e0 += kUnroll * kT) {
    uint8_t ea[kUnroll];
    long long es[kUnroll], ed[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kT;
      const bool in = e < EE;
      ea[u] = in ? e_alive[be + e] : 0;
      es[u] = in ? e_src[be + e] : 0;
      ed[u] = in ? e_dst[be + e] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kT;
      if (e >= EE) break;
      uint32_t v = kDeadEdge;
      if (ea[u]) {
        const int s = clamp_item(es[u], NI);
        const int d = clamp_item(ed[u], NI);
        atomicAdd(&deg[s], 1);
        atomicMin(&efirst[s], e);
        atomicMax(&elast[s], e);
        v = static_cast<uint32_t>(s) << 16 | static_cast<uint32_t>(d);
      }
      ew[e] = v;
    }
  }
  __syncthreads();

  // ---- 2. slots, the whole block ----
  const int n = hdr[0];
  const int ns = min(n, U);
  for (int k = tid; k < n; k += kT) {
    const long long kk = key[k];
    int pos = 0;
#pragma unroll 4
    for (int j = 0; j < n; ++j) pos += key[j] < kk;
    if (pos < ns) {
      const int it = static_cast<int>(kk & 0xffff);
      slot[pos] = static_cast<int16_t>(flag[it] & 4 ? it : -1);
    }
  }
  for (int i = tid; i < NI; i += kT)
    if (deg[i] > D2) hdr[1] = 1;
  __syncthreads();

  // ---- 3. the sweep, one warp ----
  if (tid < 32) {
    const int lane = tid;
    const unsigned below = (1u << lane) - 1;
    bool any = false;
    for (int b = 0; b < ns; b += 32) {
      const int it = b + lane < ns ? slot[b + lane] : -1;
      unsigned cand = __ballot_sync(kFullMask, it >= 0);
      while (cand) {
        const int item = __shfl_sync(kFullMask, it, __ffs(cand) - 1);
        cand &= cand - 1;
        const int d = deg[item];
        const bool kill = (flag[item] & 3) == 1 &&
                          (mode == 0 ? d <= 1 : d >= 2);  // warp-uniform
        if (!kill) continue;
        const int hi = elast[item];
        int taken = 0;
        for (int c = efirst[item]; c <= hi && taken < D2; c += 32) {
          const int e = c + lane;
          const uint32_t v = e <= hi ? ew[e] : kDeadEdge;
          const bool mine = static_cast<int>(v >> 16) == item;
          const unsigned m = __ballot_sync(kFullMask, mine);
          if (mine && taken + __popc(m & below) < D2) {
            const int nb = static_cast<int>(v & 0xffff);
            if (nb != item && !(flag[nb] & 2)) atomicSub(&deg[nb], 1);
          }
          taken += __popc(m);
        }
        __syncwarp();
        if (lane == 0) flag[item] |= 2;
        any = true;
        __syncwarp();
      }
    }
    if (lane == 0) {
      *any_out = any;
      *over_out = n > U || hdr[1] != 0;
    }
  }
  __syncthreads();

  // ---- 4. the removal, the whole block ----
  if (alive_out == nullptr) return;
  for (int i = tid; i < NI; i += kT) alive_out[bi + i] = (flag[i] & 3) == 1;
  for (int e = tid; e < EE; e += kT) {
    const uint32_t v = ew[e];
    e_alive_out[be + e] = v != kDeadEdge && !(flag[v >> 16] & 2) &&
                          !(flag[v & 0xffff] & 2);
  }
}

}  // namespace removal
