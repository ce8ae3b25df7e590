// A CPU emulation of the part of the CUDA runtime and device library that
// lancet_tpu_torch/csrc/dbg.cu, compress.cu, cleanup.cu and graphstate.cu
// use, for running their kernels with g++ on a machine without a card
// (tools/cuda_emu/emu.py builds a source against it). A launch runs its
// thread block clusters one after another (a two-dimensional grid row by
// row), the blocks of a cluster at once, and a cooperative launch
// (cudaLaunchAttributeCooperative) every block at once; each thread of a
// block is a std::thread: __syncthreads is a barrier of the block, the
// cluster barriers (cluster_arrive / cluster_wait, this_cluster().sync())
// a std::barrier of the cluster's threads, this_grid().sync() one of the
// grid's, a warp's shuffles and votes exchange values through the block's
// slots between two barriers of the warp, atomics are std::atomic_ref.
// Dynamic shared memory is each block's own buffer (emu_dyn_smem), and
// peer() / map_shared_rank map an address in it to the same offset in
// another block of the cluster; static __shared__ variables are function
// statics (shared by every block: only kernels launched without clusters
// may use them). A bulk copy (stage_copy) is a memcpy by the issuing
// thread, its mbarrier nothing (the cluster barrier before the first wait
// orders the copy). What it cannot show: anything of the card's compiler
// (registers, spills, refused launches), races that a barrier-per-warp
// schedule hides, and timing.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <optional>
#include <thread>
#include <vector>

#define CUDA_EMU 1
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __align__(x)

struct EmuDim {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local EmuDim threadIdx, blockIdx, blockDim, gridDim;

struct EmuBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> wbar;
  std::vector<long long> slot;
  std::vector<unsigned char> smem;
  std::atomic<long long> red{0};
  unsigned char* base() {
    unsigned char* p = smem.data();
    return p + ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15);
  }
};
struct EmuGroup {  // a cluster's or a grid's threads
  std::unique_ptr<std::barrier<>> bar;
  std::vector<EmuBlock*> blocks;
};
inline thread_local EmuBlock* emu_blk = nullptr;
inline thread_local EmuGroup* emu_cl = nullptr;
inline thread_local EmuGroup* emu_gr = nullptr;
inline thread_local int emu_rank = 0;
inline thread_local std::optional<std::barrier<>::arrival_token> emu_token;

inline unsigned char* emu_dyn_smem() { return emu_blk->base(); }

inline void __syncthreads() { emu_blk->bar->arrive_and_wait(); }

inline int emu_reduce(int p, bool is_or) {
  __syncthreads();
  if (threadIdx.x == 0) emu_blk->red = 0;
  __syncthreads();
  emu_blk->red += p != 0;
  __syncthreads();
  const long long r = emu_blk->red;
  __syncthreads();
  return is_or ? r != 0 : static_cast<int>(r);
}
inline int __syncthreads_count(int p) { return emu_reduce(p, false); }
inline int __syncthreads_or(int p) { return emu_reduce(p, true); }

inline void emu_wsync() { emu_blk->wbar[threadIdx.x / 32]->arrive_and_wait(); }
template <class T>
T emu_get(unsigned t) {
  T v;
  std::memcpy(&v, &emu_blk->slot[t], sizeof(T));
  return v;
}
template <class T>
void emu_put(T v) {
  long long x = 0;
  std::memcpy(&x, &v, sizeof(T));
  emu_blk->slot[threadIdx.x] = x;
}
template <class T>
T __shfl_sync(unsigned, T v, int src) {
  emu_wsync();
  emu_put(v);
  emu_wsync();
  return emu_get<T>((threadIdx.x & ~31u) + (src & 31));
}
template <class T>
T __shfl_up_sync(unsigned, T v, int d) {
  emu_wsync();
  emu_put(v);
  emu_wsync();
  return static_cast<int>(threadIdx.x & 31) >= d ? emu_get<T>(threadIdx.x - d)
                                                 : v;
}
template <class T>
T __shfl_xor_sync(unsigned, T v, int d) {
  emu_wsync();
  emu_put(v);
  emu_wsync();
  return emu_get<T>((threadIdx.x & ~31u) + ((threadIdx.x & 31) ^ d));
}
inline int __any_sync(unsigned, int p) {
  emu_wsync();
  emu_put<int>(p != 0);
  emu_wsync();
  int r = 0;
  for (unsigned l = 0; l < 32; ++l) r |= emu_get<int>((threadIdx.x & ~31u) + l);
  return r;
}

inline unsigned __ballot_sync(unsigned, int p) {
  emu_wsync();
  emu_put<int>(p != 0);
  emu_wsync();
  unsigned r = 0;
  for (unsigned l = 0; l < 32; ++l)
    r |= static_cast<unsigned>(emu_get<int>((threadIdx.x & ~31u) + l)) << l;
  return r;
}
inline void __syncwarp(unsigned = 0xffffffffu) { emu_wsync(); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline unsigned long long __brevll(unsigned long long x) {
  unsigned long long r = 0;
  for (int i = 0; i < 64; ++i) r |= ((x >> i) & 1ULL) << (63 - i);
  return r;
}

template <class T>
T atomicMin(T* a, T v) {
  std::atomic_ref<T> r(*a);
  T o = r.load();
  while (v < o && !r.compare_exchange_weak(o, v)) {
  }
  return o;
}
template <class T>
T atomicMax(T* a, T v) {
  std::atomic_ref<T> r(*a);
  T o = r.load();
  while (v > o && !r.compare_exchange_weak(o, v)) {
  }
  return o;
}
template <class T>
T atomicOr(T* a, T v) {
  return std::atomic_ref<T>(*a).fetch_or(v);
}
inline unsigned atomicOr(unsigned* a, int v) {
  return std::atomic_ref<unsigned>(*a).fetch_or(static_cast<unsigned>(v));
}
template <class T>
T atomicAdd(T* a, T v) {
  return std::atomic_ref<T>(*a).fetch_add(v);
}
template <class T>
T atomicSub(T* a, T v) {
  return std::atomic_ref<T>(*a).fetch_sub(v);
}
template <class T>
T atomicExch(T* a, T v) {
  return std::atomic_ref<T>(*a).exchange(v);
}

inline long long clock64() { return 0; }  // no clock: the stamped build
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __ll2float_rn(long long a) { return static_cast<float>(a); }
struct int4 {
  int x, y, z, w;
};
struct uint4 {
  unsigned x, y, z, w;
};
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
using std::max;
using std::min;

// ---- clusters, grids, bulk copies ----------------------------------------

inline int cluster_rank() { return emu_rank; }

template <class T>
T* peer(T* p, int rank) {
  unsigned char* mine = emu_blk->base();
  const uintptr_t off = reinterpret_cast<uintptr_t>(p) -
                        reinterpret_cast<uintptr_t>(mine);
  if (off >= emu_blk->smem.size()) std::abort();  // not this block's smem
  return reinterpret_cast<T*>(emu_cl->blocks[rank]->base() + off);
}

inline void cluster_arrive() { emu_token.emplace(emu_cl->bar->arrive()); }
inline void cluster_wait() {
  emu_cl->bar->wait(std::move(*emu_token));
  emu_token.reset();
}

inline void stage_begin(unsigned long long*, unsigned) {}
inline void stage_copy(void* dst, const void* src, unsigned bytes,
                       unsigned long long*) {
  std::memcpy(dst, src, bytes);
}
inline void stage_wait(unsigned long long*) {}
inline void stage_end(unsigned long long*) {}
inline void prefetch_l2(const void*, unsigned) {}

namespace cooperative_groups {
struct grid_group {
  bool is_valid() const { return emu_gr != nullptr; }
  void sync() const {
    if (emu_gr == nullptr) std::abort();  // a grid barrier needs a
    emu_gr->bar->arrive_and_wait();       // cooperative launch
  }
};
struct cluster_group {
  unsigned block_rank() const { return static_cast<unsigned>(emu_rank); }
  unsigned num_blocks() const {
    return static_cast<unsigned>(emu_cl->blocks.size());
  }
  void sync() const { emu_cl->bar->arrive_and_wait(); }
  template <class T>
  T* map_shared_rank(T* p, unsigned r) const {
    return peer(p, static_cast<int>(r));
  }
};
inline grid_group this_grid() { return {}; }
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups

typedef int cudaError_t;
enum { cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
typedef struct CUstream_st* cudaStream_t;
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) {
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
enum cudaLaunchAttributeID {
  cudaLaunchAttributeClusterDimension = 4,
  cudaLaunchAttributeCooperative = 2
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  union {
    struct {
      unsigned x, y, z;
    } clusterDim;
    int cooperative;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes = 0;
  cudaStream_t stream = nullptr;
  cudaLaunchAttribute* attrs = nullptr;
  unsigned numAttrs = 0;
};
// every cluster fits: the checks choose the cluster size themselves
inline cudaError_t cudaOccupancyMaxActiveClusters(int* n, const void*,
                                                  const cudaLaunchConfig_t*) {
  *n = 1 << 20;
  return 0;
}

// blocks [b0, b0 + nb) of grid row y at once, in clusters of C, the
// grid's barrier `grid` (or none)
template <class F>
void emu_run(int b0, int nb, int grid_blocks, int threads, size_t smem,
             int C, EmuGroup* grid, F& body, unsigned y = 0,
             unsigned rows = 1) {
  std::vector<std::unique_ptr<EmuBlock>> blks;
  std::vector<std::unique_ptr<EmuGroup>> cls;
  for (int i = 0; i < nb; ++i) {
    auto blk = std::make_unique<EmuBlock>();
    blk->bar = std::make_unique<std::barrier<>>(threads);
    for (int k = 0; k < threads / 32; ++k)
      blk->wbar.push_back(std::make_unique<std::barrier<>>(32));
    blk->slot.assign(threads, 0);
    blk->smem.assign(smem + 16, 0xAB);  // garbage, as a card's
    if (i % C == 0) {
      cls.push_back(std::make_unique<EmuGroup>());
      cls.back()->bar = std::make_unique<std::barrier<>>(C * threads);
    }
    cls.back()->blocks.push_back(blk.get());
    blks.push_back(std::move(blk));
  }
  std::vector<std::thread> ts;
  for (int i = 0; i < nb; ++i)
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, i, t] {
        threadIdx.x = t;
        blockIdx.x = b0 + i;
        blockIdx.y = y;
        blockDim.x = threads;
        gridDim.x = grid_blocks;
        gridDim.y = rows;
        emu_blk = blks[i].get();
        emu_cl = cls[i / C].get();
        emu_gr = grid;
        emu_rank = i % C;
        body();
      });
  for (auto& t : ts) t.join();
}

template <class F>
void emu_launch(int grid, int threads, size_t smem, F&& body, int C = 1,
                bool coop = false) {
  if (coop) {
    EmuGroup g;
    g.bar = std::make_unique<std::barrier<>>(grid * threads);
    emu_run(0, grid, grid, threads, smem, C, &g, body);
    return;
  }
  for (int b = 0; b < grid; b += C)
    emu_run(b, C, grid, threads, smem, C, nullptr, body);
}

// a two-dimensional grid, without clusters: block by block, row by row
template <class F>
void emu_launch(dim3 grid, int threads, size_t smem, F&& body) {
  for (unsigned y = 0; y < grid.y; ++y)
    for (unsigned b = 0; b < grid.x; ++b)
      emu_run(static_cast<int>(b), 1, static_cast<int>(grid.x), threads, smem,
              1, nullptr, body, y, grid.y);
}

// kernel<<<grid, threads, smem, stream>>>(args) becomes
// emu_launch(grid, threads, smem, [&] { kernel(args); }); a
// cudaLaunchKernelEx launch takes its cluster and cooperative attributes
template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(P...), A&&... args) {
  int C = 1;
  bool coop = false;
  for (unsigned k = 0; k < cfg->numAttrs; ++k) {
    if (cfg->attrs[k].id == cudaLaunchAttributeClusterDimension)
      C = static_cast<int>(cfg->attrs[k].val.clusterDim.x);
    if (cfg->attrs[k].id == cudaLaunchAttributeCooperative)
      coop = cfg->attrs[k].val.cooperative != 0;
  }
  if (C < 1 || cfg->gridDim.x % C) return cudaErrorInvalidValue;
  emu_launch(static_cast<int>(cfg->gridDim.x),
             static_cast<int>(cfg->blockDim.x), cfg->dynamicSmemBytes,
             [&] { kernel(args...); }, C, coop);
  return 0;
}
