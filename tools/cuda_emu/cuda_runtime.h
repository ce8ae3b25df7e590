// A CPU emulation of the part of the CUDA runtime and device library that
// lancet_tpu_torch/csrc/dbg.cu uses, for running its kernels with g++ on a
// machine without a card (tools/cuda_emu/emu.py builds a source against
// it). A launch runs its blocks one after another, each block's threads as
// std::threads: __syncthreads is a barrier of the block, a warp's shuffles
// and votes exchange values through the block's slots between two
// barriers of the warp, atomics are std::atomic_ref. Dynamic shared memory
// is the block's own buffer (emu_dyn_smem), static __shared__ variables
// are function statics (one block at a time shares them). What it cannot
// show: anything of the card's compiler (registers, spills, refused
// launches), races that a barrier-per-warp schedule hides, and timing.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __align__(x)

struct EmuDim {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local EmuDim threadIdx, blockIdx, blockDim;

struct EmuBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> wbar;
  std::vector<long long> slot;
  std::vector<unsigned char> smem;
  std::atomic<long long> red{0};
};
inline thread_local EmuBlock* emu_blk = nullptr;

inline unsigned char* emu_dyn_smem() {
  unsigned char* p = emu_blk->smem.data();
  return p + ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15);
}

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
inline unsigned long long __brevll(unsigned long long x) {
  unsigned long long r = 0;
  for (int i = 0; i < 64; ++i) r |= ((x >> i) & 1ULL) << (63 - i);
  return r;
}

inline int atomicMin(int* a, int v) {
  std::atomic_ref<int> r(*a);
  int o = r.load();
  while (v < o && !r.compare_exchange_weak(o, v)) {
  }
  return o;
}
inline int atomicOr(int* a, int v) {
  return std::atomic_ref<int>(*a).fetch_or(v);
}
inline int atomicAdd(int* a, int v) {
  return std::atomic_ref<int>(*a).fetch_add(v);
}
inline unsigned long long atomicAdd(unsigned long long* a,
                                    unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*a).fetch_add(v);
}

inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __ll2float_rn(long long a) { return static_cast<float>(a); }
struct int4 {
  int x, y, z, w;
};
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
using std::max;
using std::min;

typedef int cudaError_t;
enum { cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
typedef struct CUstream_st* cudaStream_t;
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) {
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }

// kernel<<<grid, threads, smem, stream>>>(args) becomes
// emu_launch(grid, threads, smem, [&] { kernel(args); })
template <class F>
void emu_launch(int grid, int threads, size_t smem, F&& body) {
  for (int b = 0; b < grid; ++b) {
    EmuBlock blk;
    blk.bar = std::make_unique<std::barrier<>>(threads);
    for (int i = 0; i < threads / 32; ++i)
      blk.wbar.push_back(std::make_unique<std::barrier<>>(32));
    blk.slot.assign(threads, 0);
    blk.smem.assign(smem + 16, 0xAB);  // garbage, as a card's
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        blockDim.x = threads;
        emu_blk = &blk;
        body();
      });
    for (auto& t : ts) t.join();
  }
}
