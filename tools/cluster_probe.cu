// What this card takes of the launch the compression body's clusters need
// (tools/cluster_probe.py builds and drives it): a thread block cluster
// (cudaLaunchAttributeClusterDimension) together with a cooperative launch
// (cudaLaunchAttributeCooperative) in one cudaLaunchKernelEx, with
// cg::this_grid().sync() and cg::this_cluster().sync() inside, and what
// cudaOccupancyMaxActiveClusters reports for blocks of 512 threads at a
// given dynamic shared memory. Each probe kernel also exercises one of the
// primitives the body uses: a peer's shared memory through
// map_shared_rank (loads, 32- and 64-bit atomics), the split cluster
// barrier (barrier.cluster.arrive.release / wait.acquire), and
// cp.async.bulk from global into shared memory completing on an mbarrier.
// Plain C interface, loaded with ctypes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// out: [0] the grid's arrivals, [1] faults seen
__global__ void __launch_bounds__(kThreads, 1)
    probe_kernel(int* out, int rounds, int coop) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank(), n = cluster.num_blocks();
  int* mine = reinterpret_cast<int*>(smem);
  unsigned long long* wide = reinterpret_cast<unsigned long long*>(smem + 16);
  if (threadIdx.x == 0) {
    mine[1] = 0;
    *wide = 0;
  }
  cluster.sync();
  const unsigned peer_rank = (rank + 1) % n;
  int* peer = cluster.map_shared_rank(mine, peer_rank);
  unsigned long long* peer_wide = cluster.map_shared_rank(wide, peer_rank);
  const int peer_block = static_cast<int>(blockIdx.x - rank + peer_rank);
  for (int r = 0; r < rounds; ++r) {
    if (threadIdx.x == 0) {
      mine[0] = static_cast<int>(blockIdx.x) * 1000 + r;
      atomicAdd(out, 1);
    }
    // the split barrier: arrive (release), then wait (acquire)
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    if (peer[0] != peer_block * 1000 + r) atomicAdd(out + 1, 1);
    atomicAdd(&peer[1], 1);
    atomicAdd(peer_wide, 1ull << 33);
    cluster.sync();
    if (threadIdx.x == 0 &&
        (mine[1] != kThreads * (r + 1) ||
         *wide != (static_cast<unsigned long long>(kThreads) * (r + 1)) << 33))
      atomicAdd(out + 1, 1);
    if (coop && !cg::this_grid().is_valid()) {
      if (threadIdx.x == 0) atomicAdd(out + 1, 1000000);
    } else if (coop) {
      cg::this_grid().sync();
      if (threadIdx.x == 0 &&
          atomicAdd(out, 0) != static_cast<int>(gridDim.x) * (r + 1))
        atomicAdd(out + 1, 1);
      cg::this_grid().sync();
    }
  }
  cluster.sync();  // no block leaves while a peer may read its memory
}

// src [gridDim.x * n] int64; each block copies its slice into shared
// memory with one cp.async.bulk on an mbarrier, then checks it
__global__ void __launch_bounds__(kThreads, 1)
    bulk_kernel(const long long* src, int n, int* bad) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bar;
  long long* dst = reinterpret_cast<long long*>(smem);
  const uint32_t b = smem_addr(&bar);
  const uint32_t bytes = static_cast<uint32_t>(n) * 8;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.proxy.async;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
        "r"(bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
        "l"(src + static_cast<size_t>(blockIdx.x) * n), "r"(bytes), "r"(b)
        : "memory");
  }
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(0)
        : "memory");
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (dst[i] != static_cast<long long>(blockIdx.x) * n + i) atomicAdd(bad, 1);
}

}  // namespace

extern "C" {

// The most clusters of `C` blocks of kThreads threads and `smem` bytes of
// dynamic shared memory the card holds at once (cooperative or not), or
// -1 on an error; *rc the error code.
int probe_max_clusters(int C, size_t smem, int coop, int* rc) {
  const void* kern = reinterpret_cast<const void*>(probe_kernel);
  *rc = static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (*rc) return -1;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeCooperative;
  at[1].val.cooperative = 1;
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = at;
  cfg.numAttrs = coop ? 2 : 1;
  int n = -1;
  *rc = static_cast<int>(cudaOccupancyMaxActiveClusters(&n, kern, &cfg));
  return *rc ? -1 : n;
}

// One launch of probe_kernel: `clusters` clusters of C blocks, `rounds`
// rounds, the cooperative attribute where `coop`, grid barriers where
// `grid_sync`; out [2] int32 on the card, zeroed. Returns the launch's
// error code, else the synchronize's.
int probe_launch(int C, int clusters, size_t smem, int coop, int grid_sync,
                 int rounds, int* out) {
  const void* kern = reinterpret_cast<const void*>(probe_kernel);
  int rc = static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (rc) return rc;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeCooperative;
  at[1].val.cooperative = 1;
  cfg.gridDim = dim3(C * clusters);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = at;
  cfg.numAttrs = coop ? 2 : 1;
  rc = static_cast<int>(cudaLaunchKernelEx(&cfg, probe_kernel, out, rounds,
                                           grid_sync));
  if (rc) return rc;
  return static_cast<int>(cudaDeviceSynchronize());
}

// One launch of bulk_kernel on `blocks` blocks, n int64 a block.
int bulk_launch(const long long* src, int blocks, int n, int* bad) {
  const void* kern = reinterpret_cast<const void*>(bulk_kernel);
  const size_t smem = static_cast<size_t>(n) * 8;
  int rc = static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (rc) return rc;
  bulk_kernel<<<blocks, kThreads, smem>>>(src, n, bad);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  return static_cast<int>(cudaDeviceSynchronize());
}

}  // extern "C"
