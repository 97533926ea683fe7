// Empty-step kernels for scripts/torch_chain_probe.py: the latency floor of
// one step of the DIA chain on a Hopper card, without the chain's work.
//   cluster_sync_kernel   k x cluster.sync() (barrier.cluster arrive + wait)
//   cluster_split_kernel  the split form: arrive, then wait, k times
//   cluster_dsmem_kernel  k x (one read of the next CTA's shared memory, then
//                         cluster.sync()): the halo read the chain adds
//   cluster_nbr_kernel    k x a barrier with the next CTAs only: each CTA
//                         arrives on its neighbours' mbarriers through
//                         distributed shared memory and waits on its own
//   grid_sync_kernel      k x grid.sync() in a cooperative launch
//   cluster_smid_kernel   the SM each CTA of a cluster runs on
// Each takes k and does nothing else, so (time at k - time at 0) / k is the
// cost of one step's barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

__global__ void cluster_sync_kernel(int k) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int s = 0; s < k; ++s) cluster.sync();
}

__global__ void cluster_split_kernel(int k) {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  for (int s = 0; s < k; ++s) {
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  }
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__global__ void cluster_dsmem_kernel(float* out, int k) {
  __shared__ float buf[1024];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned next = (cluster.block_rank() + 1) % cluster.num_blocks();
  buf[threadIdx.x] = static_cast<float>(threadIdx.x);
  cluster.sync();
  const float* remote = cluster.map_shared_rank(buf + threadIdx.x, next);
  float acc = 0.0f;
  for (int s = 0; s < k; ++s) {
    acc += *remote;
    cluster.sync();
  }
  if (acc == -1.0f) out[0] = acc;  // never true: keeps the reads
}

// Two mbarriers, used in alternate steps: a neighbour that has passed step
// s may arrive for step s+1 before this CTA's step-s phase has completed
// (its other neighbour may still be late), and must not count toward it.
// It cannot arrive for step s+2 before this CTA has arrived for s+1.
__global__ void cluster_nbr_kernel(int k) {
  __shared__ uint64_t bar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ctas = static_cast<int>(cluster.num_blocks());
  const int n_nbr = (rank > 0) + (rank + 1 < n_ctas);
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(base + 8 * b),
                   "r"(n_nbr) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();
  for (int s = 0; s < k && n_nbr > 0; ++s) {
    const uint32_t addr = base + 8 * (s & 1);
    const uint32_t parity = (s >> 1) & 1;
    __syncthreads();  // the CTA's step done
    if (threadIdx.x < 2) {
      const int t = threadIdx.x == 0 ? rank - 1 : rank + 1;
      if (t >= 0 && t < n_ctas) {
        uint32_t remote;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                     : "=r"(remote) : "r"(addr), "r"(t));
        asm volatile("fence.acq_rel.cluster;\n\t"
                     "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
                     ::"r"(remote) : "memory");
      }
    }
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    }
  }
  cluster.sync();  // no CTA exits while a neighbour may still arrive on it
}

// Where a cluster's CTAs land: CTA b writes its SM's id to smid[b].  Its
// dynamic shared memory is only a footprint, as the chain's would be.
__global__ void cluster_smid_kernel(int* smid) {
  extern __shared__ unsigned char footprint[];
  unsigned id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  if (threadIdx.x == 0) {
    footprint[0] = 0;
    smid[blockIdx.x] = static_cast<int>(id);
  }
}

__global__ void grid_sync_kernel(int k) {
  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < k; ++s) grid.sync();
}

template <typename... Args>
static int launch_cluster(void (*kern)(Args...), int cluster, int threads,
                          int smem, void* stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

// kind: 0 cluster.sync(), 1 split arrive/wait, 2 a DSMEM read + sync,
// 3 the neighbour barrier.
int probe_cluster(int kind, int cluster, int threads, int k, void* out,
                  void* stream) {
  if (kind == 0) return launch_cluster(cluster_sync_kernel, cluster, threads, 0, stream, k);
  if (kind == 1) return launch_cluster(cluster_split_kernel, cluster, threads, 0, stream, k);
  if (kind == 3) return launch_cluster(cluster_nbr_kernel, cluster, threads, 0, stream, k);
  return launch_cluster(cluster_dsmem_kernel, cluster, threads, 0, stream,
                        static_cast<float*>(out), k);
}

// The SM of each CTA of one cluster of `threads`-thread CTAs with `smem`
// bytes of dynamic shared memory each.
int probe_smid(int cluster, int threads, int smem, void* smid, void* stream) {
  return launch_cluster(cluster_smid_kernel, cluster, threads, smem, stream,
                        static_cast<int*>(smid));
}

int probe_grid(int blocks, int threads, int k, void* stream) {
  void* args[] = {&k};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&grid_sync_kernel), dim3(blocks),
      dim3(threads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* probe_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
