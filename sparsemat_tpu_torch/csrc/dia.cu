// DIA SpMV kernels for Hopper (sm_90a), bound to Python with ctypes through
// the plain C functions at the end of this file.
//
// Replaces the three Pallas kernels of sparsemat_tpu/kernels/dia.py:
//   * dia_spmv_kernel<T, false>  <- _dia_spmv_pallas_impl (1-D row chunks)
//                                   and _dia_spmv_pallas_2d_impl (lane-packed
//                                   tdata).  Both compute the same y; the TPU
//                                   needed two layouts for its (8,128) tiling,
//                                   the GPU streams the row-major (n_d, n)
//                                   data with coalesced reads.
//   * dia_spmv_kernel<T, true>   <- _dia_spmv_pallas_2d_impl(with_dot=True):
//                                   y and per-block partials of x.(Ax).
//   * dia_chain_cluster_kernel<T>
//                                <- _dia_spmv_chain_impl: x <- A^k x in one
//                                   launch of one thread-block cluster, for
//                                   a band that fits the cluster's shared
//                                   memory (the resident chain).
//   * dia_chain_kernel<T>        <- the same, for a band too large for a
//                                   cluster: a cooperative grid.
//
// y[i] = sum_d data[d*n + i] * x[i + off_d], summed in diagonal order, with an
// explicit bounds test 0 <= i + off_d < n_cols in place of the TPU kernel's
// zeroed halo.  Offsets arrive as a small int64 device array; n_d is not
// fixed (DIA.from_csr makes one diagonal per distinct offset).  Row indices
// and d*n are int64: at 2^24 rows n_d*n already exceeds 8e7 and grows with
// n_d.
//
// What bounds it on an H100: device-memory bytes.  One SpMV moves
// (n_d + 2) * n * sizeof(T) bytes (every diagonal, x and y once) for
// 2 * n_d * n flops, far below the card's flops-per-byte balance.  The
// design streams each diagonal with consecutive threads on consecutive rows
// (fully coalesced), and the n_d shifted reads of x hit the same cache
// lines, which L1/L2 serve after the first diagonal brings them in, so x
// crosses device memory about once.  No shared-memory staging, TMA or
// vector loads yet: a simple kernel that is right comes first.
//
// The fused dot (with_dot) reduces acc * x[i] over each block in shared
// memory in a fixed tree order and writes one partial per block; the caller
// sums the partials with torch.sum.  No atomics: reruns are bitwise equal,
// as the reference requires.
//
// Storage and accumulation types: the SpMV kernels are templated on the
// storage type S of data and x and the accumulation type A of y and the dot
// partials.  f32 and f64 accumulate in themselves; bf16 and f16 storage is
// widened to f32 on load and accumulated in f32, so y is f32, as the JAX
// package's dia_spmv computes it (accum_dtype).  Mixed operands are promoted
// by the Python wrapper before the launch; the chain runs in the
// accumulation type (f32/f64) throughout.
//
// The chain: a cooperative launch (cudaLaunchCooperativeKernel) sized to the
// blocks that can be co-resident, a grid-stride row loop that writes
// ping-pong buffers in global memory, and cooperative_groups grid.sync()
// between steps.  For the latency-regime operands the chain is meant for
// (the benchmark's 10^4-row band) matrix and both buffers sit in the 50 MB
// L2, so each step is bounded by L2 bandwidth plus one grid barrier
// (a few microseconds); past L2 each step streams device memory like
// dia_spmv but saves k-1 launches.  Reads of the ping-pong buffers use
// ld.global.cg (L2, coherent across SMs): the L1 and the read-only path are
// not coherent with writes that other blocks made in the same launch.
// cudaLaunchCooperativeKernel refuses a grid that cannot be co-resident, so
// an oversized grid fails the launch instead of deadlocking at the barrier.
// Every sm_90a device has cooperative launch; where smt_dia_chain_max_blocks
// reports none, the Python wrapper raises rather than running another path.
//
// The cluster chain: what bounds a short chain is the step's latency, not
// bytes or flops (the 10^4-row, 5-diagonal band is 5*10^4 FMAs a step), and
// the grid chain pays a device-wide barrier through global memory and an L2
// round trip for every x read each step.  Here one cluster of C CTAs
// (C in {1, 2, 4, 8, 16}; 16 needs the non-portable attribute) runs the
// whole chain: CTA c owns rows [c*rows, (c+1)*rows) and keeps, in dynamic
// shared memory, its slice of every diagonal (loaded once) and two
// buffers of x over its rows and their halo, [c*rows - lo, (c+1)*rows + hi)
// for offsets in [-lo, hi], zero where a row lies outside the matrix (the
// TPU kernel's zeroed halo, and the plain version's zero-padded x).  So a
// row reads every x from its own shared memory with no bounds test:
// y[r] = sum_d data[d, r] * xbuf[r + lo + off_d], in diagonal order.  A
// row that another CTA's halo holds is pushed there, into that CTA's next
// buffer, by a store through distributed shared memory (st.shared::cluster
// at a mapa address); the target CTAs are computed, since a halo may span
// several slices.  One cluster.sync() a step makes the step's writes and
// pushes visible, and a buffer is rewritten only after the barrier that
// ends every read of it.  The last step writes `out` and pushes nothing.
//
// What sets a step's time here is latency (PERF.md, measured by
// scripts/torch_chain_probe.py): the barrier grows with the CTA's warps,
// so the plan gives a CTA few threads (rows / 4, at least 256), each
// summing 4 rows with their loads in flight together; and the step's own
// path must be short and branch-free, since at a few warps an SM each
// instruction waits on the last.  That is why x is pushed rather than
// pulled: a pull needs a bounds test, a slice test and a division per
// term.  A split barrier (interior rows between arrive and wait, three
// buffers) measured slower at every cluster size and is not kept.
// cluster.sync() compiles to MEMBAR.ALL.GPU, the cluster barrier and
// CCTL.IVALL; the membar is about a third of a step.
//
// The Python wrapper sizes the plan (rows, threads, shared bytes) and
// launches this kernel only where the band fits; a refused launch is an
// error, never another path.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

constexpr int THREADS = 256;

// Read-only load of one stored value, widened to the accumulation type.
template <typename A>
__device__ __forceinline__ A ld(const float* p) { return static_cast<A>(__ldg(p)); }
template <typename A>
__device__ __forceinline__ A ld(const double* p) { return static_cast<A>(__ldg(p)); }
template <typename A>
__device__ __forceinline__ A ld(const __nv_bfloat16* p) {
  return static_cast<A>(__bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p)))));
}
template <typename A>
__device__ __forceinline__ A ld(const __half* p) {
  return static_cast<A>(__half2float(
      __ushort_as_half(__ldg(reinterpret_cast<const unsigned short*>(p)))));
}

// x load: the chain reads buffers that other blocks write in the same launch,
// so it bypasses L1 (ld.global.cg); the chain runs in f32/f64 only.
template <typename S, typename A, bool COHERENT>
__device__ __forceinline__ A load_x(const S* p) {
  if constexpr (COHERENT) {
    return __ldcg(p);
  } else {
    return ld<A>(p);
  }
}

template <typename S, typename A, bool COHERENT>
__device__ __forceinline__ A dia_row(const S* __restrict__ data,
                                     const int64_t* __restrict__ offs, int n_d,
                                     int64_t n_rows, int64_t n_cols,
                                     const S* x, int64_t i) {
  A acc = A(0);
  for (int d = 0; d < n_d; ++d) {
    const int64_t j = i + __ldg(offs + d);
    if (j >= 0 && j < n_cols) {
      acc += ld<A>(data + static_cast<int64_t>(d) * n_rows + i) *
             load_x<S, A, COHERENT>(x + j);
    }
  }
  return acc;
}

template <typename S, typename A, bool WITH_DOT>
__global__ void __launch_bounds__(THREADS)
dia_spmv_kernel(const S* __restrict__ data, const int64_t* __restrict__ offs,
                int n_d, int64_t n_rows, int64_t n_cols,
                const S* __restrict__ x, A* __restrict__ y,
                A* __restrict__ partials) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  A dot = A(0);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
       i < n_rows; i += stride) {
    const A acc = dia_row<S, A, false>(data, offs, n_d, n_rows, n_cols, x, i);
    y[i] = acc;
    if constexpr (WITH_DOT) dot += acc * ld<A>(x + i);
  }
  if constexpr (WITH_DOT) {
    __shared__ A s[THREADS];
    s[threadIdx.x] = dot;
    __syncthreads();
    for (int h = THREADS / 2; h > 0; h >>= 1) {
      if (threadIdx.x < h) s[threadIdx.x] += s[threadIdx.x + h];
      __syncthreads();
    }
    if (threadIdx.x == 0) partials[blockIdx.x] = s[0];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dia_chain_kernel(const T* __restrict__ data, const int64_t* __restrict__ offs,
                 int n_d, int64_t n, const T* x, T* out, T* tmp, int k) {
  cg::grid_group grid = cg::this_grid();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  const T* src = x;
  for (int s = 0; s < k; ++s) {
    // the last step writes `out`, so the result never needs a copy
    T* dst = ((k - 1 - s) & 1) ? tmp : out;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
         i < n; i += stride) {
      dst[i] = dia_row<T, T, true>(data, offs, n_d, n, n, src, i);
    }
    grid.sync();
    src = dst;
  }
}

// The cluster chain's CTA size: at most 1024 threads.  A thread takes the
// rows q, q + blockDim.x, ..., CLUSTER_UNROLL at a time, so that their
// shared-memory loads are in flight together.
constexpr int CLUSTER_THREADS = 1024;
constexpr int CLUSTER_UNROLL = 4;

// Shared-memory addresses: 32-bit, of the own CTA (shared::cta) or of any
// CTA of the cluster (shared::cluster, from mapa).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t addr, double v) {
  asm volatile("st.shared::cluster.f64 [%0], %1;" ::"r"(addr), "d"(v) : "memory");
}

// One step's barrier: every CTA's writes and pushes of the step seen, every
// read of the step done.
__device__ __forceinline__ void step_barrier(cg::cluster_group& cluster) {
  cluster.sync();
}

// One CTA's view of the cluster chain.  Its x buffers cover the rows
// [r0 - lo, r0 + rows + hi): its own rows at lo .. lo + rows, the halo
// around them, zero where a row lies outside the matrix.
template <typename T>
struct ClusterCta {
  const T* s_data;     // n_d diagonal slices of `rows` values
  const int* s_shift;  // lo + offset of each diagonal: x's slot for row 0
  T* s_x;              // the two buffers, ext values each
  int n_d, rows, lo, hi, ext, r0, cnt, rank;
  int n_live;          // CTAs that own rows
  bool wide;           // a halo wider than a slice (the same in every thread)
  uint32_t below, above;  // buffer 0 of CTAs rank -+ 1 (shared::cluster)
};

// Row r's new value goes to the CTAs whose halo holds row r0 + r: those t
// with t*rows - lo <= r0 + r < (t+1)*rows + hi (the own CTA aside), at
// slot r0 + r - t*rows + lo of their next buffer `b`.  Only rows within hi
// of the slice's start (for CTAs below) or lo of its end (above) have such
// a CTA; a halo no wider than a slice reaches only the next CTA, whose
// buffer address is mapped once, and only a wider one needs the divisions.
template <typename T>
__device__ __forceinline__ void push(const ClusterCta<T>& c, int b, int r, T v) {
  const int i = c.r0 + r;
  const uint32_t buf = static_cast<uint32_t>(b * c.ext * sizeof(T));
  if (r < c.hi && c.rank > 0) {
    if (!c.wide) {
      st_cluster(c.below + buf + static_cast<uint32_t>((r + c.rows + c.lo) * sizeof(T)), v);
    } else {
      const int first = i - c.hi < 0 ? 0 : (i - c.hi) / c.rows;
#pragma unroll 1
      for (int t = first; t < c.rank; ++t)
        st_cluster(map_rank(smem_addr(c.s_x + b * c.ext + (i - t * c.rows + c.lo)), t), v);
    }
  }
  if (r >= c.rows - c.lo && c.rank + 1 < c.n_live) {
    if (!c.wide) {
      st_cluster(c.above + buf + static_cast<uint32_t>((r - c.rows + c.lo) * sizeof(T)), v);
    } else {
      const int last = min(c.n_live - 1, (i + c.lo) / c.rows);
#pragma unroll 1
      for (int t = c.rank + 1; t <= last; ++t)
        st_cluster(map_rank(smem_addr(c.s_x + b * c.ext + (i - t * c.rows + c.lo)), t), v);
    }
  }
}

// Step s over the slice: y[r] = sum over d of data[d, r] * x[r + off_d] in
// diagonal order, every x read from the own buffer s & 1.  The last step
// writes `out`; the others the next buffer and the halos of the CTAs that
// need the row.  A thread sums CLUSTER_UNROLL rows at a time, loading a
// diagonal's values and x for all of them before the multiply-adds, so the
// loads are in flight together.
template <typename T, bool LAST>
__device__ __forceinline__ void cluster_step(const ClusterCta<T>& c, int s, T* out) {
  constexpr int U = CLUSTER_UNROLL;
  const int nt = blockDim.x;
  const T* src = c.s_x + (s & 1) * c.ext;
  T* dst = c.s_x + ((s + 1) & 1) * c.ext;
#pragma unroll 1
  for (int q0 = threadIdx.x; q0 < c.cnt; q0 += U * nt) {
    // a row past the slice sums slot 0 (always there) and stores nothing,
    // so the sums have no branch
    int r[U];
    T acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + u * nt;
      r[u] = q < c.cnt ? q : 0;
      acc[u] = T(0);
    }
    for (int d = 0; d < c.n_d; ++d) {
      const T* xd = src + c.s_shift[d];
      const T* dd = c.s_data + d * c.rows;
      T dv[U], xv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) dv[u] = dd[r[u]];
#pragma unroll
      for (int u = 0; u < U; ++u) xv[u] = xd[r[u]];
#pragma unroll
      for (int u = 0; u < U; ++u) acc[u] += dv[u] * xv[u];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (q0 + u * nt >= c.cnt) break;
      if constexpr (LAST) {
        out[c.r0 + r[u]] = acc[u];
      } else {
        dst[c.lo + r[u]] = acc[u];
        push(c, (s + 1) & 1, r[u], acc[u]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(CLUSTER_THREADS)
dia_chain_cluster_kernel(const T* __restrict__ data,
                         const int64_t* __restrict__ offs, int n_d, int n,
                         int rows, int lo, int hi, const T* __restrict__ x,
                         T* __restrict__ out, int k) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  // layout: n_d diagonal slices, two x buffers of ext values, n_d shifts;
  // the same in every CTA, so one slot maps to every rank
  const int ext = rows + lo + hi;
  T* s_data = reinterpret_cast<T*>(smem);
  T* s_x = s_data + static_cast<size_t>(n_d) * rows;
  int* s_shift = reinterpret_cast<int*>(s_x + 2 * static_cast<size_t>(ext));
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const int r0 = rank * rows;
  const int cnt = max(0, min(rows, n - r0));
  const int n_live = (n - 1) / rows + 1;
  // an offset beyond +-n reaches no row, as one of +-n does (lo, hi <= n)
  for (int d = tid; d < n_d; d += nt) {
    const int64_t o = offs[d];
    s_shift[d] = lo + (o < -n ? -n : (o > n ? n : static_cast<int>(o)));
  }
  for (int d = 0; d < n_d; ++d)
    for (int r = tid; r < cnt; r += nt)
      s_data[d * rows + r] = data[static_cast<int64_t>(d) * n + r0 + r];
  // buffer 0 holds x over the slice and its halo; buffer 1 starts at zero,
  // and a slot outside the matrix stays zero in both
  for (int q = tid; q < 2 * ext; q += nt) {
    const int j = r0 - lo + q;
    s_x[q] = q < ext && j >= 0 && j < n ? x[j] : T(0);
  }
  const uint32_t base = smem_addr(s_x);
  const ClusterCta<T> c{s_data, s_shift, s_x, n_d, rows, lo, hi, ext, r0, cnt, rank,
                        n_live, lo > rows || hi > rows,
                        rank > 0 ? map_rank(base, rank - 1) : 0u,
                        rank + 1 < n_live ? map_rank(base, rank + 1) : 0u};
  cluster.sync();  // every buffer set (and every CTA running)
  for (int s = 0; s + 1 < k; ++s) {
    cluster_step<T, false>(c, s, out);
    step_barrier(cluster);
  }
  cluster_step<T, true>(c, k - 1, out);
  // The last step reads only the own buffers and pushes nothing, and every
  // push into this CTA came before a barrier that it has passed, so a CTA
  // may exit while the others finish.
}

template <typename S, typename A>
static int launch_spmv(const void* data, const void* offs, int n_d,
                       int64_t n_rows, int64_t n_cols, const void* x, void* y,
                       void* partials, int blocks, void* stream) {
  const S* d = static_cast<const S*>(data);
  const int64_t* o = static_cast<const int64_t*>(offs);
  const S* xx = static_cast<const S*>(x);
  A* yy = static_cast<A*>(y);
  A* pp = static_cast<A*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pp != nullptr) {
    dia_spmv_kernel<S, A, true><<<blocks, THREADS, 0, st>>>(d, o, n_d, n_rows,
                                                            n_cols, xx, yy, pp);
  } else {
    dia_spmv_kernel<S, A, false><<<blocks, THREADS, 0, st>>>(d, o, n_d, n_rows,
                                                             n_cols, xx, yy, pp);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int chain_max_blocks(int* max_blocks) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dia_chain_kernel<T>, THREADS, 0);
  *max_blocks = coop ? per_sm * sms : 0;
  return static_cast<int>(e);
}

template <typename T>
static int launch_chain(const void* data, const void* offs, int n_d, int64_t n,
                        const void* x, void* out, void* tmp, int k, int blocks,
                        void* stream) {
  const T* d = static_cast<const T*>(data);
  const int64_t* o = static_cast<const int64_t*>(offs);
  const T* xx = static_cast<const T*>(x);
  T* oo = static_cast<T*>(out);
  T* tt = static_cast<T*>(tmp);
  void* args[] = {&d, &o, &n_d, &n, &xx, &oo, &tt, &k};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&dia_chain_kernel<T>), dim3(blocks),
      dim3(THREADS), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// A failed runtime call leaves its error as the thread's last error, which
// the next launch check would report: return it and clear it.
static int fail(cudaError_t e) {
  cudaGetLastError();
  return static_cast<int>(e);
}

template <typename T>
static cudaError_t allow_cluster(int smem) {
  auto kern = dia_chain_cluster_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  return e;
}

static cudaLaunchConfig_t cluster_config(int cluster, int threads, int smem,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The opt-in shared memory of one CTA and the largest cluster of
// CLUSTER_THREADS-thread CTAs, each using all of it, that the device can
// place (0 if none).
template <typename T>
static int cluster_limits(int* smem_optin, int* max_cluster) {
  int dev = 0;
  *smem_optin = 0;
  *max_cluster = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = allow_cluster<T>(*smem_optin);
  if (e != cudaSuccess) return fail(e);
  for (int c = 16; c >= 1; c /= 2) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg =
        cluster_config(c, CLUSTER_THREADS, *smem_optin, 0, &attr);
    int n_clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&n_clusters, dia_chain_cluster_kernel<T>,
                                       &cfg);
    if (e != cudaSuccess) {
      cudaGetLastError();  // a size the device refuses: try the next
      continue;
    }
    if (n_clusters > 0) {
      *max_cluster = c;
      break;
    }
  }
  return 0;
}

template <typename T>
static int launch_cluster(const void* data, const void* offs, int n_d, int n,
                          int rows, int lo, int hi, const void* x, void* out,
                          int k, int cluster, int threads, int smem,
                          void* stream) {
  cudaError_t e = allow_cluster<T>(smem);
  if (e != cudaSuccess) return fail(e);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(
      cluster, threads, smem, static_cast<cudaStream_t>(stream), &attr);
  e = cudaLaunchKernelEx(&cfg, dia_chain_cluster_kernel<T>,
                         static_cast<const T*>(data),
                         static_cast<const int64_t*>(offs), n_d, n, rows, lo,
                         hi, static_cast<const T*>(x), static_cast<T*>(out), k);
  if (e != cudaSuccess) return fail(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

int smt_dia_threads() { return THREADS; }

const char* smt_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// partials == NULL: plain SpMV; otherwise one x.(Ax) partial per block.
// data and x are of the suffix's storage type; y and the partials of its
// accumulation type (f32 for bf16 and f16).
#define SMT_DIA_SPMV(SUFFIX, S, A)                                            \
  int smt_dia_spmv_##SUFFIX(const void* data, const void* offs, int n_d,     \
                            int64_t n_rows, int64_t n_cols, const void* x,   \
                            void* y, void* partials, int blocks,             \
                            void* stream) {                                  \
    return launch_spmv<S, A>(data, offs, n_d, n_rows, n_cols, x, y,          \
                             partials, blocks, stream);                      \
  }

SMT_DIA_SPMV(f32, float, float)
SMT_DIA_SPMV(f64, double, double)
SMT_DIA_SPMV(bf16, __nv_bfloat16, float)
SMT_DIA_SPMV(f16, __half, float)

// Blocks of the chain kernel that can be co-resident on the current device
// (0 when the device has no cooperative launch).
int smt_dia_chain_max_blocks_f32(int* max_blocks) {
  return chain_max_blocks<float>(max_blocks);
}

int smt_dia_chain_max_blocks_f64(int* max_blocks) {
  return chain_max_blocks<double>(max_blocks);
}

int smt_dia_chain_f32(const void* data, const void* offs, int n_d, int64_t n,
                      const void* x, void* out, void* tmp, int k, int blocks,
                      void* stream) {
  return launch_chain<float>(data, offs, n_d, n, x, out, tmp, k, blocks,
                             stream);
}

int smt_dia_chain_f64(const void* data, const void* offs, int n_d, int64_t n,
                      const void* x, void* out, void* tmp, int k, int blocks,
                      void* stream) {
  return launch_chain<double>(data, offs, n_d, n, x, out, tmp, k, blocks,
                              stream);
}

int smt_dia_chain_cluster_threads() { return CLUSTER_THREADS; }

int smt_dia_chain_cluster_unroll() { return CLUSTER_UNROLL; }

#define SMT_DIA_CHAIN_CLUSTER(SUFFIX, T)                                      \
  int smt_dia_chain_cluster_limits_##SUFFIX(int* smem_optin,                 \
                                            int* max_cluster) {              \
    return cluster_limits<T>(smem_optin, max_cluster);                       \
  }                                                                          \
  int smt_dia_chain_cluster_##SUFFIX(                                        \
      const void* data, const void* offs, int n_d, int n, int rows, int lo,  \
      int hi, const void* x, void* out, int k, int cluster, int threads,     \
      int smem, void* stream) {                                              \
    return launch_cluster<T>(data, offs, n_d, n, rows, lo, hi, x, out, k,    \
                             cluster, threads, smem, stream);                \
  }

SMT_DIA_CHAIN_CLUSTER(f32, float)
SMT_DIA_CHAIN_CLUSTER(f64, double)

}  // extern "C"
