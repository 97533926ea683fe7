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
//   * dia_chain_kernel<T>        <- _dia_spmv_chain_impl: x <- A^k x in one
//                                   launch.
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

}  // extern "C"
