// CG's step algebra for Hopper (sm_90a), bound to Python with ctypes
// through the plain C functions at the end of this file.
//
// Replaces no TPU kernel: the JAX package's CG body is XLA-fused vector
// algebra inside one lax.while_loop.  The port's loop (solvers.py _while)
// runs the body in blocks of steps on the device, and each step used to be
// ~30 PyTorch passes: the updates x + alpha*p, r - alpha*Ap and r + beta*p
// as a multiply and an add each, two sums of a product, and a
// torch.where(active, new, old) commit of x, r and p.  These two kernels do
// the same step for unpreconditioned CG (z = r, so one dot serves r.z and
// r.r), after its fused SpMV-dot (dia.cu) has made Ap and p.Ap:
//   * cg_update_kernel<T, V>: active = k < maxiter && rr >= thresh2, read
//     from device memory as the loop's cond computes it; alpha = rr / pAp
//     (0 where pAp = 0); where active, x += alpha p and r -= alpha Ap in
//     place, and r.r of the new r.  The last CTA to finish sums the CTAs'
//     partials and commits: beta = rr_new / rr (0 where rr = 0) and the flag
//     into the step's scratch, rr = rr_new and k += 1.
//   * cg_direction_kernel<T, V>: where the flag holds, p = r + beta p.
// A step whose active is false reads no vector and writes only the flag, so
// the state stays as the loop's selects would leave it.
//
// What bounds them on an H100: device-memory bytes.  At n rows of T the
// update reads x, r, p, Ap and writes x, r (6 n sizeof(T)); the direction
// reads r, p and writes p (3 n sizeof(T)): 100.7 MB and 50.3 MB at the
// 2048^2 Poisson operator in f32, 30.0 and 15.0 us at 3.35 TB/s, for 2
// flops a byte at most.  So:
//   * A grid of the SMs times the CTAs an SM holds (at most the vectors
//     over 256) walks the rows as 16-byte vectors (V = 16 / sizeof(T): 4
//     f32, 2 f64), grid-stride; V = 1 where a pointer is not 16-byte
//     aligned.  The rows past the last whole vector take a scalar loop.
//   * Each value is read once and written once.  x and Ap are read, and x
//     written, with evict-first hints (ld/st.global.cs): nothing of this
//     step reads them again, so they leave L2 to r and p, which the
//     direction kernel reads next.
//   * The dot: each thread sums r_new^2 over its rows in order with fused
//     multiply-adds, the warp by __shfl_xor_sync, the CTA in shared memory
//     in warp order, and each CTA writes one partial.  The last CTA (a
//     __threadfence() and an atomicAdd ticket on a counter, which it puts
//     back to 0) sums the partials in index order.  No atomics on values:
//     every order is fixed by the grid, so reruns are bitwise equal, and
//     nothing waits on the host, so both launches can be captured in a CUDA
//     graph.
//   * Every CTA reads the scalars before it takes its ticket, and the last
//     CTA commits them only after every ticket, so no CTA reads a committed
//     rr or k within the launch.
//
// The caller gives each solve its own partials, counter and flag
// (kernels/krylov.py step_scratch, kept among the solver loop's invariants):
// a CUDA graph of the loop's block holds them as static buffers, and since
// every update leaves the counter at 0, its replays need no fill.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;

// c + a * b with one rounding.
__device__ __forceinline__ float fmadd(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return __fma_rn(a, b, c); }

// V values of consecutive rows: 16 bytes when V > 1.
template <typename T, int V>
struct Vals {
  T v[V];
};

// How a vector is read or written: the default path, or evict-first
// (ld/st.global.cs) for a value this step reads no more.
enum Hint { KEEP, STREAM };

template <typename T, int V, Hint H>
__device__ __forceinline__ Vals<T, V> load(const T* p) {
  Vals<T, V> out;
  if constexpr (V * sizeof(T) == 16) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    const uint4 u = H == STREAM ? __ldcs(q) : *q;
    memcpy(&out, &u, 16);
  } else {
    static_assert(V == 1, "a vector of values is 16 bytes");
    out.v[0] = H == STREAM ? __ldcs(p) : *p;
  }
  return out;
}

template <typename T, int V, Hint H>
__device__ __forceinline__ void store(T* p, const Vals<T, V>& v) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 u;
    memcpy(&u, &v, 16);
    if constexpr (H == STREAM) {
      __stcs(reinterpret_cast<uint4*>(p), u);
    } else {
      *reinterpret_cast<uint4*>(p) = u;
    }
  } else {
    if constexpr (H == STREAM) {
      __stcs(p, v.v[0]);
    } else {
      *p = v.v[0];
    }
  }
}

// The sum of v over the CTA, the same in every thread: warps by
// __shfl_xor_sync, then the warps' sums in warp order.  Ends with a barrier,
// so `s` may be reused at once.
template <typename T>
__device__ __forceinline__ T cta_sum(T v, T* s) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL_MASK, v, m);
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  __syncthreads();
  T total = T(0);
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) total += s[w];
  __syncthreads();
  return total;
}

// x, r at rows [i, i + V): x += alpha p, r -= alpha Ap; adds the new r's
// squares to dot.
template <typename T, int V>
__device__ __forceinline__ void update_rows(T* x, T* r, const T* p, const T* ap, int64_t i,
                                            T alpha, T& dot) {
  Vals<T, V> xv = load<T, V, STREAM>(x + i);
  Vals<T, V> rv = load<T, V, KEEP>(r + i);
  const Vals<T, V> pv = load<T, V, KEEP>(p + i);
  const Vals<T, V> av = load<T, V, STREAM>(ap + i);
#pragma unroll
  for (int u = 0; u < V; ++u) {
    xv.v[u] = fmadd(alpha, pv.v[u], xv.v[u]);
    rv.v[u] = fmadd(-alpha, av.v[u], rv.v[u]);
    dot = fmadd(rv.v[u], rv.v[u], dot);
  }
  store<T, V, STREAM>(x + i, xv);
  store<T, V, KEEP>(r + i, rv);
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
cg_update_kernel(T* __restrict__ x, T* __restrict__ r, const T* __restrict__ p,
                 const T* __restrict__ ap, int64_t n, const T* __restrict__ pap, T* rr, int* k,
                 const int* __restrict__ maxiter, const T* __restrict__ thresh2,
                 T* __restrict__ partials, unsigned* __restrict__ counter, T* __restrict__ beta,
                 int* __restrict__ flag) {
  const T rr0 = *rr;
  const int k0 = *k;
  if (!(k0 < *maxiter && rr0 >= *thresh2)) {
    if (blockIdx.x == 0 && threadIdx.x == 0) *flag = 0;
    return;
  }
  const T pap0 = *pap;
  const T alpha = pap0 != T(0) ? rr0 / pap0 : T(0);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t whole = n / V * V;
  T dot = T(0);
  for (int64_t i = first * V; i < whole; i += stride * V)
    update_rows<T, V>(x, r, p, ap, i, alpha, dot);
  for (int64_t i = whole + first; i < n; i += stride)
    update_rows<T, 1>(x, r, p, ap, i, alpha, dot);

  __shared__ T s_warp[THREADS / 32];
  __shared__ bool s_last;
  const T mine = cta_sum(dot, s_warp);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = mine;
    __threadfence();  // the partial is seen before the ticket
    s_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) {
    __threadfence();
    T part = T(0);
    for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += THREADS)
      part += __ldcg(partials + b);
    const T total = cta_sum(part, s_warp);
    if (threadIdx.x == 0) {
      *beta = rr0 != T(0) ? total / rr0 : T(0);
      *flag = 1;
      *rr = total;
      *k = k0 + 1;
      *counter = 0u;  // ready for the next launch on this stream
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
cg_direction_kernel(const T* __restrict__ r, T* __restrict__ p, int64_t n,
                    const T* __restrict__ beta, const int* __restrict__ flag) {
  if (*flag == 0) return;
  const T b = *beta;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t whole = n / V * V;
  for (int64_t i = first * V; i < whole; i += stride * V) {
    const Vals<T, V> rv = load<T, V, STREAM>(r + i);
    Vals<T, V> pv = load<T, V, KEEP>(p + i);
#pragma unroll
    for (int u = 0; u < V; ++u) pv.v[u] = fmadd(b, pv.v[u], rv.v[u]);
    store<T, V, KEEP>(p + i, pv);
  }
  for (int64_t i = whole + first; i < n; i += stride) p[i] = fmadd(b, p[i], r[i]);
}

template <typename T>
cudaError_t occupancy(int vec, int* update, int* direction) {
  constexpr int VV = 16 / sizeof(T);
  cudaError_t e;
  if (vec == VV) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(update, cg_update_kernel<T, VV>, THREADS, 0);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(direction, cg_direction_kernel<T, VV>,
                                                        THREADS, 0);
  } else if (vec == 1) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(update, cg_update_kernel<T, 1>, THREADS, 0);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(direction, cg_direction_kernel<T, 1>,
                                                        THREADS, 0);
  } else {
    e = cudaErrorInvalidValue;
  }
  return e;
}

template <typename T, int V>
cudaError_t launch_update_at(int grid, cudaStream_t st, void* x, void* r, const void* p,
                             const void* ap, int64_t n, const void* pap, void* rr, void* k,
                             const void* maxiter, const void* thresh2, void* partials,
                             void* counter, void* beta, void* flag) {
  cg_update_kernel<T, V><<<grid, THREADS, 0, st>>>(
      static_cast<T*>(x), static_cast<T*>(r), static_cast<const T*>(p),
      static_cast<const T*>(ap), n, static_cast<const T*>(pap), static_cast<T*>(rr),
      static_cast<int*>(k), static_cast<const int*>(maxiter), static_cast<const T*>(thresh2),
      static_cast<T*>(partials), static_cast<unsigned*>(counter), static_cast<T*>(beta),
      static_cast<int*>(flag));
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_direction_at(int grid, cudaStream_t st, const void* r, void* p, int64_t n,
                                const void* beta, const void* flag) {
  cg_direction_kernel<T, V><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(r), static_cast<T*>(p), n, static_cast<const T*>(beta),
      static_cast<const int*>(flag));
  return cudaGetLastError();
}

// A failed runtime call leaves its error as the thread's last error, which
// the next launch check would report: return it and clear it.
int fail(cudaError_t e) {
  if (e == cudaSuccess) return 0;
  cudaGetLastError();
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

int smt_krylov_threads() { return THREADS; }

const char* smt_krylov_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// smt_cg_occupancy: the CTAs an SM holds of each kernel at vec values a
// thread-step (16 / sizeof(T), or 1).  smt_cg_update: x, r, p, ap of n
// values of the suffix's type, 16-byte aligned at vec > 1; pap, rr, thresh2
// 0-d of that type, k and maxiter 0-d int32; partials: grid values, counter
// an unsigned 0, beta and flag the step's scratch (a value and an int).
// smt_cg_direction reads the same beta and flag.
#define SMT_KRYLOV(SUFFIX, T)                                                                   \
  int smt_cg_occupancy_##SUFFIX(int vec, int* update, int* direction) {                         \
    return fail(occupancy<T>(vec, update, direction));                                          \
  }                                                                                             \
  int smt_cg_update_##SUFFIX(void* x, void* r, const void* p, const void* ap, int64_t n,        \
                             const void* pap, void* rr, void* k, const void* maxiter,            \
                             const void* thresh2, void* partials, void* counter, void* beta,     \
                             void* flag, int grid, int vec, void* stream) {                      \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                                        \
    if (vec == 1)                                                                               \
      return fail(launch_update_at<T, 1>(grid, st, x, r, p, ap, n, pap, rr, k, maxiter, thresh2, \
                                         partials, counter, beta, flag));                       \
    if (vec != 16 / static_cast<int>(sizeof(T))) return fail(cudaErrorInvalidValue);            \
    return fail(launch_update_at<T, 16 / sizeof(T)>(grid, st, x, r, p, ap, n, pap, rr, k,       \
                                                    maxiter, thresh2, partials, counter, beta,  \
                                                    flag));                                     \
  }                                                                                             \
  int smt_cg_direction_##SUFFIX(const void* r, void* p, int64_t n, const void* beta,            \
                                const void* flag, int grid, int vec, void* stream) {             \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                                        \
    if (vec == 1) return fail(launch_direction_at<T, 1>(grid, st, r, p, n, beta, flag));        \
    if (vec != 16 / static_cast<int>(sizeof(T))) return fail(cudaErrorInvalidValue);            \
    return fail(launch_direction_at<T, 16 / sizeof(T)>(grid, st, r, p, n, beta, flag));         \
  }

SMT_KRYLOV(f32, float)
SMT_KRYLOV(f64, double)

}  // extern "C"
