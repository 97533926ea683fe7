// Streams of device memory on a CUDA card: the rate the DIA SpMV's traffic
// can reach, for scripts/torch_stream_probe.py.  Bound with ctypes.
//
// streams_kernel<NS, U>: NS read streams of n f32 values each (stream s at
// src + s * n) and one written, y[i] = sum_s src[s * n + i]: NS = 1 is a
// plain copy, NS = n_d + 1 the bytes of one DIA SpMV (its diagonals and x
// read once, y written once) without the reuse of x.  A persistent grid
// (the SMs times the CTAs an SM holds) walks 16-byte vectors; each thread
// issues the loads of U vectors of every stream before the first add, so
// U sets the bytes in flight.  Reads are ld.global.cs (read once), as the
// DIA kernel reads its diagonals.

#include <cuda_runtime.h>

#include <cstdint>

constexpr int THREADS = 256;

template <int NS, int U>
__global__ void __launch_bounds__(THREADS)
streams_kernel(const float* __restrict__ src, int64_t n, float* __restrict__ dst) {
  const int64_t n4 = n / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS * U;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS * U + threadIdx.x; i < n4;
       i += stride) {
    float4 v[NS][U];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float4* p = reinterpret_cast<const float4*>(src + s * n);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t k = i + static_cast<int64_t>(u) * THREADS;
        if (k < n4) v[s][u] = __ldcs(p + k);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t k = i + static_cast<int64_t>(u) * THREADS;
      if (k >= n4) break;
      float4 a = v[0][u];
#pragma unroll
      for (int s = 1; s < NS; ++s) {
        a.x += v[s][u].x;
        a.y += v[s][u].y;
        a.z += v[s][u].z;
        a.w += v[s][u].w;
      }
      reinterpret_cast<float4*>(dst)[k] = a;
    }
  }
}

template <int NS, int U>
static int run(const float* src, int64_t n, float* dst, int grid, void* stream) {
  streams_kernel<NS, U><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(src, n, dst);
  return static_cast<int>(cudaGetLastError());
}

template <int NS, int U>
static int per_sm(int* out) {
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, streams_kernel<NS, U>, THREADS, 0));
}

extern "C" {

// ns read streams (1, 4, 6 or 8) of n f32 values (n a multiple of 4), U in
// {1, 2, 4}; grid CTAs of THREADS threads.  Returns a cudaError_t.
int probe_streams(int ns, int u, const void* src, int64_t n, void* dst, int grid, void* stream) {
  const float* s = static_cast<const float*>(src);
  float* d = static_cast<float*>(dst);
#define PROBE_CASE(NS, U) \
  if (ns == NS && u == U) return run<NS, U>(s, n, d, grid, stream);
#define PROBE_NS(NS) PROBE_CASE(NS, 1) PROBE_CASE(NS, 2) PROBE_CASE(NS, 4)
  PROBE_NS(1) PROBE_NS(4) PROBE_NS(6) PROBE_NS(8)
  return static_cast<int>(cudaErrorInvalidValue);
}

int probe_streams_per_sm(int ns, int u, int* out) {
#define OCC_CASE(NS, U) \
  if (ns == NS && u == U) return per_sm<NS, U>(out);
#define OCC_NS(NS) OCC_CASE(NS, 1) OCC_CASE(NS, 2) OCC_CASE(NS, 4)
  OCC_NS(1) OCC_NS(4) OCC_NS(6) OCC_NS(8)
  return static_cast<int>(cudaErrorInvalidValue);
}

int probe_threads() { return THREADS; }

const char* probe_error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

}  // extern "C"
