// SlabStream SpMV kernel for Hopper (sm_90a), bound to Python with ctypes
// through the plain C functions at the end of this file.  The SlabELL /
// SlabPack SpMV and SpMM are the row-group kernels of csrc/spmv.cu and
// csrc/spmm.cu.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WINDOW = 128;
constexpr int SUBLANE = 8;  // rows of a SlabStream chunk

// SlabStream SpMV.  Replaces sparsemat_tpu/kernels/spmv.py:
// slab_stream_spmv_pallas (one sequential grid over the chunk stream, g8
// chunks a step, x and the whole y resident in VMEM and y updated by
// read-modify-write, the stream split into SMEM-sized calls whose outputs
// add, padding chunks aimed at a spare row n_rb).  For each row block b and
// row r < rb:
//   y[b*rb + r] = sum over chunks c with blk_id[c] = b, sum over s < 8 of
//                 vals[c,s,r] * x[win_id[c] * 128 + lidx[c,s,r]]
// A column >= n_cols reads 0; a chunk aimed at a block >= n_rb is dropped.
// Design: the wrapper's plan gives each row block its chunk range
// (chunk_ptr, from the freeze's block-sorted chunks) and, for a layout
// whose chunks arrive out of block order, a stable permutation (order).
// One CTA per row block, rb threads, one per row: each chunk's (8, rb) tile
// is row-contiguous, so every load coalesces; each thread sums its row over
// the block's chunks in stream order and writes y once: no atomics, reruns
// bitwise equal.  Bound: vals, lidx,
// win_id and blk_id once plus x and y, over 3.35 TB/s (about 0.219 ms on
// the pwtk-class operator at rb 256); chunk counts per block vary, so the
// CTAs' lengths do too.
template <typename T>
__global__ void __launch_bounds__(1024)
slab_stream_spmv_kernel(const T* __restrict__ vals, const int* __restrict__ lidx,
                        const int* __restrict__ win_id, const int64_t* __restrict__ chunk_ptr,
                        const int64_t* __restrict__ order, int64_t n_rows, int64_t n_cols,
                        const T* __restrict__ x, T* __restrict__ y) {
  const int64_t b = blockIdx.x;
  const int r = threadIdx.x;
  const int rb = blockDim.x;
  const int64_t row = b * rb + r;
  if (row >= n_rows) return;  // no barrier below, so the ragged block may exit
  const int64_t tile = static_cast<int64_t>(SUBLANE) * rb;
  T acc = T(0);
  const int64_t i1 = __ldg(chunk_ptr + b + 1);
  for (int64_t i = __ldg(chunk_ptr + b); i < i1; ++i) {
    const int64_t c = order != nullptr ? __ldg(order + i) : i;
    const int64_t wcol = static_cast<int64_t>(__ldg(win_id + c)) * WINDOW;
    const T* vc = vals + c * tile + r;
    const int* lc = lidx + c * tile + r;
#pragma unroll
    for (int s = 0; s < SUBLANE; ++s) {
      const int64_t col = wcol + __ldg(lc + s * rb);
      const T xv = col < n_cols ? __ldg(x + col) : T(0);
      acc = fma(__ldg(vc + s * rb), xv, acc);
    }
  }
  y[row] = acc;
}

template <typename T>
int launch_stream(const void* vals, const void* lidx, const void* win_id,
                  const void* chunk_ptr, const void* order, int64_t n_rb, int rb,
                  int64_t n_rows, int64_t n_cols, const void* x, void* y, void* stream) {
  if (n_rb <= 0 || n_rb > 0x7fffffff || rb <= 0 || rb > 1024 || rb % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  slab_stream_spmv_kernel<T><<<static_cast<unsigned>(n_rb), rb, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const int*>(lidx),
      static_cast<const int*>(win_id), static_cast<const int64_t*>(chunk_ptr),
      static_cast<const int64_t*>(order), n_rows, n_cols, static_cast<const T*>(x),
      static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* smt_slab_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// SlabStream: vals (N, 8, rb) T; lidx (N, 8, rb) int32; win_id (N,) int32;
// chunk_ptr (n_rb + 1,) int64 chunk range of each row block over `order`
// (or over the storage order when order is null); order
// (chunk_ptr[n_rb],) int64 or null.  y: (n_rows,) T, every row written.
int smt_slab_stream_spmv_f32(const void* vals, const void* lidx, const void* win_id,
                             const void* chunk_ptr, const void* order, int64_t n_rb, int rb,
                             int64_t n_rows, int64_t n_cols, const void* x, void* y,
                             void* stream) {
  return launch_stream<float>(vals, lidx, win_id, chunk_ptr, order, n_rb, rb, n_rows, n_cols,
                              x, y, stream);
}

int smt_slab_stream_spmv_f64(const void* vals, const void* lidx, const void* win_id,
                             const void* chunk_ptr, const void* order, int64_t n_rb, int rb,
                             int64_t n_rows, int64_t n_cols, const void* x, void* y,
                             void* stream) {
  return launch_stream<double>(vals, lidx, win_id, chunk_ptr, order, n_rb, rb, n_rows, n_cols,
                               x, y, stream);
}

}  // extern "C"
