// SlabELL / SlabPack SpMV kernel, and the SlabStream SpMV kernel (below
// it), for Hopper (sm_90a), bound to Python with ctypes through the plain C
// functions at the end of this file.  The slab SpMM is the row-group kernel
// of csrc/spmm.cu.
//
// Replaces sparsemat_tpu/kernels/spmv.py: slab_spmv_pallas (one grid step
// per group of rb-row blocks, x resident as 128-column windows, one gather
// and FMA per bucket slot) and slab_pack_spmv_pallas (one call per class
// part, the static block permutation _slab_pack_combine, the overflow pack
// added on top).
//
// For each block b of each part and each row r of the block:
//   y[block_ids[b]*rb + r] (+)= sum_{s < C} vals[b,s,r] *
//       x[(win_lo[b] + w_of[s]) * 128 + lidx[b,s,r]]
// where w_of[s] is the slab window of slot s (the part's buckets laid out
// per slot).  A column >= n_cols reads 0; rows >= n_rows (the ragged last
// block) are dropped.
//
// What the TPU kernels needed and these do not: x padded to x_windows() and
// held in VMEM as (n_win, 128) rows, a dynamic sublane slice per bucket and
// a 128-lane take_along per sublane group, (8, 128) register tiles, and
// blocks batched per grid step to amortise step overhead.  A GPU thread
// gathers x directly with a bound check.
//
// Design (a simple kernel that is right; staging x windows in shared
// memory and vector loads are later work):
//   * one launch per level (the parts, then each overflow pack) over all
//     blocks of all its parts: a flat grid of one CTA per block, a device
//     table of per-part pointers, and per block its part index and global
//     block id, as csrc/strip.cu has;
//   * rb threads per CTA (256, or 128 in the overflow), one per row: the
//     transposed (C, rb) tiles make every vals/lidx load coalesced;
//   * zero-height buckets own no slots, so nothing skips them;
//   * the result goes straight to its global row, which fuses
//     _slab_pack_combine: every global block is in exactly one part, so no
//     atomics; the overflow level's launch adds into Y after the parts'
//     launch on the same stream, in a fixed order, so reruns are bitwise
//     equal.
//
// What bounds it on an H100: the SpMV streams vals and lidx once (8 bytes
// a slot in f32, padding included: 10,609,572 of the 109,884,416 slots of
// the pwtk-class SlabPack hold entries) and gathers x within 128-column
// windows that the block's rows share, so its reads of x hit L1/L2 after
// the first touch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WINDOW = 128;
constexpr int SUBLANE = 8;  // rows of a SlabStream chunk

// Fields of one row of the part table (int64 each).
enum PartField {
  kVals = 0,  // pointer: (nb, C, rb) T
  kLidx,      // pointer: (nb, C, rb) int32
  kWinLo,     // pointer: (nb,) int32
  kWof,       // pointer: (C,) int32 slab window of each slot
  kC,
  kFirst,     // the part's first block in the flat grid
  kPartFields
};

template <typename T>
__global__ void __launch_bounds__(1024)
slab_spmv_kernel(const int64_t* __restrict__ parts, const int* __restrict__ part_of,
                 const int* __restrict__ block_ids, int64_t n_rows, int64_t n_cols,
                 const T* __restrict__ x, T* __restrict__ y, int accumulate) {
  const int gb = blockIdx.x;
  const int r = threadIdx.x;
  const int rb = blockDim.x;
  const int64_t row = static_cast<int64_t>(__ldg(block_ids + gb)) * rb + r;
  if (row >= n_rows) return;

  const int64_t* P = parts + static_cast<int64_t>(__ldg(part_of + gb)) * kPartFields;
  const T* vals = reinterpret_cast<const T*>(P[kVals]);
  const int* lidx = reinterpret_cast<const int*>(P[kLidx]);
  const int* wof = reinterpret_cast<const int*>(P[kWof]);
  const int64_t c_total = P[kC];
  const int64_t b = gb - P[kFirst];
  const int64_t wl = __ldg(reinterpret_cast<const int*>(P[kWinLo]) + b);

  const T* vb = vals + b * c_total * rb + r;
  const int* lb = lidx + b * c_total * rb + r;
  T acc = T(0);
  for (int64_t s = 0; s < c_total; ++s) {
    const T v = __ldg(vb + s * rb);
    const int64_t col = (wl + __ldg(wof + s)) * WINDOW + __ldg(lb + s * rb);
    const T xv = col < n_cols ? __ldg(x + col) : T(0);
    acc = fma(v, xv, acc);
  }
  y[row] = accumulate ? y[row] + acc : acc;
}

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
// is row-contiguous, so every load coalesces (the shape of slab_spmv_kernel
// above); each thread sums its row over the block's chunks in stream order
// and writes y once: no atomics, reruns bitwise equal.  Bound: vals, lidx,
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

template <typename T>
int launch_spmv(const void* parts, const void* part_of, const void* block_ids,
                int n_blocks, int rb, int64_t n_rows, int64_t n_cols,
                const void* x, void* y, int accumulate, void* stream) {
  if (n_blocks <= 0 || rb <= 0 || rb > 1024 || rb % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  slab_spmv_kernel<T><<<n_blocks, rb, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(parts), static_cast<const int*>(part_of),
      static_cast<const int*>(block_ids), n_rows, n_cols,
      static_cast<const T*>(x), static_cast<T*>(y), accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* smt_slab_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// parts: (n_parts, kPartFields) int64 device table; part_of / block_ids:
// (n_blocks,) int32 device arrays; accumulate: 0 stores y, 1 adds into it.
int smt_slab_spmv_f32(const void* parts, const void* part_of, const void* block_ids,
                      int n_blocks, int rb, int64_t n_rows, int64_t n_cols,
                      const void* x, void* y, int accumulate, void* stream) {
  return launch_spmv<float>(parts, part_of, block_ids, n_blocks, rb, n_rows, n_cols,
                            x, y, accumulate, stream);
}

int smt_slab_spmv_f64(const void* parts, const void* part_of, const void* block_ids,
                      int n_blocks, int rb, int64_t n_rows, int64_t n_cols,
                      const void* x, void* y, int accumulate, void* stream) {
  return launch_spmv<double>(parts, part_of, block_ids, n_blocks, rb, n_rows, n_cols,
                             x, y, accumulate, stream);
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
