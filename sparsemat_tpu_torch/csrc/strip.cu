// StripELL SpMV kernel for Hopper (sm_90a), bound to Python with ctypes
// through the plain C functions at the end of this file.
//
// Replaces sparsemat_tpu/kernels/strip.py: strip_part_spmv_pallas (one
// launch per class part), strip_spmv_pallas and _combine (the static block
// permutation that puts each part's (nb, 128) block results in row order).
//
// For each 128-row block b of each part and each lane r:
//   y[block_ids[b]*128 + r] = sum_{s < c_total} vals[b,s,r] *
//       x[(wtile[b/g4]*32 + wrel[b,s]) * 128 + lidx_s[b,r]]
// where lidx_s is byte s / cp of word row s % cp of the packed index array
// (cp = c_total / pack).  A column >= n_cols reads 0; rows >= n_rows (the
// ragged last block and the trailing group pad, whose block ids are past
// the last row block) are dropped.
//
// What the TPU kernel needed and this one does not: a TPU has no sublane
// gather, so it assembled per-strip x rows from a DMA'd 128x128 x^T tile by
// one lane-gather plus a transpose per 128 strips.  A GPU thread gathers x
// directly, so there are no tiles here.
//
// Design (a simple kernel that is right; staging the group's x span in
// shared memory, asynchronous copies and vector loads are later work):
//   * one launch per SpMV over all blocks of all parts: a flat grid of one
//     CTA per block, a small device table of per-part pointers and shapes,
//     and per block its part index and block id.  The TPU's class split
//     leaves ~50 blocks per part on the pwtk-class operator, so a launch per
//     part would fill well under half of the 132 SMs and pay a launch
//     latency 32 times per SpMV;
//   * 128 threads per CTA, one per row (lane): the vals and lidx rows of a
//     strip are 128 consecutive words, so each load is coalesced;
//   * the block's wrel row (c_total ints) staged in shared memory once;
//   * a loop over the packed word rows, unpacking `pack` bytes per word;
//   * the result written straight to y[block_ids[b]*128 + r], which fuses
//     _combine: the targets of all blocks are distinct, so no atomics;
//   * a fixed summation order (word row o outer, byte j inner), so reruns
//     are bitwise equal.
//
// What bounds it on an H100: device-memory bytes.  The vals stream (one
// value per strip slot, fill ~0.19 on the pwtk-class operator) and the
// packed index stream are read once, 2 flops per slot; x is gathered within
// 128-column windows that the block's rows share, so its reads hit L1/L2
// after the first touch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int RB = 128;          // rows per block == threads per CTA
constexpr int WINDOW = 128;      // columns per window
constexpr int TILE_STRIDE = 32;  // tile bases are multiples of 32 windows

// Fields of one row of the part table (int64 each).
enum PartField {
  kVals = 0,   // pointer: (nb, c_total, 128) T
  kLidx,       // pointer: (nb, cp, 128) int32, pack bytes per word
  kWrel,       // pointer: (nb, wrel_stride) int32
  kWtile,      // pointer: (nb / g4,) int32
  kCTotal,
  kCp,
  kWrelStride,
  kG4,
  kFirst,      // the part's first block in the flat grid
  kPartFields
};

template <typename T, int PACK>
__global__ void __launch_bounds__(RB)
strip_spmv_kernel(const int64_t* __restrict__ parts,
                  const int* __restrict__ part_of,
                  const int* __restrict__ block_ids, int64_t n_rows,
                  int64_t n_cols, const T* __restrict__ x, T* __restrict__ y) {
  extern __shared__ int swrel[];
  const int gb = blockIdx.x;
  const int r = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(__ldg(block_ids + gb)) * RB;
  if (row0 >= n_rows) return;  // trailing group pad (uniform over the CTA)

  const int64_t* P = parts + static_cast<int64_t>(__ldg(part_of + gb)) * kPartFields;
  const T* vals = reinterpret_cast<const T*>(P[kVals]);
  const int* lidx = reinterpret_cast<const int*>(P[kLidx]);
  const int* wrel = reinterpret_cast<const int*>(P[kWrel]);
  const int* wtile = reinterpret_cast<const int*>(P[kWtile]);
  const int c_total = static_cast<int>(P[kCTotal]);
  const int cp = static_cast<int>(P[kCp]);
  const int64_t g4 = P[kG4];
  const int64_t b = gb - P[kFirst];  // this block's index within its part

  const int* wrow = wrel + b * P[kWrelStride];
  for (int s = r; s < c_total; s += RB) swrel[s] = __ldg(wrow + s);
  __syncthreads();

  const int64_t base = static_cast<int64_t>(__ldg(wtile + b / g4)) * TILE_STRIDE;
  const T* vb = vals + b * c_total * RB + r;
  const int* lb = lidx + b * cp * RB + r;
  T acc = T(0);
  for (int o = 0; o < cp; ++o) {
    const unsigned w = static_cast<unsigned>(__ldg(lb + static_cast<int64_t>(o) * RB));
#pragma unroll
    for (int j = 0; j < PACK; ++j) {
      const int s = j * cp + o;
      const int64_t col = (base + swrel[s]) * WINDOW + ((w >> (8 * j)) & 0xFFu);
      const T xv = col < n_cols ? __ldg(x + col) : T(0);
      acc += __ldg(vb + static_cast<int64_t>(s) * RB) * xv;
    }
  }
  const int64_t row = row0 + r;
  if (row < n_rows) y[row] = acc;
}

template <typename T>
int launch(const void* parts, const void* part_of, const void* block_ids,
           int n_blocks, int pack, int64_t n_rows, int64_t n_cols,
           const void* x, void* y, int c_max, void* stream) {
  const int64_t* p = static_cast<const int64_t*>(parts);
  const int* po = static_cast<const int*>(part_of);
  const int* bi = static_cast<const int*>(block_ids);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  const size_t smem = static_cast<size_t>(c_max) * sizeof(int);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pack) {
    case 1:
      strip_spmv_kernel<T, 1><<<n_blocks, RB, smem, st>>>(p, po, bi, n_rows, n_cols, xx, yy);
      break;
    case 2:
      strip_spmv_kernel<T, 2><<<n_blocks, RB, smem, st>>>(p, po, bi, n_rows, n_cols, xx, yy);
      break;
    case 4:
      strip_spmv_kernel<T, 4><<<n_blocks, RB, smem, st>>>(p, po, bi, n_rows, n_cols, xx, yy);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* smt_strip_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// parts: (n_parts, kPartFields) int64 device table; part_of / block_ids: (n_blocks,)
// int32 device arrays; c_max: the largest c_total (shared memory ints).
int smt_strip_spmv_f32(const void* parts, const void* part_of,
                       const void* block_ids, int n_blocks, int pack,
                       int64_t n_rows, int64_t n_cols, const void* x, void* y,
                       int c_max, void* stream) {
  return launch<float>(parts, part_of, block_ids, n_blocks, pack, n_rows,
                       n_cols, x, y, c_max, stream);
}

int smt_strip_spmv_f64(const void* parts, const void* part_of,
                       const void* block_ids, int n_blocks, int pack,
                       int64_t n_rows, int64_t n_cols, const void* x, void* y,
                       int c_max, void* stream) {
  return launch<double>(parts, part_of, block_ids, n_blocks, pack, n_rows,
                        n_cols, x, y, c_max, stream);
}

}  // extern "C"
