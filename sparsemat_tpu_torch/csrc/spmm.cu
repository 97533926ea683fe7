// Row-group SpMM kernel for Hopper (sm_90a): Y = A @ B over the compact
// launch plan of a BSR, SlabELL, SlabPack, StripELL, WELL, SlabStream or
// RouteStream (kernels/_rowgroup.py), bound to Python with ctypes through
// the plain C functions at the end of this file.
//
// Replaces sparsemat_tpu/kernels/spmm.py: bsr_spmm_pallas (:72, one MXU
// product per stored (br x bc) block per 128-column tile of B),
// slab_spmm_pallas (:204, the SlabELL slot walk over mc columns of B per
// pass) and slab_pack_spmm_pallas (:301, one call per class part and per
// overflow pack, combined by a static permutation and an add).
//
// The plan (built once per matrix) holds exactly the matrix's entries: no
// zero blocks, no padding slots.  Rows are cut into groups of G <= 8
// consecutive rows; group g owns the union columns u in
// [grp_ptr[g], grp_ptr[g+1]), sorted, each with its column cols[u], a mask
// (bit i set where row g*G + i has an entry there) and one value per row of
// the group, vals[i*U + u] (zero where the row has none).  For row
// r = g*G + i and column j of B:
//   Y[r, j] = sum over u of the group, bit i of mask[u] set:
//             vals[i*U + u] * B[cols[u], j]
// summed in the group's column order: plain FMAs, no atomics, Y written
// once, so reruns are bitwise equal.  A masked-off term is skipped, not
// multiplied by zero: for a B holding inf or NaN the result is what a CSR
// SpMM gives (a stored zero still gives 0 * inf = NaN).
//
// Design:
//   * one warp per (row group, column tile); a tile is 128 f32 or 64 f64
//     columns, so each lane covers 16 bytes of a B row;
//   * the warp reads its group's columns, masks and values 32 union columns
//     at a time, coalesced (vals is (G, U), so each row's values are
//     contiguous), and broadcasts each with __shfl_sync;
//   * it gathers the B row slices of 8 union columns before it consumes
//     them (8 loads of 512 bytes in flight per warp), then does G FMAs per
//     element into G x 4 (f32) or G x 2 (f64) register accumulators;
//   * Y rows are written with 16-byte stores.  Where m is not a multiple of
//     the vector width, or B or Y is not 16-byte aligned, the lanes take
//     columns lane + 32 w with scalar loads and stores instead; columns past
//     m (a ragged last tile, m = 1) are masked;
//   * no tensor cores: the work is 2 nnz m flops over the entries, B and Y,
//     about 8.8 flop per byte on the FEM operator at m = 128, under the
//     FP32 ridge (67 TFLOP/s over 3.35 TB/s = 20); and TF32 would break
//     parity with the reference's Precision.HIGHEST.
//
// What bounds it on an H100: the B gather.  Each union column costs one
// 512-byte read of a B row per tile, so about 3.6 M x 512 bytes (1.9 GB)
// per product on the FEM operator at m = 128, served mostly by L2 (the
// band's B window is a few MB); the plan itself (about 60 MB there), B and
// Y cross device memory once.  Row groups of G rows share each B read,
// which is why the plan groups rows.
//
// Limits: a group's union columns are walked by one warp, so a very long
// row (power-law degree) makes one long warp; a small m (below a tile)
// leaves lanes idle.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;     // warps per CTA, one row group each
constexpr int UNROLL = 8;    // B row loads in flight per warp
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int width = 4;
  __device__ static float get(const float4& v, int w) {
    return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
  }
  __device__ static float4 make(const float* a) { return make_float4(a[0], a[1], a[2], a[3]); }
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int width = 2;
  __device__ static double get(const double2& v, int w) { return w == 0 ? v.x : v.y; }
  __device__ static double2 make(const double* a) { return make_double2(a[0], a[1]); }
};

template <typename T, int G, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
rowgroup_spmm_kernel(const int64_t* __restrict__ grp_ptr, const int* __restrict__ cols,
                     const uint8_t* __restrict__ mask, const T* __restrict__ vals,
                     int64_t n_union, int64_t n_groups, int64_t n_rows, int64_t m,
                     const T* __restrict__ B, T* __restrict__ Y) {
  constexpr int W = Vec<T>::width;  // columns per lane
  constexpr int TILE = 32 * W;
  using V = typename Vec<T>::type;

  const int lane = threadIdx.x % 32;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (g >= n_groups) return;  // whole warps leave together; no barrier below
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * TILE;
  // this lane's first column: 16-byte slices, or lane + 32 w (scalar path)
  const int64_t col0 = VEC ? j0 + lane * W : j0 + lane;

  T acc[G][W];
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int w = 0; w < W; ++w) acc[i][w] = T(0);

  const int64_t u0 = __ldg(grp_ptr + g);
  const int64_t u1 = __ldg(grp_ptr + g + 1);
  for (int64_t base = u0; base < u1; base += 32) {
    const int n = static_cast<int>(u1 - base < 32 ? u1 - base : 32);
    // this chunk's columns, masks and values, one union column per lane
    int my_col = 0;
    unsigned my_mask = 0;
    T my_val[G];
    if (lane < n) {
      my_col = __ldg(cols + base + lane);
      my_mask = __ldg(mask + base + lane);
#pragma unroll
      for (int i = 0; i < G; ++i) my_val[i] = __ldg(vals + i * n_union + base + lane);
    } else {
#pragma unroll
      for (int i = 0; i < G; ++i) my_val[i] = T(0);
    }
    for (int k0 = 0; k0 < n; k0 += UNROLL) {
      // gather the B row slices of up to UNROLL union columns
      T b[UNROLL][W];
#pragma unroll
      for (int kk = 0; kk < UNROLL; ++kk) {
        const int64_t c = __shfl_sync(FULL, my_col, k0 + kk);
        const T* brow = B + c * m;
        if (k0 + kk < n) {  // the same for every lane of the warp
          if constexpr (VEC) {
            V v = col0 < m ? __ldg(reinterpret_cast<const V*>(brow + col0)) : V{};
#pragma unroll
            for (int w = 0; w < W; ++w) b[kk][w] = Vec<T>::get(v, w);
          } else {
#pragma unroll
            for (int w = 0; w < W; ++w) {
              const int64_t col = col0 + 32 * w;
              b[kk][w] = col < m ? __ldg(brow + col) : T(0);
            }
          }
        } else {
#pragma unroll
          for (int w = 0; w < W; ++w) b[kk][w] = T(0);
        }
      }
      // G rows x W columns of FMAs per union column, in column order
#pragma unroll
      for (int kk = 0; kk < UNROLL; ++kk) {
        const unsigned bits = __shfl_sync(FULL, my_mask, k0 + kk);  // 0 past n
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const T a = __shfl_sync(FULL, my_val[i], k0 + kk);
          if (bits >> i & 1u) {
#pragma unroll
            for (int w = 0; w < W; ++w) acc[i][w] = fma(a, b[kk][w], acc[i][w]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int64_t row = g * G + i;
    if (row >= n_rows) break;
    T* yrow = Y + row * m;
    if constexpr (VEC) {
      if (col0 < m) *reinterpret_cast<V*>(yrow + col0) = Vec<T>::make(acc[i]);
    } else {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int64_t col = col0 + 32 * w;
        if (col < m) yrow[col] = acc[i][w];
      }
    }
  }
}

template <typename T, int G>
void launch_g(const int64_t* grp_ptr, const int* cols, const uint8_t* mask, const T* vals,
              int64_t n_union, int64_t n_groups, int64_t n_rows, int64_t m, const T* B,
              T* Y, bool vec, dim3 grid, cudaStream_t st) {
  if (vec)
    rowgroup_spmm_kernel<T, G, true><<<grid, WARPS * 32, 0, st>>>(
        grp_ptr, cols, mask, vals, n_union, n_groups, n_rows, m, B, Y);
  else
    rowgroup_spmm_kernel<T, G, false><<<grid, WARPS * 32, 0, st>>>(
        grp_ptr, cols, mask, vals, n_union, n_groups, n_rows, m, B, Y);
}

template <typename T>
int launch(const void* grp_ptr, const void* cols, const void* mask, const void* vals,
           int64_t n_union, int64_t n_groups, int group, int64_t n_rows, int64_t m,
           const void* B, void* Y, int vec, void* stream) {
  constexpr int TILE = 32 * Vec<T>::width;
  const int64_t blocks = (n_groups + WARPS - 1) / WARPS;
  const int64_t tiles = (m + TILE - 1) / TILE;
  if (n_groups <= 0 || n_rows <= 0 || m <= 0 || group < 1 || group > 8 ||
      n_groups * group < n_rows || blocks > 0x7fffffff || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles));
  const auto* p = static_cast<const int64_t*>(grp_ptr);
  const auto* c = static_cast<const int*>(cols);
  const auto* k = static_cast<const uint8_t*>(mask);
  const auto* v = static_cast<const T*>(vals);
  const auto* b = static_cast<const T*>(B);
  auto* y = static_cast<T*>(Y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1: launch_g<T, 1>(p, c, k, v, n_union, n_groups, n_rows, m, b, y, vec, grid, st); break;
    case 2: launch_g<T, 2>(p, c, k, v, n_union, n_groups, n_rows, m, b, y, vec, grid, st); break;
    case 3: launch_g<T, 3>(p, c, k, v, n_union, n_groups, n_rows, m, b, y, vec, grid, st); break;
    case 4: launch_g<T, 4>(p, c, k, v, n_union, n_groups, n_rows, m, b, y, vec, grid, st); break;
    case 5: launch_g<T, 5>(p, c, k, v, n_union, n_groups, n_rows, m, b, y, vec, grid, st); break;
    case 6: launch_g<T, 6>(p, c, k, v, n_union, n_groups, n_rows, m, b, y, vec, grid, st); break;
    case 7: launch_g<T, 7>(p, c, k, v, n_union, n_groups, n_rows, m, b, y, vec, grid, st); break;
    default: launch_g<T, 8>(p, c, k, v, n_union, n_groups, n_rows, m, b, y, vec, grid, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* smt_spmm_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// grp_ptr: (n_groups + 1,) int64; cols: (n_union,) int32 < n_cols; mask:
// (n_union,) uint8; vals: (group, n_union) T; B: (n_cols, m) and Y:
// (n_rows, m) row-major, Y fully written.  vec: 1 where m is a multiple of
// 16 / sizeof(T) and B and Y are 16-byte aligned.
int smt_rowgroup_spmm_f32(const void* grp_ptr, const void* cols, const void* mask,
                          const void* vals, int64_t n_union, int64_t n_groups, int group,
                          int64_t n_rows, int64_t m, const void* B, void* Y, int vec,
                          void* stream) {
  return launch<float>(grp_ptr, cols, mask, vals, n_union, n_groups, group, n_rows, m, B, Y,
                       vec, stream);
}

int smt_rowgroup_spmm_f64(const void* grp_ptr, const void* cols, const void* mask,
                          const void* vals, int64_t n_union, int64_t n_groups, int group,
                          int64_t n_rows, int64_t m, const void* B, void* Y, int vec,
                          void* stream) {
  return launch<double>(grp_ptr, cols, mask, vals, n_union, n_groups, group, n_rows, m, B, Y,
                        vec, stream);
}

}  // extern "C"
