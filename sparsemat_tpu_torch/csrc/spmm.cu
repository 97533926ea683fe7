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
//     m (a ragged last tile) are masked;
//   * below a full tile (m <= 64 in f32, m <= 32 in f64) a warp is cut into
//     32 / L sub-warps of L lanes, L the fewest (a power of two, chosen on
//     the host, kernels/_rowgroup.py spmm_lanes) whose 16-byte slices cover
//     m: L = 2 at m = 8 in f32.  Each sub-warp owns one row group, so one
//     warp walks 32 / L consecutive groups at once; its lanes take columns
//     lane * W (16-byte path) or lane + L w (scalar path).  The warp stages
//     the next union columns of all its groups in shared memory (256 a pass,
//     each group's run read coalesced, one element per lane, by asynchronous
//     copies all in flight at once), and each sub-warp reads its own column,
//     mask and values from there (a row pitch of an odd number of words
//     puts the sub-warps on distinct banks);
//   * no tensor cores: the work is 2 nnz m flops over the entries, B and Y,
//     about 8.8 flop per byte on the FEM operator at m = 128, under the
//     FP32 ridge (67 TFLOP/s over 3.35 TB/s = 20); and TF32 would break
//     parity with the reference's Precision.HIGHEST.
//
// Every Y element takes the same FMAs in the same order whatever L: its
// row's terms over the group's union columns in the group's order, a
// masked-off term skipped, from zero.  So a narrow product is bitwise equal
// to the same columns of a wider one, and reruns are bitwise equal.
//
// What bounds it on an H100: at a full tile, the B gather.  Each union
// column costs one 512-byte read of a B row per tile, so about 3.6 M x 512
// bytes (1.9 GB) per product on the FEM operator at m = 128, served mostly
// by L2 (the band's B window is a few MB); the plan itself (about 60 MB
// there), B and Y cross device memory once.  Row groups of G rows share
// each B read, which is why the plan groups rows.  Below a tile, the work
// of the load/store path per union column rather than bytes: each union
// column's B slice is its own L1 request (32 / L distinct rows in every
// warp-wide gather; 32 bytes, one sector, at m = 8), beside the staging of
// its column, mask and G values (63 MB on FEM, over the 56 MB that values,
// B and Y need) and G + 2 shared-memory reads.  On FEM at m = 8 on an H100
// the three cost about alike and add up (0.08 ms a product, against 0.33
// for a full tile): taking out the gathers leaves 0.05 ms, the staging's
// device-memory reads as well 0.02.
//
// Limits: a group's union columns are walked by one warp or sub-warp, so a
// very long row (power-law degree) makes one long walk, and a sub-warp's
// warp waits for the longest of its groups.

#include <cuda_pipeline.h>
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

// The sub-warp layout below a full tile: S = 32 / L row groups a warp, CH
// union columns of each staged a pass (STAGED a warp, at most 32 a group),
// one warp-wide load covering P groups' runs of CH; the warps of a CTA keep
// within the 48 KB of static shared memory.
constexpr int STAGED = 256;

template <typename T, int G, int L>
struct Narrow {
  static constexpr int S = 32 / L;
  static constexpr int CH = STAGED / S < UNROLL ? UNROLL : STAGED / S < 32 ? STAGED / S : 32;
  static constexpr int P = 32 / CH;
  static constexpr int PITCH = CH + 1;  // odd: sub-warp q's word k sits in bank (q PITCH + k) % 32
  struct Warp {
    T val[G][S][PITCH];
    int col[S][PITCH];
    unsigned bits[S][PITCH];
    int64_t lo[S];   // each group's first union column
    int64_t len[S];  // and its count (0 past the last group)
  };
  static constexpr int WARPS = 8 * sizeof(Warp) <= 48 * 1024   ? 8
                               : 4 * sizeof(Warp) <= 48 * 1024 ? 4
                               : 2 * sizeof(Warp) <= 48 * 1024 ? 2
                                                               : 1;
};

// Below a full tile (the lane count L < 32 selects this overload): one
// sub-warp of L lanes per row group, 32 / L groups a warp, one column tile.
template <typename T, int G, bool VEC, int L>
__global__ void __launch_bounds__((Narrow<T, G, L>::WARPS * 32))
rowgroup_spmm_kernel(const int64_t* __restrict__ grp_ptr, const int* __restrict__ cols,
                     const uint8_t* __restrict__ mask, const T* __restrict__ vals,
                     int64_t n_union, int64_t n_groups, int64_t n_rows, int64_t m,
                     const T* __restrict__ B, T* __restrict__ Y) {
  using N = Narrow<T, G, L>;
  constexpr int W = Vec<T>::width;
  constexpr int S = N::S, CH = N::CH, P = N::P;
  using V = typename Vec<T>::type;
  static_assert(CH % UNROLL == 0, "a pass holds whole rounds of UNROLL union columns");
  __shared__ typename N::Warp warps[N::WARPS];

  const int lane = threadIdx.x % 32;
  const int q = lane / L;  // this lane's sub-warp, and its group in the warp
  const int s = lane % L;
  typename N::Warp& wp = warps[threadIdx.x / 32];
  const int64_t g0 = (static_cast<int64_t>(blockIdx.x) * N::WARPS + threadIdx.x / 32) * S;
  if (g0 >= n_groups) return;  // whole warps leave together; no barrier below
  if (lane < S) {
    const int64_t g = g0 + lane;
    const int64_t lo = g < n_groups ? __ldg(grp_ptr + g) : 0;
    wp.lo[lane] = lo;
    wp.len[lane] = g < n_groups ? __ldg(grp_ptr + g + 1) - lo : 0;
  }
  __syncwarp();
  long long longest = lane < S ? wp.len[lane] : 0;  // the warp's longest group
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long other = __shfl_xor_sync(FULL, longest, off);
    longest = other > longest ? other : longest;
  }
  const int64_t my_len = wp.len[q];
  // this lane's first column: 16-byte slices, or lane + L w (scalar path)
  const int64_t col0 = VEC ? s * W : s;

  T acc[G][W];
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int w = 0; w < W; ++w) acc[i][w] = T(0);

  for (int64_t base = 0; base < longest; base += CH) {
    // stage union columns base .. base + CH of every group, P groups a load,
    // every load of the pass in flight at once: columns and values copied
    // to shared memory asynchronously, masks (single bytes) through registers
    unsigned bits_in[S / P];
#pragma unroll
    for (int j = 0; j < S / P; ++j) {
      const int qq = j * P + lane / CH;
      const int e = lane % CH;
      bits_in[j] = 0;
      if (base + e < wp.len[qq]) {
        const int64_t u = wp.lo[qq] + base + e;
        __pipeline_memcpy_async(&wp.col[qq][e], cols + u, sizeof(int));
#pragma unroll
        for (int i = 0; i < G; ++i)
          __pipeline_memcpy_async(&wp.val[i][qq][e], vals + i * n_union + u, sizeof(T));
        bits_in[j] = __ldg(mask + u);
      }
    }
    __pipeline_commit();
#pragma unroll
    for (int j = 0; j < S / P; ++j) wp.bits[j * P + lane / CH][lane % CH] = bits_in[j];
    __pipeline_wait_prior(0);
    __syncwarp();
    // this sub-warp's union columns in the pass, and the warp's most
    const int n = static_cast<int>(my_len - base < CH ? (my_len > base ? my_len - base : 0) : CH);
    const int n_warp = static_cast<int>(longest - base < CH ? longest - base : CH);
    for (int k0 = 0; k0 < n_warp; k0 += UNROLL) {
      // gather the B row slices of up to UNROLL union columns
      T b[UNROLL][W];
#pragma unroll
      for (int kk = 0; kk < UNROLL; ++kk) {
        if (k0 + kk < n) {
          const T* brow = B + static_cast<int64_t>(wp.col[q][k0 + kk]) * m;
          if constexpr (VEC) {
            V v = col0 < m ? __ldg(reinterpret_cast<const V*>(brow + col0)) : V{};
#pragma unroll
            for (int w = 0; w < W; ++w) b[kk][w] = Vec<T>::get(v, w);
          } else {
#pragma unroll
            for (int w = 0; w < W; ++w) {
              const int64_t col = col0 + L * w;
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
        const unsigned bits = k0 + kk < n ? wp.bits[q][k0 + kk] : 0u;
#pragma unroll
        for (int i = 0; i < G; ++i) {
          if (bits >> i & 1u) {
            const T a = wp.val[i][q][k0 + kk];
#pragma unroll
            for (int w = 0; w < W; ++w) acc[i][w] = fma(a, b[kk][w], acc[i][w]);
          }
        }
      }
    }
    __syncwarp();  // the pass is read before the next one overwrites it
  }

  const int64_t g = g0 + q;
  if (g >= n_groups) return;
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
        const int64_t col = col0 + L * w;
        if (col < m) yrow[col] = acc[i][w];
      }
    }
  }
}

struct Args {
  const int64_t* grp_ptr;
  const int* cols;
  const uint8_t* mask;
  int64_t n_union, n_groups, n_rows, m;
};

// One launch at G rows a group and L lanes a group (L = 32: a warp per
// (group, column tile), the full-tile kernel).
template <typename T, int G, int L>
void launch_gl(const Args& a, const T* vals, const T* B, T* Y, bool vec, cudaStream_t st) {
  if constexpr (L == 32) {
    constexpr int TILE = 32 * Vec<T>::width;
    const dim3 grid(static_cast<unsigned>((a.n_groups + WARPS - 1) / WARPS),
                    static_cast<unsigned>((a.m + TILE - 1) / TILE));
    if (vec)
      rowgroup_spmm_kernel<T, G, true><<<grid, WARPS * 32, 0, st>>>(
          a.grp_ptr, a.cols, a.mask, vals, a.n_union, a.n_groups, a.n_rows, a.m, B, Y);
    else
      rowgroup_spmm_kernel<T, G, false><<<grid, WARPS * 32, 0, st>>>(
          a.grp_ptr, a.cols, a.mask, vals, a.n_union, a.n_groups, a.n_rows, a.m, B, Y);
  } else {
    constexpr int PER_CTA = Narrow<T, G, L>::WARPS * Narrow<T, G, L>::S;  // groups a CTA
    const dim3 grid(static_cast<unsigned>((a.n_groups + PER_CTA - 1) / PER_CTA));
    constexpr int THREADS = Narrow<T, G, L>::WARPS * 32;
    if (vec)
      rowgroup_spmm_kernel<T, G, true, L><<<grid, THREADS, 0, st>>>(
          a.grp_ptr, a.cols, a.mask, vals, a.n_union, a.n_groups, a.n_rows, a.m, B, Y);
    else
      rowgroup_spmm_kernel<T, G, false, L><<<grid, THREADS, 0, st>>>(
          a.grp_ptr, a.cols, a.mask, vals, a.n_union, a.n_groups, a.n_rows, a.m, B, Y);
  }
}

template <typename T, int L>
void launch_l(const Args& a, int group, const T* vals, const T* B, T* Y, bool vec,
              cudaStream_t st) {
  switch (group) {
    case 1: launch_gl<T, 1, L>(a, vals, B, Y, vec, st); break;
    case 2: launch_gl<T, 2, L>(a, vals, B, Y, vec, st); break;
    case 3: launch_gl<T, 3, L>(a, vals, B, Y, vec, st); break;
    case 4: launch_gl<T, 4, L>(a, vals, B, Y, vec, st); break;
    case 5: launch_gl<T, 5, L>(a, vals, B, Y, vec, st); break;
    case 6: launch_gl<T, 6, L>(a, vals, B, Y, vec, st); break;
    case 7: launch_gl<T, 7, L>(a, vals, B, Y, vec, st); break;
    default: launch_gl<T, 8, L>(a, vals, B, Y, vec, st); break;
  }
}

template <typename T>
int launch(const void* grp_ptr, const void* cols, const void* mask, const void* vals,
           int64_t n_union, int64_t n_groups, int group, int64_t n_rows, int64_t m,
           const void* B, void* Y, int vec, int lanes, void* stream) {
  constexpr int W = Vec<T>::width;
  const int64_t blocks = (n_groups + WARPS - 1) / WARPS;
  const int64_t tiles = (m + 32 * W - 1) / (32 * W);
  // lanes: a power of two up to 32, below 32 only where its slices cover m
  const bool lanes_ok = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0 &&
                        (lanes == 32 || lanes * W >= m);
  if (n_groups <= 0 || n_rows <= 0 || m <= 0 || group < 1 || group > 8 ||
      n_groups * group < n_rows || blocks > 0x7fffffff || tiles > 65535 || !lanes_ok)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int64_t*>(grp_ptr), static_cast<const int*>(cols),
               static_cast<const uint8_t*>(mask), n_union, n_groups, n_rows, m};
  const auto* v = static_cast<const T*>(vals);
  const auto* b = static_cast<const T*>(B);
  auto* y = static_cast<T*>(Y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1: launch_l<T, 1>(a, group, v, b, y, vec, st); break;
    case 2: launch_l<T, 2>(a, group, v, b, y, vec, st); break;
    case 4: launch_l<T, 4>(a, group, v, b, y, vec, st); break;
    case 8: launch_l<T, 8>(a, group, v, b, y, vec, st); break;
    case 16: launch_l<T, 16>(a, group, v, b, y, vec, st); break;
    default: launch_l<T, 32>(a, group, v, b, y, vec, st); break;
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
// 16 / sizeof(T) and B and Y are 16-byte aligned.  lanes: the lanes of one
// row group, 1, 2, 4, 8 or 16 where lanes * 16 / sizeof(T) >= m, else 32.
int smt_rowgroup_spmm_f32(const void* grp_ptr, const void* cols, const void* mask,
                          const void* vals, int64_t n_union, int64_t n_groups, int group,
                          int64_t n_rows, int64_t m, const void* B, void* Y, int vec,
                          int lanes, void* stream) {
  return launch<float>(grp_ptr, cols, mask, vals, n_union, n_groups, group, n_rows, m, B, Y,
                       vec, lanes, stream);
}

int smt_rowgroup_spmm_f64(const void* grp_ptr, const void* cols, const void* mask,
                          const void* vals, int64_t n_union, int64_t n_groups, int group,
                          int64_t n_rows, int64_t m, const void* B, void* Y, int vec,
                          int lanes, void* stream) {
  return launch<double>(grp_ptr, cols, mask, vals, n_union, n_groups, group, n_rows, m, B, Y,
                        vec, lanes, stream);
}

}  // extern "C"
