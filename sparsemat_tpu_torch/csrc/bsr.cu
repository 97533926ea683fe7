// BSR SpMM kernel for Hopper (sm_90a), bound to Python with ctypes through
// the plain C functions at the end of this file.
//
// Replaces sparsemat_tpu/kernels/spmm.py: bsr_spmm_pallas (Y = A @ B, one
// MXU product per stored (br x bc) block per 128-column tile of B, the
// output block zeroed on its first visit, results of per-chunk calls
// concatenated).
//
// For block row R, with tiles t in [tile_ptr[R], tile_ptr[R+1]) (block_rows
// ascending, so a block row's tiles are consecutive):
//   Y[R*br + r, j] = sum_t sum_{k < bc} blocks[t, r, k] * B[block_cols[t]*bc + k, j]
// Rows of B past n_cols read 0; rows of Y past n_rows are not written.
//
// Design (a simple kernel that is right; tensor cores are later work):
//   * one CTA per (block row, sub-range of RS = 8*TM of its rows, 128
//     columns of Y).  A 512 x 128 f32 output block is 256 KB, more than a
//     CTA's shared memory, hence the row sub-ranges; TM is the largest of
//     8, 4, 2, 1 with 8*TM dividing br;
//   * 256 threads: 8 row groups (one per warp) of TM rows, 32 column lanes
//     of 4 columns each, strided by 32 so that shared-memory reads and the
//     stores of Y are consecutive across the warp;
//   * the CTA walks its block row's tiles in order and their bc columns in
//     chunks of KC, staging the (RS x KC) piece of A and the (KC x 128)
//     slice of B in shared memory; the TM x 4 sums stay in registers, so Y
//     is written once, with no atomics and no zeroing pass (the TPU's
//     first-visit zeroing becomes register initialisation);
//   * plain FP32/FP64 fused multiply-adds, no TF32, matching the TPU's
//     Precision.HIGHEST; a fixed summation order (tile, then k), so reruns
//     are bitwise equal.
//
// What bounds it on an H100: FP32 arithmetic over the stored blocks.  At
// the FEM benchmark's 512 x 128 blocks 98.8% of the stored-block flops
// multiply zeros (229 GFLOP per SpMM at m = 128 against 2.72 useful), and
// the per-thread inner step is 4 + TM shared-memory loads for 4*TM FMAs, so
// the kernel runs below the card's 67 TFLOP/s FP32 rate.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BN = 128;       // columns of Y per CTA
constexpr int THREADS = 256;  // 8 row groups x 32 column lanes
constexpr int TN = 4;         // columns per thread (strided by 32)

template <typename T>
struct KChunk {
  static constexpr int value = 32;
};
template <>
struct KChunk<double> {
  static constexpr int value = 16;
};

template <typename T, int TM>
__global__ void __launch_bounds__(THREADS)
bsr_spmm_kernel(const T* __restrict__ blocks, const int* __restrict__ block_cols,
                const int* __restrict__ tile_ptr, int br, int bc, int n_sub,
                int64_t n_rows, int64_t n_cols, int64_t m,
                const T* __restrict__ B, T* __restrict__ Y) {
  constexpr int RS = 8 * TM;
  constexpr int KC = KChunk<T>::value;
  __shared__ T As[RS][KC];
  __shared__ T Bs[KC][BN];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int grp = tid / 32;
  const int64_t rblk = blockIdx.x / n_sub;
  const int rs0 = (blockIdx.x % n_sub) * RS;
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * BN;

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

  const int t0 = __ldg(tile_ptr + rblk);
  const int t1 = __ldg(tile_ptr + rblk + 1);
  const int64_t tile_elems = static_cast<int64_t>(br) * bc;
  for (int t = t0; t < t1; ++t) {
    const T* A = blocks + t * tile_elems + static_cast<int64_t>(rs0) * bc;
    const int64_t brow0 = static_cast<int64_t>(__ldg(block_cols + t)) * bc;
    for (int k0 = 0; k0 < bc; k0 += KC) {
      for (int i = tid; i < RS * KC; i += THREADS) {
        const int r = i / KC, k = i % KC;
        As[r][k] = __ldg(A + static_cast<int64_t>(r) * bc + k0 + k);
      }
      for (int i = tid; i < KC * BN; i += THREADS) {
        const int k = i / BN, c = i % BN;
        const int64_t row = brow0 + k0 + k, col = j0 + c;
        Bs[k][c] = (row < n_cols && col < m) ? __ldg(B + row * m + col) : T(0);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        T b[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[k][lane + 32 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const T a = As[grp * TM + i][k];  // one address per warp: a broadcast
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fma(a, b[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t row = rblk * br + rs0 + grp * TM + i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t col = j0 + lane + 32 * j;
      if (col < m) Y[row * m + col] = acc[i][j];
    }
  }
}

template <typename T, int TM>
void launch_tm(const T* blocks, const int* bcols, const int* tptr, int n_rb,
               int br, int bc, int64_t n_rows, int64_t n_cols, int64_t m,
               const T* B, T* Y, cudaStream_t st) {
  const int n_sub = br / (8 * TM);
  const dim3 grid(static_cast<unsigned>(static_cast<int64_t>(n_rb) * n_sub),
                  static_cast<unsigned>((m + BN - 1) / BN));
  bsr_spmm_kernel<T, TM><<<grid, THREADS, 0, st>>>(blocks, bcols, tptr, br, bc,
                                                   n_sub, n_rows, n_cols, m, B, Y);
}

template <typename T>
int launch(const void* blocks, const void* block_cols, const void* tile_ptr,
           int n_rb, int br, int bc, int64_t n_rows, int64_t n_cols, int64_t m,
           const void* B, void* Y, void* stream) {
  if (br <= 0 || br % 8 || bc <= 0 || bc % KChunk<T>::value || n_rb <= 0 || m <= 0 ||
      (m + BN - 1) / BN > 65535 || static_cast<int64_t>(n_rb) * (br / 8) > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* a = static_cast<const T*>(blocks);
  const int* c = static_cast<const int*>(block_cols);
  const int* p = static_cast<const int*>(tile_ptr);
  const T* b = static_cast<const T*>(B);
  T* y = static_cast<T*>(Y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (br % 64 == 0)
    launch_tm<T, 8>(a, c, p, n_rb, br, bc, n_rows, n_cols, m, b, y, st);
  else if (br % 32 == 0)
    launch_tm<T, 4>(a, c, p, n_rb, br, bc, n_rows, n_cols, m, b, y, st);
  else if (br % 16 == 0)
    launch_tm<T, 2>(a, c, p, n_rb, br, bc, n_rows, n_cols, m, b, y, st);
  else
    launch_tm<T, 1>(a, c, p, n_rb, br, bc, n_rows, n_cols, m, b, y, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* smt_bsr_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// blocks: (T, br, bc); block_cols: (T,) int32; tile_ptr: (n_rb + 1,) int32;
// B: (n_cols, m) row-major; Y: (n_rows, m) row-major, fully written.
int smt_bsr_spmm_f32(const void* blocks, const void* block_cols,
                     const void* tile_ptr, int n_rb, int br, int bc,
                     int64_t n_rows, int64_t n_cols, int64_t m, const void* B,
                     void* Y, void* stream) {
  return launch<float>(blocks, block_cols, tile_ptr, n_rb, br, bc, n_rows,
                       n_cols, m, B, Y, stream);
}

int smt_bsr_spmm_f64(const void* blocks, const void* block_cols,
                     const void* tile_ptr, int n_rb, int br, int bc,
                     int64_t n_rows, int64_t n_cols, int64_t m, const void* B,
                     void* Y, void* stream) {
  return launch<double>(blocks, block_cols, tile_ptr, n_rb, br, bc, n_rows,
                        n_cols, m, B, Y, stream);
}

}  // extern "C"
