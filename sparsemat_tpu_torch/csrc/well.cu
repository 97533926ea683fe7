// WELL SpMV kernel for Hopper (sm_90a), bound to Python with ctypes through
// the plain C functions at the end of this file.
//
// Replaces sparsemat_tpu/kernels/spmv.py: well_spmv_pallas (one grid step
// per (8 x K) tile, the tile's 128-column x window loaded as a (1, 1, 128)
// block, a 128-lane take_along_axis gather, the product summed into the
// tile's 8-row output block, which the first tile of each row block zeroes).
//
// For each row block b and row r < 8:
//   y[8b + r] = sum over tiles t with tile_rows[t] = b, sum over k < K of
//               vals[t,r,k] * x[tile_wins[t] * 128 + lidx[t,r,k]]
// A column >= n_cols reads 0 (the JAX package's zero-padded x windows); rows
// >= n_rows are dropped; the duplicate "overflow" tiles of a row block add
// like any other.
//
// What the TPU kernel needed and this one does not: the tile stream cut
// into `chunks` whose scalar-prefetch arrays fit in SMEM (one pallas_call
// each); K padded to 128 lanes in registers for Mosaic's take_along_axis; x
// carried as (n_win, 1, 128) blocks; the first-visit zeroing of a revisited
// output block.  A GPU thread gathers x directly with a bound check.
//
// What bounds it on an H100: it streams vals and lidx once (8 bytes a slot
// in f32, padding included: 1.4% of the circuit operator's slots hold
// entries) and gathers x at random 128-column windows; x (684 KB on the
// circuit operator) stays in L2.  Bound: (vals + lidx + x + y) bytes over
// 3.35 TB/s, about 0.157 ms on the circuit operator.  What stands in the
// way is the spread of tiles per row block: 31.6 on average on the circuit
// operator, 1,276 in its heaviest block, so one warp per row block would
// leave the heaviest block's serial walk as the kernel's time.
//
// Design (simple and right; staging x windows in shared memory is later
// work):
//   * the wrapper's plan cuts each row block's tiles (in row-block order,
//     so a segment's slots are one contiguous run of vals / lidx) into
//     segments of at most SEG_SLOTS slots; a row block with no tiles gets
//     one empty segment, so every row is written;
//   * one warp per segment, four segments per CTA; four lanes per tile
//     row, each walking every fourth slot of its row with four slots in
//     flight (loads first, then the gathers of x, then the FMAs): a
//     lane's row is fixed, so it keeps one sum, and the tile's 8 x K
//     slots (384 bytes at K = 12) are read whole from L1 after the first
//     touch.  Striding the lanes over the flat slots instead would cost
//     two integer divisions and eight predicated FMAs a slot: instruction
//     time on the order of the bytes' time.
//   * each row's four lane sums are reduced by shuffles in a fixed order.
//     A row block of one segment (most of them) has its rows written by
//     their first lanes.  A row block of several writes one 8-row partial
//     per segment; the warp that finishes last (a ticket counter, zeroed per
//     launch by the wrapper) sums them in segment order and writes y once.
//     The counter orders the work and never carries a value, so reruns
//     are bitwise equal.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ROW_BLOCK = 8;
constexpr int WINDOW = 128;
constexpr int WARPS = 4;          // segments per CTA
constexpr int LANES_PER_ROW = 4;  // 8 tile rows x 4 lanes = one warp
constexpr int UNROLL = 4;         // slots a lane keeps in flight

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
well_spmv_kernel(const T* __restrict__ vals, const int* __restrict__ lidx,
                 const int* __restrict__ tile_wins, const int64_t* __restrict__ seg_ptr,
                 const int* __restrict__ seg_block, const int* __restrict__ seg_multi,
                 const int* __restrict__ multi_first, const int* __restrict__ multi_count,
                 int64_t n_seg, int k, int64_t n_rows, int64_t n_cols,
                 const T* __restrict__ x, T* __restrict__ y, T* __restrict__ partial,
                 unsigned* __restrict__ tickets) {
  const int lane = threadIdx.x & 31;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (s >= n_seg) return;  // uniform across the warp
  const int row = lane / LANES_PER_ROW;  // the tile row this lane sums
  const int kk = lane % LANES_PER_ROW;   // its first slot in the row
  const int64_t slots = static_cast<int64_t>(ROW_BLOCK) * k;
  const int64_t t1 = __ldg(seg_ptr + s + 1);

  T acc = T(0);
  for (int64_t t = __ldg(seg_ptr + s); t < t1; ++t) {
    const int64_t base = t * slots + static_cast<int64_t>(row) * k;
    const int64_t wcol = static_cast<int64_t>(__ldg(tile_wins + t)) * WINDOW;
    for (int k0 = kk; k0 < k; k0 += LANES_PER_ROW * UNROLL) {
      T v[UNROLL];
      int64_t col[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int kj = k0 + u * LANES_PER_ROW;
        v[u] = kj < k ? __ldg(vals + base + kj) : T(0);
        col[u] = kj < k ? wcol + __ldg(lidx + base + kj) : n_cols;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const T xv = col[u] < n_cols ? __ldg(x + col[u]) : T(0);
        acc = fma(v[u], xv, acc);
      }
    }
  }
  // the row's sum over its LANES_PER_ROW lanes, in a fixed butterfly order
#pragma unroll
  for (int off = 1; off < LANES_PER_ROW; off <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);

  const int64_t b = __ldg(seg_block + s);
  const int m = __ldg(seg_multi + s);
  if (m < 0) {  // the row block's only segment
    const int64_t r = b * ROW_BLOCK + row;
    if (kk == 0 && r < n_rows) y[r] = acc;
    return;
  }
  T rows[ROW_BLOCK];
#pragma unroll
  for (int q = 0; q < ROW_BLOCK; ++q)
    rows[q] = __shfl_sync(0xffffffffu, acc, q * LANES_PER_ROW);
  unsigned ticket = 0;
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < ROW_BLOCK; ++q) partial[s * ROW_BLOCK + q] = rows[q];
    __threadfence();  // the partial is visible before the ticket is taken
    ticket = atomicAdd(tickets + m, 1u);
  }
  ticket = __shfl_sync(0xffffffffu, ticket, 0);
  const int count = __ldg(multi_count + m);
  if (ticket != static_cast<unsigned>(count - 1)) return;  // not the last segment
  __threadfence();
  const int64_t r = b * ROW_BLOCK + lane;
  if (lane < ROW_BLOCK && r < n_rows) {
    const int64_t first = __ldg(multi_first + m);
    T sum = T(0);
    for (int j = 0; j < count; ++j) sum += __ldcg(partial + (first + j) * ROW_BLOCK + lane);
    y[r] = sum;
  }
}

template <typename T>
int launch(const void* vals, const void* lidx, const void* tile_wins, const void* seg_ptr,
           const void* seg_block, const void* seg_multi, const void* multi_first,
           const void* multi_count, int64_t n_seg, int k, int64_t n_rows, int64_t n_cols,
           const void* x, void* y, void* partial, void* tickets, void* stream) {
  const int64_t grid = (n_seg + WARPS - 1) / WARPS;
  if (k <= 0 || k > WINDOW || n_seg <= 0 || grid > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  well_spmv_kernel<T><<<static_cast<unsigned>(grid), WARPS * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const int*>(lidx),
      static_cast<const int*>(tile_wins), static_cast<const int64_t*>(seg_ptr),
      static_cast<const int*>(seg_block), static_cast<const int*>(seg_multi),
      static_cast<const int*>(multi_first), static_cast<const int*>(multi_count), n_seg, k,
      n_rows, n_cols, static_cast<const T*>(x), static_cast<T*>(y), static_cast<T*>(partial),
      static_cast<unsigned*>(tickets));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* smt_well_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// vals: (n_tiles, 8, k) T and lidx: (n_tiles, 8, k) int32, tiles in
// row-block order; tile_wins: (n_tiles,) int32.  Segment s covers the
// tiles [seg_ptr[s], seg_ptr[s + 1]) of row block seg_block[s];
// seg_multi[s] is -1 where that block has one segment, else the block's
// index among the blocks of several, whose segments are multi_first[m] ..
// multi_first[m] + multi_count[m] - 1.  partial: (n_seg * 8,) T scratch;
// tickets: (blocks of several,) unsigned, zero at launch.  y: (n_rows,) T,
// every row written.
int smt_well_spmv_f32(const void* vals, const void* lidx, const void* tile_wins,
                      const void* seg_ptr, const void* seg_block, const void* seg_multi,
                      const void* multi_first, const void* multi_count, int64_t n_seg, int k,
                      int64_t n_rows, int64_t n_cols, const void* x, void* y, void* partial,
                      void* tickets, void* stream) {
  return launch<float>(vals, lidx, tile_wins, seg_ptr, seg_block, seg_multi, multi_first,
                       multi_count, n_seg, k, n_rows, n_cols, x, y, partial, tickets, stream);
}

int smt_well_spmv_f64(const void* vals, const void* lidx, const void* tile_wins,
                      const void* seg_ptr, const void* seg_block, const void* seg_multi,
                      const void* multi_first, const void* multi_count, int64_t n_seg, int k,
                      int64_t n_rows, int64_t n_cols, const void* x, void* y, void* partial,
                      void* tickets, void* stream) {
  return launch<double>(vals, lidx, tile_wins, seg_ptr, seg_block, seg_multi, multi_first,
                        multi_count, n_seg, k, n_rows, n_cols, x, y, partial, tickets, stream);
}

}  // extern "C"
