// RouteStream SpMV kernel for Hopper (sm_90a): y = A @ x as one
// nnz-balanced (merge-path) CSR SpMV over the RouteStream's compact plan,
// bound to Python with ctypes through the plain C functions at the end of
// this file.
//
// Replaces sparsemat_tpu/kernels/route.py: route_gather_pallas (:102) and
// route_reduce_pallas (:198), the two kernels route_spmv_pallas (:271)
// launches.  On the TPU the gather routes every product a_vals * x through
// three lane gathers and two transposes into a staging buffer, and the
// reduce permutes it back and takes segment sums as differences of a lane
// prefix sum on the MXU, because Mosaic has no sublane gather.  A GPU thread
// gathers x directly, so this kernel reads none of those tables: it walks
// the plan kernels/_rowgroup.py builds from RouteStream.to_coo at groups of
// one row, which is the matrix's CSR (row_ptr = grp_ptr; the entries'
// columns and values in row order; padding slots dropped, stored zeros
// kept).  The frozen layout stays bit-equal to the JAX freeze.
//
// What bounds it on an H100: bytes.  It needs the CSR, x and y, each read
// or written once (9.43 MB on the 170,998-row circuit operator, 0.0028 ms
// at 3.35 TB/s); x (684 KB there) is gathered from L2.  What stands in the
// way is the spread of row lengths: on that operator the median row holds
// 2 entries and the longest 3,751, so a split by rows leaves a few warps
// walking long rows while most hold almost nothing.  This kernel splits
// the work by items instead.
//
// Design (Merrill & Garland, "Merge-based Parallel Sparse Matrix-Vector
// Multiplication", SC16):
//   * the merge of the row ends with the entries (n_rows + nnz items, a
//     row's end after its last entry) is cut into tiles of tile_items items,
//     one CTA each; the split (_rowgroup.MergeSplit, built once per matrix)
//     gives each tile its start (row, entry), so a CTA loads its bounds and
//     searches nothing across tiles;
//   * the CTA copies its tile's row ends, column indices and values into
//     shared memory with cp.async.  The copies are 4 or 8 bytes a thread,
//     not 16: a tile starts at any entry, so 16-byte copies would need a
//     ragged head and tail.  Neighbouring threads copy neighbouring
//     elements (coalesced), and all copies are in flight before one wait,
//     with no round trip through registers.  Then thread tid multiplies
//     entries tid, tid + 256, ... by x at their columns, in place, its
//     gathers unrolled so that up to 8 are in flight;
//   * each thread takes ipt = ceil(tile_items / 256) consecutive merge items,
//     finds its start by a binary search over the tile's row ends in shared
//     memory, and walks them: an entry adds its product to the running sum,
//     a row end closes the row.  A row the thread holds from its first item
//     is written directly (an empty row as 0).  The sums of the row each
//     thread leaves open are combined by a segmented inclusive scan keyed by
//     row (Hillis-Steele in shared memory), which the first row each thread
//     closes takes as its carry.  So every thread holds the same number of
//     items, however the rows spread;
//   * a row whose items lie in several tiles (the split lists it) gets one
//     partial per tile; the tile that arrives last (a ticket counter per
//     row) adds them in tile order, writes y once and resets its counter to
//     0 for the next launch, so the wrapper launches no zeroing.  Values
//     never meet an atomic, so reruns are bitwise equal.  Every sum is taken
//     in a fixed order, which route_spmv_walk (kernels/route.py) replays;
//   * no padding slot exists in the plan, so where x holds inf or NaN the
//     answer is the CSR product's (a stored zero still gives 0 * inf = NaN);
//   * shared memory is sized by tile_items and stays under 48 KB (46,080
//     bytes at 2,048 items in f64), so no launch sets a function attribute.
//     One launch per SpMV, no memset;
//   * no tensor cores: 2 flops per 8-12 bytes is far under the ridge.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 256;                // per CTA (_rowgroup.MERGE_THREADS)
constexpr int MAX_ITEMS = 2048;             // merge items a tile may hold (MERGE_MAX_ITEMS)
constexpr int MAX_IPT = MAX_ITEMS / THREADS;

// Dynamic shared memory of a tile of `items` items: row ends (int64) and
// values, then the scan's two buffers of sums (T), then columns and the
// scan's rows (int).
template <typename T>
size_t smem_bytes(int items) {
  return static_cast<size_t>(items) * (sizeof(int64_t) + sizeof(T) + sizeof(int)) +
         THREADS * (2 * sizeof(T) + sizeof(int));
}

// Tile `tile`'s partial of spanning row s; the tile that arrives last adds
// the row's partials in tile order, writes y and resets the counter.
template <typename T>
__device__ void add_partial(const int* __restrict__ span, int s, int tile, T value,
                            T* __restrict__ partial, unsigned* __restrict__ tickets,
                            T* __restrict__ y) {
  const int row = __ldg(span + 4 * s);
  const int first = __ldg(span + 4 * s + 1);
  const int count = __ldg(span + 4 * s + 2);
  const int64_t p0 = __ldg(span + 4 * s + 3);
  partial[p0 + (tile - first)] = value;
  __threadfence();  // the partial is visible before the ticket is taken
  if (atomicAdd(tickets + s, 1u) != static_cast<unsigned>(count - 1)) return;
  __threadfence();
  T sum = T(0);
  for (int k = 0; k < count; ++k) sum += __ldcg(partial + p0 + k);
  y[row] = sum;
  tickets[s] = 0u;  // every tile of the row has arrived
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
route_spmv_kernel(const int64_t* __restrict__ row_ptr, const int* __restrict__ cols,
                  const T* __restrict__ vals, const int64_t* __restrict__ starts,
                  const int* __restrict__ tile_span, const int* __restrict__ span,
                  int tile_items, const T* __restrict__ x, T* __restrict__ y,
                  T* __restrict__ partial, unsigned* __restrict__ tickets) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* s_end = reinterpret_cast<int64_t*>(smem);   // row_ptr[r0 + 1 + k]
  T* s_val = reinterpret_cast<T*>(s_end + tile_items);  // values, then products
  T* s_sum = s_val + tile_items;                         // [2][THREADS]
  int* s_col = reinterpret_cast<int*>(s_sum + 2 * THREADS);
  int* s_row = s_col + tile_items;                       // [THREADS]

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t r0 = __ldg(starts + 2 * tile);
  const int64_t e0 = __ldg(starts + 2 * tile + 1);
  const int n_r = static_cast<int>(__ldg(starts + 2 * tile + 2) - r0);  // row ends in the tile
  const int n_e = static_cast<int>(__ldg(starts + 2 * tile + 3) - e0);  // entries in the tile
  const int len = n_r + n_e;

  // 1. the tile's row ends, columns and values into shared memory
  for (int k = tid; k < n_r; k += THREADS)
    __pipeline_memcpy_async(s_end + k, row_ptr + r0 + 1 + k, sizeof(int64_t));
  for (int k = tid; k < n_e; k += THREADS) {
    __pipeline_memcpy_async(s_col + k, cols + e0 + k, sizeof(int));
    __pipeline_memcpy_async(s_val + k, vals + e0 + k, sizeof(T));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // 2. each entry's product, in place
  {
    T xv[MAX_IPT];
#pragma unroll
    for (int q = 0; q < MAX_IPT; ++q) {
      const int k = tid + q * THREADS;
      xv[q] = k < n_e ? __ldg(x + s_col[k]) : T(0);
    }
#pragma unroll
    for (int q = 0; q < MAX_IPT; ++q) {
      const int k = tid + q * THREADS;
      if (k < n_e) s_val[k] = s_val[k] * xv[q];
    }
  }
  __syncthreads();

  // 3. this thread's items [d, d_end): i row ends and j entries lie before d
  const int ipt = (tile_items + THREADS - 1) / THREADS;
  const int d = min(tid * ipt, len);
  const int d_end = min(d + ipt, len);
  int lo = max(0, d - n_e);
  int hi = min(d, n_r);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_end[mid] - e0 + mid < d)
      lo = mid + 1;
    else
      hi = mid;
  }
  int i = lo;
  int j = d - lo;
  T run = T(0);
  T first_sum = T(0);
  int first_row = -1;  // the first row this thread closes: it may carry a sum
  for (int k = d; k < d_end; ++k) {
    if (i < n_r && s_end[i] - e0 <= j) {  // row i's end: all its entries are in
      if (first_row < 0) {
        first_row = i;
        first_sum = run;
      } else {
        y[r0 + i] = run;  // held from its first item
      }
      run = T(0);
      ++i;
    } else {
      run += s_val[j];
      ++j;
    }
  }

  // 4. segmented inclusive scan of the open rows' sums, keyed by row (the
  // rows are non-decreasing in tid, so equal keys are contiguous)
  s_row[tid] = i;
  s_sum[tid] = run;
  __syncthreads();
  const int n_active = (len + ipt - 1) / ipt;  // threads that hold items
  int buf = 0;
  for (int off = 1; off < n_active; off <<= 1) {
    T v = s_sum[buf * THREADS + tid];
    if (tid >= off && s_row[tid - off] == i) v = s_sum[buf * THREADS + tid - off] + v;
    s_sum[(buf ^ 1) * THREADS + tid] = v;
    buf ^= 1;
    __syncthreads();
  }
  const T* scan = s_sum + buf * THREADS;

  // 5. the first row each thread closes, with the sums of the threads before
  // it; a row begun in an earlier tile gives this tile's partial instead
  if (first_row >= 0) {
    T v = first_sum;
    if (tid > 0 && s_row[tid - 1] == first_row) v = scan[tid - 1] + v;
    const int s = first_row == 0 ? __ldg(tile_span + 2 * tile) : -1;
    if (s >= 0)
      add_partial(span, s, tile, v, partial, tickets, y);
    else
      y[r0 + first_row] = v;
  }
  // the row the tile leaves open: its partial from this tile
  if (tid == n_active - 1) {
    const int s = __ldg(tile_span + 2 * tile + 1);
    if (s >= 0) add_partial(span, s, tile, scan[tid], partial, tickets, y);
  }
}

template <typename T>
int launch(const void* row_ptr, const void* cols, const void* vals, const void* starts,
           const void* tile_span, const void* span, int64_t n_tiles, int tile_items,
           const void* x, void* y, void* partial, void* tickets, void* stream) {
  if (n_tiles <= 0 || n_tiles > 0x7fffffff || tile_items < 1 || tile_items > MAX_ITEMS)
    return static_cast<int>(cudaErrorInvalidValue);
  route_spmv_kernel<T><<<static_cast<unsigned>(n_tiles), THREADS, smem_bytes<T>(tile_items),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(row_ptr), static_cast<const int*>(cols),
      static_cast<const T*>(vals), static_cast<const int64_t*>(starts),
      static_cast<const int*>(tile_span), static_cast<const int*>(span), tile_items,
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<T*>(partial),
      static_cast<unsigned*>(tickets));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* smt_route_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// row_ptr: (n_rows + 1,) int64; cols: (nnz,) int32; vals: (nnz,) T; starts:
// (n_tiles + 1, 2) int64, each tile's first (row, entry) and the end;
// tile_span: (n_tiles, 2) int32, the spanning row open at a tile's start and
// at its end, or -1; span: (spanning rows, 4) int32 (row, first tile, tile
// count, first partial slot); partial: (partial slots,) T scratch, or null
// where no row spans tiles; tickets: (spanning rows,) unsigned, zero at
// launch and left zero; y: (n_rows,) T, every row written.
int smt_route_spmv_f32(const void* row_ptr, const void* cols, const void* vals,
                       const void* starts, const void* tile_span, const void* span,
                       int64_t n_tiles, int tile_items, const void* x, void* y, void* partial,
                       void* tickets, void* stream) {
  return launch<float>(row_ptr, cols, vals, starts, tile_span, span, n_tiles, tile_items, x, y,
                       partial, tickets, stream);
}

int smt_route_spmv_f64(const void* row_ptr, const void* cols, const void* vals,
                       const void* starts, const void* tile_span, const void* span,
                       int64_t n_tiles, int tile_items, const void* x, void* y, void* partial,
                       void* tickets, void* stream) {
  return launch<double>(row_ptr, cols, vals, starts, tile_span, span, n_tiles, tile_items, x, y,
                        partial, tickets, stream);
}

}  // extern "C"
