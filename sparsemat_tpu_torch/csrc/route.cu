// RouteStream SpMV kernels for Hopper (sm_90a), bound to Python with ctypes
// through the plain C functions at the end of this file.
//
// Replaces sparsemat_tpu/kernels/route.py: route_gather_pallas (kernel 1)
// and route_reduce_pallas (kernel 2).  The layout (formats/route.py) is the
// JAX package's, bit for bit; what the two kernels compute is the same:
//
//   gather:  for supertile t, split sp, arrival slot (j, l):
//              c = p3[t,sp,j,l], s = p2[t,sp,c,j], m = m1[t,sp,s,c]
//              staging[touch[t,sp,j]*128 + l] += m * prod[t, s, p1[t,sp,s,c]]
//            with prod[t, s, k] = a_vals[t*128+s, k] * x[a_win[t*128+s]*128 + a_lidx[...]]
//            (a column >= n_cols reads 0);
//   reduce:  for region R, staging row j (reduce layout), lane l:
//              c = q3[R,j,l], s = q2[R,c,j], v[j,l] = staging[R*128 + s, q1[R,s,c]]
//            and for every lane r with segmask[R,j,r] = 1:
//              y[wrow[R,j]*128 + r] += sum of v[j, k] for k in (ppos, lpos]
//            (k from 0 where pmask = 0).
//
// What the TPU kernels needed and these do not.  Mosaic has no sublane
// gather, so the TPU composes each permutation from three lane gathers and
// two transposes, and takes the segment sums as differences of a lane
// prefix sum computed by an MXU matmul.  A GPU thread reads any element of
// a tile in shared memory, so each composed permutation is one gather, and
// each segment is summed directly (the quantity the prefix difference
// computes, with less cancellation).
//
// Design (a simple pair that is right; composing the routing into one
// destination per A-slot at plan time, which would drop the four routing
// tables from every SpMV, is later work):
//   * route_gather_kernel: one CTA per (supertile, split), 1024 threads.  The
//     CTA computes its supertile's 128x128 products into shared memory
//     (64 KB in f32, 128 KB in f64), then routes the split's 16,384 arrival
//     slots.  The freeze gives every real product its own staging slot and
//     gives dummies m1 = 0, so each real slot is STORED (no atomics, no
//     read-modify-write) into a buffer the launcher zeroes on the stream;
//     the wrapper checks the one-product-per-slot invariant once per matrix.
//   * route_reduce_kernel: one CTA per 128-row y window, 8 warps.  The freeze
//     packs a window's segments into consecutive staging rows [win_lo,
//     win_hi), so the CTA owns them all: warp v takes rows win_lo + v,
//     win_lo + v + 8, ...; for each it gathers the row's reduce layout into
//     its own shared-memory row (4 lanes a thread), then each thread adds
//     the segments of its 4 lanes, keeping per-lane sums in registers.  At
//     the end the 8 warps' sums are added in warp order and each y row is
//     written once.  A matrix row of more than 128 entries (chunks on several
//     staging rows, possibly in two regions) is summed within the window in
//     that fixed order.  No atomics, so reruns are bitwise equal.  Several
//     warps per window, because each row costs a chain of four dependent
//     loads (q3, q2, q1, staging): walked by one warp, the windows that hold
//     the longest matrix rows (up to 40 staging rows on the scircuit-class
//     operator, 6.3 on average) would set the kernel's time.
//
// What bounds them on an H100.  Device-memory bytes: per SpMV the kernels
// read the values and column indices once, the four routing tables and the
// seven reduce tables once, x as a gather within 128-column windows, and
// write and read the staging buffer once (RouteStream.spmv_traffic_bytes).
// The routing reads (p2, m1, p1 at data-dependent positions) stay inside one
// 64 KB table per CTA and hit L1/L2.  On the scircuit-class operator the
// gather grid is only n_sup * n_splits (~126) CTAs, about one per SM.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int LANE = 128;                // lanes per row; rows per supertile / region
constexpr int TILE = LANE * LANE;        // slots per supertile, split or region
constexpr int GATHER_THREADS = 1024;
constexpr int REDUCE_WARPS = 8;
constexpr int LANES_PER_THREAD = LANE / 32;

template <typename T>
__global__ void __launch_bounds__(GATHER_THREADS)
route_gather_kernel(const T* __restrict__ a_vals, const int* __restrict__ a_lidx,
                    const int* __restrict__ a_win, const int* __restrict__ p1,
                    const T* __restrict__ m1, const int* __restrict__ p2,
                    const int* __restrict__ p3, const int* __restrict__ touch,
                    int n_splits, int64_t n_cols, const T* __restrict__ x,
                    T* __restrict__ staging) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* prod = reinterpret_cast<T*>(smem);
  const int64_t inst = blockIdx.x;             // supertile * n_splits + split
  const int64_t t = inst / n_splits;           // supertile
  const int64_t a0 = t * TILE;

  for (int i = threadIdx.x; i < TILE; i += GATHER_THREADS) {
    const int64_t col = static_cast<int64_t>(__ldg(a_win + t * LANE + (i >> 7))) * LANE +
                        __ldg(a_lidx + a0 + i);
    const T xv = col < n_cols ? __ldg(x + col) : T(0);
    prod[i] = __ldg(a_vals + a0 + i) * xv;
  }
  __syncthreads();

  const int64_t b = inst * TILE;
  const int* P1 = p1 + b;
  const T* M1 = m1 + b;
  const int* P2 = p2 + b;
  const int* P3 = p3 + b;
  const int* TO = touch + inst * LANE;
#pragma unroll 4
  for (int i = threadIdx.x; i < TILE; i += GATHER_THREADS) {
    const int j = i >> 7;
    const int l = i & (LANE - 1);
    const int c = __ldg(P3 + i);
    const int s = __ldg(P2 + c * LANE + j);
    const T m = __ldg(M1 + s * LANE + c);
    if (m != T(0)) {
      staging[static_cast<int64_t>(__ldg(TO + j)) * LANE + l] =
          m * prod[s * LANE + __ldg(P1 + s * LANE + c)];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(REDUCE_WARPS * 32)
route_reduce_kernel(const T* __restrict__ staging, const int* __restrict__ q1,
                    const int* __restrict__ q2, const int* __restrict__ q3,
                    const int* __restrict__ lpos, const int* __restrict__ ppos,
                    const T* __restrict__ pmask, const T* __restrict__ segmask,
                    const int* __restrict__ win_lo, const int* __restrict__ win_hi,
                    int64_t n_rows, T* __restrict__ y) {
  __shared__ T row[REDUCE_WARPS][LANE];
  __shared__ T part[REDUCE_WARPS][LANE];
  const int w = blockIdx.x;
  const int v = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g1 = __ldg(win_hi + w);
  T acc[LANES_PER_THREAD];
#pragma unroll
  for (int q = 0; q < LANES_PER_THREAD; ++q) acc[q] = T(0);

  for (int g = __ldg(win_lo + w) + v; g < g1; g += REDUCE_WARPS) {
    const int64_t rb = static_cast<int64_t>(g >> 7) * TILE;  // region's tables
    const int j = g & (LANE - 1);
#pragma unroll
    for (int q = 0; q < LANES_PER_THREAD; ++q) {
      const int l = lane + 32 * q;
      const int c = __ldg(q3 + rb + j * LANE + l);
      const int s = __ldg(q2 + rb + c * LANE + j);
      row[v][l] = __ldg(staging + rb + s * LANE + __ldg(q1 + rb + s * LANE + c));
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < LANES_PER_THREAD; ++q) {
      const int64_t e = rb + j * LANE + lane + 32 * q;
      if (__ldg(segmask + e) != T(0)) {   // the tables hold 0 or 1
        const int hi = __ldg(lpos + e);
        const int lo = __ldg(pmask + e) != T(0) ? __ldg(ppos + e) + 1 : 0;
        T seg = T(0);
        for (int k = lo; k <= hi; ++k) seg += row[v][k];
        acc[q] += seg;
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int q = 0; q < LANES_PER_THREAD; ++q) part[v][lane + 32 * q] = acc[q];
  __syncthreads();
  if (threadIdx.x < LANE) {
    T sum = T(0);
#pragma unroll
    for (int u = 0; u < REDUCE_WARPS; ++u) sum += part[u][threadIdx.x];
    const int64_t r = static_cast<int64_t>(w) * LANE + threadIdx.x;
    if (r < n_rows) y[r] = sum;
  }
}

template <typename T>
int launch_gather(const void* a_vals, const void* a_lidx, const void* a_win,
                  const void* p1, const void* m1, const void* p2, const void* p3,
                  const void* touch, int n_sup, int n_splits, int64_t n_cols,
                  const void* x, void* staging, int64_t staging_numel, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(staging, 0, static_cast<size_t>(staging_numel) * sizeof(T), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = TILE * static_cast<int>(sizeof(T));
  e = cudaFuncSetAttribute(route_gather_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = static_cast<unsigned>(n_sup) * static_cast<unsigned>(n_splits);
  route_gather_kernel<T><<<grid, GATHER_THREADS, smem, st>>>(
      static_cast<const T*>(a_vals), static_cast<const int*>(a_lidx),
      static_cast<const int*>(a_win), static_cast<const int*>(p1),
      static_cast<const T*>(m1), static_cast<const int*>(p2),
      static_cast<const int*>(p3), static_cast<const int*>(touch), n_splits, n_cols,
      static_cast<const T*>(x), static_cast<T*>(staging));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_reduce(const void* staging, const void* q1, const void* q2, const void* q3,
                  const void* lpos, const void* ppos, const void* pmask,
                  const void* segmask, const void* win_lo, const void* win_hi,
                  int n_ywin, int64_t n_rows, void* y, void* stream) {
  route_reduce_kernel<T><<<n_ywin, REDUCE_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(staging), static_cast<const int*>(q1),
      static_cast<const int*>(q2), static_cast<const int*>(q3),
      static_cast<const int*>(lpos), static_cast<const int*>(ppos),
      static_cast<const T*>(pmask), static_cast<const T*>(segmask),
      static_cast<const int*>(win_lo), static_cast<const int*>(win_hi), n_rows,
      static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* smt_route_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Tables as laid out by RouteStream: a_vals/a_lidx (n_sup*128, 128), a_win
// (n_sup*128,), p1/m1/p2/p3 (n_sup, n_splits, 128, 128), touch (n_sup,
// n_splits, 128); staging (staging_numel = (n_regions*128 + 128) * 128).
int smt_route_gather_f32(const void* a_vals, const void* a_lidx, const void* a_win,
                         const void* p1, const void* m1, const void* p2, const void* p3,
                         const void* touch, int n_sup, int n_splits, int64_t n_cols,
                         const void* x, void* staging, int64_t staging_numel, void* stream) {
  return launch_gather<float>(a_vals, a_lidx, a_win, p1, m1, p2, p3, touch, n_sup,
                              n_splits, n_cols, x, staging, staging_numel, stream);
}

int smt_route_gather_f64(const void* a_vals, const void* a_lidx, const void* a_win,
                         const void* p1, const void* m1, const void* p2, const void* p3,
                         const void* touch, int n_sup, int n_splits, int64_t n_cols,
                         const void* x, void* staging, int64_t staging_numel, void* stream) {
  return launch_gather<double>(a_vals, a_lidx, a_win, p1, m1, p2, p3, touch, n_sup,
                               n_splits, n_cols, x, staging, staging_numel, stream);
}

// q1/q2/q3/lpos/ppos/pmask/segmask (n_regions, 128, 128); win_lo/win_hi
// (n_ywin,) int32: window w's staging rows (region*128 + row) are
// [win_lo[w], win_hi[w]).
int smt_route_reduce_f32(const void* staging, const void* q1, const void* q2,
                         const void* q3, const void* lpos, const void* ppos,
                         const void* pmask, const void* segmask, const void* win_lo,
                         const void* win_hi, int n_ywin, int64_t n_rows, void* y,
                         void* stream) {
  return launch_reduce<float>(staging, q1, q2, q3, lpos, ppos, pmask, segmask, win_lo,
                              win_hi, n_ywin, n_rows, y, stream);
}

int smt_route_reduce_f64(const void* staging, const void* q1, const void* q2,
                         const void* q3, const void* lpos, const void* ppos,
                         const void* pmask, const void* segmask, const void* win_lo,
                         const void* win_hi, int n_ywin, int64_t n_rows, void* y,
                         void* stream) {
  return launch_reduce<double>(staging, q1, q2, q3, lpos, ppos, pmask, segmask, win_lo,
                               win_hi, n_ywin, n_rows, y, stream);
}

}  // extern "C"
