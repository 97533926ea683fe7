// DIA SpMV kernels for Hopper (sm_90a), bound to Python with ctypes through
// the plain C functions at the end of this file.
//
// Replaces the three Pallas kernels of sparsemat_tpu/kernels/dia.py:
//   * dia_spmv_kernel<S, A, false, ND, V>
//                                <- _dia_spmv_pallas_impl (1-D row chunks)
//                                   and _dia_spmv_pallas_2d_impl (lane-packed
//                                   tdata).  Both compute the same y; the TPU
//                                   needed two layouts for its (8,128) tiling,
//                                   the GPU streams the row-major (n_d, n)
//                                   data with 16-byte loads.
//   * dia_spmv_kernel<S, A, true, ND, V>
//                                <- _dia_spmv_pallas_2d_impl(with_dot=True):
//                                   y and x.(Ax), finished in the same launch.
//   * dia_chain_cluster_kernel<T>
//                                <- _dia_spmv_chain_impl: x <- A^k x in one
//                                   launch of one thread-block cluster, for
//                                   a band that fits the cluster's shared
//                                   memory (the resident chain).
//   * dia_chain_kernel<T>        <- the same, for a band too large for a
//                                   cluster: a cooperative grid.
//
// y[i] = sum_d data[d*n + i] * x[i + off_d], summed in diagonal order, a
// term whose column lies outside [0, n_cols) reading zero, as the plain
// version's zero-padded x and the TPU kernel's zeroed halo give.  n_d is
// not fixed (DIA.from_csr makes one diagonal per distinct offset).
//
// The SpMV (rows 1 and 2 of PERF.md's kernel table).  What bounds it on an
// H100: device-memory bytes.  One SpMV moves (n_d + 2) * n * sizeof(S)
// bytes (every diagonal, x and y once) for 2 * n_d * n flops, far below the
// card's flops-per-byte balance; the dot adds no byte.  To stream at the
// card's rate an SM needs some 18 KB of loads in flight (3.35 TB/s times
// ~0.7 us of latency, over 132 SMs), and a kernel of one row a thread,
// each term's two 4-byte loads behind a loop and a bounds branch, holds
// 8-16 KB.  So:
//   * A persistent grid (the SMs times the CTAs an SM holds, at most the
//     tile count) walks tiles of T = 256 * V rows: CTA b takes tiles b,
//     b + gridDim.x, ...  Thread k of a tile owns its V consecutive rows.
//   * V = 16 / sizeof(S) (4 f32, 2 f64, 8 bf16/f16): a thread reads each
//     diagonal's values for its rows as one 16-byte load, and x for them as
//     one 16-byte aligned load too, issuing every load of the tile before
//     its first multiply-add (V = 1 where n_rows * sizeof(S) is not a
//     multiple of 16, so a diagonal's slice is not 16-byte aligned).
//   * An offset o = q*V + r.  A far diagonal (r = 0: the +-n of a 2-D
//     stencil when V divides n) reads x as the aligned vector at q, an L2
//     hit after its first reader.  A near one (r != 0: -1, +1) needs the
//     vectors at q and q + 1; the one at q + 1 is the next lane's vector
//     at q, taken by __shfl_down_sync (lane 31 loads its own), and the
//     values are funnel-shifted by r.  So x crosses device memory about
//     once and no interior load tests a bound.
//   * Only the tiles whose rows or x vectors reach outside the matrix (the
//     plan's edge tiles: a few at each end, and past n_cols for a
//     rectangular matrix) take the per-element bounds tests.  The sums run
//     in diagonal order with fused multiply-adds, as the one-row-a-thread
//     kernel's did, so y is that kernel's y wherever no term falls outside
//     the matrix.
//   * The diagonal counts of the repo's 1-D and 2-D bands (3, 5) are
//     compile-time, their offsets kernel parameters (the constant bank),
//     every diagonal's loads issued together; any other count loops over
//     the device array of offsets in chunks of 4 diagonals, each chunk's
//     loads issued together.  The loop took 10-59% more device time than
//     the compiled count on the same operands (PERF.md, measured by
//     scripts/torch_dia_compare.py).  Row indices are int: only the tile
//     base is int64.
//   * The dot: each thread adds acc * x[i] over its rows with the x vector
//     it already holds (offset 0), the warp reduces by __shfl_xor_sync, the
//     CTA in shared memory in warp order, and each CTA writes one partial.
//     The last CTA to finish (a __threadfence() and an atomicAdd ticket on
//     a counter) sums the gridDim.x partials in index order, writes the
//     0-d result and puts the counter back to 0.  Every order is fixed by
//     the grid, not by arrival, so reruns are bitwise equal; no host sync,
//     so the launch can be captured in a CUDA graph.  The Python wrapper
//     gives each (device, stream) its own counter and partials.
//
// Storage and accumulation types: the SpMV kernels are templated on the
// storage type S of data and x and the accumulation type A of y and the dot
// partials.  f32 and f64 accumulate in themselves; bf16 and f16 storage is
// widened to f32 on load and accumulated in f32, so y is f32, as the JAX
// package's dia_spmv computes it (accum_dtype).  Mixed operands are promoted
// by the Python wrapper before the launch; the chain runs in the
// accumulation type (f32/f64) throughout.  The chain's rows (dia_row) keep
// int64 indices and a bounds test per term.
//
// The chain: a cooperative launch (cudaLaunchCooperativeKernel) sized to the
// blocks that can be co-resident, a grid-stride row loop that writes
// ping-pong buffers in global memory, and cooperative_groups grid.sync()
// between steps.  For the latency-regime operands the chain is meant for
// (the benchmark's 10^4-row band) matrix and both buffers sit in the 50 MB
// L2, so each step is bounded by L2 bandwidth plus one grid barrier
// (a few microseconds); past L2 each step streams device memory like
// dia_spmv but saves k-1 launches.  Reads of the ping-pong buffers use
// ld.global.cg (L2, coherent across SMs): the L1 and the read-only path are
// not coherent with writes that other blocks made in the same launch.
// cudaLaunchCooperativeKernel refuses a grid that cannot be co-resident, so
// an oversized grid fails the launch instead of deadlocking at the barrier.
// Every sm_90a device has cooperative launch; where smt_dia_chain_max_blocks
// reports none, the Python wrapper raises rather than running another path.
//
// The cluster chain: what bounds a short chain is the step's latency, not
// bytes or flops (the 10^4-row, 5-diagonal band is 5*10^4 FMAs a step), and
// the grid chain pays a device-wide barrier through global memory and an L2
// round trip for every x read each step.  Here one cluster of C CTAs
// (C in {1, 2, 4, 8, 16}; 16 needs the non-portable attribute) runs the
// whole chain: CTA c owns rows [c*rows, (c+1)*rows) and keeps, in dynamic
// shared memory, its slice of every diagonal (loaded once) and two
// buffers of x over its rows and their halo, [c*rows - lo, (c+1)*rows + hi)
// for offsets in [-lo, hi], zero where a row lies outside the matrix (the
// TPU kernel's zeroed halo, and the plain version's zero-padded x).  So a
// row reads every x from its own shared memory with no bounds test:
// y[r] = sum_d data[d, r] * xbuf[r + lo + off_d], in diagonal order.  A
// row that another CTA's halo holds is pushed there, into that CTA's next
// buffer, by a store through distributed shared memory (st.shared::cluster
// at a mapa address); the target CTAs are computed, since a halo may span
// several slices.  One cluster.sync() a step makes the step's writes and
// pushes visible, and a buffer is rewritten only after the barrier that
// ends every read of it.  The last step writes `out` and pushes nothing.
//
// What sets a step's time here is latency (PERF.md, measured by
// scripts/torch_chain_probe.py): the barrier grows with the CTA's warps,
// so the plan gives a CTA few threads (rows / 4, at least 256), each
// summing 4 rows with their loads in flight together; and the step's own
// path must be short and branch-free, since at a few warps an SM each
// instruction waits on the last.  That is why x is pushed rather than
// pulled: a pull needs a bounds test, a slice test and a division per
// term.  A split barrier (interior rows between arrive and wait, three
// buffers) measured slower at every cluster size and is not kept.
// cluster.sync() compiles to MEMBAR.ALL.GPU, the cluster barrier and
// CCTL.IVALL; the membar is about a third of a step.
//
// The Python wrapper sizes the plan (rows, threads, shared bytes) and
// launches this kernel only where the band fits; a refused launch is an
// error, never another path.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace cg = cooperative_groups;

constexpr int THREADS = 256;

// Read-only load of one stored value, widened to the accumulation type.
template <typename A>
__device__ __forceinline__ A ld(const float* p) { return static_cast<A>(__ldg(p)); }
template <typename A>
__device__ __forceinline__ A ld(const double* p) { return static_cast<A>(__ldg(p)); }
template <typename A>
__device__ __forceinline__ A ld(const __nv_bfloat16* p) {
  return static_cast<A>(__bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p)))));
}
template <typename A>
__device__ __forceinline__ A ld(const __half* p) {
  return static_cast<A>(__half2float(
      __ushort_as_half(__ldg(reinterpret_cast<const unsigned short*>(p)))));
}

// x load: the chain reads buffers that other blocks write in the same launch,
// so it bypasses L1 (ld.global.cg); the chain runs in f32/f64 only.
template <typename S, typename A, bool COHERENT>
__device__ __forceinline__ A load_x(const S* p) {
  if constexpr (COHERENT) {
    return __ldcg(p);
  } else {
    return ld<A>(p);
  }
}

template <typename S, typename A, bool COHERENT>
__device__ __forceinline__ A dia_row(const S* __restrict__ data,
                                     const int64_t* __restrict__ offs, int n_d,
                                     int64_t n_rows, int64_t n_cols,
                                     const S* x, int64_t i) {
  A acc = A(0);
  for (int d = 0; d < n_d; ++d) {
    const int64_t j = i + __ldg(offs + d);
    if (j >= 0 && j < n_cols) {
      acc += ld<A>(data + static_cast<int64_t>(d) * n_rows + i) *
             load_x<S, A, COHERENT>(x + j);
    }
  }
  return acc;
}

// --- the SpMV ----------------------------------------------------------------

constexpr int SPMV_THREADS = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;
// diagonals whose loads a thread issues together: all of a compile-time
// count, the runtime count in chunks of LOOP_CHUNK
constexpr int LOOP_CHUNK = 4;

// V stored values of consecutive rows: 16 bytes when V > 1.
template <typename S, int V>
struct Vals {
  S v[V];
};

// Widen one stored value to the accumulation type.
template <typename A>
__device__ __forceinline__ A widen(float v) { return static_cast<A>(v); }
template <typename A>
__device__ __forceinline__ A widen(double v) { return static_cast<A>(v); }
template <typename A>
__device__ __forceinline__ A widen(__nv_bfloat16 v) { return static_cast<A>(__bfloat162float(v)); }
template <typename A>
__device__ __forceinline__ A widen(__half v) { return static_cast<A>(__half2float(v)); }

// c + a * b with one rounding (what nvcc contracts `c += a * b` to).
__device__ __forceinline__ float fmadd(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return __fma_rn(a, b, c); }

// V values at p: one 16-byte load (p 16-byte aligned) or, at V = 1, one
// scalar.  STREAM: read once (ld.global.cs, evict first), so the diagonals
// streaming through L2 do not push x out of it; otherwise the read-only
// path (x, read by several diagonals).
template <typename S, int V, bool STREAM>
__device__ __forceinline__ Vals<S, V> ldv(const S* p) {
  Vals<S, V> out;
  if constexpr (V * sizeof(S) == 16) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    const uint4 u = STREAM ? __ldcs(q) : __ldg(q);
    memcpy(&out, &u, 16);
  } else {
    static_assert(V == 1, "a vector of values is 16 bytes");
    if constexpr (sizeof(S) == 2) {
      const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
      const unsigned short u = STREAM ? __ldcs(q) : __ldg(q);
      memcpy(&out, &u, 2);
    } else {
      out.v[0] = STREAM ? __ldcs(p) : __ldg(p);
    }
  }
  return out;
}

// One stored value at p, widened (the edge tiles' per-element reads).
template <typename S, typename A>
__device__ __forceinline__ A ld1(const S* p) {
  return widen<A>(ldv<S, 1, false>(p).v[0]);
}

// The 16 bytes of the next lane's vector (lane 31 gets its own back).
template <typename S, int V>
__device__ __forceinline__ Vals<S, V> from_next_lane(const Vals<S, V>& a) {
  uint4 u;
  memcpy(&u, &a, 16);
  u.x = __shfl_down_sync(FULL_MASK, u.x, 1);
  u.y = __shfl_down_sync(FULL_MASK, u.y, 1);
  u.z = __shfl_down_sync(FULL_MASK, u.z, 1);
  u.w = __shfl_down_sync(FULL_MASK, u.w, 1);
  Vals<S, V> out;
  memcpy(&out, &u, 16);
  return out;
}

// out[u] = x[i + u + r] for the vectors lo = x[i ..) and hi = x[i + V ..),
// 0 < r < V; r is the same in every thread, so the branch is uniform.
template <typename S, typename A, int V, int R = 1>
__device__ __forceinline__ void funnel(const Vals<S, V>& lo, const Vals<S, V>& hi, int r,
                                       A (&out)[V]) {
  if constexpr (R < V) {
    if (r == R) {
#pragma unroll
      for (int u = 0; u < V; ++u) out[u] = widen<A>((u + R < V ? lo : hi).v[(u + R) % V]);
    } else {
      funnel<S, A, V, R + 1>(lo, hi, r, out);
    }
  }
}

// V accumulators to p (16-byte aligned when V > 1).
template <typename A, int V>
__device__ __forceinline__ void stv(A* p, const A (&v)[V]) {
  if constexpr (sizeof(A) * V >= 16) {
    constexpr int W = sizeof(A) * V / 16;
    uint4 u[W];
    memcpy(u, v, sizeof(u));
#pragma unroll
    for (int w = 0; w < W; ++w) reinterpret_cast<uint4*>(p)[w] = u[w];
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) p[u] = v[u];
  }
}

// A compile-time count of diagonals: each offset as q * V + r, 0 <= r < V,
// passed by value (the constant bank, read at no register cost).
template <int ND>
struct DiagParams {
  int64_t q[ND > 0 ? ND : 1];
  int r[ND > 0 ? ND : 1];
};

// Diagonal d's q and r: from the parameters, or (ND = 0) from the device
// array of offsets (V is a power of two: the shift is a floor division).
template <int ND, int V>
__device__ __forceinline__ void diag_qr(const DiagParams<ND>& dp, const int64_t* offs, int d,
                                        int64_t& q, int& r) {
  if constexpr (ND > 0) {
    q = dp.q[d];
    r = dp.r[d];
  } else {
    const int64_t o = __ldg(offs + d);
    q = o >> (V == 8 ? 3 : V == 4 ? 2 : V == 2 ? 1 : 0);
    r = static_cast<int>(o & (V - 1));
  }
}

// Diagonals [d0, d0 + CH) of an interior tile, for the thread whose rows
// start at xt - x (and dt - data): every load first, then the lanes'
// exchange, then the multiply-adds in diagonal order.
template <typename S, typename A, int ND, int V, int CH>
__device__ __forceinline__ void interior_chunk(const S* dt, const S* xt, int64_t n_rows,
                                               const DiagParams<ND>& dp, const int64_t* offs,
                                               int d0, int nd, int lane, A (&acc)[V]) {
  Vals<S, V> dv[CH], lo[CH], hi[CH];
  int r[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    if (d0 + c < nd) {
      int64_t q;
      diag_qr<ND, V>(dp, offs, d0 + c, q, r[c]);
      dv[c] = ldv<S, V, true>(dt + static_cast<int64_t>(d0 + c) * n_rows);
      lo[c] = ldv<S, V, false>(xt + q * V);
      if (V > 1 && r[c] != 0 && lane == 31) hi[c] = ldv<S, V, false>(xt + (q + 1) * V);
    }
  }
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    if (d0 + c < nd) {
      A xv[V];
      if constexpr (V > 1) {
        if (r[c] != 0) {
          const Vals<S, V> next = from_next_lane(lo[c]);
          if (lane != 31) hi[c] = next;
          funnel<S, A, V>(lo[c], hi[c], r[c], xv);
        } else {
#pragma unroll
          for (int u = 0; u < V; ++u) xv[u] = widen<A>(lo[c].v[u]);
        }
      } else {
        xv[0] = widen<A>(lo[c].v[0]);
      }
#pragma unroll
      for (int u = 0; u < V; ++u) acc[u] = fmadd(widen<A>(dv[c].v[u]), xv[u], acc[u]);
    }
  }
}

// Diagonal d of an edge tile: rows past n_rows and columns outside
// [0, n_cols) read zero.
template <typename S, typename A, int V>
__device__ __forceinline__ void edge_diag(const S* data, const S* x, int64_t n_rows,
                                          int64_t n_cols, int64_t i0, int d, int64_t o,
                                          A (&acc)[V]) {
  const S* dd = data + static_cast<int64_t>(d) * n_rows;
  A dv[V], xv[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int64_t i = i0 + u, j = i + o;
    dv[u] = i < n_rows ? ld1<S, A>(dd + i) : A(0);
    xv[u] = i < n_rows && j >= 0 && j < n_cols ? ld1<S, A>(x + j) : A(0);
  }
#pragma unroll
  for (int u = 0; u < V; ++u) acc[u] = fmadd(dv[u], xv[u], acc[u]);
}

// The sum of v over the CTA, the same in every thread: warps by
// __shfl_xor_sync, then the warps' sums in warp order.  Ends with a barrier,
// so `s` may be reused at once.
template <typename A>
__device__ __forceinline__ A cta_sum(A v, A* s) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL_MASK, v, m);
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  __syncthreads();
  A total = A(0);
#pragma unroll
  for (int w = 0; w < SPMV_THREADS / 32; ++w) total += s[w];
  __syncthreads();
  return total;
}

// y = A x over tiles [0, tiles) of T = SPMV_THREADS * V rows; tiles in
// [lo_tile, hi_tile) read no row past n_rows and no x outside [0, n_cols).
// DOT: x.y too (square A), into dot_out[0], by the last CTA to finish.
template <typename S, typename A, bool DOT, int ND, int V>
__global__ void __launch_bounds__(SPMV_THREADS)
dia_spmv_kernel(const S* __restrict__ data, const int64_t* __restrict__ offs, int n_d,
                const DiagParams<ND> dp, int64_t n_rows, int64_t n_cols,
                const S* __restrict__ x, A* __restrict__ y, int64_t tiles, int64_t lo_tile,
                int64_t hi_tile, A* __restrict__ partials, unsigned* __restrict__ counter,
                A* __restrict__ dot_out) {
  constexpr int64_t T = SPMV_THREADS * V;
  constexpr int CH = ND == 0 ? LOOP_CHUNK : ND;
  const int nd = ND > 0 ? ND : n_d;
  const int lane = threadIdx.x & 31;
  const int local = threadIdx.x * V;
  A dot = A(0);
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t i0 = t * T + local;
    A acc[V];
#pragma unroll
    for (int u = 0; u < V; ++u) acc[u] = A(0);
    if (t >= lo_tile && t < hi_tile) {
      const S* xt = x + i0;
      Vals<S, V> xi;
      if constexpr (DOT) xi = ldv<S, V, false>(xt);
      if constexpr (ND > 0) {
#pragma unroll
        for (int d0 = 0; d0 < ND; d0 += CH)
          interior_chunk<S, A, ND, V, CH>(data + i0, xt, n_rows, dp, offs, d0, nd, lane, acc);
      } else {
#pragma unroll 1
        for (int d0 = 0; d0 < nd; d0 += CH)
          interior_chunk<S, A, ND, V, CH>(data + i0, xt, n_rows, dp, offs, d0, nd, lane, acc);
      }
      stv<A, V>(y + i0, acc);
      if constexpr (DOT) {
#pragma unroll
        for (int u = 0; u < V; ++u) dot = fmadd(acc[u], widen<A>(xi.v[u]), dot);
      }
    } else {
      if constexpr (ND > 0) {
#pragma unroll
        for (int d = 0; d < ND; ++d)
          edge_diag<S, A, V>(data, x, n_rows, n_cols, i0, d, dp.q[d] * V + dp.r[d], acc);
      } else {
#pragma unroll 1
        for (int d = 0; d < nd; ++d)
          edge_diag<S, A, V>(data, x, n_rows, n_cols, i0, d, __ldg(offs + d), acc);
      }
#pragma unroll
      for (int u = 0; u < V; ++u) {
        if (i0 + u < n_rows) {
          y[i0 + u] = acc[u];
          if constexpr (DOT) dot = fmadd(acc[u], ld1<S, A>(x + i0 + u), dot);
        }
      }
    }
  }
  if constexpr (DOT) {
    __shared__ A s_warp[SPMV_THREADS / 32];
    __shared__ bool s_last;
    const A mine = cta_sum(dot, s_warp);
    if (threadIdx.x == 0) {
      partials[blockIdx.x] = mine;
      __threadfence();  // the partial is seen before the ticket
      s_last = atomicAdd(counter, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (s_last) {
      __threadfence();
      A p = A(0);
      for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += SPMV_THREADS)
        p += __ldcg(partials + b);
      const A total = cta_sum(p, s_warp);
      if (threadIdx.x == 0) {
        dot_out[0] = total;
        *counter = 0u;  // ready for the next launch on this stream
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dia_chain_kernel(const T* __restrict__ data, const int64_t* __restrict__ offs,
                 int n_d, int64_t n, const T* x, T* out, T* tmp, int k) {
  cg::grid_group grid = cg::this_grid();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  const T* src = x;
  for (int s = 0; s < k; ++s) {
    // the last step writes `out`, so the result never needs a copy
    T* dst = ((k - 1 - s) & 1) ? tmp : out;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
         i < n; i += stride) {
      dst[i] = dia_row<T, T, true>(data, offs, n_d, n, n, src, i);
    }
    grid.sync();
    src = dst;
  }
}

// The cluster chain's CTA size: at most 1024 threads.  A thread takes the
// rows q, q + blockDim.x, ..., CLUSTER_UNROLL at a time, so that their
// shared-memory loads are in flight together.
constexpr int CLUSTER_THREADS = 1024;
constexpr int CLUSTER_UNROLL = 4;

// Shared-memory addresses: 32-bit, of the own CTA (shared::cta) or of any
// CTA of the cluster (shared::cluster, from mapa).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t addr, double v) {
  asm volatile("st.shared::cluster.f64 [%0], %1;" ::"r"(addr), "d"(v) : "memory");
}

// One step's barrier: every CTA's writes and pushes of the step seen, every
// read of the step done.
__device__ __forceinline__ void step_barrier(cg::cluster_group& cluster) {
  cluster.sync();
}

// One CTA's view of the cluster chain.  Its x buffers cover the rows
// [r0 - lo, r0 + rows + hi): its own rows at lo .. lo + rows, the halo
// around them, zero where a row lies outside the matrix.
template <typename T>
struct ClusterCta {
  const T* s_data;     // n_d diagonal slices of `rows` values
  const int* s_shift;  // lo + offset of each diagonal: x's slot for row 0
  T* s_x;              // the two buffers, ext values each
  int n_d, rows, lo, hi, ext, r0, cnt, rank;
  int n_live;          // CTAs that own rows
  bool wide;           // a halo wider than a slice (the same in every thread)
  uint32_t below, above;  // buffer 0 of CTAs rank -+ 1 (shared::cluster)
};

// Row r's new value goes to the CTAs whose halo holds row r0 + r: those t
// with t*rows - lo <= r0 + r < (t+1)*rows + hi (the own CTA aside), at
// slot r0 + r - t*rows + lo of their next buffer `b`.  Only rows within hi
// of the slice's start (for CTAs below) or lo of its end (above) have such
// a CTA; a halo no wider than a slice reaches only the next CTA, whose
// buffer address is mapped once, and only a wider one needs the divisions.
template <typename T>
__device__ __forceinline__ void push(const ClusterCta<T>& c, int b, int r, T v) {
  const int i = c.r0 + r;
  const uint32_t buf = static_cast<uint32_t>(b * c.ext * sizeof(T));
  if (r < c.hi && c.rank > 0) {
    if (!c.wide) {
      st_cluster(c.below + buf + static_cast<uint32_t>((r + c.rows + c.lo) * sizeof(T)), v);
    } else {
      const int first = i - c.hi < 0 ? 0 : (i - c.hi) / c.rows;
#pragma unroll 1
      for (int t = first; t < c.rank; ++t)
        st_cluster(map_rank(smem_addr(c.s_x + b * c.ext + (i - t * c.rows + c.lo)), t), v);
    }
  }
  if (r >= c.rows - c.lo && c.rank + 1 < c.n_live) {
    if (!c.wide) {
      st_cluster(c.above + buf + static_cast<uint32_t>((r - c.rows + c.lo) * sizeof(T)), v);
    } else {
      const int last = min(c.n_live - 1, (i + c.lo) / c.rows);
#pragma unroll 1
      for (int t = c.rank + 1; t <= last; ++t)
        st_cluster(map_rank(smem_addr(c.s_x + b * c.ext + (i - t * c.rows + c.lo)), t), v);
    }
  }
}

// Step s over the slice: y[r] = sum over d of data[d, r] * x[r + off_d] in
// diagonal order, every x read from the own buffer s & 1.  The last step
// writes `out`; the others the next buffer and the halos of the CTAs that
// need the row.  A thread sums CLUSTER_UNROLL rows at a time, loading a
// diagonal's values and x for all of them before the multiply-adds, so the
// loads are in flight together.
template <typename T, bool LAST>
__device__ __forceinline__ void cluster_step(const ClusterCta<T>& c, int s, T* out) {
  constexpr int U = CLUSTER_UNROLL;
  const int nt = blockDim.x;
  const T* src = c.s_x + (s & 1) * c.ext;
  T* dst = c.s_x + ((s + 1) & 1) * c.ext;
#pragma unroll 1
  for (int q0 = threadIdx.x; q0 < c.cnt; q0 += U * nt) {
    // a row past the slice sums slot 0 (always there) and stores nothing,
    // so the sums have no branch
    int r[U];
    T acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + u * nt;
      r[u] = q < c.cnt ? q : 0;
      acc[u] = T(0);
    }
    for (int d = 0; d < c.n_d; ++d) {
      const T* xd = src + c.s_shift[d];
      const T* dd = c.s_data + d * c.rows;
      T dv[U], xv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) dv[u] = dd[r[u]];
#pragma unroll
      for (int u = 0; u < U; ++u) xv[u] = xd[r[u]];
#pragma unroll
      for (int u = 0; u < U; ++u) acc[u] += dv[u] * xv[u];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (q0 + u * nt >= c.cnt) break;
      if constexpr (LAST) {
        out[c.r0 + r[u]] = acc[u];
      } else {
        dst[c.lo + r[u]] = acc[u];
        push(c, (s + 1) & 1, r[u], acc[u]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(CLUSTER_THREADS)
dia_chain_cluster_kernel(const T* __restrict__ data,
                         const int64_t* __restrict__ offs, int n_d, int n,
                         int rows, int lo, int hi, const T* __restrict__ x,
                         T* __restrict__ out, int k) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  // layout: n_d diagonal slices, two x buffers of ext values, n_d shifts;
  // the same in every CTA, so one slot maps to every rank
  const int ext = rows + lo + hi;
  T* s_data = reinterpret_cast<T*>(smem);
  T* s_x = s_data + static_cast<size_t>(n_d) * rows;
  int* s_shift = reinterpret_cast<int*>(s_x + 2 * static_cast<size_t>(ext));
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const int r0 = rank * rows;
  const int cnt = max(0, min(rows, n - r0));
  const int n_live = (n - 1) / rows + 1;
  // an offset beyond +-n reaches no row, as one of +-n does (lo, hi <= n)
  for (int d = tid; d < n_d; d += nt) {
    const int64_t o = offs[d];
    s_shift[d] = lo + (o < -n ? -n : (o > n ? n : static_cast<int>(o)));
  }
  for (int d = 0; d < n_d; ++d)
    for (int r = tid; r < cnt; r += nt)
      s_data[d * rows + r] = data[static_cast<int64_t>(d) * n + r0 + r];
  // buffer 0 holds x over the slice and its halo; buffer 1 starts at zero,
  // and a slot outside the matrix stays zero in both
  for (int q = tid; q < 2 * ext; q += nt) {
    const int j = r0 - lo + q;
    s_x[q] = q < ext && j >= 0 && j < n ? x[j] : T(0);
  }
  const uint32_t base = smem_addr(s_x);
  const ClusterCta<T> c{s_data, s_shift, s_x, n_d, rows, lo, hi, ext, r0, cnt, rank,
                        n_live, lo > rows || hi > rows,
                        rank > 0 ? map_rank(base, rank - 1) : 0u,
                        rank + 1 < n_live ? map_rank(base, rank + 1) : 0u};
  cluster.sync();  // every buffer set (and every CTA running)
  for (int s = 0; s + 1 < k; ++s) {
    cluster_step<T, false>(c, s, out);
    step_barrier(cluster);
  }
  cluster_step<T, true>(c, k - 1, out);
  // The last step reads only the own buffers and pushes nothing, and every
  // push into this CTA came before a barrier that it has passed, so a CTA
  // may exit while the others finish.
}

// One launch's plan (kernels/dia.py SpmvLaunch): the instantiation
// (nd_spec: the compiled count, or 0 for the loop; vec: 16 / sizeof(S), or
// 1), the grid and the tiles, and the matrix's shape and offsets (on the
// device, and on the host for the compiled counts' parameters).
struct SpmvLaunch {
  const int64_t* offs;
  const int64_t* offs_host;
  int n_d, nd_spec, vec, grid;
  int64_t n_rows, n_cols, tiles, lo_tile, hi_tile;
};

template <typename S, typename A, bool DOT, int ND, int V>
static cudaError_t launch_spmv_at(const SpmvLaunch& p, const void* data, const void* x, void* y,
                                  void* partials, void* counter, void* dot_out,
                                  cudaStream_t st) {
  DiagParams<ND> dp = {};
  for (int d = 0; d < ND; ++d) {
    const int64_t o = p.offs_host[d];
    const int64_t q = o >= 0 ? o / V : -((-o + V - 1) / V);  // floor(o / V)
    dp.q[d] = q;
    dp.r[d] = static_cast<int>(o - q * V);
  }
  dia_spmv_kernel<S, A, DOT, ND, V><<<p.grid, SPMV_THREADS, 0, st>>>(
      static_cast<const S*>(data), p.offs, p.n_d, dp, p.n_rows, p.n_cols,
      static_cast<const S*>(x), static_cast<A*>(y), p.tiles, p.lo_tile, p.hi_tile,
      static_cast<A*>(partials), static_cast<unsigned*>(counter), static_cast<A*>(dot_out));
  return cudaGetLastError();
}

// The diagonal counts with a kernel of their own (kernels/dia.py SPECIALISED).
#define SMT_DIA_SPEC_COUNTS(X) X(3) X(5)

template <typename S, typename A, bool DOT>
static cudaError_t dispatch_spmv(const SpmvLaunch& p, const void* data, const void* x, void* y,
                                 void* partials, void* counter, void* dot_out,
                                 cudaStream_t st) {
  constexpr int VV = 16 / sizeof(S);
#define SMT_ARGS p, data, x, y, partials, counter, dot_out, st
  if (p.vec == 1 && p.nd_spec == 0) return launch_spmv_at<S, A, DOT, 0, 1>(SMT_ARGS);
  if (p.vec != VV) return cudaErrorInvalidValue;
  switch (p.nd_spec) {
    case 0: return launch_spmv_at<S, A, DOT, 0, VV>(SMT_ARGS);
#define SMT_CASE(N) \
    case N: return launch_spmv_at<S, A, DOT, N, VV>(SMT_ARGS);
    SMT_DIA_SPEC_COUNTS(SMT_CASE)
#undef SMT_CASE
    default: return cudaErrorInvalidValue;
  }
#undef SMT_ARGS
}

template <typename S, typename A, bool DOT, int ND, int V>
static cudaError_t occupancy_at(int* per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, dia_spmv_kernel<S, A, DOT, ND, V>, SPMV_THREADS, 0);
}

// CTAs of the instantiation (nd_spec, vec) that one SM holds: the fewer of
// its plain and its dot form, so both take the same grid.
template <typename S, typename A>
static cudaError_t spmv_occupancy(int nd_spec, int vec, int* per_sm) {
  constexpr int VV = 16 / sizeof(S);
  int a = 0, b = 0;
  cudaError_t e = cudaErrorInvalidValue;
  if (vec == 1 && nd_spec == 0) {
    e = occupancy_at<S, A, false, 0, 1>(&a);
    if (e == cudaSuccess) e = occupancy_at<S, A, true, 0, 1>(&b);
  } else if (vec == VV) {
    switch (nd_spec) {
#define SMT_OCC(N)                                                    \
      case N:                                                         \
        e = occupancy_at<S, A, false, N, VV>(&a);                     \
        if (e == cudaSuccess) e = occupancy_at<S, A, true, N, VV>(&b); \
        break;
      SMT_OCC(0)
      SMT_DIA_SPEC_COUNTS(SMT_OCC)
#undef SMT_OCC
      default: break;
    }
  }
  *per_sm = a < b ? a : b;
  return e;
}

template <typename T>
static int chain_max_blocks(int* max_blocks) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dia_chain_kernel<T>, THREADS, 0);
  *max_blocks = coop ? per_sm * sms : 0;
  return static_cast<int>(e);
}

template <typename T>
static int launch_chain(const void* data, const void* offs, int n_d, int64_t n,
                        const void* x, void* out, void* tmp, int k, int blocks,
                        void* stream) {
  const T* d = static_cast<const T*>(data);
  const int64_t* o = static_cast<const int64_t*>(offs);
  const T* xx = static_cast<const T*>(x);
  T* oo = static_cast<T*>(out);
  T* tt = static_cast<T*>(tmp);
  void* args[] = {&d, &o, &n_d, &n, &xx, &oo, &tt, &k};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&dia_chain_kernel<T>), dim3(blocks),
      dim3(THREADS), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// A failed runtime call leaves its error as the thread's last error, which
// the next launch check would report: return it and clear it.
static int fail(cudaError_t e) {
  cudaGetLastError();
  return static_cast<int>(e);
}

template <typename T>
static cudaError_t allow_cluster(int smem) {
  auto kern = dia_chain_cluster_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  return e;
}

static cudaLaunchConfig_t cluster_config(int cluster, int threads, int smem,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The opt-in shared memory of one CTA and the largest cluster of
// CLUSTER_THREADS-thread CTAs, each using all of it, that the device can
// place (0 if none).
template <typename T>
static int cluster_limits(int* smem_optin, int* max_cluster) {
  int dev = 0;
  *smem_optin = 0;
  *max_cluster = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = allow_cluster<T>(*smem_optin);
  if (e != cudaSuccess) return fail(e);
  for (int c = 16; c >= 1; c /= 2) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg =
        cluster_config(c, CLUSTER_THREADS, *smem_optin, 0, &attr);
    int n_clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&n_clusters, dia_chain_cluster_kernel<T>,
                                       &cfg);
    if (e != cudaSuccess) {
      cudaGetLastError();  // a size the device refuses: try the next
      continue;
    }
    if (n_clusters > 0) {
      *max_cluster = c;
      break;
    }
  }
  return 0;
}

template <typename T>
static int launch_cluster(const void* data, const void* offs, int n_d, int n,
                          int rows, int lo, int hi, const void* x, void* out,
                          int k, int cluster, int threads, int smem,
                          void* stream) {
  cudaError_t e = allow_cluster<T>(smem);
  if (e != cudaSuccess) return fail(e);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(
      cluster, threads, smem, static_cast<cudaStream_t>(stream), &attr);
  e = cudaLaunchKernelEx(&cfg, dia_chain_cluster_kernel<T>,
                         static_cast<const T*>(data),
                         static_cast<const int64_t*>(offs), n_d, n, rows, lo,
                         hi, static_cast<const T*>(x), static_cast<T*>(out), k);
  if (e != cudaSuccess) return fail(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

int smt_dia_threads() { return THREADS; }

const char* smt_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

int smt_dia_spmv_threads() { return SPMV_THREADS; }

// One SpMV (partials == NULL) or SpMV with its dot (partials: gridDim
// scratch values, counter: an unsigned 0, dot_out: the 0-d result) by the
// instantiation (plan->nd_spec, plan->vec) over the plan's tiles.  data and x
// are of the suffix's storage type; y, the partials and the dot of its
// accumulation type (f32 for bf16 and f16).  The plan is one struct, made
// once per matrix, so a call converts few arguments.
#define SMT_DIA_SPMV(SUFFIX, S, A)                                                    \
  int smt_dia_spmv_##SUFFIX(const SpmvLaunch* plan, const void* data, const void* x,      \
                            void* y, void* partials, void* counter, void* dot_out,         \
                            void* stream) {                                                \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                                   \
    cudaError_t e = partials == nullptr                                                    \
                        ? dispatch_spmv<S, A, false>(*plan, data, x, y, partials, counter, \
                                                     dot_out, st)                          \
                        : dispatch_spmv<S, A, true>(*plan, data, x, y, partials, counter,  \
                                                    dot_out, st);                          \
    return e == cudaSuccess ? 0 : fail(e);                                                 \
  }                                                                                        \
  int smt_dia_spmv_occupancy_##SUFFIX(int nd_spec, int vec, int* per_sm) {                 \
    cudaError_t e = spmv_occupancy<S, A>(nd_spec, vec, per_sm);                            \
    return e == cudaSuccess ? 0 : fail(e);                                                 \
  }

SMT_DIA_SPMV(f32, float, float)
SMT_DIA_SPMV(f64, double, double)
SMT_DIA_SPMV(bf16, __nv_bfloat16, float)
SMT_DIA_SPMV(f16, __half, float)

// Blocks of the chain kernel that can be co-resident on the current device
// (0 when the device has no cooperative launch).
int smt_dia_chain_max_blocks_f32(int* max_blocks) {
  return chain_max_blocks<float>(max_blocks);
}

int smt_dia_chain_max_blocks_f64(int* max_blocks) {
  return chain_max_blocks<double>(max_blocks);
}

int smt_dia_chain_f32(const void* data, const void* offs, int n_d, int64_t n,
                      const void* x, void* out, void* tmp, int k, int blocks,
                      void* stream) {
  return launch_chain<float>(data, offs, n_d, n, x, out, tmp, k, blocks,
                             stream);
}

int smt_dia_chain_f64(const void* data, const void* offs, int n_d, int64_t n,
                      const void* x, void* out, void* tmp, int k, int blocks,
                      void* stream) {
  return launch_chain<double>(data, offs, n_d, n, x, out, tmp, k, blocks,
                              stream);
}

int smt_dia_chain_cluster_threads() { return CLUSTER_THREADS; }

int smt_dia_chain_cluster_unroll() { return CLUSTER_UNROLL; }

#define SMT_DIA_CHAIN_CLUSTER(SUFFIX, T)                                      \
  int smt_dia_chain_cluster_limits_##SUFFIX(int* smem_optin,                 \
                                            int* max_cluster) {              \
    return cluster_limits<T>(smem_optin, max_cluster);                       \
  }                                                                          \
  int smt_dia_chain_cluster_##SUFFIX(                                        \
      const void* data, const void* offs, int n_d, int n, int rows, int lo,  \
      int hi, const void* x, void* out, int k, int cluster, int threads,     \
      int smem, void* stream) {                                              \
    return launch_cluster<T>(data, offs, n_d, n, rows, lo, hi, x, out, k,    \
                             cluster, threads, smem, stream);                \
  }

SMT_DIA_CHAIN_CLUSTER(f32, float)
SMT_DIA_CHAIN_CLUSTER(f64, double)

}  // extern "C"
