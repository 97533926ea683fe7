// Row-group SpMV kernel for Hopper (sm_90a): y = A @ x over the compact
// launch plan of a WELL, SlabELL, SlabPack, StripELL or SlabStream
// (kernels/_rowgroup.py, the plan the row-group SpMM of csrc/spmm.cu walks
// too), bound to Python with ctypes through the plain C functions at the end
// of this file.
//
// Replaces sparsemat_tpu/kernels/spmv.py: well_spmv_pallas (:50, one grid
// step per (8 x K) WELL tile over a 128-column x window), slab_spmv_pallas
// (:165, the SlabELL (C, rb) slot tiles over resident x windows),
// slab_pack_spmv_pallas (:271, one call per class part, a static block
// permutation, the overflow pack's product added on top) and
// slab_stream_spmv_pallas (:320, the (8 x rb) chunk stream summed into each
// chunk's row block); and sparsemat_tpu/kernels/strip.py:
// strip_part_spmv_pallas (:42, one call per class part over xT tiles, then
// the static block permutation of _combine).
//
// The plan holds exactly the matrix's entries: no padding slots, no dummy
// tiles, every part and overflow level in one.  Rows are cut into groups of
// G <= 8 consecutive rows; group g owns the union columns u in
// [grp_ptr[g], grp_ptr[g+1]), sorted, each with its column cols[u], a mask
// (bit i set where row g*G + i has an entry there) and one value per row
// of the group, vals[i*U + u].  For row r = g*G + i:
//   y[r] = sum over u of the group, bit i of mask[u] set: vals[i*U + u] * x[cols[u]]
// A masked-off term is skipped, not multiplied by zero: for an x holding
// inf or NaN the result is what a CSR SpMV gives (a stored zero still gives
// 0 * inf = NaN).
//
// What bounds it on an H100: the bytes of the plan.  Per union column it
// reads a 4-byte column, a 1-byte mask (none at G = 1, where every union
// column is its row's entry) and G values, and gathers x once for all G
// rows; x (under 1 MB on the FEM and circuit operators) stays in L2.  That
// is 63.2 MB on the 217,920-row FEM operator (G = 3) and about 9 MB on the
// 170,998-row circuit operator (G = 1), against 289-1,202 MB (StripELL,
// SlabStream, SlabPack, SlabELL) and 526 MB (WELL) of the padded layouts
// the TPU kernels stream.
// What stands in the way is the spread of row lengths: the circuit
// operator's heaviest rows hold thousands of entries beside a mean of 5.6.
//
// Design:
//   * the wrapper's split (SpmvSplit, once per plan) gives each group one
//     sub-warp of L lanes (4, 8, 16 or 32: one pass of UNROLL loads a lane
//     covers a group of the mean length), and cuts a group of more than
//     2 * UNROLL * L union columns into segments of at most that many, one
//     sub-warp each, so no lane walks a long row alone;
//   * lane j takes the union columns j, j + L, ... of its segment: its
//     column, mask and G value loads are coalesced across the lanes, and a
//     pass keeps UNROLL gathers of x in flight before its FMAs;
//   * the G sums are reduced over the L lanes by __shfl_xor_sync in a fixed
//     butterfly order, after which every lane holds them;
//   * a group of one segment writes its G rows directly (an empty group
//     writes zeros); a group of several writes one G-row partial per
//     segment, and the segment that arrives last (a ticket counter) sums
//     them in segment order, writes y once and resets the counter to 0 for
//     the next launch, so the wrapper launches no zeroing.  Values never
//     meet an atomic, so reruns are bitwise equal;
//   * no tensor cores: 2 flops per 9-17 bytes is far under the ridge.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;  // per CTA: 256 / L sub-warps
constexpr int UNROLL = 4;     // union columns a lane loads per pass

template <typename T, int G>
__global__ void __launch_bounds__(THREADS)
rowgroup_spmv_kernel(const int* __restrict__ cols, const uint8_t* __restrict__ mask,
                     const T* __restrict__ vals, int64_t n_union,
                     const int64_t* __restrict__ seg_ptr, const int* __restrict__ seg_tag,
                     const int* __restrict__ multi, int64_t n_seg, int lanes, int64_t n_rows,
                     const T* __restrict__ x, T* __restrict__ y, T* __restrict__ partial,
                     unsigned* __restrict__ tickets) {
  const int lane = threadIdx.x & (lanes - 1);
  const int64_t s = static_cast<int64_t>(blockIdx.x) * (THREADS / lanes) + threadIdx.x / lanes;
  if (s >= n_seg) return;  // whole sub-warps leave together
  // the lanes of this sub-warp within its warp
  const unsigned sub = lanes == 32 ? 0xffffffffu
                                   : ((1u << lanes) - 1u) << ((threadIdx.x & 31) & ~(lanes - 1));
  const int64_t u1 = __ldg(seg_ptr + s + 1);

  T acc[G];
#pragma unroll
  for (int i = 0; i < G; ++i) acc[i] = T(0);
  for (int64_t base = __ldg(seg_ptr + s) + lane; base < u1;
       base += static_cast<int64_t>(lanes) * UNROLL) {
    int c[UNROLL];
    unsigned bits[UNROLL];
    T v[UNROLL][G];
    T xv[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int64_t u = base + static_cast<int64_t>(k) * lanes;
      const bool in = u < u1;
      c[k] = in ? __ldg(cols + u) : 0;
      if constexpr (G == 1)
        bits[k] = in ? 1u : 0u;
      else
        bits[k] = in ? static_cast<unsigned>(__ldg(mask + u)) : 0u;
#pragma unroll
      for (int i = 0; i < G; ++i) v[k][i] = in ? __ldg(vals + i * n_union + u) : T(0);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) xv[k] = bits[k] ? __ldg(x + c[k]) : T(0);
#pragma unroll
    for (int k = 0; k < UNROLL; ++k)
#pragma unroll
      for (int i = 0; i < G; ++i)
        if (bits[k] >> i & 1u) acc[i] = fma(v[k][i], xv[k], acc[i]);
  }
  for (int off = 1; off < lanes; off <<= 1)
#pragma unroll
    for (int i = 0; i < G; ++i) acc[i] += __shfl_xor_sync(sub, acc[i], off, lanes);

  const int tag = __ldg(seg_tag + s);
  if (tag >= 0) {  // the group's only segment
    const int64_t r0 = static_cast<int64_t>(tag) * G;
#pragma unroll
    for (int i = 0; i < G; ++i)
      if ((i & (lanes - 1)) == lane && r0 + i < n_rows) y[r0 + i] = acc[i];
    return;
  }
  const int m = -1 - tag;
  const int g = __ldg(multi + 4 * m);
  const int first = __ldg(multi + 4 * m + 1);
  const int count = __ldg(multi + 4 * m + 2);
  const int64_t pfirst = __ldg(multi + 4 * m + 3);
  unsigned ticket = 0;
  if (lane == 0) {
    T* p = partial + (pfirst + (s - first)) * G;
#pragma unroll
    for (int i = 0; i < G; ++i) p[i] = acc[i];
    __threadfence();  // the partial is visible before the ticket is taken
    ticket = atomicAdd(tickets + m, 1u);
  }
  ticket = __shfl_sync(sub, ticket, 0, lanes);
  if (ticket != static_cast<unsigned>(count - 1)) return;  // not the last segment
  __threadfence();
  for (int i = lane; i < G; i += lanes) {
    const int64_t row = static_cast<int64_t>(g) * G + i;
    if (row >= n_rows) break;
    T sum = T(0);
    for (int j = 0; j < count; ++j) sum += __ldcg(partial + (pfirst + j) * G + i);
    y[row] = sum;
  }
  if (lane == 0) tickets[m] = 0u;  // every segment of the group has arrived
}

template <typename T, int G>
void launch_g(const int* cols, const uint8_t* mask, const T* vals, int64_t n_union,
              const int64_t* seg_ptr, const int* seg_tag, const int* multi, int64_t n_seg,
              int lanes, int64_t n_rows, const T* x, T* y, T* partial, unsigned* tickets,
              unsigned grid, cudaStream_t st) {
  rowgroup_spmv_kernel<T, G><<<grid, THREADS, 0, st>>>(cols, mask, vals, n_union, seg_ptr,
                                                       seg_tag, multi, n_seg, lanes, n_rows, x,
                                                       y, partial, tickets);
}

template <typename T>
int launch(const void* cols, const void* mask, const void* vals, int64_t n_union,
           const void* seg_ptr, const void* seg_tag, const void* multi, int64_t n_seg, int group,
           int lanes, int64_t n_rows, const void* x, void* y, void* partial, void* tickets,
           void* stream) {
  if (n_seg <= 0 || n_rows <= 0 || group < 1 || group > 8 ||
      (lanes != 4 && lanes != 8 && lanes != 16 && lanes != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t grid = (n_seg + THREADS / lanes - 1) / (THREADS / lanes);
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto* c = static_cast<const int*>(cols);
  const auto* k = static_cast<const uint8_t*>(mask);
  const auto* v = static_cast<const T*>(vals);
  const auto* sp = static_cast<const int64_t*>(seg_ptr);
  const auto* tg = static_cast<const int*>(seg_tag);
  const auto* mu = static_cast<const int*>(multi);
  const auto* xx = static_cast<const T*>(x);
  auto* yy = static_cast<T*>(y);
  auto* p = static_cast<T*>(partial);
  auto* tk = static_cast<unsigned*>(tickets);
  const auto gr = static_cast<unsigned>(grid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SMT_SPMV_G(NG)                                                                  \
  case NG:                                                                              \
    launch_g<T, NG>(c, k, v, n_union, sp, tg, mu, n_seg, lanes, n_rows, xx, yy, p, tk, gr, \
                    st);                                                                \
    break;
  switch (group) {
    SMT_SPMV_G(1)
    SMT_SPMV_G(2)
    SMT_SPMV_G(3)
    SMT_SPMV_G(4)
    SMT_SPMV_G(5)
    SMT_SPMV_G(6)
    SMT_SPMV_G(7)
    SMT_SPMV_G(8)
  }
#undef SMT_SPMV_G
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* smt_spmv_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// cols: (n_union,) int32 < n_cols; mask: (n_union,) uint8; vals: (group,
// n_union) T; seg_ptr: (n_seg + 1,) int64; seg_tag: (n_seg,) int32, the
// group of a group's only segment or -1 - k for a segment of the k-th group
// of several; multi: (groups of several, 4) int32 (group, first segment,
// segment count, first partial slot); partial: (partial slots * group,) T
// scratch, or null where no group has several segments; tickets: (groups
// of several,) unsigned, zero at launch and left zero; y: (n_rows,) T,
// every row written.
int smt_rowgroup_spmv_f32(const void* cols, const void* mask, const void* vals, int64_t n_union,
                          const void* seg_ptr, const void* seg_tag, const void* multi,
                          int64_t n_seg, int group, int lanes, int64_t n_rows, const void* x,
                          void* y, void* partial, void* tickets, void* stream) {
  return launch<float>(cols, mask, vals, n_union, seg_ptr, seg_tag, multi, n_seg, group, lanes,
                       n_rows, x, y, partial, tickets, stream);
}

int smt_rowgroup_spmv_f64(const void* cols, const void* mask, const void* vals, int64_t n_union,
                          const void* seg_ptr, const void* seg_tag, const void* multi,
                          int64_t n_seg, int group, int lanes, int64_t n_rows, const void* x,
                          void* y, void* partial, void* tickets, void* stream) {
  return launch<double>(cols, mask, vals, n_union, seg_ptr, seg_tag, multi, n_seg, group, lanes,
                        n_rows, x, y, partial, tickets, stream);
}

}  // extern "C"
