// The port's own copy of sparsemat_tpu/native/assembly.cc, built by
// sparsemat_tpu_torch/native/__init__.py with g++ and bound with ctypes.
//
// Native assembly runtime: incremental sparse-matrix builder.
//
// TPU-native replacement for the reference's assembly format
// (reference: src/sparsemat_indexlist.rs + src/indexlist.rs): the reference
// finds an entry by walking a linked-list-in-arrays chain per row —
// O(nnz_row) per insert (indexlist.rs:75-78).  Here an open-addressing hash
// table keyed by (row, col) gives O(1) amortized insert/lookup while three
// flat append arrays preserve the *insertion order* the reference exposes
// through its iterators (src/lib.rs:67-71 pins that order).
//
// Values are accumulated in double (covers f32/f64/int semantics at the
// Python edge).  Exposed as a C ABI consumed via ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Builder {
  // insertion-ordered entry store
  std::vector<int64_t> rows;
  std::vector<int64_t> cols;
  std::vector<double> vals;
  // open-addressing hash: key -> slot+1 (0 = empty)
  std::vector<uint64_t> keys;
  std::vector<uint64_t> slots;
  uint64_t mask = 0;
  int64_t n_rows = 0;  // grows monotonically from touched coords
  int64_t n_cols = 0;  // (≈ sparsemat_indexlist.rs:45-47)

  explicit Builder(uint64_t capacity) {
    uint64_t table = 16;
    while (table < capacity * 2) table <<= 1;
    keys.assign(table, 0);
    slots.assign(table, 0);
    mask = table - 1;
    rows.reserve(capacity);
    cols.reserve(capacity);
    vals.reserve(capacity);
  }

  static inline uint64_t hash_key(uint64_t k) {
    // splitmix64 finalizer
    k += 0x9e3779b97f4a7c15ull;
    k = (k ^ (k >> 30)) * 0xbf58476d1ce4e5b9ull;
    k = (k ^ (k >> 27)) * 0x94d049bb133111ebull;
    return k ^ (k >> 31);
  }

  void grow_table() {
    uint64_t table = (mask + 1) << 1;
    std::vector<uint64_t> nk(table, 0), ns(table, 0);
    uint64_t nmask = table - 1;
    for (uint64_t i = 0; i <= mask; ++i) {
      if (slots[i]) {
        uint64_t p = hash_key(keys[i]) & nmask;
        while (ns[p]) p = (p + 1) & nmask;
        nk[p] = keys[i];
        ns[p] = slots[i];
      }
    }
    keys.swap(nk);
    slots.swap(ns);
    mask = nmask;
  }

  // find-or-insert; returns slot index (≈ get_mut's insert-zero-if-absent
  // contract, sparsematrix.rs:112-114)
  uint64_t slot_for(int64_t i, int64_t j) {
    uint64_t key = (static_cast<uint64_t>(i) << 32) | static_cast<uint32_t>(j);
    uint64_t p = hash_key(key) & mask;
    while (true) {
      if (!slots[p]) {
        rows.push_back(i);
        cols.push_back(j);
        vals.push_back(0.0);
        slots[p] = rows.size();  // slot+1
        keys[p] = key;
        if (i >= n_rows) n_rows = i + 1;
        if (j >= n_cols) n_cols = j + 1;
        if (rows.size() * 2 > mask) grow_table();
        return rows.size() - 1;
      }
      if (keys[p] == key) return slots[p] - 1;
      p = (p + 1) & mask;
    }
  }

  // lookup without insert; returns slot or -1 (≈ find_index,
  // sparsemat_indexlist.rs:29-42)
  int64_t find(int64_t i, int64_t j) const {
    uint64_t key = (static_cast<uint64_t>(i) << 32) | static_cast<uint32_t>(j);
    uint64_t p = hash_key(key) & mask;
    while (slots[p]) {
      if (keys[p] == key) return static_cast<int64_t>(slots[p] - 1);
      p = (p + 1) & mask;
    }
    return -1;
  }
};

}  // namespace

extern "C" {

void* smt_builder_new(uint64_t capacity) { return new Builder(capacity ? capacity : 16); }

void smt_builder_free(void* h) { delete static_cast<Builder*>(h); }

void smt_builder_add_to(void* h, int64_t i, int64_t j, double v) {
  auto* b = static_cast<Builder*>(h);
  b->vals[b->slot_for(i, j)] += v;
}

void smt_builder_set(void* h, int64_t i, int64_t j, double v) {
  auto* b = static_cast<Builder*>(h);
  b->vals[b->slot_for(i, j)] = v;
}

double smt_builder_get(void* h, int64_t i, int64_t j) {
  auto* b = static_cast<Builder*>(h);
  int64_t s = b->find(i, j);
  return s < 0 ? 0.0 : b->vals[s];
}

int32_t smt_builder_contains(void* h, int64_t i, int64_t j) {
  return static_cast<Builder*>(h)->find(i, j) >= 0 ? 1 : 0;
}

// batch paths — the performance-relevant API (amortizes the ctypes hop)
void smt_builder_add_batch(void* h, uint64_t n, const int64_t* is,
                           const int64_t* js, const double* vs) {
  auto* b = static_cast<Builder*>(h);
  for (uint64_t k = 0; k < n; ++k) b->vals[b->slot_for(is[k], js[k])] += vs[k];
}

void smt_builder_set_batch(void* h, uint64_t n, const int64_t* is,
                           const int64_t* js, const double* vs) {
  auto* b = static_cast<Builder*>(h);
  for (uint64_t k = 0; k < n; ++k) b->vals[b->slot_for(is[k], js[k])] = vs[k];
}

uint64_t smt_builder_nnz(void* h) { return static_cast<Builder*>(h)->rows.size(); }
int64_t smt_builder_n_rows(void* h) { return static_cast<Builder*>(h)->n_rows; }
int64_t smt_builder_n_cols(void* h) { return static_cast<Builder*>(h)->n_cols; }

// export in insertion order (the order the reference's whole-matrix iterator
// observes per row — src/lib.rs:67-71)
void smt_builder_export(void* h, int64_t* rows_out, int64_t* cols_out,
                        double* vals_out) {
  auto* b = static_cast<Builder*>(h);
  std::memcpy(rows_out, b->rows.data(), b->rows.size() * sizeof(int64_t));
  std::memcpy(cols_out, b->cols.data(), b->cols.size() * sizeof(int64_t));
  std::memcpy(vals_out, b->vals.data(), b->vals.size() * sizeof(double));
}

// export as CSR with a stable counting sort by row: within a row, entries
// stay in insertion order — exactly the chain order the reference's to_crs
// streams (sparsemat_crs.rs:24-50).  indptr_out: n_rows+1 entries.
void smt_builder_export_csr(void* h, int64_t* indptr_out, int64_t* cols_out,
                            double* vals_out) {
  auto* b = static_cast<Builder*>(h);
  uint64_t nnz = b->rows.size();
  int64_t nr = b->n_rows;
  std::vector<int64_t> count(nr + 1, 0);
  for (uint64_t k = 0; k < nnz; ++k) count[b->rows[k] + 1]++;
  for (int64_t r = 0; r < nr; ++r) count[r + 1] += count[r];
  std::memcpy(indptr_out, count.data(), (nr + 1) * sizeof(int64_t));
  std::vector<int64_t> cursor(count.begin(), count.end() - 1);
  for (uint64_t k = 0; k < nnz; ++k) {
    int64_t p = cursor[b->rows[k]]++;
    cols_out[p] = b->cols[k];
    vals_out[p] = b->vals[k];
  }
}

void smt_builder_scale(void* h, double s) {
  auto* b = static_cast<Builder*>(h);
  for (auto& v : b->vals) v *= s;
}

}  // extern "C"
