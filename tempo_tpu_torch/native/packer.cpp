// Native host packing engine of tempo_tpu_torch (a copy of the JAX
// package's engine; the port keeps its own).
//
// Role: the ragged->padded layout transform that feeds the device (hash
// the rows by key, sort each key's rows by (ts, seq), pack them into
// dense [K, L] rows).  The numpy path does this with lexsort and
// fancy-index scatters; this C++ path does a bucket place, a per-key
// stable sort and contiguous memcpy packs, multithreaded over series
// buckets.
//
// Exposed through a plain C ABI and loaded from Python with ctypes
// (tempo_tpu_torch/native/__init__.py builds it with g++ at first use).


#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// Comparator matching numpy lexsort((seq, ts, key)) within one key
// bucket: primary ts, secondary seq with NaN sorted last (numpy sorts
// NaN to the end), stable on full ties.  The sequence column comes in
// either float64 (seq_f) or exact int64 (seq_i) flavors — int64
// sequence ids above 2^53 must not round through a double.
struct TsSeqLess {
  const int64_t* ts;
  const double* seq_f;   // may be null
  const int64_t* seq_i;  // may be null (mutually exclusive with seq_f)
  bool operator()(int64_t a, int64_t b) const {
    if (ts[a] != ts[b]) return ts[a] < ts[b];
    if (seq_i != nullptr) return seq_i[a] < seq_i[b];
    if (seq_f == nullptr) return false;
    const double sa = seq_f[a], sb = seq_f[b];
    const bool na = std::isnan(sa), nb = std::isnan(sb);
    if (na || nb) return !na && nb;  // non-NaN < NaN; NaN==NaN keeps order
    return sa < sb;
  }
};

void parallel_over_keys(int64_t n_keys, const int64_t* starts, int nthreads,
                        const std::function<void(int64_t)>& body) {
  if (nthreads <= 1 || n_keys <= 1) {
    for (int64_t k = 0; k < n_keys; ++k) body(k);
    return;
  }
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t k = next.fetch_add(1);
      if (k >= n_keys) return;
      body(k);
    }
  };
  std::vector<std::thread> pool;
  int nt = std::min<int64_t>(nthreads, n_keys);
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  (void)starts;
}

}  // namespace

extern "C" {

// Compute the sorted flat layout: order[i] = position into the original
// arrays of the i-th row in (key, ts, seq) order; starts[k] = row offset
// of key k in the sorted stream (length n_keys+1).
// key_ids must be dense in [0, n_keys).  seq may be null.
void tempo_sort_layout(const int64_t* key_ids, const int64_t* ts,
                       const double* seq_f, const int64_t* seq_i, int64_t n,
                       int64_t n_keys, int64_t* order, int64_t* starts,
                       int nthreads) {
  // pass 1: counts -> starts
  std::vector<int64_t> counts(n_keys, 0);
  for (int64_t i = 0; i < n; ++i) counts[key_ids[i]]++;
  starts[0] = 0;
  for (int64_t k = 0; k < n_keys; ++k) starts[k + 1] = starts[k] + counts[k];
  // pass 2: stable bucket placement by key (original order within bucket)
  std::vector<int64_t> cursor(starts, starts + n_keys);
  for (int64_t i = 0; i < n; ++i) order[cursor[key_ids[i]]++] = i;
  // pass 3: per-key stable sort by (ts, seq)
  TsSeqLess less{ts, seq_f, seq_i};
  parallel_over_keys(n_keys, starts, nthreads, [&](int64_t k) {
    std::stable_sort(order + starts[k], order + starts[k + 1], less);
  });
}

// Gather a column through `order` (itemsize-generic):
// out[i*itemsize..] = vals[order[i]*itemsize..].
void tempo_take(const char* vals, const int64_t* order, int64_t n,
                int64_t itemsize, char* out, int nthreads) {
  int nt = std::max(1, nthreads);
  int64_t chunk = (n + nt - 1) / nt;
  std::vector<std::thread> pool;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([=]() {
      for (int64_t i = lo; i < hi; ++i)
        std::memcpy(out + i * itemsize, vals + order[i] * itemsize, itemsize);
    });
  }
  for (auto& th : pool) th.join();
}

// Pack an already key/ts-sorted flat column into dense [K, L] padded
// rows: row k = vals[starts[k]:starts[k+1]] then fill_elem repeated.
// Contiguous memcpy per series + pattern fill — the scatter the numpy
// path does with fancy indexing.
void tempo_pack(const char* vals, const int64_t* starts, int64_t n_keys,
                int64_t padded_len, int64_t itemsize, const char* fill_elem,
                char* out, int nthreads) {
  parallel_over_keys(n_keys, starts, nthreads, [&](int64_t k) {
    const int64_t len = std::min(starts[k + 1] - starts[k], padded_len);
    char* row = out + k * padded_len * itemsize;
    std::memcpy(row, vals + starts[k] * itemsize, len * itemsize);
    for (int64_t j = len; j < padded_len; ++j)
      std::memcpy(row + j * itemsize, fill_elem, itemsize);
  });
}

// Inverse of tempo_pack: flatten [K, L] padded rows back to the sorted
// flat stream of real rows.
void tempo_unpack(const char* packed, const int64_t* starts, int64_t n_keys,
                  int64_t padded_len, int64_t itemsize, char* out,
                  int nthreads) {
  parallel_over_keys(n_keys, starts, nthreads, [&](int64_t k) {
    const int64_t len = starts[k + 1] - starts[k];
    std::memcpy(out + starts[k] * itemsize,
                packed + k * padded_len * itemsize, len * itemsize);
  });
}

}  // extern "C"
