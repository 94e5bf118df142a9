// bucketize: multi-threaded construction of the degree-bucketed padded CSR.
//
// The port's own copy of tpu_als/io/native/bucketize.cc (same arithmetic,
// same C interface).  Blocking is a host-side pass that lays COO ratings
// out as power-of-two-width padded CSR buckets (tpu_als_torch/core/
// ratings.py documents the layout); this library does its two O(nnz)
// passes — per-entity counting and bucket fill — with threads, an order
// of magnitude faster than the numpy argsort path at ML-25M scale, and
// array-equal to it (same bucket order, same within-row entry order).
//
// Build (tpu_als_torch/io/_native_build.py, into tpu_als_torch/_build/):
//   g++ -O3 -shared -fPIC -pthread bucketize.cc -o libbucketize.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

void parallel_for(int64_t n, int n_threads,
                  const std::function<void(int64_t, int64_t)>& fn) {
  if (n_threads <= 1 || n < (1 << 16)) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * per, hi = std::min(n, lo + per);
    if (lo >= hi) break;
    ts.emplace_back([&fn, lo, hi] { fn(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// counts[e] = number of entries with rows[i] == e.  rows must be < num_rows.
void bucketize_count(const int64_t* rows, int64_t nnz, int64_t num_rows,
                     int64_t* counts, int n_threads) {
  std::memset(counts, 0, sizeof(int64_t) * num_rows);
  if (n_threads <= 1 || nnz < (1 << 18)) {
    for (int64_t i = 0; i < nnz; ++i) counts[rows[i]]++;
    return;
  }
  // per-thread partial counts, then reduce (counting over entries)
  std::vector<std::vector<int64_t>> partial(n_threads);
  std::vector<std::thread> ts;
  int64_t per = (nnz + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * per, hi = std::min(nnz, lo + per);
    if (lo >= hi) break;
    ts.emplace_back([&, t, lo, hi] {
      partial[t].assign(num_rows, 0);
      for (int64_t i = lo; i < hi; ++i) partial[t][rows[i]]++;
    });
  }
  for (auto& t : ts) t.join();
  parallel_for(num_rows, n_threads, [&](int64_t lo, int64_t hi) {
    for (const auto& p : partial) {
      if (p.empty()) continue;
      for (int64_t e = lo; e < hi; ++e) counts[e] += p[e];
    }
  });
}

// Fill the bucket arenas.
//
//  rows/cols   [nnz] int64 COO
//  vals        [nnz] float
//  counts      [num_rows] from bucketize_count
//  ebucket     [num_rows] bucket index per entity (-1 = no ratings),
//              precomputed by the caller (tpu_als_torch/io/fastbucket.py)
//              with the same width rule as the numpy path — single source
//              of truth
//  per bucket b (nbuckets of them):
//    widths[b], rows_out[b] int32[nb_pad] (prefilled with num_rows),
//    cols/vals/mask arenas of [nb_pad * w], zero-prefilled by the caller.
//  scratch: elocal int32[num_rows], cursor int32[num_rows] zero-prefilled.
//
// Semantics match the numpy path of tpu_als_torch.core.ratings.
// build_csr_buckets exactly: bucket rows ascend by entity id; entries
// within a row keep input order.
void bucketize_fill(const int64_t* rows, const int64_t* cols,
                    const float* vals, int64_t nnz, int64_t num_rows,
                    const int64_t* counts,
                    const int32_t* ebucket, int32_t nbuckets,
                    const int64_t* widths, int32_t** rows_out,
                    int32_t** cols_out, float** vals_out, float** mask_out,
                    int32_t* elocal, int32_t* cursor,
                    int n_threads) {
  // pass 1 (sequential over entities, ascending id = numpy bucket order):
  // assign every rated entity its local row and write rows_out
  std::vector<int64_t> fill(nbuckets, 0);
  for (int64_t e = 0; e < num_rows; ++e) {
    int32_t b = ebucket[e];
    if (b < 0) continue;
    elocal[e] = static_cast<int32_t>(fill[b]);
    rows_out[b][fill[b]++] = static_cast<int32_t>(e);
  }
  // pass 2 (parallel by entity range): scatter entries into the arenas;
  // each thread owns a disjoint entity range so cursor needs no atomics,
  // and scanning entries in input order preserves within-row entry order.
  // Ranges are balanced by entry mass (counts prefix), not entity count —
  // power-law degrees would otherwise starve most threads.
  int T = (nnz < (1 << 18)) ? 1 : std::max(1, n_threads);
  std::vector<int64_t> bound(T + 1, num_rows);
  bound[0] = 0;
  int64_t acc = 0, target = nnz / T + 1;
  for (int64_t e = 0, t = 1; e < num_rows && t < T; ++e) {
    acc += counts[e];
    if (acc >= t * target) bound[t++] = e + 1;
  }
  std::vector<std::thread> ts;
  for (int t = 0; t < T; ++t) {
    int64_t lo = bound[t], hi = bound[t + 1];
    if (lo >= hi) continue;
    auto work = [&, lo, hi] {
      for (int64_t i = 0; i < nnz; ++i) {
        int64_t e = rows[i];
        if (e < lo || e >= hi) continue;
        int32_t b = ebucket[e];
        int64_t w = widths[b];
        int64_t dst = static_cast<int64_t>(elocal[e]) * w + cursor[e]++;
        cols_out[b][dst] = static_cast<int32_t>(cols[i]);
        vals_out[b][dst] = vals[i];
        mask_out[b][dst] = 1.0f;
      }
    };
    if (T == 1) {
      work();
    } else {
      ts.emplace_back(work);
    }
  }
  for (auto& t : ts) t.join();
}

}  // extern "C"
