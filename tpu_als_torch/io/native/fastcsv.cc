// fastcsv: multi-threaded MovieLens ratings parser.
//
// The port's own copy of tpu_als/io/native/fastcsv.cc (same arithmetic,
// same C interface).  It parses `ratings.csv` (userId,movieId,rating,
// timestamp) or `u.data` (tab-separated) straight into preallocated numpy
// buffers, in parallel over byte ranges, bound via ctypes
// (tpu_als_torch/io/fastcsv.py).
//
// Strictness contract: every data line must be exactly
// `int<delim>int<delim>float<delim>int` with an optional trailing `\r` /
// spaces; empty lines (and `\r`-only lines) are skipped.  Anything else
// — quoted fields, missing fields, trailing junk, extra columns — makes
// fastcsv_parse return -2 so the Python wrapper can raise a clean error
// instead of a zero-filled row entering training.
// CRLF endings, a missing final newline, scientific-notation floats, and
// full-int64 ids are all accepted (the ids may exceed the float64
// mantissa).
//
// Build (tpu_als_torch/io/_native_build.py, into tpu_als_torch/_build/):
//   g++ -O3 -shared -fPIC -pthread fastcsv.cc -o libfastcsv.so

#include <atomic>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Span {
  const char* begin;
  const char* end;
  int64_t out_offset;  // first output row index for this span
};

// [b, eol) of one line with the trailing '\r' stripped; empty -> skip
inline const char* strip_eol(const char* b, const char* eol) {
  if (eol > b && eol[-1] == '\r') --eol;
  return eol;
}

// count NON-EMPTY lines in [b, e)
int64_t count_lines(const char* b, const char* e) {
  int64_t n = 0;
  while (b < e) {
    const char* p = static_cast<const char*>(memchr(b, '\n', e - b));
    const char* eol = p ? p : e;
    if (strip_eol(b, eol) > b) ++n;
    if (!p) break;
    b = p + 1;
  }
  return n;
}

// strict parse of one line body [p, eol): exactly 4 delimited fields.
// strtoll/strtof stop at the terminating '\n'/delim, and every field is
// bounds-checked against eol, so they never consume past the line.
// errno (thread-local) catches int64 overflow — an overflowing id would
// otherwise clamp to INT64_MAX and silently merge distinct entities —
// and std::isfinite rejects nan/inf ratings, which strtof accepts as
// valid spellings but which would poison the factor accumulation.
inline bool parse_fields(const char* p, const char* eol, char delim,
                         int64_t* u, int64_t* i, float* r, int64_t* t) {
  char* q;
  errno = 0;
  *u = strtoll(p, &q, 10);
  if (q == p || errno == ERANGE || q >= eol || *q != delim) return false;
  p = q + 1;
  *i = strtoll(p, &q, 10);
  if (q == p || errno == ERANGE || q >= eol || *q != delim) return false;
  p = q + 1;
  *r = strtof(p, &q);
  if (q == p || !std::isfinite(*r) || q >= eol || *q != delim)
    return false;
  p = q + 1;
  errno = 0;  // strtof sets ERANGE on float underflow (a legal rating)
  *t = strtoll(p, &q, 10);
  if (q == p || errno == ERANGE || q > eol) return false;
  for (p = q; p < eol && *p == ' '; ++p) {}
  return p == eol;
}

void parse_span(Span span, char delim, int64_t* users, int64_t* items,
                float* ratings, int64_t* ts, std::atomic<bool>* bad) {
  const char* p = span.begin;
  int64_t row = span.out_offset;
  while (p < span.end) {
    if (bad->load(std::memory_order_relaxed)) return;
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', span.end - p));
    const char* eol = strip_eol(p, nl ? nl : span.end);
    if (eol > p) {
      if (!parse_fields(p, eol, delim, &users[row], &items[row],
                        &ratings[row], &ts[row])) {
        bad->store(true, std::memory_order_relaxed);
        return;
      }
      ++row;
    }
    p = nl ? nl + 1 : span.end;
  }
}

}  // namespace

extern "C" {

// Count data lines (after skipping `skip_header` lines) of the buffer.
int64_t fastcsv_count(const char* buf, int64_t len, int skip_header) {
  const char* b = buf;
  const char* e = buf + len;
  for (int s = 0; s < skip_header && b < e; ++s) {
    const char* p = static_cast<const char*>(memchr(b, '\n', e - b));
    if (!p) return 0;
    b = p + 1;
  }
  return count_lines(b, e);
}

// Parse into preallocated arrays of length >= fastcsv_count(...).
// Returns rows written, -1 on a header error, -2 on a malformed data line.
int64_t fastcsv_parse(const char* buf, int64_t len, char delim,
                      int skip_header, int n_threads, int64_t* users,
                      int64_t* items, float* ratings, int64_t* ts) {
  const char* b = buf;
  const char* e = buf + len;
  for (int s = 0; s < skip_header && b < e; ++s) {
    const char* p = static_cast<const char*>(memchr(b, '\n', e - b));
    if (!p) return -1;
    b = p + 1;
  }
  if (n_threads < 1) n_threads = 1;

  // split [b, e) into n byte ranges aligned to line starts
  std::vector<Span> spans;
  int64_t chunk = (e - b) / n_threads + 1;
  const char* cur = b;
  while (cur < e) {
    const char* stop = cur + chunk < e ? cur + chunk : e;
    if (stop < e) {
      const char* nl = static_cast<const char*>(memchr(stop, '\n', e - stop));
      stop = nl ? nl + 1 : e;
    }
    spans.push_back({cur, stop, 0});
    cur = stop;
  }
  // prefix-sum line counts -> output offsets
  std::vector<int64_t> counts(spans.size());
  {
    std::vector<std::thread> th;
    for (size_t k = 0; k < spans.size(); ++k)
      th.emplace_back([&, k] { counts[k] = count_lines(spans[k].begin,
                                                       spans[k].end); });
    for (auto& t : th) t.join();
  }
  int64_t off = 0;
  for (size_t k = 0; k < spans.size(); ++k) {
    spans[k].out_offset = off;
    off += counts[k];
  }
  std::atomic<bool> bad{false};
  {
    std::vector<std::thread> th;
    for (auto& s : spans)
      th.emplace_back([&, s] { parse_span(s, delim, users, items,
                                          ratings, ts, &bad); });
    for (auto& t : th) t.join();
  }
  if (bad.load()) return -2;
  return off;
}

}  // extern "C"
