// streamcsv: chunked string-id ratings ingest with a persistent interner.
//
// The port's own copy of tpu_als/io/native/streamcsv.cc (the same parser,
// interner and C interface; bound via ctypes in tpu_als_torch/io/stream.py).
// Ratings files whose user/item ids are STRINGS are read in chunks of one
// host's byte range: the caller feeds successive chunk buffers (lines are
// never split across calls -- the Python reader re-stitches the partial
// line at each chunk's tail), and this library emits dense LOCAL int64 ids
// per row while growing two intern tables (user, item).  After the stream
// ends the caller exports each table's keys in dense-id order and merges
// vocabularies across hosts; the remap local->global is then one numpy
// gather per host.
//
// Strictness contract matches fastcsv.cc: every data line must be
// exactly `str<delim>str<delim>float` followed by (require_cols - 3)
// more non-validated fields; empty id fields, non-finite ratings,
// quoted fields (a '"' opening either id), and wrong column counts all
// return -2 so the Python wrapper raises instead of letting a merged or
// zero-filled row enter training.  CRLF and a missing final newline are
// accepted; empty lines are skipped.
//
// Interner: open-addressing table (FNV-1a 64) over a byte arena;
// indices, not pointers, so arena growth never invalidates keys.  One
// handle is single-threaded by design -- per-host ingest is one stream.
//
// Build (tpu_als_torch/io/_native_build.py, into tpu_als_torch/_build/):
//   g++ -O3 -shared -fPIC -pthread streamcsv.cc -o libstreamcsv.so

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

inline uint64_t fnv1a(const char* p, int64_t n) {
  uint64_t h = 1469598103934665603ull;
  for (int64_t k = 0; k < n; ++k) {
    h ^= static_cast<unsigned char>(p[k]);
    h *= 1099511628211ull;
  }
  return h;
}

struct Interner {
  std::vector<char> arena;           // concatenated key bytes
  std::vector<int64_t> offsets{0};   // offsets[id] .. offsets[id+1]
  std::vector<int64_t> slots;        // open addressing: id+1, 0 = empty
  std::vector<uint64_t> hashes;      // hash per id (cheap rehash/probe)

  Interner() : slots(1 << 12, 0) {}

  int64_t size() const { return (int64_t)offsets.size() - 1; }

  void rehash() {
    std::vector<int64_t> ns(slots.size() * 2, 0);
    uint64_t mask = ns.size() - 1;
    for (int64_t id = 0; id < size(); ++id) {
      uint64_t j = hashes[id] & mask;
      while (ns[j]) j = (j + 1) & mask;
      ns[j] = id + 1;
    }
    slots.swap(ns);
  }

  int64_t intern(const char* p, int64_t n) {
    uint64_t h = fnv1a(p, n);
    uint64_t mask = slots.size() - 1;
    uint64_t j = h & mask;
    while (slots[j]) {
      int64_t id = slots[j] - 1;
      if (hashes[id] == h && offsets[id + 1] - offsets[id] == n &&
          memcmp(arena.data() + offsets[id], p, n) == 0)
        return id;
      j = (j + 1) & mask;
    }
    int64_t id = size();
    arena.insert(arena.end(), p, p + n);
    offsets.push_back((int64_t)arena.size());
    hashes.push_back(h);
    slots[j] = id + 1;
    if (size() * 10 >= (int64_t)slots.size() * 7) rehash();
    return id;
  }
};

struct Handle {
  Interner users, items;
};

// [b, eol) of one line with the trailing '\r' stripped
inline const char* strip_eol(const char* b, const char* eol) {
  if (eol > b && eol[-1] == '\r') --eol;
  return eol;
}

// one id field [p, *fe): ends at delim; empty or quoted -> malformed
inline bool take_id(const char* p, const char* eol, char delim,
                    const char** fe) {
  const char* d =
      static_cast<const char*>(memchr(p, delim, eol - p));
  if (!d || d == p || *p == '"') return false;
  *fe = d;
  return true;
}

}  // namespace

extern "C" {

void* sc_create() { return new Handle(); }

void sc_destroy(void* h) { delete static_cast<Handle*>(h); }

// Count non-empty lines of the buffer (chunk output sizing).
int64_t sc_count_lines(const char* buf, int64_t len) {
  int64_t n = 0;
  const char* b = buf;
  const char* e = buf + len;
  while (b < e) {
    const char* p = static_cast<const char*>(memchr(b, '\n', e - b));
    const char* eol = strip_eol(b, p ? p : e);
    if (eol > b) ++n;
    if (!p) break;
    b = p + 1;
  }
  return n;
}

// Parse one chunk of whole lines; rows land in out_* (length >= the
// chunk's sc_count_lines).  require_cols >= 3: total delimited fields
// per line (user, item, rating, then require_cols-3 ignored tails).
// Returns rows written, or -2 on the first malformed line.
int64_t sc_ingest(void* handle, const char* buf, int64_t len, char delim,
                  int require_cols, int64_t* out_u, int64_t* out_i,
                  float* out_r) {
  Handle* h = static_cast<Handle*>(handle);
  const char* p = buf;
  const char* e = buf + len;
  int64_t row = 0;
  while (p < e) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', e - p));
    const char* eol = strip_eol(p, nl ? nl : e);
    if (eol > p) {
      const char *ue, *ie;
      if (!take_id(p, eol, delim, &ue)) return -2;
      if (!take_id(ue + 1, eol, delim, &ie)) return -2;
      const char* rp = ie + 1;
      char* q;
      float r = strtof(rp, &q);
      if (q == rp || !std::isfinite(r)) return -2;
      // after the rating: either end-of-line (require_cols == 3) or
      // delim + exactly require_cols-4 more delims before eol
      int extra = require_cols - 3;
      if (extra == 0) {
        const char* t = q;
        while (t < eol && *t == ' ') ++t;
        if (t != eol) return -2;
      } else {
        if (q >= eol || *q != delim) return -2;
        const char* t = q;
        int seen = 0;  // delims from the one after rating onward
        while (t < eol) {
          const char* d =
              static_cast<const char*>(memchr(t, delim, eol - t));
          if (!d) break;
          ++seen;
          t = d + 1;
        }
        if (seen != extra) return -2;
      }
      out_u[row] = h->users.intern(p, ue - p);
      out_i[row] = h->items.intern(ue + 1, ie - (ue + 1));
      out_r[row] = r;
      ++row;
    }
    p = nl ? nl + 1 : e;
  }
  return row;
}

// which: 0 = users, 1 = items
int64_t sc_num_keys(void* handle, int which) {
  Handle* h = static_cast<Handle*>(handle);
  return (which ? h->items : h->users).size();
}

int64_t sc_key_bytes(void* handle, int which) {
  Handle* h = static_cast<Handle*>(handle);
  return (int64_t)(which ? h->items : h->users).arena.size();
}

// Export keys in dense-id order: out_bytes gets the concatenated arena
// (length sc_key_bytes), out_offsets gets size()+1 offsets.
void sc_export_keys(void* handle, int which, char* out_bytes,
                    int64_t* out_offsets) {
  Handle* h = static_cast<Handle*>(handle);
  Interner& t = which ? h->items : h->users;
  memcpy(out_bytes, t.arena.data(), t.arena.size());
  memcpy(out_offsets, t.offsets.data(),
         t.offsets.size() * sizeof(int64_t));
}

int64_t sc_max_key_len(void* handle, int which) {
  Handle* h = static_cast<Handle*>(handle);
  Interner& t = which ? h->items : h->users;
  int64_t m = 0;
  for (int64_t id = 0; id < t.size(); ++id) {
    int64_t n = t.offsets[id + 1] - t.offsets[id];
    if (n > m) m = n;
  }
  return m;
}

// Export keys as a dense [size, width] zero-padded matrix — one memcpy
// per key instead of one Python object per key, so the caller can view
// it as a numpy S(width) array and vectorize the cross-host merge.
void sc_export_keys_padded(void* handle, int which, int64_t width,
                           char* out) {
  Handle* h = static_cast<Handle*>(handle);
  Interner& t = which ? h->items : h->users;
  memset(out, 0, t.size() * width);
  for (int64_t id = 0; id < t.size(); ++id) {
    int64_t n = t.offsets[id + 1] - t.offsets[id];
    memcpy(out + id * width, t.arena.data() + t.offsets[id],
           n < width ? n : width);
  }
}

}  // extern "C"
