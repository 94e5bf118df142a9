// The gathered weighted Gram of one width chunk above rank 256, for
// Hopper (sm_90a): gram_sm90.cuh's warp tiles, staged by strips.
//
// The block body of kernel K3 (gather_gram.cu) and of the first pass of
// kernels K4 (gather_solve.cu) and K7 (gather_solve_ring.cu) at every
// rank above gram::kRankLimit (256); at and below it they run
// gram_sm90.cuh's body, which stages whole rows.  Same contract as
// gram_sm90.cuh's gram() and store(): S's lower triangle in 32x32 warp
// tiles, b and the count, for the entries [w0, w1) of one row of an
// entry source.
//
// Why another body: gram_sm90.cuh cuts a triangle of more than 12 warp
// tiles over blocks that each stage whole rows, so each part gathers
// every row again (12 parts at rank 512), and its stage ring of
// kStages x kT rows of 32T + 8 elements outgrows a block's 227 KB above
// rank 416 in f32.  Here a part stages only the 32-column strips its
// tiles read.  The T = ceil(r/32) strips fall in groups of kGroup = 4:
// - a diagonal part: group P's triangle, 10 warp tiles on 4 strips;
// - an off-diagonal part: two strips of group P against the 4 strips of
//   an earlier group Q < P, 8 warp tiles on 6 strips;
// so a stage holds at most 6 strips of a row (107 KB in f32, 55 KB in
// bf16, at any rank), and the parts together stage (3G - 1)/2 whole
// rows over G groups (5.5 at rank 512, 16 parts) rather than one a part.
// A row's parts are neighbouring blocks (grid x = part + parts·row), so
// the parts that share a strip gather it close together in time, the
// later ones from L2.
//
// Each warp tile's arithmetic is gram_sm90.cuh's, operand for operand:
// the 3xTF32 mma.sync m16n8k8 products (small·big + big·small +
// big·big), a stage's 12 mma steps into a zeroed partial added to the
// running sums in f32 (two-level), all-padding stages neither copied nor
// computed.  b is summed once: each diagonal part sums its group's
// columns, a thread a column, in the order gram() sums them; the count
// by part 0.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "gram.cuh"
#include "gram_sm90.cuh"

namespace gstrips {

using g90::copy_async;
using g90::copy_bytes;
using g90::kMeta;
using g90::kStages;
using g90::kT;
using g90::meta_bytes;
using g90::side_tiles;
using tc::commit;
using tc::mma_tf32;
using tc::split_tf32;
using tc::wait_pending;

constexpr int kGroup = 4;                       // strips a group
constexpr int kWarps = kGroup * (kGroup + 1) / 2;  // a diagonal part's tiles
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxStrips = kGroup + 2;          // an off-diagonal part's
static_assert(2 * kGroup <= kWarps, "an off-diagonal part's tiles");

__host__ __device__ inline int groups(int r) {
  return (side_tiles(r) + kGroup - 1) / kGroup;
}
// the strips of group g (the last group may hold fewer)
__host__ __device__ inline int group_strips(int r, int g) {
  const int left = side_tiles(r) - g * kGroup;
  return left < kGroup ? left : kGroup;
}

// A part: its tiles (i, j), row strip i in [r0, r1), column strip j in
// [c0, c1), j <= i.  Diagonal when r0 == c0.
struct Part {
  int r0, r1, c0, c1;
};

// parts of rank r: the G diagonal ones, then for each group P > 0 and
// each earlier group Q, ceil(strips of P / 2) off-diagonal ones
__host__ __device__ inline int parts(int r) {
  const int G = groups(r);
  int n = G;
  for (int P = 1; P < G; ++P) n += P * ((group_strips(r, P) + 1) / 2);
  return n;
}

__host__ __device__ inline Part part_of(int r, int z) {
  const int G = groups(r);
  if (z < G) {
    const int a = z * kGroup;
    return {a, a + group_strips(r, z), a, a + group_strips(r, z)};
  }
  z -= G;
  for (int P = 1; P < G; ++P) {
    const int ns = group_strips(r, P), h = (ns + 1) / 2;
    if (z < P * h) {
      const int Q = z / h, a = P * kGroup + 2 * (z - Q * h);
      const int a1 = a + 2 < P * kGroup + ns ? a + 2 : P * kGroup + ns;
      return {a, a1, Q * kGroup, Q * kGroup + kGroup};
    }
    z -= P * h;
  }
  return {0, 0, 0, 0};  // past the last part: no tiles
}

// the stage ring's row stride for ns staged strips: 32·ns + 8 keeps one
// warp's fragment loads on distinct banks, as gram_sm90.cuh's 32T + 8
__host__ __device__ inline int row_stride(int ns) { return 32 * ns + 8; }

template <typename T>
__host__ __device__ inline size_t smem_bytes() {
  return meta_bytes() + static_cast<size_t>(kStages) * kT *
                            row_stride(kMaxStrips) * sizeof(T);
}

struct Acc {
  float s[2][4][4];  // the warp tile's running sums (mma C layout)
  int ti, tj;        // the warp tile: rows 32ti.., columns 32tj..
  bool math;         // this warp owns a tile
  int bcol;          // the column of b this thread sums, or -1
  float b;
  float cnt;         // Σ cw (part 0, thread 0)
  bool lead;         // part 0
};

// Accumulate entries [w0, w1) of one row of `src` into `acc`: the warp
// tiles of part `part` and, on a diagonal part, b over its strips (part
// 0 also the count).  Called by every thread of a block of kThreads
// threads; smem: smem_bytes<T>() bytes, 16-byte aligned.
template <typename T, bool kTwoSided, typename Src>
__device__ __forceinline__ void gram(const Src& src, int r, long long w0,
                                     long long w1, int part,
                                     unsigned char* smem, Acc& acc) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const Part pt = part_of(r, part);
  const bool dpart = pt.r0 == pt.c0;
  const int nr = pt.r1 - pt.r0;
  const int ns = dpart ? nr : nr + pt.c1 - pt.c0;  // staged strips
  const int ld = row_stride(ns);
  const int cb = copy_bytes<T>(r);
  const int rbytes = r * static_cast<int>(sizeof(T));
  const int cps = 32 * static_cast<int>(sizeof(T)) / cb;  // copies a strip
  float* meta = reinterpret_cast<float*>(smem);  // [kMeta][4][kT]
  int* live = reinterpret_cast<int*>(meta + kMeta * 4 * kT);  // [kMeta]
  T* rows = reinterpret_cast<T*>(smem + meta_bytes());  // [kStages][kT][ld]
  const int nst = static_cast<int>((w1 - w0 + kT - 1) / kT);

  // this warp's tile: a diagonal part's triangle row by row, an
  // off-diagonal part's rectangle row by row; staged strip of tile
  // strip g: rows first, then (off the diagonal) columns
  const int ntiles = dpart ? nr * (nr + 1) / 2 : nr * (pt.c1 - pt.c0);
  acc.math = warp < ntiles;
  int li = 0, lj = 0;  // the tile's staged strips
  if (dpart) {
    while ((li + 1) * (li + 2) / 2 <= warp) ++li;
    lj = warp - li * (li + 1) / 2;
    acc.ti = pt.r0 + li;
    acc.tj = pt.r0 + lj;
  } else {
    li = warp / (pt.c1 - pt.c0);
    const int cj = warp - li * (pt.c1 - pt.c0);
    acc.ti = pt.r0 + li;
    acc.tj = pt.c0 + cj;
    lj = nr + cj;
  }
  const bool diag = acc.ti == acc.tj;
  const int i0 = 32 * li, j0 = 32 * lj;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc.s[m][n][q] = 0.f;
  acc.b = 0.f;
  acc.cnt = 0.f;
  acc.lead = part == 0;
  acc.bcol = dpart && tid < 32 * nr && 32 * pt.r0 + tid < r
                 ? 32 * pt.r0 + tid : -1;

  // the columns past r (the last strip's) are read as zeros, never copied
  {
    float* words = reinterpret_cast<float*>(rows);
    const int nwords = kStages * kT * ld * static_cast<int>(sizeof(T)) / 4;
    for (int i = tid; i < nwords; i += nthr) words[i] = 0.f;
  }
  auto slot = [&](int s) { return meta + (s % kMeta) * 4 * kT; };
  auto load = [&](int s, int& h, float& a, float& bb, float& c) {
    h = 0;
    a = bb = c = 0.f;
    const long long pos = w0 + static_cast<long long>(s) * kT + tid;
    if (s < nst && pos < w1) src.load(pos, h, a, bb, c);
  };
  auto store = [&](int s, int h, float a, float bb, float c) {
    float* m = slot(s);
    reinterpret_cast<int*>(m)[tid] = h;
    m[kT + tid] = a;
    m[2 * kT + tid] = bb;
    m[3 * kT + tid] = c;
    const unsigned any =
        __ballot_sync(0xffffffffu, a != 0.f || bb != 0.f || c != 0.f);
    if (tid == 0) live[s % kMeta] = any != 0u;
  };
  // a warp per entry, its lanes over the staged strips' copies
  auto issue = [&](int s) {
    if (s < nst && live[s % kMeta]) {
      const int* hs = reinterpret_cast<const int*>(slot(s));
      T* dst = rows + (s % kStages) * kT * ld;
      for (int e = warp; e < kT; e += nthr >> 5) {
        const char* g = reinterpret_cast<const char*>(src.row(hs[e]));
        char* d = reinterpret_cast<char*>(dst + e * ld);
        for (int c = lane; c < ns * cps; c += 32) {
          const int ls = c / cps, k = c - ls * cps;
          const int gs = ls < nr ? pt.r0 + ls : pt.c0 + ls - nr;
          const int off = gs * 32 * static_cast<int>(sizeof(T)) + k * cb;
          if (off < rbytes)
            copy_async(d + ls * 32 * static_cast<int>(sizeof(T)) + k * cb,
                       g + off, cb);
        }
      }
    }
    commit();  // one group a stage, empty or not: the wait counts on it
  };

  int h = 0;
  float a = 0.f, bb = 0.f, c = 0.f;
  if (tid < kT) {
    for (int s = 0; s < kStages; ++s) {
      load(s, h, a, bb, c);
      store(s, h, a, bb, c);
    }
    load(kStages, h, a, bb, c);
  }
  __syncthreads();
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  for (int k = 0; k < nst; ++k) {
    if (tid < kT) {
      store(k + kStages, h, a, bb, c);  // its slot held stage k - 4
      load(k + kStages + 1, h, a, bb, c);
    }
    wait_pending<kStages - 2>();  // this thread's copies of stage k
    __syncthreads();  // everyone's copies landed; stage k-1 is consumed
    issue(k + kStages - 1);  // into stage k-1's slot

    const float* m = slot(k);
    const float* aw_s = m + kT;
    const T* st = rows + (k % kStages) * kT * ld;
    const bool on = live[k % kMeta];
    if (acc.math && on) {
      float p[2][4][4];
#pragma unroll
      for (int mm = 0; mm < 2; ++mm)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) p[mm][n][q] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kT / 8; ++kk) {
        const int e = kk * 8 + tig;
        const T* r0 = st + e * ld;  // entry e (k = tig)
        const T* r1 = r0 + 4 * ld;  // entry e + 4 (k = tig + 4)
        const float a0 = aw_s[e], a1 = aw_s[e + 4];
        uint32_t ab[2][4], as[2][4], bb_[4][2], bs[4][2];
#pragma unroll
        for (int mm = 0; mm < 2; ++mm) {
          const int i = i0 + 16 * mm + gid;
          split_tf32(gram::to_f(r0[i]) * a0, ab[mm][0], as[mm][0]);
          split_tf32(gram::to_f(r0[i + 8]) * a0, ab[mm][1], as[mm][1]);
          split_tf32(gram::to_f(r1[i]) * a1, ab[mm][2], as[mm][2]);
          split_tf32(gram::to_f(r1[i + 8]) * a1, ab[mm][3], as[mm][3]);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int j = j0 + 8 * n + gid;
          float v0 = gram::to_f(r0[j]), v1 = gram::to_f(r1[j]);
          if (kTwoSided) {
            v0 *= a0;
            v1 *= a1;
          }
          split_tf32(v0, bb_[n][0], bs[n][0]);
          split_tf32(v1, bb_[n][1], bs[n][1]);
        }
#pragma unroll
        for (int mm = 0; mm < 2; ++mm)
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            if (diag && mm == 0 && n >= 2) continue;  // above the diagonal
            mma_tf32(p[mm][n], as[mm], bb_[n]);
            mma_tf32(p[mm][n], ab[mm], bs[n]);
            mma_tf32(p[mm][n], ab[mm], bb_[n]);
          }
      }
#pragma unroll
      for (int mm = 0; mm < 2; ++mm)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc.s[mm][n][q] += p[mm][n][q];
    }
    if (on) {
      const float* bw_s = m + 2 * kT;
      const float* cw_s = m + 3 * kT;
      if (acc.bcol >= 0) {
        float tb = 0.f;
#pragma unroll 8
        for (int e = 0; e < kT; ++e)
          tb += bw_s[e] * gram::to_f(st[e * ld + tid]);
        acc.b += tb;
      }
      if (acc.lead && tid == 0) {
        float tc = 0.f;
#pragma unroll 8
        for (int e = 0; e < kT; ++e) tc += cw_s[e];
        acc.cnt += tc;
      }
    }
  }
  wait_pending<0>();
}

// Write what gram() accumulated: the warp tiles' entries of the lower
// triangle to So [r, r] at (i, j) and (j, i), b's columns to bo [r] and
// (part 0, when co is not null) the count to *co.
__device__ __forceinline__ void store(const Acc& acc, int r,
                                      float* __restrict__ So,
                                      float* __restrict__ bo,
                                      float* __restrict__ co) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  if (acc.math) {
#pragma unroll
    for (int mm = 0; mm < 2; ++mm)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 32 * acc.ti + 16 * mm + gid + 8 * (q >> 1);
          const int j = 32 * acc.tj + 8 * n + 2 * tig + (q & 1);
          if (i < r && j <= i) {
            So[i * r + j] = acc.s[mm][n][q];
            So[j * r + i] = acc.s[mm][n][q];
          }
        }
  }
  if (acc.bcol >= 0) bo[acc.bcol] = acc.b;
  if (acc.lead && threadIdx.x == 0 && co != nullptr) *co = acc.cnt;
}

}  // namespace gstrips
