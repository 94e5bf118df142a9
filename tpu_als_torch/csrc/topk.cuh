// The top-k scan shared by kernel K5 (topk.cu) and kernel K8
// (topk_merge_ring.cu): for Hopper (sm_90a).
//
// One kernel computes, for the query rows U [n, r] against a catalog in S
// shards V [S, ni_loc, r] (valid [S, ni_loc]), each row's k best items
// in the stable order — score descending, the lower global id first on a
// tie (global id = s·ni_loc + local) — cut to k and padded with
// (NEG_INF, id 0).  K5 is the case S = 1.  The design:
//
// - Grid (user tile, set).  A block owns kTU = 64 query rows and one set:
//   one of P contiguous parts (in id order, whole item tiles each) of one
//   shard's items.  The host picks P (ops/cuda_topk.py::topk_parts) so
//   that a call with few user tiles still fills the card; S·P <= 32
//   where S allows, else P = 1.  At most kMaxSetsY sets (CUDA's grid
//   limit in y).
// - Score GEMM on the tensor cores at f32 accuracy (3xTF32): each
//   operand x = big + small (split_trunc), and mma.sync m16n8k8
//   (tf32.cuh, as K3's Gram) accumulates small·big + big·small +
//   big·big.  The rank is padded to a multiple of 8 with zeros.  The
//   tensor cores' f32 accumulation truncates, so each 32-rank chunk goes
//   into a zeroed partial that is added to the running score with
//   round-to-nearest f32 adds (two-level sums).  On integer factors
//   below 2^11 the small parts are zero and every sum of integers below
//   2^24 is exact: such scores are the exact f32 ones.
// - The block's query rows are read from device memory once: they stay
//   in shared memory for the whole pass over the set (resident) up to
//   rank 128, and above it when that keeps two blocks on a
//   multiprocessor or streaming would not either (resident()); otherwise
//   each stage carries their 32-rank chunk beside the items' (streaming:
//   rank 256 at k = 10).  The items stream through a ring of kStages
//   stages by cp.async, a stage being one tile of kTI = 128 items x 32
//   ranks: one wait and one block barrier a stage.  8 warps, each a
//   32 x 32 warp tile (2 x 4 mma tiles): 64 rows x 128 items a tile, at
//   most 128 registers a thread, two blocks a multiprocessor where the
//   shared memory allows (k up to ~18 at rank 128).
// - Selection from registers.  After an item tile's last chunk each
//   thread holds its 32 scores; it compares each with its row's k-th key
//   (score, id), read once per tile, and only the survivors go to a
//   32-slot queue per row in shared memory.  The queues are folded after
//   the next stage's barrier, so a tile costs no barrier of its own: a
//   warp folds a row's queue into the row's sorted list by the key (a
//   survivor's place is the number of kept and queued keys above it), so
//   the list is the stable order whatever the arrival order.  What a full
//   queue did not take is re-tested against the new k-th key and queued
//   again, until none is left.  Invalid items and rows past n never
//   enter; an item scoring exactly NEG_INF never displaces a sentinel (as
//   in the plain version).
// - Sets merged by the last block.  With S·P > 1 each block writes its
//   set to a scratch coll [tiles, S·P, kTU, k] in device memory; the last
//   block of a user tile to finish (a __threadfence, then an atomic
//   ticket per tile, which the wrapper zeroes) merges the sets in set
//   order: one warp per row, lane j holding the heads of sets j, j + 32,
//   ... (a byte each, in the shared memory the scan is done with), k
//   steps of each lane's best head (the lower set first on a tie) and a
//   warp-wide argmax over (score, set), the lower set (so the lower ids)
//   winning a tie.  One launch, no spin-waits.
// - Across processes (K8 with its sets in buffers the processes map from
//   each other, parallel/peer.py) the two halves run apart: scan-to-sets
//   (launch_scan with sets_only) writes every set of this process's
//   shards for every user tile to an exported buffer, ids offset by the
//   first shard's mesh position; after a barrier, merge-from-sets
//   (merge_kernel) merges the rows of this process's queries over every
//   process's sets, in shard and part order, with the same merge.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32.cuh"

namespace topk {

constexpr int kTU = 64;        // query rows per block
constexpr int kTI = 128;       // items per tile
constexpr int kDK = 32;        // ranks per stage (4 mma k-steps)
constexpr int kThreads = 256;  // 8 warps: 2 (rows) x 4 (items) of 32 x 32
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;     // stages of the cp.async ring
constexpr int kLd = kDK + 4;   // staged row stride: conflict-free fragments
constexpr int kQ = 32;         // queue slots per row (one per lane)
constexpr int kMaxK = 128;
constexpr int kMaxSetsY = 65535;  // sets: the grid's limit in y
// a block's shared memory on sm_90 (232,448 bytes) less room for the
// static `last` flag; and what lets two blocks share a multiprocessor
// (233,472 bytes, 1,024 of them reserved per block)
constexpr size_t kMaxSmem = 232448 - 128;
constexpr size_t kHalfSmem = 233472 / 2 - 1024 - 128;
constexpr float kNegInf = -3.4e38f;

__host__ __device__ inline int rank8(int r) { return (r + 7) / 8 * 8; }
__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

// Byte offsets of the block's shared memory: the kept lists (scores,
// part-local ids), each row's k-th key, the queues, then (resident) the
// query rows and the ring.
struct Layout {
  size_t ls, li, ts, ti, qs, qi, qn, us, ring, total;
  int ldu;  // resident query row stride in floats (rank8 + 4)
};

__host__ __device__ inline Layout layout(int k, int r, bool resident) {
  Layout l;
  l.ldu = rank8(r) + 4;
  l.ls = 0;
  l.li = l.ls + static_cast<size_t>(kTU) * k * 4;
  l.ts = l.li + static_cast<size_t>(kTU) * k * 4;
  l.ti = l.ts + kTU * 4;
  l.qs = l.ti + kTU * 4;
  l.qi = l.qs + kTU * kQ * 4;
  l.qn = l.qi + kTU * kQ * 4;
  l.us = align16(l.qn + kTU * 4);
  l.ring = l.us + (resident ? static_cast<size_t>(kTU) * l.ldu * 4 : 0);
  l.total = l.ring + static_cast<size_t>(kStages) *
                         (kTI + (resident ? 0 : kTU)) * kLd * 4;
  return l;
}

// The query rows stay resident when they fit, up to rank 128 always;
// above it only if that keeps two blocks on a multiprocessor or
// streaming would not either (two blocks hide each other's barriers and
// selection; one leaves the tensor cores waiting).
__host__ __device__ inline bool resident(int k, int r) {
  const size_t res = layout(k, r, true).total;
  if (res > kMaxSmem) return false;
  return rank8(r) <= 128 || res <= kHalfSmem ||
         layout(k, r, false).total > kHalfSmem;
}

// the stable order's "a before b": higher score, then lower id
__device__ __forceinline__ bool better(float s, int i, float ts, int ti) {
  return s > ts || (s == ts && i < ti);
}

// x = big + small for the 3xTF32 products, in two instructions: big is x
// truncated to TF32 (its low 13 bits cleared), small = x - big (exact in
// f32), of which the tensor cores read only the TF32 bits (truncated),
// so |x - big - small| < 2^-20 |x|.  (tc::split_tf32 rounds big and masks
// small, < 2^-21 |x|, in four; here the split is the inner loop's main
// cost.)  Integers below 2^11 in magnitude split exactly (small = 0).
__device__ __forceinline__ void split_trunc(float x, uint32_t& big,
                                            uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// p += the 3xTF32 products of KK k-steps (8 ranks each) of one stage:
// the warp's 32 query rows at su (row stride ldu) against its 32 items
// at sv (row stride kLd).  KK is a constant, so the k-steps form one
// block of straight code that the compiler interleaves.
template <int KK>
__device__ __forceinline__ void stage_mma(float (&p)[2][4][4],
                                          const float* su, int ldu,
                                          const float* sv, int gid,
                                          int tig) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float* a = su + (16 * m + gid) * ldu + kk * 8 + tig;
      split_trunc(a[0], ab[m][0], as[m][0]);
      split_trunc(a[8 * ldu], ab[m][1], as[m][1]);
      split_trunc(a[4], ab[m][2], as[m][2]);
      split_trunc(a[8 * ldu + 4], ab[m][3], as[m][3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* b = sv + (8 * j + gid) * kLd + kk * 8 + tig;
      uint32_t bb[2], bs[2];
      split_trunc(b[0], bb[0], bs[0]);
      split_trunc(b[4], bb[1], bs[1]);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        tc::mma_tf32(p[m][j], as[m], bb);
        tc::mma_tf32(p[m][j], ab[m], bs);
        tc::mma_tf32(p[m][j], ab[m], bb);
      }
    }
  }
}

// cp.async of `bytes` (16, 8 or 4); zeros when !real (nothing is read)
__device__ __forceinline__ void copy_zfill(void* dst, const void* src,
                                           int bytes, bool real) {
  const uint32_t d = tc::smem_addr(dst);
  const int n = real ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
}

// Copy rows [row0, row0 + rows) x ranks [d0, d0 + kDK) of X [nrows, r]
// into dst [rows][kLd]; rows at or past `end` and ranks at or past r are
// zeros.  cb: bytes a copy (the largest of 16, 8, 4 dividing a row), sh:
// log2 of the copies a staged row (3, 4, 5).
__device__ __forceinline__ void stage_rows(float* dst, const float* X,
                                           long long row0, long long end,
                                           int rows, int d0, int r, int cb,
                                           int sh) {
  const int step = kThreads >> sh;  // rows one pass of the block covers
  const int row = threadIdx.x >> sh;
  const int dd = (threadIdx.x & ((1 << sh) - 1)) * (cb >> 2);
  const bool din = d0 + dd < r;
  float* o = dst + row * kLd + dd;
  const float* x = X + (row0 + row) * r + d0 + dd;
  for (int rr = row; rr < rows; rr += step) {
    const bool real = din && row0 + rr < end;
    copy_zfill(o, real ? x : X, cb, real);
    o += step * kLd;
    x += static_cast<long long>(step) * r;
  }
}

// One warp folds row `row`'s queue into its kept list (see the header).
__device__ __forceinline__ void fold(float* ls, int* li, float* ts, int* ti,
                                     const float* qs, const int* qi, int* qn,
                                     int row, int k, int lane) {
  const int m = min(qn[row], kQ);
  if (m == 0) return;
  float* rs = ls + row * k;
  int* ri = li + row * k;
  const float cs = lane < m ? qs[row * kQ + lane] : 0.f;
  const int ci = lane < m ? qi[row * kQ + lane] : 0;
  float es[kMaxK / 32];
  int ei[kMaxK / 32], ep[kMaxK / 32];
#pragma unroll
  for (int j = 0; j < kMaxK / 32; ++j) {
    const int p = lane + 32 * j;
    es[j] = p < k ? rs[p] : 0.f;
    ei[j] = p < k ? ri[p] : 0;
    ep[j] = p;
  }
  int cp = 0;  // queued keys above the lane's survivor
  for (int t = 0; t < m; ++t) {
    const float s = __shfl_sync(0xffffffffu, cs, t);
    const int i = __shfl_sync(0xffffffffu, ci, t);
    cp += better(s, i, cs, ci);
#pragma unroll
    for (int j = 0; j < kMaxK / 32; ++j) ep[j] += better(s, i, es[j], ei[j]);
  }
  if (lane < m) {  // kept keys above it: a binary search of the list
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (better(rs[mid], ri[mid], cs, ci)) lo = mid + 1; else hi = mid;
    }
    cp += lo;
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kMaxK / 32; ++j)
    if (lane + 32 * j < k && ep[j] < k) {
      rs[ep[j]] = es[j];
      ri[ep[j]] = ei[j];
    }
  if (lane < m && cp < k) {
    rs[cp] = cs;
    ri[cp] = ci;
  }
  __syncwarp();
  if (lane == 0) {
    ts[row] = rs[k - 1];
    ti[row] = ri[k - 1];
    qn[row] = 0;
  }
}

// One warp merges one row's `sets` sorted lists of k (score, id) into
// out_s / out_i [k], in set order: lane j holds the heads of sets j, j +
// 32, ... (a byte each at hd, k <= 128), k steps of each lane's best
// head (the lower set first on a tie) and a warp-wide argmax over
// (score, set), the lower set (so the lower ids) winning a tie.
// score(s, h) / id(s, h): entry h of set s's list.
template <typename Score, typename Id>
__device__ __forceinline__ void merge_row(Score score, Id id, int sets,
                                          int k, unsigned char* hd,
                                          int lane, float* out_s,
                                          long long* out_i) {
  for (int s = lane; s < sets; s += 32) hd[s] = 0;
  __syncwarp();
  for (int j = 0; j < k; ++j) {
    // the lane's best head, the lower set first on a tie; bl == sets:
    // none left
    float bs = __int_as_float(0xff800000u);
    int bl = sets;
    for (int s = lane; s < sets; s += 32) {
      const int h = hd[s];
      if (h < k) {
        const float v = score(s, h);
        if (v > bs) {
          bs = v;
          bl = s;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, off);
      const int ol = __shfl_xor_sync(0xffffffffu, bl, off);
      if (os > bs || (os == bs && ol < bl)) {
        bs = os;
        bl = ol;
      }
    }
    if (lane == 0) {
      const bool real = bs > kNegInf && bl < sets;
      out_s[j] = real ? bs : kNegInf;
      out_i[j] = real ? id(bl, hd[bl]) : 0;
    }
    __syncwarp();  // lane 0 has read the head before its owner moves it
    if (bl < sets && lane == bl % 32) ++hd[bl];
    __syncwarp();
  }
}

// Grid (ceil(n / kTU), S·P); block kThreads; dynamic
// shared memory `mem` bytes, at least layout(k, r, kResident).total and
// room for the merge's heads.  With S·P == 1 the block writes its rows'
// results to out; otherwise its set to coll and the last block of the
// tile merges.
template <bool kResident>
__global__ void __launch_bounds__(kThreads, 2)
scan_kernel(const float* __restrict__ U, const float* __restrict__ V,
            const unsigned char* __restrict__ valid,
            float* __restrict__ coll_s, long long* __restrict__ coll_i,
            unsigned* __restrict__ tickets, float* __restrict__ out_s,
            long long* __restrict__ out_i, long long n, long long ni_loc,
            int P, int r, int k, int mem, long long id0, bool sets_only) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last;
  const Layout L = layout(k, r, kResident);
  float* ls = reinterpret_cast<float*>(smem + L.ls);
  int* li = reinterpret_cast<int*>(smem + L.li);
  float* ts = reinterpret_cast<float*>(smem + L.ts);
  int* ti = reinterpret_cast<int*>(smem + L.ti);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  int* qi = reinterpret_cast<int*>(smem + L.qi);
  int* qn = reinterpret_cast<int*>(smem + L.qn);
  float* us = reinterpret_cast<float*>(smem + L.us);
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  constexpr int kStage = (kTI + (kResident ? 0 : kTU)) * kLd;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows 32wm, items 32wn
  const long long tile = blockIdx.x;
  const int set = blockIdx.y, sets = gridDim.y;
  const int shard = set / P, part = set % P;
  const long long u0 = tile * kTU;
  // the set: item tiles [t_lo, t_hi) of the shard, items [lo, hi)
  const long long nt = (ni_loc + kTI - 1) / kTI;
  const long long t_lo = nt * part / P, t_hi = nt * (part + 1) / P;
  const long long lo = t_lo * kTI, hi = min(ni_loc, t_hi * kTI);
  const float* Vs = V + static_cast<size_t>(shard) * ni_loc * r;
  const unsigned char* vs = valid + static_cast<size_t>(shard) * ni_loc;
  const long long base = id0 + static_cast<long long>(shard) * ni_loc + lo;
  const int r8 = rank8(r);
  const int nch = (r8 + kDK - 1) / kDK;
  const int nst = static_cast<int>(t_hi - t_lo) * nch;
  const int cb = r % 4 == 0 ? 16 : r % 2 == 0 ? 8 : 4;
  const int sh = cb == 16 ? 3 : cb == 8 ? 4 : 5;

  for (int t = tid; t < kTU * k; t += kThreads) {
    ls[t] = kNegInf;
    li[t] = 0;
  }
  for (int t = tid; t < kTU; t += kThreads) {
    ts[t] = kNegInf;
    ti[t] = 0;
    qn[t] = 0;
  }
  if (kResident) {
    for (int t = tid; t < kTU * r8; t += kThreads) {
      const int row = t / r8, d = t % r8;
      us[row * L.ldu + d] =
          (u0 + row < n && d < r) ? U[(u0 + row) * r + d] : 0.f;
    }
  }
  auto issue = [&](int st) {
    if (st < nst) {
      float* dst = ring + (st % kStages) * kStage;
      const int d0 = (st % nch) * kDK;
      stage_rows(dst, Vs, lo + static_cast<long long>(st / nch) * kTI, hi,
                 kTI, d0, r, cb, sh);
      if (!kResident)
        stage_rows(dst + kTI * kLd, U, u0, n, kTU, d0, r, cb, sh);
    }
    tc::commit();  // one group a stage, empty or not: the wait counts on it
  };
  for (int st = 0; st < kStages - 1; ++st) issue(st);

  float run[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) run[m][j][q] = 0.f;

  // Thread-local value (m, h, j, c), bit ((m·2 + h)·4 + j)·2 + c, is the
  // score run[m][j][2h + c] of row 32wm + 16m + 8h + gid and item
  // 32wn + 8j + 2tig + c of a tile.
  auto bit_of = [](int m, int h, int j, int c) {
    return 1u << (((m * 2 + h) * 4 + j) * 2 + c);
  };
  // queue the values in `pend` of the tile whose item 0 is it0; what a
  // full queue does not take stays in pend
  auto push = [&](unsigned& pend, int it0) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (pend & bit_of(m, h, j, c)) {
              const int row = wm * 32 + 16 * m + 8 * h + gid;
              const int q = atomicAdd(qn + row, 1);
              if (q < kQ) {
                qs[row * kQ + q] = run[m][j][2 * h + c];
                qi[row * kQ + q] = it0 + wn * 32 + 8 * j + 2 * tig + c;
                pend &= ~bit_of(m, h, j, c);
              }
            }
  };
  // Fold the queued survivors of the tile before (item 0 at it0); while a
  // full queue left some behind (`spill`, the block's or of pend), re-test
  // them against the new k-th keys and queue them again.  Without a spill
  // no barrier: the next one a selection passes makes the folds visible.
  // warp w folds rows w, w + kWarps, ...: those a lane finds queued
  auto fold_rows = [&]() {
    const int row = warp + kWarps * lane;
    unsigned todo =
        __ballot_sync(0xffffffffu, row < kTU && qn[min(row, kTU - 1)] > 0);
    for (; todo; todo &= todo - 1)
      fold(ls, li, ts, ti, qs, qi, qn, warp + kWarps * (__ffs(todo) - 1), k,
           lane);
  };
  auto settle = [&](bool spill, unsigned& pend, int it0) {
    fold_rows();
    while (spill) {
      __syncthreads();  // the folds are done: the k-th keys are current
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * 32 + 16 * m + 8 * h + gid;
          const float s_k = ts[row];
          const int i_k = ti[row];
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if ((pend & bit_of(m, h, j, c)) &&
                  !better(run[m][j][2 * h + c],
                          it0 + wn * 32 + 8 * j + 2 * tig + c, s_k, i_k))
                pend &= ~bit_of(m, h, j, c);
        }
      push(pend, it0);
      __syncthreads();  // the pushes are done
      fold_rows();
      spill = __syncthreads_or(pend != 0u);
    }
  };

  // the validity of this thread's 8 items of a tile (bit 2j + c), read at
  // the tile's first stage: the load's latency hides behind the products
  unsigned okm = 0;
  unsigned pend = 0;  // the last tile's survivors that no queue took
  int it_last = 0;    // the last tile's item 0
  // st == nst: the last tile's fold only
  for (int st = 0; st <= nst; ++st) {
    tc::wait_pending<kStages - 2>();  // this thread's copies of stage st
    // everyone's copies landed, stage st-1's slot is free, and every
    // survivor of the last tile is queued or left in some pend
    const bool spill = __syncthreads_or(pend != 0u);
    const int ch = st % nch;
    const int it0 = (st / nch) * kTI;  // part-local id of the tile's item 0
    if (st < nst) issue(st + kStages - 1);
    if (ch == 0 && st > 0) {
      settle(spill, pend, it_last);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) run[m][j][q] = 0.f;
    }
    if (st == nst) break;
    if (ch == 0) {
      okm = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const long long it = lo + it0 + wn * 32 + 8 * j + 2 * tig + c;
          okm |= (it < hi && vs[it] ? 1u : 0u) << (2 * j + c);
        }
    }
    const int nk = min(kDK, r8 - ch * kDK) / 8;
    const float* sv = ring + (st % kStages) * kStage + (wn * 32) * kLd;
    const float* su = kResident ? us + (wm * 32) * L.ldu + ch * kDK
                                : ring + (st % kStages) * kStage + kTI * kLd +
                                      (wm * 32) * kLd;
    const int ldu = kResident ? L.ldu : kLd;
    float p[2][4][4];  // the chunk's partial sums
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) p[m][j][q] = 0.f;
    // only the last chunk of a rank not a multiple of 32 has nk < 4
    switch (nk) {
      case 4: stage_mma<4>(p, su, ldu, sv, gid, tig); break;
      case 3: stage_mma<3>(p, su, ldu, sv, gid, tig); break;
      case 2: stage_mma<2>(p, su, ldu, sv, gid, tig); break;
      default: stage_mma<1>(p, su, ldu, sv, gid, tig);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) run[m][j][q] += p[m][j][q];
    if (ch != nch - 1) continue;

    // the tile's scores are final: queue those above their row's k-th key
    if (nch == 1) __syncthreads();  // this stage's folds are everyone's
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 32 + 16 * m + 8 * h + gid;
        const float s_k = ts[row];
        const int i_k = ti[row];
        if (u0 + row >= n) continue;  // a row past n takes nothing
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if ((okm >> (2 * j + c) & 1u) &&
                better(run[m][j][2 * h + c],
                       it0 + wn * 32 + 8 * j + 2 * tig + c, s_k, i_k))
              pend |= bit_of(m, h, j, c);
      }
    push(pend, it0);
    it_last = it0;
  }
  tc::wait_pending<0>();
  __syncthreads();  // the last folds are everyone's

  // the kept lists, global ids; a slot no item reached is (NEG_INF, 0)
  if (sets == 1 && !sets_only) {
    for (int t = tid; t < kTU * k; t += kThreads) {
      const long long u = u0 + t / k;
      if (u < n) {
        const float s = ls[t];
        out_s[u * k + t % k] = s;
        out_i[u * k + t % k] = s > kNegInf ? base + li[t] : 0;
      }
    }
    return;
  }
  const size_t setsz = static_cast<size_t>(kTU) * k;
  float* cs = coll_s + (static_cast<size_t>(tile) * sets + set) * setsz;
  long long* ci = coll_i + (static_cast<size_t>(tile) * sets + set) * setsz;
  for (int t = tid; t < kTU * k; t += kThreads) {
    const float s = ls[t];
    cs[t] = s;
    ci[t] = s > kNegInf ? base + li[t] : 0;
  }
  if (sets_only) return;  // merged by merge_kernel, across processes
  __threadfence();  // the set is visible device-wide before the ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + tile, 1u) == sets - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // merge the tile's sets in set order: per row, lane j holds the heads
  // of sets j, j + 32, ... of their sorted lists; k steps of a warp-wide
  // argmax
  const float* t_s = coll_s + static_cast<size_t>(tile) * sets * setsz;
  const long long* t_i = coll_i + static_cast<size_t>(tile) * sets * setsz;
  // a head is a byte (k <= 128) in the shared memory the scan is done
  // with, `sets` bytes for each of the W warps that merge
  const int W = min(kWarps, mem / sets);
  if (warp >= W) return;
  unsigned char* hd = smem + static_cast<size_t>(warp) * sets;
  for (int row = warp; row < kTU; row += W) {
    const long long u = u0 + row;
    if (u >= n) break;
    const size_t at = static_cast<size_t>(row) * k;
    merge_row(
        [&](int s, int h) {
          return __ldcg(t_s + static_cast<size_t>(s) * setsz + at + h);
        },
        [&](int s, int h) {
          return __ldcg(t_i + static_cast<size_t>(s) * setsz + at + h);
        },
        sets, k, hd, lane, out_s + u * k, out_i + u * k);
  }
}

// The sets of a user tile across processes (merge-from-sets): query rows
// [q0, q0 + nq) of U, warp w of block b merging row q0 + b·W + w, W =
// blockDim.x / 32.  The S·P sets of a row are reached through
// `nbase` base pointers (one a process, its own and its peers' mapped
// buffers, in process order), each buffer holding `spb` sets of every
// user tile as the scan writes them, [tiles, spb, kTU, k]: set g is set
// g % spb of buffer g / spb, so the sets come in shard and part order.
// The merge is the scan's own (merge_row), so a row's result is the
// one-process launch's bit for bit.  A row need not start a user tile.
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* const* __restrict__ bases_s,
             const long long* const* __restrict__ bases_i, int nbase,
             int spb, long long q0, long long nq, int k,
             float* __restrict__ out_s, long long* __restrict__ out_i) {
  extern __shared__ unsigned char heads[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int sets = nbase * spb;
  const long long q = static_cast<long long>(blockIdx.x) * W + warp;
  if (q >= nq) return;
  const long long u = q0 + q;
  const long long tile = u / kTU;
  const int row = static_cast<int>(u - tile * kTU);
  const size_t setsz = static_cast<size_t>(kTU) * k;
  // set g's list: set g % spb of the tile in buffer g / spb
  auto at = [&](int g) {
    const int b = g / spb;
    return (static_cast<size_t>(tile) * spb + (g - b * spb)) * setsz +
           static_cast<size_t>(row) * k;
  };
  merge_row([&](int s, int h) { return bases_s[s / spb][at(s) + h]; },
            [&](int s, int h) { return bases_i[s / spb][at(s) + h]; },
            sets, k, heads + static_cast<size_t>(warp) * sets, lane,
            out_s + q * k, out_i + q * k);
}

// The scan's launch, for every entry: S shards of ni_loc items, each cut
// in P parts, ids offset by id0; sets_only writes every set to coll and
// merges none (then tickets are unused).
inline int launch_scan(const float* U, const float* V,
                       const unsigned char* valid, float* coll_s,
                       long long* coll_i, unsigned* tickets, float* out_s,
                       long long* out_i, long long n, long long ni_loc,
                       int S, int P, int r, int k, long long id0,
                       bool sets_only, cudaStream_t stream) {
  if (n <= 0) return 0;
  const long long sets = static_cast<long long>(S) * P;
  if (k < 1 || k > kMaxK || r < 1 || S < 1 || P < 1 ||
      sets > kMaxSetsY || ni_loc < 1 || id0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n + kTU - 1) / kTU;
  // part-local ids are ints
  const long long part_items = ((ni_loc + kTI - 1) / kTI + P - 1) / P * kTI;
  if (tiles > 0x7fffffffLL || part_items > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((sets > 1 || sets_only) &&
      (coll_s == nullptr || coll_i == nullptr ||
       (!sets_only && tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the staged copies need V (and U when streamed) aligned to their width
  const int cb = r % 4 == 0 ? 16 : r % 2 == 0 ? 8 : 4;
  if (reinterpret_cast<uintptr_t>(V) % cb != 0 ||
      reinterpret_cast<uintptr_t>(U) % cb != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const bool res = resident(k, r);
  size_t smem = layout(k, r, res).total;
  // the merge's heads: a byte a set for each warp, fewer warps when the
  // block's memory cannot hold them all
  const size_t heads = static_cast<size_t>(kWarps) * sets;
  if (!sets_only && heads > smem) smem = heads < kMaxSmem ? heads : kMaxSmem;
  auto kern = res ? scan_kernel<true> : scan_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(sets)),
         kThreads, smem, stream>>>(U, V, valid, coll_s, coll_i, tickets,
                                   out_s, out_i, n, ni_loc, P, r, k,
                                   static_cast<int>(smem), id0, sets_only);
  return static_cast<int>(cudaGetLastError());
}

// Launch the scan over S shards of ni_loc items, each cut in P parts.
// coll_s / coll_i: scratch of ceil(n / kTU)·S·P·kTU·k entries and
// tickets: ceil(n / kTU) zeroed counters, when S·P > 1 (else unused).
// S·P up to kMaxSetsY sets.
inline int launch(const float* U, const float* V, const unsigned char* valid,
                  float* coll_s, long long* coll_i, unsigned* tickets,
                  float* out_s, long long* out_i, long long n,
                  long long ni_loc, int S, int P, int r, int k,
                  cudaStream_t stream) {
  return launch_scan(U, V, valid, coll_s, coll_i, tickets, out_s, out_i, n,
                     ni_loc, S, P, r, k, 0, false, stream);
}

// Merge-from-sets (merge_kernel) of query rows [q0, q0 + nq): bases_s /
// bases_i device arrays of nbase pointers, each buffer [tiles, spb, kTU,
// k]; out [nq, k].  Up to kMaxSetsY sets.
inline int launch_merge(const float* const* bases_s,
                        const long long* const* bases_i, int nbase, int spb,
                        long long q0, long long nq, int k, float* out_s,
                        long long* out_i, cudaStream_t stream) {
  if (nq <= 0) return 0;
  const long long sets = static_cast<long long>(nbase) * spb;
  if (k < 1 || k > kMaxK || nbase < 1 || spb < 1 || sets > kMaxSetsY ||
      q0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // a warp a row, as many warps a block as the heads' memory allows
  const long long fit = static_cast<long long>(kMaxSmem) / sets;
  const int W = static_cast<int>(fit < kWarps ? fit : kWarps);
  const size_t smem = static_cast<size_t>(W) * sets;
  cudaError_t e = cudaFuncSetAttribute(
      merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (nq + W - 1) / W;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  merge_kernel<<<static_cast<unsigned>(blocks), 32 * W, smem, stream>>>(
      bases_s, bases_i, nbase, spb, q0, nq, k, out_s, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace topk
