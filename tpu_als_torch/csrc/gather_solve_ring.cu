// Kernel K7: the fused ring half-step — for every row, the Gram, b and
// count accumulated over the S source shards of the opposite factors in
// ring order, then K4's tail and solve; for Hopper (sm_90a).
//
// Replaces: tpu_als/ops/pallas_gather_ne.py::gather_solve_ring (body
// _gather_solve_ring_kernel), behind gather_fused_ring_explicit/implicit
// — the kernel of solve_backend='gather_fused_ring' under the 'ring'
// strategies.  Same contract, for all D owners at once: the opposite
// factors in S shards of `per` rows (V's type f32 or bf16), reached
// through a device array of S base pointers; cols/aw/bw/cw [D, S, n, w]
// shard-local, source-major and unrotated, weights in V's type; YᵀY
// [r, r] f32 (null: zero) -> x [D, n, r] f32.  Owner d's row walks the
// sources src = (d - t) mod S for t = 0 .. S-1 (the shard the TPU ring
// holds after t rotations), each source's w entries in order, as ONE
// stream of S·w entries through gram.cuh's two-level sums; then
// gather_solve.cuh's tail (the ridge rounded in the weight type, YᵀY,
// jitter, the empty-row guard) and K1's solve.  At S = 1 the stream is
// K4's row and the result is K4's bit for bit.
//
// The transport: on the TPU each chip holds one shard, and the shards
// rotate between chips by in-kernel remote DMA.  Here every shard is
// reached through its base pointer.  On a mesh of logical shards on one
// card the pointers point into one stacked table; a mesh over several
// cards would fill them with peer-mapped pointers (NVLink), and this
// device code would not change.
//
// What bounds it on this card: operations, as K4: r(r+1) + 2r flops per
// real entry, r³/3 + 2r² per row.  A power-law catalog adds a long tail:
// the widest rows' streams are millions of entries, and one block per
// (owner, row) made them run alone at the end of a launch while the other
// SMs idled (PERF.md: the widest bucket took half the launch).
//
// What the design does about the tail: the rows of a bucket all have the
// same stream length S·w.  A bucket with S·w <= `split` keeps the one-block
// body above (at S = 1 it is K4 bit for bit).  A longer one is split over
// blocks in three passes:
//   1. grid (owner·row, chunk, part): chunk k takes entries
//      [k·split, (k+1)·split) of the row's ring stream (a chunk may cross
//      a source boundary) through gram_sm90.cuh's Gram, K3's block body
//      fed by the ring entry source, and writes the partial S, b and
//      count to scratch;
//   2. the partials summed in chunk order (deterministic, no atomics);
//   3. a block per row: gather_solve.cuh's tail unchanged (the ridge
//      rounded in the weight type, YᵀY, jitter, the empty-row guard) and
//      K1's factorization and substitutions in shared memory; only x is
//      written.
// The wrapper launches the passes on row tiles that keep the scratch
// within a fixed budget.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gather_solve.cuh"
#include "gram_sm90.cuh"

namespace {

// The entries of owner `me`'s row `row_id`: entry pos = t·w + k is entry
// k of source shard (me - t) mod S.  A row handle is src·per + local.
template <typename T>
struct RingEntries {
  const T* const* __restrict__ bases;  // [S] shard base pointers
  const int* __restrict__ cols;  // owner me's block [S, n, w]
  const T* __restrict__ aw;
  const T* __restrict__ bw;
  const T* __restrict__ cw;
  long long n, w, row_id;
  int per, S, me, r;
  __device__ __forceinline__ void load(long long pos, int& h, float& a,
                                       float& b, float& c) const {
    const long long t = pos / w;
    int src = me - static_cast<int>(t);
    if (src < 0) src += S;
    const size_t idx =
        (static_cast<size_t>(src) * n + row_id) * w + (pos - t * w);
    h = src * per + cols[idx];
    a = gram::to_f(aw[idx]);
    b = gram::to_f(bw[idx]);
    c = gram::to_f(cw[idx]);
  }
  __device__ __forceinline__ const T* row(int h) const {
    const int src = h / per;
    return bases[src] + static_cast<size_t>(h - src * per) * r;
  }
};

template <typename T, bool kTwoSided, int kMaxRank>
__global__ void __launch_bounds__(gram::Acc<kMaxRank>::kThreads,
                                  kMaxRank <= 128 ? 2 : 1)
gather_solve_ring_kernel(const T* const* __restrict__ bases, int per,
                         const int* __restrict__ cols,
                         const T* __restrict__ aw, const T* __restrict__ bw,
                         const T* __restrict__ cw,
                         const float* __restrict__ YtY, float* __restrict__ x,
                         int S, long long n, long long w, int r, float reg_w,
                         float jitter) {
  extern __shared__ __align__(16) float smem[];
  const long long blk = blockIdx.x;  // owner-major: blk = me·n + row
  const int me = static_cast<int>(blk / n);
  const long long row = blk - static_cast<long long>(me) * n;
  const size_t own = static_cast<size_t>(me) * S * n * w;
  const RingEntries<T> src{bases, cols + own, aw + own, bw + own, cw + own,
                           n, w, row, per, S, me, r};
  gsolve::solve_row<T, kTwoSided, kMaxRank>(src, S * w, YtY, x + blk * r, r,
                                            reg_w, jitter, smem);
}

// Pass 1 of the split: the partial Gram, b and count of chunk blockIdx.y
// of rows [row0, row0 + nrows) of every owner; part [D·nrows, nchunk, E],
// E = r·r + r + 1.
template <typename T, bool kTwoSided>
__global__ void __launch_bounds__(g90::kMaxThreads, 1)
ring_gram_kernel(const T* const* __restrict__ bases, int per,
                 const int* __restrict__ cols, const T* __restrict__ aw,
                 const T* __restrict__ bw, const T* __restrict__ cw,
                 float* __restrict__ part, int S, long long n, long long w,
                 int r, long long row0, long long nrows, long long split) {
  extern __shared__ __align__(16) float smem[];  // as the one-block body's
  const long long blk = blockIdx.x;  // owner-major: blk = me·nrows + i
  const int me = static_cast<int>(blk / nrows);
  const long long row = row0 + blk - static_cast<long long>(me) * nrows;
  const size_t own = static_cast<size_t>(me) * S * n * w;
  const RingEntries<T> src{bases, cols + own, aw + own, bw + own, cw + own,
                           n, w, row, per, S, me, r};
  const int k = blockIdx.y, nchunk = gridDim.y;
  const long long len = S * w, w0 = k * split;
  const long long w1 = w0 + split < len ? w0 + split : len;
  g90::Acc acc;
  g90::gram<T, kTwoSided>(src, r, w0, w1, blockIdx.z,
                          reinterpret_cast<unsigned char*>(smem), acc);
  const long long E = static_cast<long long>(r) * r + r + 1;
  float* o = part + (blk * nchunk + k) * E;
  g90::store(acc, r, blockIdx.z, o, o + r * r, o + r * r + r);
}

constexpr int kTailThreads = 256;

// floats of shared memory of pass 3: the packed triangle, K1's panel, the
// substitution vector and b
__host__ __device__ inline int tail_floats(int r) {
  return cholb::smem_floats(r) + r;
}

// Pass 3: per row, gather_solve.cuh's tail on the summed Gram (sums
// [D·nrows, E]), then K1's solve in place; x [D, n, r].
template <typename T>
__global__ void __launch_bounds__(kTailThreads)
ring_tail_solve_kernel(const float* __restrict__ sums,
                       const float* __restrict__ YtY, float* __restrict__ x,
                       long long n, int r, long long row0, long long nrows,
                       float reg_w, float jitter) {
  extern __shared__ __align__(16) float smem[];
  const long long blk = blockIdx.x;
  const int me = static_cast<int>(blk / nrows);
  const long long row = row0 + blk - static_cast<long long>(me) * nrows;
  const long long E = static_cast<long long>(r) * r + r + 1;
  const float* Sg = sums + blk * E;
  const float cnt = Sg[r * r + r];
  float* S = smem;  // the packed lower triangle
  float* Lp = S + cholb::tri(r);
  float* res = Lp + cholb::kPanel * r;
  float* bs = res + r;
  const float ridge = gram::round_w<T>(gram::round_w<T>(cnt) * reg_w);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < r; i += kTailThreads / 32) {
    float* Si = S + cholb::tri(i);
    for (int c = lane; c <= i; c += 32) {
      float a = Sg[i * r + c];
      if (YtY != nullptr) a += YtY[i * r + c];
      if (i == c) a = (a + ridge) + jitter;
      if (cnt <= 0.f) a = (i == c) ? 1.f + jitter : 0.f;
      Si[c] = a;
    }
  }
  for (int i = threadIdx.x; i < r; i += kTailThreads) bs[i] = Sg[r * r + i];
  cholb::factorize(S, Lp, r);  // opens and closes with a barrier
  cholb::substitute(S, r, res, bs, x + (me * n + row) * r);
}

template <typename T, bool kTwoSided>
cudaError_t launch_split(const void* const* bases, int per, const int* cols,
                         const void* aw, const void* bw, const void* cw,
                         const float* YtY, float* x, long long D, int S,
                         long long n, long long w, int r, float reg_w,
                         float jitter, long long split, long long row0,
                         long long nrows, float* part, float* sums,
                         cudaStream_t stream) {
  const int nchunk = static_cast<int>((S * w + split - 1) / split);
  const long long rows = D * nrows;
  auto gk = ring_gram_kernel<T, kTwoSided>;
  const size_t smem = g90::smem_bytes<T>(r);
  cudaError_t e = cudaFuncSetAttribute(
      gk, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(nchunk),
            static_cast<unsigned>(g90::parts(r)));
  gk<<<grid, 32 * g90::warps(r), smem, stream>>>(
      reinterpret_cast<const T* const*>(bases), per, cols,
      static_cast<const T*>(aw), static_cast<const T*>(bw),
      static_cast<const T*>(cw), part, S, n, w, r, row0, nrows, split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long E = static_cast<long long>(r) * r + r + 1;
  e = g90::launch_sum(part, sums, rows, E, nchunk, stream);
  if (e != cudaSuccess) return e;
  auto tk = ring_tail_solve_kernel<T>;
  const size_t tsmem = tail_floats(r) * sizeof(float);
  e = cudaFuncSetAttribute(tk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(tsmem));
  if (e != cudaSuccess) return e;
  tk<<<static_cast<unsigned>(rows), kTailThreads, tsmem, stream>>>(
      sums, YtY, x, n, r, row0, nrows, reg_w, jitter);
  return cudaGetLastError();
}

template <typename T, bool kTwoSided>
cudaError_t launch_rank(const void* const* bases, int per, const int* cols,
                        const void* aw, const void* bw, const void* cw,
                        const float* YtY, float* x, long long D, int S,
                        long long n, long long w, int r, float reg_w,
                        float jitter, cudaStream_t stream) {
  const T* const* p = reinterpret_cast<const T* const*>(bases);
  const T* a = static_cast<const T*>(aw);
  const T* b = static_cast<const T*>(bw);
  const T* c = static_cast<const T*>(cw);
  return r <= 128
      ? gsolve::launch<128>(gather_solve_ring_kernel<T, kTwoSided, 128>,
                            D * n, r, stream, p, per, cols, a, b, c, YtY, x,
                            S, n, w, r, reg_w, jitter)
      : gsolve::launch<256>(gather_solve_ring_kernel<T, kTwoSided, 256>,
                            D * n, r, stream, p, per, cols, a, b, c, YtY, x,
                            S, n, w, r, reg_w, jitter);
}

template <typename T, bool kTwoSided>
cudaError_t launch_either(const void* const* bases, int per, const int* cols,
                          const void* aw, const void* bw, const void* cw,
                          const float* YtY, float* x, long long D, int S,
                          long long n, long long w, int r, float reg_w,
                          float jitter, long long split, long long row0,
                          long long nrows, float* part, float* sums,
                          cudaStream_t stream) {
  if (split > 0 && S * w > split)
    return launch_split<T, kTwoSided>(bases, per, cols, aw, bw, cw, YtY, x,
                                      D, S, n, w, r, reg_w, jitter, split,
                                      row0, nrows, part, sums, stream);
  return launch_rank<T, kTwoSided>(bases, per, cols, aw, bw, cw, YtY, x, D,
                                   S, n, w, r, reg_w, jitter, stream);
}

}  // namespace

// bases: a device array of S pointers, shard s's `per` rows of r values;
// reg_w: the ridge coefficient already rounded to the weight type.
// split: when the rows' streams are longer (S·w > split > 0), the rows
// [row0, row0 + nrows) of every owner take the three passes, with scratch
// part [D·nrows, nchunk, r·r + r + 1] (nchunk = ceil(S·w / split)) and
// sums [D·nrows, r·r + r + 1]; otherwise every row runs the one-block
// body, and row0, nrows, part and sums are not used.
extern "C" int gather_solve_ring(const void* const* bases, int per,
                                 const int* cols, const void* aw,
                                 const void* bw, const void* cw,
                                 const float* YtY, float* x, long long D,
                                 int S, long long n, long long w, int r,
                                 float reg_w, float jitter, int two_sided,
                                 int bf16, long long split, long long row0,
                                 long long nrows, float* part, float* sums,
                                 void* stream) {
  if (D <= 0 || n <= 0) return 0;
  if (r < 1 || r > gram::kRankLimit || w < 1 || S < 1 || per < 1 ||
      D * n > 0x7fffffffLL || static_cast<long long>(S) * per > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (split > 0 && S * w > split &&
      (row0 < 0 || nrows < 1 || row0 + nrows > n || !part || !sums ||
       (S * w + split - 1) / split > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bf16)
    e = two_sided
        ? launch_either<__nv_bfloat16, true>(
              bases, per, cols, aw, bw, cw, YtY, x, D, S, n, w, r, reg_w,
              jitter, split, row0, nrows, part, sums, st)
        : launch_either<__nv_bfloat16, false>(
              bases, per, cols, aw, bw, cw, YtY, x, D, S, n, w, r, reg_w,
              jitter, split, row0, nrows, part, sums, st);
  else
    e = two_sided
        ? launch_either<float, true>(bases, per, cols, aw, bw, cw, YtY, x, D,
                                     S, n, w, r, reg_w, jitter, split, row0,
                                     nrows, part, sums, st)
        : launch_either<float, false>(bases, per, cols, aw, bw, cw, YtY, x,
                                      D, S, n, w, r, reg_w, jitter, split,
                                      row0, nrows, part, sums, st);
  return static_cast<int>(e);
}
