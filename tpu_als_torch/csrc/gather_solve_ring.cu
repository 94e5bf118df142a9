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
// stream of S·w entries; then gather_solve.cuh's tail (the ridge rounded
// in the weight type, YᵀY, jitter, the empty-row guard) and solve.  At
// S = 1 the stream is K4's row and the result is K4's bit for bit.
//
// The transport: on the TPU each chip holds one shard, and the shards
// rotate between chips by in-kernel remote DMA.  Here every shard is
// reached through its base pointer.  On a mesh of logical shards on one
// card the pointers point into one stacked table; a mesh over several
// cards would fill them with peer-mapped pointers (NVLink), and this
// device code would not change.
//
// What bounds it on this card: operations, as K4: r(r+1) + 2r flops per
// real entry (the Gram on the tensor cores), r³/3 + 2r² per row.  A
// power-law catalog adds a long tail: the widest rows' streams are
// millions of entries, and one block per (owner, row) made them run
// alone at the end of a launch while the other SMs idled.
//
// What the design does: K4's two passes, the Gram fed by the ring entry
// source.  The rows of a bucket all have the same stream length S·w; a
// stream longer than `split` is cut into chunks of `split` entries (a
// chunk may cross a source boundary), one block each:
//   1. grid (owner·row, chunk, part): gram_sm90.cuh's Gram of the chunk
//      (above rank 256 gram_strips.cuh's), its S, b and count to scratch;
//   2. (more than one chunk) the partials summed in chunk order
//      (deterministic, no atomics);
//   3. a block per row: gather_solve.cuh's tail and chol_tiled.cuh's
//      solve, in shared memory up to rank 288; above it a cluster of
//      blocks per row (chol_cluster.cuh, the system in their distributed
//      shared memory); only x is written.
// The wrapper launches the passes on row tiles that keep the scratch
// within a fixed budget.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gather_solve.cuh"
#include "gram_sm90.cuh"
#include "gram_strips.cuh"

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

// Pass 1: the partial Gram, b and count of chunk blockIdx.y (entries
// [k·split, (k+1)·split) of the stream; the whole stream when split
// covers it) of rows [row0, row0 + nrows) of every owner; part
// [D·nrows, nchunk, E], E = gsolve::row_floats(r).  Grid (D·nrows,
// nchunk, parts) at rank <= 256 (gram_sm90.cuh), above it (kStrips,
// gram_strips.cuh) (parts·D·nrows, nchunk), a row's parts side by side.
template <typename T, bool kTwoSided, bool kStrips>
__global__ void __launch_bounds__(kStrips ? gstrips::kThreads
                                          : g90::kMaxThreads, 1)
ring_gram_kernel(const T* const* __restrict__ bases, int per,
                 const int* __restrict__ cols, const T* __restrict__ aw,
                 const T* __restrict__ bw, const T* __restrict__ cw,
                 float* __restrict__ part, int S, long long n, long long w,
                 int r, long long row0, long long nrows, long long split) {
  extern __shared__ __align__(16) float smem[];  // as the solve pass's
  const int np = kStrips ? gstrips::parts(r) : 1;
  // owner-major: blk = me·nrows + i
  const long long blk = kStrips ? blockIdx.x / np : blockIdx.x;
  const int z = kStrips ? static_cast<int>(blockIdx.x - blk * np)
                        : static_cast<int>(blockIdx.z);
  const int me = static_cast<int>(blk / nrows);
  const long long row = row0 + blk - static_cast<long long>(me) * nrows;
  const size_t own = static_cast<size_t>(me) * S * n * w;
  const RingEntries<T> src{bases, cols + own, aw + own, bw + own, cw + own,
                           n, w, row, per, S, me, r};
  const int k = blockIdx.y, nchunk = gridDim.y;
  const long long len = S * w, w0 = k * split;
  const long long w1 = w0 + split < len ? w0 + split : len;
  float* o = part + (blk * nchunk + k) * gsolve::row_floats(r);
  auto* sm = reinterpret_cast<unsigned char*>(smem);
  if constexpr (kStrips) {
    gstrips::Acc acc;
    gstrips::gram<T, kTwoSided>(src, r, w0, w1, z, sm, acc);
    gstrips::store(acc, r, o, o + r * r, o + r * r + r);
  } else {
    g90::Acc acc;
    g90::gram<T, kTwoSided>(src, r, w0, w1, z, sm, acc);
    g90::store(acc, r, z, o, o + r * r, o + r * r + r);
  }
}

// The passes on rows [row0, row0 + nrows) of every owner; the stream is
// cut into nchunk chunks of `split` entries (one chunk: `split` >= S·w).
template <typename T, bool kTwoSided>
cudaError_t launch(const void* const* bases, int per, const int* cols,
                   const void* aw, const void* bw, const void* cw,
                   const float* YtY, float* x, long long D, int S,
                   long long n, long long w, int r, float reg_w,
                   float jitter, long long split, int nchunk, long long row0,
                   long long nrows, float* part, float* sums,
                   cudaStream_t stream) {
  const long long rows = D * nrows;
  const bool strips = r > gram::kRankLimit;
  auto gk = strips ? ring_gram_kernel<T, kTwoSided, true>
                   : ring_gram_kernel<T, kTwoSided, false>;
  const size_t smem =
      strips ? gstrips::smem_bytes<T>() : g90::smem_bytes<T>(r);
  cudaError_t e = cudaFuncSetAttribute(
      gk, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid =
      strips ? dim3(static_cast<unsigned>(rows * gstrips::parts(r)),
                    static_cast<unsigned>(nchunk), 1)
             : dim3(static_cast<unsigned>(rows),
                    static_cast<unsigned>(nchunk),
                    static_cast<unsigned>(g90::parts(r)));
  const int threads = strips ? gstrips::kThreads : 32 * g90::warps(r);
  gk<<<grid, threads, smem, stream>>>(
      reinterpret_cast<const T* const*>(bases), per, cols,
      static_cast<const T*>(aw), static_cast<const T*>(bw),
      static_cast<const T*>(cw), nchunk > 1 ? part : sums, S, n, w, r, row0,
      nrows, split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (nchunk > 1) {
    e = g90::launch_sum(part, sums, rows, gsolve::row_floats(r), nchunk,
                        stream);
    if (e != cudaSuccess) return e;
  }
  return gsolve::launch_tail_solve<T>(sums, YtY, x, D, n, r, row0, nrows,
                                      reg_w, jitter, stream);
}

}  // namespace

// bases: a device array of S pointers, shard s's `per` rows of r values;
// reg_w: the ridge coefficient already rounded to the weight type.  The
// rows [row0, row0 + nrows) of every owner are solved, with scratch sums
// [D·nrows, E], E = gsolve::row_floats(r).  split: when the rows'
// streams are longer (S·w > split > 0), they are cut into nchunk =
// ceil(S·w / split) chunks with scratch part [D·nrows, nchunk, E];
// otherwise (one chunk) part is not used.  Rank <= 512, as K4.
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
  if (r < 1 || r > gram::kSolveRankLimit || w < 1 || S < 1 || per < 1 ||
      D * n > 0x7fffffffLL || static_cast<long long>(S) * per > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long len = S * w;
  const bool cut = split > 0 && len > split;
  const long long chunk = cut ? split : len;
  const long long nchunk = (len + chunk - 1) / chunk;
  if (row0 < 0 || nrows < 1 || row0 + nrows > n || !sums ||
      (cut && !part) || nchunk > 65535 ||
      (r > gram::kRankLimit &&
       D * nrows * gstrips::parts(r) > 0x7fffffffLL))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = static_cast<int>(nchunk);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bf16)
    e = two_sided
        ? launch<__nv_bfloat16, true>(bases, per, cols, aw, bw, cw, YtY, x,
                                      D, S, n, w, r, reg_w, jitter, chunk,
                                      nc, row0, nrows, part, sums, st)
        : launch<__nv_bfloat16, false>(bases, per, cols, aw, bw, cw, YtY, x,
                                       D, S, n, w, r, reg_w, jitter, chunk,
                                       nc, row0, nrows, part, sums, st);
  else
    e = two_sided
        ? launch<float, true>(bases, per, cols, aw, bw, cw, YtY, x, D, S, n,
                              w, r, reg_w, jitter, chunk, nc, row0, nrows,
                              part, sums, st)
        : launch<float, false>(bases, per, cols, aw, bw, cw, YtY, x, D, S,
                               n, w, r, reg_w, jitter, chunk, nc, row0,
                               nrows, part, sums, st);
  return static_cast<int>(e);
}
