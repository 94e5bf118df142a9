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
// padded entry, r³/3 + 2r² per row.  One block per (owner, row), so a
// row's whole S·w stream is one block's work: the widest rows of a
// power-law catalog make a long tail (splitting them over blocks, as K3
// does, is left for later).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gather_solve.cuh"

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

}  // namespace

// bases: a device array of S pointers, shard s's `per` rows of r values;
// reg_w: the ridge coefficient already rounded to the weight type.
extern "C" int gather_solve_ring(const void* const* bases, int per,
                                 const int* cols, const void* aw,
                                 const void* bw, const void* cw,
                                 const float* YtY, float* x, long long D,
                                 int S, long long n, long long w, int r,
                                 float reg_w, float jitter, int two_sided,
                                 int bf16, void* stream) {
  if (D <= 0 || n <= 0) return 0;
  if (r < 1 || r > gram::kRankLimit || w < 1 || S < 1 || per < 1 ||
      D * n > 0x7fffffffLL || static_cast<long long>(S) * per > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bf16)
    e = two_sided
        ? launch_rank<__nv_bfloat16, true>(bases, per, cols, aw, bw, cw, YtY,
                                           x, D, S, n, w, r, reg_w, jitter,
                                           st)
        : launch_rank<__nv_bfloat16, false>(bases, per, cols, aw, bw, cw,
                                            YtY, x, D, S, n, w, r, reg_w,
                                            jitter, st);
  else
    e = two_sided
        ? launch_rank<float, true>(bases, per, cols, aw, bw, cw, YtY, x, D,
                                   S, n, w, r, reg_w, jitter, st)
        : launch_rank<float, false>(bases, per, cols, aw, bw, cw, YtY, x, D,
                                    S, n, w, r, reg_w, jitter, st);
  return static_cast<int>(e);
}
