// Kernel K4: the fused half-step — gather, Gram, ridge/YᵀY tail and the
// Cholesky solve in one kernel, for Hopper (sm_90a).
//
// Replaces: tpu_als/ops/pallas_gather_ne.py::gather_solve (body
// _gather_solve_kernel), behind gather_fused_solve_explicit/implicit —
// the kernel the JAX main path resolves to on a TPU.  Same contract:
// V [N, r] (f32 or bf16), cols [n, w] int32, aw/bw/cw [n, w] in V's type,
// YᵀY [r, r] f32 (null: zero) -> x [n, r] f32; the per-row arithmetic is
// gather_solve.cuh's (shared with the ring kernel K7).
//
// What bounds it on this card: operations.  Per padded entry the Gram
// takes r(r+1) + 2r flops (16,768 at rank 128) against r·4 + 16 bytes
// gathered (528); per row the solve adds r³/3 + 2r² flops.
//
// What the design does about it: one block per row, gram.cuh's
// register-tiled accumulation, then the tail and the solve on the packed
// lower triangle in shared memory.  Rows wider than the trainer's split
// width do not come here: kernel K3 spreads their width over blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gather_solve.cuh"

namespace {

template <typename T, bool kTwoSided, int kMaxRank>
__global__ void __launch_bounds__(gram::Acc<kMaxRank>::kThreads,
                                  kMaxRank <= 128 ? 2 : 1)
gather_solve_kernel(const T* __restrict__ V, const int* __restrict__ cols,
                    const T* __restrict__ aw, const T* __restrict__ bw,
                    const T* __restrict__ cw, const float* __restrict__ YtY,
                    float* __restrict__ x, int r, long long w, float reg_w,
                    float jitter) {
  extern __shared__ __align__(16) float smem[];
  const long long row = blockIdx.x;
  const gram::RowEntries<T> src{V, cols + row * w, aw + row * w,
                                bw + row * w, cw + row * w, r};
  gsolve::solve_row<T, kTwoSided, kMaxRank>(src, w, YtY, x + row * r, r,
                                            reg_w, jitter, smem);
}

// the instantiation for rank r: 128 up to rank 128, 256 above
template <typename T, bool kTwoSided>
cudaError_t launch_rank(const void* V, const int* cols, const void* aw,
                        const void* bw, const void* cw, const float* YtY,
                        float* x, long long n, long long w, int r,
                        float reg_w, float jitter, cudaStream_t stream) {
  const T* v = static_cast<const T*>(V);
  const T* a = static_cast<const T*>(aw);
  const T* b = static_cast<const T*>(bw);
  const T* c = static_cast<const T*>(cw);
  return r <= 128
      ? gsolve::launch<128>(gather_solve_kernel<T, kTwoSided, 128>, n, r,
                            stream, v, cols, a, b, c, YtY, x, r, w, reg_w,
                            jitter)
      : gsolve::launch<256>(gather_solve_kernel<T, kTwoSided, 256>, n, r,
                            stream, v, cols, a, b, c, YtY, x, r, w, reg_w,
                            jitter);
}

}  // namespace

// reg_w: the ridge coefficient already rounded to the weight type.
extern "C" int gather_solve(const void* V, const int* cols, const void* aw,
                            const void* bw, const void* cw, const float* YtY,
                            float* x, long long n, long long w, int r,
                            float reg_w, float jitter, int two_sided,
                            int bf16, void* stream) {
  if (n <= 0) return 0;
  if (r < 1 || r > gram::kRankLimit || w < 1 || n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bf16)
    e = two_sided
        ? launch_rank<__nv_bfloat16, true>(V, cols, aw, bw, cw, YtY, x, n, w,
                                           r, reg_w, jitter, st)
        : launch_rank<__nv_bfloat16, false>(V, cols, aw, bw, cw, YtY, x, n,
                                            w, r, reg_w, jitter, st);
  else
    e = two_sided
        ? launch_rank<float, true>(V, cols, aw, bw, cw, YtY, x, n, w, r,
                                   reg_w, jitter, st)
        : launch_rank<float, false>(V, cols, aw, bw, cw, YtY, x, n, w, r,
                                    reg_w, jitter, st);
  return static_cast<int>(e);
}
