// Kernel K4: the fused half-step — gather, Gram, ridge/YᵀY tail and the
// Cholesky solve in one kernel, for Hopper (sm_90a).
//
// Replaces: tpu_als/ops/pallas_gather_ne.py::gather_solve (body
// _gather_solve_kernel), behind gather_fused_solve_explicit/implicit —
// the kernel the JAX main path resolves to on a TPU.  Same contract:
// V [N, r] (f32 or bf16), cols [n, w] int32, aw/bw/cw [n, w] in V's type,
// YᵀY [r, r] f32 (null: zero) -> x [n, r] f32; per row
//   A = Σ (aw·v)(aw·v)ᵀ or Σ (aw·v) vᵀ,  b = Σ bw·v,  count = Σ cw,
//   A += YᵀY;  diag += ridge + jitter,  ridge = reg·count rounded in the
//   weight type (count rounded, times the rounded reg, rounded again:
//   the reduce_precision pair of the reference's tail);
//   count <= 0 (no ratings, or implicit rows with no positive rating):
//   A := (1 + jitter)·I, and b is 0 there, so x is exactly 0;
//   x = A⁻¹ b by K1's blocked Cholesky (chol_blocked.cuh), in place.
// Neither the gathered rows nor A nor b reach device memory; only x is
// written.
//
// What bounds it on this card: operations.  Per padded entry the Gram
// takes r(r+1) + 2r flops (16,768 at rank 128) against r·4 + 16 bytes
// gathered (528); per row the solve adds r³/3 + 2r² flops.
//
// What the design does about it: one block per row, gram.cuh's
// register-tiled accumulation, then the tail and the solve run on the
// packed lower triangle in shared memory: at rank <= 128 the triangle
// (33 KB) is written from the registers into the space the staging used;
// at rank <= 256 the running sums are already that triangle (131.6 KB,
// 197.6 KB with the staging, whose space then holds the panel).  Rows
// wider than the trainer's split width do not come here: kernel K3
// spreads their width over blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "chol_blocked.cuh"
#include "gram.cuh"

namespace {

// floats of shared memory at rank r: the running sums (rank > 128), then
// the staging, whose space the solve reuses once the Gram is built
template <int kMaxRank>
__host__ __device__ inline int smem_floats(int r) {
  const int stage = gram::stage_floats(r);
  if constexpr (gram::Acc<kMaxRank>::kInRegisters) {
    const int solve = cholb::smem_floats(r) + r + 1;  // + b, count
    return solve > stage ? solve : stage;
  } else {
    const int solve = cholb::kPanel * r + r + r + 1;  // panel, res, b, count
    return gram::sums_floats<kMaxRank>(r) + (solve > stage ? solve : stage);
  }
}

template <typename T, bool kTwoSided, int kMaxRank>
__global__ void __launch_bounds__(gram::Acc<kMaxRank>::kThreads,
                                  kMaxRank <= 128 ? 2 : 1)
gather_solve_kernel(const T* __restrict__ V, const int* __restrict__ cols,
                    const T* __restrict__ aw, const T* __restrict__ bw,
                    const T* __restrict__ cw, const float* __restrict__ YtY,
                    float* __restrict__ x, int r, long long w, float reg_w,
                    float jitter) {
  using Acc = gram::Acc<kMaxRank>;
  extern __shared__ __align__(16) float smem[];
  const long long row = blockIdx.x;
  float* stage = smem + gram::sums_floats<kMaxRank>(r);
  Acc acc;
  gram::init(acc, r, smem);
  gram::accumulate<T, kTwoSided>(V, cols + row * w, aw + row * w,
                                 bw + row * w, cw + row * w, r, 0, w, stage,
                                 acc);
  __syncthreads();  // the stage is dead; its space becomes the system's
  float* S = smem;  // the packed lower triangle
  float* Lp = Acc::kInRegisters ? S + cholb::tri(r) : stage;
  float* res = Lp + cholb::kPanel * r;
  float* bs = res + r;
  float* cnt_s = bs + r;
  if constexpr (Acc::kInRegisters) {
    gram::for_each_lower(acc, r, [&](int i, int c, float v) {
      S[cholb::tri(i) + c] = v;
    });
  }
  if (threadIdx.x < r) bs[threadIdx.x] = acc.b;
  if (threadIdx.x == 0) *cnt_s = acc.cnt;
  __syncthreads();
  const float cnt = *cnt_s;
  const float ridge = gram::round_w<T>(gram::round_w<T>(cnt) * reg_w);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < r; i += Acc::kThreads / 32) {
    float* Si = S + cholb::tri(i);
    for (int c = lane; c <= i; c += 32) {
      float a = Si[c];
      if (YtY != nullptr) a += YtY[i * r + c];
      if (i == c) a = (a + ridge) + jitter;
      if (cnt <= 0.f) a = (i == c) ? 1.f + jitter : 0.f;
      Si[c] = a;
    }
  }
  cholb::factorize(S, Lp, r);  // opens and closes with a barrier
  cholb::substitute(S, r, res, bs, x + row * r);
}

template <typename T, bool kTwoSided, int kMaxRank>
cudaError_t launch(const void* V, const int* cols, const void* aw,
                   const void* bw, const void* cw, const float* YtY,
                   float* x, long long n, long long w, int r, float reg_w,
                   float jitter, cudaStream_t stream) {
  auto kern = gather_solve_kernel<T, kTwoSided, kMaxRank>;
  const size_t smem = smem_floats<kMaxRank>(r) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<static_cast<unsigned>(n), gram::Acc<kMaxRank>::kThreads, smem,
         stream>>>(
      static_cast<const T*>(V), cols, static_cast<const T*>(aw),
      static_cast<const T*>(bw), static_cast<const T*>(cw), YtY, x, r, w,
      reg_w, jitter);
  return cudaGetLastError();
}

// the instantiation for rank r: 128 up to rank 128, 256 above
template <typename T, bool kTwoSided>
cudaError_t launch_rank(const void* V, const int* cols, const void* aw,
                        const void* bw, const void* cw, const float* YtY,
                        float* x, long long n, long long w, int r,
                        float reg_w, float jitter, cudaStream_t stream) {
  return r <= 128
      ? launch<T, kTwoSided, 128>(V, cols, aw, bw, cw, YtY, x, n, w, r,
                                  reg_w, jitter, stream)
      : launch<T, kTwoSided, 256>(V, cols, aw, bw, cw, YtY, x, n, w, r,
                                  reg_w, jitter, stream);
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
