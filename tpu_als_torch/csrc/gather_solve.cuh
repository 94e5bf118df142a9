// The block body of the fused gather-and-solve kernels: one row's Gram
// from an entry source, the ridge/YᵀY/jitter/empty-row tail, and the
// Cholesky solve in place.
//
// Shared by kernel K4 (gather_solve.cu: the entries of one padded CSR
// row) and kernel K7 (gather_solve_ring.cu: the same row's entries over
// S source shards in ring order), so the two run the same arithmetic in
// the same order — at S = 1 K7 is K4 bit for bit.  Per row
//   A = Σ (aw·v)(aw·v)ᵀ or Σ (aw·v) vᵀ,  b = Σ bw·v,  count = Σ cw,
//   A += YᵀY;  diag += ridge + jitter,  ridge = reg·count rounded in the
//   weight type (count rounded, times the rounded reg, rounded again:
//   the reduce_precision pair of the reference's tail);
//   count <= 0 (no ratings, or implicit rows with no positive rating):
//   A := (1 + jitter)·I, and b is 0 there, so x is exactly 0;
//   x = A⁻¹ b by K1's blocked Cholesky (chol_blocked.cuh), in place.
// Neither the gathered rows nor A nor b reach device memory; only x is
// written.  At rank <= 128 the triangle (33 KB) is written from the
// registers into the space the staging used; at rank <= 256 the running
// sums are already that triangle (131.6 KB, 197.6 KB with the staging,
// whose space then holds the panel).

#pragma once

#include <cuda_runtime.h>

#include "chol_blocked.cuh"
#include "gram.cuh"

namespace gsolve {

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

// One row: the entries [0, len) of `src`, then the tail and the solve;
// x_row [r] f32.  Called by every thread of the block; smem holds
// smem_floats<kMaxRank>(r) floats.
template <typename T, bool kTwoSided, int kMaxRank, typename Src>
__device__ __forceinline__ void solve_row(const Src& src, long long len,
                                          const float* __restrict__ YtY,
                                          float* __restrict__ x_row, int r,
                                          float reg_w, float jitter,
                                          float* smem) {
  using Acc = gram::Acc<kMaxRank>;
  float* stage = smem + gram::sums_floats<kMaxRank>(r);
  Acc acc;
  gram::init(acc, r, smem);
  gram::accumulate_entries<T, kTwoSided>(src, r, 0, len, stage, acc);
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
  cholb::substitute(S, r, res, bs, x_row);
}

// Set the kernel's shared-memory limit and launch it on `blocks` blocks.
template <int kMaxRank, typename Kernel, typename... Args>
cudaError_t launch(Kernel kern, long long blocks, int r, cudaStream_t stream,
                   Args... args) {
  const size_t smem = smem_floats<kMaxRank>(r) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<static_cast<unsigned>(blocks), gram::Acc<kMaxRank>::kThreads, smem,
         stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace gsolve
