// Kernel K2: batched SPD solve x = A⁻¹ b, rank 1..128, for Hopper (sm_90a).
//
// Replaces: tpu_als/ops/pallas_lanes.py::spd_solve_lanes (body
// _chol_lanes_kernel), the rank <= 128 rung of solve_spd's dispatch that
// fold-in runs.  Same contract: A [n, r, r] f32 arrives regularized (the
// empty-row identity guard and the jitter are applied by solve_spd), b
// [n, r] f32, x [n, r] f32; a row with b = 0 solves to x = 0; the pivot
// is scaled by rsqrt(max(d, 1e-30)).  Any r in 1..128 is exact with no
// padding visible to the caller.
//
// What bounds it on this card: the arithmetic, n·(r³/3 + 2r²) flops, is
// ~45 µs at the f32 peak for the fold-in batch of 4096 systems at rank
// 128; reading the lower triangle of A plus b and writing x,
// n·(r(r+1)/2 + 2r)·4 bytes (139.5 MB), is ~42 µs at 3.35 TB/s.  Its
// real limit is latency: the column recurrence is serial, with three
// block barriers per column and one per substitution step.
//
// What the design does about it: one thread block per system, with the
// whole system in dynamic shared memory (r·(r|1)·4 bytes, 66 KB at rank
// 128, so up to three blocks share an SM and hide each other's barriers).
// A is read from device memory once, coalesced; nothing but x is
// written.  The TPU kernel's batch-in-lanes layout, panels and MXU
// variant exist for Mosaic and are not carried over.

#include <cuda_runtime.h>

#include "chol.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRank = 128;

__global__ void __launch_bounds__(kThreads)
chol_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                  float* __restrict__ x, int r, int ld) {
  extern __shared__ float smem[];
  float* S = smem;
  float* res = S + r * ld;
  float* y = res + r;
  const long long sys = blockIdx.x;
  const float* Ag = A + sys * r * r;
  for (int t = threadIdx.x; t < r * r; t += blockDim.x) {
    const int i = t / r, c = t % r;
    if (c <= i) S[i * ld + c] = Ag[t];
  }
  chol::factorize(S, r, ld);  // opens with a barrier
  chol::substitute(S, r, ld, res, y, b + sys * r, x + sys * r);
}

}  // namespace

extern "C" int chol_solve_f32(const float* A, const float* b, float* x,
                              long long n, int r, void* stream) {
  if (n <= 0) return 0;
  if (r < 1 || r > kMaxRank || n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ld = chol::leading_dim(r);
  const size_t smem = (static_cast<size_t>(r) * ld + 2 * r) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  chol_solve_kernel<<<static_cast<unsigned>(n), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(A, b, x, r, ld);
  return static_cast<int>(cudaGetLastError());
}
