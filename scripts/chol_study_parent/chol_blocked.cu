// Kernel K1: batched SPD solve x = A⁻¹ b by blocked Cholesky, for Hopper
// (sm_90a), rank 1..323.
//
// Replaces: tpu_als/ops/pallas_solve.py::spd_solve_pallas (body
// _chol_solve_kernel -> factorize/substitute).  Same contract: A [n, r, r]
// f32 arrives regularized (solve_spd's empty-row identity guard and
// jitter), b [n, r] f32, x [n, r] f32; only the lower triangle of A is
// read; a row with b = 0 solves to x = 0; the pivot is scaled by
// rsqrt(max(d, 1e-30)).  The TPU kernel pads r to a panel multiple with
// an identity block; here the last panel is simply narrower, which gives
// the same L.
//
// What bounds it on this card: the arithmetic, n·(r³/3 + 2r²) flops,
// against reading A's lower triangle plus b and writing x,
// n·(r(r+1)/2 + 2r)·4 bytes; at rank 128 the two are within 10 % of each
// other.  Its real limit is latency: the panel factorization is a serial
// recurrence with one block barrier per column.
//
// What the design does about it: one thread block per system, the whole
// packed triangle in dynamic shared memory (33 KB at rank 128, 131.6 KB at
// rank 256, opt-in above 48 KB); the column recurrence touches only the
// 16-column panel (one barrier per column instead of K2's three), and the
// O(r³) part is one trailing update per panel in which each entry takes
// a 16-term dot product from a transposed copy of the panel, laid out so
// neighbouring lanes read neighbouring words.  Above rank 323 the
// triangle does not fit (rank 256 and up is kernel K6's, not ported).

#include <cuda_runtime.h>

#include "chol_blocked.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
chol_blocked_kernel(const float* __restrict__ A, const float* __restrict__ b,
                    float* __restrict__ x, int r) {
  extern __shared__ float smem[];
  float* S = smem;
  float* Lp = S + cholb::tri(r);
  float* res = Lp + cholb::kPanel * r;
  const long long sys = blockIdx.x;
  const float* Ag = A + sys * r * r;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < r; i += kThreads / 32) {
    float* row = S + cholb::tri(i);
    for (int c = lane; c <= i; c += 32) row[c] = Ag[i * r + c];
  }
  cholb::factorize(S, Lp, r);  // opens and closes with a barrier
  cholb::substitute(S, r, res, b + sys * r, x + sys * r);
}

}  // namespace

extern "C" int chol_blocked_f32(const float* A, const float* b, float* x,
                                long long n, int r, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = cholb::smem_floats(r) * sizeof(float);
  if (r < 1 || smem > 232448 || n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      chol_blocked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  chol_blocked_kernel<<<static_cast<unsigned>(n), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(A, b, x, r);
  return static_cast<int>(cudaGetLastError());
}
