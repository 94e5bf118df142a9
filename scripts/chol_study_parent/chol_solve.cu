// Kernel K2: batched SPD solve x = A⁻¹ b, rank 1..128, for Hopper (sm_90a).
//
// Replaces: tpu_als/ops/pallas_lanes.py::spd_solve_lanes (body
// _chol_lanes_kernel), the rank <= 128 rung of solve_spd's dispatch that
// fold-in runs.  Same contract: A [n, r, r] f32 arrives regularized (the
// empty-row identity guard and the jitter are applied by solve_spd), b
// [n, r] f32, x [n, r] f32; only the lower triangle of A is read; a row
// with b = 0 solves to x = 0; the pivot is scaled by rsqrt(max(d,
// 1e-30)).  Any r in 1..128 is exact with no padding visible to the
// caller.
//
// What bounds it on this card: the arithmetic, n·(r³/3 + 2r²) flops, is
// ~45 µs at the f32 peak for the fold-in batch of 4096 systems at rank
// 128; reading the lower triangle of A plus b and writing x,
// n·(r(r+1)/2 + 2r)·4 bytes (139.5 MB), is ~42 µs at 3.35 TB/s.  Its
// real limit is latency: the factorization is a serial recurrence over
// the columns, and every block barrier stalls the whole system.
//
// What the design does about it: one block of 8 warps per system, the
// system in 32 x 32 tiles in shared memory (chol_tiled.cuh, 46 KB at rank
// 128; three blocks an SM, by registers, hide each other's barriers).
// The column recurrence of each diagonal tile runs in one warp's
// registers with shuffles (no barrier), the panel below it a row a
// thread in registers, and the O(r³) part is a trailing update in 4 x 4
// register tiles: three barriers per 32 columns.  The substitutions run
// in one warp with no block barrier.  The TPU kernel's batch-in-lanes
// layout, panels and MXU variant exist for Mosaic and are not carried
// over.

#include <cuda_runtime.h>

#include "chol_tiled.cuh"

namespace {

constexpr int kMaxTiles = 4;  // rank 128
constexpr int kThreads = cholt::threads(kMaxTiles);

__global__ void __launch_bounds__(kThreads, 3)
chol_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                  float* __restrict__ x, int r) {
  extern __shared__ __align__(16) float smem[];
  const long long sys = blockIdx.x;
  cholt::fill<false>(smem, r, A + sys * r * r, nullptr,
                     [](int, int, float a) { return a; });
  const int T = cholt::tiles(r);
  cholt::factorize(smem, T);  // opens and closes with a barrier
  cholt::substitute(smem, T, r, b + sys * r, x + sys * r);
}

}  // namespace

extern "C" int chol_solve_f32(const float* A, const float* b, float* x,
                              long long n, int r, void* stream) {
  if (n <= 0) return 0;
  if (r < 1 || r > cholt::kNB * kMaxTiles || n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = cholt::smem_floats(r) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  chol_solve_kernel<<<static_cast<unsigned>(n), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(A, b, x, r);
  return static_cast<int>(cudaGetLastError());
}
