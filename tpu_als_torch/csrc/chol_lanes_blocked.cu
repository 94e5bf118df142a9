// Kernel K6: batched Cholesky factor L (A = L Lᵀ) for ranks above 128,
// written over A, and the fused solve x = A⁻¹ b, for Hopper (sm_90a).
//
// Replaces: tpu_als/ops/pallas_lanes_blocked.py::chol_lanes_blocked (body
// _chol_blocked_kernel) and, fused, spd_solve_lanes_blocked's two
// triangular solves.  Same contract: A [n, r, r] f32 arrives regularized
// (solve_spd's empty-row identity guard and jitter); only its lower
// triangle is used; L overwrites A in place (the TPU kernel's
// input_output_aliases), with exact zeros above the diagonal, as the
// reference returns tril(L); the diagonal blocks' pivots are scaled by
// rsqrt(max(d, 1e-30)), and the blocks below divide by max(L_jj, 1e-30),
// as do the fused substitutions.  Any rank >= 1 is taken.
//
// What bounds it on this card: r³/3 flops per system (plus 2r² for the
// solve) against reading the lower triangle and writing the whole
// square, (r(r+1)/2 + r²)·4 bytes: at rank 256, 5.6 MFLOP against 0.39
// MB, within 1.5x of each other.  On the fit's launches, a few dozen
// systems on 132 SMs, the latency of one system: the serial chain of
// pivots, panels and substitutions.
//
// What the design does about it: up to rank 288 the whole system stays
// in one block's shared memory (chol_tiled.cuh: 32 x 32 tiles, 167 KB at
// rank 256): loaded once by 16-byte loads, factorized right-looking with
// each diagonal tile in one warp's registers (shuffles, one on a column's
// chain, no barrier), the rows below it a thread a row in registers and
// the trailing update in 4 x 4 register tiles over the other warps, three
// barriers per 32 columns.  The fused entry's forward substitution runs
// in the block's last warp beside the panels and trailing updates; then
// L is written once by 16-byte stores by 15 warps while warp 0 runs the
// backward substitution from the same shared memory.  No earlier column
// and no L is read back from device memory.  A launch with more systems
// than SMs at rank <= 128 gives each 8 warps, three blocks an SM; else 16
// warps a system.  Above rank 288 the same arithmetic streams
// (chol_tiled.cuh::stream_solve): block column by block column, its
// tiles formed from the L already written (left-looking), 23 KB of
// shared memory at any rank.  No tensor cores, so no TF32 rounding.  The
// plain versions are ops/cuda_lanes_blocked.py::chol_lanes_blocked_plain
// and chol_lanes_blocked_solve_plain.

#include <cuda_runtime.h>

#include "chol_tiled.cuh"

extern "C" int chol_lanes_blocked_f32(float* A, long long n, int r,
                                      void* stream) {
  return cholt::launch<true, false, true>(
      A, nullptr, nullptr, n, r, static_cast<cudaStream_t>(stream));
}

// L written over A, and x [n, r] = A⁻¹ b [n, r]
extern "C" int chol_lanes_blocked_solve_f32(float* A, const float* b,
                                            float* x, long long n, int r,
                                            void* stream) {
  return cholt::launch<true, true, true>(A, b, x, n, r,
                                         static_cast<cudaStream_t>(stream));
}
