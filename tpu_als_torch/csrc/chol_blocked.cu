// Kernel K1: batched SPD solve x = A⁻¹ b by tiled Cholesky, any rank, for
// Hopper (sm_90a).
//
// Replaces: tpu_als/ops/pallas_solve.py::spd_solve_pallas (body
// _chol_solve_kernel -> factorize/substitute).  Same contract: A [n, r, r]
// f32 arrives regularized (solve_spd's empty-row identity guard and
// jitter), b [n, r] f32, x [n, r] f32; only the lower triangle of A is
// used; a row with b = 0 solves to x = 0; the pivot is scaled by
// rsqrt(max(d, 1e-30)).  The TPU kernel pads r to a panel multiple with
// an identity block; here the padding of the last tile is the identity,
// which gives the same L.
//
// What bounds it on this card: the arithmetic, n·(r³/3 + 2r²) flops,
// against reading A's lower triangle plus b and writing x,
// n·(r(r+1)/2 + 2r)·4 bytes; at rank 128 the two are within 10 % of each
// other.  On the fit's own launches (the wide buckets', 1 to 128 systems
// a launch, fewer than the 132 SMs) its limit is the latency of one
// system: the serial recurrence over the columns and the substitutions.
//
// What the design does about it: one block per system, the system in
// 32 x 32 tiles in shared memory (chol_tiled.cuh, K2's order: 46 KB at
// rank 128, up to rank 288), loaded by 16-byte loads.  Each diagonal
// tile runs in one warp's registers with shuffles, one on a column's
// chain and no predicate or branch on it; the panel a row a thread; the
// O(r³) part in 4 x 4 register tiles: three barriers per 32 columns
// where the first port had one per column.  The forward substitution
// runs in the block's last warp beside the panels and trailing updates,
// the backward one after them, each tile's solve across a warp's lanes
// (div_rn, a shuffle and a multiply-add a step).  A launch with no more
// systems than SMs (the fit's) gives each system 16 warps; a larger one
// at rank <= 128 gives it 8, three blocks an SM (K2's shape).  Above rank
// 288 the system streams (chol_tiled.cuh::stream_solve, the same
// arithmetic), and L is written over A: the wrapper hands it a copy.
// A thread-block cluster splitting a system over SMs would divide only
// the trailing update, about a tenth of a rank-128 launch (PERF.md), so
// the design has none.

#include <cuda_runtime.h>

#include "chol_tiled.cuh"

extern "C" int chol_blocked_f32(const float* A, const float* b, float* x,
                                long long n, int r, void* stream) {
  return cholt::launch<false, true, false>(const_cast<float*>(A), b, x, n,
                                           r,
                                           static_cast<cudaStream_t>(stream));
}
