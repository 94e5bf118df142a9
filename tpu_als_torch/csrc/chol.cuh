// Cholesky factorize-and-solve of one small SPD system in shared memory.
//
// Device routines shared by the batched SPD solve (chol_solve.cu) and, in
// the training port, by the fused gather-and-solve kernel, which ends in
// the same in-kernel factorization.  One thread block owns one system;
// every routine is called by all threads of the block.
//
// Layout: row i of the r x r matrix starts at S + i * ld.  Only the lower
// triangle (column <= row) is read or written.  ld = r | 1 (odd) keeps a
// column walk (stride ld) on distinct shared-memory banks.
//
// Arithmetic follows tpu_als/ops/pallas_lanes.py::_chol_lanes_kernel:
// pivot scale rsqrt(max(d, 1e-30)), which keeps the scale finite on a
// zero or slightly negative pivot; it does not make a singular system
// solvable (solve_spd's identity guard and jitter are what do that).
// f32 throughout; no tensor cores, so no TF32 rounding.

#pragma once

namespace chol {

constexpr float kPivotFloor = 1e-30f;

__host__ __device__ inline int leading_dim(int r) { return r | 1; }

// In place: S holds A's lower triangle on entry, L's on exit (A = L Lᵀ).
// Right-looking, one column per step, three barriers per column.
__device__ __forceinline__ void factorize(float* S, int r, int ld) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int j = 0; j < r; ++j) {
    __syncthreads();  // the previous column's trailing update has landed
    const float inv = rsqrtf(fmaxf(S[j * ld + j], kPivotFloor));
    __syncthreads();  // every thread holds the pivot before it is scaled
    for (int i = j + tid; i < r; i += nt) S[i * ld + j] *= inv;
    __syncthreads();  // column j of L is final
    // trailing update: S[i][c] -= L[i][j] * L[c][j] for j < c <= i.
    // Neighbouring threads take neighbouring c of one row i.
    const int m = r - j - 1;
    for (int t = tid; t < m * m; t += nt) {
      const int i = j + 1 + t / m;
      const int c = j + 1 + t % m;
      if (c <= i) S[i * ld + c] -= S[i * ld + j] * S[c * ld + j];
    }
  }
  __syncthreads();
}

// Solve L Lᵀ x = b with L from factorize().  res and y are shared
// scratch of r floats each; b is read from and x written to any memory.
// Both substitutions are column-oriented (an axpy per step, one barrier,
// no reduction): forward walks the columns of L, backward walks the rows
// of L, which are the columns of Lᵀ.
__device__ __forceinline__ void substitute(const float* S, int r, int ld,
                                           float* res, float* y,
                                           const float* b, float* x) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < r; i += nt) res[i] = b[i];
  __syncthreads();
  for (int j = 0; j < r; ++j) {  // L y = b
    const float yj = res[j] / S[j * ld + j];
    if (tid == 0) y[j] = yj;
    for (int i = j + 1 + tid; i < r; i += nt) res[i] -= yj * S[i * ld + j];
    __syncthreads();
  }
  for (int j = r - 1; j >= 0; --j) {  // Lᵀ x = y
    const float xj = y[j] / S[j * ld + j];
    if (tid == 0) x[j] = xj;
    for (int i = tid; i < j; i += nt) y[i] -= xj * S[j * ld + i];
    __syncthreads();
  }
}

}  // namespace chol
