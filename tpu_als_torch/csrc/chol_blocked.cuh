// Blocked Cholesky factorize-and-solve of one SPD system in shared memory.
//
// Device routines of kernel K1 (chol_blocked.cu); K6
// (chol_lanes_blocked.cu) factorizes its diagonal blocks with
// factorize().  One thread block owns one system; every routine is
// called by all its threads.
//
// Layout: the lower triangle of the r x r matrix, packed by rows: row i
// starts at S + tri(i), tri(i) = i(i+1)/2, so entry (i, c), c <= i, is
// S[tri(i) + c].  Packing halves the footprint of a square layout, so a
// rank-256 system (131,584 bytes) fits in one block's shared memory.
// Lp is kPanel x r floats of scratch holding the current panel
// transposed (Lp[k * r + i] = L[i][p + k]).
//
// Arithmetic follows tpu_als/ops/pallas_solve.py::factorize/substitute:
// right-looking blocked Cholesky (a panel of kPanel columns factorized
// column by column, then ONE trailing update of the rest per panel), the
// pivot scale rsqrt(max(d, 1e-30)), then forward and back substitution.
// f32 throughout, no tensor cores, so no TF32 rounding.

#pragma once

namespace cholb {

constexpr int kPanel = 16;
constexpr float kPivotFloor = 1e-30f;

__host__ __device__ inline int tri(int i) { return i * (i + 1) / 2; }

// floats of shared memory factorize + substitute need for rank r:
// the packed triangle, the panel scratch and the substitution vector
__host__ __device__ inline int smem_floats(int r) {
  return tri(r) + kPanel * r + r;
}

// In place: S holds A's lower triangle on entry, L's on exit (A = L Lᵀ).
//
// Panel step: thread t owns panel rows p + t, p + t + nt, ... and only
// ever writes its own rows of Lp.  At column jj every thread reads the
// unscaled pivot and the unscaled column jj, updates the later panel
// columns of its rows with the scaled products, and scales its entry of
// column jj - 1 (delayed by one step, so that no thread rewrites column
// jj while another reads it): one barrier per column.  The trailing
// update then subtracts the panel's contribution from every entry right
// of the panel: one barrier per panel.
__device__ __forceinline__ void factorize(float* S, float* Lp, int r) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  for (int p = 0; p < r; p += kPanel) {
    const int pw = min(kPanel, r - p);
    __syncthreads();  // the previous trailing update has landed
    for (int i = p + tid; i < r; i += nt) {
      const float* row = S + tri(i);
      for (int k = 0; k < pw; ++k)
        Lp[k * r + i] = (p + k <= i) ? row[p + k] : 0.f;
    }
    float inv_prev = 0.f;
    for (int jj = 0; jj < pw; ++jj) {
      const int j = p + jj;
      __syncthreads();  // column jj has its final (unscaled) values
      const float inv = rsqrtf(fmaxf(Lp[jj * r + j], kPivotFloor));
      for (int i = p + tid; i < r; i += nt) {
        if (jj > 0 && i >= j - 1) Lp[(jj - 1) * r + i] *= inv_prev;
        if (i > j) {
          const float lij = Lp[jj * r + i] * inv;
          const int cmax = min(pw - 1, i - p);
          for (int c = jj + 1; c <= cmax; ++c)
            Lp[c * r + i] -= lij * (Lp[jj * r + p + c] * inv);
        }
      }
      inv_prev = inv;
    }
    __syncthreads();
    for (int i = p + pw - 1 + tid; i < r; i += nt)
      Lp[(pw - 1) * r + i] *= inv_prev;
    __syncthreads();  // the panel of L is final in Lp
    // write the panel back (columns p .. p+pw-1) ...
    for (int i = p + tid; i < r; i += nt) {
      float* row = S + tri(i);
      for (int k = 0; k < pw && p + k <= i; ++k) row[p + k] = Lp[k * r + i];
    }
    // ... and update the trailing block (columns >= p+pw): one warp per
    // row, neighbouring lanes on neighbouring columns.  Reads only Lp.
    const int q = p + pw;
    for (int i = q + warp; i < r; i += nw) {
      float li[kPanel];
#pragma unroll
      for (int k = 0; k < kPanel; ++k) li[k] = (k < pw) ? Lp[k * r + i] : 0.f;
      float* row = S + tri(i);
      for (int c = q + lane; c <= i; c += 32) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < kPanel; ++k)
          if (k < pw) s += li[k] * Lp[k * r + c];
        row[c] -= s;
      }
    }
  }
  __syncthreads();
}

// Solve L Lᵀ x = b with L from factorize().  The first warp does the
// substitutions (r² / 2 multiply-adds each, too little to pay for block
// barriers); res is r floats of shared scratch, b is read from and x
// written to any memory.  Forward walks the columns of L (an axpy per
// step), backward walks the rows of L, which are the columns of Lᵀ.
// The caller has synchronized the block after factorize().
__device__ __forceinline__ void substitute(const float* S, int r, float* res,
                                           const float* b, float* x) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  for (int i = lane; i < r; i += 32) res[i] = b[i];
  __syncwarp();
  for (int j = 0; j < r; ++j) {  // L y = b
    const float yj = res[j] / S[tri(j) + j];
    __syncwarp();
    if (lane == (j & 31)) res[j] = yj;
    for (int i = j + 1 + lane; i < r; i += 32) res[i] -= yj * S[tri(i) + j];
    __syncwarp();
  }
  for (int j = r - 1; j >= 0; --j) {  // Lᵀ x = y
    const float* row = S + tri(j);
    const float xj = res[j] / row[j];
    __syncwarp();
    if (lane == (j & 31)) x[j] = xj;
    for (int i = lane; i < j; i += 32) res[i] -= xj * row[i];
    __syncwarp();
  }
}

}  // namespace cholb
