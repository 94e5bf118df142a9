// Kernel K6: batched Cholesky factor L (A = L Lᵀ) for ranks above 128,
// written over A, for Hopper (sm_90a).
//
// Replaces: tpu_als/ops/pallas_lanes_blocked.py::chol_lanes_blocked (body
// _chol_blocked_kernel).  Same contract: A [n, r, r] f32 arrives
// regularized (solve_spd's empty-row identity guard and jitter); only its
// lower triangle is read; L overwrites A in place (the TPU kernel's
// input_output_aliases), with exact zeros above the diagonal, as the
// reference returns tril(L); the diagonal blocks' pivots are scaled by
// rsqrt(max(d, 1e-30)), and the blocks below divide by max(L_jj, 1e-30).
// The two substitutions run outside the kernel, as in the reference.  The
// TPU kernel pads r to a multiple of 128 with an identity tail; here the
// last block column is simply narrower, which gives the same L.  Any
// rank >= 1 is taken, and the working set does not grow with it.
//
// What bounds it on this card: r³/3 flops per system against reading the
// lower triangle and writing the whole square, (r(r+1)/2 + r²)·4 bytes:
// at rank 256, 5.6 MFLOP against 0.39 MB, within 1.5x of each other.  An
// f32 system at rank 256 is 256 KB, more than the 227 KB one block may
// hold in shared memory, so the system cannot stay on chip as K1's does.
//
// What the design does about it: one block per system walks the block
// columns of width kB = 64, left-looking.  For block column k, each 64 x 64
// tile of it (the diagonal one first) is loaded into registers (a 4 x 4
// tile per thread) and takes its Schur corrections Σ_{m<k} L_im L_kmᵀ from
// the earlier block columns, which are read back from device memory (the
// lower triangles of the 264 systems in flight, two blocks per SM, are
// 34 MB at rank 256, so they can stay in the 50 MB L2) and staged
// transposed in shared memory, so one pair of 16-byte loads
// feeds 16 multiply-adds.  The diagonal tile is factorized in shared
// memory by K1's column recurrence (chol_blocked.cuh); the rows below it
// are solved against L_kkᵀ kChunk rows at a time, one thread per row.
// Shared memory: 80.5 KB at every rank, two blocks per SM.  No tensor
// cores, so no TF32 rounding.

#include <cuda_runtime.h>

#include "chol_blocked.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kB = 64;             // block column width; tiles are kB x kB
constexpr int kChunk = 128;        // rows solved against L_kk at a time
constexpr int kPad = kB + 4;       // row stride of a staged tile (float4)
constexpr int kStride = kB + 1;    // row stride of the chunk (no conflicts)
constexpr float kPivotFloor = 1e-30f;

constexpr int kSmemFloats = kB * (kB + 1) / 2      // L_kk, packed
                            + cholb::kPanel * kB   // factorize's panel
                            + 2 * kB * kPad        // two staged tiles
                            + kChunk * kStride;    // the rows below

// acc = the tile rows [row0, row0 + kB) x columns [c0, c0 + kB) of A
// (lower triangle only; 0 outside it and beyond r), then minus the Schur
// corrections Σ_{m < c0/kB} L[rows, m-block] · L[c0 block, m-block]ᵀ.
// Thread (ty, tx) holds rows ty*4 + x, columns tx*4 + y.  Opens and closes
// with a barrier.
__device__ __forceinline__ void tile_update(const float* A, int r, int row0,
                                            int c0, float acc[4][4],
                                            float* Pi, float* Pk) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int i = row0 + ty * 4 + x, c = c0 + tx * 4 + y;
      acc[x][y] = (i < r && c <= i) ? A[i * r + c] : 0.f;
    }
  const bool diag = row0 == c0;
  for (int m0 = 0; m0 < c0; m0 += kB) {
    __syncthreads();  // the previous tile's reads of the stage are done
    // stage L[row0 + ρ][m0 + c] at Pi[c * kPad + ρ] (and the diagonal
    // block's rows at Pk), neighbouring threads on neighbouring columns
    for (int e = tid; e < kB * kB; e += kThreads) {
      const int rho = e / kB, c = e - rho * kB;
      const int i = row0 + rho;
      Pi[c * kPad + rho] = i < r ? A[i * r + m0 + c] : 0.f;
      if (!diag) Pk[c * kPad + rho] = A[(c0 + rho) * r + m0 + c];
    }
    __syncthreads();
    const float* Q = diag ? Pi : Pk;
    for (int c = 0; c < kB; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(Pi + c * kPad +
                                                        ty * 4);
      const float4 g = *reinterpret_cast<const float4*>(Q + c * kPad +
                                                        tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] -= av[x] * gv[y];
    }
  }
  __syncthreads();
}

// A is read and written by this kernel, so it is not a read-only
// (const __restrict__) pointer: a block reads back the columns it wrote,
// after a barrier.
__global__ void __launch_bounds__(kThreads, 2)
chol_lanes_blocked_kernel(float* A, int r) {
  extern __shared__ __align__(16) float smem[];
  float* Lkk = smem;                          // tri(kB)
  float* Lp = Lkk + kB * (kB + 1) / 2;        // kPanel * kB
  float* Pi = Lp + cholb::kPanel * kB;        // kB * kPad
  float* Pk = Pi + kB * kPad;                 // kB * kPad
  float* C = Pk + kB * kPad;                  // kChunk * kStride
  A += static_cast<long long>(blockIdx.x) * r * r;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4];
  for (int c0 = 0; c0 < r; c0 += kB) {
    const int bk = min(kB, r - c0);
    // ---- the diagonal tile: corrections, then factorize in place ----
    tile_update(A, r, c0, c0, acc, Pi, Pk);
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int i = ty * 4 + x, c = tx * 4 + y;
        if (i < bk && c <= i) Lkk[cholb::tri(i) + c] = acc[x][y];
      }
    cholb::factorize(Lkk, Lp, bk);  // opens and closes with a barrier
    for (int e = tid; e < bk * bk; e += kThreads) {
      const int i = e / bk, c = e - i * bk;
      A[(c0 + i) * r + c0 + c] = c <= i ? Lkk[cholb::tri(i) + c] : 0.f;
    }
    for (int e = tid; e < c0 * bk; e += kThreads) {  // zeros above
      const int i = e / bk, c = e - i * bk;
      A[i * r + c0 + c] = 0.f;
    }
    // ---- the rows below, kChunk at a time: L_ik = W_ik · L_kk⁻ᵀ ----
    for (int ch0 = c0 + bk; ch0 < r; ch0 += kChunk) {
      const int nrows = min(kChunk, r - ch0);
      for (int t0 = 0; t0 < nrows; t0 += kB) {
        tile_update(A, r, ch0 + t0, c0, acc, Pi, Pk);
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y)
            C[(t0 + ty * 4 + x) * kStride + tx * 4 + y] = acc[x][y];
      }
      __syncthreads();
      // row t: x_j = (w_j - Σ_{m<j} x_m L_kk[j][m]) / max(L_kk[j][j], floor)
      if (tid < nrows) {
        float* w = C + tid * kStride;
        for (int j = 0; j < bk; ++j) {
          const float* Lj = Lkk + cholb::tri(j);
          float s = w[j];
          for (int m = 0; m < j; ++m) s -= w[m] * Lj[m];
          w[j] = s / fmaxf(Lj[j], kPivotFloor);
        }
      }
      __syncthreads();
      for (int e = tid; e < nrows * bk; e += kThreads) {
        const int i = e / bk, c = e - i * bk;
        A[(ch0 + i) * r + c0 + c] = C[i * kStride + c];
      }
      // the next chunk's first tile_update opens with a barrier
    }
  }
}

}  // namespace

extern "C" int chol_lanes_blocked_f32(float* A, long long n, int r,
                                      void* stream) {
  if (n <= 0) return 0;
  if (r < 1 || r > 46340 || n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kSmemFloats * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      chol_lanes_blocked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  chol_lanes_blocked_kernel<<<static_cast<unsigned>(n), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(A, r);
  return static_cast<int>(cudaGetLastError());
}
