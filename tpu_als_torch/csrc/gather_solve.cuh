// The solve pass of the fused gather-and-solve kernels: per row, the
// ridge/YᵀY/jitter/empty-row tail on its summed Gram, then the Cholesky
// solve in shared memory.
//
// Shared by kernel K4 (gather_solve.cu) and kernel K7
// (gather_solve_ring.cu).  Both first build each row's Gram, b and count
// with gram_sm90.cuh's tensor-core Gram (K3's block body) into scratch
// in device memory, E = r·r + r + 1 floats a row (S row-major, b, the
// count); K7 sums its width chunks' partials in order first.  Then this
// pass, per row:
//   A = S + YᵀY;  diag += ridge + jitter,  ridge = reg·count rounded in
//   the weight type (count rounded, times the rounded reg, rounded again:
//   the reduce_precision pair of the reference's tail);
//   count <= 0 (no ratings, or implicit rows with no positive rating):
//   A := (1 + jitter)·I, and b is 0 there, so x is exactly 0;
//   x = A⁻¹ b by chol_tiled.cuh's factorization and substitutions: in
//   shared memory up to rank 288 (cholt::kMaxTiles tiles a side), above
//   it by stream_solve() on A formed in place in the row's scratch, L
//   written over it (the same arithmetic in the same order).
// The same bytes through the same two kernels give the same x, so K7 at
// one shard, unsplit, is K4 bit for bit.

#pragma once

#include <cuda_runtime.h>

#include "chol_tiled.cuh"
#include "gram.cuh"

namespace gsolve {

__host__ __device__ inline bool streamed(int r) {
  return cholt::tiles(r) > cholt::kMaxTiles;
}

// floats of scratch a row needs: S [r, r], b [r], the count; streamed,
// rounded up to a multiple of 4, so every row's A starts 16-byte aligned
// for stream_solve()'s 16-byte loads
__host__ __device__ inline long long row_floats(int r) {
  const long long e = static_cast<long long>(r) * r + r + 1;
  return streamed(r) ? (e + 3) / 4 * 4 : e;
}

// The tail on entry (i, c), c <= i, of a row's a = S (+ YᵀY): the ridge,
// then the jitter, on the diagonal; a row with count <= 0 becomes
// (1 + jitter)·I
__device__ __forceinline__ float tail(int i, int c, float a, float ridge,
                                      float jitter, float cnt) {
  if (i == c) a = (a + ridge) + jitter;
  if (cnt <= 0.f) a = (i == c) ? 1.f + jitter : 0.f;
  return a;
}

// Block blk solves row `row0 + blk % nrows` of owner `blk / nrows` (K4:
// one owner) from sums [D·nrows, E]; x [D, n, r].
template <typename T, int kMaxT>
__global__ void __launch_bounds__(cholt::threads(kMaxT), kMaxT <= 4 ? 3 : 1)
tail_solve_kernel(const float* __restrict__ sums,
                  const float* __restrict__ YtY, float* __restrict__ x,
                  long long n, int r, long long row0, long long nrows,
                  float reg_w, float jitter) {
  extern __shared__ __align__(16) float smem[];
  const long long blk = blockIdx.x;
  const long long me = blk / nrows;
  const long long row = row0 + blk - me * nrows;
  const float* Sg = sums + blk * row_floats(r);
  const float cnt = Sg[r * r + r];
  const float ridge = gram::round_w<T>(gram::round_w<T>(cnt) * reg_w);
  // a = S (+ YᵀY, added by fill), then the ridge, jitter and guard
  const auto row_tail = [&](int i, int c, float a) {
    return tail(i, c, a, ridge, jitter, cnt);
  };
  if (YtY != nullptr)
    cholt::fill<true>(smem, r, Sg, YtY, row_tail);
  else
    cholt::fill<false>(smem, r, Sg, nullptr, row_tail);
  const int nt = cholt::tiles(r);
  cholt::factorize(smem, nt);  // opens and closes with a barrier
  cholt::substitute(smem, nt, r, Sg + r * r, x + (me * n + row) * r);
}

// Above rank 288: block blk forms row `row0 + blk % nrows` of owner
// `blk / nrows`'s A in place over its S in sums (the lower triangle: S
// + YᵀY, then tail()), then stream_solve() factors it, L written over
// A, and solves x.
template <typename T>
__global__ void __launch_bounds__(cholt::kStreamThreads, 2)
tail_stream_kernel(float* __restrict__ sums, const float* __restrict__ YtY,
                   float* __restrict__ x, long long n, int r, long long row0,
                   long long nrows, float reg_w, float jitter) {
  extern __shared__ __align__(16) float smem[];
  const long long blk = blockIdx.x;
  const long long me = blk / nrows;
  const long long row = row0 + blk - me * nrows;
  float* A = sums + blk * row_floats(r);
  const float cnt = A[r * r + r];
  const float ridge = gram::round_w<T>(gram::round_w<T>(cnt) * reg_w);
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int i = threadIdx.x >> 5; i < r; i += nw)
    for (int c = lane; c <= i; c += 32) {
      const float a = A[i * r + c];
      A[i * r + c] = tail(i, c, YtY != nullptr ? a + YtY[i * r + c] : a,
                          ridge, jitter, cnt);
    }
  __syncthreads();  // A in place before any block column reads it
  cholt::stream_solve<false, true>(A, r, A + r * r, x + (me * n + row) * r,
                                   smem, r % 4 == 0);
}

// Launch the solve pass on rows [row0, row0 + nrows) of D owners: one
// block a row, with 8 warps up to rank 128, 16 up to rank 288 (shared
// memory holds the system), streamed above.
template <typename T>
cudaError_t launch_tail_solve(float* sums, const float* YtY, float* x,
                              long long D, long long n, int r,
                              long long row0, long long nrows, float reg_w,
                              float jitter, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(D * nrows);
  cudaError_t e;
  if (streamed(r)) {
    auto k = tail_stream_kernel<T>;
    const size_t smem = cholt::kStreamSmemFloats * sizeof(float);
    k<<<blocks, cholt::kStreamThreads, smem, stream>>>(
        sums, YtY, x, n, r, row0, nrows, reg_w, jitter);
    return cudaGetLastError();
  }
  const size_t smem = cholt::smem_floats(r) * sizeof(float);
  if (cholt::tiles(r) <= 4) {
    auto k = tail_solve_kernel<T, 4>;
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    k<<<blocks, cholt::threads(4), smem, stream>>>(sums, YtY, x, n, r, row0,
                                                   nrows, reg_w, jitter);
  } else {  // 5 to cholt::kMaxTiles (9) tiles: the same 512 threads
    auto k = tail_solve_kernel<T, 8>;
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    k<<<blocks, cholt::threads(8), smem, stream>>>(sums, YtY, x, n, r, row0,
                                                   nrows, reg_w, jitter);
  }
  return cudaGetLastError();
}

}  // namespace gsolve
