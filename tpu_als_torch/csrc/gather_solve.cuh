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
//   one block's shared memory up to rank 288 (cholt::kMaxTiles tiles a
//   side), above it in a thread-block cluster's (chol_cluster.cuh: C = 2
//   or 4 blocks on neighbouring SMs, A formed from S on chip, L never
//   written back), with the same arithmetic in the same order as
//   chol_tiled.cuh's stream_solve (K1's streamed solve), bit for bit.
// The same bytes through the same two kernels give the same x, so K7 at
// one shard, unsplit, is K4 bit for bit.

#pragma once

#include <cuda_runtime.h>

#include "chol_cluster.cuh"
#include "chol_tiled.cuh"
#include "gram.cuh"

namespace gsolve {

__host__ __device__ inline bool streamed(int r) {
  return cholt::tiles(r) > cholt::kMaxTiles;
}

// floats of scratch a row needs: S [r, r], b [r], the count; above rank
// 288 rounded up to a multiple of 4, so every row's S starts 16-byte
// aligned for the cluster solve's 16-byte loads
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

// Above rank 288: cluster blk (of ccl::cluster_size(r) blocks) solves
// row `row0 + blk % nrows` of owner `blk / nrows`: chol_cluster.cuh's
// solve() forms A from the row's S (+ YᵀY) and tail() in the cluster's
// shared memory and writes x alone.
template <typename T>
__global__ void __launch_bounds__(ccl::kThreads, 1)
tail_cluster_kernel(const float* __restrict__ sums,
                    const float* __restrict__ YtY, float* __restrict__ x,
                    long long n, int r, long long row0, long long nrows,
                    float reg_w, float jitter, int vec) {
  extern __shared__ __align__(16) float smem[];
  const long long blk =
      blockIdx.x / cooperative_groups::this_cluster().num_blocks();
  const long long me = blk / nrows;
  const long long row = row0 + blk - me * nrows;
  const float* Sg = sums + blk * row_floats(r);
  const float cnt = Sg[r * r + r];
  // the product rounded before the tail adds it (never fused into that
  // add), as the reference's reduce_precision pair and tail_system give it
  const float ridge =
      gram::round_w<T>(__fmul_rn(gram::round_w<T>(cnt), reg_w));
  const auto row_tail = [&](int i, int c, float a) {
    return tail(i, c, a, ridge, jitter, cnt);
  };
  float* xr = x + (me * n + row) * r;
  if (YtY != nullptr)
    ccl::solve<true>(Sg, r, YtY, Sg + r * r, xr, smem, vec, row_tail);
  else
    ccl::solve<false>(Sg, r, nullptr, Sg + r * r, xr, smem, vec, row_tail);
}

// The cluster launch of tail_cluster_kernel: its configuration (grid of
// `rows` clusters, ccl::smem_bytes of shared memory a block), after
// raising the kernel's shared-memory limit to it
template <typename T>
cudaError_t cluster_config(long long rows, int r, cudaStream_t stream,
                           cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr) {
  const int C = ccl::cluster_size(r);
  if (C == 0) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(ccl::smem_bytes(cholt::tiles(r), C));
  const cudaError_t e =
      cudaFuncSetAttribute(tail_cluster_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * C));
  cfg.blockDim = dim3(ccl::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// The card's view of the cluster launch at rank r (streamed(r)): out =
// {the cluster size, the dynamic shared bytes a block (the kernel's
// attribute, as raised), its static shared bytes, registers a thread,
// cudaOccupancyMaxActiveClusters}
template <typename T>
cudaError_t cluster_info(int r, long long* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config<T>(1, r, nullptr, cfg, attr);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, tail_cluster_kernel<T>);
  if (e != cudaSuccess) return e;
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(&active, tail_cluster_kernel<T>, &cfg);
  if (e != cudaSuccess) return e;
  out[0] = attr.val.clusterDim.x;
  out[1] = fa.maxDynamicSharedSizeBytes;
  out[2] = static_cast<long long>(fa.sharedSizeBytes);
  out[3] = fa.numRegs;
  out[4] = active;
  return cudaSuccess;
}

// Launch the solve pass on rows [row0, row0 + nrows) of D owners: one
// block a row, with 8 warps up to rank 128, 16 up to rank 288 (shared
// memory holds the system); above it one cluster a row.  A cluster
// launch the card cannot hold (cudaOccupancyMaxActiveClusters 0) returns
// cudaErrorLaunchOutOfResources unlaunched.
template <typename T>
cudaError_t launch_tail_solve(float* sums, const float* YtY, float* x,
                              long long D, long long n, int r,
                              long long row0, long long nrows, float reg_w,
                              float jitter, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(D * nrows);
  cudaError_t e;
  if (streamed(r)) {
    if (D * nrows * ccl::cluster_size(r) > 0x7fffffffLL)
      return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    e = cluster_config<T>(D * nrows, r, stream, cfg, attr);
    if (e != cudaSuccess) return e;
    int active = 0;
    e = cudaOccupancyMaxActiveClusters(&active, tail_cluster_kernel<T>, &cfg);
    if (e != cudaSuccess) return e;
    if (active < 1) return cudaErrorLaunchOutOfResources;
    const int vec = r % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(sums) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(YtY) % 16 == 0;
    e = cudaLaunchKernelEx(&cfg, tail_cluster_kernel<T>,
                           static_cast<const float*>(sums), YtY, x, n, r,
                           row0, nrows, reg_w, jitter, vec);
    if (e != cudaSuccess) return e;
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
