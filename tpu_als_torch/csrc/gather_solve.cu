// Kernel K4: the fused half-step — gather, Gram, ridge/YᵀY tail and the
// Cholesky solve, for Hopper (sm_90a).
//
// Replaces: tpu_als/ops/pallas_gather_ne.py::gather_solve (body
// _gather_solve_kernel), behind gather_fused_solve_explicit/implicit —
// the kernel the JAX main path resolves to on a TPU.  Same contract:
// V [N, r] (f32 or bf16), cols [n, w] int32, aw/bw/cw [n, w] in V's type,
// YᵀY [r, r] f32 (null: zero) -> x [n, r] f32; the per-row tail is
// gather_solve.cuh's (shared with the ring kernel K7).
//
// What bounds it on this card: operations.  Per real entry the Gram
// takes r(r+1) + 2r flops (16,768 at rank 128) against r·4 bytes
// gathered; on the tensor cores in the 3xTF32 form that is about a third
// of the f32 FMA time.  Per row the solve adds r³/3 + 2r² flops at the
// FMA rate, which at rank 256 outweighs the Gram of a row of width 128.
//
// What the design does about it: two passes over a tile of rows, within
// one call.  Pass 1 is K3's Gram (gram_sm90.cuh): the rows gathered by
// cp.async into a 4-stage ring, the lower triangle on the tensor cores in
// 3xTF32 (f32 accuracy), all-padding stages skipped, and above rank 128
// the triangle cut over blocks (above rank 256 gram_strips.cuh's parts,
// each staging only the strips it reads); it writes each row's S, b and
// count to scratch (gsolve::row_floats(r) floats a row).  Pass 2 is
// gather_solve.cuh's tail and chol_tiled.cuh's solve, a block of 8 warps
// per row at rank <= 128, 16 up to rank 288, and above it a cluster of 2
// or 4 blocks a row holding the system in distributed shared memory
// (chol_cluster.cuh).  Rank <= 512, the reference's bound.  Two passes, because the two halves want other
// blocks: the Gram one block of up to 12 warps at ~150 registers a thread
// (its triangle cut over blocks above rank 128), the solve several small
// blocks an SM to hide its barriers.  Rows wider than the trainer's split
// width do not come here: kernel K3 spreads their width over blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gather_solve.cuh"
#include "gram_sm90.cuh"
#include "gram_strips.cuh"

namespace {

// Pass 1: the Gram, b and count of rows [row0, row0 + nrows) into
// sums [nrows, E]; grid (nrows, 1, parts) at rank <= 256 (gram_sm90.cuh),
// above it (kStrips, gram_strips.cuh) grid (parts·nrows), a row's parts
// side by side.
template <typename T, bool kTwoSided, bool kStrips>
__global__ void __launch_bounds__(kStrips ? gstrips::kThreads
                                          : g90::kMaxThreads, 1)
row_gram_kernel(const T* __restrict__ V, const int* __restrict__ cols,
                const T* __restrict__ aw, const T* __restrict__ bw,
                const T* __restrict__ cw, float* __restrict__ sums, int r,
                long long w, long long row0) {
  extern __shared__ __align__(16) float smem[];  // as the solve pass's
  const int np = kStrips ? gstrips::parts(r) : 1;
  const long long i = kStrips ? blockIdx.x / np : blockIdx.x;
  const int part = kStrips ? static_cast<int>(blockIdx.x - i * np)
                           : static_cast<int>(blockIdx.z);
  const long long row = row0 + i;
  const gram::RowEntries<T> src{V, cols + row * w, aw + row * w,
                                bw + row * w, cw + row * w, r};
  float* o = sums + i * gsolve::row_floats(r);
  auto* sm = reinterpret_cast<unsigned char*>(smem);
  if constexpr (kStrips) {
    gstrips::Acc acc;
    gstrips::gram<T, kTwoSided>(src, r, 0, w, part, sm, acc);
    gstrips::store(acc, r, o, o + r * r, o + r * r + r);
  } else {
    g90::Acc acc;
    g90::gram<T, kTwoSided>(src, r, 0, w, part, sm, acc);
    g90::store(acc, r, part, o, o + r * r, o + r * r + r);
  }
}

template <typename T, bool kTwoSided>
cudaError_t launch(const void* V, const int* cols, const void* aw,
                   const void* bw, const void* cw, const float* YtY,
                   float* x, float* sums, long long n, long long w, int r,
                   float reg_w, float jitter, long long row0,
                   long long nrows, cudaStream_t stream) {
  const bool strips = r > gram::kRankLimit;
  auto gk = strips ? row_gram_kernel<T, kTwoSided, true>
                   : row_gram_kernel<T, kTwoSided, false>;
  const size_t smem =
      strips ? gstrips::smem_bytes<T>() : g90::smem_bytes<T>(r);
  cudaError_t e = cudaFuncSetAttribute(
      gk, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid =
      strips ? dim3(static_cast<unsigned>(nrows * gstrips::parts(r)))
             : dim3(static_cast<unsigned>(nrows), 1,
                    static_cast<unsigned>(g90::parts(r)));
  const int threads = strips ? gstrips::kThreads : 32 * g90::warps(r);
  gk<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(V), cols, static_cast<const T*>(aw),
      static_cast<const T*>(bw), static_cast<const T*>(cw), sums, r, w,
      row0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return gsolve::launch_tail_solve<T>(sums, YtY, x, 1, n, r, row0, nrows,
                                      reg_w, jitter, stream);
}

}  // namespace

// Rows [row0, row0 + nrows) of the n: sums is scratch of
// nrows·gsolve::row_floats(r) floats (r·r + r + 1, rounded up to a
// multiple of 4 above rank 288); reg_w: the ridge coefficient already
// rounded to the weight type.
extern "C" int gather_solve(const void* V, const int* cols, const void* aw,
                            const void* bw, const void* cw, const float* YtY,
                            float* x, float* sums, long long n, long long w,
                            int r, float reg_w, float jitter, int two_sided,
                            int bf16, long long row0, long long nrows,
                            void* stream) {
  if (n <= 0 || nrows <= 0) return 0;
  if (r < 1 || r > gram::kSolveRankLimit || w < 1 || n > 0x7fffffffLL ||
      row0 < 0 || row0 + nrows > n || !sums ||
      (r > gram::kRankLimit && nrows * gstrips::parts(r) > 0x7fffffffLL))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bf16)
    e = two_sided
        ? launch<__nv_bfloat16, true>(V, cols, aw, bw, cw, YtY, x, sums, n,
                                      w, r, reg_w, jitter, row0, nrows, st)
        : launch<__nv_bfloat16, false>(V, cols, aw, bw, cw, YtY, x, sums, n,
                                       w, r, reg_w, jitter, row0, nrows, st);
  else
    e = two_sided
        ? launch<float, true>(V, cols, aw, bw, cw, YtY, x, sums, n, w, r,
                              reg_w, jitter, row0, nrows, st)
        : launch<float, false>(V, cols, aw, bw, cw, YtY, x, sums, n, w, r,
                               reg_w, jitter, row0, nrows, st);
  return static_cast<int>(e);
}

// The solve pass's cluster launch above rank 288 as the card takes it
// (gsolve::cluster_info): out [5] = cluster size, dynamic and static
// shared bytes a block, registers a thread, the most clusters active.
extern "C" int gather_solve_cluster_info(int r, int bf16, long long* out) {
  if (!gsolve::streamed(r) || r > gram::kSolveRankLimit || !out)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(bf16 ? gsolve::cluster_info<__nv_bfloat16>(r, out)
                               : gsolve::cluster_info<float>(r, out));
}
