// Kernel K5: fused score GEMM + running top-k, for Hopper (sm_90a).
//
// Replaces: tpu_als/ops/pallas_topk.py::topk_scores_pallas (body
// _topk_kernel), the top-k that ALSModel.recommendFor* and
// recommend_arrays run.  Same contract: U [n, r] f32, V [ni, r] f32,
// valid [ni] bool, 1 <= k <= 128 -> scores [n, k] f32 sorted descending
// and ids [n, k] (int64 here, int32 on the TPU).  Invalid items are never
// returned while enough valid ones exist; when fewer than k are valid the
// surplus slots hold exactly NEG_INF (-3.4e38) with meaningless ids (0).
// Tie order is not promised.  Scores never go to device memory.
//
// Precision differs from the TPU on purpose: the TPU ran the score GEMM
// at default precision (one bf16 pass); this kernel computes every score
// with f32 FMAs, as the JAX package's CPU path and the plain version do.
//
// What bounds it on this card: the GEMM, 2·n·ni·r flops (2.46 TFLOP for
// all 162,541 users x 59,047 items at rank 128, ~37 ms at the 67 TFLOP/s
// f32 peak outside the tensor cores); bytes are only the factor tables
// and the [n, k] result.
//
// What the design does about it: topk.cuh's block scan — a block owns 64
// user rows and walks the whole catalog in 64-item tiles, the score
// block in registers, then a running top-k per row in shared memory (its
// insertion is stable; the contract does not promise it).

#include <cuda_runtime.h>

#include "topk.cuh"

namespace {

__global__ void __launch_bounds__(topk::kThreads)
topk_kernel(const float* __restrict__ U, const float* __restrict__ V,
            const unsigned char* __restrict__ valid,
            float* __restrict__ out_s, long long* __restrict__ out_i,
            long long n, long long ni, int r, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const topk::Lists l = topk::carve(smem_raw, k);
  const long long u0 = static_cast<long long>(blockIdx.x) * topk::kTU;
  topk::init(l, k);
  topk::scan(U, V, valid, n, ni, r, k, u0, 0, l);
  for (int t = threadIdx.x; t < topk::kTU * k; t += topk::kThreads) {
    const long long u = u0 + t / k;
    if (u < n) {
      out_s[u * k + t % k] = l.Ls[t];
      out_i[u * k + t % k] = l.Li[t];
    }
  }
}

}  // namespace

extern "C" int topk_f32(const float* U, const float* V,
                        const unsigned char* valid, float* out_s,
                        long long* out_i, long long n, long long ni, int r,
                        int k, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > topk::kMaxK || r < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + topk::kTU - 1) / topk::kTU;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = topk::smem_bytes(k);
  cudaError_t e = cudaFuncSetAttribute(
      topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  topk_kernel<<<static_cast<unsigned>(blocks), topk::kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(U, V, valid, out_s,
                                                     out_i, n, ni, r, k);
  return static_cast<int>(cudaGetLastError());
}
