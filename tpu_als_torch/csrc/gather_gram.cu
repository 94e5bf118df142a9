// Kernel K3: gather factor rows + weighted Gram build, for Hopper (sm_90a).
//
// Replaces: tpu_als/ops/pallas_gather_ne.py::gather_gram (body
// _gather_gram_kernel), behind gather_normal_eq_explicit/implicit.  Same
// contract: V [N, r] (f32 or bf16), cols [n, w] int32, aw/bw [n, w] in
// V's type -> S [n, r, r] f32, b [n, r] f32 with
//   S[i] = Σ_k (aw·v)(aw·v)ᵀ (two-sided) or Σ_k (aw·v) vᵀ (one-sided),
//   b[i] = Σ_k bw·v,   v = V[cols[i, k]];
// the gathered rows never exist in device memory.  S is written
// symmetric, mirrored from the lower triangle the block accumulates.
//
// What bounds it on this card: the Gram arithmetic, r(r+1) + 2r flops per
// real entry for the lower triangle and b (16,768 at rank 128), against
// r·4 + 12 bytes per entry gathered (524 bytes at rank 128): some 32
// flops per byte.  At the f32 FMA rate (67 TFLOP/s) that is operations;
// on the tensor cores the 3xTF32 form does 3x the flops at 495 TFLOP/s
// (dense TF32), about 1/3 of the FMA time, and the gather's bytes come
// close to binding.
//
// What the design does about it: gram_sm90.cuh's block body, the rows
// gathered by cp.async into a 4-stage ring that overlaps the math, and
// the Gram on the tensor cores in the 3xTF32 form (an f32 operand split
// into two TF32 halves, three mma products, the sums in f32 registers,
// two-level) at every rank <= 256; above 12 warp tiles (rank > 128) the
// triangle is cut over blocks; a stage of 32 entries whose weights are
// all zero (padding) is skipped.  Above rank 256, gram_strips.cuh's body:
// the same warp tiles, grouped into parts that each stage only the
// 32-column strips they read (at most 6, any rank), a row's parts in
// neighbouring blocks.  On the TPU a wide row's width chunks ran
// in order on one core; here a row wider than `split` is cut into width
// chunks of `split` entries, one block each (grid (n, nsplit, parts)),
// so the few rows of a power-law catalog's widest buckets spread over
// many SMs.  Each chunk writes a partial (S, b) to scratch the wrapper
// allocates, and a second kernel sums the partials in chunk order:
// deterministic, no float atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gram_sm90.cuh"
#include "gram_strips.cuh"

namespace {

// Grid (n, nsplit, parts) at rank <= 256 (gram_sm90.cuh); above it
// (kStrips, gram_strips.cuh) grid (parts·n, nsplit), a row's parts side
// by side.
template <typename T, bool kTwoSided, bool kStrips>
__global__ void __launch_bounds__(kStrips ? gstrips::kThreads
                                          : g90::kMaxThreads, 1)
gather_gram_kernel(const T* __restrict__ V, const int* __restrict__ cols,
                   const T* __restrict__ aw, const T* __restrict__ bw,
                   float* __restrict__ S, float* __restrict__ b, int r,
                   long long w, long long split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int np = kStrips ? gstrips::parts(r) : 1;
  const long long row = kStrips ? blockIdx.x / np : blockIdx.x;
  const int part = kStrips ? static_cast<int>(blockIdx.x - row * np)
                           : static_cast<int>(blockIdx.z);
  const int k = blockIdx.y, nsplit = gridDim.y;
  const long long w0 = k * split;
  const long long w1 = w0 + split < w ? w0 + split : w;
  const gram::RowEntries<T> src{V, cols + row * w, aw + row * w,
                                bw + row * w, nullptr, r};
  const long long out = row * nsplit + k;
  if constexpr (kStrips) {
    gstrips::Acc acc;
    gstrips::gram<T, kTwoSided>(src, r, w0, w1, part, smem, acc);
    gstrips::store(acc, r, S + out * r * r, b + out * r, nullptr);
  } else {
    g90::Acc acc;
    g90::gram<T, kTwoSided>(src, r, w0, w1, part, smem, acc);
    g90::store(acc, r, part, S + out * r * r, b + out * r, nullptr);
  }
}

template <typename T, bool kTwoSided>
cudaError_t launch(const void* V, const int* cols, const void* aw,
                   const void* bw, float* S, float* b, long long n,
                   long long w, int r, long long split, int nsplit,
                   cudaStream_t stream) {
  const bool strips = r > gram::kRankLimit;
  auto kern = strips ? gather_gram_kernel<T, kTwoSided, true>
                     : gather_gram_kernel<T, kTwoSided, false>;
  const size_t smem =
      strips ? gstrips::smem_bytes<T>() : g90::smem_bytes<T>(r);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid =
      strips ? dim3(static_cast<unsigned>(n * gstrips::parts(r)),
                    static_cast<unsigned>(nsplit), 1)
             : dim3(static_cast<unsigned>(n), static_cast<unsigned>(nsplit),
                    static_cast<unsigned>(g90::parts(r)));
  const int threads = strips ? gstrips::kThreads : 32 * g90::warps(r);
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(V), cols, static_cast<const T*>(aw),
      static_cast<const T*>(bw), S, b, r, w, split);
  return cudaGetLastError();
}

}  // namespace

// part_S [n, nsplit, r, r] and part_b [n, nsplit, r] are scratch, used
// (and required) only when the width is cut into nsplit > 1 chunks.
extern "C" int gather_gram(const void* V, const int* cols, const void* aw,
                           const void* bw, float* S, float* b, float* part_S,
                           float* part_b, long long n, long long w, int r,
                           long long split, int two_sided, int bf16,
                           void* stream) {
  if (n <= 0) return 0;
  if (r < 1 || r > gram::kGramRankLimit || w < 1 || split < 1 ||
      n > 0x7fffffffLL ||
      (r > gram::kRankLimit && n * gstrips::parts(r) > 0x7fffffffLL))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nsplit = (w + split - 1) / split;
  if (nsplit > 65535 || (nsplit > 1 && (!part_S || !part_b)))
    return static_cast<int>(cudaErrorInvalidValue);
  float* So = nsplit > 1 ? part_S : S;
  float* bo = nsplit > 1 ? part_b : b;
  auto st = static_cast<cudaStream_t>(stream);
  const int ns = static_cast<int>(nsplit);
  cudaError_t e;
  if (bf16)
    e = two_sided ? launch<__nv_bfloat16, true>(V, cols, aw, bw, So, bo, n,
                                                w, r, split, ns, st)
                  : launch<__nv_bfloat16, false>(V, cols, aw, bw, So, bo, n,
                                                 w, r, split, ns, st);
  else
    e = two_sided ? launch<float, true>(V, cols, aw, bw, So, bo, n, w, r,
                                        split, ns, st)
                  : launch<float, false>(V, cols, aw, bw, So, bo, n, w, r,
                                         split, ns, st);
  if (e != cudaSuccess || nsplit == 1) return static_cast<int>(e);
  e = g90::launch_sum(part_S, S, n, static_cast<long long>(r) * r, ns, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(g90::launch_sum(part_b, b, n, r, ns, st));
}
