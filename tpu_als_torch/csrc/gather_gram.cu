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
// padded entry for the lower triangle and b (16,768 at rank 128), against
// r·4 + 12 bytes per entry gathered (524 bytes at rank 128): some 32
// flops per byte, so operations, not the gather, bound it at f32.
//
// What the design does about it: gram.cuh's register-tiled accumulation
// (each 16-byte pair of shared loads feeds 16 multiply-adds), rank <= 256
// (the running sums in registers up to rank 128; above, in the shared
// packed triangle, 197.6 KB of shared memory at rank 256).  On the TPU
// a wide row's width chunks ran in order on one core; here a row wider
// than `split` is cut into width chunks of `split` entries, one block
// each (grid (n, nsplit)), so the few rows of a power-law catalog's
// widest buckets spread over many SMs.  Each chunk writes a partial
// (S, b) to scratch the wrapper allocates, and a second kernel sums the
// partials in chunk order: deterministic, no float atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gram.cuh"

namespace {

template <typename T, bool kTwoSided, int kMaxRank>
__global__ void __launch_bounds__(gram::Acc<kMaxRank>::kThreads,
                                  kMaxRank <= 128 ? 2 : 1)
gather_gram_kernel(const T* __restrict__ V, const int* __restrict__ cols,
                   const T* __restrict__ aw, const T* __restrict__ bw,
                   float* __restrict__ S, float* __restrict__ b, int r,
                   long long w, long long split) {
  using Acc = gram::Acc<kMaxRank>;
  extern __shared__ __align__(16) float smem[];
  const long long row = blockIdx.x;
  const int k = blockIdx.y, nsplit = gridDim.y;
  const long long w0 = k * split;
  const long long w1 = w0 + split < w ? w0 + split : w;
  Acc acc;
  gram::init(acc, r, smem);
  gram::accumulate<T, kTwoSided>(V, cols + row * w, aw + row * w,
                                 bw + row * w, nullptr, r, w0, w1,
                                 smem + gram::sums_floats<kMaxRank>(r), acc);
  const long long out = row * nsplit + k;
  float* So = S + out * r * r;
  if constexpr (Acc::kInRegisters) {
    gram::for_each_lower(acc, r, [&](int i, int c, float v) {
      So[i * r + c] = v;
      So[c * r + i] = v;
    });
  } else {
    __syncthreads();  // every thread's last step is in the triangle
    for (int e = threadIdx.x; e < r * r; e += Acc::kThreads) {
      const int i = e / r, c = e - i * r;
      So[e] = smem[i >= c ? cholb::tri(i) + c : cholb::tri(c) + i];
    }
  }
  if (threadIdx.x < r) b[out * r + threadIdx.x] = acc.b;
}

// S[row] = Σ_k part_S[row, k], b likewise, k in order.
__global__ void sum_partials(const float* __restrict__ part_S,
                             const float* __restrict__ part_b,
                             float* __restrict__ S, float* __restrict__ b,
                             int r, int nsplit) {
  const long long row = blockIdx.x;
  const int rr = r * r;
  for (int e = threadIdx.x; e < rr + r; e += blockDim.x) {
    float s = 0.f;
    if (e < rr) {
      for (int k = 0; k < nsplit; ++k)
        s += part_S[(row * nsplit + k) * rr + e];
      S[row * rr + e] = s;
    } else {
      for (int k = 0; k < nsplit; ++k)
        s += part_b[(row * nsplit + k) * r + (e - rr)];
      b[row * r + (e - rr)] = s;
    }
  }
}

template <typename T, bool kTwoSided, int kMaxRank>
cudaError_t launch(const void* V, const int* cols, const void* aw,
                   const void* bw, float* S, float* b, long long n,
                   long long w, int r, long long split, int nsplit,
                   cudaStream_t stream) {
  auto kern = gather_gram_kernel<T, kTwoSided, kMaxRank>;
  const size_t smem = (gram::sums_floats<kMaxRank>(r) +
                       gram::stage_floats(r)) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>(nsplit));
  kern<<<grid, gram::Acc<kMaxRank>::kThreads, smem, stream>>>(
      static_cast<const T*>(V), cols, static_cast<const T*>(aw),
      static_cast<const T*>(bw), S, b, r, w, split);
  return cudaGetLastError();
}

// the instantiation for rank r: 128 up to rank 128, 256 above
template <typename T, bool kTwoSided>
cudaError_t launch_rank(const void* V, const int* cols, const void* aw,
                        const void* bw, float* S, float* b, long long n,
                        long long w, int r, long long split, int nsplit,
                        cudaStream_t stream) {
  return r <= 128
      ? launch<T, kTwoSided, 128>(V, cols, aw, bw, S, b, n, w, r, split,
                                  nsplit, stream)
      : launch<T, kTwoSided, 256>(V, cols, aw, bw, S, b, n, w, r, split,
                                  nsplit, stream);
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
  if (r < 1 || r > gram::kRankLimit || w < 1 || split < 1 ||
      n > 0x7fffffffLL)
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
    e = two_sided
        ? launch_rank<__nv_bfloat16, true>(V, cols, aw, bw, So, bo, n, w, r,
                                           split, ns, st)
        : launch_rank<__nv_bfloat16, false>(V, cols, aw, bw, So, bo, n, w,
                                            r, split, ns, st);
  else
    e = two_sided
        ? launch_rank<float, true>(V, cols, aw, bw, So, bo, n, w, r, split,
                                   ns, st)
        : launch_rank<float, false>(V, cols, aw, bw, So, bo, n, w, r, split,
                                    ns, st);
  if (e != cudaSuccess || nsplit == 1) return static_cast<int>(e);
  sum_partials<<<static_cast<unsigned>(n), 256, 0, st>>>(part_S, part_b, S,
                                                         b, r, ns);
  return static_cast<int>(cudaGetLastError());
}
