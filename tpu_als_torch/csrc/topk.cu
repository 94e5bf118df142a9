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
// What the design does about it: a block owns 64 user rows and walks the
// whole catalog in 64-item tiles.  Each tile's 64 x 64 score block is
// built in registers (a 4 x 4 micro-tile per thread, operands staged in
// shared memory 32 ranks at a time, 16-byte shared loads), masked, and
// left in shared memory, where each warp folds its rows into a sorted
// per-row list of the k best (scores and ids in shared memory).  A
// candidate is compared with the row's current k-th score first, so after
// the first tiles almost every candidate is rejected by one compare; an
// accepted one is inserted by the whole warp (ballot count of the
// position, one shifted copy).  Candidates are taken in increasing item
// order and equal scores never displace a kept one, so ties in practice
// keep the lower id.

#include <cuda_runtime.h>

namespace {

constexpr int kTU = 64;       // user rows per block
constexpr int kTI = 64;       // items per tile
constexpr int kDK = 32;       // ranks per staged operand chunk
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 scores each
constexpr int kWarps = kThreads / 32;
constexpr int kLdOp = kTU + 4;   // operand row stride: 16-byte aligned rows
constexpr int kLdS = kTI + 1;    // score row stride: conflict-free row reads
constexpr int kMaxK = 128;
constexpr float kNegInf = -3.4e38f;
static_assert(kTU == kTI, "operand staging assumes square tiles");

__device__ __forceinline__ void insert_sorted(float* ls, long long* li,
                                              int k, float s, long long id,
                                              int lane) {
  // position = number of kept scores >= s (the list is sorted descending)
  int cnt = 0;
#pragma unroll
  for (int c = 0; c < kMaxK / 32; ++c) {
    const int q = lane + 32 * c;
    if (q < k) cnt += ls[q] >= s;
  }
  const int p = __reduce_add_sync(0xffffffffu, cnt);
  float sv[kMaxK / 32];
  long long iv[kMaxK / 32];
#pragma unroll
  for (int c = 0; c < kMaxK / 32; ++c) {
    const int q = lane + 32 * c;
    if (q < k && q > p) { sv[c] = ls[q - 1]; iv[c] = li[q - 1]; }
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < kMaxK / 32; ++c) {
    const int q = lane + 32 * c;
    if (q < k && q > p) { ls[q] = sv[c]; li[q] = iv[c]; }
  }
  if (lane == 0) { ls[p] = s; li[p] = id; }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ U, const float* __restrict__ V,
            const unsigned char* __restrict__ valid,
            float* __restrict__ out_s, long long* __restrict__ out_i,
            long long n, long long ni, int r, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* Li = reinterpret_cast<long long*>(smem_raw);  // [kTU][k]
  float* Ls = reinterpret_cast<float*>(Li + kTU * k);       // [kTU][k]
  float* Us = Ls + kTU * k;                                 // [kDK][kLdOp]
  float* Vs = Us + kDK * kLdOp;                             // [kDK][kLdOp]
  float* Ss = Vs + kDK * kLdOp;                             // [kTU][kLdS]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const long long u0 = static_cast<long long>(blockIdx.x) * kTU;

  for (int t = tid; t < kTU * k; t += kThreads) {
    Ls[t] = kNegInf;
    Li[t] = 0;
  }

  for (long long i0 = 0; i0 < ni; i0 += kTI) {
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

    for (int d0 = 0; d0 < r; d0 += kDK) {
      const int dk = min(kDK, r - d0);
      __syncthreads();  // operands (and last tile's score reads) are free
      for (int t = tid; t < kDK * kTU; t += kThreads) {
        const int d = t % kDK, row = t / kDK;
        const bool din = d < dk;
        const long long u = u0 + row, it = i0 + row;
        Us[d * kLdOp + row] = (din && u < n) ? U[u * r + d0 + d] : 0.f;
        Vs[d * kLdOp + row] = (din && it < ni) ? V[it * r + d0 + d] : 0.f;
      }
      __syncthreads();
      for (int d = 0; d < dk; ++d) {
        const float4 ua = *reinterpret_cast<const float4*>(
            Us + d * kLdOp + ty * 4);
        const float4 vb = *reinterpret_cast<const float4*>(
            Vs + d * kLdOp + tx * 4);
        const float uv[4] = {ua.x, ua.y, ua.z, ua.w};
        const float vv[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(uv[a], vv[b], acc[a][b]);
      }
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const long long it = i0 + tx * 4 + b;
      const bool ok = it < ni && valid[it];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        Ss[(ty * 4 + a) * kLdS + tx * 4 + b] = ok ? acc[a][b] : kNegInf;
    }
    __syncthreads();

    for (int row = warp; row < kTU; row += kWarps) {
      if (u0 + row >= n) break;
      float* ls = Ls + row * k;
      long long* li = Li + row * k;
      const float c0 = Ss[row * kLdS + lane];
      const float c1 = Ss[row * kLdS + lane + 32];
      float thr = ls[k - 1];
      unsigned m0 = __ballot_sync(0xffffffffu, c0 > thr);
      unsigned m1 = __ballot_sync(0xffffffffu, c1 > thr);
      while (m0 | m1) {  // warp-uniform: ballots and shuffles only
        float s;
        long long id;
        if (m0) {
          const int src = __ffs(m0) - 1;
          m0 &= m0 - 1;
          s = __shfl_sync(0xffffffffu, c0, src);
          id = i0 + src;
        } else {
          const int src = __ffs(m1) - 1;
          m1 &= m1 - 1;
          s = __shfl_sync(0xffffffffu, c1, src);
          id = i0 + 32 + src;
        }
        if (s > thr) {
          insert_sorted(ls, li, k, s, id, lane);
          thr = ls[k - 1];
        }
      }
    }
  }
  __syncthreads();
  for (int t = tid; t < kTU * k; t += kThreads) {
    const long long u = u0 + t / k;
    if (u < n) {
      out_s[u * k + t % k] = Ls[t];
      out_i[u * k + t % k] = Li[t];
    }
  }
}

}  // namespace

extern "C" int topk_f32(const float* U, const float* V,
                        const unsigned char* valid, float* out_s,
                        long long* out_i, long long n, long long ni, int r,
                        int k, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > kMaxK || r < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kTU - 1) / kTU;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kTU) * k * (sizeof(long long) +
                                                      sizeof(float)) +
                      (2 * kDK * kLdOp + kTU * kLdS) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  topk_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(U, V, valid, out_s,
                                                     out_i, n, ni, r, k);
  return static_cast<int>(cudaGetLastError());
}
