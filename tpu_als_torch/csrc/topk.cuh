// A block's running top-k over a catalog: the score GEMM and the stable
// insertion shared by kernel K5 (topk.cu) and kernel K8
// (topk_merge_ring.cu).
//
// A block owns kTU = 64 user rows and walks a catalog in 64-item tiles.
// Each tile's 64 x 64 score block is built in registers (a 4 x 4
// micro-tile per thread, operands staged in shared memory 32 ranks at a
// time, 16-byte shared loads, f32 FMAs in rank order), masked (an invalid
// item scores NEG_INF), and left in shared memory, where each warp folds
// its rows into a sorted per-row list of the k best (scores and ids in
// shared memory).  A candidate is compared with the row's current k-th
// score first, so after the first tiles almost every candidate is
// rejected by one compare; an accepted one is inserted by the whole warp
// (ballot count of the position, one shifted copy).  Candidates are taken
// in increasing item order, an equal score never displaces a kept one,
// and a new score goes after the kept scores equal to it: the list is
// stable — score descending, the lower id first on a tie — and slots no
// valid item reached keep (NEG_INF, id 0).

#pragma once

#include <cuda_runtime.h>

namespace topk {

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

// bytes of shared memory for k kept candidates per row
__host__ __device__ inline size_t smem_bytes(int k) {
  return static_cast<size_t>(kTU) * k * (sizeof(long long) + sizeof(float)) +
         (2 * kDK * kLdOp + kTU * kLdS) * sizeof(float);
}

// The block's shared memory, carved: the kept lists, then the staging.
struct Lists {
  long long* Li;  // [kTU][k]
  float* Ls;      // [kTU][k]
  float* Us;      // [kDK][kLdOp]
  float* Vs;      // [kDK][kLdOp]
  float* Ss;      // [kTU][kLdS]
};

__device__ __forceinline__ Lists carve(unsigned char* smem, int k) {
  Lists l;
  l.Li = reinterpret_cast<long long*>(smem);
  l.Ls = reinterpret_cast<float*>(l.Li + kTU * k);
  l.Us = l.Ls + kTU * k;
  l.Vs = l.Us + kDK * kLdOp;
  l.Ss = l.Vs + kDK * kLdOp;
  return l;
}

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

// Fold the items [0, ni) of V [ni, r] (with validity `valid`, ids
// id0 + item) into the kept lists of the rows u0 .. u0 + kTU - 1 of
// U [n, r].  The lists must be initialized; called by every thread.
__device__ __forceinline__ void scan(const float* __restrict__ U,
                                     const float* __restrict__ V,
                                     const unsigned char* __restrict__ valid,
                                     long long n, long long ni, int r, int k,
                                     long long u0, long long id0,
                                     const Lists& l) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
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
        l.Us[d * kLdOp + row] = (din && u < n) ? U[u * r + d0 + d] : 0.f;
        l.Vs[d * kLdOp + row] = (din && it < ni) ? V[it * r + d0 + d] : 0.f;
      }
      __syncthreads();
      for (int d = 0; d < dk; ++d) {
        const float4 ua = *reinterpret_cast<const float4*>(
            l.Us + d * kLdOp + ty * 4);
        const float4 vb = *reinterpret_cast<const float4*>(
            l.Vs + d * kLdOp + tx * 4);
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
        l.Ss[(ty * 4 + a) * kLdS + tx * 4 + b] = ok ? acc[a][b] : kNegInf;
    }
    __syncthreads();

    for (int row = warp; row < kTU; row += kWarps) {
      if (u0 + row >= n) break;
      float* ls = l.Ls + row * k;
      long long* li = l.Li + row * k;
      const float c0 = l.Ss[row * kLdS + lane];
      const float c1 = l.Ss[row * kLdS + lane + 32];
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
          id = id0 + i0 + src;
        } else {
          const int src = __ffs(m1) - 1;
          m1 &= m1 - 1;
          s = __shfl_sync(0xffffffffu, c1, src);
          id = id0 + i0 + 32 + src;
        }
        if (s > thr) {
          insert_sorted(ls, li, k, s, id, lane);
          thr = ls[k - 1];
        }
      }
    }
  }
  __syncthreads();
}

// Every kept slot (NEG_INF, id 0): the lists before any item.
__device__ __forceinline__ void init(const Lists& l, int k) {
  for (int t = threadIdx.x; t < kTU * k; t += kThreads) {
    l.Ls[t] = kNegInf;
    l.Li[t] = 0;
  }
}

}  // namespace topk
