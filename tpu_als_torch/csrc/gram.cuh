// Gather factor rows and accumulate a weighted Gram matrix, in one block.
//
// The front end shared by kernels K3 (gather_gram.cu) and K4
// (gather_solve.cu), the counterpart of the DMA-gather + Gram step of
// tpu_als/ops/pallas_gather_ne.py::_gather_gram_kernel: for the entries
// [w0, w1) of one padded CSR row,
//
//   S = Σ (aw·v) (aw·v)ᵀ   (two-sided)   or   Σ (aw·v) vᵀ   (one-sided)
//   b = Σ bw·v             cnt = Σ cw      with v = V[cols[e]]
//
// where aw·v is formed in f32 (exact for a bf16 table and bf16 weights:
// the reference's XLA lowering keeps that product in f32 too, measured
// ~1e-3 relative apart on A when it is rounded back to bf16), and
// everything accumulates in f32.  The
// gathered rows never reach device memory: kT of them at a time are
// staged in shared memory (weighted and raw, zero-padded to R4 = r rounded
// up to 4), and each thread owns up to kMaxTiles 4x4 tiles of the LOWER
// triangle of S, so one pair of 16-byte shared loads feeds 16
// multiply-adds.
//
// Two instantiations, by the largest rank they take (Acc<kMaxRank>):
// - rank <= 128: 256 threads, 3 tiles each (528 tiles at RT = r/4 = 32),
//   the running sums in registers;
// - rank <= 256: 544 threads (17 warps), 4 tiles each (2,080 tiles at
//   RT = 64).  Holding the running sums in registers as well would take
//   twice the tiles' registers and spill; so only each step's partials
//   are registers, and the running sums live in the packed lower
//   triangle in shared memory (chol_blocked.cuh's layout, 131.6 KB at
//   rank 256), where K4 factorizes it in place.  Every thread adds its
//   own entries after each step: no atomics, no barrier.

#pragma once

#include <cuda_bf16.h>

#include "chol_blocked.cuh"

namespace gram {

constexpr int kT = 32;         // entries staged per step
constexpr int kRankLimit = 256;  // the largest instantiation's rank

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

// round an f32 value to the table's type, back in f32
template <typename T> __device__ __forceinline__ float round_w(float v);
template <> __device__ __forceinline__ float round_w<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float round_w<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__host__ __device__ inline int round4(int r) { return (r + 3) & ~3; }

// floats of shared staging for rank r
__host__ __device__ inline int stage_floats(int r) {
  return 2 * kT * round4(r) + 4 * kT;
}

template <int kMaxRank>
struct Acc {
  static_assert(kMaxRank == 128 || kMaxRank == 256, "rank 128 or 256");
  static constexpr bool kInRegisters = kMaxRank <= 128;
  static constexpr int kThreads = kInRegisters ? 256 : 544;
  static constexpr int kMaxTiles = kInRegisters ? 3 : 4;
  float s[kInRegisters ? kMaxTiles : 1][4][4];  // running sums (<= 128)
  float* tri;  // running sums, packed lower triangle in shared memory
  int ti[kMaxTiles], tj[kMaxTiles];
  int ntiles;
  float b;    // b[threadIdx.x], for threadIdx.x < r
  float cnt;  // on thread 0
};

// floats of shared memory the running sums take before the staging
// (16-byte aligned)
template <int kMaxRank>
__host__ __device__ inline int sums_floats(int r) {
  return Acc<kMaxRank>::kInRegisters ? 0 : round4(cholb::tri(r));
}

// tri: sums_floats(r) floats of shared memory (unused at rank <= 128)
template <int kMaxRank>
__device__ __forceinline__ void init(Acc<kMaxRank>& acc, int r, float* tri) {
  constexpr int kThreads = Acc<kMaxRank>::kThreads;
  const int rt = round4(r) / 4;
  const int total = rt * (rt + 1) / 2;
  acc.ntiles = 0;
#pragma unroll
  for (int s = 0; s < Acc<kMaxRank>::kMaxTiles; ++s) {
    const int t = threadIdx.x + s * kThreads;
    int ti = 0;
    while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
    acc.ti[s] = ti;
    acc.tj[s] = t - ti * (ti + 1) / 2;
    if (t < total) acc.ntiles = s + 1;
  }
  if constexpr (Acc<kMaxRank>::kInRegisters) {
#pragma unroll
    for (int s = 0; s < Acc<kMaxRank>::kMaxTiles; ++s)
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc.s[s][x][y] = 0.f;
  } else {
    acc.tri = tri;
    for (int e = threadIdx.x; e < cholb::tri(r); e += kThreads) tri[e] = 0.f;
  }
  acc.b = 0.f;
  acc.cnt = 0.f;
}

// Accumulate entries [w0, w1) of one row.  cols/aw/bw/cw point at the
// row's first entry; cw may be null (no count).  stage: stage_floats(r)
// floats of shared memory, 16-byte aligned.  Opens with a barrier.
template <typename T, bool kTwoSided, int kMaxRank>
__device__ __forceinline__ void accumulate(
    const T* __restrict__ V, const int* __restrict__ cols,
    const T* __restrict__ aw, const T* __restrict__ bw,
    const T* __restrict__ cw, int r, long long w0, long long w1,
    float* stage, Acc<kMaxRank>& acc) {
  constexpr int kThreads = Acc<kMaxRank>::kThreads;
  constexpr int kMaxTiles = Acc<kMaxRank>::kMaxTiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R4 = round4(r);
  float* Vw = stage;                 // [kT][R4]  aw·v
  float* Vg = Vw + kT * R4;          // [kT][R4]  v
  float* aw_s = Vg + kT * R4;        // [kT]
  float* bw_s = aw_s + kT;
  float* cw_s = bw_s + kT;
  int* col_s = reinterpret_cast<int*>(cw_s + kT);
  for (long long e0 = w0; e0 < w1; e0 += kT) {
    __syncthreads();  // the previous step's reads of the stage are done
    if (tid < kT) {
      const long long pos = e0 + tid;
      const bool ok = pos < w1;
      col_s[tid] = ok ? cols[pos] : 0;
      aw_s[tid] = ok ? to_f(aw[pos]) : 0.f;
      bw_s[tid] = ok ? to_f(bw[pos]) : 0.f;
      cw_s[tid] = (ok && cw != nullptr) ? to_f(cw[pos]) : 0.f;
    }
    __syncthreads();
    for (int e = warp; e < kT; e += kThreads / 32) {
      const bool ok = e0 + e < w1;
      const T* vr = V + static_cast<size_t>(col_s[e]) * r;
      const float a = aw_s[e];
      for (int k = lane; k < R4; k += 32) {
        const float v = (ok && k < r) ? to_f(vr[k]) : 0.f;
        Vg[e * R4 + k] = v;
        Vw[e * R4 + k] = v * a;
      }
    }
    __syncthreads();
    // two-level sums: the step's kT entries into a partial, the partial
    // into the running total, so a long row's running sums see w/kT
    // additions instead of w (sequential f32 sums of 2^16 half-star
    // terms drifted 9e-5 of their magnitude on the card)
    float ts[kMaxTiles][4][4];
#pragma unroll
    for (int s = 0; s < kMaxTiles; ++s)
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) ts[s][x][y] = 0.f;
    float tb = 0.f, tc = 0.f;
    const int ne = static_cast<int>(min(static_cast<long long>(kT), w1 - e0));
    for (int e = 0; e < ne; ++e) {
      const float4* wrow = reinterpret_cast<const float4*>(Vw + e * R4);
      const float4* grow = kTwoSided
          ? wrow : reinterpret_cast<const float4*>(Vg + e * R4);
#pragma unroll
      for (int s = 0; s < kMaxTiles; ++s) {
        if (s < acc.ntiles) {
          const float4 a = wrow[acc.ti[s]];
          const float4 g = grow[acc.tj[s]];
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int y = 0; y < 4; ++y) ts[s][x][y] += av[x] * gv[y];
        }
      }
      if (tid < r) tb += bw_s[e] * Vg[e * R4 + tid];
      if (tid == 0) tc += cw_s[e];
    }
    if constexpr (Acc<kMaxRank>::kInRegisters) {
#pragma unroll
      for (int s = 0; s < kMaxTiles; ++s)
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) acc.s[s][x][y] += ts[s][x][y];
    } else {
#pragma unroll
      for (int s = 0; s < kMaxTiles; ++s) {
        if (s < acc.ntiles) {
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int y = 0; y < 4; ++y) {
              const int i = acc.ti[s] * 4 + x, c = acc.tj[s] * 4 + y;
              if (i < r && c <= i) acc.tri[cholb::tri(i) + c] += ts[s][x][y];
            }
        }
      }
    }
    acc.b += tb;
    acc.cnt += tc;
  }
}

// Visit every lower-triangle entry (i, c), c <= i < r, this thread holds
// in registers (rank <= 128).
template <typename F>
__device__ __forceinline__ void for_each_lower(const Acc<128>& acc, int r,
                                               F f) {
#pragma unroll
  for (int s = 0; s < Acc<128>::kMaxTiles; ++s) {
    if (s < acc.ntiles) {
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const int i = acc.ti[s] * 4 + x, c = acc.tj[s] * 4 + y;
          if (i < r && c <= i) f(i, c, acc.s[s][x][y]);
        }
    }
  }
}

}  // namespace gram
