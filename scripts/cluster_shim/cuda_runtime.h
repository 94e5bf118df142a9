// A CPU stand-in for the CUDA runtime, enough to run the device routines
// of tpu_als_torch/csrc/chol_tiled.cuh and chol_cluster.cuh with g++:
// each CUDA thread is a std::thread; __syncthreads, __syncwarp and the
// cluster barrier are std::barriers; __shfl_sync goes through a per-warp
// buffer between two warp barriers.  Used by scripts/chol_cluster_shim.py.
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __shared__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __restrict__

struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) {
  return float4{a, b, c, d};
}
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

using cudaError_t = int;
using cudaStream_t = void*;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
constexpr int cudaDevAttrMultiProcessorCount = 16;
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 132; return 0; }
template <typename K>
inline int cudaFuncSetAttribute(K, int, int) { return 0; }

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline long long min(long long a, long long b) { return a < b ? a : b; }
inline float __frcp_rn(float v) { return 1.0f / v; }
inline unsigned __cvta_generic_to_shared(const void*) { return 0; }
inline unsigned __float_as_uint(float v) {
  unsigned u;
  std::memcpy(&u, &v, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float v;
  std::memcpy(&v, &u, 4);
  return v;
}

namespace shim {
using Barrier = std::barrier<>;
struct Warp {
  Barrier bar{32};
  float buf[32];
};
struct Block {
  explicit Block(int threads, size_t smem_floats)
      : bar(threads), warps(threads / 32), smem(smem_floats + 4) {}
  Barrier bar;
  Barrier pair{64};  // named barrier 1 of warps 0 and 1
  std::vector<Warp> warps;
  std::vector<float> smem;
  float* base() {  // 16-byte aligned
    auto p = reinterpret_cast<uintptr_t>(smem.data());
    return reinterpret_cast<float*>((p + 15) & ~uintptr_t(15));
  }
};
struct Cluster {
  std::unique_ptr<Barrier> bar;
  std::vector<Block*> blocks;
};
struct Ctx {
  Block* block;
  Cluster* cluster;
  unsigned rank;
};
inline thread_local Ctx ctx;
}  // namespace shim

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

inline void __syncthreads() { shim::ctx.block->bar.arrive_and_wait(); }
inline void shim_pair_sync() { shim::ctx.block->pair.arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  shim::ctx.block->warps[threadIdx.x >> 5].bar.arrive_and_wait();
}
inline float __shfl_sync(unsigned, float v, int src) {
  shim::Warp& w = shim::ctx.block->warps[threadIdx.x >> 5];
  w.buf[threadIdx.x & 31] = v;
  w.bar.arrive_and_wait();
  const float out = w.buf[src & 31];
  w.bar.arrive_and_wait();
  return out;
}
