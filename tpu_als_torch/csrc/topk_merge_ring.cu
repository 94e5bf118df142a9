// Kernel K8: cross-shard top-k — each shard's stable running top-k, then
// a stable merge of the S candidate sets in shard order; for Hopper
// (sm_90a).
//
// Replaces: tpu_als/ops/pallas_topk.py::topk_merge_ring (body
// _topk_merge_ring_kernel, merge _stable_extract), the
// gatherStrategy='merge_ring' path of parallel/serve.py::topk_sharded.
// Same contract: U [n, r] f32 (the queries, seen by every shard), the
// catalog in S shards V [S, ni_loc, r] f32 with valid [S, ni_loc] bool,
// 1 <= k <= 128 -> scores [n, k] f32 and ids [n, k] int64, global id =
// s·ni_loc + local.  Per user: the valid items sorted by (score
// descending, global id ascending), cut to k, padded with (NEG_INF, 0) —
// bitwise what chunked_topk_scores returns over the concatenated catalog
// (whenever the two compute the same score values: exactly at integer
// factors).
//
// The transport: on the TPU each chip scores its own shard and the
// packed candidate sets hop round the ring by remote DMA into VMEM.
// Here the S shards' blocks write their sets to a scratch in device
// memory, coll [n_tiles, S, 64, k], and the last block of a user tile to
// finish (a __threadfence, then an atomic ticket per tile, which the
// wrapper zeroes) merges them: one launch, no spin-waits, no block waits
// for another to be resident.
//
// What bounds it on this card: the score GEMM, 2·n·S·ni_loc·r flops, as
// K5; the candidate sets add n·S·k·12 bytes each way.
//
// What the design does about it: a grid of (user tile, shard); each block
// runs topk.cuh's stable block scan over its shard's items; the merge is
// one warp per user row, each of its lanes holding one shard's head: k
// steps of a warp-wide argmax, the lower shard winning a tie.

#include <cuda_runtime.h>

#include "topk.cuh"

namespace {

constexpr int kMaxShards = 32;  // one lane per shard in the merge

__global__ void __launch_bounds__(topk::kThreads)
topk_merge_ring_kernel(const float* __restrict__ U,
                       const float* __restrict__ V,
                       const unsigned char* __restrict__ valid,
                       float* __restrict__ coll_s,
                       long long* __restrict__ coll_i,
                       unsigned* __restrict__ tickets,
                       float* __restrict__ out_s,
                       long long* __restrict__ out_i, long long n,
                       long long ni_loc, int r, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ bool last;
  const topk::Lists l = topk::carve(smem_raw, k);
  const long long tile = blockIdx.x;
  const int s = blockIdx.y, S = gridDim.y;
  const long long u0 = tile * topk::kTU;
  topk::init(l, k);
  topk::scan(U, V + static_cast<size_t>(s) * ni_loc * r,
             valid + static_cast<size_t>(s) * ni_loc, n, ni_loc, r, k, u0,
             static_cast<long long>(s) * ni_loc, l);
  // this shard's set for the tile -> coll[tile, s]
  const size_t set = static_cast<size_t>(topk::kTU) * k;
  float* cs = coll_s + (static_cast<size_t>(tile) * S + s) * set;
  long long* ci = coll_i + (static_cast<size_t>(tile) * S + s) * set;
  for (int t = threadIdx.x; t < topk::kTU * k; t += topk::kThreads) {
    cs[t] = l.Ls[t];
    ci[t] = l.Li[t];
  }
  __threadfence();  // the set is visible device-wide before the ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + tile, 1u) == S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // merge the tile's S sets in shard order: per row, lane j < S holds the
  // head of shard j's sorted set; k steps of a warp-wide argmax
  const float* ts = coll_s + static_cast<size_t>(tile) * S * set;
  const long long* ti = coll_i + static_cast<size_t>(tile) * S * set;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int row = warp; row < topk::kTU; row += topk::kWarps) {
    const long long u = u0 + row;
    if (u >= n) break;
    int head = 0;
    for (int j = 0; j < k; ++j) {
      // -inf: below every kept score, sentinels included
      float bs = __int_as_float(0xff800000u);
      int bl = lane;
      if (lane < S && head < k)
        bs = __ldcg(ts + lane * set + static_cast<size_t>(row) * k + head);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_xor_sync(0xffffffffu, bs, off);
        const int ol = __shfl_xor_sync(0xffffffffu, bl, off);
        if (os > bs || (os == bs && ol < bl)) { bs = os; bl = ol; }
      }
      const int bh = __shfl_sync(0xffffffffu, head, bl);
      if (lane == 0) {
        const bool real = bs > topk::kNegInf;
        out_s[u * k + j] = real ? bs : topk::kNegInf;
        out_i[u * k + j] =
            real ? __ldcg(ti + bl * set + static_cast<size_t>(row) * k + bh)
                 : 0;
      }
      if (lane == bl) ++head;
    }
  }
}

}  // namespace

// coll_s/coll_i: scratch of n_tiles·S·64·k entries; tickets: n_tiles
// zeroed counters (n_tiles = ceil(n / 64)).
extern "C" int topk_merge_ring_f32(const float* U, const float* V,
                                   const unsigned char* valid, float* coll_s,
                                   long long* coll_i, unsigned* tickets,
                                   float* out_s, long long* out_i,
                                   long long n, long long ni_loc, int S,
                                   int r, int k, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > topk::kMaxK || r < 1 || S < 1 || S > kMaxShards ||
      ni_loc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n + topk::kTU - 1) / topk::kTU;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = topk::smem_bytes(k);
  cudaError_t e = cudaFuncSetAttribute(
      topk_merge_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  topk_merge_ring_kernel<<<dim3(static_cast<unsigned>(tiles), S),
                           topk::kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      U, V, valid, coll_s, coll_i, tickets, out_s, out_i, n, ni_loc, r, k);
  return static_cast<int>(cudaGetLastError());
}
