// Kernel K8: cross-shard top-k — each shard's stable running top-k, then
// a stable merge of the candidate sets in shard order; for Hopper
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
// Here the blocks of the S shards write their sets to a scratch in
// device memory and the last block of a user tile to finish merges them
// (topk.cuh): one launch, no spin-waits, no block waits for another to
// be resident.
//
// What bounds it on this card: the score GEMM, 2·n·S·ni_loc·r flops, as
// K5 (three TF32 products each on the tensor cores); the candidate sets
// add n·S·P·k·12 bytes each way.
//
// What the design does about it: topk.cuh's scan with S shards, each
// shard cut in P parts (S·P <= 32 where S allows, else P = 1; a lane of
// the merging warp holds sets j, j + 32, ...), so K8 is K5's kernel with
// its sets spread over shards, up to 65,535 shards (the grid's y limit).

#include <cuda_runtime.h>

#include "topk.cuh"

// coll_s/coll_i: scratch of ceil(n / 64)·S·P·64·k entries; tickets:
// ceil(n / 64) zeroed counters (both unused when S·P == 1).
extern "C" int topk_merge_ring_f32(const float* U, const float* V,
                                   const unsigned char* valid, float* coll_s,
                                   long long* coll_i, unsigned* tickets,
                                   float* out_s, long long* out_i,
                                   long long n, long long ni_loc, int S,
                                   int r, int k, int P, void* stream) {
  return topk::launch(U, V, valid, coll_s, coll_i, tickets, out_s, out_i, n,
                      ni_loc, S, P, r, k, static_cast<cudaStream_t>(stream));
}
