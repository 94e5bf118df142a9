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
//
// Across the processes of a group on one card (parallel/serve.py's
// 'merge_ring' when process_count > 1) the candidate sets, not the
// catalog, move, as on the TPU: topk_sets_f32 scores every query row
// against this process's L shards and writes the L·P sets to a buffer
// its peers map (CUDA IPC); after a barrier topk_merge_sets_f32 merges
// this process's query rows over every process's sets, reached through
// arrays of base pointers.  Both are topk.cuh's own scan and merge, so
// the rows are the one-process launch's bit for bit.

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

// Scan-to-sets: coll_s/coll_i [ceil(n / 64), L·P, 64, k] (the exported
// buffer), every (user tile, local shard, part)'s stable set, ids
// globalized as id0 + s·ni_loc + local (id0: the first local shard's
// mesh position times ni_loc).
extern "C" int topk_sets_f32(const float* U, const float* V,
                             const unsigned char* valid, float* coll_s,
                             long long* coll_i, long long n,
                             long long ni_loc, int L, int r, int k, int P,
                             long long id0, void* stream) {
  return topk::launch_scan(U, V, valid, coll_s, coll_i, nullptr, nullptr,
                           nullptr, n, ni_loc, L, P, r, k, id0, true,
                           static_cast<cudaStream_t>(stream));
}

// Merge-from-sets: query rows [q0, q0 + nq) -> out [nq, k]; bases_s /
// bases_i: device arrays of nbase pointers (one buffer a process, in
// process order), each [ceil(n / 64), spb, 64, k].
extern "C" int topk_merge_sets_f32(const float* const* bases_s,
                                   const long long* const* bases_i,
                                   int nbase, int spb, long long q0,
                                   long long nq, int k, float* out_s,
                                   long long* out_i, void* stream) {
  return topk::launch_merge(bases_s, bases_i, nbase, spb, q0, nq, k, out_s,
                            out_i, static_cast<cudaStream_t>(stream));
}
