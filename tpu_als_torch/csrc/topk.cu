// Kernel K5: fused score GEMM + running top-k, for Hopper (sm_90a).
//
// Replaces: tpu_als/ops/pallas_topk.py::topk_scores_pallas (body
// _topk_kernel), the top-k that ALSModel.recommendFor* and
// recommend_arrays run.  Same contract: U [n, r] f32, V [ni, r] f32,
// valid [ni] bool, 1 <= k <= 128 -> scores [n, k] f32 sorted descending
// and ids [n, k] (int64 here, int32 on the TPU).  Invalid items are never
// returned while enough valid ones exist; when fewer than k are valid the
// surplus slots hold exactly NEG_INF (-3.4e38) with id 0.  The order is
// stable (an equal score keeps the lower id first) though the contract
// does not promise it.  Scores never go to device memory.
//
// Precision differs from the TPU on purpose: the TPU ran the score GEMM
// at default precision (one bf16 pass); this kernel computes every score
// to f32 accuracy on the tensor cores (3xTF32), as K3's Gram does.
//
// What bounds it on this card: the GEMM, 2·n·ni·r flops (2.46 TFLOP for
// all 162,541 users x 59,047 items at rank 128): ~14.9 ms as three TF32
// products at the 495 TFLOP/s dense TF32 rate (~37 ms at the 67 TFLOP/s
// f32 rate outside the tensor cores); bytes are only the factor tables
// and the [n, k] result.
//
// What the design does about it: topk.cuh's scan with one shard — the
// score GEMM on the tensor cores, the query tile read once, the catalog
// streamed by cp.async, selection from registers, and the catalog split
// in P parts over blocks when the user tiles alone would not fill the
// card (the last block of a tile merges the parts).

#include <cuda_runtime.h>

#include "topk.cuh"

// coll_s/coll_i: scratch of ceil(n / 64)·P·64·k entries and tickets:
// ceil(n / 64) zeroed counters when P > 1 (null otherwise).
extern "C" int topk_f32(const float* U, const float* V,
                        const unsigned char* valid, float* coll_s,
                        long long* coll_i, unsigned* tickets, float* out_s,
                        long long* out_i, long long n, long long ni, int r,
                        int k, int P, void* stream) {
  return topk::launch(U, V, valid, coll_s, coll_i, tickets, out_s, out_i, n,
                      ni, 1, P, r, k, static_cast<cudaStream_t>(stream));
}
