"""Kernels K5 (fused score GEMM + running top-k) and K8 (the cross-shard
top-k merge) — wrappers.

K5 :func:`topk_scores`: counterpart of
``tpu_als/ops/pallas_topk.py::topk_scores_pallas``, source
``tpu_als_torch/csrc/topk.cu``.  Same contract as
:func:`tpu_als_torch.ops.topk.chunked_topk_scores`, which is its plain
version: U [n, r] f32, V [Ni, r] f32, item_valid [Ni] bool, k <= 128 ->
(scores [n, k] f32 descending, ids [n, k] int64); surplus slots hold
exactly ``NEG_INF``; tie order is not promised.

K8 :func:`topk_merge_ring`: counterpart of
``tpu_als/ops/pallas_topk.py::topk_merge_ring``, source
``tpu_als_torch/csrc/topk_merge_ring.cu``: the catalog in S shards, each
shard's stable top-k, then their stable merge in shard order — bitwise
``chunked_topk_scores`` over the concatenated catalog, tie order
included; plain version :func:`topk_merge_ring_plain`.

A CUDA tensor goes to a kernel (or raises); only a CPU tensor takes a
plain version.
"""

from __future__ import annotations

import torch

from tpu_als_torch import _build
from tpu_als_torch.ops.topk import NEG_INF, chunked_topk_scores, merge_topk

MAX_K = 128
# K8's merge holds one shard per lane of a warp
MAX_SHARDS = 32
# user rows per block in csrc/topk.cuh (kTU): K8's scratch holds one
# candidate set per (tile of this many users, shard)
_TILE_U = 64

# kernel launches in this process; a run reads them to show that its path
# went through the kernels
LAUNCHES = 0        # K5
MERGE_LAUNCHES = 0  # K8


def _check(U, V, item_valid, k):
    if U.dtype != torch.float32 or V.dtype != torch.float32:
        raise TypeError(f"top-k takes float32 factors, got {U.dtype}, "
                        f"{V.dtype}")
    if item_valid.dtype != torch.bool:
        raise TypeError(f"item_valid must be bool, got {item_valid.dtype}")
    if U.dim() != 2 or V.dim() != 2 or U.shape[1] != V.shape[1] \
            or item_valid.shape != (V.shape[0],):
        raise ValueError(f"top-k takes U [n, r], V [Ni, r], item_valid "
                         f"[Ni]; got {tuple(U.shape)}, {tuple(V.shape)}, "
                         f"{tuple(item_valid.shape)}")
    if not (U.device == V.device == item_valid.device):
        raise ValueError("U, V and item_valid must share a device")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")


def topk_scores(U, V, item_valid, k, item_chunk=8192):
    """Top-k per row of U: kernel K5 for CUDA tensors, the plain chunked
    version (``item_chunk`` items per step) for CPU tensors."""
    global LAUNCHES
    _check(U, V, item_valid, k)
    if U.device.type == "cpu":
        return chunked_topk_scores(U, V, item_valid, k,
                                   item_chunk=item_chunk)
    if U.device.type != "cuda":
        raise ValueError(f"top-k runs on cuda or cpu, not {U.device}")
    if k > MAX_K:
        raise NotImplementedError(
            f"k = {k} > {MAX_K}: the fused top-k kernel keeps at most "
            f"{MAX_K} candidates per row, as the TPU kernel does")
    if not (U.is_contiguous() and V.is_contiguous()
            and item_valid.is_contiguous()):
        raise ValueError("top-k takes contiguous U, V and item_valid")
    n, r = U.shape
    scores = torch.empty((n, k), dtype=torch.float32, device=U.device)
    ids = torch.empty((n, k), dtype=torch.int64, device=U.device)
    if n == 0:
        return scores, ids
    fn = _build.load("topk")
    with torch.cuda.device(U.device):
        stream = torch.cuda.current_stream(U.device).cuda_stream
        err = fn(U.data_ptr(), V.data_ptr(), item_valid.data_ptr(),
                 scores.data_ptr(), ids.data_ptr(), n, V.shape[0], r, k,
                 stream)
    _build.check(err, "topk_f32")
    LAUNCHES += 1
    return scores, ids


def topk_merge_ring_plain(U, V_shards, valid_shards, k):
    """K8's function in plain PyTorch: the stable chunked top-k of every
    shard (ids globalized, s·ni_loc + local), folded into the running set
    in shard order by the stable merge, the carried set first."""
    S, ni_loc = V_shards.shape[:2]
    n = U.shape[0]
    best_s = torch.full((n, k), NEG_INF, dtype=torch.float32,
                        device=U.device)
    best_i = torch.zeros((n, k), dtype=torch.int64, device=U.device)
    for s in range(S):
        cs, ci = chunked_topk_scores(U, V_shards[s], valid_shards[s], k)
        best_s, best_i = merge_topk(best_s, best_i, cs, ci + s * ni_loc, k)
    return best_s, best_i


def topk_merge_ring(U, V_shards, valid_shards, k):
    """Top-k over a catalog in S shards: U [n, r] f32, V_shards
    [S, ni_loc, r] f32, valid_shards [S, ni_loc] bool, 1 <= k <= 128 ->
    (scores [n, k] f32, ids [n, k] int64, global id s·ni_loc + local).
    Kernel K8 for CUDA tensors, :func:`topk_merge_ring_plain` for CPU
    tensors."""
    global MERGE_LAUNCHES
    if V_shards.dim() != 3 or valid_shards.shape != V_shards.shape[:2]:
        raise ValueError(f"topk_merge_ring takes V_shards [S, ni_loc, r] and "
                         f"valid_shards [S, ni_loc]; got "
                         f"{tuple(V_shards.shape)}, "
                         f"{tuple(valid_shards.shape)}")
    S, ni_loc, r = V_shards.shape
    _check(U, V_shards.reshape(S * ni_loc, r), valid_shards.reshape(-1), k)
    if k > MAX_K:
        raise ValueError(f"topk_merge_ring takes k <= {MAX_K}, got {k}: the "
                         "merged candidate sets hold at most that many, as "
                         "the TPU kernel's do")
    if U.device.type == "cpu":
        return topk_merge_ring_plain(U, V_shards, valid_shards, k)
    if U.device.type != "cuda":
        raise ValueError(f"top-k runs on cuda or cpu, not {U.device}")
    if S > MAX_SHARDS:
        raise NotImplementedError(
            f"{S} shards > {MAX_SHARDS}: K8's merge holds one shard per "
            "lane of a warp")
    if not (U.is_contiguous() and V_shards.is_contiguous()
            and valid_shards.is_contiguous()):
        raise ValueError("topk_merge_ring takes contiguous tensors")
    n = U.shape[0]
    scores = torch.full((n, k), NEG_INF, dtype=torch.float32,
                        device=U.device)
    ids = torch.zeros((n, k), dtype=torch.int64, device=U.device)
    if n == 0 or ni_loc == 0:
        return scores, ids
    tiles = -(-n // _TILE_U)
    coll_s = torch.empty(tiles * S * _TILE_U * k, dtype=torch.float32,
                         device=U.device)
    coll_i = torch.empty(tiles * S * _TILE_U * k, dtype=torch.int64,
                         device=U.device)
    tickets = torch.zeros(tiles, dtype=torch.int32, device=U.device)
    fn = _build.load("topk_merge_ring")
    with torch.cuda.device(U.device):
        stream = torch.cuda.current_stream(U.device).cuda_stream
        err = fn(U.data_ptr(), V_shards.data_ptr(), valid_shards.data_ptr(),
                 coll_s.data_ptr(), coll_i.data_ptr(), tickets.data_ptr(),
                 scores.data_ptr(), ids.data_ptr(), n, ni_loc, S, r, k,
                 stream)
    _build.check(err, "topk_merge_ring_f32")
    MERGE_LAUNCHES += 1
    return scores, ids
