"""Kernel K5: fused score GEMM + running top-k — wrapper.

Counterpart of ``tpu_als/ops/pallas_topk.py::topk_scores_pallas``.  The
CUDA source is ``tpu_als_torch/csrc/topk.cu``.  Same contract as
:func:`tpu_als_torch.ops.topk.chunked_topk_scores`, which is its plain
version: U [n, r] f32, V [Ni, r] f32, item_valid [Ni] bool, k <= 128 ->
(scores [n, k] f32 descending, ids [n, k] int64); surplus slots hold
exactly ``NEG_INF``; tie order is not promised.

A CUDA tensor goes to the kernel (or raises); only a CPU tensor takes the
plain version.
"""

from __future__ import annotations

import torch

from tpu_als_torch import _build
from tpu_als_torch.ops.topk import chunked_topk_scores

MAX_K = 128

# kernel launches in this process; a run reads it to show that its path
# went through the kernel
LAUNCHES = 0


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
