"""Top-k items per query row: the sentinel and the plain chunked version.

Counterpart of ``tpu_als/ops/topk.py``.  :func:`chunked_topk_scores` is the
plain PyTorch version of kernel K5 (a score GEMM per item chunk folded
into a running ``torch.topk``).  The reference's ``topk_scores`` dispatch
is :func:`tpu_als_torch.ops.cuda_topk.topk_scores`: a CUDA tensor goes to
the kernel and a CPU tensor here.
"""

from __future__ import annotations

import torch

# the sentinel score of a slot that holds no valid item (as in tpu_als)
NEG_INF = -3.4e38


def topk_validity(scores):
    """Bool mask of the slots in a top-k result that hold a real score;
    the surplus slots of a row with fewer than k valid items hold
    ``NEG_INF`` with meaningless ids."""
    return scores > NEG_INF


def chunked_topk_scores(U, V, item_valid, k, item_chunk=8192):
    """Top-k items per row of ``U``: U [n, r], V [Ni, r], item_valid [Ni]
    bool.  Returns (scores [n, k] float32 descending, ids [n, k] int64).

    Rows with fewer than ``k`` valid items carry ``NEG_INF`` with
    meaningless ids in the surplus slots.
    """
    n = U.shape[0]
    Ni = V.shape[0]
    dev = U.device
    best_s = torch.full((n, k), NEG_INF, dtype=torch.float32, device=dev)
    best_i = torch.zeros((n, k), dtype=torch.int64, device=dev)
    U = U.float()
    for off in range(0, Ni, item_chunk):
        Vt = V[off:off + item_chunk].float()
        scores = U @ Vt.T
        scores = torch.where(item_valid[off:off + item_chunk][None, :],
                             scores, NEG_INF)
        ids = torch.arange(off, off + Vt.shape[0], device=dev)
        cat_s = torch.cat([best_s, scores], dim=1)
        cat_i = torch.cat([best_i, ids.expand(n, -1)], dim=1)
        best_s, sel = torch.topk(cat_s, k, dim=1)
        best_i = torch.gather(cat_i, 1, sel)
    return best_s, best_i

