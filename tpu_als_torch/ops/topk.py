"""Top-k items per query row: the sentinel and the plain chunked version.

Counterpart of ``tpu_als/ops/topk.py``.  :func:`chunked_topk_scores` is the
plain PyTorch version of kernel K5 (a score GEMM per item chunk folded
into a running stable selection).  The reference's ``topk_scores``
dispatch is :func:`tpu_als_torch.ops.cuda_topk.topk_scores`: a CUDA
tensor goes to the kernel and a CPU tensor here.
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


def stable_topk(x, k):
    """The k largest entries of each row of ``x`` [n, m] (k <= m) in
    ``lax.top_k``'s order: value descending, the lower column first on a
    tie.  Returns (values [n, k], columns [n, k] int64).

    ``torch.topk`` promises no tie order, so it only finds each row's
    k-th value; every entry above it is kept, and of the entries equal to
    it the first ones by column, as many as are missing; a stable sort of
    those k puts them in order.  (A stable sort of the whole row would do
    the same with several times the memory.)"""
    thr = torch.topk(x, k, dim=1).values[:, -1:]
    above = x > thr
    tied = x == thr
    need = k - above.sum(1, keepdim=True, dtype=torch.int32)
    keep = above | (tied & (tied.cumsum(1, dtype=torch.int32) <= need))
    cols = keep.nonzero()[:, 1].view(-1, k)  # row-major: columns ascending
    vals, order = torch.sort(torch.gather(x, 1, cols), dim=1,
                             descending=True, stable=True)
    return vals, torch.gather(cols, 1, order)


def chunked_topk_scores(U, V, item_valid, k, item_chunk=8192):
    """Top-k items per row of ``U``: U [n, r], V [Ni, r], item_valid [Ni]
    bool.  Returns (scores [n, k] float32 descending, ids [n, k] int64).

    The order is ``lax.top_k``'s, as in the reference: score descending,
    the lower column first on a tie, with the carried best at the low
    columns of each step — so equal scores keep the lower item id.  Rows
    with fewer than ``k`` valid items carry ``NEG_INF`` with id 0 (the
    initial best's) in the surplus slots.
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
        best_s, sel = stable_topk(torch.cat([best_s, scores], dim=1), k)
        best_i = torch.where(sel < k,
                             torch.gather(best_i, 1, sel.clamp(max=k - 1)),
                             off + sel - k)
    return best_s, best_i


def merge_topk(s1, i1, s2, i2, k):
    """Fold the candidates (s2, i2) into the running (s1, i1): the k best
    of their concatenation in the stable order (score descending, the
    earlier column first on a tie), so (s1, i1) win ties."""
    s, sel = stable_topk(torch.cat([s1, s2], dim=1), k)
    return s, torch.gather(torch.cat([i1, i2], dim=1), 1, sel)
