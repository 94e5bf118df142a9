"""Sharded top-k serving: ``recommendForAll*`` over a mesh of shards.

Counterpart of ``tpu_als/parallel/serve.py::topk_sharded``, with its three
strategies.  The catalog is padded to S·ni_loc rows and cut into S shards
of ni_loc; global item id = s·ni_loc + local.

- ``'all_gather'``: the queries cut into S shards; each query shard runs
  kernel K5 over the whole catalog (on one device, the stacked shards).
- ``'ring'``: each query shard runs K5 over one catalog shard per
  rotation — owner d holds catalog shard (d - t) mod S after t of them —
  and folds it into its running set with the stable merge (the
  reference leaves that merge to XLA).  ``k > 128`` takes this strategy
  whatever was asked, as in the reference.
- ``'merge_ring'``: kernel K8 — every shard scores the whole query set
  against its own catalog shard, and the S candidate sets merge in shard
  order, bitwise ``chunked_topk_scores`` over the whole catalog, tie
  order included.

The reference's degraded mode (answering from a last-good catalog when
the sharded call raises) is not ported: it would hide a kernel failure;
it belongs with the resilience slice, and here the call raises.
"""

from __future__ import annotations

import torch

from tpu_als_torch.ops import cuda_topk
from tpu_als_torch.ops.topk import NEG_INF, merge_topk

STRATEGIES = ("all_gather", "ring", "merge_ring")


def _as_f32(x, device):
    return torch.as_tensor(x).to(device=device, dtype=torch.float32) \
        .contiguous()


def topk_sharded(U, V, k, mesh, strategy="all_gather", item_valid=None,
                 item_chunk=8192):
    """Top-k of every row of ``U`` [Nu, r] over the catalog ``V`` [Ni, r]
    (``item_valid`` [Ni] bool, default all valid) on ``mesh``: (scores
    [Nu, k'] float32, ids [Nu, k'] int64) with ``k' = min(k, Ni)``, as
    tensors on the mesh's device.  The scores are those of
    ``chunked_topk_scores(U, V, valid, k')``; ``'merge_ring'`` also
    returns its ids, the others may order ties differently."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown serving strategy {strategy!r} "
                         f"(expected one of {STRATEGIES})")
    dev = mesh.device
    U, V = _as_f32(U, dev), _as_f32(V, dev)
    Nu, r = U.shape
    Ni = V.shape[0]
    if Ni == 0 or Nu == 0:
        kk = min(k, Ni)
        return (torch.zeros(Nu, kk, dtype=torch.float32, device=dev),
                torch.zeros(Nu, kk, dtype=torch.int64, device=dev))
    valid = (torch.ones(Ni, dtype=torch.bool, device=dev)
             if item_valid is None
             else torch.as_tensor(item_valid).to(device=dev,
                                                 dtype=torch.bool))
    D = mesh.size
    k_eff = min(k, Ni)
    ni_loc = -(-Ni // D)
    if strategy == "merge_ring" and k_eff > cuda_topk.MAX_K:
        strategy = "ring"  # the merged candidate sets hold at most 128
    # the catalog in D shards of ni_loc rows; padding rows are invalid
    Vp = torch.zeros(D * ni_loc, r, dtype=torch.float32, device=dev)
    Vp[:Ni] = V
    validp = torch.zeros(D * ni_loc, dtype=torch.bool, device=dev)
    validp[:Ni] = valid
    if strategy == "merge_ring":
        return cuda_topk.topk_merge_ring(U, Vp.reshape(D, ni_loc, r),
                                         validp.reshape(D, ni_loc), k_eff)
    nu_loc = -(-Nu // D)
    k_loc = min(k_eff, ni_loc)
    out_s, out_i = [], []
    for d in range(D):
        Ud = U[d * nu_loc:(d + 1) * nu_loc]
        if strategy == "all_gather":
            s, ix = cuda_topk.topk_scores(Ud, Vp, validp, k_eff,
                                          item_chunk=min(item_chunk,
                                                         D * ni_loc))
        else:
            s = torch.full((Ud.shape[0], k_eff), NEG_INF,
                           dtype=torch.float32, device=dev)
            ix = torch.zeros(Ud.shape[0], k_eff, dtype=torch.int64,
                             device=dev)
            for t in range(D):
                own = (d - t) % D  # the catalog shard held after t rotations
                sl = slice(own * ni_loc, (own + 1) * ni_loc)
                st, it = cuda_topk.topk_scores(
                    Ud, Vp[sl], validp[sl], k_loc,
                    item_chunk=min(item_chunk, ni_loc))
                s, ix = merge_topk(s, ix, st, own * ni_loc + it, k_eff)
        out_s.append(s)
        out_i.append(ix)
    return torch.cat(out_s), torch.cat(out_i)
