"""The ragged ``all_to_all`` gather strategy.

Counterpart of ``tpu_als/parallel/a2a.py``: each owner receives, from
each source shard, only the opposite-factor rows its rating shard
references.  The request lists are computed on the host once
(:func:`build_a2a`), padded to one budget ``R`` per (source, destination)
pair, and the rating shards' column ids are remapped to compact ids
``s·R + position`` into the received ``[S·R, r]`` table, so that after
the exchange the half-step is the unchanged ``local_half_step`` (K4 on
narrow buckets, K3 + K1/K6 on wide ones).

On one device the exchange for destination d is an index gather: the
rows ``send_idx[s, d]`` of every source shard s of the stacked table,
stacked in source order (:func:`a2a_half_step`).  The host build is
array-equal to the reference's, its ``positions=`` build (one process of
a multi-process mesh: only that process's source rows of the send table
and its owners' shards, the plan still computed from every rating) too.
Across processes the exchange is one ``all_to_all`` between them
(:func:`~tpu_als_torch.parallel.multihost.all_to_all`): each process
sends every destination the rows its sources hold for it, so each owner
receives only its referenced rows, stacked in source order into the same
compact table as on one process.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from tpu_als_torch.core.als import local_half_step
from tpu_als_torch.core.ratings import (Bucket, build_csr_buckets, buckets_to,
                                        unique_inverse)
from tpu_als_torch.parallel import multihost
from tpu_als_torch.parallel.data import Partition, shard_layout, stack_shards


@dataclass
class A2aCsr:
    """Rating shards and routing tables for one side's half-step: bucket
    arrays [D, nb, w] (cols hold compact ids into the received table);
    ``send_idx`` [S_src, D_dst, R]: the local factor rows of each source
    shard that each destination requests (0-padded; no compact id points
    at a padding slot)."""

    buckets: list
    send_idx: np.ndarray
    rows_per_shard: int
    request_budget: int  # R
    chunk_elems: int
    nnz: int
    # the budget is the max over (src, dst) pairs, so one hot pair
    # inflates the whole [D, D, R] exchange: these fields show it
    padding_ratio: float = 1.0  # D²·R / true request-list entries
    degenerate: bool = False    # True when exchanged rows >= all_gather's
    # None: the full build; a tuple: one process's mesh positions
    positions: tuple = None

    def to(self, device):
        """``(buckets, send_idx)`` as tensors on ``device``."""
        return (buckets_to(self.buckets, device),
                torch.as_tensor(self.send_idx).to(device))


def build_a2a(row_part, col_part, row_idx, col_idx, vals, min_width=8,
              chunk_elems=1 << 19, on_degenerate="build", positions=None):
    """Rating shards with compact column ids, and the exchange plan.

    ``row_part`` / ``col_part``: the Partition of the solved side / the
    gathered side, with equal shard counts.  ``on_degenerate``: when the
    budget R reaches the opposite side's rows per shard (the exchange
    moves at least what ``'all_gather'`` moves), ``'build'`` warns and
    still builds a working plan; ``'stub'`` returns at once with
    ``degenerate=True`` and no shard or table arrays (not trainable: the
    caller falls back).  ``positions`` (one process's mesh positions):
    allocate and fill ONLY those positions' source rows of ``send_idx``
    (``[len(positions), D, R]``) and their owners' shards; R, the
    compact ids and the degeneration are still computed from every
    rating, so every process agrees.  Equals the full build's slice at
    ``positions``."""
    if on_degenerate not in ("build", "stub"):
        raise ValueError(f"on_degenerate must be 'build' or 'stub', got "
                         f"{on_degenerate!r}")
    D = row_part.n_shards
    if col_part.n_shards != D:
        raise ValueError("all_to_all requires equal shard counts per side")
    row_idx = np.asarray(row_idx)
    col_idx = np.asarray(col_idx)
    vals = np.asarray(vals)
    owner_r = row_part.owner[row_idx]
    local_r = row_part.local[row_idx]
    owner_c = col_part.owner[col_idx]
    local_c = col_part.local[col_idx].astype(np.int64)
    rps = col_part.rows_per_shard

    # unique (dst, src, local_col) triples, sorted: a triple's position in
    # its (dst, src) group is its slot in that destination's request list
    key = (owner_r.astype(np.int64) * D + owner_c) * rps + local_c
    uniq, inv = unique_inverse(key, D * D * rps)
    grp = (uniq // rps).astype(np.int64)            # dst·D + src, sorted
    loc = (uniq % rps).astype(np.int64)
    starts = np.searchsorted(grp, np.arange(D * D))
    pos = np.arange(len(uniq)) - starts[grp]
    # one budget for every pair, padded to a multiple of 8
    R_true = int(pos.max()) + 1 if len(uniq) else 1
    R = max(8, -(-R_true // 8) * 8)

    true_requests = max(1, len(uniq))
    padding_ratio = (D * D * R) / true_requests
    degenerate = R_true >= rps
    if degenerate:
        warnings.warn(
            f"all_to_all request budget R={R_true} >= opposite rows/shard "
            f"{rps}: the exchange moves at least as many bytes as "
            "all_gather (clustered-skew rating layout); prefer "
            "gatherStrategy='all_gather' or 'ring'", stacklevel=2)
        if on_degenerate == "stub":
            return A2aCsr(
                buckets=[], send_idx=np.zeros((D, D, 0), dtype=np.int32),
                rows_per_shard=row_part.rows_per_shard, request_budget=R,
                chunk_elems=chunk_elems, nnz=len(row_idx),
                padding_ratio=padding_ratio, degenerate=True)

    local = positions is not None
    pos_list = list(positions) if local else list(range(D))
    pos_of = np.full(D, -1, dtype=np.int64)
    pos_of[pos_list] = np.arange(len(pos_list))
    dst = grp // D
    src = grp % D
    send_idx = np.zeros((len(pos_list), D, R), dtype=np.int32)
    ssel = pos_of[src] >= 0
    send_idx[pos_of[src[ssel]], dst[ssel], pos[ssel]] = loc[ssel]

    # compact col id per rating: src_shard·R + request position
    compact = (owner_c.astype(np.int64) * R + pos[inv]).astype(np.int64)

    shards = []
    for d in pos_list:
        sel = owner_r == d
        shards.append(build_csr_buckets(
            local_r[sel], compact[sel], vals[sel],
            num_rows=row_part.rows_per_shard, min_width=min_width,
            chunk_elems=chunk_elems))
    # the layout from the counts per (shard, local row), as the
    # reference derives it
    rps_row = row_part.rows_per_shard
    flat_counts = np.bincount(owner_r.astype(np.int64) * rps_row + local_r,
                              minlength=D * rps_row)
    slot_part = Partition(
        owner=np.repeat(np.arange(D, dtype=np.int32), rps_row),
        local=np.tile(np.arange(rps_row, dtype=np.int32), D),
        rows_per_shard=rps_row, n_shards=D)
    layout = shard_layout(slot_part, flat_counts, min_width, chunk_elems)
    pos_t = tuple(pos_list) if local else None
    stacked = stack_shards(shards, chunk_elems, layout=layout,
                           positions=pos_t)
    return A2aCsr(buckets=stacked.buckets, send_idx=send_idx,
                  rows_per_shard=row_part.rows_per_shard,
                  request_budget=R, chunk_elems=chunk_elems,
                  nnz=len(row_idx), padding_ratio=padding_ratio,
                  degenerate=degenerate, positions=pos_t)


def _exchange(V_local, send_idx, n_local):
    """Across processes: ``[n_local]`` compact tables, one per local
    owner, each ``[S·R, r]`` in source order.  ``V_local`` [L·per, r]:
    this process's source shards; ``send_idx`` [L, D, R]: their request
    lists.  Process p sends process q the rows its sources hold for q's
    owners, ``[L, L, R, r]``, in one ``all_to_all``."""
    r = V_local.shape[-1]
    L = send_idx.shape[0]
    V_sh = V_local.reshape(L, -1, r)
    src = torch.arange(L, device=V_local.device)[:, None, None]
    rows = V_sh[src, send_idx.long()]                        # [L, D, R, r]
    blocks = [rows[:, q * n_local:(q + 1) * n_local].contiguous()
              for q in range(multihost.process_count())]
    recv = torch.cat(multihost.all_to_all(blocks))        # [S, L_dst, R, r]
    return [recv[:, j].reshape(-1, r) for j in range(n_local)]


def a2a_half_step(V_stacked, send_idx, buckets, num_rows, n_shards, cfg,
                  chunk_elems, YtY=None, prev=None, knobs=None,
                  across_processes=False):
    """One half-step of every owner with the ragged exchange.

    ``V_stacked`` [S·per, r]: the opposite factors in slot space;
    ``send_idx`` [S, D, R] (a tensor on V's device); ``buckets``: the
    side's :class:`A2aCsr` buckets as tensors; ``prev`` [D·num_rows, r]:
    the solved side's current factors, the CG warm start.  Owner d
    receives ``V_shard_s[send_idx[s, d]]`` from every source s, stacked
    in source order into the compact ``[S·R, r]`` table its column ids
    index, and solves its rows with ``local_half_step`` (``knobs`` as
    its).  ``across_processes``: ``V_stacked`` and ``send_idx`` are this
    process's L shards and the positions build's ``[L, S, R]`` lists,
    the buckets its L owners', and the tables come from the exchange
    between processes (:func:`_exchange`).  Returns [D·num_rows, r] f32
    (D: the owners here)."""
    r = V_stacked.shape[-1]
    D = buckets[0].rows.shape[0] if buckets else send_idx.shape[1]
    if across_processes:
        table = _exchange(V_stacked, send_idx, D).__getitem__
    else:  # one owner's table at a time
        V_sh = V_stacked.reshape(n_shards, -1, r)
        src = torch.arange(n_shards, device=V_stacked.device)[:, None]

        def table(d):
            return V_sh[src, send_idx[:, d].long()].reshape(-1, r)
    out = []
    for d in range(D):
        own = [Bucket(rows=b.rows[d], cols=b.cols[d], vals=b.vals[d],
                      mask=b.mask[d]) for b in buckets]
        out.append(local_half_step(
            table(d), own, num_rows, cfg, YtY, chunk_elems,
            prev=None if prev is None
            else prev[d * num_rows:(d + 1) * num_rows], knobs=knobs))
    return torch.cat(out)
