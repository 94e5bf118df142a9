"""The ring strategy: factor shards stream past stationary accumulators.

Counterpart of ``tpu_als/parallel/comm.py``.  The ratings are blocked on
a 2-D (owner shard × source shard) grid, :class:`RingCsr`, with column
ids local to the source shard and ONE row position per entity shared by
all S sources (rows bucketed by their max-per-source degree), so a row
accumulates its normal equations across the whole ring pass before it
is solved.  The grid is built on the host with numpy, array-equal to the
reference's :func:`shard_csr_grid`.

Two half-steps over it, each for every owner at once:

- :func:`ring_half_step`, the unfused ring: per row tile, torch normal
  equations over the shard held at each of the S rotations — owner d
  holds shard (d - t) mod S after t of them — then ``solve_spd`` (kernel
  K2 up to rank 128, K6 above).  On one device the rotation is index
  arithmetic on the stacked table's shard axis, not a copy.
- :func:`ring_fused_half_step` (``solve_backend='gather_fused_ring'``):
  one launch of kernel K7 per bucket, whose blocks walk the S sources
  themselves.

The reference's ``gather_block_plan`` and ``chunked_gather_half_step``
('all_gather_chunked') are not ported yet, nor its multi-host
``positions=``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpu_als_torch.core.ratings import (
    Bucket,
    buckets_to,
    entity_widths,
    scan_chunk,
    trainer_chunk,
)
from tpu_als_torch.ops import cuda_gather_ne as gne
from tpu_als_torch.ops.solve import gram_terms, solve_cg, solve_nnls, \
    solve_spd


@dataclass
class RingCsr:
    """The (owner × source) grid of one side: rows [D, nb] (the entity of
    each row, shared by the sources), cols/vals/mask [D, S, nb, w] with
    shard-local column ids."""

    buckets: list  # list[Bucket]
    rows_per_shard: int
    chunk_elems: int
    nnz: int

    @property
    def padded_nnz(self):
        return sum(b.mask.size for b in self.buckets)

    def to(self, device):
        """The grid's buckets as tensors on ``device``."""
        return buckets_to(self.buckets, device)


def shard_csr_grid(row_part, col_part, row_idx, col_idx, vals, min_width=8,
                   chunk_elems=1 << 19):
    """Build the grid with a row space shared by the source shards: every
    source stores entity u's ratings at the same (bucket, row) position,
    and entities are bucketed by their max-per-source degree (each
    source's slice of a row pads to that width)."""
    D = row_part.n_shards
    S = col_part.n_shards
    row_idx = np.asarray(row_idx)
    col_idx = np.asarray(col_idx)
    vals = np.asarray(vals, dtype=np.float32)
    owner = row_part.owner[row_idx].astype(np.int64)
    local_rows = row_part.local[row_idx].astype(np.int64)
    src = col_part.owner[col_idx].astype(np.int64)
    local_cols = col_part.local[col_idx].astype(np.int64)
    num_rows = row_part.rows_per_shard
    n = len(row_idx)

    # per-entry offset within its (owner, row, source) group
    key = (owner * num_rows + local_rows) * S + src
    order = np.argsort(key, kind="stable")
    uniq_k, starts, kcounts = np.unique(
        key[order], return_index=True, return_counts=True)
    off = np.arange(n) - starts[np.repeat(np.arange(len(uniq_k)), kcounts)]

    # bucket width per (owner, entity): the max degree over the sources
    k_du = uniq_k // S
    maxdeg = np.zeros(D * num_rows, dtype=np.int64)
    np.maximum.at(maxdeg, k_du, kcounts)
    rated = np.zeros(D * num_rows, dtype=bool)
    rated[k_du] = True
    widths_all = entity_widths(maxdeg, min_width)

    bucket_widths = sorted(set(widths_all[rated].tolist()))
    local_pos = np.full(D * num_rows, -1, dtype=np.int64)
    nb_pads = []
    selections = {}  # (w, d) -> row indices, reused by the fill below
    for w in bucket_widths:
        nb_need = 0
        for d in range(D):
            lo = d * num_rows
            sel = np.flatnonzero(rated[lo:lo + num_rows]
                                 & (widths_all[lo:lo + num_rows] == w))
            selections[w, d] = sel
            local_pos[lo + sel] = np.arange(len(sel))
            nb_need = max(nb_need, len(sel))
        chunk = scan_chunk(nb_need, w, chunk_elems)
        nb_pads.append(-(-nb_need // chunk) * chunk)

    e_owner = owner[order]
    flat = e_owner * num_rows + local_rows[order]
    e_src = src[order]
    e_cols = local_cols[order]
    e_vals = vals[order]
    e_w = widths_all[flat]
    e_pos = local_pos[flat]

    buckets = []
    for w, nb in zip(bucket_widths, nb_pads):
        rows = np.full((D, nb), num_rows, dtype=np.int32)
        for d in range(D):
            sel = selections[w, d]
            rows[d, :len(sel)] = sel
        cols = np.zeros((D, S, nb, w), dtype=np.int32)
        v = np.zeros((D, S, nb, w), dtype=np.float32)
        m = np.zeros((D, S, nb, w), dtype=np.float32)
        esel = e_w == w
        at = (e_owner[esel], e_src[esel], e_pos[esel], off[esel])
        cols[at] = e_cols[esel]
        v[at] = e_vals[esel]
        m[at] = 1.0
        buckets.append(Bucket(rows=rows, cols=cols, vals=v, mask=m))
    return RingCsr(buckets=buckets, rows_per_shard=num_rows,
                   chunk_elems=chunk_elems, nnz=n)


def _scatter(out, b, x):
    """out [D, num_rows + 1, r] <- x [D, nb, r] at each owner's rows (the
    padding rows, ``rows == num_rows``, land in the spare row)."""
    owners = torch.arange(out.shape[0], device=out.device)[:, None]
    out[owners, b.rows] = x


def ring_fused_half_step(V_stacked, ring_buckets, num_rows, n_shards, cfg,
                         YtY=None):
    """One half-step of every owner through kernel K7, one launch per
    bucket.  ``V_stacked`` [S·per, r]: the opposite factors in slot space;
    ``ring_buckets``: the grid as tensors (:meth:`RingCsr.to`).  Returns
    the solved side [D·num_rows, r] f32.  The count and the ridge come from
    the kernel's own ``cw`` sums, as in the reference."""
    r = V_stacked.shape[-1]
    cdt = getattr(torch, cfg.compute_dtype)
    V_sh = V_stacked.to(cdt).reshape(n_shards, -1, r).contiguous()
    D = ring_buckets[0].rows.shape[0] if ring_buckets else n_shards
    out = torch.zeros(D, num_rows + 1, r, dtype=torch.float32,
                      device=V_stacked.device)
    for b in ring_buckets:
        vals, mask = b.vals.to(cdt), b.mask.to(cdt)
        if cfg.implicit_prefs:
            x = gne.gather_fused_ring_implicit(
                V_sh, b.cols, vals, mask, cfg.reg_param, cfg.alpha, YtY,
                jitter=cfg.jitter)
        else:
            x = gne.gather_fused_ring_explicit(
                V_sh, b.cols, vals, mask, cfg.reg_param, jitter=cfg.jitter)
        _scatter(out, b, x)
    return out[:, :num_rows].reshape(D * num_rows, r)


def ring_half_step(V_stacked, ring_buckets, counts, num_rows, n_shards, cfg,
                   chunk_elems, YtY=None, prev=None, fused=False):
    """One half-step of every owner with the factor shards streaming.

    ``V_stacked`` [S·per, r]: the opposite factors in slot space;
    ``ring_buckets``: the grid as tensors; ``counts`` [D, num_rows]: each
    row's rating count (implicit: positive ones) for the λ·n ridge;
    ``prev`` [D·num_rows, r]: the solved side's current factors, the CG
    warm start.  Per owner, bucket and row tile (``trainer_chunk``), the
    normal equations sum the held shard's terms over the S rotations, then
    the tile is solved: NNLS when nonnegative, warm-started CG when
    ``cg_iters > 0``, else ``solve_spd``.  ``fused=True`` is
    :func:`ring_fused_half_step` (not with nonnegative: NNLS has no fused
    kernel).  Returns [D·num_rows, r] f32."""
    if fused and not cfg.nonnegative:
        return ring_fused_half_step(V_stacked, ring_buckets, num_rows,
                                    n_shards, cfg, YtY=YtY)
    r = V_stacked.shape[-1]
    dev = V_stacked.device
    cdt = getattr(torch, cfg.compute_dtype)
    V_sh = V_stacked.to(cdt).reshape(n_shards, -1, r)
    D = counts.shape[0]
    eye = torch.eye(r, dtype=torch.float32, device=dev)
    out = torch.zeros(D, num_rows + 1, r, dtype=torch.float32, device=dev)
    cg = (cfg.cg_iters > 0
          and cfg.solve_backend not in ("gather_fused_solve",
                                        "gather_fused_ring"))
    for b in ring_buckets:
        _, S, nb, w = b.cols.shape
        tile = trainer_chunk(nb, w, r, chunk_elems)
        vals, mask = b.vals.to(cdt), b.mask.to(cdt)
        for d in range(D):
            for s0 in range(0, nb, tile):
                sl = slice(s0, s0 + tile)
                rows = b.rows[d, sl]
                A = torch.zeros(rows.shape[0], r, r, dtype=torch.float32,
                                device=dev)
                bb = torch.zeros(rows.shape[0], r, dtype=torch.float32,
                                 device=dev)
                for t in range(S):
                    src = (d - t) % S  # the shard held after t rotations
                    Vg = V_sh[src][b.cols[d, src, sl].long()]
                    Sg, bg, _ = gram_terms(Vg, vals[d, src, sl],
                                           mask[d, src, sl],
                                           implicit=cfg.implicit_prefs,
                                           alpha=cfg.alpha)
                    A = A + Sg
                    bb = bb + bg
                # padding rows read a real row's count; their b is 0, so
                # they solve to 0, and the scatter drops them
                at = torch.clamp(rows, max=num_rows - 1)
                cnt = counts[d][at]
                A = A + (cfg.reg_param * cnt)[:, None, None] * eye
                if cfg.implicit_prefs:
                    A = A + YtY[None]
                if cfg.nonnegative:
                    x = solve_nnls(A, bb, cnt, sweeps=cfg.nnls_sweeps,
                                   jitter=cfg.jitter)
                elif cg:
                    x0 = (None if prev is None
                          else prev[d * num_rows:(d + 1) * num_rows][at])
                    x = solve_cg(A, bb, cnt, x0=x0, iters=cfg.cg_iters,
                                 jitter=cfg.jitter)
                else:
                    x = solve_spd(A, bb, cnt, jitter=cfg.jitter)
                out[d, rows] = x
    return out[:, :num_rows].reshape(D * num_rows, r)
