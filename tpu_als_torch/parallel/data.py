"""Sharded ratings layout: balanced entity partition, stacked CSR shards.

Counterpart of ``tpu_als/parallel/data.py`` (numpy, array-equal to it):

- a **count-balanced entity partition** (:func:`partition_balanced`):
  entities dealt round-robin in descending rating-count order;
- a **slot space**: entity e lives at ``slot[e] = owner·rows_per_shard +
  local``, so the stacked factor table ``[S·rows_per_shard, r]`` is
  indexed by slot ids directly;
- **stacked, shape-unified buckets** (:func:`shard_csr`): every shard's
  CSR buckets padded to common shapes and stacked on a leading shard
  axis, with col ids in the opposite side's slot space.

The reference's multi-host arguments (``positions=``, per-host
``row_counts``) are left out: the port runs one process.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tpu_als_torch.core.ratings import (
    Bucket,
    build_csr_buckets,
    buckets_to,
    entity_widths,
    padded_bucket_rows,
)


@dataclass
class Partition:
    """Entity -> (owner shard, local slot) assignment for one side."""

    owner: np.ndarray  # [n] shard per entity
    local: np.ndarray  # [n] local row index on the owner
    rows_per_shard: int
    n_shards: int

    @property
    def slot(self):
        """Global row in the stacked (shard-major) factor table."""
        return self.owner.astype(np.int64) * self.rows_per_shard + self.local

    @property
    def padded_rows(self):
        return self.n_shards * self.rows_per_shard


def partition_balanced(counts, n_shards):
    """Count-balanced partition: entities dealt round-robin in descending
    rating-count order (stable), so power-law degrees spread evenly."""
    counts = np.asarray(counts)
    n = len(counts)
    order = np.argsort(-counts, kind="stable")
    owner = np.empty(n, dtype=np.int32)
    local = np.empty(n, dtype=np.int32)
    k = np.arange(n)
    owner[order] = (k % n_shards).astype(np.int32)
    local[order] = (k // n_shards).astype(np.int32)
    return Partition(owner=owner, local=local,
                     rows_per_shard=-(-n // n_shards), n_shards=n_shards)


@dataclass
class ShardedCsr:
    """Shape-unified, stacked CSR shards for one side: ``buckets[k]`` arrays
    carry a leading [n_shards] axis; row ids are shard-local, col ids are
    opposite-side slot ids."""

    buckets: list  # list[Bucket] with a leading shard axis
    rows_per_shard: int
    chunk_elems: int
    nnz: int

    def to(self, device):
        """The stacked buckets as tensors on ``device``."""
        return buckets_to(self.buckets, device)


def shard_layout(row_part, row_counts, min_width=8, chunk_elems=1 << 19,
                 width_growth=2.0):
    """The stacked-bucket layout ``[(width, padded_nb)]`` from the
    per-entity rating counts alone: per-shard chunk padding, then the
    cross-shard max, then re-padding to the common chunk."""
    counts = np.asarray(row_counts)
    D = row_part.n_shards
    rated = counts > 0
    w_all = entity_widths(counts, min_width, width_growth)
    layout = []
    for w in sorted(set(w_all[rated].tolist())):
        sel = rated & (w_all == w)
        nb_d = np.bincount(row_part.owner[sel], minlength=D)
        nb_max = max(padded_bucket_rows(int(nb), w, chunk_elems)
                     for nb in nb_d if nb)
        layout.append((w, padded_bucket_rows(nb_max, w, chunk_elems)))
    return layout


def shard_csr(row_part, col_part, row_idx, col_idx, vals, min_width=8,
              chunk_elems=1 << 19):
    """Per-shard CSR buckets in slot space, stacked.  ``row_part`` /
    ``col_part``: the Partition of the solved side / the gathered side."""
    row_idx = np.asarray(row_idx)
    owner = row_part.owner[row_idx]
    local_rows = row_part.local[row_idx]
    slot_cols = col_part.slot[np.asarray(col_idx)]
    if len(row_idx):
        row_counts = np.bincount(row_idx, minlength=len(row_part.owner))
    else:
        row_counts = np.zeros(len(row_part.owner), np.int64)
    layout = shard_layout(row_part, row_counts, min_width, chunk_elems)
    shards = []
    for d in range(row_part.n_shards):
        sel = owner == d
        shards.append(build_csr_buckets(
            local_rows[sel], slot_cols[sel], np.asarray(vals)[sel],
            num_rows=row_part.rows_per_shard, min_width=min_width,
            chunk_elems=chunk_elems))
    return stack_shards(shards, chunk_elems, layout=layout)


def stack_shards(shards, chunk_elems, layout=None):
    """Unify bucket shapes across shards and stack them on a leading axis.
    ``layout``: ``[(width, padded_nb)]`` (default: derived from the shards
    with the same arithmetic); a built width missing from it raises rather
    than silently dropping ratings."""
    num_rows = shards[0].num_rows
    built_widths = sorted({b.width for s in shards for b in s.buckets})
    if layout is None:
        layout = []
        for w in built_widths:
            nb_max = max(b.rows.shape[0] for s in shards for b in s.buckets
                         if b.width == w)
            layout.append((w, padded_bucket_rows(nb_max, w, chunk_elems)))
    missing = set(built_widths) - {w for w, _ in layout}
    if missing:
        raise ValueError(
            f"built buckets of widths {sorted(missing)} have no layout "
            "entry — row_counts disagree with the rating triples; refusing "
            "to silently drop ratings")
    D = len(shards)
    stacked = []
    for w, nb_max in layout:
        rows = np.full((D, nb_max), num_rows, dtype=np.int32)
        cols = np.zeros((D, nb_max, w), dtype=np.int32)
        vals = np.zeros((D, nb_max, w), dtype=np.float32)
        mask = np.zeros((D, nb_max, w), dtype=np.float32)
        for d, s in enumerate(shards):
            match = [b for b in s.buckets if b.width == w]
            if not match:
                continue
            b = match[0]
            nb = b.rows.shape[0]
            rows[d, :nb] = b.rows
            cols[d, :nb] = b.cols
            vals[d, :nb] = b.vals
            mask[d, :nb] = b.mask
        stacked.append(Bucket(rows=rows, cols=cols, vals=vals, mask=mask))
    return ShardedCsr(buckets=stacked, rows_per_shard=num_rows,
                      chunk_elems=chunk_elems,
                      nnz=sum(s.nnz for s in shards))
