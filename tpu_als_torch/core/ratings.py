"""Ratings containers: id maps and degree-bucketed, padded CSR.

Counterpart of ``tpu_als/core/ratings.py`` (an own copy — the port
imports nothing of the JAX package): ``IdMap``/``remap_ids``, the rating
sanity bound, and the bucketed CSR layout training runs on.  Entity rows
are grouped by rating count into width buckets (next power of two,
floored at ``min_width``; ``width_growth=1.5`` adds the 0.75·2^k rungs),
each padded to its width, and each bucket's row count padded to its scan
chunk; padding rows carry ``rows == num_rows``.  The layout is built on
the host with numpy, bit-identical to the reference's numpy path (and so
to its C++ bucketizer, which is not ported), then moved to the device
once with :meth:`CsrBuckets.to`.  ``_next_pow2`` is not carried over,
since it only bounded JAX's compile cache.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

# |rating| above this is data corruption, not signal: past 1e6 the f32
# normal-equation sums (r² terms reach 1e12) are overwhelmed
RATING_ABS_MAX = 1e6


def invalid_rating_mask(r, max_abs=RATING_ABS_MAX):
    """Ratings to quarantine: non-finite or of magnitude above
    ``max_abs``."""
    r = np.asarray(r)
    return ~np.isfinite(r) | (np.abs(r) > max_abs)


class Bucket(NamedTuple):
    """One fixed-width padded CSR bucket (numpy on the host, tensors after
    :meth:`CsrBuckets.to`).

    rows [nb]      entity index per row; padding rows hold ``num_rows``
    cols [nb, w]   opposite-entity indices (0 in padding slots), int32
    vals [nb, w]   ratings (0 in padding slots)
    mask [nb, w]   1.0 real / 0.0 padding
    """

    rows: object
    cols: object
    vals: object
    mask: object

    @property
    def width(self):
        return self.cols.shape[-1]


@dataclass
class CsrBuckets:
    """All buckets of one side (users or items)."""

    buckets: list       # list[Bucket], ascending width
    num_rows: int       # entity count (valid scatter targets)
    counts: np.ndarray  # [num_rows] rating count per entity
    nnz: int
    chunk_elems: int    # scan-chunk budget the row padding was built for

    @property
    def padded_nnz(self):
        return sum(b.mask.size for b in self.buckets)

    def to(self, device):
        """The buckets as tensors on ``device`` (:func:`buckets_to`)."""
        return buckets_to(self.buckets, device)


def buckets_to(buckets, device):
    """Host buckets as tensors on ``device``: rows int64, cols int32, vals
    and mask as built."""
    return [Bucket(rows=torch.from_numpy(b.rows.astype(np.int64)).to(device),
                   cols=torch.from_numpy(b.cols).to(device),
                   vals=torch.from_numpy(b.vals).to(device),
                   mask=torch.from_numpy(b.mask).to(device))
            for b in buckets]


@dataclass
class IdMap:
    """Dense-index <-> original-id mapping, persisted with the model.
    ``ids[dense] == original``."""

    ids: np.ndarray  # [n] original ids, position = dense index

    def __post_init__(self):
        self._lookup = None

    def __len__(self):
        return len(self.ids)

    def to_dense(self, original, missing=-1):
        """Map original ids -> dense indices; unseen ids -> ``missing``."""
        original = np.asarray(original)
        if self._lookup is None:
            order = np.argsort(self.ids, kind="stable")
            self._lookup = (self.ids[order], order)
        sorted_ids, order = self._lookup
        if len(sorted_ids) == 0:
            return np.full(original.shape, missing, dtype=np.int64)
        pos = np.searchsorted(sorted_ids, original)
        pos = np.clip(pos, 0, len(sorted_ids) - 1)
        hit = sorted_ids[pos] == original
        return np.where(hit, order[pos], missing).astype(np.int64)

    def to_original(self, dense):
        return self.ids[np.asarray(dense)]


def remap_ids(raw):
    """Densify one id column.  Returns (dense_idx [n], IdMap)."""
    raw = np.asarray(raw)
    uniq, inv = np.unique(raw, return_inverse=True)
    return inv.astype(np.int64), IdMap(ids=uniq)



def entity_widths(counts, min_width, growth=2.0):
    """Bucket width per entity, floored at ``min_width``: the next power of
    two (growth 2.0), or with growth < 2 also the 0.75·2^k rungs that are
    multiples of 8."""
    counts = np.maximum(np.asarray(counts, dtype=np.int64), 1)
    w = np.maximum(
        min_width, 1 << np.ceil(np.log2(counts)).astype(np.int64)
    )
    if growth < 2.0:
        w34 = (3 * w) // 4
        ok = (w34 >= counts) & (w34 >= min_width) & (w34 % 8 == 0)
        w = np.where(ok, w34, w)
    return w


def scan_chunk(nb, width, chunk_elems):
    """Rows per scan step for a bucket of ``nb`` rows of ``width``: a power
    of two, at most ``chunk_elems // width``, at most ``nb`` rounded up,
    and at most ~nb/16 (floored at 64 rows) so pad-to-chunk costs little."""
    cap = max(1, chunk_elems // width)
    cap = 1 << (cap.bit_length() - 1)  # floor to power of two
    full = 1 << max(0, nb - 1).bit_length()  # ceil to power of two
    tgt = max(64, 1 << max(0, -(-nb // 16) - 1).bit_length())
    return max(1, min(cap, full, tgt))


def padded_bucket_rows(nb, width, chunk_elems):
    """Bucket row count padded to its scan chunk — the pairing every
    builder must use identically."""
    chunk = scan_chunk(nb, width, chunk_elems)
    return -(-nb // chunk) * chunk


def trainer_chunk(nb_padded, width, rank, chunk_elems, mem_elems=1 << 28,
                  fused_gather=False):
    """Trainer-side chunk: the builder chunk, halved until the largest
    per-chunk intermediate — max(Vg [chunk, w, r], A [chunk, r, r]), or A
    alone when the gather is fused — fits ``mem_elems`` elements; the gcd
    fallback covers buckets built with another ``chunk_elems``."""
    c = scan_chunk(nb_padded, width, chunk_elems)
    big = rank if fused_gather else max(width, rank)
    while c > 1 and c * rank * big > mem_elems:
        c //= 2
    if nb_padded % c:
        c = math.gcd(nb_padded, c)
    return c


def build_csr_buckets(row_idx, col_idx, vals, num_rows, min_width=8,
                      chunk_elems=1 << 19, dtype=np.float32,
                      width_growth=2.0):
    """Degree-bucketed padded CSR from COO triples (numpy).

    Duplicate (row, col) entries are kept (they contribute twice).  Within
    a row, entries keep their input order; rows per bucket are padded to a
    multiple of the bucket's scan chunk, padding rows carrying
    ``rows == num_rows``.
    """
    row_idx = np.asarray(row_idx, dtype=np.int64)
    col_idx = np.asarray(col_idx, dtype=np.int64)
    vals = np.asarray(vals, dtype=dtype)
    nnz = len(row_idx)
    counts = np.bincount(row_idx, minlength=num_rows).astype(np.int64)

    order = np.argsort(row_idx, kind="stable")
    s_rows = row_idx[order]
    s_cols = col_idx[order]
    s_vals = vals[order]

    uniq, starts, ucounts = np.unique(s_rows, return_index=True,
                                      return_counts=True)
    # per entry: rank of its row among the unique rows, offset in the row
    entry_rank = np.repeat(np.arange(len(uniq)), ucounts)
    entry_off = np.arange(nnz) - starts[entry_rank]

    widths = entity_widths(ucounts, min_width, width_growth)
    buckets = []
    for w in sorted(set(widths.tolist())):
        sel_rows = np.flatnonzero(widths == w)  # indices into uniq
        nb = len(sel_rows)
        nb_pad = padded_bucket_rows(nb, w, chunk_elems)
        rows = np.full(nb_pad, num_rows, dtype=np.int32)
        rows[:nb] = uniq[sel_rows]
        cols = np.zeros((nb_pad, w), dtype=np.int32)
        v = np.zeros((nb_pad, w), dtype=dtype)
        m = np.zeros((nb_pad, w), dtype=dtype)
        local = np.full(len(uniq), -1, dtype=np.int64)
        local[sel_rows] = np.arange(nb)
        emask = local[entry_rank] >= 0
        er = local[entry_rank[emask]]
        eo = entry_off[emask]
        cols[er, eo] = s_cols[emask]
        v[er, eo] = s_vals[emask]
        m[er, eo] = 1.0
        buckets.append(Bucket(rows=rows, cols=cols, vals=v, mask=m))

    return CsrBuckets(buckets=buckets, num_rows=num_rows, counts=counts,
                      nnz=nnz, chunk_elems=chunk_elems)
