"""Streaming micro-batch server: serve fold-in updates without a refit.

Counterpart of ``tpu_als/stream/microbatch.py::FoldInServer``.  The server
wraps an :class:`~tpu_als_torch.api.estimator.ALSModel` and runs on its
device; each ``update`` call

1. groups the batch's ratings per entity and merges each entity's kept
   rating history (optional),
2. packs the touched rows into padded ``[n, w]`` arrays,
3. folds them in against the fixed opposite factor table,
4. writes the new rows into the model, appending brand-new entities.

``update_items`` is the symmetric direction (new or updated items against
the fixed user factors); it refreshes the cached item table and YᵀY that
user fold-ins read.  The reference padded rows and widths to powers of
two only to bound JAX's compile cache; PyTorch runs eagerly, so batches
are packed at their own size (padding rows solve to 0 and padding slots
are masked, so results are the same).
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from tpu_als_torch import obs
from tpu_als_torch.core.foldin import fold_in
from tpu_als_torch.core.ratings import IdMap, _next_pow2
from tpu_als_torch.ops.solve import compute_yty
from tpu_als_torch.utils.frame import as_frame


def pack_rows(solved_raw, fixed_dense, ratings, history=None):
    """Group ratings per solved entity into padded rows.

    Returns ``(touched, cols [n, w] int64, vals [n, w] f32, mask [n, w]
    f32)`` as numpy arrays, ``touched`` sorted.  Within a row, ratings
    keep the order of the batch, after the entity's ``history`` (a dict
    original id -> (fixed_dense[], ratings[])) when one is given; the
    history is updated in place.
    """
    order = np.argsort(solved_raw, kind="stable")
    touched, starts = np.unique(solved_raw[order], return_index=True)
    per_f = np.split(fixed_dense[order], starts[1:])
    per_v = np.split(ratings[order], starts[1:])
    if history is not None:
        for j, e in enumerate(touched.tolist()):
            hist = history.get(e)
            if hist is not None:
                per_f[j] = np.concatenate([hist[0], per_f[j]])
                per_v[j] = np.concatenate([hist[1], per_v[j]])
            history[e] = (per_f[j], per_v[j])
    lens = np.array([len(f) for f in per_f], dtype=np.int64)
    n, w = len(touched), int(lens.max())
    rows = np.repeat(np.arange(n), lens)
    pos = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens,
                                                 lens)
    cols = np.zeros((n, w), dtype=np.int64)
    vals = np.zeros((n, w), dtype=np.float32)
    mask = np.zeros((n, w), dtype=np.float32)
    cols[rows, pos] = np.concatenate(per_f)
    vals[rows, pos] = np.concatenate(per_v)
    mask[rows, pos] = 1.0
    return touched, cols, vals, mask


class FoldInServer:
    """Incremental factor updates against a fitted model, on its device."""

    def __init__(self, model, keep_history=True, stats_window=512):
        self.model = model
        self.keep_history = keep_history
        self._history = {}  # original user id -> (item_dense[], rating[])
        self._item_history = {}  # original item id -> (user_dense[], rating[])
        p = model._params
        self._reg = float(p.get("regParam", 0.1))
        self._implicit = bool(p.get("implicitPrefs", False))
        self._alpha = float(p.get("alpha", 1.0))
        self._nonnegative = bool(p.get("nonnegative", False))
        self._V = model._V
        self._YtY = compute_yty(self._V) if self._implicit else None
        # (batch_size, touched_entities, latency_seconds), bounded
        self.stats = collections.deque(maxlen=int(stats_window))

    @property
    def device(self):
        return self.model.device

    def prewarm(self, rows=(256,), widths=(8,), sides=("user",), growth=0):
        """Run one fold-in per (rows, width) shape and side on zeros, so the
        kernels are built and loaded before the first real batch.

        ``growth`` also runs them against the fixed table padded with zero
        rows to ``growth`` further doublings of its power-of-two size, as
        the reference does for a stream that appends entities (zero rows
        change neither the gathered rows nor ``FᵀF``).  The defaults of
        ``rows`` and ``widths`` are the port's own, smaller than the
        reference's grid: the port builds no program per shape, so one
        shape builds and loads every kernel the fold-in runs."""
        dev = self.device
        for side in sides:
            F0 = self._V if side == "user" else self.model._U
            for g in range(int(growth) + 1):
                n_pad = _next_pow2(F0.shape[0]) << g
                F = F0 if g == 0 else torch.cat(
                    [F0, F0.new_zeros((n_pad - F0.shape[0], F0.shape[1]))])
                YtY = compute_yty(F) if self._implicit else None
                for n in rows:
                    for w in widths:
                        fold_in(F, torch.zeros((n, w), dtype=torch.int64,
                                               device=dev),
                                torch.zeros((n, w), device=dev),
                                torch.zeros((n, w), device=dev),
                                self._reg, implicit_prefs=self._implicit,
                                alpha=self._alpha,
                                nonnegative=self._nonnegative, YtY=YtY)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def update(self, batch):
        """Fold one micro-batch frame (userCol/itemCol/ratingCol of the
        model) into the user factors.  Returns the original ids of the
        users whose factors moved."""
        return self._fold_batch(batch, items_side=False)

    def update_items(self, batch):
        """Fold a batch into the ITEM factors against the fixed user
        factors; users unknown to the model are ignored.  Refreshes the
        cached item table and YᵀY that user fold-ins read.  Returns the
        original ids of the items whose factors moved."""
        return self._fold_batch(batch, items_side=True)

    def _fold_batch(self, batch, items_side):
        """One mechanics path for both directions."""
        t0 = time.perf_counter()
        frame = as_frame(batch)
        m = self.model
        p = m._params
        if items_side:
            solved_raw = np.asarray(frame[p["itemCol"]])
            fixed_raw = np.asarray(frame[p["userCol"]])
            fixed_map, history = m._user_map, self._item_history
        else:
            solved_raw = np.asarray(frame[p["userCol"]])
            fixed_raw = np.asarray(frame[p["itemCol"]])
            fixed_map, history = m._item_map, self._history
        r = np.asarray(frame[p["ratingCol"]], dtype=np.float32)

        # fixed-side entities never seen in training have no factors to
        # regress on; they are ignored until a refit
        fixed_dense = fixed_map.to_dense(fixed_raw)
        known = fixed_dense >= 0
        solved_raw = solved_raw[known]
        fixed_dense, r = fixed_dense[known], r[known]
        if len(solved_raw) == 0:
            return np.array([], dtype=np.int64)

        touched, cols, vals, mask = pack_rows(
            solved_raw, fixed_dense, r,
            history if self.keep_history else None)
        dev = self.device
        if items_side:
            F = m._U  # user fold-ins may have grown it: read it live
            YtY = compute_yty(F) if self._implicit else None
        else:
            F, YtY = self._V, self._YtY
        x = fold_in(
            F, torch.from_numpy(cols).to(dev),
            torch.from_numpy(vals).to(dev), torch.from_numpy(mask).to(dev),
            self._reg, implicit_prefs=self._implicit, alpha=self._alpha,
            nonnegative=self._nonnegative, YtY=YtY)

        self._write_back(touched, x, items_side)
        if items_side:
            self._V = m._V
            if self._implicit:
                self._YtY = compute_yty(self._V)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # the update is visible: stop here
        dt = time.perf_counter() - t0
        side = "item" if items_side else "user"
        self.stats.append((len(solved_raw), len(touched), dt))
        obs.histogram("foldin.update_seconds", dt, side=side)
        obs.histogram("foldin.batch_rows", len(touched), side=side)
        obs.counter("foldin.ratings", len(solved_raw))
        return touched

    def _write_back(self, touched_raw_ids, new_rows, items_side=False):
        m = self.model
        map_attr = "_item_map" if items_side else "_user_map"
        fac_attr = "_V" if items_side else "_U"
        fac = getattr(m, fac_attr)
        emap = getattr(m, map_attr)
        dense = emap.to_dense(touched_raw_ids)
        new_mask = dense < 0
        if new_mask.any():  # brand-new entities: extend map and factors
            new_ids = touched_raw_ids[new_mask]
            emap = IdMap(ids=np.concatenate([emap.ids, new_ids]))
            setattr(m, map_attr, emap)
            fac = torch.cat([fac, fac.new_zeros((len(new_ids),
                                                 fac.shape[1]))])
            setattr(m, fac_attr, fac)
            dense = emap.to_dense(touched_raw_ids)
        # in place: a second copy of the table per batch buys nothing
        fac[torch.from_numpy(dense).to(fac.device)] = new_rows.to(fac.dtype)

    def latency(self, q=0.5, skip_warmup=False):
        """Latency quantile (seconds) over processed batches; ``skip_warmup``
        drops the first batch."""
        stats = list(self.stats)
        if skip_warmup:
            stats = stats[1:]
        lat = sorted(s[2] for s in stats)
        if not lat:
            return float("nan")
        return lat[min(len(lat) - 1, int(len(lat) * q))]

    def p50_latency(self):
        return self.latency(0.5)
