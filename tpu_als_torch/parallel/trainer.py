"""Sharded ALS training over a mesh of shards.

Counterpart of ``tpu_als/parallel/trainer.py``.  Factors live in slot
space (:mod:`tpu_als_torch.parallel.data`): entity e's row is row
``slot[e]`` of a stacked ``[S·rows_per_shard, r]`` table on the mesh's
device, shard s being rows ``s·per .. (s+1)·per``.  Each iteration is an
item half-step against the users, then a user half-step against the new
items, with a strategy for how each owner reaches the opposite factors:

- ``'all_gather'``: the reference gathers the opposite table onto every
  device; on one device the stacked table IS the gathered table, and
  each owner's rows go through the single-device ``local_half_step``
  (kernels K4, K3 + K1/K6);
- ``'ring'`` / ``'ring_overlap'``: the grid of :mod:`.comm`, unfused
  (torch normal equations + ``solve_spd``) or, with
  ``solve_backend='gather_fused_ring'``, kernel K7.  ``'ring_overlap'``
  has the ring's numerics; it exists to put the rotation's collective
  under the compute, and on one device there is no collective to
  overlap, so it is ``'ring'`` by another name.

For implicit feedback YᵀY is the whole opposite table's (the reference
``psum``s the shards' partial Grams).  ``'all_gather_chunked'``,
``'all_to_all'`` and ``elastic=True`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_als_torch.convert import slot_rows
from tpu_als_torch.core.als import AlsConfig, init_factors, local_half_step
from tpu_als_torch.core.ratings import Bucket
from tpu_als_torch.ops.solve import compute_yty
from tpu_als_torch.parallel.comm import ring_half_step

#: The gather-strategy table (the reference's names and meanings).
GATHER_STRATEGIES = {
    "auto": "the execution planner's comm-model pick (not ported: the "
            "planner comes with the ops-infrastructure slice)",
    "all_gather": "full opposite-factor gather per half-step "
                  "(the default; on one device, the stacked table)",
    "all_gather_chunked": "column-block gathers per row tile (not ported: "
                          "comes with the multi-card transport slice)",
    "ring": "shards stream past stationary accumulators; with "
            "solve_backend='gather_fused_ring', kernel K7",
    "ring_overlap": "the ring with the rotation under the compute; on one "
                    "device, the ring",
    "all_to_all": "ragged exchange of only the referenced rows (not "
                  "ported: comes with the multi-card transport slice)",
}

#: The names train_sharded runs here; the others raise, naming the slice
#: of the port they come with.
EXECUTABLE_STRATEGIES = ("all_gather", "ring", "ring_overlap")

_LATER = {
    "all_gather_chunked": "the multi-card transport slice",
    "all_to_all": "the multi-card transport slice",
    "auto": "the ops-infrastructure (planner) slice",
}


def strategy_help():
    """One-line rendering of :data:`GATHER_STRATEGIES` for help and error
    messages."""
    return "; ".join(f"{k} = {v}" for k, v in GATHER_STRATEGIES.items())


def check_strategy(strategy):
    """Raise for a name outside the table (ValueError) or one not ported
    yet (NotImplementedError)."""
    if strategy not in GATHER_STRATEGIES:
        raise ValueError(f"unknown gather strategy {strategy!r} (expected "
                         f"one of {tuple(GATHER_STRATEGIES)}; "
                         f"{strategy_help()})")
    if strategy not in EXECUTABLE_STRATEGIES:
        raise NotImplementedError(
            f"gather strategy {strategy!r} is not ported yet: it comes with "
            f"{_LATER[strategy]}")


def _check_shards(mesh, *containers):
    for c in containers:
        if c.buckets and c.buckets[0].rows.shape[0] != mesh.size:
            raise ValueError(
                f"the mesh has {mesh.size} shards but the rating shards were "
                f"built for {c.buckets[0].rows.shape[0]}; a mismatch would "
                "silently drop shards")


def _owner(buckets, d):
    return [Bucket(rows=b.rows[d], cols=b.cols[d], vals=b.vals[d],
                   mask=b.mask[d]) for b in buckets]


def make_sharded_step(mesh, user_sharded, item_sharded, cfg: AlsConfig):
    """``step(U, V) -> (U, V)`` on slot-space tables, strategy
    ``'all_gather'``: each owner's rows solved by ``local_half_step``
    against the whole stacked opposite table."""
    _check_shards(mesh, user_sharded, item_sharded)
    dev = mesh.device
    ub, ib = user_sharded.to(dev), item_sharded.to(dev)

    def half(Y, buckets, per, chunk, prev):
        YtY = compute_yty(Y) if cfg.implicit_prefs else None
        return torch.cat([
            local_half_step(Y, _owner(buckets, d), per, cfg, YtY, chunk,
                            prev=prev[d * per:(d + 1) * per])
            for d in range(mesh.size)])

    def step(U, V):
        V = half(U, ib, item_sharded.rows_per_shard,
                 item_sharded.chunk_elems, V)
        U = half(V, ub, user_sharded.rows_per_shard,
                 user_sharded.chunk_elems, U)
        return U, V

    return step


def make_ring_step(mesh, user_ring, item_ring, cfg: AlsConfig, ring_counts):
    """``step(U, V) -> (U, V)`` with the ring strategy over the grids
    ``user_ring``/``item_ring`` (:class:`.comm.RingCsr`), kernel K7 when
    ``solve_backend='gather_fused_ring'`` (and not nonnegative).
    ``ring_counts``: ``(user_counts, item_counts)`` from
    :func:`stacked_counts`."""
    _check_shards(mesh, user_ring, item_ring)
    dev = mesh.device
    ub, ib = user_ring.to(dev), item_ring.to(dev)
    uc, ic = (torch.as_tensor(np.asarray(c), dtype=torch.float32).to(dev)
              for c in ring_counts)
    fused = cfg.solve_backend == "gather_fused_ring" and not cfg.nonnegative
    S = mesh.size

    def step(U, V):
        YtY = compute_yty(U) if cfg.implicit_prefs else None
        V = ring_half_step(U, ib, ic, item_ring.rows_per_shard, S, cfg,
                           item_ring.chunk_elems, YtY, prev=V, fused=fused)
        YtY = compute_yty(V) if cfg.implicit_prefs else None
        U = ring_half_step(V, ub, uc, user_ring.rows_per_shard, S, cfg,
                           user_ring.chunk_elems, YtY, prev=U, fused=fused)
        return U, V

    return step


def stacked_counts(part, row_idx, vals=None, positive_only=False):
    """Per-row rating counts in [D, rows_per_shard] layout (the ring's λ·n
    ridge; ``positive_only``: implicit feedback's positive ratings)."""
    if positive_only and vals is None:
        raise ValueError("vals is required when positive_only=True")
    rows = np.asarray(row_idx)
    if positive_only:
        rows = rows[np.asarray(vals) > 0]
    out = np.zeros((part.n_shards, part.rows_per_shard), dtype=np.float32)
    np.add.at(out, (part.owner[rows], part.local[rows]), 1.0)
    return out


def train_sharded(mesh, user_part, item_part, user_sharded, item_sharded,
                  cfg: AlsConfig, callback=None, strategy="all_gather",
                  ring_counts=None, init=None, start_iter=0, elastic=False):
    """Sharded ALS training loop.  Returns the slot-space ``(U, V)`` on the
    mesh's device; index them with ``Partition.slot`` for entity rows.

    ``strategy``: a row of :data:`GATHER_STRATEGIES`; the gather family
    takes :class:`.data.ShardedCsr` containers, the ring family
    :class:`.comm.RingCsr` grids plus ``ring_counts=(user, item)`` from
    :func:`stacked_counts`.  ``init``: an entity-space ``(U0, V0)`` warm
    start, scattered into slot space; without it the rows are
    ``init_factors`` drawn from ``cfg.seed`` as the single-device
    ``train`` draws them (users first), so both start from the same
    factors.  Runs iterations ``start_iter + 1 .. cfg.max_iter``;
    ``callback(iteration, U, V)`` gets the slot-space tables."""
    check_strategy(strategy)
    if elastic:
        raise NotImplementedError(
            "elastic=True (device loss as a rescheduling event) comes with "
            "the resilience slice of the port")
    dev = mesh.device
    if init is None:
        g = torch.Generator().manual_seed(int(cfg.seed))
        init = (init_factors(len(user_part.owner), cfg.rank, g),
                init_factors(len(item_part.owner), cfg.rank, g))
    # padding slots start at 0; a row with no rating solves to 0
    U, V = (slot_rows(part, torch.as_tensor(x).float().to(dev))
            for part, x in ((user_part, init[0]), (item_part, init[1])))
    if strategy in ("ring", "ring_overlap"):
        if ring_counts is None:
            raise ValueError(f"strategy={strategy!r} requires ring_counts="
                             "(user_counts, item_counts) from "
                             "stacked_counts")
        step = make_ring_step(mesh, user_sharded, item_sharded, cfg,
                              ring_counts)
    else:
        step = make_sharded_step(mesh, user_sharded, item_sharded, cfg)
    for it in range(start_iter, cfg.max_iter):
        U, V = step(U, V)
        if callback is not None:
            callback(it + 1, U, V)
    return U, V
