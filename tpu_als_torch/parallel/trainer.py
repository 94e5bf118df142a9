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
- ``'all_gather_chunked'``: the opposite table in column blocks per row
  tile, the normal equations summed block by block, then ``solve_spd``
  (K2 up to rank 128, K6 above) (:func:`.comm.chunked_gather_half_step`);
- ``'ring'`` / ``'ring_overlap'``: the grid of :mod:`.comm`, unfused
  (torch normal equations + ``solve_spd``) or, with
  ``solve_backend='gather_fused_ring'``, kernel K7.  ``'ring_overlap'``
  has the ring's numerics; it exists to put the rotation's collective
  under the compute, and on one device there is no collective to
  overlap, so it is ``'ring'`` by another name;
- ``'all_to_all'``: each owner receives only the rows its ratings
  reference, then ``local_half_step`` (:mod:`.a2a`).

For implicit feedback YᵀY is the whole opposite table's: the shards'
partial Grams summed shard after shard in mesh-position order, the
reference's ``psum`` (:func:`_yty`).

Across processes (:mod:`tpu_als_torch.parallel.multihost`) the steps run
on this process's slot rows only (``[L·per, r]`` a table) over the
``positions=`` builds, with the multihost transport between processes,
moving what the reference's steps move (``parallel/comm_audit.py``
holds the two to ``comm_bytes_per_iter``): 'all_gather' gathers the
opposite table once a half-step (the result is the one-process fit's,
bit for bit), 'all_gather_chunked' each column block once
per row tile, the unfused ring rotates the opposite shards between
processes, back home once per row tile
(:func:`.comm.ring_process_half_step`), 'all_to_all' exchanges the
referenced rows, and every strategy sums the shards' partial YᵀY.  K7
(``solve_backend='gather_fused_ring'``) reads every shard's base pointer
in one launch: across the processes of one card, its own shards' and
its peers' through buffers each process maps from the others (CUDA
IPC, :mod:`.peer`), one barrier a half-step
(:func:`_fused_process_ring_step`).

``elastic=True`` wraps the step in the device-loss detector (:mod:`tpu_als_torch.resilience.elastic`);
an armed ``comm.ring_step`` fault point wraps the ring step in
:func:`_chaos_wrap_step`.  ``'auto'`` is resolved upstream
(``plan.resolve_gather_strategy``); ``train_sharded`` refuses it, as the
reference's does.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_als_torch.convert import slot_rows
from tpu_als_torch.core import als as core_als
from tpu_als_torch.core.als import AlsConfig, init_factors, local_half_step
from tpu_als_torch.core.ratings import Bucket, trainer_chunk
from tpu_als_torch.ops.solve import compute_yty
from tpu_als_torch.parallel import multihost
from tpu_als_torch.parallel.a2a import a2a_half_step
from tpu_als_torch.parallel.comm import (
    ProcessSources,
    chunked_gather_half_step,
    ring_half_step,
    ring_process_fused_half_step,
    ring_process_half_step,
    roll_sources,
)
from tpu_als_torch.perf.roofline import (ring_r_pad, ring_remote_bytes,
                                         ring_row_tile)
from tpu_als_torch.resilience import faults
from tpu_als_torch.resilience.elastic import DeviceLost, wrap_step

#: The gather-strategy table (the reference's names and meanings).
GATHER_STRATEGIES = {
    "auto": "the execution planner's comm-model pick "
            "(plan.resolve_gather_strategy; resolved before the fit)",
    "all_gather": "full opposite-factor gather per half-step "
                  "(the default; on one device, the stacked table)",
    "all_gather_chunked": "column-block gathers per row tile; the full "
                          "opposite table never enters a row tile's "
                          "normal equations at once",
    "ring": "shards stream past stationary accumulators; with "
            "solve_backend='gather_fused_ring', kernel K7",
    "ring_overlap": "the ring with the rotation under the compute; on one "
                    "device, the ring",
    "all_to_all": "ragged exchange of only the referenced rows (needs the "
                  "built A2aCsr request plans)",
}

#: The strategy names train_sharded runs ('auto' resolves to one of
#: these upstream).
EXECUTABLE_STRATEGIES = tuple(k for k in GATHER_STRATEGIES if k != "auto")


def strategy_help(include_auto=True):
    """One-line rendering of :data:`GATHER_STRATEGIES` for help and error
    messages."""
    keys = GATHER_STRATEGIES if include_auto else EXECUTABLE_STRATEGIES
    return "; ".join(f"{k} = {GATHER_STRATEGIES[k]}" for k in keys)


def check_strategy(strategy):
    """Raise ``ValueError`` for a name outside the table."""
    if strategy not in GATHER_STRATEGIES:
        raise ValueError(f"unknown gather strategy {strategy!r} (expected "
                         f"one of {tuple(GATHER_STRATEGIES)}; "
                         f"{strategy_help()})")


class FactorsCorrupt(RuntimeError):
    """Non-finite factors after a ring step: the sharded counterpart of a
    torn message.  ALS cannot iterate out of it (NaN is a fixed point of
    the solve), so the loop stops and resumes from the last
    checkpoint."""


def _chaos_wrap_step(step):
    """The host-level ``comm.ring_step`` fault wrapper, installed only
    when the point is armed: raise mode fails before the step (a failed
    collective), corrupt mode poisons U with NaN after it, and the
    finiteness check (a host read, paid only here) turns that into
    :class:`FactorsCorrupt`."""

    def chaos_step(U, V, *args):
        mode = faults.check("comm.ring_step")
        U, V = step(U, V, *args)
        if mode == "corrupt":
            U = U * float("nan")
        if not bool(torch.isfinite(U.sum()) & torch.isfinite(V.sum())):
            raise FactorsCorrupt(
                "non-finite factors after ring step — resume from the "
                "last checkpoint")
        return U, V

    return chaos_step


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


def _across(mesh):
    return mesh.process_count > 1


def _gather(mesh, Y):
    """The whole stacked opposite table: ``Y`` itself in one process, the
    processes' rows gathered across several."""
    return multihost.all_gather(Y) if _across(mesh) else Y


def _yty(mesh, Y):
    """YᵀY of the whole opposite table from this process's rows ``Y``
    (``[L·per, r]``; one process: the whole stacked table): every
    shard's partial Gram, summed shard after shard in mesh-position
    order (:func:`~tpu_als_torch.parallel.multihost.all_reduce_sum`, the
    reference's ``psum``), so one process and several get the same
    bits."""
    parts = torch.stack([compute_yty(y)
                         for y in Y.reshape(mesh.size, -1, Y.shape[-1])])
    return multihost.all_reduce_sum(parts)


def make_sharded_step(mesh, user_sharded, item_sharded, cfg: AlsConfig,
                      knobs=None):
    """``step(U, V) -> (U, V)`` on slot-space tables, strategy
    ``'all_gather'``: each owner's rows solved by ``local_half_step``
    (with the fit's ``knobs``) against the whole stacked opposite
    table (across processes: this process's rows, the opposite table
    gathered once a half-step)."""
    _check_shards(mesh, user_sharded, item_sharded)
    dev = mesh.device
    ub, ib = user_sharded.to(dev), item_sharded.to(dev)

    def half(Y, buckets, per, chunk, prev):
        YtY = _yty(mesh, Y) if cfg.implicit_prefs else None
        Y = _gather(mesh, Y)
        return torch.cat([
            local_half_step(Y, _owner(buckets, d), per, cfg, YtY, chunk,
                            prev=prev[d * per:(d + 1) * per], knobs=knobs)
            for d in range(mesh.size)])

    def step(U, V):
        V = half(U, ib, item_sharded.rows_per_shard,
                 item_sharded.chunk_elems, V)
        U = half(V, ub, user_sharded.rows_per_shard,
                 user_sharded.chunk_elems, U)
        return U, V

    return step


def make_ring_step(mesh, user_ring, item_ring, cfg: AlsConfig, ring_counts,
                   knobs=None):
    """``step(U, V) -> (U, V)`` with the ring strategy over the grids
    ``user_ring``/``item_ring`` (:class:`.comm.RingCsr`), kernel K7 when
    ``solve_backend='gather_fused_ring'`` (and not nonnegative), split at
    the ``knobs``' split width.  ``ring_counts``: ``(user_counts,
    item_counts)`` from :func:`stacked_counts`."""
    _check_shards(mesh, user_ring, item_ring)
    dev = mesh.device
    ub, ib = user_ring.to(dev), item_ring.to(dev)
    uc, ic = (torch.as_tensor(np.asarray(c), dtype=torch.float32).to(dev)
              for c in ring_counts)
    fused = cfg.solve_backend == "gather_fused_ring" and not cfg.nonnegative
    S = mesh.size
    split = (knobs or {}).get("split_width")
    if _across(mesh) and fused:
        return _fused_process_ring_step(mesh, ub, ib, user_ring, item_ring,
                                        cfg, split)
    if _across(mesh):
        def ring_step(U, V):
            YtY = _yty(mesh, U) if cfg.implicit_prefs else None
            V = ring_process_half_step(U, ib, ic, item_ring.rows_per_shard,
                                       cfg, item_ring.chunk_elems, YtY,
                                       prev=V)
            YtY = _yty(mesh, V) if cfg.implicit_prefs else None
            U = ring_process_half_step(V, ub, uc, user_ring.rows_per_shard,
                                       cfg, user_ring.chunk_elems, YtY,
                                       prev=U)
            return U, V

        if faults.armed("comm.ring_step"):
            return _chaos_wrap_step(ring_step)
        return ring_step

    def ring_step(U, V):
        YtY = _yty(mesh, U) if cfg.implicit_prefs else None
        V = ring_half_step(U, ib, ic, item_ring.rows_per_shard, S, cfg,
                           item_ring.chunk_elems, YtY, prev=V, fused=fused,
                           split_width=split)
        YtY = _yty(mesh, V) if cfg.implicit_prefs else None
        U = ring_half_step(V, ub, uc, user_ring.rows_per_shard, S, cfg,
                           user_ring.chunk_elems, YtY, prev=U, fused=fused,
                           split_width=split)
        return U, V

    if faults.armed("comm.ring_step"):
        return _chaos_wrap_step(ring_step)
    return ring_step


def _fused_process_ring_step(mesh, ub, ib, user_ring, item_ring, cfg,
                             split):
    """The fused ring (K7) across processes: this process's L owners over
    all S sources, the grid's source axis rolled to this process's first
    position once (:func:`.comm.roll_sources`), and one
    :class:`.comm.ProcessSources` per factor table, built here, once (on
    the card: the exported buffer each peer maps).  A half-step publishes
    the table it reads (this process's rows in, a stream sync and one
    barrier), then launches K7; the barrier also keeps a table from being
    overwritten while a peer still reads it.  YᵀY is the shards'
    partials summed in mesh-position order, as every strategy's.  The
    returned step's ``close()`` (collective) releases the buffers:
    ``multihost.train_multihost`` calls it when the loop ends."""
    first = mesh.positions[0]
    ub, ib = roll_sources(ub, first), roll_sources(ib, first)
    cdt = getattr(torch, cfg.compute_dtype)
    # item half-steps read U (the user side's shards), user half-steps V
    u_src = ProcessSources(mesh, user_ring.rows_per_shard, cfg.rank, cdt)
    v_src = ProcessSources(mesh, item_ring.rows_per_shard, cfg.rank, cdt)

    def ring_step(U, V):
        YtY = _yty(mesh, U) if cfg.implicit_prefs else None
        V = ring_process_fused_half_step(U, u_src, ib,
                                         item_ring.rows_per_shard, cfg, YtY,
                                         split_width=split)
        YtY = _yty(mesh, V) if cfg.implicit_prefs else None
        U = ring_process_fused_half_step(V, v_src, ub,
                                         user_ring.rows_per_shard, cfg, YtY,
                                         split_width=split)
        return U, V

    def close():
        u_src.close()
        v_src.close()

    step = _chaos_wrap_step(ring_step) if faults.armed("comm.ring_step") \
        else ring_step
    step.close = close
    return step


def make_chunked_gather_step(mesh, user_sharded, item_sharded,
                             cfg: AlsConfig, n_blocks=4):
    """``step(U, V) -> (U, V)`` with ``'all_gather_chunked'``: the opposite
    factors taken in ``n_blocks`` column blocks per row tile
    (:func:`.comm.chunked_gather_half_step`), over the same stacked CSR
    shards as ``'all_gather'``."""
    _check_shards(mesh, user_sharded, item_sharded)
    dev = mesh.device
    ub, ib = user_sharded.to(dev), item_sharded.to(dev)
    S = mesh.global_size

    across = _across(mesh)

    def step(U, V):
        YtY = _yty(mesh, U) if cfg.implicit_prefs else None
        V = chunked_gather_half_step(
            U, ib, item_sharded.rows_per_shard, S, cfg,
            item_sharded.chunk_elems, n_blocks=n_blocks, YtY=YtY, prev=V,
            across_processes=across)
        YtY = _yty(mesh, V) if cfg.implicit_prefs else None
        U = chunked_gather_half_step(
            V, ub, user_sharded.rows_per_shard, S, cfg,
            user_sharded.chunk_elems, n_blocks=n_blocks, YtY=YtY, prev=U,
            across_processes=across)
        return U, V

    return step


def make_a2a_step(mesh, user_a2a, item_a2a, cfg: AlsConfig, knobs=None):
    """``step(U, V) -> (U, V)`` with the ragged ``'all_to_all'`` exchange
    (:mod:`.a2a`): the item-side plan routes U rows to the item half-step,
    the user-side plan V rows to the user half-step (``knobs`` as
    ``local_half_step``'s)."""
    for side, plan in (("user", user_a2a), ("item", item_a2a)):
        if not plan.buckets:
            raise ValueError(
                f"the {side} all_to_all plan is a stub (degenerate, built "
                "with on_degenerate='stub'): it holds no shards to train "
                "on; fall back to 'all_gather'")
    _check_shards(mesh, user_a2a, item_a2a)
    dev = mesh.device
    ub, us = user_a2a.to(dev)
    ib, is_ = item_a2a.to(dev)
    S = mesh.global_size
    across = _across(mesh)

    def step(U, V):
        YtY = _yty(mesh, U) if cfg.implicit_prefs else None
        V = a2a_half_step(U, is_, ib, item_a2a.rows_per_shard, S, cfg,
                          item_a2a.chunk_elems, YtY, prev=V, knobs=knobs,
                          across_processes=across)
        YtY = _yty(mesh, V) if cfg.implicit_prefs else None
        U = a2a_half_step(V, us, ub, user_a2a.rows_per_shard, S, cfg,
                          user_a2a.chunk_elems, YtY, prev=U, knobs=knobs,
                          across_processes=across)
        return U, V

    return step


def make_process_step(mesh, strategy, user_c, item_c, cfg: AlsConfig,
                      ring_counts=None, knobs=None, gather_blocks=4):
    """The step of ``strategy`` (a row of :data:`EXECUTABLE_STRATEGIES`)
    over this process's containers: the whole mesh's in one process, the
    ``positions=`` builds across processes, where ``step(U, V)`` takes
    and returns this process's slot rows.  The ring family needs
    ``ring_counts`` (this process's rows of :func:`stacked_counts`).
    The fused ring's step across processes holds buffers that its
    ``close()`` releases."""
    if strategy in ("ring", "ring_overlap"):
        if ring_counts is None:
            raise ValueError(f"strategy={strategy!r} requires ring_counts="
                             "(user_counts, item_counts) from "
                             "stacked_counts")
        return make_ring_step(mesh, user_c, item_c, cfg, ring_counts, knobs)
    if strategy == "all_to_all":
        return make_a2a_step(mesh, user_c, item_c, cfg, knobs)
    if strategy == "all_gather_chunked":
        return make_chunked_gather_step(mesh, user_c, item_c, cfg,
                                        n_blocks=gather_blocks)
    return make_sharded_step(mesh, user_c, item_c, cfg, knobs)


def comm_bytes_per_iter(strategy, user_part, item_part, rank,
                        user_container=None, item_container=None,
                        implicit=False, compute_dtype="float32",
                        panel=16):
    """Per-device collective traffic of ONE full ALS iteration in bytes,
    the reference's model (its integers, strategy by strategy), f32
    factors, per half-step the solved side receiving the opposite rows:

    - ``all_gather``: ``(D−1)·rows_per_shard·r·4``;
    - ``ring`` / ``ring_overlap``: ``D·rows_per_shard·r·4`` per row tile
      (read from the built containers, else 1);
    - ``all_gather_chunked``: one full gather per row tile;
    - ``all_to_all``: ``2·(D−1)·R·r·4`` (received and sent), R from the
      built ``A2aCsr`` plans;
    - ``gather_fused_ring``: the fused ring kernel's remote copies
      (``perf/roofline.py``'s :func:`ring_remote_bytes` over
      :func:`ring_row_tile`'s tiles, the rank padded to 128, in the
      compute dtype);
    - implicit adds one YᵀY reduction per half-step,
      ``2·(D−1)/D·r²·4`` each.

    On one card nothing crosses a link: this is the traffic the strategy
    would move across cards, reported as the reference reports it."""
    D = user_part.n_shards
    fb = 4 * rank
    _db = torch.empty((), dtype=getattr(torch, compute_dtype)).element_size()

    def tiles(container):
        if container is None or not getattr(container, "buckets", None):
            return 1
        n = 0
        for b in container.buckets:
            S, nb, w = b.cols.shape[-3:]
            chunk = trainer_chunk(nb, w, rank, container.chunk_elems)
            n += nb // chunk
        return max(1, n)

    def _ring_tiles(container, r):
        if container is None or not getattr(container, "buckets", None):
            return 1
        n = 0
        for b in container.buckets:
            S, nb, w = b.cols.shape[-3:]
            tn = ring_row_tile(ring_r_pad(r), -(-w // 8) * 8, panel=panel)
            n += -(-nb // tn)
        return max(1, n)

    if strategy == "all_gather":
        half_u = (D - 1) * item_part.rows_per_shard * fb
        half_v = (D - 1) * user_part.rows_per_shard * fb
    elif strategy in ("ring", "ring_overlap"):
        half_u = D * item_part.rows_per_shard * fb * tiles(user_container)
        half_v = D * user_part.rows_per_shard * fb * tiles(item_container)
    elif strategy == "all_gather_chunked":
        half_u = ((D - 1) * item_part.rows_per_shard * fb
                  * tiles(user_container))
        half_v = ((D - 1) * user_part.rows_per_shard * fb
                  * tiles(item_container))
    elif strategy == "all_to_all":
        if user_container is None or item_container is None:
            raise ValueError("all_to_all traffic needs the built A2aCsr "
                             "plans (request budgets R)")
        half_u = 2 * (D - 1) * user_container.request_budget * fb
        half_v = 2 * (D - 1) * item_container.request_budget * fb
    elif strategy == "gather_fused_ring":
        half_u = ring_remote_bytes(
            _ring_tiles(user_container, rank), D,
            item_part.rows_per_shard, ring_r_pad(rank), _db)
        half_v = ring_remote_bytes(
            _ring_tiles(item_container, rank), D,
            user_part.rows_per_shard, ring_r_pad(rank), _db)
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    total = half_u + half_v
    if implicit:
        total += 2 * 2 * (D - 1) * rank * rank * 4 // D
    return int(total)


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
                  ring_counts=None, init=None, start_iter=0,
                  gather_blocks=4, elastic=False):
    """Sharded ALS training loop.  Returns the slot-space ``(U, V)`` on the
    mesh's device; index them with ``Partition.slot`` for entity rows.

    ``strategy``: a row of :data:`EXECUTABLE_STRATEGIES` ('auto' is
    resolved upstream and raises here, as in the reference).  The gather
    strategies take :class:`.data.ShardedCsr` containers
    (``'all_gather_chunked'`` reads ``gather_blocks``), the ring family
    :class:`.comm.RingCsr` grids plus ``ring_counts=(user, item)`` from
    :func:`stacked_counts`, and ``'all_to_all'`` :class:`.a2a.A2aCsr`
    plans from ``build_a2a``.  ``init``: an entity-space ``(U0, V0)``
    warm start, scattered into slot space; without it the rows are
    ``init_factors`` drawn from ``cfg.seed`` as the single-device
    ``train`` draws them (users first), so both start from the same
    factors.  Runs iterations ``start_iter + 1 .. cfg.max_iter``;
    ``callback(iteration, U, V)`` gets the slot-space tables.
    ``elastic=True`` wraps the step in ``resilience.elastic.wrap_step``:
    a failed step is probed into a transient retry or a
    :class:`~tpu_als_torch.resilience.elastic.DeviceLost` stamped with
    the failing iteration, which ``api.fitting.fit_sharded`` turns into a
    re-formed mesh.  Before the first iteration the fit takes its tuned
    kernel knobs and resolves its training plan once each, as
    ``core.als.train`` does."""
    if strategy not in EXECUTABLE_STRATEGIES:
        raise ValueError(f"unknown gather strategy {strategy!r} for "
                         f"train_sharded (expected one of "
                         f"{EXECUTABLE_STRATEGIES}; 'auto' is resolved "
                         "before the fit by plan.resolve_gather_strategy; "
                         f"{strategy_help(include_auto=False)})")
    if _across(mesh):
        raise ValueError("train_sharded runs one process's mesh; a mesh "
                         "across processes trains through "
                         "parallel.multihost.train_multihost")
    dev = mesh.device
    if init is None:
        g = torch.Generator().manual_seed(int(cfg.seed))
        init = (init_factors(len(user_part.owner), cfg.rank, g),
                init_factors(len(item_part.owner), cfg.rank, g))
    # padding slots start at 0; a row with no rating solves to 0
    U, V = (slot_rows(part, torch.as_tensor(x).float().to(dev))
            for part, x in ((user_part, init[0]), (item_part, init[1])))
    if strategy in ("ring", "ring_overlap") and ring_counts is None:
        raise ValueError(f"strategy={strategy!r} requires ring_counts="
                         "(user_counts, item_counts) from stacked_counts")

    def make_step(knobs):
        return make_process_step(mesh, strategy, user_sharded, item_sharded,
                                 cfg, ring_counts=ring_counts, knobs=knobs,
                                 gather_blocks=gather_blocks)

    knobs = None
    # the chunked gather's half-steps run no K3 or K4: no knob reaches them
    if strategy != "all_gather_chunked" and core_als.autotune_gate():
        def prepare(kn):
            step = make_step(kn)
            return lambda: step(U, V)

        knobs = core_als.tuned_kernel_knobs(
            cfg, dev, prepare, (user_sharded, item_sharded),
            len(user_part.owner), len(item_part.owner),
            mesh_shape=(mesh.size,))
    core_als.plan_training(
        cfg, cfg.rank, None if knobs is None else knobs["split_width"], dev)
    step = make_step(knobs)
    if elastic:
        step = wrap_step(step, mesh)
    for it in range(start_iter, cfg.max_iter):
        try:
            U, V = step(U, V)
        except DeviceLost as e:
            if e.iteration is None:
                e.iteration = it + 1  # stamp the failing iteration
            raise
        if callback is not None:
            callback(it + 1, U, V)
    return U, V
