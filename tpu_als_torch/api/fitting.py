"""The mesh fits behind ``ALS(mesh=...).fit``.

Counterpart of ``tpu_als/api/fitting.py``:

- :func:`fit_sharded` — one process: balanced entity partitions, the
  strategy's rating containers (stacked CSR shards, the ring's owner ×
  source grid with its per-row counts, or the all_to_all plans, with the
  reference's fallback from a degenerate plan to ``'all_gather'``), the
  traffic model, then :func:`tpu_als_torch.parallel.trainer.
  train_sharded`.  ``'auto'`` is resolved by
  ``plan.resolve_gather_strategy``.  With ``est.elastic`` a lost shard
  re-forms the mesh on the survivors and the fit resumes from the last
  checkpoint (:func:`_reform_and_resume`).
- :func:`check_multiprocess_gate` — the FIRST collective of every
  multi-process fit: the reference's 11 fields plus the port's kernel
  knobs (``split_width``, K4's ``scratch_elems``), so a divergence
  raises on every process instead of pairing mismatched collectives or
  training shards with different numerics.
- :func:`fit_multiprocess` — P processes × L logical shards
  (``parallel.multihost.train_multihost``), replicated or per-host data,
  sharded or replicated checkpoints, the collective preemption decision.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from tpu_als_torch import obs
from tpu_als_torch.convert import entity_rows
from tpu_als_torch.parallel import multihost
from tpu_als_torch.parallel.comm import gather_block_plan, shard_csr_grid
from tpu_als_torch.parallel.data import partition_balanced, shard_csr
from tpu_als_torch.parallel.trainer import (
    check_strategy,
    comm_bytes_per_iter,
    stacked_counts,
    train_sharded,
)
from tpu_als_torch.resilience import preempt
from tpu_als_torch.resilience.elastic import DeviceLost


def fit_sharded(est, u_idx, i_idx, r, user_map, item_map, cfg, init,
                start_iter, callback=None):
    """Fit over ``est.mesh`` with ``est.gatherStrategy``; ``callback``
    (iteration, U, V) gets entity-space factors.  Returns entity-space
    ``(U, V)`` on the mesh's device.

    With ``est.elastic`` a :class:`DeviceLost` from the step becomes a
    rescheduling event, at most S − 1 times: the mesh re-forms on the
    surviving shards and training re-enters from the last checkpoint in
    ``est.checkpointDir`` that matches this fit (else from the original
    init).  Each pass is deterministic given (mesh size, init,
    start_iter), so the recovered fit equals a fresh fit on the shrunk
    mesh resumed from the same checkpoint."""
    check_strategy(est.gatherStrategy)
    mesh = est.mesh
    reforms = 0
    max_reforms = mesh.size - 1  # a mesh cannot shrink below one shard
    while True:
        try:
            return _fit_sharded_once(est, mesh, u_idx, i_idx, r, user_map,
                                     item_map, cfg, init, start_iter,
                                     callback)
        except DeviceLost as e:
            if reforms >= max_reforms:
                raise
            reforms += 1
            mesh, init, start_iter = _reform_and_resume(
                est, mesh, e, cfg, user_map, item_map, init, start_iter)


def _reform_and_resume(est, mesh, exc, cfg, user_map, item_map, orig_init,
                       orig_start):
    """One elastic recovery: the ``device_lost`` record, the mesh rebuilt
    on the survivors (their logical ids kept), and the resume point (the
    last checkpoint that matches this fit's rank and id maps, else the
    original init: the quarantined epoch is re-run).  Returns ``(mesh,
    init, start_iter)`` for the next pass.  The trail ``device_lost`` →
    ``mesh_reformed`` → ``elastic_resume`` and the ``elastic.*`` trace
    spans are the recovery tree ``observe explain`` rebuilds."""
    from tpu_als_torch.io.checkpoint import discover_resume, load_factors
    from tpu_als_torch.obs import tracing
    from tpu_als_torch.parallel.mesh import make_mesh

    lost = sorted(set(exc.lost))
    old = list(mesh.shards)
    surviving = [s for s in old if int(s.id) not in set(lost)]
    if not surviving:
        raise exc
    obs.counter("train.reformations")
    obs.emit("device_lost", iteration=exc.iteration, lost=lost,
             surviving=len(surviving))
    ctx = tracing.start_trace("elastic.detect", iteration=exc.iteration,
                              lost=lost)
    if multihost.process_count() > 1:
        # the group re-forms before the shrunk mesh's first collective
        # (one process: nothing to re-form)
        multihost.rejoin()
    new_mesh = make_mesh(devices=[s.device for s in surviving],
                         ids=[s.id for s in surviving])
    obs.emit("mesh_reformed", old_devices=len(old),
             new_devices=len(surviving), lost=lost)
    ctx = tracing.record_span(ctx, "elastic.reform", old_devices=len(old),
                              new_devices=len(surviving))
    init, start_iter, source, path = orig_init, orig_start, "scratch", None
    if est.checkpointDir is not None:
        path = discover_resume(est.checkpointDir)
    if path is not None:
        manifest, c_uids, c_U, c_iids, c_V = load_factors(path)
        if (manifest.get("rank") == cfg.rank
                and np.array_equal(c_uids, user_map.ids)
                and np.array_equal(c_iids, item_map.ids)):
            init = (c_U, c_V)
            start_iter = int(manifest.get("iteration") or 0)
            source = "checkpoint"
        else:
            path = None  # a foreign checkpoint is not this fit's state
    extra = {"path": path} if source == "checkpoint" else {}
    obs.emit("elastic_resume", iteration=start_iter, source=source,
             devices=len(surviving), **extra)
    tracing.record_span(ctx, "elastic.resume", iteration=start_iter,
                        source=source)
    return new_mesh, init, start_iter


def _fit_sharded_once(est, mesh, u_idx, i_idx, r, user_map, item_map, cfg,
                      init, start_iter, callback):
    """One training pass over ``mesh``: partitions, the strategy's
    containers, the traffic model's bookkeeping, then ``train_sharded``.
    Returns entity-space ``(U, V)``."""
    D = mesh.size
    obs.update_manifest(mesh_shape=[D], mesh_devices=D)
    with obs.span("train.partition"):
        upart = partition_balanced(
            np.bincount(u_idx, minlength=len(user_map)), D)
        ipart = partition_balanced(
            np.bincount(i_idx, minlength=len(item_map)), D)
    strategy = est.gatherStrategy
    if strategy == "auto":
        from tpu_als_torch import plan

        strategy = plan.resolve_gather_strategy(
            requested="auto", n_users=len(user_map), n_items=len(item_map),
            rank=cfg.rank, n_devices=D, implicit=cfg.implicit_prefs)
    ring_counts = None
    with obs.span("train.block", strategy=strategy):
        if strategy in ("ring", "ring_overlap"):
            ush = shard_csr_grid(upart, ipart, u_idx, i_idx, r)
            ish = shard_csr_grid(ipart, upart, i_idx, u_idx, r)
            pos = cfg.implicit_prefs
            ring_counts = (stacked_counts(upart, u_idx, r, positive_only=pos),
                           stacked_counts(ipart, i_idx, r, positive_only=pos))
        elif strategy == "all_to_all":
            from tpu_als_torch.parallel.a2a import build_a2a

            ush = build_a2a(upart, ipart, u_idx, i_idx, r,
                            on_degenerate="stub")
            ish = build_a2a(ipart, upart, i_idx, u_idx, r,
                            on_degenerate="stub")
            if ush.degenerate or ish.degenerate:
                # one hot (src, dst) pair inflated the budget to at least
                # all_gather's traffic: use the strategy that bounds it
                strategy = "all_gather"
                ush = shard_csr(upart, ipart, u_idx, i_idx, r)
                ish = shard_csr(ipart, upart, i_idx, u_idx, r)
        else:
            ush = shard_csr(upart, ipart, u_idx, i_idx, r)
            ish = shard_csr(ipart, upart, i_idx, u_idx, r)

    # the EFFECTIVE strategy's modeled traffic (a degenerate a2a plan fell
    # back to all_gather above)
    est.lastFitCommBytes = comm_bytes_per_iter(
        strategy, upart, ipart, cfg.rank, user_container=ush,
        item_container=ish, implicit=cfg.implicit_prefs)
    est.lastFitStrategy = strategy
    obs.gauge("train.comm_bytes_per_iter", est.lastFitCommBytes,
              strategy=strategy)
    if strategy == "all_gather_chunked":
        sub_u, _, _ = gather_block_plan(ipart.rows_per_shard, 4)
        obs.gauge("train.gather_block_rows", sub_u, n_blocks=4,
                  side="user_half")

    sharded_cb = None
    if callback is not None:
        def sharded_cb(iteration, U, V):  # slot space -> entity space
            if est._callback_due(iteration):
                callback(iteration, entity_rows(upart, U),
                         entity_rows(ipart, V))
    with obs.span("train.fit", strategy=strategy):
        Us, Vs = train_sharded(mesh, upart, ipart, ush, ish, cfg,
                               callback=sharded_cb, strategy=strategy,
                               ring_counts=ring_counts, init=init,
                               start_iter=start_iter,
                               elastic=bool(getattr(est, "elastic", False)))
        U, V = entity_rows(upart, Us), entity_rows(ipart, Vs)
        if U.is_cuda:
            torch.cuda.synchronize(U.device)
    return U, V


# -- multi-process ------------------------------------------------------

_GATE_FIELDS = ("dataMode", "fitCallback present", "fitCallbackInterval",
                "checkpointing", "checkpointInterval", "checkpointSharded",
                "checkpointDir digest", "maxIter", "gatherStrategy",
                "cgIters", "cgMode", "split_width", "scratch_elems")


def multiprocess_knobs(est, cfg, u_raw, i_raw):
    """The kernel knobs a multi-process fit runs with: the planner's
    banked ``kernel_config`` for this process's view of the problem (its
    ratings ``u_raw``/``i_raw``; keyed like a single-process fit, with
    the mesh's global size), read and never tuned (a tune would time
    collectives per process and decide per process), or None (the module
    constants) when the gate ``core.als.autotune_gate`` is off or nothing
    is banked.  Processes whose banks differ meet in
    :func:`check_multiprocess_gate`."""
    from tpu_als_torch import plan
    from tpu_als_torch.core import als as core_als

    if not core_als.autotune_gate():
        return None
    kcfg = plan.resolve_kernel_config(
        rank=int(cfg.rank), compute_dtype=cfg.compute_dtype,
        device=est.mesh.device, tune=False,
        shape_class=plan.shape_class(len(np.unique(u_raw)),
                                     len(np.unique(i_raw)), len(u_raw)),
        mesh_shape=(est.mesh.global_size,))
    if not kcfg:
        return None
    return {"split_width": int(kcfg["split_width"]),
            "scratch_elems": int(kcfg["scratch_elems"])}


def check_multiprocess_gate(est, knobs=None):
    """All-gather and compare the fit's knobs every process must share:
    the reference's 11 (dataMode, fitCallback present,
    fitCallbackInterval, checkpointing, checkpointInterval,
    checkpointSharded, a digest of the resolved checkpointDir when the
    checkpoints are sharded, maxIter, gatherStrategy, cgIters, cgMode)
    and the port's kernel knobs ``knobs`` (None: the module constants).
    ``gatherStrategy='auto'`` is refused, as in the reference: the
    planner's pick must be made up front and passed explicitly."""
    from tpu_als_torch.core import als as core_als
    from tpu_als_torch.ops import cuda_gather_ne
    from tpu_als_torch.parallel.trainer import EXECUTABLE_STRATEGIES

    interval = est.getCheckpointInterval()
    ckpt_on = est.checkpointDir is not None and interval >= 1
    ckdir_digest = 0
    if est.checkpointSharded and ckpt_on and est.checkpointDir:
        h = hashlib.blake2b(os.path.abspath(est.checkpointDir).encode(),
                            digest_size=8).digest()
        ckdir_digest = int(np.frombuffer(h, dtype=np.int64)[0])
    if est.gatherStrategy == "auto":
        raise ValueError(
            "gatherStrategy='auto' is not supported in multi-process "
            "fits — resolve it up front (tpu_als_torch plan warm shows the "
            "modeled pick) and pass the same explicit strategy on every "
            "process")
    knobs = knobs or {}
    row = np.array(
        [int(est.dataMode == "per_host"), int(est.fitCallback is not None),
         est.fitCallbackInterval, int(ckpt_on), interval,
         int(est.checkpointSharded), ckdir_digest, est.getMaxIter(),
         EXECUTABLE_STRATEGIES.index(est.gatherStrategy), est.cgIters,
         ("matfree", "dense").index(est.cgMode),
         int(knobs.get("split_width", core_als.SPLIT_WIDTH)),
         int(knobs.get("scratch_elems", cuda_gather_ne._SCRATCH_ELEMS))],
        dtype=np.int64)
    gate = multihost.process_allgather(row)
    if not (gate == gate[0]).all():
        raise ValueError(
            "processes disagree on multi-process fit config "
            f"({', '.join(_GATE_FIELDS)}): {gate.tolist()} — pass the SAME "
            "knobs on every process (peers may use an inert callback; "
            "only process 0's is invoked; the kernel knobs come from each "
            "process's plan cache: share one TPU_ALS_PLAN_CACHE or tune "
            "once with plan tune)")


def check_finite_ratings_collective(local_nonfinite, rating_col):
    """Raise on EVERY process when any process's ratings hold nan/inf: a
    one-process abort before the data collectives would strand its peers
    inside them."""
    counts = multihost.process_allgather(
        np.array([local_nonfinite], dtype=np.int64))
    if counts.sum() > 0:
        raise ValueError(
            f"ratingCol {rating_col!r} contains non-finite values "
            f"(nan/inf) — per-process counts {counts.ravel().tolist()}; "
            "clean the input before fit")


def fit_multiprocess(est, u_idx, i_idx, r, user_map, item_map, cfg, init,
                     start_iter, knobs=None):
    """Multi-process fit: every process passes the SAME dataset
    (``dataMode='replicated'``) or its own split (``'per_host'``: the id
    maps were agreed by ``global_id_union``, the triples are exchanged
    inside ``train_multihost``); blocking is per process, training
    crosses processes through the multihost transport, and the fitted
    factors are gathered to every process for the model object.  Same
    init, partitions and layout as the one-process mesh fit, so
    'all_gather' gives its factors bit for bit.

    Per iteration, collectively: the preemption decision (a signal on
    any process saves and stops every process at the same boundary); a
    sharded checkpoint written by every process when due
    (``checkpointSharded``); else, when a checkpoint, the fitCallback
    (every ``fitCallbackInterval``) or a stop is due, the entity-space
    gather, then on process 0 only the callback and the replicated
    checkpoint.  The last gather is reused when it was the final
    iteration's.  Returns entity-space ``(U, V)``."""
    last_gather = {}  # iteration -> (U, V), so the final gather is not
    # repeated after training (the costliest collective at the end)

    def mp_cb(iteration, Us, Vs, up, ip):
        due_cb, due_ck = est._due(iteration)
        stopping = bool(multihost.process_allgather(np.array(
            [int(preempt.pending(iteration))], dtype=np.int64)).sum() > 0)
        if stopping and est.checkpointDir is not None:
            due_ck = True  # a resume point at this boundary
        if due_ck and est.checkpointSharded:
            multihost.save_checkpoint_sharded(
                os.path.join(est.checkpointDir, "als_checkpoint"), Us, Vs,
                up, ip, user_map, item_map, est.mesh,
                params=est._ckpt_params(), iteration=iteration)
            due_ck = False
        if not (due_cb or due_ck or stopping):
            return
        Ue = multihost.gather_entity_factors(Us, up, est.mesh)
        Ve = multihost.gather_entity_factors(Vs, ip, est.mesh)
        last_gather.clear()
        last_gather[iteration] = (Ue, Ve)
        if multihost.process_index() == 0:
            if due_cb and est.fitCallback is not None:
                est.fitCallback(iteration, Ue, Ve)
            if due_ck:
                est._save_checkpoint(user_map, item_map, iteration, Ue, Ve)
        if stopping:
            path = (os.path.join(est.checkpointDir, "als_checkpoint")
                    if est.checkpointDir is not None else None)
            g = preempt.installed()
            signum = g.signum if g is not None else None
            obs.emit("preempted", iteration=iteration, signum=signum)
            raise preempt.Preempted(iteration, path, signum)

    # nothing observes the fit (the one-process rule): no per-iteration
    # collective; the gate made this the same decision on every process
    observed = est._callback(user_map, item_map) is not None
    with obs.span("train.fit", strategy=est.gatherStrategy):
        Us, Vs, upart, ipart = multihost.train_multihost(
            u_idx, i_idx, r, len(user_map), len(item_map), cfg,
            mesh=est.mesh, replicated=est.dataMode == "replicated",
            strategy=est.gatherStrategy, init=init, start_iter=start_iter,
            callback=mp_cb if observed else None, knobs=knobs)
        if cfg.max_iter in last_gather:
            return last_gather[cfg.max_iter]
        return (multihost.gather_entity_factors(Us, upart, est.mesh),
                multihost.gather_entity_factors(Vs, ipart, est.mesh))
