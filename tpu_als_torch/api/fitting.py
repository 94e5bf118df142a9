"""The sharded fit behind ``ALS(mesh=...).fit``, with elastic recovery.

Counterpart of ``tpu_als/api/fitting.py::fit_sharded`` for one process:
balanced entity partitions, the strategy's rating containers (stacked
CSR shards, the ring's owner × source grid with its per-row counts, or
the all_to_all plans, with the reference's fallback from a degenerate
plan to ``'all_gather'``), the traffic model, then
:func:`tpu_als_torch.parallel.trainer.train_sharded`.  ``'auto'`` is
resolved by ``plan.resolve_gather_strategy``.  With ``est.elastic`` a
lost shard re-forms the mesh on the survivors and the fit resumes from
the last checkpoint (:func:`_reform_and_resume`).  The reference's
multi-process fit is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_als_torch import obs
from tpu_als_torch.convert import entity_rows
from tpu_als_torch.parallel.comm import gather_block_plan, shard_csr_grid
from tpu_als_torch.parallel.data import partition_balanced, shard_csr
from tpu_als_torch.parallel.trainer import (
    check_strategy,
    comm_bytes_per_iter,
    stacked_counts,
    train_sharded,
)
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
