"""The sharded fit behind ``ALS(mesh=...).fit``.

Counterpart of ``tpu_als/api/fitting.py::fit_sharded`` for one process:
balanced entity partitions, the strategy's rating containers (stacked
CSR shards, or the ring's owner × source grid with its per-row counts),
then :func:`tpu_als_torch.parallel.trainer.train_sharded`.  The
reference's elastic recovery, its planner-resolved ``'auto'`` and its
multi-process fit are not ported.
"""

from __future__ import annotations

import numpy as np

from tpu_als_torch.convert import entity_rows
from tpu_als_torch.parallel.comm import shard_csr_grid
from tpu_als_torch.parallel.data import partition_balanced, shard_csr
from tpu_als_torch.parallel.trainer import (
    check_strategy,
    stacked_counts,
    train_sharded,
)


def fit_sharded(est, u_idx, i_idx, r, user_map, item_map, cfg, init,
                start_iter, callback=None):
    """Fit over ``est.mesh`` with ``est.gatherStrategy``; ``callback``
    (iteration, U, V) gets entity-space factors.  Returns entity-space
    ``(U, V)`` on the mesh's device."""
    mesh = est.mesh
    strategy = est.gatherStrategy
    check_strategy(strategy)
    D = mesh.size
    upart = partition_balanced(np.bincount(u_idx, minlength=len(user_map)),
                               D)
    ipart = partition_balanced(np.bincount(i_idx, minlength=len(item_map)),
                               D)
    ring_counts = None
    if strategy in ("ring", "ring_overlap"):
        ush = shard_csr_grid(upart, ipart, u_idx, i_idx, r)
        ish = shard_csr_grid(ipart, upart, i_idx, u_idx, r)
        pos = cfg.implicit_prefs
        ring_counts = (stacked_counts(upart, u_idx, r, positive_only=pos),
                       stacked_counts(ipart, i_idx, r, positive_only=pos))
    else:
        ush = shard_csr(upart, ipart, u_idx, i_idx, r)
        ish = shard_csr(ipart, upart, i_idx, u_idx, r)

    sharded_cb = None
    if callback is not None:
        def sharded_cb(iteration, U, V):  # slot space -> entity space
            if est._callback_due(iteration):
                callback(iteration, entity_rows(upart, U),
                         entity_rows(ipart, V))
    U, V = train_sharded(mesh, upart, ipart, ush, ish, cfg,
                         callback=sharded_cb, strategy=strategy,
                         ring_counts=ring_counts, init=init,
                         start_iter=start_iter)
    return entity_rows(upart, U), entity_rows(ipart, V)
