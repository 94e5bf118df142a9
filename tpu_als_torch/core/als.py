"""Pairwise scoring of (user, item) index pairs.

Counterpart of ``tpu_als/core/als.py::predict``.  The training loop of
that module belongs to the training slice and is not here.
"""

from __future__ import annotations

import torch


def predict(U, V, u_idx, i_idx, u_valid, i_valid):
    """Gather-dot scores ``U[u]·V[i]``; NaN where a mask is False or an
    index is out of range (the ``coldStartStrategy='nan'`` semantic)."""
    u = u_idx.clamp(0, U.shape[0] - 1)
    i = i_idx.clamp(0, V.shape[0] - 1)
    ok = (u_valid & i_valid
          & (u_idx >= 0) & (u_idx < U.shape[0])
          & (i_idx >= 0) & (i_idx < V.shape[0]))
    scores = (U[u] * V[i]).sum(-1)
    return torch.where(ok, scores, torch.nan)
