"""Numerical-safety tooling.

Counterpart of ``tpu_als/utils/debug.py``:

  * :func:`debug_mode` — a context manager under which the first torch
    operation whose floating output holds a NaN raises
    ``FloatingPointError`` naming the operation, instead of poisoning the
    factors silently (the reference turns on ``jax_debug_nans``; here a
    ``TorchDispatchMode`` sees every operation's outputs).
  * :func:`checked_predict` — gather-dot scoring that raises
    :class:`IndexCheckError` on an out-of-range id instead of reading a
    clamped row (the production ``predict`` clamps and masks to NaN;
    this is the test-mode oracle that the mask hides nothing).
  * :func:`assert_all_finite` — the host-side factor audit for fit
    callbacks.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class IndexCheckError(IndexError):
    """An id outside its factor table, reported by
    :func:`checked_predict` (the reference raises
    ``checkify.JaxRuntimeError`` with the same messages)."""


class _NanCheck(TorchDispatchMode):
    """Raise at the first operation with a NaN in a floating output."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and bool(torch.isnan(t).any()):
                raise FloatingPointError(
                    f"debug_mode: {func} produced NaN")
        return out


@contextmanager
def debug_mode(nans=True, disable_jit=False):
    """Fail fast on numerics inside the block.

    ``nans=True`` makes any torch operation whose floating output holds a
    NaN raise ``FloatingPointError`` at that operation (each output is
    checked as it is made, which waits for the device).  The dispatch
    mode is popped on exit, however the block ends, so the previous
    state returns.  ``disable_jit`` is accepted for the reference's
    signature and changes nothing: eager torch has no jit to disable.
    """
    del disable_jit
    if not nans:
        yield
        return
    with _NanCheck():
        yield


def checked_predict(U, V, u_idx, i_idx):
    """Gather-dot scoring with hard index-bounds checks.

    Returns the scores as a tensor on U's device; raises
    :class:`IndexCheckError` ("negative user index", "user index out of
    range", "negative item index", "item index out of range", the first
    that fails in that order) on any out-of-range id.  For tests and
    debugging; the production path (``tpu_als_torch.core.als.predict``)
    masks invalid ids to NaN instead.
    """
    U = torch.as_tensor(U)
    V = torch.as_tensor(V, device=U.device)
    u = torch.as_tensor(np.asarray(u_idx), device=U.device).long()
    i = torch.as_tensor(np.asarray(i_idx), device=U.device).long()
    for bad, msg in (((u < 0).any(), "negative user index"),
                     ((u >= U.shape[0]).any(), "user index out of range"),
                     ((i < 0).any(), "negative item index"),
                     ((i >= V.shape[0]).any(), "item index out of range")):
        if bool(bad):
            raise IndexCheckError(msg)
    return torch.einsum("nr,nr->n", U[u], V[i])


def assert_all_finite(iteration, U, V):
    """Fit-callback form: raise if any factor entry is non-finite."""
    for name, X in (("U", U), ("V", V)):
        X = X.detach().cpu().numpy() if hasattr(X, "detach") \
            else np.asarray(X)
        bad = ~np.isfinite(X)
        if bad.any():
            raise FloatingPointError(
                f"non-finite {name} factors at iteration {iteration}: "
                f"{int(bad.sum())} entries (first row "
                f"{int(np.argwhere(bad)[0][0])})")
