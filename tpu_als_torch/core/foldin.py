"""Incremental fold-in: solve factors for touched entities against fixed ones.

Counterpart of ``tpu_als/core/foldin.py::fold_in``.  For each touched
entity u with ratings against the fixed factor table V,

    u* = (VᵤᵀCᵤVᵤ + λ·n·I)⁻¹ VᵤᵀCᵤp(u)

— one half-step restricted to the touched rows.  The gather and the
normal equations are PyTorch ops; on the card the SPD solve is kernel K2
up to rank 128 and kernel K6 (factorization and both substitutions in
one call) above (:func:`tpu_als_torch.ops.solve.solve_spd`).
"""

from __future__ import annotations

from tpu_als_torch.ops.solve import (
    DEFAULT_JITTER,
    compute_yty,
    normal_eq_explicit,
    normal_eq_implicit,
    solve_nnls,
    solve_spd,
)


def normal_eqs(V, cols, vals, mask, reg_param, implicit_prefs=False,
               alpha=1.0, YtY=None):
    """Gather ``V[cols]`` and build ``(A, b, count)`` for the touched rows."""
    Vg = V[cols]
    if implicit_prefs:
        if YtY is None:
            YtY = compute_yty(V)
        return normal_eq_implicit(Vg, vals, mask, reg_param, alpha, YtY)
    return normal_eq_explicit(Vg, vals, mask, reg_param)


def fold_in(V, cols, vals, mask, reg_param, implicit_prefs=False, alpha=1.0,
            nonnegative=False, nnls_sweeps=32, YtY=None,
            jitter=DEFAULT_JITTER):
    """New factors [n, rank] for a batch of touched entities.

    cols (int64) / vals / mask (float32): [n, w] padded rows on V's device.
    """
    A, b, count = normal_eqs(V, cols, vals, mask, reg_param,
                             implicit_prefs=implicit_prefs, alpha=alpha,
                             YtY=YtY)
    if nonnegative:
        return solve_nnls(A, b, count, sweeps=nnls_sweeps, jitter=jitter)
    return solve_spd(A, b, count, jitter=jitter)
