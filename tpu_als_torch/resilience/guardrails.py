"""Numerical-health guardrails: divergence sentinels and bounded rollback.

Counterpart of ``tpu_als/resilience/guardrails.py``.  A NaN seeded in the
factors, an ill-conditioned Gram system or a poisoned rating would
otherwise spoil a fit silently: a non-finite factor row spreads through
the next normal-equation sums to every entity it touches.  One mode knob
arms three layers (``python -m tpu_als_torch.cli train --guardrails
off|warn|recover``, the env var ``TPU_ALS_GUARDRAILS``, ``ALS(guardrails=)``
or :func:`set_mode`):

- **Sentinels** — :func:`health_stats`, a reduction over both factor
  tables on the device (finiteness, the largest row norm of each side,
  the global norm) read once at each iteration boundary by
  :meth:`Monitor.judge`: one small device pass and one host sync an
  iteration.  Disarmed, the cost is one mode check per ``train`` call.
- **Adaptive solve** — 'recover' trains with ``AlsConfig(adaptive_solve=
  True)``: :func:`tpu_als_torch.ops.solve.solve_spd`'s residual-checked
  jitter ladder and CG fallback, above the solve dispatch, so the solve
  kernels (K1, K2, K6) run every rung.
- **Rollback** — a last-good snapshot of the factors (a real copy, taken
  before each iteration) restored with a seeded perturbation and a
  transient regularization bump when a sentinel trips in 'recover'; the
  budget is a :class:`~tpu_als_torch.resilience.retry.RetryPolicy`
  (``max_attempts`` rollbacks), after which :class:`TrainDiverged`
  raises.  'warn' only reports and goes on.

Every trip emits ``guardrail_tripped``; every rollback counts
``train.rollbacks`` and emits ``train_rollback``
(:mod:`tpu_als_torch.obs`).  The perturbation is drawn from a
``torch.Generator`` seeded by the reference's formula; it cannot match
``jax.random``'s draws, only their determinism.
"""

from __future__ import annotations

import contextlib
import os

import torch

from tpu_als_torch import obs
from tpu_als_torch.resilience.retry import RetryPolicy

MODES = ("off", "warn", "recover")

ENV_VAR = "TPU_ALS_GUARDRAILS"

# the `sentinel` field of every guardrail_tripped event is one of these
SENTINELS = ("nonfinite", "norm_band", "trend")

# Factor rows start unit-norm and a healthy fit keeps row norms within a
# few orders of magnitude of the rating scale: 1e4 is far outside any
# converging trajectory and far inside float32 overflow.  ALS decreases
# its objective monotonically, so a > 10x jump of the global norm
# between healthy iterations is the cheap, ratings-free sign of a
# diverging fit.
NORM_BAND_MAX = 1e4
TREND_FACTOR = 10.0

# recover mode: each rollback perturbs the snapshot by PERTURB_SCALE
# Gaussian noise (seeded) and multiplies regParam by REG_BUMP_FACTOR for
# the retried iteration
PERTURB_SCALE = 1e-3
REG_BUMP_FACTOR = 10.0

# 3 rollbacks, then TrainDiverged (rollback retries at once: no delays)
DEFAULT_ROLLBACK_POLICY = RetryPolicy(max_attempts=3, base_delay=0.0,
                                      jitter=0.0)


class TrainDiverged(ArithmeticError):
    """The rollback budget is spent and the fit still trips a sentinel:
    the run is numerically unrecoverable under its config (raise regParam
    or jitter, or inspect the data)."""

    def __init__(self, iteration, rollbacks, sentinel):
        super().__init__(
            f"training diverged at iteration {iteration}: sentinel "
            f"{sentinel!r} still trips after {rollbacks} rollback(s) — "
            "the rollback budget is exhausted")
        self.iteration = iteration
        self.rollbacks = rollbacks
        self.sentinel = sentinel


_mode = None   # explicit set_mode value; None -> the env var


def _check(mode, where):
    if mode not in MODES:
        raise ValueError(f"unknown guardrails mode {mode!r} in {where} "
                         f"(expected one of {MODES})")
    return mode


def set_mode(mode):
    """Arm the guardrails for this process (``ALS(guardrails=)`` lands
    here through :func:`scoped`)."""
    global _mode
    _mode = _check(mode, "set_mode")


def clear_mode():
    """Back to the environment's setting."""
    global _mode
    _mode = None


def guardrails_mode():
    """The effective mode: :func:`set_mode`'s, else ``TPU_ALS_GUARDRAILS``,
    else 'off'.  A value that is not a mode raises (silently disarming a
    guardrail would be worse)."""
    if _mode is not None:
        return _mode
    return _check(os.environ.get(ENV_VAR) or "off", ENV_VAR)


def armed():
    return guardrails_mode() != "off"


@contextlib.contextmanager
def scoped(mode):
    """Arm ``mode`` for the body (the estimator's fit, tests), then
    restore the previous setting."""
    global _mode
    prev = _mode
    set_mode(mode)
    try:
        yield
    finally:
        _mode = prev


def health_stats(U, V):
    """``[finite, max_row_norm_u, max_row_norm_v, global_fro_norm]`` as a
    float32 tensor of 4 on the factors' device, computed there and not
    read here: :meth:`Monitor.judge` reads it, the iteration's one
    sync."""
    def sq(X):
        return (X.float() * X.float()).sum(1)

    su, sv = sq(U), sq(V)
    zero = torch.zeros((), device=U.device)
    finite = torch.isfinite(U).all() & torch.isfinite(V).all()
    return torch.stack([
        finite.float(),
        su.max().sqrt() if len(su) else zero,
        sv.max().sqrt() if len(sv) else zero,
        (su.sum() + sv.sum()).sqrt()])


class Monitor:
    """Sentinel state and rollback for one fit
    (:func:`tpu_als_torch.core.als.train` makes one when armed).

    The loop's contract, per iteration: :meth:`keep_last_good` before the
    step, :meth:`judge` on its output at the boundary and, on a trip in
    'recover', :meth:`rollback` for perturbed last-good factors and the
    reg scale of the retried iteration.
    """

    def __init__(self, cfg, mode, *, norm_band_max=NORM_BAND_MAX,
                 trend_factor=TREND_FACTOR, policy=None):
        if mode not in ("warn", "recover"):
            raise ValueError(f"Monitor mode must be 'warn' or 'recover', "
                             f"got {mode!r}")
        self.cfg = cfg
        self.mode = mode
        self.norm_band_max = float(norm_band_max)
        self.trend_factor = float(trend_factor)
        self.policy = policy if policy is not None \
            else DEFAULT_ROLLBACK_POLICY
        self.rollbacks = 0
        self.reg_scale = 1.0
        self._snap = None
        self._prev_fro = None

    def keep_last_good(self, U, V, retry=False):
        """Copy the pre-step factors ('recover' only: 'warn' never rolls
        back).  ``retry=True`` marks a post-rollback attempt, whose
        perturbed factors must not replace the clean snapshot they came
        from."""
        if self.mode != "recover" or retry:
            return
        self._snap = (U.clone(), V.clone())

    def judge(self, iteration, U, V):
        """Read the sentinels at the iteration boundary (the one host
        sync).  Returns the tripped sentinel's name, or None when healthy;
        a trip emits ``guardrail_tripped``."""
        finite, un, vn, fro = health_stats(U, V).tolist()
        row_norm = max(un, vn)
        trip = value = None
        if not finite:
            trip, value = "nonfinite", 0.0
        elif row_norm > self.norm_band_max:
            trip, value = "norm_band", row_norm
        elif (self._prev_fro is not None
                and fro > self.trend_factor * self._prev_fro):
            trip, value = "trend", fro / self._prev_fro
        if trip is None:
            self._prev_fro = fro
            return None
        obs.emit("guardrail_tripped", iteration=int(iteration),
                 sentinel=trip, mode=self.mode, value=value)
        return trip

    def rollback(self, iteration, sentinel):
        """Restore the last-good snapshot with a seeded perturbation and
        bump the regularization.  Returns ``(U, V, reg_scale)``; raises
        :class:`TrainDiverged` once the policy's ``max_attempts``
        rollbacks are spent, or when there is no snapshot (a fit whose
        first iteration diverges has nothing to roll back to)."""
        if self.rollbacks >= self.policy.max_attempts or self._snap is None:
            raise TrainDiverged(iteration, self.rollbacks, sentinel)
        self.rollbacks += 1
        self.reg_scale *= REG_BUMP_FACTOR
        U0, V0 = self._snap
        # a pure function of (seed, iteration, attempt): a failing
        # recovery replays exactly, and two rollbacks at one iteration
        # draw different noise
        g = torch.Generator(device=U0.device).manual_seed(
            (self.cfg.seed * 1_000_003 + iteration * 101 + self.rollbacks)
            & 0x7FFFFFFF)
        U = U0 + PERTURB_SCALE * torch.randn(
            U0.shape, generator=g, device=U0.device, dtype=U0.dtype)
        V = V0 + PERTURB_SCALE * torch.randn(
            V0.shape, generator=g, device=V0.device, dtype=V0.dtype)
        obs.counter("train.rollbacks", 1)
        obs.emit("train_rollback", iteration=int(iteration),
                 attempt=self.rollbacks, sentinel=sentinel,
                 reg_param=float(self.cfg.reg_param * self.reg_scale))
        return U, V, self.reg_scale
