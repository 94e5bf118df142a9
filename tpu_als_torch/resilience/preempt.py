"""Preemption-safe training: catch SIGTERM, checkpoint, exit cleanly.

Counterpart of ``tpu_als/resilience/preempt.py`` (stdlib only).  Spot or
preemptible capacity gets a SIGTERM with a short grace window before the
machine goes.  The contract: finish the iteration in flight, write an
atomic checkpoint, and exit with :data:`EXIT_PREEMPTED` so that the
orchestrator reruns the command with ``--resume auto`` instead of
reporting a failure.

The guard only *records* the signal; the fit's per-iteration callback
polls :func:`pending` at iteration boundaries, where the factors are
consistent.  A resumed fit restarts from the checkpoint's factors and
iteration index.

``TPU_ALS_PREEMPT_AT=N`` makes :func:`pending` fire at iteration N
without any signal: deterministic "preemption" for tests and chip runs.
A malformed value is a configuration error, not a silent no-op: it
raises :class:`PreemptAtError` when a guard is armed
(``PreemptionGuard.__enter__``) and at every poll, as a malformed
``TPU_ALS_FAULT_SPEC`` does.
"""

from __future__ import annotations

import os
import signal
import threading

# distinct from a generic failure (1)
EXIT_PREEMPTED = 43

ENV_PREEMPT_AT = "TPU_ALS_PREEMPT_AT"


class PreemptAtError(ValueError):
    """``TPU_ALS_PREEMPT_AT`` is set but not a positive integer: a knob
    that silently failed to fire would let a test pass with nothing
    injected."""


def preempt_at(environ=None):
    """The validated ``TPU_ALS_PREEMPT_AT`` value: ``None`` when unset
    or empty, the iteration as an int otherwise.  Raises
    :class:`PreemptAtError` on a malformed value."""
    at = (environ if environ is not None else os.environ).get(
        ENV_PREEMPT_AT)
    if not at:
        return None
    try:
        n = int(at)
    except ValueError:
        raise PreemptAtError(
            f"{ENV_PREEMPT_AT}={at!r} is not an integer — the "
            "deterministic preemption knob takes an iteration number "
            "(e.g. TPU_ALS_PREEMPT_AT=3)") from None
    if n < 1:
        raise PreemptAtError(
            f"{ENV_PREEMPT_AT}={at!r} must be >= 1 (iterations are "
            "1-based)")
    return n


class Preempted(SystemExit):
    """Raised (by the trainer callback) after the preemption checkpoint
    is safely on disk.  Subclasses SystemExit with code
    :data:`EXIT_PREEMPTED` so an unhandled escape still exits with the
    right status; ``checkpoint_path`` tells the handler where the
    resumable state landed (None if no checkpoint dir was configured)."""

    def __init__(self, iteration, checkpoint_path=None, signum=None):
        super().__init__(EXIT_PREEMPTED)
        self.iteration = iteration
        self.checkpoint_path = checkpoint_path
        self.signum = signum

    def __str__(self):
        where = self.checkpoint_path or "<no checkpoint dir>"
        return (f"preempted at iteration {self.iteration}; "
                f"state at {where}")


class PreemptionGuard:
    """Context manager that converts SIGTERM/SIGINT into a flag.

    Signal handlers can only be installed from the main thread; on any
    other thread the guard degrades to the ``TPU_ALS_PREEMPT_AT`` knob.  Handlers are restored
    on exit.  A second signal while the flag is already set re-raises
    the default behavior (the user pressing Ctrl-C twice really wants
    out *now*).
    """

    _active = None  # the currently installed guard, for pending()

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self._flag = threading.Event()
        self._signum = None
        self._saved = {}
        self._installed = False

    # -- signal plumbing -------------------------------------------------
    def _handler(self, signum, frame):
        if self._flag.is_set():
            # second signal: restore defaults and let it kill us
            self._restore()
            signal.raise_signal(signum)
            return
        self._signum = signum
        self._flag.set()

    def _restore(self):
        for s, old in self._saved.items():
            try:
                signal.signal(s, old)
            except (ValueError, OSError):
                pass
        self._saved.clear()
        self._installed = False

    def __enter__(self):
        preempt_at()   # arm-time validation: fail loud, not silent
        if threading.current_thread() is threading.main_thread():
            for s in self.signals:
                self._saved[s] = signal.signal(s, self._handler)
            self._installed = True
        PreemptionGuard._active = self
        return self

    def __exit__(self, *exc):
        if self._installed:
            self._restore()
        if PreemptionGuard._active is self:
            PreemptionGuard._active = None
        return False

    # -- queries ---------------------------------------------------------
    @property
    def signum(self):
        return self._signum

    def triggered(self):
        """True once a signal has been observed."""
        return self._flag.is_set()

    def trigger(self, signum=signal.SIGTERM):
        """Programmatic preemption (tests, simulated orchestrators)."""
        self._signum = signum
        self._flag.set()


def installed():
    """The active :class:`PreemptionGuard`, or None."""
    return PreemptionGuard._active


def enabled():
    """True when preemption handling is in play at all — a guard is
    installed or the deterministic test knob is set.  Trainers use this
    to decide whether their loop needs a preemption-aware callback."""
    return (PreemptionGuard._active is not None
            or preempt_at() is not None)


def pending(iteration=None):
    """Should training stop at this iteration boundary?

    True when the active guard has observed a signal, or when
    ``TPU_ALS_PREEMPT_AT`` equals ``iteration`` (the deterministic test
    knob).  Cheap enough to poll every iteration.
    """
    g = PreemptionGuard._active
    if g is not None and g.triggered():
        return True
    if iteration is not None:
        at = preempt_at()
        if at is not None and at == iteration:
            if g is not None:
                g.trigger()
            return True
    return False
