"""Causal trace-context propagation across the serving request path.

Counterpart of ``tpu_als/obs/tracing.py`` (stdlib + obs): one context
threads every hop a request takes, so a breach whose cause sits in
another stage is visible from the trail alone.

- :func:`start_trace` mints a root span at an admission point (a serve
  request entering the engine) and returns a :class:`TraceContext`;
- :func:`record_span` emits one child span and returns the NEW context,
  so call sites chain hops with a single assignment::

      t.trace = tracing.record_span(t.trace, "serve.queue",
                                    seconds=queue_wait)

- every span lands in the obs trail as a ``trace_span`` event whose
  name is checked against ``schema.TRACE_SPANS`` when it is recorded.

Determinism: trace and span ids come from a lock-protected process
counter seeded by :func:`reset_trace_ids`, never a clock or a random
draw, so a seeded replay of the same admission order gives the same ids
as the reference's.  Device work is timed by its callers and the
measured seconds ride the span; this module never touches a tensor.

Arming: tracing is off unless enabled (:func:`enable_tracing`, the
scoped :func:`traced`, or ``TPU_ALS_TRACE=1``).  Disarmed,
:func:`start_trace` returns ``None`` and every propagation site is one
``is None`` check.
"""

from __future__ import annotations

import contextlib
import os
import threading

from tpu_als_torch import obs
from tpu_als_torch.obs import schema

__all__ = [
    "TraceContext", "enable_tracing", "disable_tracing",
    "tracing_armed", "traced", "reset_trace_ids", "start_trace",
    "record_span",
]

_ENV_FLAG = "TPU_ALS_TRACE"
_armed = False

_lock = threading.Lock()
_seed = 0
_next = 0


def enable_tracing():
    """Arm causal tracing for this process (tests arm it; production
    serving opts in)."""
    global _armed
    _armed = True


def disable_tracing():
    global _armed
    _armed = False


def tracing_armed():
    """True when tracing is on — explicitly or via the ``TPU_ALS_TRACE``
    env knob (any value but ''/'0')."""
    return _armed or os.environ.get(_ENV_FLAG, "0") not in ("", "0")


@contextlib.contextmanager
def traced():
    """Scoped arming (tests)."""
    was = _armed
    enable_tracing()
    try:
        yield
    finally:
        if not was:
            disable_tracing()


def reset_trace_ids(seed=0):
    """Restart the deterministic id counter (tests; a seeded replay of
    the same admission order reproduces the same trace/span ids)."""
    global _seed, _next
    with _lock:
        _seed = int(seed)
        _next = 0


def _new_id(prefix):
    """One process-unique id: ``<prefix><seed:02x>-<counter:08x>``.
    A counter, not a clock or RNG — ids are causal order, replayable."""
    global _next
    with _lock:
        _next += 1
        return f"{prefix}{_seed:02x}-{_next:08x}"


class TraceContext:
    """The propagated half of one span: enough to emit a child.

    Immutable by convention; propagation replaces the whole context
    (``t.trace = record_span(t.trace, ...)``) so concurrent readers
    never see a half-updated hop.
    """

    __slots__ = ("trace_id", "span_id", "parent_id", "tenant")

    def __init__(self, trace_id, span_id, parent_id=None, tenant=None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.tenant = tenant

    def __repr__(self):
        return (f"TraceContext(trace_id={self.trace_id!r}, "
                f"span_id={self.span_id!r}, "
                f"parent_id={self.parent_id!r}, "
                f"tenant={self.tenant!r})")


def _emit(ctx, name, status, seconds, fields):
    schema.check_trace_span(name, status)
    extra = dict(fields)
    if ctx.tenant is not None:
        extra.setdefault("tenant", ctx.tenant)
    obs.emit("trace_span", trace_id=ctx.trace_id, span_id=ctx.span_id,
             parent_id=ctx.parent_id, name=name, status=status,
             seconds=seconds, **extra)


def start_trace(name, tenant=None, *, status="ok", seconds=None,
                **fields):
    """Mint a new trace at an admission point: emits the root span and
    returns its :class:`TraceContext` (``None`` when disarmed — the
    whole propagation chain no-ops off that None).

    ``name`` must be a declared ``schema.TRACE_SPANS`` hop; ``status``
    a declared ``TRACE_STATUSES`` outcome (a shed admission is a root
    span with ``status="shed"`` — refusals are traced, not dropped).
    """
    if not tracing_armed():
        return None
    ctx = TraceContext(_new_id("t"), _new_id("s"), parent_id=None,
                       tenant=tenant)
    _emit(ctx, name, status, seconds, fields)
    return ctx


def record_span(ctx, name, *, status="ok", seconds=None, **fields):
    """Emit one child span under ``ctx`` and return the NEW context
    (the child becomes the parent of the next hop).  No-ops — returning
    ``ctx`` unchanged — when ``ctx`` is None or tracing is disarmed, so
    call sites chain unconditionally."""
    if ctx is None or not tracing_armed():
        return ctx
    child = TraceContext(ctx.trace_id, _new_id("s"),
                         parent_id=ctx.span_id, tenant=ctx.tenant)
    _emit(child, name, status, seconds, fields)
    return child
