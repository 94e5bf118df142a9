"""Measurement-side tracing: fence-timed stage spans and the serving
flight recorder.

Counterpart of ``tpu_als/obs/trace.py``:

- ``stage(name)``: a context manager that times one ALS stage between
  fences and records the wall clock into the ``train.stage_seconds
  {stage=name}`` histogram and the span tree.  Stage names are
  ``perf/roofline.py``'s, so ``observe attribution`` joins measured
  seconds against the modeled floor by name.  The fence is what makes
  the numbers mean anything: torch returns before the card finishes, so
  without it a stage's time is the time to enqueue its kernels.
  :func:`fence` synchronizes the CUDA device of every CUDA tensor it is
  given; CPU tensors and host values pass through.
- :class:`FlightRecorder`: a bounded ring of per-request span records
  for the serving engine; ``dump(trigger)`` emits the not-yet-dumped
  tail as ``flight_record`` events.

Arming: the attributed training path is off unless enabled
(:func:`enable_stage_attribution`, :func:`stage_attribution`, or
``TPU_ALS_STAGE_ATTRIBUTION`` set to anything but '' or '0').  Disarmed,
``core.als.train`` reads one flag and runs its iteration as it is.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time

import torch
from torch.utils._pytree import tree_leaves

from tpu_als_torch import obs

_ENV_FLAG = "TPU_ALS_STAGE_ATTRIBUTION"
_armed = False


def enable_stage_attribution():
    """Arm the attributed (decomposed, fence-timed) training path."""
    global _armed
    _armed = True


def disable_stage_attribution():
    global _armed
    _armed = False


def stage_attribution_armed():
    """True when stage attribution is on, explicitly or through the
    ``TPU_ALS_STAGE_ATTRIBUTION`` variable (any value but '' or '0')."""
    return _armed or os.environ.get(_ENV_FLAG, "0") not in ("", "0")


@contextlib.contextmanager
def stage_attribution():
    """Scoped arming, for tests and the attribution command."""
    was = _armed
    enable_stage_attribution()
    try:
        yield
    finally:
        if not was:
            disable_stage_attribution()


def fence(x):
    """Wait for the CUDA device of every CUDA tensor in ``x`` (any nest
    of lists, tuples and dicts); CPU tensors and host values pass
    through.  Returns ``x``."""
    devices = {t.device for t in tree_leaves(x)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)
    return x


@contextlib.contextmanager
def stage(name, sink=None):
    """Fence-timed stage span.

    Yields ``keep(x)``: the body passes every device output it wants
    attributed through it.  On exit the kept values are fenced, and the
    fence-to-fence wall clock lands in ``train.stage_seconds{stage=
    name}``, the span tree (span ``attr.<name>``) and ``sink[name]``
    when a dict is given (the attribution runner's accumulator).
    """
    pending = []

    def keep(x):
        pending.append(x)
        return x

    # tal: disable=timer-brackets-span -- deliberate: the clock brackets
    # the span's own bookkeeping too, so every second of the attributed
    # path belongs to some stage (the coverage bound of
    # perf/attribution.py: the stages cover >= 90 % of the wall iteration)
    t0 = time.perf_counter()
    with obs.span("attr." + name, stage=name):
        yield keep
        fence(pending)
    dt = time.perf_counter() - t0
    obs.histogram("train.stage_seconds", dt, stage=name)
    if sink is not None:
        sink[name] = sink.get(name, 0.0) + dt


# per-request span breakdown every flight record carries; rescore is None
# where the int8 rescore is not timed apart from the shortlist
SPAN_KEYS = obs.schema.SERVE_SPAN_KEYS


class FlightRecorder:
    """Bounded ring of per-request span records.

    ``record(...)`` is the always-on cheap path (called once per request
    outcome); ``dump(trigger)`` emits every not-yet-dumped record in the
    ring as a ``flight_record`` event.  A monotonic watermark guarantees
    each record is emitted at most once, so repeated triggers (every
    request breaching a tiny SLO) cost O(new records), not O(ring).

    ``span_keys`` names the breakdown each record carries — the serving
    request spans by default.

    ``labels`` is the recorder's STRUCTURAL attribution (e.g.
    ``tenant=<name>`` on a tenant-built engine's ring): stamped into
    every record at construction time rather than re-passed per call,
    so a new record site cannot forget the tenant and strand a dump
    event unattributable.
    """

    def __init__(self, capacity=64, span_keys=SPAN_KEYS, labels=None):
        self._ring = collections.deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._span_keys = tuple(span_keys)
        self._labels = dict(labels) if labels else {}
        self._seq = 0
        self._dumped_seq = 0

    def record(self, status, spans, *, e2e_seconds=None, path=None,
               **extra):
        """Append one request trace. ``spans`` maps the recorder's span
        keys -> seconds (missing/None = not reached, e.g. a shed never
        queues)."""
        with self._lock:
            self._seq += 1
            rec = {"seq": self._seq, "status": status,
                   "spans": {k: spans.get(k) for k in self._span_keys},
                   "e2e_seconds": e2e_seconds, "path": path}
            rec.update(self._labels)
            rec.update(extra)
            self._ring.append(rec)
            return self._seq

    def dump(self, trigger):
        """Emit the not-yet-dumped tail as flight_record events; returns
        the number emitted."""
        with self._lock:
            recs = [dict(r) for r in self._ring
                    if r["seq"] > self._dumped_seq]
            self._dumped_seq = self._seq
        for r in recs:
            obs.emit("flight_record", trigger=trigger, **r)
        return len(recs)

    def __len__(self):
        with self._lock:
            return len(self._ring)
