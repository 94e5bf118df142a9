"""The serving flight recorder: a bounded ring of per-request traces.

Counterpart of the second half of ``tpu_als/obs/trace.py``
(:class:`FlightRecorder` and its ``SPAN_KEYS``).  The first half, the
per-stage attribution of a training iteration, waits for the port's
``perf/`` (ROADMAP).
"""

from __future__ import annotations

import collections
import threading

from tpu_als_torch import obs

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
