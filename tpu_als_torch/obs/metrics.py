"""Process-wide metrics registry, spans and the JSONL/Prometheus sinks.

Counterpart of ``tpu_als/obs/metrics.py`` (stdlib only): one in-process
registry that the instrumented paths write to with dict operations under
one lock, and that a run drains to disk once, at :meth:`finalize`:

- ``events.jsonl``      — the append-only event log (spans, gauge sets,
  guardrail trips, quarantines, fault firings, a final ``snapshot``),
- ``metrics.prom``      — the Prometheus text exposition of the counters,
  gauges and histograms,
- ``run_manifest.json`` — config, versions, git, device
  (:mod:`tpu_als_torch.obs.manifest`).

Histograms use the reference's FIXED log-scale buckets (4 per decade,
1e-6..1e6), so two runs' exposition files share one ``le`` grid, and
their quantiles are the same bucketed estimates the reference reports.
``span(name)`` records wall-clock tree-structured spans and, when torch
is already imported, opens ``torch.profiler.record_function(name)`` so a
profiler trace carries the same names.  Names are checked against
:mod:`tpu_als_torch.obs.schema` when written.  A full ``events.jsonl``
rotates to ``events.NNN.jsonl`` at finalize (:func:`maybe_rotate`), as
the reference's does.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import sys
import threading
import time

from tpu_als_torch.obs import schema

# 4 buckets per decade over 1e-6 .. 1e6 (49 upper bounds; the 50th
# bucket is +Inf), as the reference's: fixed, never derived from data
BUCKET_BOUNDS = tuple(10.0 ** (e / 4.0) for e in range(-24, 25))

# in-memory event cap: a registry that is never finalized (library use,
# the tests) must not grow without bound; finalize() reports the drops
_MAX_EVENTS = 100_000

# events.jsonl rotation bound (bytes), as the reference's: when it is
# reached, finalize renames the file to the next events.NNN.jsonl and
# starts a fresh one.  Env-overridable; 0 disables rotation.
ROTATE_ENV = "TPU_ALS_OBS_ROTATE_BYTES"
_ROTATE_BYTES = 8 << 20


def _rotate_bound():
    raw = os.environ.get(ROTATE_ENV)
    if raw is None:
        return _ROTATE_BYTES
    try:
        return max(0, int(raw))
    except ValueError:
        return _ROTATE_BYTES


def maybe_rotate(run_dir, bound=None):
    """Rotate ``<run_dir>/events.jsonl`` to ``events.NNN.jsonl`` when it
    has reached ``bound`` bytes (default: ``TPU_ALS_OBS_ROTATE_BYTES``,
    else 8 MiB).  Returns the rotated-to path or None.  The readers
    (:mod:`tpu_als_torch.obs.report`, :mod:`~tpu_als_torch.obs.explain`)
    read the ``events.*.jsonl`` files sorted before the live one."""
    if bound is None:
        bound = _rotate_bound()
    if not bound:
        return None
    live = os.path.join(run_dir, "events.jsonl")
    try:
        if os.path.getsize(live) < bound:
            return None
    except OSError:
        return None
    n = 0
    while True:
        cand = os.path.join(run_dir, f"events.{n:03d}.jsonl")
        if not os.path.exists(cand):
            break
        n += 1
    os.replace(live, cand)
    return cand


def _labels_key(labels):
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _render_labels(lkey):
    if not lkey:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in lkey) + "}"


def _prom_name(name):
    return "tpu_als_" + name.replace(".", "_")


def _fmt(v):
    return f"{v:.10g}"


class _Hist:
    __slots__ = ("counts", "sum", "count", "min", "max")

    def __init__(self):
        self.counts = [0] * (len(BUCKET_BOUNDS) + 1)
        self.sum = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v):
        self.counts[bisect.bisect_left(BUCKET_BOUNDS, v)] += 1
        self.sum += v
        self.count += 1
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def quantile(self, q):
        """Upper bucket bound at quantile ``q`` (0..1), the bucketed
        estimate; the overflow bucket reports the observed max."""
        if self.count == 0:
            return float("nan")
        target = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            # acc > 0: at q = 0 an empty prefix is not the minimum
            if acc >= target and acc > 0:
                if i < len(BUCKET_BOUNDS):
                    return BUCKET_BOUNDS[i]
                return self.max
        return self.max

    def state(self):
        return {"count": self.count, "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "p50": self.quantile(0.5) if self.count else None,
                "p95": self.quantile(0.95) if self.count else None}


class MetricsRegistry:
    """Counters, gauges, histograms, events and spans under one lock;
    nothing touches the filesystem until :meth:`finalize`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters = {}     # (name, labels_key) -> float
        self._gauges = {}       # (name, labels_key) -> float
        self._hists = {}        # (name, labels_key) -> _Hist
        self._events = []
        self._dropped = 0
        self._flushed = 0       # events already written to disk
        self._run_dir = None
        self._manifest = None
        self._local = threading.local()

    # -- instruments ---------------------------------------------------
    def counter(self, name, value=1, **labels):
        schema.check_metric(name, "counter")
        schema.check_labels(name, labels)
        key = (name, _labels_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + value

    def gauge(self, name, value, **labels):
        schema.check_metric(name, "gauge")
        schema.check_labels(name, labels)
        key = (name, _labels_key(labels))
        with self._lock:
            self._gauges[key] = value
        # a gauge is point-in-time: each set is also an event, so the
        # JSONL alone carries its history
        self.emit("metric", kind="gauge", name=name, value=value,
                  labels=dict(labels))

    def histogram(self, name, value, **labels):
        schema.check_metric(name, "histogram")
        schema.check_labels(name, labels)
        key = (name, _labels_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Hist()
            h.observe(float(value))

    def histogram_quantile(self, name, q, **labels):
        """Bucketed quantile of a recorded histogram series (exact label
        match; NaN when the series has no observations)."""
        with self._lock:
            h = self._hists.get((name, _labels_key(labels)))
            return h.quantile(q) if h is not None else float("nan")

    def histogram_count(self, name, **labels):
        with self._lock:
            h = self._hists.get((name, _labels_key(labels)))
            return h.count if h is not None else 0

    def counter_value(self, name, **labels):
        with self._lock:
            return self._counters.get((name, _labels_key(labels)), 0)

    def emit(self, etype, **fields):
        """Append one event; returns the event dict (with its ts)."""
        schema.check_event(etype, fields)
        ev = {"ts": round(time.time(), 6), "type": etype, **fields}
        with self._lock:
            if len(self._events) >= _MAX_EVENTS:
                self._dropped += 1
            else:
                self._events.append(ev)
        return ev

    def events(self, etype=None):
        """The recorded events (of type ``etype``), oldest first."""
        with self._lock:
            return [e for e in self._events
                    if etype is None or e["type"] == etype]

    # -- span tracing --------------------------------------------------
    @contextlib.contextmanager
    def span(self, name, **labels):
        """Record a wall-clock span; nest for tree structure (the event's
        ``path`` is the '/'-joined stack).  Opens
        ``torch.profiler.record_function(name)`` when torch is already
        imported, and never imports it."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append(name)
        path = "/".join(stack)
        torch = sys.modules.get("torch")
        scope = (torch.profiler.record_function(name) if torch is not None
                 else contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with scope:
                yield
        finally:
            dt = time.perf_counter() - t0
            stack.pop()
            self.emit("span", name=name, path=path, seconds=round(dt, 6),
                      **labels)

    # -- run lifecycle -------------------------------------------------
    def configure(self, run_dir, config=None, argv=None):
        """Point the registry at a run directory and capture the start
        of the run manifest.  Nothing is written until :meth:`finalize`
        (the CLI's ``--output`` is replaced by the model save, so writing
        into it earlier would be lost)."""
        from tpu_als_torch.obs.manifest import build_manifest

        with self._lock:
            self._run_dir = run_dir
            self._manifest = build_manifest(config=config, argv=argv)

    def active(self):
        return self._run_dir is not None

    def deconfigure(self):
        """Detach the run directory (the accumulated state stays)."""
        with self._lock:
            self._run_dir = None
            self._manifest = None

    def update_manifest(self, **fields):
        with self._lock:
            if self._manifest is not None:
                self._manifest.update(fields)

    def snapshot(self):
        """Registry state as plain JSON-ready dicts."""
        with self._lock:
            return {
                "counters": {n + _render_labels(lk): v
                             for (n, lk), v in sorted(self._counters.items())},
                "gauges": {n + _render_labels(lk): v
                           for (n, lk), v in sorted(self._gauges.items())},
                "histograms": {n + _render_labels(lk): h.state()
                               for (n, lk), h in sorted(self._hists.items())},
            }

    def prometheus_text(self):
        """Prometheus text exposition of the whole registry (names
        prefixed ``tpu_als_``, dots to underscores, counters suffixed
        ``_total``, histograms as cumulative ``le`` buckets with
        ``+Inf``, ``_sum`` and ``_count``)."""
        with self._lock:
            series = {}
            for (n, lk), v in self._counters.items():
                series.setdefault((n, "counter"), []).append((lk, v))
            for (n, lk), v in self._gauges.items():
                series.setdefault((n, "gauge"), []).append((lk, v))
            for (n, lk), h in self._hists.items():
                series.setdefault((n, "histogram"), []).append(
                    (lk, (list(h.counts), h.sum, h.count)))
        out = []
        for (n, kind), rows in sorted(series.items()):
            pn = _prom_name(n) + ("_total" if kind == "counter" else "")
            out.append(f"# HELP {pn} {schema.METRICS[n][2]}")
            out.append(f"# TYPE {pn} {kind}")
            for lk, v in sorted(rows):
                if kind != "histogram":
                    out.append(f"{pn}{_render_labels(lk)} {_fmt(v)}")
                    continue
                counts, hsum, count = v
                acc = 0
                for bound, c in zip(BUCKET_BOUNDS, counts):
                    acc += c
                    lab = _render_labels(lk + (("le", _fmt(bound)),))
                    out.append(f"{pn}_bucket{lab} {acc}")
                lab = _render_labels(lk + (("le", "+Inf"),))
                out.append(f"{pn}_bucket{lab} {count}")
                out.append(f"{pn}_sum{_render_labels(lk)} {_fmt(hsum)}")
                out.append(f"{pn}_count{_render_labels(lk)} {count}")
        return "\n".join(out) + "\n"

    def finalize(self):
        """Drain the registry to the configured run directory: append the
        new events (and a final ``snapshot``) to ``events.jsonl``,
        rewrite ``metrics.prom`` and ``run_manifest.json``.  A second call
        appends only the events recorded since the first; a full
        ``events.jsonl`` rotates first (:func:`maybe_rotate`).  Returns
        the run directory, or None when none is configured.  Across
        processes only process 0 writes."""
        with self._lock:
            run_dir = self._run_dir
        if run_dir is None:
            return None
        # across processes only process 0 writes (the peers share the
        # directory); read through sys.modules, so nothing is imported
        mh = sys.modules.get("tpu_als_torch.parallel.multihost")
        if mh is not None and mh.process_count() > 1 \
                and mh.process_index() != 0:
            return None
        snap = self.snapshot()
        if self._dropped:
            snap["events_dropped"] = self._dropped
        self.emit("snapshot", **snap)
        os.makedirs(run_dir, exist_ok=True)
        with self._lock:
            pending = self._events[self._flushed:]
            self._flushed = len(self._events)
            manifest = dict(self._manifest or {})
        from tpu_als_torch.obs.manifest import late_device_info

        manifest["finished_at"] = round(time.time(), 6)
        manifest.update(late_device_info())
        maybe_rotate(run_dir)
        with open(os.path.join(run_dir, "events.jsonl"), "a") as f:
            for ev in pending:
                f.write(json.dumps(ev) + "\n")
        with open(os.path.join(run_dir, "metrics.prom"), "w") as f:
            f.write(self.prometheus_text())
        with open(os.path.join(run_dir, "run_manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
        return run_dir
