"""Process-wide metrics registry and the JSONL/Prometheus sinks.

Counterpart of ``tpu_als/obs/metrics.py`` (stdlib only): one in-process
registry that the instrumented paths write to with dict operations under
one lock, and that a run drains to disk once, at :meth:`finalize`:

- ``events.jsonl``      — the append-only event log (guardrail trips,
  rollbacks, quarantines, fault firings, a final ``snapshot``),
- ``metrics.prom``      — the Prometheus text exposition of the counters,
- ``run_manifest.json`` — config, versions, git, device
  (:mod:`tpu_als_torch.obs.manifest`).

Names are checked against :mod:`tpu_als_torch.obs.schema` when written.
The port's metrics are all counters so far; the reference's gauges and
fixed-bucket histograms arrive with the first metric of their kind (its
serving rows), and its rotation of long event logs, its spans and its
device-trace scopes are not ported.
"""

from __future__ import annotations

import json
import os
import threading
import time

from tpu_als_torch.obs import schema

# in-memory event cap: a registry that is never finalized (library use,
# the tests) must not grow without bound; finalize() reports the drops
_MAX_EVENTS = 100_000


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


class MetricsRegistry:
    """Counters and events under one lock; nothing touches the
    filesystem until :meth:`finalize`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters = {}     # (name, labels_key) -> float
        self._events = []
        self._dropped = 0
        self._flushed = 0       # events already written to disk
        self._run_dir = None
        self._manifest = None

    # -- instruments ---------------------------------------------------
    def counter(self, name, value=1, **labels):
        schema.check_metric(name, "counter")
        schema.check_labels(name, labels)
        key = (name, _labels_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + value

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

    def deconfigure(self):
        """Detach the run directory (the accumulated state stays)."""
        with self._lock:
            self._run_dir = None
            self._manifest = None

    def snapshot(self):
        """Registry state as plain JSON-ready dicts (the reference's
        layout: no gauge or histogram is declared yet)."""
        with self._lock:
            return {
                "counters": {n + _render_labels(lk): v
                             for (n, lk), v in sorted(self._counters.items())},
                "gauges": {}, "histograms": {}}

    def prometheus_text(self):
        """Prometheus text exposition of the counters (names prefixed
        ``tpu_als_``, dots to underscores, suffixed ``_total``)."""
        with self._lock:
            counters = sorted(self._counters.items())
        out, seen = [], set()
        for (n, lk), v in counters:
            pn = _prom_name(n) + "_total"
            if n not in seen:
                seen.add(n)
                out.append(f"# HELP {pn} {schema.METRICS[n][2]}")
                out.append(f"# TYPE {pn} counter")
            out.append(f"{pn}{_render_labels(lk)} {_fmt(v)}")
        return "\n".join(out) + "\n"

    def finalize(self):
        """Drain the registry to the configured run directory: append the
        new events (and a final ``snapshot``) to ``events.jsonl``,
        rewrite ``metrics.prom`` and ``run_manifest.json``.  A second call
        appends only the events recorded since the first.  Returns the
        run directory, or None when none is configured."""
        with self._lock:
            run_dir = self._run_dir
        if run_dir is None:
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
        with open(os.path.join(run_dir, "events.jsonl"), "a") as f:
            for ev in pending:
                f.write(json.dumps(ev) + "\n")
        with open(os.path.join(run_dir, "metrics.prom"), "w") as f:
            f.write(self.prometheus_text())
        with open(os.path.join(run_dir, "run_manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
        return run_dir
