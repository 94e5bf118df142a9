"""``tpu_als_torch.obs`` — the port's metrics registry and run sinks.

Counterpart of ``tpu_als/obs/__init__.py`` (stdlib only).  The
instrumented paths (guardrails, fault points, retry, checkpoints, the
fold-in server, the serving engine) write through the module-level
default registry:

    from tpu_als_torch import obs

    with obs.span("serve_bench.warmup"):
        ...
    obs.counter("train.rollbacks", 1)
    obs.histogram("serving.e2e_seconds", dt)
    obs.gauge("serving.queue_depth", depth)
    obs.histogram_quantile("serving.e2e_seconds", 0.99)

    obs.configure(run_dir)      # start of a run (the CLI's --output)
    obs.finalize()              # events.jsonl, metrics.prom,
                                # run_manifest.json into run_dir

Until ``finalize`` everything is in-memory bookkeeping, bounded, so
library use and the tests need no run directory.  Causal tracing is
:mod:`tpu_als_torch.obs.tracing`, the serving flight recorder and the
fenced training stages :mod:`tpu_als_torch.obs.trace`, the run
directory's readers (``observe summarize|tail|explain``)
:mod:`tpu_als_torch.obs.report` and :mod:`tpu_als_torch.obs.explain`,
and the bench regression gate (``observe regress``)
:mod:`tpu_als_torch.obs.regress`.
"""

from __future__ import annotations

from tpu_als_torch.obs import schema  # noqa: F401
from tpu_als_torch.obs.metrics import (BUCKET_BOUNDS,  # noqa: F401
                                       MetricsRegistry)

_default = MetricsRegistry()


def default_registry():
    return _default


def reset():
    """Replace the default registry with a fresh one (tests)."""
    global _default
    _default = MetricsRegistry()
    return _default


def counter(name, value=1, **labels):
    _default.counter(name, value, **labels)


def gauge(name, value, **labels):
    _default.gauge(name, value, **labels)


def histogram(name, value, **labels):
    _default.histogram(name, value, **labels)


def histogram_quantile(name, q, **labels):
    return _default.histogram_quantile(name, q, **labels)


def histogram_count(name, **labels):
    return _default.histogram_count(name, **labels)


def counter_value(name, **labels):
    return _default.counter_value(name, **labels)


def emit(etype, **fields):
    return _default.emit(etype, **fields)


def events(etype=None):
    return _default.events(etype)


def span(name, **labels):
    return _default.span(name, **labels)


def configure(run_dir, config=None, argv=None):
    _default.configure(run_dir, config=config, argv=argv)


def active():
    return _default.active()


def deconfigure():
    _default.deconfigure()


def update_manifest(**fields):
    _default.update_manifest(**fields)


def snapshot():
    return _default.snapshot()


def prometheus_text():
    return _default.prometheus_text()


def finalize():
    return _default.finalize()
