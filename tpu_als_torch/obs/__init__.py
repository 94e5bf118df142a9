"""``tpu_als_torch.obs`` — the port's metrics registry and run sinks.

Counterpart of ``tpu_als/obs/__init__.py`` (stdlib only).  The
guardrails, the fault points, the retry helper and the estimator's
quarantine write through the module-level default registry:

    from tpu_als_torch import obs

    obs.counter("train.rollbacks", 1)
    obs.emit("guardrail_tripped", iteration=2, sentinel="nonfinite",
             mode="warn")
    obs.counter_value("train.rollbacks")

    obs.configure(run_dir)      # start of a run (the CLI's --output)
    obs.finalize()              # events.jsonl, metrics.prom,
                                # run_manifest.json into run_dir

Until ``finalize`` everything is in-memory bookkeeping, bounded, so
library use and the tests need no run directory.  The reference's
spans and tracing, ``regress``, ``explain`` and report are not ported yet.
"""

from __future__ import annotations

from tpu_als_torch.obs import schema  # noqa: F401
from tpu_als_torch.obs.metrics import MetricsRegistry  # noqa: F401

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


def counter_value(name, **labels):
    return _default.counter_value(name, **labels)


def emit(etype, **fields):
    return _default.emit(etype, **fields)


def events(etype=None):
    return _default.events(etype)


def configure(run_dir, config=None, argv=None):
    _default.configure(run_dir, config=config, argv=argv)


def deconfigure():
    _default.deconfigure()


def finalize():
    return _default.finalize()
