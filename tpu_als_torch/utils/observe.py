"""Observability of a fit: structured per-iteration logs and the profiler.

Counterpart of ``tpu_als/utils/observe.py``:

- :class:`IterationLogger` — a ``callback`` for the training loops that
  writes one JSON line per iteration (iteration, wall time, probe RMSE,
  factor norms) to a file and/or stderr.  The port's loops hand it the
  factors as tensors on the device; it brings them to the host and runs
  the reference's numpy arithmetic on them, so on equal factors every
  field but the two times is the reference's.
- :func:`trace` — a context manager over ``torch.profiler.profile`` (CPU
  and, when a CUDA device is visible, CUDA activities) that writes a
  Chrome/Perfetto trace of the block under ``logdir``, the counterpart
  of the reference's ``jax.profiler`` trace.  The spans of
  :mod:`tpu_als_torch.obs` open ``torch.profiler.record_function`` with
  their names, so the trace carries ``train.fit`` and the other phases
  around the kernels they launched.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import numpy as np


def _host(X):
    """A factor table as a numpy array (a tensor on any device, or an
    array)."""
    if hasattr(X, "detach"):
        return X.detach().cpu().numpy()
    return np.asarray(X)


class IterationLogger:
    """Per-iteration structured logging; usable as ``train(callback=...)``
    or ``ALS(fitCallback=...)``.

    probe: optional (u_idx, i_idx, ratings) triple of dense indices —
    RMSE on it is logged each iteration.

    Usable as a context manager (``with IterationLogger(path=p) as log:``);
    the file is opened lazily on the first record, so a logger that never
    fires touches no file.
    """

    def __init__(self, probe=None, stream=sys.stderr, path=None, tag="als"):
        self.probe = probe
        self.stream = stream
        self.path = path
        self.tag = tag
        self._t_last = self._t0 = time.perf_counter()
        self._file = None
        self._closed = False
        self.records = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __call__(self, iteration, U, V):
        now = time.perf_counter()
        U, V = _host(U), _host(V)
        rec = {
            "tag": self.tag,
            "iteration": int(iteration),
            "seconds": round(now - self._t_last, 4),
            "total_seconds": round(now - self._t0, 4),
            "u_norm": float(np.linalg.norm(U) / max(1, U.shape[0]) ** 0.5),
            "v_norm": float(np.linalg.norm(V) / max(1, V.shape[0]) ** 0.5),
        }
        self._t_last = now
        if self.probe is not None:
            u, i, r = self.probe
            pred = np.einsum("nr,nr->n", U[u], V[i])
            rec["probe_rmse"] = float(np.sqrt(np.mean((pred - r) ** 2)))
        self.records.append(rec)
        line = json.dumps(rec)
        if self.stream is not None:
            print(line, file=self.stream, flush=True)
        if self.path is not None and not self._closed:
            if self._file is None:
                self._file = open(self.path, "a")
            self._file.write(line + "\n")
            self._file.flush()

    def close(self):
        if self._closed:
            return
        self._closed = True
        if self._file is not None:
            self._file.close()
            self._file = None


_trace_active = False


def _trace_warn(what, reason):
    """Record a degraded-profiling condition without stopping the run: one
    ``warning`` event and a stderr line."""
    from tpu_als_torch import obs

    obs.emit("warning", what=what, reason=str(reason))
    print(f"observe.trace: {what}: {reason}", file=sys.stderr)


def _start_profiler():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(prof, logdir):
    """Stop ``prof`` and write its Chrome trace under ``logdir``; returns
    the file's path."""
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir):
    """Profile a block into ``logdir`` (a ``trace_<pid>_<ns>.json``
    Chrome/Perfetto trace): ``with observe.trace('/tmp/trace'): fit()``.

    Degrades to a no-op, with a ``warning`` event, instead of raising
    when a trace is already active in this process (``trace_skipped``)
    or the profiler cannot start (``trace_unavailable``); a failure to
    stop or write it is ``trace_stop_failed``.  The block's own
    exceptions propagate.
    """
    global _trace_active

    if _trace_active:
        _trace_warn("trace_skipped",
                    "a profiler trace is already active in this process")
        yield
        return
    # a failed profiling request must not stop the run it observes
    try:
        prof = _start_profiler()
    except Exception as err:  # noqa: BLE001
        _trace_warn("trace_unavailable", err)
        yield
        return
    _trace_active = True
    try:
        yield
    finally:
        _trace_active = False
        try:
            _stop_profiler(prof, logdir)
        except Exception as err:  # noqa: BLE001
            _trace_warn("trace_stop_failed", err)
