"""Elastic mesh training: the loss of a shard becomes a rescheduling event.

Counterpart of ``tpu_als/resilience/elastic.py``.  A failed step of the
sharded trainer is classified instead of aborting the run:

1. **Detect**: :func:`wrap_step` (installed by
   ``parallel.trainer.train_sharded(elastic=True)``) catches the step's
   failure on the host, around the step, which it leaves unchanged.
2. **Classify**: :func:`classify` probes every shard of the mesh under a
   bounded :mod:`tpu_als_torch.resilience.retry` backoff.  A shard that
   fails every probe attempt is dead (``RetryExhausted``); a failure with
   every shard healthy is transient and retried in place, at most
   ``max_transient`` times.
3. **Reschedule**: a dead shard surfaces as :class:`DeviceLost`, which
   ``api.fitting.fit_sharded`` turns into a mesh re-formed on the
   survivors (their logical ids kept), resumed from the last checkpoint.

Shards are addressed by their logical ids (``parallel.mesh.Mesh.ids``):
on one card every shard has the same device, so the id is what a loss
names.  The probe (:func:`_probe_device`) is a round trip on the shard's
device, ``torch.ones(8).sum()`` read back and compared with 8.

Deterministic injection: the ``mesh.device_lost`` fault point.
``corrupt`` kills a shard: the victim (``TPU_ALS_LOST_DEVICE``, a mesh
position, by default the last) is marked lost in this module's
registry, so the probe confirms a dead shard; ``raise`` injects a step
failure with every shard healthy, the transient path.  Tests mark and
clear losses directly (:func:`mark_lost`, :func:`clear_lost`).

One deliberate divergence from the reference: its failure types
(``_step_failure_types``) add JAX's runtime errors, what a dead TPU peer
raises.  Here they are only ``InjectedFault``, :class:`ProbeFailed` and
``OSError``.  A CUDA error or any other ``RuntimeError`` raised inside a
step propagates as it is: it is not probed, not retried and not turned
into :class:`DeviceLost`, since catching it would hide a kernel failure
behind a rescheduling event.
"""

from __future__ import annotations

import os
import threading

from tpu_als_torch import obs
from tpu_als_torch.resilience import faults
from tpu_als_torch.resilience.retry import (
    RetryExhausted,
    RetryPolicy,
    retry_call,
)

#: the mesh position ``mesh.device_lost`` corrupt mode kills; default:
#: the last shard
ENV_LOST_DEVICE = "TPU_ALS_LOST_DEVICE"

FAULT_POINT = "mesh.device_lost"


class DeviceLost(RuntimeError):
    """A shard is dead: the probe exhausted its retries on the named
    logical ids.  The elastic fit re-forms the mesh on the survivors;
    without elastic training it propagates."""

    def __init__(self, lost, surviving=None, iteration=None):
        self.lost = tuple(int(d) for d in lost)
        self.surviving = surviving
        self.iteration = iteration
        super().__init__(
            f"device(s) {list(self.lost)} unreachable after probe "
            f"retries exhausted; {surviving} device(s) surviving")


class ProbeFailed(OSError):
    """One probe attempt against one shard failed.  An ``OSError``, so the
    retry policy counts it as transient: only a whole budget of failed
    probes (``RetryExhausted``) marks the shard dead."""


# -- the simulated-loss registry (logical ids) -------------------------------

_lost = set()
_lock = threading.Lock()


def mark_lost(*device_ids):
    """Mark logical shard ids as dead for the probe."""
    with _lock:
        _lost.update(int(d) for d in device_ids)


def lost_devices():
    """The simulated-lost logical ids, frozen."""
    with _lock:
        return frozenset(_lost)


def clear_lost():
    """Forget every simulated loss."""
    with _lock:
        _lost.clear()


def _victim_index(n_devices, environ=None):
    """The mesh position corrupt mode kills: ``TPU_ALS_LOST_DEVICE``,
    validated, by default the last position."""
    raw = (environ if environ is not None else os.environ).get(
        ENV_LOST_DEVICE)
    if not raw:
        return n_devices - 1
    try:
        idx = int(raw)
    except ValueError:
        raise ValueError(
            f"{ENV_LOST_DEVICE}={raw!r} is not an integer mesh "
            "position") from None
    if not 0 <= idx < n_devices:
        raise ValueError(
            f"{ENV_LOST_DEVICE}={idx} out of range for a "
            f"{n_devices}-device mesh")
    return idx


# -- the probe ---------------------------------------------------------------


def default_probe_policy():
    """A few fast attempts per shard: what separates a hiccup from a dead
    shard (the reference's policy)."""
    return RetryPolicy(max_attempts=3, base_delay=0.01, factor=2.0,
                       max_delay=0.25, jitter=0.25,
                       retry_on=(OSError, TimeoutError))


def _probe_device(shard):
    """One probe attempt on ``shard`` (a ``parallel.mesh.Shard``): a
    shard marked lost fails; otherwise ``torch.ones(8).sum()`` on its
    device must read back 8, and anything else raises the retryable
    :class:`ProbeFailed`."""
    if int(shard.id) in lost_devices():
        raise ProbeFailed(f"device {int(shard.id)} is marked lost")
    import torch

    try:
        ok = torch.ones(8, device=shard.device).sum().item() == 8.0
    except Exception as e:  # noqa: BLE001 - any failure is the signal
        raise ProbeFailed(
            f"device {int(shard.id)} probe raised "
            f"{type(e).__name__}: {e}") from e
    if not ok:
        raise ProbeFailed(
            f"device {int(shard.id)} returned a wrong probe value")


def classify(shards, policy=None):
    """Probe every shard (``parallel.mesh.Shard``, e.g. ``mesh.shards``);
    returns the tuple of dead logical ids (empty: the failure was
    transient).  Each shard gets the policy's whole retry budget."""
    shards = tuple(shards)
    policy = policy or default_probe_policy()
    dead = []
    with obs.span("elastic.probe", devices=len(shards)):
        for s in shards:
            try:
                retry_call(_probe_device, s, policy=policy,
                           what=f"elastic.probe:d{int(s.id)}")
            except RetryExhausted:
                dead.append(int(s.id))
    return tuple(dead)


def surviving_devices(mesh):
    """The mesh's shards minus the lost ones, in mesh order, their
    logical ids kept: what the re-formed mesh is built from."""
    lost = lost_devices()
    return [s for s in mesh.shards if int(s.id) not in lost]


# -- the detector ------------------------------------------------------------


def _step_failure_types():
    """What a failed step may raise and still be probed: the injected
    fault, a failed probe, and OS errors.  No ``RuntimeError`` (see the
    module docstring)."""
    return (faults.InjectedFault, ProbeFailed, OSError)


def wrap_step(step, mesh, policy=None, max_transient=2):
    """The host-level elastic detector around a training step.

    Fires the ``mesh.device_lost`` fault point before each step (corrupt:
    kill the victim shard and fail the step; raise: a transient failure
    with every shard healthy), then classifies a failure of the types
    :func:`_step_failure_types` names: dead shards raise
    :class:`DeviceLost`; a transient failure is retried in place up to
    ``max_transient`` times with the probe policy's backoff."""
    shards = mesh.shards
    policy = policy or default_probe_policy()
    failure_types = _step_failure_types()

    def elastic_step(U, V, *args):
        transient = 0
        while True:
            try:
                mode = faults.check("mesh.device_lost")
                if mode == "corrupt":
                    victim = shards[_victim_index(len(shards))]
                    mark_lost(int(victim.id))
                    raise ProbeFailed(
                        f"collective failed: peer {int(victim.id)} "
                        "unreachable (injected device loss)")
                return step(U, V, *args)
            except failure_types as e:
                with obs.span("elastic.classify"):
                    dead = classify(shards, policy=policy)
                if dead:
                    raise DeviceLost(
                        dead, surviving=len(shards) - len(dead)) from e
                transient += 1
                obs.emit("warning", what="elastic.transient",
                         reason=f"step failure with all peers healthy "
                                f"(attempt {transient}/{max_transient}):"
                                f" {type(e).__name__}: {e}")
                if transient > max_transient:
                    raise
                policy.sleep(policy.delay(transient - 1))

    return elastic_step
