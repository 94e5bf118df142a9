"""Fair-share admission front door: one scheduler, N tenant engines.

Counterpart of ``tpu_als/tenancy/scheduler.py``.  Rather than N serving
threads racing for the device, the :class:`MultiTenantEngine` runs ONE
scheduler thread over every tenant's queue and makes the sharing policy
explicit:

- **Stride (weighted fair-share) scheduling.**  Each tenant carries a
  virtual time advanced by ``served_rows / weight`` whenever one of its
  micro-batches is scored; the backlogged tenant with the least virtual
  time is served next.  Under contention a tenant's share of served rows
  converges to ``weight / sum(weights)``.
- **Typed per-tenant shedding.**  Admission rides each tenant's own
  bounded batcher; at capacity the submit raises
  :class:`TenantOverloaded` (an ``Overloaded`` naming the tenant).
- **Fault isolation per batch.**  A tenant batch that raises fails only
  that batch's tickets and counts ``tenancy.batch_errors{tenant=...}``;
  the round goes on with the next tenant.  A batch error that is not an
  injected fault is also a ``warning`` event with
  ``what="tenancy.batch"``, which ``chip_smoke.py`` counts.
- **Lazy virtual-time admission.**  A tenant that joins, or returns from
  idle, starts at the current virtual clock, not at zero.
"""

from __future__ import annotations

import threading

from tpu_als_torch import obs
from tpu_als_torch.obs import tracing
from tpu_als_torch.resilience import faults
from tpu_als_torch.serving.batcher import Overloaded
from tpu_als_torch.tenancy.registry import TenantRegistry, TenantSpec
from tpu_als_torch.utils.platform import resolve_device

__all__ = ["FairShareScheduler", "MultiTenantEngine", "TenantOverloaded"]


class TenantOverloaded(Overloaded):
    """One tenant's admission queue is at capacity; ``tenant`` names it,
    so load balancers shed per tenant, not per process."""

    def __init__(self, tenant, message):
        self.tenant = tenant
        super().__init__(f"tenant {tenant!r}: {message}")


class FairShareScheduler:
    """Stride scheduling over the registry's tenants.

    Pure policy, no threads: :meth:`pick` selects the backlogged tenant
    with the least virtual time (ties break by name); :meth:`charge`
    advances the served tenant's clock by ``rows / weight``.  Virtual
    times live on the :class:`Tenant` records; the scheduler carries only
    the global virtual clock and the tenants active in the last round.
    """

    def __init__(self):
        self._clock = 0.0
        self._active = set()

    def pick(self, backlogged):
        """The next tenant to serve among ``backlogged`` (non-empty).  A
        tenant entering the rotation is floored to the global virtual
        clock first; tenants that stayed in the rotation keep their
        earned deficit."""
        for t in backlogged:
            if t.name not in self._active and t.vtime < self._clock:
                t.vtime = self._clock
        self._active = {t.name for t in backlogged}
        chosen = min(backlogged, key=lambda t: (t.vtime, t.name))
        self._clock = max(self._clock, chosen.vtime)
        return chosen

    def charge(self, tenant, rows):
        tenant.vtime += rows / tenant.spec.weight
        tenant.served_rows += rows
        obs.counter("tenancy.served_rows", rows, tenant=tenant.name)


class MultiTenantEngine:
    """Many models behind one admission front door.

    ``submit``/``recommend`` take the tenant name first; publishes and
    live updates go to the named tenant's own engine or updater.  One
    scheduler thread drives every tenant's batcher through
    :class:`FairShareScheduler`; each batch is served by the tenant's
    ``ServingEngine.serve_batch``, unchanged.  ``device``: where every
    tenant serves (None -> the card, raising without CUDA), or the
    ``registry``'s device when one is given.
    """

    def __init__(self, registry=None, idle_wait_s=0.05, device=None):
        if registry is None:
            registry = TenantRegistry(device=device)
        elif device is not None and \
                resolve_device(device) != registry.device:
            raise ValueError(f"device {device} is not the registry's "
                             f"{registry.device}")
        self.registry = registry
        self.device = registry.device
        self.scheduler = FairShareScheduler()
        self.idle_wait_s = float(idle_wait_s)
        self._round = 0      # monotonic fair-share pick counter (traced)
        self._work = threading.Event()
        self._stopping = threading.Event()
        self._thread = None

    # -- tenant lifecycle ---------------------------------------------
    def add_tenant(self, spec, U, V, **publish_kwargs):
        """Register a tenant (:meth:`TenantRegistry.register`); ``spec``
        may be a :class:`TenantSpec` or a plain name."""
        if isinstance(spec, str):
            spec = TenantSpec(name=spec)
        return self.registry.register(spec, U, V, **publish_kwargs)

    def remove_tenant(self, name):
        return self.registry.remove(name)

    def attach_live(self, name, foldin, **updater_kwargs):
        """Attach and START the tenant's live fold-in pipeline."""
        updater = self.registry.attach_live(name, foldin, **updater_kwargs)
        updater.start()
        return updater

    def tenant(self, name):
        return self.registry.get(name)

    # -- per-tenant model lifecycle -----------------------------------
    def publish(self, name, U, V, **kwargs):
        """Atomic publish into ONE tenant's sequence."""
        return self.registry.get(name).engine.publish(U, V, **kwargs)

    def publish_update(self, name, U, V, **kwargs):
        """Incremental (fold-in) publish into one tenant's sequence;
        returns ``(seq, mode)``."""
        return self.registry.get(name).engine.publish_update(U, V, **kwargs)

    def published_seq(self, name):
        return self.registry.get(name).engine.published_seq

    def warmup(self, name=None):
        """Run each tenant's (bucket, route) pairs once (one tenant, or
        all): the kernels are built and loaded by the first."""
        tenants = ([self.registry.get(name)] if name is not None
                   else self.registry.tenants())
        for t in tenants:
            t.engine.warmup()

    # -- request path -------------------------------------------------
    def submit(self, name, payload, k=None, deadline_s=None):
        """Admit one request for ``name``; returns its ticket.  Raises
        :class:`UnknownTenant` for an unregistered name and
        :class:`TenantOverloaded` when THAT tenant's queue is full."""
        tenant = self.registry.get(name)
        try:
            ticket = tenant.engine.submit(payload, k=k,
                                          deadline_s=deadline_s)
        except Overloaded as e:
            raise TenantOverloaded(name, str(e)) from None
        self._work.set()
        return ticket

    def recommend(self, name, payload, k=None, deadline_s=None,
                  timeout=None):
        """Submit + block: ``(scores, indices)`` for one request."""
        return self.submit(name, payload, k=k,
                           deadline_s=deadline_s).result(timeout)

    # -- scheduler loop -----------------------------------------------
    def start(self):
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._stopping.clear()
        self._thread = threading.Thread(
            target=self._run, name="tpu-als-torch-tenancy", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain_timeout_s=10.0):
        """Stop every tenant's updater, close every admission queue,
        drain in-flight batches, join the scheduler."""
        for t in self.registry.tenants():
            if t.updater is not None:
                t.updater.stop()
            t.engine.batcher.close()
        self._stopping.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join(drain_timeout_s)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _backlogged(self):
        return [t for t in self.registry.tenants()
                if t.engine.batcher.depth() > 0]

    def _run(self):
        while True:
            served = self._drain_round()
            if not served:
                if self._stopping.is_set() and not self._backlogged():
                    return
                self._work.wait(self.idle_wait_s)
                self._work.clear()

    def _drain_round(self):
        """Serve until every queue is empty, one fair-share pick per
        micro-batch.  Returns whether anything was served."""
        served_any = False
        while True:
            backlogged = self._backlogged()
            if not backlogged:
                return served_any
            tenant = self.scheduler.pick(backlogged)
            # timeout=0: depth was > 0 just now; a race to empty returns
            # None and the round re-checks the backlog
            batch = tenant.engine.batcher.next_batch(timeout=0)
            if not batch:
                continue
            served_any = True
            # link each ticket's trail to the pick that drained it
            self._round += 1
            for t in batch:
                if t.trace is not None:
                    t.trace = tracing.record_span(
                        t.trace, "tenancy.round", round=self._round,
                        batch_rows=len(batch))
            try:
                tenant.engine.serve_batch(batch)
            except BaseException as e:  # noqa: BLE001 — isolate the tenant
                # the single engine's loop contract, scoped to ONE tenant:
                # its undone tickets fail, the error is counted against
                # it, and the round moves on
                for t in batch:
                    if not t.done():
                        t.fail(e)
                        if t.trace is not None:
                            t.trace = tracing.record_span(
                                t.trace, "serve.score", status="failed",
                                error=type(e).__name__)
                        tenant.engine.flight.record(
                            "failed",
                            {"admission": t.t_admit,
                             "queue_wait": (t.t_dequeue - t.t_submit
                                            if t.t_dequeue else None)},
                            error=type(e).__name__,
                            trace_id=(t.trace.trace_id
                                      if t.trace is not None else None))
                obs.counter("tenancy.batch_errors", tenant=tenant.name)
                if not isinstance(e, faults.InjectedFault):
                    obs.emit("warning", what="tenancy.batch",
                             reason=f"tenant {tenant.name!r}: "
                                    f"{type(e).__name__}: {e}")
            self.scheduler.charge(tenant, len(batch))
