"""Tenant registry: N independent model universes in one process.

Counterpart of ``tpu_als/tenancy/registry.py``.  Each registered tenant
owns the whole single-tenant serving stack: its own
:class:`~tpu_als_torch.serving.engine.ServingEngine` (factors, int8
candidate index, admission queue, flight recorder, SLO) and optionally
its own fold-in server and :class:`~tpu_als_torch.live.LiveUpdater`.  So:

- **Publish sequences are per tenant.**  They live on the tenant's
  engine; tenant A's torn publish can mark only A's index stale.
- **Budgets are per tenant.**  Queue depth, coalescing window, deadlines
  and the latency SLO are knobs of the tenant's own engine; one tenant's
  overload raises :class:`~tpu_als_torch.tenancy.scheduler.
  TenantOverloaded` naming it and sheds only its requests.
- **Obs is attributable.**  The engine and updater are built with
  ``tenant=<name>``, so every ``serving.*``/``live.*`` series, publish
  and live-update event and flight-recorder dump carries the tenant.

What is shared is the plan (``plan.resolve_tenant_plan`` keys on the
shapes, not the name) and the device: every tenant of a registry serves
on the registry's ``device``, the card unless the caller passes
``device='cpu'``.  The port builds no program per shape, so same-shaped
tenants share the loaded kernels rather than compiled executables.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from tpu_als_torch import obs
from tpu_als_torch.utils.platform import resolve_device

# tenant names become metric label values and event fields: a slug
_NAME_RE = re.compile(r"^[a-z0-9][a-z0-9_-]{0,31}$")

GUARDRAIL_MODES = ("off", "abort", "recover")


class TenancyError(RuntimeError):
    """Base class for control-plane failures."""


class UnknownTenant(TenancyError):
    """An operation named a tenant nobody registered; ``available`` lists
    those that are, in registration order."""

    def __init__(self, name, available):
        self.name = name
        self.available = tuple(available)
        super().__init__(
            f"unknown tenant {name!r} (registered: "
            f"{', '.join(self.available) or '<none>'})")


class DuplicateTenant(TenancyError):
    """``register`` was called twice for one name: replacing a live
    engine would strand its in-flight tickets."""

    def __init__(self, name):
        self.name = name
        super().__init__(f"tenant {name!r} is already registered "
                         "(remove it first)")


@dataclass(frozen=True)
class TenantSpec:
    """Declarative per-tenant serving contract.

    ``weight`` is the fair-share weight (a weight-2 tenant is entitled to
    twice the served rows of a weight-1 tenant under contention); the
    queue, deadline and SLO fields are the tenant's own admission
    budgets.  ``buckets=None`` resolves through
    ``plan.resolve_tenant_plan``.  ``guardrail_mode`` is the posture the
    tenant's re-fits run under (``resilience.guardrails.scoped``).
    """

    name: str
    weight: float = 1.0
    k: int = 10
    shortlist_k: int = 64
    buckets: tuple = None
    max_queue: int = 1024
    max_wait_s: float = 0.002
    default_deadline_s: float = None
    slo_s: float = None
    freshness_slo_s: float = None
    fold_items: bool = False
    guardrail_mode: str = "abort"
    flight_capacity: int = 64

    def __post_init__(self):
        if not _NAME_RE.match(self.name or ""):
            raise ValueError(
                f"tenant name {self.name!r} must match "
                f"{_NAME_RE.pattern} (it becomes a metric label value)")
        if not self.weight > 0:
            raise ValueError(f"tenant {self.name!r}: weight must be "
                             f"> 0, got {self.weight}")
        if self.guardrail_mode not in GUARDRAIL_MODES:
            raise ValueError(
                f"tenant {self.name!r}: guardrail_mode "
                f"{self.guardrail_mode!r} not in {GUARDRAIL_MODES}")


@dataclass
class Tenant:
    """One admitted tenant: its spec, its engine, and (with live updates
    attached) its fold-in pipeline.  ``shape_class`` is the plan's
    bucketing of its sizes."""

    spec: TenantSpec
    engine: object
    shape_class: str = "generic"
    foldin: object = None
    updater: object = None
    served_rows: int = 0            # scheduler-maintained goodput
    vtime: float = field(default=0.0, repr=False)   # fair-share clock

    @property
    def name(self):
        return self.spec.name


class TenantRegistry:
    """The control plane's source of truth: name -> :class:`Tenant`.

    ``register`` builds the tenant's engine (tenant-labeled) on the
    registry's device, resolves its plan, and performs the tenant's
    FIRST publish; a tenant is never registered without a servable
    model.  Thread-safe; the scheduler iterates a snapshot.
    ``device``: None -> the card (raises without CUDA); ``'cpu'`` runs
    the kernels' plain versions.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._tenants = {}
        self._reserved = set()
        self._lock = threading.Lock()

    # -- membership ---------------------------------------------------
    def register(self, spec, U, V, *, item_valid=None, quantize=True):
        """Admit one tenant and publish its initial factors (numpy arrays
        or tensors).  Returns the :class:`Tenant`.  Raises
        :class:`DuplicateTenant` on a name collision.

        The name is only *reserved* while the engine is built and its
        first generation published; the tenant enters the registry after
        the publish succeeds, and a failed publish leaves nothing behind
        but a released reservation."""
        from tpu_als_torch import plan as _plan
        from tpu_als_torch.serving.engine import ServingEngine

        with self._lock:
            if spec.name in self._tenants or spec.name in self._reserved:
                raise DuplicateTenant(spec.name)
            self._reserved.add(spec.name)
        engine = None
        try:
            if not isinstance(U, torch.Tensor):
                U = np.asarray(U, dtype=np.float32)
            if not isinstance(V, torch.Tensor):
                V = np.asarray(V, dtype=np.float32)
            tplan = _plan.resolve_tenant_plan(
                rank=U.shape[1], n_users=U.shape[0], n_items=V.shape[0],
                requested_buckets=spec.buckets)
            engine = ServingEngine(
                k=spec.k, buckets=tplan["buckets"],
                shortlist_k=spec.shortlist_k, max_queue=spec.max_queue,
                max_wait_s=spec.max_wait_s,
                default_deadline_s=spec.default_deadline_s,
                slo_s=spec.slo_s, flight_capacity=spec.flight_capacity,
                tenant=spec.name, device=self.device)
            engine.publish(U, V, item_valid=item_valid, quantize=quantize)
            tenant = Tenant(spec=spec, engine=engine,
                            shape_class=tplan["shape_class"])
        except BaseException:
            if engine is not None:
                engine.stop()
            with self._lock:
                self._reserved.discard(spec.name)
            raise
        with self._lock:
            self._reserved.discard(spec.name)
            self._tenants[spec.name] = tenant
            n_now = len(self._tenants)
        obs.gauge("tenancy.tenants", n_now)
        obs.emit("tenant_registered", tenant=spec.name,
                 users=int(U.shape[0]), items=int(V.shape[0]),
                 shape_class=tenant.shape_class, weight=spec.weight)
        return tenant

    def attach_live(self, name, foldin, **updater_kwargs):
        """Wire a live fold-in -> publish pipeline onto a registered
        tenant: its own :class:`LiveUpdater` over ``foldin``, labeled
        with the tenant's name, on the registry's device (created, not
        started)."""
        from tpu_als_torch.live import LiveUpdater

        tenant = self.get(name)
        if tenant.updater is not None:
            raise TenancyError(
                f"tenant {name!r} already has a live updater attached")
        updater_kwargs.setdefault("fold_items", tenant.spec.fold_items)
        if tenant.spec.freshness_slo_s is not None:
            updater_kwargs.setdefault("slo_s", tenant.spec.freshness_slo_s)
        tenant.foldin = foldin
        tenant.updater = LiveUpdater(tenant.engine, foldin, tenant=name,
                                     device=self.device, **updater_kwargs)
        return tenant.updater

    def remove(self, name):
        """Deregister a tenant: stop its updater and engine and drop the
        reference (releasing its device tensors)."""
        with self._lock:
            tenant = self._tenants.pop(name, None)
            n_now = len(self._tenants)
        if tenant is None:
            raise UnknownTenant(name, self.names())
        if tenant.updater is not None:
            tenant.updater.stop()
        tenant.engine.stop()
        obs.gauge("tenancy.tenants", n_now)
        obs.emit("tenant_removed", tenant=name)
        return tenant

    # -- lookup -------------------------------------------------------
    def get(self, name):
        with self._lock:
            tenant = self._tenants.get(name)
        if tenant is None:
            raise UnknownTenant(name, self.names())
        return tenant

    def names(self):
        with self._lock:
            return tuple(self._tenants)

    def tenants(self):
        """Snapshot of the registered tenants."""
        with self._lock:
            return tuple(self._tenants.values())

    def __len__(self):
        with self._lock:
            return len(self._tenants)

    def __contains__(self, name):
        with self._lock:
            return name in self._tenants

    def shape_classes(self):
        """shape_class -> tenant names."""
        out = {}
        for t in self.tenants():
            out.setdefault(t.shape_class, []).append(t.name)
        return out
