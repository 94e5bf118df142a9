"""Multi-tenant model control plane: many models behind one front door.

Counterpart of ``tpu_als/tenancy/``.  :mod:`~tpu_als_torch.tenancy.
registry` holds tenant identity: each tenant owns a whole single-tenant
serving stack (engine, int8 index, optional live updater) with its own
publish sequence and tenant-labeled obs.  :mod:`~tpu_als_torch.tenancy.
scheduler` is the shared admission front door: one
:class:`MultiTenantEngine` with weighted fair-share scheduling, typed
per-tenant shedding (:class:`TenantOverloaded`) and per-batch fault
isolation.  Every tenant serves on one device, the card unless the
caller passes ``device='cpu'``.
"""

from tpu_als_torch.tenancy.registry import (  # noqa: F401
    GUARDRAIL_MODES,
    DuplicateTenant,
    TenancyError,
    Tenant,
    TenantRegistry,
    TenantSpec,
    UnknownTenant,
)
from tpu_als_torch.tenancy.scheduler import (  # noqa: F401
    FairShareScheduler,
    MultiTenantEngine,
    TenantOverloaded,
)
