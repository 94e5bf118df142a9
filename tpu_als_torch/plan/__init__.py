"""The execution planner and its persistent cache.

Counterpart of ``tpu_als/plan/``: :mod:`.planner` resolves each dispatch
decision of the port (training routes, top-k route, gather strategy,
serving ladder, live cadence, tenant plans, tuned kernel knobs) through
one cache discipline; :mod:`.cache` is the on-disk, schema-validated
store behind it (stdlib only).  ``TPU_ALS_PLAN_CACHE`` names the
directory (default ``~/.cache/tpu_als_torch/plan``), ``off`` disarms.
"""

from tpu_als_torch.plan.cache import PlanCacheCorrupt, SCHEMA_VERSION  # noqa: F401
from tpu_als_torch.plan.planner import (  # noqa: F401
    AUTOTUNE_ENV,
    DEFAULT_LIVE_CADENCE,
    GATHER_CANDIDATES,
    ExecutionPlan,
    armed,
    autotune_enabled,
    clear,
    gather_model,
    invalidate_kernel_config,
    mode,
    plan_key,
    probe_budget_s,
    resolve_execution_plan,
    resolve_gather_strategy,
    resolve_kernel_config,
    resolve_live_cadence,
    resolve_serving_buckets,
    resolve_tenant_plan,
    resolve_topk,
    resolve_training,
    shape_class,
    training_model,
)
