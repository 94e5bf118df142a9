"""Resilience of the port: fault injection (:mod:`.faults`), retry
policies (:mod:`.retry`), the fit's numerical guardrails
(:mod:`.guardrails`), preemption (:mod:`.preempt`) and elastic training
over a mesh of shards (:mod:`.elastic`).

The reference's names are re-exported (``tpu_als/resilience/__init__.py``'s
``__all__``).
"""

from tpu_als_torch.resilience import elastic, faults, preempt  # noqa: F401
from tpu_als_torch.resilience.elastic import DeviceLost, ProbeFailed
from tpu_als_torch.resilience.faults import ENV_VAR as FAULT_SPEC_ENV
from tpu_als_torch.resilience.faults import (FAULT_POINTS, FaultSpecError,
                                             InjectedFault)
from tpu_als_torch.resilience.preempt import (EXIT_PREEMPTED, PreemptAtError,
                                              Preempted, PreemptionGuard)
from tpu_als_torch.resilience.retry import (AttemptTimeout, RetryExhausted,
                                            RetryPolicy, retry_call)

__all__ = [
    "AttemptTimeout",
    "DeviceLost",
    "EXIT_PREEMPTED",
    "FAULT_POINTS",
    "FAULT_SPEC_ENV",
    "FaultSpecError",
    "InjectedFault",
    "PreemptAtError",
    "Preempted",
    "PreemptionGuard",
    "ProbeFailed",
    "RetryExhausted",
    "RetryPolicy",
    "elastic",
    "faults",
    "preempt",
    "retry_call",
]
