"""Production-day scenario harness: composed chaos with hard assertions.

Counterpart of ``tpu_als/scenario/``, with its exports, run on the card
(``run_scenario(..., device=None)``; ``device='cpu'`` for the CPU).

The robustness primitives (fault injection, preemption, degraded
serving, fold-in, checkpoint resume) are each proven in isolation;
this package composes them into named, scripted end-to-end scenarios —
``tpu_als_torch scenario run <name>`` — whose pass/fail verdicts are
evaluated from the obs metrics/events the run emits.  The reference's
docs/scenarios.md describes them.
"""

from tpu_als_torch.scenario.library import SCENARIOS, get_scenario, names
from tpu_als_torch.scenario.runner import (bank_result, render_result,
                                           run_scenario)
from tpu_als_torch.scenario.spec import (
    Assertion,
    Phase,
    PhaseFailed,
    RunContext,
    ScenarioError,
    ScenarioFailed,
    ScenarioSpec,
    UnknownScenario,
)

__all__ = [
    "Assertion",
    "Phase",
    "PhaseFailed",
    "RunContext",
    "SCENARIOS",
    "ScenarioError",
    "ScenarioFailed",
    "ScenarioSpec",
    "UnknownScenario",
    "bank_result",
    "get_scenario",
    "names",
    "render_result",
    "run_scenario",
]
