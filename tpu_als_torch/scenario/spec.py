"""Declarative scenario specs: phases, fault arming, assertions.

Counterpart of ``tpu_als/scenario/spec.py``, a copy of it: the same
classes, errors and evaluation.  One addition of the port:
:class:`RunContext` carries the ``device`` the run was asked for (the
card unless the caller asks for the CPU), which every phase hands to
the entry points it calls.

A scenario is a scripted "production day" slice — train, serve, stream,
and chaos composed into one runnable unit with HARD assertions.  The
pieces it composes all exist elsewhere (``resilience/faults.py`` specs,
``resilience/preempt.py``, ``serving/engine.py``, ``stream/microbatch.
py``, checkpoint resume); what this module adds is the *contract*: a
named spec that says which phases run, which fault rules are armed for
the whole run, and which assertions — evaluated from the obs
metrics/events the run emitted — decide pass/fail.

The assertion vocabulary is deliberately small and data-driven (see
docs/scenarios.md for the full table):

==============  =============================================================
``quantile``    ``histogram_quantile(metric, q)`` compared against a bound
                (``scale_ms=True`` converts the seconds histogram to ms so
                the bound can be an SLO in milliseconds)
``counter``     the DELTA of a counter since the scenario started
``ratio``       delta(num) / sum(delta(d) for d in den) — shed rate etc.;
                an empty denominator evaluates as 0 (nothing attempted =
                nothing shed)
``event``       count of events of a type emitted since the scenario started
``fact``        a value a phase recorded into ``ctx.facts`` (exit codes,
                bitwise-equality booleans, measured freshness seconds)
==============  =============================================================

Bounds may be literals or ``"$key"`` references into the scenario's
config (so ``tpu_als_torch scenario run traffic-spike --slo-ms 80``
rebinds
the assertion without editing the spec).  Operators: ``<= >= == < > !=``.

Deliberately stdlib-only: specs and their evaluation logic import
neither torch nor the package, so ``scenario list`` and the CLI's error
paths stay instant.
"""

from __future__ import annotations

import operator
import time
from dataclasses import dataclass, field

OPS = {
    "<=": operator.le,
    ">=": operator.ge,
    "==": operator.eq,
    "!=": operator.ne,
    "<": operator.lt,
    ">": operator.gt,
}

ASSERTION_KINDS = ("quantile", "counter", "ratio", "event", "fact")


class ScenarioError(RuntimeError):
    """Base class for scenario-harness failures."""


class UnknownScenario(ScenarioError):
    """``run``/``get_scenario`` was asked for a name nobody registered.

    Carries ``available`` so every surface (CLI, smoke scripts, tests)
    can list what IS runnable instead of a bare KeyError."""

    def __init__(self, name, available):
        self.name = name
        self.available = tuple(available)
        super().__init__(
            f"unknown scenario {name!r} (available: "
            f"{', '.join(self.available)})")


class PhaseFailed(ScenarioError):
    """A phase body raised — the scenario cannot reach its assertions.
    Distinct from assertion failure: this is harness breakage, not a
    judged robustness property."""

    def __init__(self, scenario, phase, error):
        self.scenario = scenario
        self.phase = phase
        self.error = error
        super().__init__(
            f"scenario {scenario!r} phase {phase!r} failed: "
            f"{type(error).__name__}: {error}")


class ScenarioFailed(ScenarioError):
    """One or more assertions did not hold; ``failed`` lists them."""

    def __init__(self, scenario, failed):
        self.scenario = scenario
        self.failed = list(failed)
        names = ", ".join(a["check"] for a in self.failed)
        super().__init__(
            f"scenario {scenario!r} failed {len(self.failed)} "
            f"assertion(s): {names}")


@dataclass(frozen=True)
class Phase:
    """One named step of a scenario.  ``run`` receives the RunContext;
    anything it must hand later phases goes in ``ctx.state`` (arrays,
    engines), anything an assertion judges goes in ``ctx.facts``
    (JSON-serializable scalars only).

    ``fault_spec`` arms a PHASE-scoped chaos window: the runner pushes
    it (``faults.push_spec``, overlaying the scenario-level spec) just
    before ``run`` and pops it in a ``finally`` — so a chaos window can
    re-arm mid-scenario without leaking rules into later phases or the
    enclosing process."""

    name: str
    run: object          # callable(ctx) -> None
    doc: str = ""
    fault_spec: str = None


@dataclass(frozen=True)
class Assertion:
    """One declarative check, evaluated after every phase has run.

    ``kind`` selects the evaluator; the remaining fields parameterize
    it (see the module docstring's vocabulary table).  ``value`` is the
    bound — a literal, or a ``"$key"`` reference into the run config.
    """

    check: str                 # stable name, reported in scenario_assert
    kind: str                  # one of ASSERTION_KINDS
    op: str = "<="
    value: object = None       # bound (literal or "$config_key")
    metric: str = None         # quantile/counter: metric name
    q: float = None            # quantile: which quantile
    scale_ms: bool = False     # quantile: seconds histogram vs ms bound
    num: str = None            # ratio: numerator counter
    den: tuple = ()            # ratio: denominator counters (summed)
    event: str = None          # event: event type
    fact: str = None           # fact: ctx.facts key
    doc: str = ""

    def __post_init__(self):
        if self.kind not in ASSERTION_KINDS:
            raise ValueError(
                f"assertion {self.check!r}: unknown kind {self.kind!r} "
                f"(known: {ASSERTION_KINDS})")
        if self.op not in OPS:
            raise ValueError(
                f"assertion {self.check!r}: unknown op {self.op!r} "
                f"(known: {tuple(OPS)})")


@dataclass(frozen=True)
class ScenarioSpec:
    """A complete scenario: identity + chaos arming + phases + judgments.

    ``fault_spec`` is a ``TPU_ALS_FAULT_SPEC`` grammar string the runner
    pushes before phase 1 and pops after the last phase (phases may
    push their own overlays — see :class:`Phase`) — the scenario's
    whole chaos schedule is visible here, declaratively, not buried in
    phase bodies.  ``defaults`` seed the run config; CLI
    flags / ``run_scenario(config=...)`` override per key.
    """

    name: str
    doc: str
    phases: tuple          # tuple[Phase, ...]
    assertions: tuple      # tuple[Assertion, ...]
    fault_spec: str = None
    defaults: dict = field(default_factory=dict)


class RunContext:
    """Everything a phase can see: config, a scratch dir, the shared
    facts/state dicts, and a LIFO cleanup stack (engines started in one
    phase are stopped by the runner even when a later phase fails).
    ``device`` is the torch device the run was asked for (the runner
    resolves it; a phase passes it to every entry point it calls)."""

    def __init__(self, spec, config, workdir, registry, device=None):
        self.spec = spec
        self.config = config
        self.workdir = workdir
        self.registry = registry
        self.device = device
        self.facts = {}       # JSON scalars: what assertions judge
        self.state = {}       # arrays/objects handed between phases
        self._cleanups = []

    def defer(self, fn):
        """Register cleanup (engine.stop, thread joins) to run LIFO
        after the last phase, failures included."""
        self._cleanups.append(fn)

    def run_cleanups(self):
        errors = []
        while self._cleanups:
            fn = self._cleanups.pop()
            try:
                fn()
            except Exception as e:   # noqa: BLE001 — best-effort teardown
                errors.append(e)
        return errors


def resolve_bound(value, config):
    """A ``"$key"`` bound reads the run config; literals pass through."""
    if isinstance(value, str) and value.startswith("$"):
        key = value[1:]
        if key not in config:
            raise ScenarioError(
                f"assertion bound {value!r} references a config key "
                f"that is not set (have: {sorted(config)})")
        return config[key]
    return value


def evaluate_assertion(a, ctx, baseline_counters, events_start):
    """Evaluate one assertion against the registry state accumulated
    since the scenario started.  Returns a JSON-ready record:
    ``{"check", "kind", "ok", "observed", "expected", "op"}``.

    Counters/events are judged as deltas from the scenario-start
    baseline so a scenario composes with an already-instrumented
    process (the CLI run dir, a test that served traffic earlier).
    """
    reg = ctx.registry
    bound = resolve_bound(a.value, ctx.config)
    observed = None
    ok = False
    try:
        if a.kind == "quantile":
            observed = reg.histogram_quantile(a.metric, a.q)
            if a.scale_ms:
                observed = observed * 1e3
        elif a.kind == "counter":
            observed = (reg.counter_value(a.metric)
                        - baseline_counters.get(a.metric, 0))
        elif a.kind == "ratio":
            num = (reg.counter_value(a.num)
                   - baseline_counters.get(a.num, 0))
            den = sum(reg.counter_value(d) - baseline_counters.get(d, 0)
                      for d in a.den)
            observed = (num / den) if den else 0.0
        elif a.kind == "event":
            observed = sum(
                1 for e in reg._events[events_start:]
                if e.get("type") == a.event)
        elif a.kind == "fact":
            if a.fact not in ctx.facts:
                return {"check": a.check, "kind": a.kind, "ok": False,
                        "observed": None, "expected": bound, "op": a.op,
                        "error": f"fact {a.fact!r} was never recorded"}
            observed = ctx.facts[a.fact]
        ok = bool(OPS[a.op](observed, bound))
    except ScenarioError:
        raise
    except Exception as e:   # noqa: BLE001 — a broken check must FAIL, loudly
        return {"check": a.check, "kind": a.kind, "ok": False,
                "observed": observed, "expected": bound, "op": a.op,
                "error": f"{type(e).__name__}: {e}"}
    if isinstance(observed, float):
        observed = round(observed, 6)
    return {"check": a.check, "kind": a.kind, "ok": ok,
            "observed": observed, "expected": bound, "op": a.op}


def now():
    return time.perf_counter()
