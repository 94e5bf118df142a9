"""Scenario execution: arm chaos, run phases, judge assertions, bank.

Counterpart of ``tpu_als/scenario/runner.py``.  Where the port differs:

- :func:`run_scenario` takes ``device`` (None -> the card, raising
  without CUDA; ``'cpu'`` runs the kernels' plain versions), resolved
  before anything runs and handed to every phase as ``ctx.device``; the
  result dict is the reference's, the device not in it.
- :func:`bank_result` names the card: torch's device name and, where
  ``nvidia-smi`` answers, its ``name, power.limit`` line, where the
  reference records ``jax.default_backend()``.

The runner is the integration layer ROADMAP item 4 asks for: it takes a
:class:`~tpu_als_torch.scenario.spec.ScenarioSpec` and produces one verdict,
leaving a complete obs trail behind —

- ``scenario_start``  once, with the phase list and effective config,
- ``scenario_phase``  per phase, with its wall-clock seconds,
- ``scenario_assert`` per assertion, with observed vs expected,
- ``scenario_end``    once, with the verdict and total seconds

— so ``tpu_als_torch observe tail`` on a scenario run dir reads as the
production day's story, and the assertions are *re-derivable* from the
events alone.

Fault arming is scoped and STACKED: the spec's ``fault_spec`` is pushed
(``faults.push_spec``) before phase 1, each phase's own ``fault_spec``
is pushed as an overlay around just that phase, and every push is
popped LIFO afterwards, failures included — so chaos windows can re-arm
mid-scenario (the soak chaos schedule) and a failing scenario never
leaks rules into the next one or the enclosing process.  Causal tracing
(``obs.tracing``) is armed over the same window with the same restore
discipline, so every scenario's trail carries complete ``trace_span``
trees (``observe explain`` on a scenario run dir) without flipping the
process-wide default.

``bank_result`` writes ``BENCH_scenario_<name>.json`` with the same
``banked_at`` UTC-provenance contract bench.py and serve-bench use, so
a scenario run on chip is a bankable artifact, not just a green line.
"""

from __future__ import annotations

import shutil
import tempfile

from tpu_als_torch.obs import tracing
from tpu_als_torch.resilience import faults
from tpu_als_torch.scenario.spec import (
    PhaseFailed,
    RunContext,
    ScenarioFailed,
    evaluate_assertion,
    now,
)


def run_scenario(spec, config=None, registry=None, workdir=None,
                 raise_on_fail=False, device=None):
    """Run one scenario end to end; returns the result dict.

    ``config`` overrides the spec's defaults per key (CLI flags land
    here).  ``registry`` defaults to the process-wide obs registry.
    ``device``: where every phase runs (None -> the card, raising
    without CUDA).
    ``raise_on_fail=True`` turns a failed verdict into a typed
    :class:`ScenarioFailed` (the CLI prefers checking ``result
    ["passed"]`` so it can print the table first).

    The result dict::

        {"scenario", "passed", "seconds",
         "phases": [{"phase", "seconds"}, ...],
         "assertions": [{"check", "kind", "ok", "observed",
                         "expected", "op"}, ...],
         "config": {...}}
    """
    from tpu_als_torch.utils.platform import resolve_device

    device = resolve_device(device)
    if registry is None:
        from tpu_als_torch import obs

        registry = obs.default_registry()
    cfg = dict(spec.defaults)
    if config:
        cfg.update({k: v for k, v in config.items() if v is not None})

    own_workdir = workdir is None
    if own_workdir:
        workdir = tempfile.mkdtemp(prefix=f"tpu_als_scenario_{spec.name}_")
    ctx = RunContext(spec, cfg, workdir, registry, device=device)

    # counters/events are judged as deltas from here (spec.py docstring)
    baseline = {}
    for a in spec.assertions:
        for name in filter(None, (a.metric, a.num) + tuple(a.den)):
            if a.kind in ("counter", "ratio"):
                baseline[name] = registry.counter_value(name)
    events_start = len(registry._events)

    registry.emit("scenario_start", scenario=spec.name,
                  phases=[p.name for p in spec.phases], config=cfg)
    t_start = now()
    phase_records = []
    tracing_was = tracing.tracing_armed()
    pushed = 0
    try:
        tracing.enable_tracing()
        if spec.fault_spec:
            faults.push_spec(spec.fault_spec)
            pushed += 1
        for phase in spec.phases:
            t0 = now()
            # phase-scoped chaos window: push as an overlay over the
            # scenario-level spec, pop in the finally — LIFO restore,
            # so a failing phase never leaks its rules forward
            if phase.fault_spec:
                faults.push_spec(phase.fault_spec)
                pushed += 1
            try:
                phase.run(ctx)
            except Exception as e:   # noqa: BLE001 — typed + obs-visible
                err = PhaseFailed(spec.name, phase.name, e)
                registry.emit("scenario_end", scenario=spec.name,
                              passed=False, seconds=now() - t_start,
                              error=str(err))
                raise err from e
            finally:
                if phase.fault_spec:
                    faults.pop_spec()
                    pushed -= 1
            phase_records.append(
                {"phase": phase.name, "seconds": round(now() - t0, 4)})
            registry.emit("scenario_phase", scenario=spec.name,
                          phase=phase.name,
                          seconds=phase_records[-1]["seconds"])
    finally:
        # restore the pre-scenario fault state (the env spec, if any)
        # BEFORE teardown so engine drains don't hit armed points
        while pushed:
            faults.pop_spec()
            pushed -= 1
        for e in ctx.run_cleanups():
            registry.emit("warning", what="scenario.cleanup",
                          reason=f"{type(e).__name__}: {e}")
        # disarm AFTER the drains so in-flight tickets finish their
        # trees; restore-only (an operator-armed process stays armed)
        if not tracing_was:
            tracing.disable_tracing()
        if own_workdir:
            shutil.rmtree(workdir, ignore_errors=True)

    assertions = [
        evaluate_assertion(a, ctx, baseline, events_start)
        for a in spec.assertions
    ]
    for rec in assertions:
        registry.emit("scenario_assert", scenario=spec.name, **rec)
    failed = [rec for rec in assertions if not rec["ok"]]
    passed = not failed
    total = round(now() - t_start, 4)
    registry.emit("scenario_end", scenario=spec.name, passed=passed,
                  seconds=total)
    result = {"scenario": spec.name, "passed": passed, "seconds": total,
              "phases": phase_records, "assertions": assertions,
              "facts": dict(ctx.facts), "config": cfg}
    if raise_on_fail and not passed:
        raise ScenarioFailed(spec.name, failed)
    return result


def device_provenance(device):
    """What a banked result ran on: ``platform`` (the torch device type),
    ``device_name`` (torch's name of the card, or the host's processor on
    the CPU) and ``nvidia_smi`` (``name, power.limit`` as ``nvidia-smi``
    reports them, None where it does not answer)."""
    import platform
    import subprocess

    import torch

    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
    else:
        name = platform.processor() or platform.machine()
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        smi = (p.stdout.strip().splitlines() or [None])[0] \
            if p.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        smi = None
    return {"platform": device.type, "device_name": name,
            "nvidia_smi": smi}


def bank_result(result, path, device=None):
    """Write the scenario result as a BENCH-contract JSON artifact:
    ``metric``/``value`` headline plus the full phase/assertion record,
    stamped with absolute-UTC ``banked_at`` provenance (never a
    relative phrase) and the card it ran on (:func:`device_provenance`
    of ``device``, None -> the card)."""
    import datetime as _dt
    import json

    from tpu_als_torch.utils.platform import resolve_device

    banked = {
        "metric": f"scenario_{result['scenario']}",
        "value": 1 if result["passed"] else 0,
        "unit": "pass",
        **result,
        **device_provenance(resolve_device(device)),
        "banked_by": "tpu_als_torch scenario run",
        "banked_at": _dt.datetime.now(
            _dt.timezone.utc).isoformat(timespec="seconds"),
    }
    with open(path, "w") as f:
        json.dump(banked, f, indent=2, default=str)
        f.write("\n")
    return banked


def render_result(result):
    """Human-readable verdict table (the CLI's stdout companion to the
    machine-readable JSON line)."""
    lines = [f"scenario {result['scenario']}: "
             f"{'PASS' if result['passed'] else 'FAIL'} "
             f"({result['seconds']:.2f}s)"]
    for p in result["phases"]:
        lines.append(f"  phase {p['phase']:<24} {p['seconds']:>8.3f}s")
    for a in result["assertions"]:
        mark = "ok  " if a["ok"] else "FAIL"
        detail = f"{a['observed']} {a['op']} {a['expected']}"
        if a.get("error"):
            detail += f"  [{a['error']}]"
        lines.append(f"  {mark} {a['check']:<28} {detail}")
    return "\n".join(lines)
