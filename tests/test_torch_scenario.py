"""Parity of the port's production-day scenarios
(``tpu_als_torch/scenario/``) with ``tpu_als/scenario/``, on the CPU.

- The registry: the twelve names, and each scenario's doc, phases,
  assertions, ``fault_spec`` and defaults equal to the reference's; the
  typed errors are there.
- The judging: ``resolve_bound`` and ``evaluate_assertion`` give the
  reference's records on the same registries, and a toy spec run
  through both runners gives equal result dicts (walls dropped) and the
  same ``scenario_*`` trail (timestamps and walls dropped).
- The named scenarios, end to end on the CPU: torn-publish, cold-start,
  poisoned-stream and preempt-resume pass; for poisoned-stream and
  torn-publish the reference's run in the same test records the same
  fact keys with equal counts, exit codes and booleans (its fits draw
  their own inits, so RMSEs are not compared).
- The command line: ``scenario list`` prints the reference's text;
  an unknown name exits 2 naming the scenarios, a failed assertion 1,
  an unparseable ``TPU_ALS_FAULT_SPEC`` 2, none with a traceback.
- The divergence of the CLI children (here and in ``soak/``): the
  parent's ``--device`` and ``--devices N`` logical shards, no
  ``XLA_FLAGS``; ``bank_result`` names the device.

Tolerances: every comparison here is exact (texts, records, counts,
booleans); no factor or score is compared across the packages.  Inside
a scenario the reference's own bounds hold (torn-publish's ids bitwise
and scores within its ``allclose(rtol=1e-5, atol=1e-6)``).
"""

import dataclasses
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

from tpu_als import obs as jobs
from tpu_als import scenario as jscenario
from tpu_als.resilience import faults as jfaults
from tpu_als.scenario import spec as jspec
from tpu_als_torch import obs as tobs
from tpu_als_torch import scenario as tscenario
from tpu_als_torch.parallel import serve as tserve
from tpu_als_torch.resilience import faults as tfaults
from tpu_als_torch.scenario import spec as tspec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: under the suite's
    workers a thread pool per small op mostly waits for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Disarmed faults and fresh registries in both packages, and the
    reference's planner disarmed."""
    monkeypatch.setenv("TPU_ALS_PLAN_CACHE", "off")
    monkeypatch.delenv("TPU_ALS_TRACE", raising=False)
    jfaults.clear()
    tfaults.clear()
    tserve.reset_last_good()
    yield jobs.reset(), tobs.reset()
    jfaults.clear()
    tfaults.clear()


def _cli(module, args, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"  # as the in-process tests: one thread
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)


# -- the registry ---------------------------------------------------------------

def test_the_twelve_names_are_the_references():
    assert tscenario.names() == jscenario.names()
    assert len(tscenario.names()) == 12


def _shape(spec):
    return {"name": spec.name, "doc": spec.doc,
            "fault_spec": spec.fault_spec, "defaults": spec.defaults,
            "phases": [(p.name, p.doc, p.fault_spec) for p in spec.phases],
            "assertions": [dataclasses.asdict(a) for a in spec.assertions]}


@pytest.mark.parametrize("name", jscenario.names())
def test_scenario_spec_equals_the_references(name):
    assert _shape(tscenario.get_scenario(name)) == \
        _shape(jscenario.get_scenario(name))


def test_typed_errors():
    for cls in (tscenario.UnknownScenario, tscenario.PhaseFailed,
                tscenario.ScenarioFailed):
        assert issubclass(cls, tscenario.ScenarioError)
    assert issubclass(tscenario.ScenarioError, RuntimeError)
    with pytest.raises(tscenario.UnknownScenario) as ei:
        tscenario.get_scenario("no-such")
    assert ei.value.available == jscenario.names()
    assert str(ei.value) == str(jscenario.UnknownScenario(
        "no-such", jscenario.names()))
    with pytest.raises(ValueError, match="unknown kind"):
        tspec.Assertion("x", "vibes", value=1)
    with pytest.raises(ValueError, match="unknown op"):
        tspec.Assertion("x", "fact", op="~=", fact="f", value=1)


# -- judging --------------------------------------------------------------------

@pytest.mark.parametrize("value,config", [
    ("$slo_ms", {"slo_ms": 250.0}), (42, {}), ("plain", {"x": 1}),
    ("$missing", {"slo_ms": 1.0})])
def test_resolve_bound_agrees(value, config):
    def run(mod):
        try:
            return mod.resolve_bound(value, config)
        except mod.ScenarioError as e:
            return ("error", str(e))

    assert run(tspec) == run(jspec)


ASSERTIONS = [
    dict(check="p99", kind="quantile", metric="serving.e2e_seconds",
         q=0.99, scale_ms=True, op="<=", value="$slo_ms"),
    dict(check="p50", kind="quantile", metric="serving.e2e_seconds",
         q=0.5, op=">", value=0.001),
    dict(check="requests", kind="counter", metric="serving.requests",
         op="==", value=7),
    dict(check="shed_rate", kind="ratio", num="serving.shed",
         den=("serving.shed", "serving.requests"), op="<=", value=0.5),
    dict(check="empty_ratio", kind="ratio", num="serve.degraded",
         den=("serve.requests",), op="==", value=0.0),
    dict(check="publishes", kind="event", event="serving_publish",
         op=">=", value=2),
    dict(check="answered", kind="fact", fact="answered", op=">=",
         value=50),
    dict(check="missing", kind="fact", fact="never", op="==", value=1),
    dict(check="broken", kind="quantile", metric="serving.e2e_seconds",
         q=0.5, op="<=", value="not a number"),
]


def _fill(obs_mod):
    reg = obs_mod.default_registry()
    reg.counter("serving.requests", 100)     # before the baseline
    base = {"serving.requests": reg.counter_value("serving.requests"),
            "serving.shed": 0}
    start = len(reg._events)
    reg.counter("serving.requests", 7)
    reg.counter("serving.shed", 2)
    for v in (0.010, 0.020, 0.030, 0.2):
        reg.histogram("serving.e2e_seconds", v)
    for seq in (1, 2):
        reg.emit("serving_publish", seq=seq, items=10, quantized=True)
    return reg, base, start


@pytest.mark.parametrize("kw", ASSERTIONS, ids=[a["check"] for a in ASSERTIONS])
def test_evaluate_assertion_agrees(kw):
    out = []
    for obs_mod, spec_mod in ((tobs, tspec), (jobs, jspec)):
        reg, base, start = _fill(obs_mod)
        ctx = spec_mod.RunContext(None, {"slo_ms": 250.0}, None, reg)
        ctx.facts["answered"] = 64
        out.append(spec_mod.evaluate_assertion(spec_mod.Assertion(**kw),
                                               ctx, base, start))
    assert out[0] == out[1]


def _toy(spec_mod):
    def work(ctx):
        ctx.registry.counter("serving.requests", 7)
        ctx.registry.emit("serving_publish", seq=1, items=3,
                          quantized=False)
        ctx.facts["answered"] = 7

    def note(ctx):
        ctx.facts["armed"] = (tfaults if spec_mod is tspec
                              else jfaults).armed("solve.gram")

    A = spec_mod.Assertion
    return spec_mod.ScenarioSpec(
        name="toy", doc="inline test spec",
        phases=(spec_mod.Phase("work", work),
                spec_mod.Phase("note", note,
                               fault_spec="solve.gram=corrupt")),
        assertions=(A("delta", "counter", metric="serving.requests",
                      op="==", value=7),
                    A("floor", "fact", fact="answered", op=">=",
                      value="$floor"),
                    A("armed", "fact", fact="armed", op="==", value=True),
                    A("never", "fact", fact="x", op="==", value=1),
                    A("published", "event", event="serving_publish",
                      op=">=", value=1)),
        fault_spec="serve.gather=corrupt", defaults={"floor": 5})


def _drop_walls(result):
    out = dict(result)
    out.pop("seconds")
    out["phases"] = [p["phase"] for p in result["phases"]]
    return out


def _trail(reg):
    drop = {"ts", "seconds"}
    return [{k: v for k, v in e.items() if k not in drop}
            for e in reg._events if e["type"].startswith("scenario_")]


def test_toy_spec_through_both_runners(_fresh):
    jreg, treg = _fresh
    jreg.counter("serving.requests", 100)
    treg.counter("serving.requests", 100)
    ours = tscenario.run_scenario(_toy(tspec), device="cpu")
    theirs = jscenario.run_scenario(_toy(jspec))
    assert _drop_walls(ours) == _drop_walls(theirs)
    assert ours["passed"] is False      # the "never" fact was not recorded
    assert _trail(treg) == _trail(jreg)
    assert not tfaults.active() and tfaults.push_depth() == 0


def test_phase_failure_is_typed_and_cleans_up(_fresh):
    stopped = []

    def start(ctx):
        ctx.defer(lambda: stopped.append("a"))
        ctx.defer(lambda: stopped.append("b"))

    def boom(ctx):
        raise RuntimeError("shard on fire")

    spec = tspec.ScenarioSpec(
        name="tiny", doc="inline", phases=(tspec.Phase("start", start),
                                           tspec.Phase("boom", boom)),
        assertions=(), fault_spec="serve.gather=raise")
    with pytest.raises(tscenario.PhaseFailed, match="shard on fire"):
        tscenario.run_scenario(spec, device="cpu")
    assert stopped == ["b", "a"]
    assert not tfaults.active()


def test_bank_result_names_the_device(tmp_path):
    spec = tspec.ScenarioSpec(name="tiny", doc="inline",
                              phases=(tspec.Phase("noop", lambda c: None),),
                              assertions=())
    result = tscenario.run_scenario(spec, device="cpu")
    banked = tscenario.bank_result(result, str(tmp_path / "b.json"),
                                   device="cpu")
    on_disk = json.loads((tmp_path / "b.json").read_text())
    assert on_disk["metric"] == "scenario_tiny" and on_disk["value"] == 1
    assert on_disk["platform"] == "cpu" and on_disk["device_name"]
    assert "nvidia_smi" in on_disk and "+00:00" in on_disk["banked_at"]
    assert banked["banked_by"] == "tpu_als_torch scenario run"


def test_run_scenario_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tscenario.run_scenario(tscenario.get_scenario("torn-publish"))


# -- the named scenarios --------------------------------------------------------

def _facts_alike(ours, theirs):
    """The same fact keys; equal values for every count, exit code and
    boolean (floats, the runs' RMSEs and walls, are not compared)."""
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        if isinstance(v, (bool, int)) or v is None:
            assert ours[k] == v, k


@pytest.mark.parametrize("name", ["torn-publish", "poisoned-stream"])
def test_scenario_passes_with_the_references_facts(name, _fresh):
    jreg, treg = _fresh
    ours = tscenario.run_scenario(tscenario.get_scenario(name), device="cpu")
    assert ours["passed"], ours["assertions"]
    theirs = jscenario.run_scenario(jscenario.get_scenario(name))
    assert theirs["passed"], theirs["assertions"]
    _facts_alike(ours["facts"], theirs["facts"])
    assert [a["check"] for a in ours["assertions"]] == \
        [a["check"] for a in theirs["assertions"]]
    for a, b in zip(ours["assertions"], theirs["assertions"]):
        if a["kind"] in ("counter", "event"):
            assert a["observed"] == b["observed"], a["check"]


def test_cold_start_passes():
    result = tscenario.run_scenario(tscenario.get_scenario("cold-start"),
                                    device="cpu")
    assert result["passed"], result["assertions"]
    assert result["facts"]["new_user_served"] is True
    assert 0 < result["facts"]["freshness_ms"] <= 5000
    assert tobs.histogram_count("scenario.freshness_seconds") == 1


def test_preempt_resume_passes_through_the_cli_children(monkeypatch):
    # the children inherit one intra-op thread, as the fixture's
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    result = tscenario.run_scenario(
        tscenario.get_scenario("preempt-resume"), device="cpu")
    assert result["passed"], result["assertions"]
    f = result["facts"]
    assert f["preempt_exit_code"] == 43 and f["resume_exit_code"] == 0
    assert f["resume_discovered"] is True and f["model_saved"] is True


# -- the command line ---------------------------------------------------------

def test_scenario_list_prints_the_references_text():
    from tpu_als import cli as jcli
    from tpu_als_torch import cli as tcli

    texts = []
    for cli in (tcli, jcli):
        buf = io.StringIO()
        with redirect_stdout(buf):
            cli.main(["scenario", "list"])
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    assert texts[0].count("\n      - ") == sum(
        len(s.phases) for s in tscenario.SCENARIOS.values())


def test_cli_unknown_scenario_exits_2_and_lists_names():
    p = _cli("tpu_als_torch.cli", ["scenario", "run", "no-such-scenario",
                                   "--device", "cpu"])
    assert p.returncode == 2
    assert p.stderr.startswith("tpu_als_torch scenario: unknown scenario")
    for name in tscenario.names():
        assert name in p.stderr
    assert "Traceback" not in p.stderr


def test_cli_failed_assertion_exits_1_after_the_table():
    p = _cli("tpu_als_torch.cli", ["scenario", "run", "cold-start",
                                   "--freshness-slo-ms", "0", "--json",
                                   "--device", "cpu"])
    assert p.returncode == 1, p.stderr
    assert p.stdout.startswith("scenario cold-start: FAIL")
    result = json.loads(p.stdout.strip().splitlines()[-1])
    bad = [a["check"] for a in result["assertions"] if not a["ok"]]
    assert bad == ["freshness_under_bound"]
    assert "Traceback" not in p.stderr


def test_cli_rejects_an_unparseable_fault_spec():
    p = _cli("tpu_als_torch.cli", ["scenario", "run", "torn-publish",
                                   "--device", "cpu"],
             env_extra={"TPU_ALS_FAULT_SPEC": "not=a@spec="})
    assert p.returncode == 2
    assert "TPU_ALS_FAULT_SPEC" in p.stderr and "Traceback" not in p.stderr


def test_cli_children_take_the_parents_device_and_logical_shards(
        monkeypatch, tmp_path):
    """The port's divergence in both libraries' children: ``--device``
    passed on from the parent and ``--devices N`` logical shards, with no
    ``XLA_FLAGS`` or ``JAX_PLATFORMS`` set (the reference forces a CPU
    platform of ``host_devices`` devices)."""
    from tpu_als_torch.scenario import library
    from tpu_als_torch.soak import chaos, orchestrator, traffic

    seen = []

    def fake_run(argv, **kw):
        seen.append((list(argv), kw["env"]))
        return subprocess.CompletedProcess(argv, 0, "", "")

    monkeypatch.delenv("XLA_FLAGS", raising=False)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setattr(library.subprocess, "run", fake_run)
    spec = tscenario.get_scenario("device-loss")
    ctx = tspec.RunContext(spec, dict(spec.defaults), str(tmp_path),
                           tobs.default_registry(),
                           device=torch.device("cpu"))
    library._dl_elastic(ctx)
    argv, env = seen[-1]
    assert argv[-2:] == ["--device", "cpu"]
    assert argv[argv.index("--devices") + 1] == "4" and "--elastic" in argv
    assert env["TPU_ALS_FAULT_SPEC"] == "mesh.device_lost=corrupt@nth=3"
    assert "XLA_FLAGS" not in env and "JAX_PLATFORMS" not in env
    with pytest.raises(ValueError, match="host_devices is 8"):
        library._dl_env({"devices": 9, "host_devices": 8})

    cw = next(c for c in chaos.default_schedule(8).windows
              if c.action == "device_loss")
    (args, env_extra), = orchestrator._child_commands(
        traffic.TrafficConfig(), cw, str(tmp_path))
    assert args[args.index("--devices") + 1] == "3" and "--elastic" in args
    assert env_extra == {"TPU_ALS_FAULT_SPEC":
                         "mesh.device_lost=corrupt@nth=2"}
    started = []

    class FakePopen:
        def __init__(self, argv, **kw):
            started.append((argv, kw["env"]))
            self.returncode = 0

    monkeypatch.setattr(orchestrator.subprocess, "Popen", FakePopen)
    orchestrator._Child(args, torch.device("cpu"), env_extra)
    argv, env = started[-1]
    assert argv[-2:] == ["--device", "cpu"]
    assert "XLA_FLAGS" not in env and "JAX_PLATFORMS" not in env
