"""Parity of the port's production-week soak (``tpu_als_torch/soak/``)
with ``tpu_als/soak/``, on the CPU.

- The traffic model: ``stream_bytes`` of three configs byte-identical to
  the reference's (bitwise).
- The chaos schedule: ``default_schedule(...).describe()`` text identical
  to the reference's with and without the CLI children (bitwise), and
  ``soak --plan`` prints the reference's text; a window's specs arm and
  pop LIFO over the port's fault harness.
- The judge: the port's ``judge`` and the reference's give identical
  results on hand-built trails (passing, an error on a victim-free
  tenant, a missed recovery, an overridden SLO), and the port's
  ``verdict.py`` runs as a file with ``torch`` and ``tpu_als_torch``
  unimportable.
- The soak itself: an in-process soak on the CPU (``subprocesses=False``,
  the reference test's own config and its widened latency bounds,
  ``tests/test_soak.py::test_soak_e2e_inprocess_verdict_and_
  rederivability``, no wider) passes with its four injections fired and
  recovered, and the reference's stdlib ``verdict.py`` re-derives the
  identical checks from the dumped trail (bitwise).
- ``analysis/vocab.py::check_soak_vocabulary`` is clean on the port's
  tree and fires on doctored copies.

Nothing here compares factors or scores across the packages (the
soak's fits draw their own inits), so every comparison is exact.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from tpu_als.soak import chaos as jchaos
from tpu_als.soak import traffic as jtraffic
from tpu_als.soak import verdict as jverdict
from tpu_als_torch import obs as tobs
from tpu_als_torch.analysis import vocab
from tpu_als_torch.resilience import faults as tfaults
from tpu_als_torch.soak import chaos as tchaos
from tpu_als_torch.soak import orchestrator as torch_orchestrator
from tpu_als_torch.soak import traffic as ttraffic
from tpu_als_torch.soak import verdict as tverdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_VERDICT = os.path.join(REPO, "tpu_als_torch", "soak", "verdict.py")
REF_VERDICT = os.path.join(REPO, "tpu_als", "soak", "verdict.py")


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
    monkeypatch.setenv("TPU_ALS_PLAN_CACHE", "off")
    tfaults.clear()
    reg = tobs.reset()
    yield reg
    tfaults.clear()


# -- traffic: the byte-for-byte replay across the packages ------------------

TRAFFIC_CONFIGS = {
    "the reference test's": dict(seed=23, windows=3, window_s=0.5,
                                 base_qps=30.0, update_qps=20.0,
                                 catalog0=24, catalog_growth=4, n_users=32,
                                 poison_frac=0.1),
    "the soak command's defaults": {},
    "three tenants, heavy poison": dict(seed=5, windows=6, window_s=1.5,
                                        tenants=(("x", 1.0), ("y", 2.5),
                                                 ("z", 0.5)),
                                        day_windows=3, diurnal_amp=0.9,
                                        zipf_s=1.4, poison_frac=0.4),
}


@pytest.mark.parametrize("name", sorted(TRAFFIC_CONFIGS))
def test_stream_bytes_identical_to_reference(name):
    kw = TRAFFIC_CONFIGS[name]
    ours = ttraffic.stream_bytes(ttraffic.TrafficConfig(**kw))
    theirs = jtraffic.stream_bytes(jtraffic.TrafficConfig(**kw))
    assert ours == theirs
    assert ours.count(b"\n") > 0


def test_traffic_config_round_trips_through_the_references_dict():
    cfg = ttraffic.TrafficConfig(**TRAFFIC_CONFIGS["the reference test's"])
    back = jtraffic.TrafficConfig.from_dict(cfg.to_dict())
    assert back.to_dict() == cfg.to_dict()
    assert ttraffic.window_counts(cfg, 1) == jtraffic.window_counts(
        jtraffic.TrafficConfig(**TRAFFIC_CONFIGS["the reference test's"]), 1)


# -- chaos: the schedule's text and its scoped arming ------------------------

@pytest.mark.parametrize("subprocesses", [True, False])
@pytest.mark.parametrize("windows", [3, 8])
def test_default_schedule_text_identical_to_reference(subprocesses, windows):
    ours = tchaos.default_schedule(windows, subprocesses=subprocesses)
    theirs = jchaos.default_schedule(windows, subprocesses=subprocesses)
    assert ours.describe() == theirs.describe()
    assert len(ours) == len(theirs) == (6 if subprocesses else 4)


def test_window_rejects_unknown_action_and_bad_spec():
    with pytest.raises(ValueError, match="unknown action"):
        tchaos.ChaosWindow(1, "x", action="set_on_fire")
    with pytest.raises(tfaults.FaultSpecError):
        tchaos.ChaosWindow(1, "x", fault_spec="not a spec !!")


def test_armed_window_overlays_and_pops_lifo():
    tfaults.install("serve.gather=corrupt")
    sched = tchaos.ChaosSchedule([
        tchaos.ChaosWindow(2, "torn", fault_spec="serving.publish=corrupt",
                           action="torn_publish", victim="a")])
    d0 = tfaults.push_depth()
    with pytest.raises(RuntimeError, match="boom"):
        with sched.armed(2):
            assert tfaults.armed("serving.publish")
            assert tfaults.armed("serve.gather")
            assert tfaults.push_depth() == d0 + 1
            raise RuntimeError("boom")
    assert not tfaults.armed("serving.publish")
    assert tfaults.armed("serve.gather")
    assert tfaults.push_depth() == d0


def test_soak_plan_prints_the_references_text():
    def plan(module):
        p = subprocess.run([sys.executable, "-m", module, "soak", "--plan",
                            "--windows", "6"], capture_output=True,
                           text=True, cwd=REPO,
                           env={**os.environ, "JAX_PLATFORMS": "cpu",
                                "OMP_NUM_THREADS": "1"},
                           timeout=120)
        assert p.returncode == 0, p.stderr
        return p.stdout

    assert plan("tpu_als_torch.cli") == plan("tpu_als.cli")


# -- the judge ----------------------------------------------------------------

def _passing_trail():
    """The reference test's hand-written two-window trail."""
    t = {"offered": 10, "answered": 10, "shed": 0, "errors": 0,
         "p99_ms": 40.0}
    victim = dict(t, errors=3, p99_ms=900.0)
    return [
        {"type": "soak_start", "windows": 2, "window_s": 30.0,
         "tenants": 2, "seed": 17, "scheduled_injections": 1},
        {"type": "trace_span", "name": "live.visible", "seconds": 0.4},
        {"type": "trace_span", "name": "live.visible", "seconds": 0.6},
        {"type": "soak_window", "window": 0, "offered": 20,
         "answered": 20, "shed": 0, "errors": 0,
         "tenants": {"a": dict(t), "b": dict(t)}},
        {"type": "soak_injection", "window": 1, "action": "torn_publish",
         "fired": 1, "recovered": True, "victim": "a"},
        {"type": "soak_window", "window": 1, "offered": 20,
         "answered": 20, "shed": 0, "errors": 3,
         "tenants": {"a": victim, "b": dict(t)}},
    ]


def _victim_free_error(trail):
    trail[-1]["tenants"]["b"]["errors"] = 1
    return trail, None


def _missed_recovery(trail):
    trail[4]["recovered"] = False
    return trail, None


TRAILS = {
    "passing": lambda trail: (trail, None),
    "victim-free error": _victim_free_error,
    "missed recovery": _missed_recovery,
    "overridden SLO": lambda trail: (trail, {"slo_ms": 10.0,
                                             "freshness_slo_ms": 500.0}),
}


@pytest.mark.parametrize("case", sorted(TRAILS))
def test_judge_agrees_with_reference(case):
    trail, config = TRAILS[case](_passing_trail())
    ours = tverdict.judge(json.loads(json.dumps(trail)), config)
    theirs = jverdict.judge(json.loads(json.dumps(trail)), config)
    assert ours == theirs
    assert ours["passed"] is (case == "passing")
    assert tverdict.render(ours) == jverdict.render(theirs)


def test_verdict_defaults_and_p99_are_the_references():
    assert tverdict.DEFAULTS == jverdict.DEFAULTS
    for vals in ([], [3.0], list(range(1, 201)), [0.5, 0.1, 0.9]):
        assert tverdict.p99(vals) == jverdict.p99(vals)


def test_verdict_runs_as_a_file_without_torch_or_the_package(tmp_path):
    """The port's judge needs nothing but the trail: with ``torch``,
    ``tpu_als_torch``, ``jax`` and ``tpu_als`` all made to fail on import,
    ``python tpu_als_torch/soak/verdict.py`` still judges (the twin of the
    reference's ``tests/test_soak.py`` poisoned-jax test)."""
    poison = tmp_path / "poison"
    poison.mkdir()
    for mod in ("torch", "tpu_als_torch", "jax", "tpu_als", "numpy"):
        (poison / f"{mod}.py").write_text(
            f"raise ImportError('the verdict must not import {mod}')\n")
    epath = tmp_path / "events.jsonl"
    epath.write_text("".join(json.dumps(e) + "\n"
                             for e in _passing_trail()))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(poison)
    p = subprocess.run([sys.executable, PORT_VERDICT, str(epath), "--json"],
                       capture_output=True, text=True, env=env,
                       cwd=str(tmp_path), timeout=60)
    assert p.returncode == 0, p.stderr
    out = json.loads(p.stdout)
    assert out == jverdict.judge(_passing_trail())
    p2 = subprocess.run([sys.executable, PORT_VERDICT,
                         str(tmp_path / "nowhere")], capture_output=True,
                        text=True, env=env, cwd=str(tmp_path), timeout=60)
    assert p2.returncode == 2
    assert "no events.jsonl" in p2.stderr and "Traceback" not in p2.stderr


# -- the soak, in process on the CPU -----------------------------------------

def test_inprocess_soak_passes_and_the_reference_rederives_it(tmp_path,
                                                              _fresh):
    cfg = ttraffic.TrafficConfig(
        seed=17, windows=5, window_s=1.0, base_qps=30.0,
        update_qps=15.0, catalog0=48, catalog_growth=6)
    result = torch_orchestrator.run_soak(
        cfg, subprocesses=False, workdir=str(tmp_path / "soak"),
        judge_config={"slo_ms": 5000.0, "freshness_slo_ms": 20000.0},
        device="cpu")
    assert result["passed"], result["checks"]
    assert result["windows"] == cfg.windows
    assert 0 < result["answered"] <= result["offered"]
    assert result["injections"] == result["recoveries"] == 4
    for inj in result["injection_records"]:
        assert inj["fired"] and inj["recovered"], inj
    assert _fresh.counter_value("soak.windows") == cfg.windows
    assert _fresh.counter_value("soak.recoveries") == 4
    assert _fresh.histogram_count("soak.window_seconds") == cfg.windows
    assert len(_fresh.events("soak_verdict")) == 1
    epath = tmp_path / "events.jsonl"
    epath.write_text("".join(json.dumps(e) + "\n"
                             for e in result["events"]))
    p = subprocess.run([sys.executable, REF_VERDICT, str(epath), "--json",
                        "--slo-ms", "5000", "--freshness-slo-ms", "20000"],
                       capture_output=True, text=True, timeout=60)
    assert p.returncode == 0, p.stderr
    again = json.loads(p.stdout)
    assert again["checks"] == result["checks"]
    assert again["survived_minutes"] == result["survived_minutes"]
    assert not tfaults.active()


def test_run_soak_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_orchestrator.run_soak(ttraffic.TrafficConfig(windows=1))


# -- the lint check -----------------------------------------------------------

def test_check_soak_vocabulary_clean_on_the_port():
    assert vocab.check_soak_vocabulary() == []


def _drop_emit(root):
    p = root / "tpu_als_torch" / "soak" / "orchestrator.py"
    p.write_text(p.read_text().replace('"soak_window"', '"soak_windw"'))


def _wrong_kind(root):
    p = root / "tpu_als_torch" / "obs" / "schema.py"
    p.write_text(p.read_text().replace(
        '"soak.windows": (\n        "counter"',
        '"soak.windows": (\n        "gauge"'))


def _verdict_imports_torch(root):
    p = root / "tpu_als_torch" / "soak" / "verdict.py"
    p.write_text(p.read_text().replace("import argparse\n",
                                       "import argparse\nimport torch\n"))


DOCTORED = {"an event never emitted": (_drop_emit, "never emits"),
            "a metric of another kind": (_wrong_kind, "must be a counter"),
            "a verdict importing torch": (_verdict_imports_torch,
                                          "imports torch")}


@pytest.mark.parametrize("case", sorted(DOCTORED))
def test_check_soak_vocabulary_fires_on_a_doctored_copy(tmp_path, case):
    for rel in ("tpu_als_torch/obs/schema.py",
                "tpu_als_torch/resilience/faults.py",
                "tpu_als_torch/soak/orchestrator.py",
                "tpu_als_torch/soak/verdict.py"):
        dst = tmp_path / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(REPO, rel), dst)
    assert vocab.check_soak_vocabulary(str(tmp_path)) == []
    doctor, needle = DOCTORED[case]
    doctor(tmp_path)
    root = str(tmp_path) + os.sep      # a fresh key of the registry cache
    errors = vocab.check_soak_vocabulary(root)
    assert len(errors) == 1 and needle in errors[0], errors
