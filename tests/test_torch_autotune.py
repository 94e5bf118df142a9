"""The port's kernel-knob autotuner (``tpu_als_torch.perf.autotune``) and
the planner's ``kernel_config`` component, on the CPU.

- The search discipline is the reference's: the defaults (the module
  constants the knobs replace) are trial 0, then one knob at a time; the
  winner is the strict minimum, a tie going to the earlier trial; the
  same timer gives the same verdict; the budget stops the search after
  trial 0; an unknown knob is a ``ValueError`` (and exits 2 from the
  CLI); ``feasible`` rejects what K3 and K4 do not take.
- ``tune_band`` / ``drifted`` equal the reference's on the same numbers.
- The planner: a warm read runs no trial; a ``plain`` verdict (the CPU's
  plain versions) never replaces a banked ``device`` one, even under
  ``force``; ``invalidate_kernel_config`` forces a re-tune; a second
  process reads the bank back with ``plan_cache_hit`` and no
  ``tune_trial``.
- ``make_timer`` on the CPU at a tiny instance times the plain versions
  and reports ``source="plain"``; ``model_seconds`` is the sum of
  ``perf/roofline.py``'s kernel bounds over the timed buckets.
- A fit under ``TPU_ALS_AUTOTUNE=1`` tunes on one iteration of itself,
  keyed on its own problem's shape class: it never reads the synthetic
  timer's ``"generic"`` verdict, and its second run reads its own back
  with no trial.

Everything here is exact; no test asserts a time.
"""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_als.perf import autotune as jtune
from tpu_als_torch import obs as tobs
from tpu_als_torch import plan as tplan
from tpu_als_torch.core import als as tals
from tpu_als_torch.ops import cuda_gather_ne
from tpu_als_torch.perf import autotune
from tpu_als_torch.plan import cache as tcache

# the package rebinds ``perf.roofline`` to the function of that name
_rl = importlib.import_module("tpu_als_torch.perf.roofline")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = "TPU_ALS_PLAN_CACHE"
TINY = dict(n=32, w=4, max_w=64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny tensors: under the suite's
    workers a thread pool per small op mostly waits for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    monkeypatch.setenv(ENV, str(tmp_path / "plan"))
    monkeypatch.delenv(tplan.AUTOTUNE_ENV, raising=False)
    monkeypatch.delenv(autotune.TUNE_BAND_ENV, raising=False)
    tobs.reset()
    yield
    tobs.reset()


def _timer(values, source="device"):
    """An injected timer: the i-th trial takes ``values[i]`` seconds."""
    calls = []

    def timer(config):
        calls.append(dict(config))
        return values[len(calls) - 1]

    timer.source = source
    timer.calls = calls
    return timer


# -- the search -------------------------------------------------------------

def test_defaults_are_the_module_constants_and_trial_zero():
    assert autotune.default_config() == {
        "split_width": tals.SPLIT_WIDTH,
        "scratch_elems": cuda_gather_ne._SCRATCH_ELEMS}
    assert set(autotune.SPACE) == {"split_width", "scratch_elems"}
    trials = autotune.enumerate_configs()
    assert trials[0] == autotune.default_config()
    assert len(trials) == 1 + sum(len(v) - 1
                                  for v in autotune.SPACE.values()) == 8
    assert trials == autotune.enumerate_configs()
    # one knob at a time
    for t in trials[1:]:
        assert sum(t[k] != trials[0][k] for k in t) == 1
    # a restricted space without the default starts from its first value
    assert autotune.enumerate_configs({"split_width": [4096, 16384]}) == [
        dict(autotune.default_config(), split_width=4096),
        dict(autotune.default_config(), split_width=16384)]


def test_trial_zero_reads_the_constants_when_called(monkeypatch):
    """A patched constant (the idiom of the split-width route tests) is
    still the untuned path: trial 0 and the verdict's default_seconds."""
    monkeypatch.setattr(tals, "SPLIT_WIDTH", 1 << 12)
    monkeypatch.setattr(cuda_gather_ne, "_SCRATCH_ELEMS", 1 << 26)
    trials = autotune.enumerate_configs()
    assert trials[0] == {"split_width": 1 << 12, "scratch_elems": 1 << 26}
    # the patched defaults are not repeated as alternatives
    assert trials.count(trials[0]) == 1 and len(trials) == 8
    t = _timer([2.0] + [3.0] * 7)
    verdict = autotune.tune(rank=8, timer=t, **TINY)
    assert t.calls[0] == trials[0] and verdict["config"] == trials[0]
    assert verdict["default_seconds"] == 2.0


@pytest.mark.parametrize("space", [{"panel": [8]}, {"depth": [2, 8]},
                                   {"split_width": [4096], "max_wc": [1]}])
def test_unknown_knob_is_a_value_error(space, capsys):
    from tpu_als_torch.cli import main

    with pytest.raises(ValueError, match="unknown autotune knob"):
        autotune.enumerate_configs(space)
    with pytest.raises(ValueError, match="unknown autotune knob"):
        autotune.tune(rank=8, space=space, timer=_timer([1.0] * 8))
    with pytest.raises(SystemExit) as ei:
        main(["plan", "tune", "--rank", "8", "--device", "cpu",
              "--space", json.dumps(space)])
    assert ei.value.code == 2
    assert "unknown autotune knob" in capsys.readouterr().err


def test_strict_minimum_ties_to_the_earlier_trial():
    v = [5.0, 6.0, 4.0, 7.0, 4.0, 4.0, 9.0, 4.0]
    verdict = autotune.tune(rank=128, timer=_timer(v), **TINY)
    configs = autotune.enumerate_configs()
    assert verdict["config"] == configs[2] and verdict["measured_seconds"] \
        == 4.0 and verdict["default_seconds"] == 5.0
    assert [t["seconds"] for t in verdict["trials"]] == v
    # all equal: the defaults win
    flat = autotune.tune(rank=128, timer=_timer([3.0] * 8), **TINY)
    assert flat["config"] == autotune.default_config()
    assert set(flat) == {"config", "measured_seconds", "default_seconds",
                         "model_seconds", "source", "trials",
                         "tune_seconds", "shape"}
    assert len(tobs.events("tune_trial")) == 16


def test_same_timer_same_verdict():
    vals = [2.0, 1.5, 3.0, 1.0, 2.5, 1.25, 4.0, 0.5]
    a = autotune.tune(rank=64, timer=_timer(vals), seed=3, **TINY)
    b = autotune.tune(rank=64, timer=_timer(vals), seed=3, **TINY)
    for k in ("config", "measured_seconds", "default_seconds",
              "model_seconds", "source", "trials", "shape"):
        assert a[k] == b[k]
    assert a["config"] == dict(autotune.default_config(),
                               scratch_elems=1 << 26)
    assert a["source"] == "device"


def test_budget_stops_after_the_defaults():
    t = _timer([1.0] * 8)
    verdict = autotune.tune(rank=8, timer=t, budget_s=0.0, **TINY)
    assert len(t.calls) == 1 and verdict["config"] == t.calls[0] == \
        autotune.default_config()


def test_feasible_rejects_what_the_kernels_do_not_take():
    d = autotune.default_config()
    assert all(autotune.feasible(c, 128)
               for c in autotune.enumerate_configs())
    row128 = cuda_gather_ne._row_floats(128)
    for bad in ({"split_width": 0}, {"split_width": -8},
                {"split_width": (1 << 18) + 1}, {"scratch_elems": None},
                {"scratch_elems": row128 - 1}, {"scratch_elems": 1 << 29},
                {"split_width": "wide"}):
        assert not autotune.feasible(dict(d, **bad), 128), bad
    assert autotune.feasible(dict(d, scratch_elems=row128), 128)
    assert not autotune.feasible({"split_width": 8192}, 128)
    # rank-dependent: 2^18 floats hold no rank-512 row (262,656 floats)
    assert autotune.feasible(dict(d, scratch_elems=1 << 18), 256)
    assert not autotune.feasible(dict(d, scratch_elems=1 << 18), 512)
    # above K4's rank its scratch is never used
    assert autotune.feasible(dict(d, scratch_elems=1), 640)
    assert not autotune.feasible(d, cuda_gather_ne.GRAM_MAX_RANK + 1)
    # the search skips an infeasible config and never banks it
    t = _timer([2.0, 1.0])
    verdict = autotune.tune(rank=512, timer=t, space={
        "scratch_elems": [1 << 18, 1 << 22, 1 << 28]}, **TINY)
    assert [c["scratch_elems"] for c in t.calls] == [1 << 28, 1 << 22]
    assert verdict["config"]["scratch_elems"] == 1 << 22
    assert [c["config"]["scratch_elems"] for c in verdict["trials"]] == [
        1 << 28, 1 << 22]


@pytest.mark.parametrize("env", [None, "1.5", "3", "bogus", "0.5"])
def test_drift_band_as_the_reference(monkeypatch, env):
    if env is not None:
        monkeypatch.setenv(autotune.TUNE_BAND_ENV, env)
    assert autotune.tune_band() == jtune.tune_band()
    for banked, current, band in ((1.0, 1.9, None), (1.0, 2.1, None),
                                  (2.0, 0.9, None), (0.0, 5.0, None),
                                  (1.0, None, 2.0), (3.0, 4.0, 1.2),
                                  (3.0, 3.3, 1.2), (1e-9, 1.0, 1e9)):
        assert autotune.drifted(banked, current, band) == \
            jtune.drifted(banked, current, band), (banked, current, band)


def test_model_seconds_is_the_roofline_bounds_over_the_buckets():
    shapes = autotune.bucket_shapes(**TINY)
    assert shapes == [(4, 32), (8, 16), (16, 8), (32, 8), (64, 8)]
    timed = autotune.synthetic_shapes(**TINY)
    assert timed == [(w, n, n * (w - w // 5)) for w, n in shapes]
    assert autotune.bucket_shapes(4096, 64, 1 << 17)[-1] == (1 << 17, 8)
    # every default bucket fits one split value and not another
    widths = [w for w, _ in autotune.bucket_shapes(4096, 64, 1 << 17)]
    for s in autotune.SPACE["split_width"]:
        assert min(widths) <= s < max(widths)
    r = 8
    k4 = autotune.default_config()
    k3 = dict(k4, split_width=2)
    ms4 = ms3 = 0.0   # summed in bucket order, as model_seconds sums
    for w, n in shapes:
        ms4 += _rl.fused_solve_bound(n * w, n * (w - w // 5), n, r)[0]
        ms3 += (_rl.gram_bound(n * w, n * (w - w // 5), n, r)[0]
                + _rl.solve_bound(n, r)[0])
    assert autotune.model_seconds(k4, r, timed) == ms4 / 1e3
    assert autotune.model_seconds(k3, r, timed) == ms3 / 1e3
    # bytes bound at rank 8: a bfloat16 fit's table moves fewer
    bf = autotune.model_seconds(k4, r, timed, "bfloat16")
    assert 0 < bf < ms4 / 1e3


def test_data_shapes_count_each_buckets_rows_and_real_entries():
    from tpu_als_torch.core.ratings import build_csr_buckets

    g = np.random.default_rng(1)
    u, i = g.integers(0, 30, 400), g.integers(0, 20, 400)
    r = g.uniform(1, 5, 400).astype(np.float32)
    ucsr = build_csr_buckets(u, i, r, 30, min_width=4)
    icsr = build_csr_buckets(i, u, r, 20, min_width=4)
    shapes = autotune.data_shapes(ucsr, icsr)
    assert shapes == [(b.width, b.cols.shape[0], int(b.mask.sum()))
                      for c in (ucsr, icsr) for b in c.buckets]
    assert sum(s[2] for s in shapes) == 2 * 400


def test_make_timer_runs_the_plain_half_step_on_the_cpu():
    timer = autotune.make_timer(8, "float32", device="cpu", **TINY)
    assert timer.source == "plain"
    assert timer.shapes == autotune.synthetic_shapes(**TINY)
    for config in autotune.enumerate_configs():
        assert timer(config) > 0
    verdict = tplan.resolve_kernel_config(rank=8, tune=True, device="cpu",
                                          **TINY)
    assert autotune.feasible(verdict, 8)
    (entry,) = [d for _, d in tcache.list_entries()]
    assert entry["plan_key"]["shape_class"] == "generic"
    prov = entry["components"]["kernel_config"]["provenance"]
    assert prov["source"] == "plain" and prov["trials"] == 8
    assert prov["model_seconds"] == autotune.model_seconds(
        verdict, 8, autotune.synthetic_shapes(**TINY))
    assert prov["model"]["shape"] == dict(TINY, rank=8, k=3, seed=0)


def test_a_trial_that_raises_fails_the_search_naming_its_config():
    def timer(config):
        if config["scratch_elems"] == 1 << 22:
            raise RuntimeError("launch failed")
        return 1.0

    with pytest.raises(RuntimeError, match="'scratch_elems': 4194304"):
        tplan.resolve_kernel_config(rank=8, tune=True, device="cpu",
                                    timer=timer)
    assert tcache.list_entries() == []


# -- the planner's component ------------------------------------------------

def _types():
    return [e["type"] for e in tobs.events()
            if e["type"].startswith(("plan_", "tune_"))]


def test_cold_tune_banks_and_warm_reads_with_no_trial():
    assert tplan.resolve_kernel_config(rank=8, device="cpu") is None
    assert _types() == []
    cold = tplan.resolve_kernel_config(
        rank=8, tune=True, device="cpu",
        timer=_timer([3.0, 2.0] + [5.0] * 6))
    assert cold == autotune.enumerate_configs()[1]
    assert _types() == ["plan_cache_miss"] + ["tune_trial"] * 8 + [
        "plan_tuned", "plan_resolved"]
    tuned = tobs.events("plan_tuned")[0]
    assert tuned["source"] == "device" and tuned["measured_seconds"] == 2.0
    tobs.reset()
    warm = tplan.resolve_kernel_config(rank=8, tune=True, device="cpu",
                                       timer=_timer([]))
    assert warm == cold and _types() == ["plan_cache_hit", "plan_resolved"]
    assert tobs.events("plan_resolved")[0]["source"] == "cache"


def test_plain_verdict_never_overrides_a_device_bank():
    banked = tplan.resolve_kernel_config(
        rank=8, tune=True, device="cpu",
        timer=_timer([3.0, 2.0] + [5.0] * 6, source="device"))
    tobs.reset()
    again = tplan.resolve_kernel_config(
        rank=8, tune=True, force=True, device="cpu",
        timer=_timer([1.0] * 8, source="plain"))
    assert again == banked
    assert any("never-override" in e["reason"]
               for e in tobs.events("warning"))
    (entry,) = [d for _, d in tcache.list_entries()]
    prov = entry["components"]["kernel_config"]["provenance"]
    assert prov["source"] == "device" and prov["measured_seconds"] == 2.0
    # a device verdict under force does replace it
    forced = tplan.resolve_kernel_config(
        rank=8, tune=True, force=True, device="cpu",
        timer=_timer([1.0] * 8, source="device"))
    assert forced == autotune.default_config()


def test_invalidate_forces_a_retune():
    assert not tplan.invalidate_kernel_config(rank=8, device="cpu")
    tplan.resolve_kernel_config(rank=8, tune=True, device="cpu",
                                timer=_timer([1.0] * 8))
    assert tplan.invalidate_kernel_config(rank=8, device="cpu",
                                          reason="drift")
    assert not tplan.invalidate_kernel_config(rank=8, device="cpu")
    assert tplan.resolve_kernel_config(rank=8, device="cpu") is None
    tobs.reset()
    t = _timer([2.0, 1.0] + [3.0] * 6)
    again = tplan.resolve_kernel_config(rank=8, tune=True, device="cpu",
                                        timer=t)
    assert len(t.calls) == 8 and again == autotune.enumerate_configs()[1]
    assert tobs.events("plan_cache_miss")[0]["reason"] == "invalidated"


def test_autotune_gate_tunes_on_a_miss(monkeypatch):
    monkeypatch.setenv(tplan.AUTOTUNE_ENV, "1")
    t = _timer([1.0] * 8)
    assert tplan.resolve_kernel_config(rank=8, device="cpu", timer=t) == \
        autotune.default_config()
    assert len(t.calls) == 8


def test_a_second_process_reads_the_bank_with_no_trial(tmp_path):
    tplan.resolve_kernel_config(rank=8, tune=True, device="cpu", **TINY)
    run = tmp_path / "obs"
    out = subprocess.run(
        [sys.executable, "-m", "tpu_als_torch.cli", "plan", "tune",
         "--rank", "8", "--device", "cpu", "--obs-dir", str(run),
         "--n", "32", "--w", "4", "--max-w", "64",
         "--bank-out", str(tmp_path / "bank.json")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    printed = json.loads(out.stdout.strip().splitlines()[-1])
    assert printed["provenance"]["source"] == "plain"
    types = [json.loads(x)["type"] for x in open(run / "events.jsonl")
             if x.strip()]
    assert "plan_cache_hit" in types and "tune_trial" not in types
    bank = json.loads((tmp_path / "bank.json").read_text())
    assert bank["metric"] == "autotune_fused_solve_speedup_cpu"
    assert bank["value"] == bank["default_seconds"] / bank["tuned_seconds"]


def test_a_fit_tunes_on_its_own_iteration(monkeypatch):
    """Under ``TPU_ALS_AUTOTUNE=1`` a fit ignores the synthetic timer's
    ``"generic"`` bank: it keys on its own problem, times one iteration
    of itself per trial (warm call + min-of-3), prices its own buckets,
    and its next run reads the verdict back with no trial."""
    from tpu_als_torch.core.ratings import build_csr_buckets

    g = np.random.default_rng(5)
    u, i = g.integers(0, 40, 500), g.integers(0, 24, 500)
    r = g.uniform(0.5, 5.0, 500).astype(np.float32)
    ucsr = build_csr_buckets(u, i, r, 40, min_width=4)
    icsr = build_csr_buckets(i, u, r, 24, min_width=4)
    tplan.resolve_kernel_config(rank=8, tune=True, device="cpu",
                                timer=_timer([2.0, 1.0] + [3.0] * 6))
    monkeypatch.setenv(tplan.AUTOTUNE_ENV, "1")
    steps = []
    real = tals.als_step

    def counting(*a, **k):
        steps.append(a[-1] if len(a) == 10 else k.get("knobs"))
        return real(*a, **k)

    monkeypatch.setattr(tals, "als_step", counting)
    cfg = tals.AlsConfig(rank=8, max_iter=1, implicit_prefs=True,
                         alpha=4.0, reg_param=0.05)
    tobs.reset()
    tals.train(ucsr, icsr, cfg, device="cpu")
    assert _types()[:10] == ["plan_cache_miss"] + ["tune_trial"] * 8 + [
        "plan_tuned"]
    # 8 trials of 4 timed-or-warm iterations, then the fit's one
    assert len(steps) == 8 * 4 + 1
    assert [s for s in steps[:-1:4]] == autotune.enumerate_configs()
    sc = tplan.shape_class(40, 24, 500)
    fit = [d for _, d in tcache.list_entries()
           if d["plan_key"]["shape_class"] == sc
           and "kernel_config" in d["components"]]
    (entry,) = fit
    comp = entry["components"]["kernel_config"]
    prov = comp["provenance"]
    assert prov["source"] == "plain" and prov["trials"] == 8
    assert prov["model"]["shape"] == {"rank": 8, "data": "fit",
                                      "n_users": 40, "n_items": 24,
                                      "nnz": 500, "k": 3}
    assert prov["model_seconds"] == autotune.model_seconds(
        comp["resolved"], 8, autotune.data_shapes(ucsr, icsr))
    assert steps[-1] == comp["resolved"]
    steps.clear()
    tobs.reset()
    tals.train(ucsr, icsr, cfg, device="cpu")
    assert "tune_trial" not in _types() and len(steps) == 1
    assert tobs.events("plan_resolved")[0]["source"] == "cache"


def test_plan_tune_data_warms_the_key_train_reads(monkeypatch, capsys):
    """``plan tune --data`` tunes on that data's fit and banks under the
    key ``train --data`` reads: the train run that follows, with the gate
    on, reads it back with no trial."""
    from tpu_als_torch.cli import main

    spec = "synthetic:40x24x500"
    main(["plan", "tune", "--rank", "8", "--device", "cpu", "--data", spec,
          "--reps", "1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    shape = out["provenance"]["model"]["shape"]
    assert out["provenance"]["source"] == "plain" and shape["data"] == "fit"
    assert out["provenance"]["trials"] == 8 and shape["k"] == 1
    monkeypatch.setenv(tplan.AUTOTUNE_ENV, "1")
    tobs.reset()
    main(["train", "--data", spec, "--rank", "8", "--max-iter", "1",
          "--implicit", "--device", "cpu"])
    capsys.readouterr()
    assert "tune_trial" not in _types()
    hits = [e for e in tobs.events("plan_cache_hit")
            if e["component"] == "kernel_config"]
    assert len(hits) == 1


@pytest.mark.parametrize("strategy", ["all_gather", "all_to_all",
                                      "all_gather_chunked"])
def test_a_sharded_fit_tunes_on_its_own_step(monkeypatch, strategy):
    """``train_sharded`` under the gate times its own sharded step and
    keys on its problem and mesh; the chunked gather, whose half-steps
    reach no K3 or K4, consults no knob."""
    from tpu_als_torch.parallel import a2a, data, trainer
    from tpu_als_torch.parallel.mesh import make_mesh

    g = np.random.default_rng(5)
    nu, ni, nnz, S = 200, 150, 600, 3
    u, i = g.integers(0, nu, nnz), g.integers(0, ni, nnz)
    r = g.uniform(0.5, 5.0, nnz).astype(np.float32)
    up = data.partition_balanced(np.bincount(u, minlength=nu), S)
    ip = data.partition_balanced(np.bincount(i, minlength=ni), S)
    if strategy == "all_to_all":
        us = a2a.build_a2a(up, ip, u, i, r, min_width=4)
        is_ = a2a.build_a2a(ip, up, i, u, r, min_width=4)
    else:
        us = data.shard_csr(up, ip, u, i, r, min_width=4)
        is_ = data.shard_csr(ip, up, i, u, r, min_width=4)
    monkeypatch.setenv(tplan.AUTOTUNE_ENV, "1")
    tobs.reset()
    trainer.train_sharded(make_mesh(devices=["cpu"] * S), up, ip, us, is_,
                          tals.AlsConfig(rank=4, max_iter=1),
                          strategy=strategy)
    tuned = [d for _, d in tcache.list_entries()
             if "kernel_config" in d["components"]]
    if strategy == "all_gather_chunked":
        assert tuned == [] and "tune_trial" not in _types()
        return
    (entry,) = tuned
    assert entry["plan_key"]["mesh_shape"] == [S]
    assert entry["plan_key"]["shape_class"] == tplan.shape_class(nu, ni,
                                                                 nnz)
    prov = entry["components"]["kernel_config"]["provenance"]
    assert prov["trials"] == 8 and prov["model"]["shape"]["data"] == "fit"
    assert prov["model_seconds"] == autotune.model_seconds(
        entry["components"]["kernel_config"]["resolved"], 4,
        autotune.data_shapes(us, is_))
