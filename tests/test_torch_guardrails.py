"""The port's numerical guardrails against the reference's.

The regimes of ``tests/test_guardrails.py``, each run through both
packages from the same numpy inputs: mode resolution, ``health_stats``,
each sentinel tripping, rollback (determinism, budget, the typed
``TrainDiverged``), 'recover' and 'warn' fits with the fault
``solve.gram=corrupt@nth=2`` from one injected init, and the estimator's
quarantine of poisoned ratings; and ``retry_call`` (the backoff
schedule, its events and exhaustion) against the reference's.  The
rollback's perturbation comes from a ``torch.Generator`` seeded by the
reference's formula; it cannot reproduce ``jax.random``'s draws, so the
tests hold its determinism and the contract (the same trips, rollbacks
and counts in both packages), and the fits' factors within a stated
band, not the draws.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_als import ALS as JALS
from tpu_als import ColumnarFrame as JFrame
from tpu_als import obs as jobs
from tpu_als.core.als import AlsConfig as JConfig
from tpu_als.core.als import train as jtrain
from tpu_als.core.ratings import build_csr_buckets as jbuild
from tpu_als.resilience import faults as jfaults
from tpu_als.resilience import guardrails as jg
from tpu_als.resilience import retry as jretry
import tpu_als_torch
from tpu_als_torch import cli, obs
from tpu_als_torch.core import als as tals
from tpu_als_torch.core.ratings import build_csr_buckets as tbuild
from tpu_als_torch.parallel.mesh import make_mesh
from tpu_als_torch.resilience import faults, guardrails, retry
from tpu_als_torch.resilience.guardrails import Monitor, TrainDiverged
from tpu_als_torch.resilience.retry import RetryPolicy

# a healthy fit's factors, port vs reference from one init (the
# reference's band for two solve paths over a few iterations)
ATOL, RTOL = 5e-4, 5e-3
# after a rollback the two packages restart from differently drawn
# perturbations of PERTURB_SCALE = 1e-3 (and a 10x regParam for that
# iteration): two more ALS iterations leave them within a few times that
RECOVER_ATOL = 1e-2


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    monkeypatch.delenv(guardrails.ENV_VAR, raising=False)
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    for g, f, o in ((guardrails, faults, obs), (jg, jfaults, jobs)):
        g.clear_mode()
        f.clear()
        o.reset()
    yield
    for g, f, o in ((guardrails, faults, obs), (jg, jfaults, jobs)):
        g.clear_mode()
        f.clear()
        o.reset()


def _jevents(etype):
    return [e for e in jobs.default_registry()._events if e["type"] == etype]


def _fields(events, *keys):
    return [tuple(e[k] for k in keys) for e in events]


@pytest.mark.parametrize("env", ["", "off", "warn", "recover", "recove",
                                 "loud"])
def test_mode_resolution_matches_reference(monkeypatch, env):
    monkeypatch.setenv(guardrails.ENV_VAR, env)
    if env in ("", "off", "warn", "recover"):
        assert guardrails.guardrails_mode() == jg.guardrails_mode() == \
            (env or "off")
        assert guardrails.armed() == jg.armed()
    else:
        for mod in (guardrails, jg):
            with pytest.raises(ValueError):
                mod.guardrails_mode()
    # set_mode beats the env; scoped restores on exit; clear_mode goes back
    guardrails.set_mode("warn")
    assert guardrails.guardrails_mode() == "warn"
    with guardrails.scoped("recover"):
        assert guardrails.guardrails_mode() == "recover"
    assert guardrails.guardrails_mode() == "warn"
    guardrails.clear_mode()
    for bad in ("loud", "Recover", None):
        with pytest.raises(ValueError, match="unknown guardrails mode"):
            guardrails.set_mode(bad)
    assert guardrails.MODES == jg.MODES
    assert guardrails.SENTINELS == jg.SENTINELS
    assert (guardrails.NORM_BAND_MAX, guardrails.TREND_FACTOR,
            guardrails.PERTURB_SCALE, guardrails.REG_BUMP_FACTOR) == \
        (jg.NORM_BAND_MAX, jg.TREND_FACTOR, jg.PERTURB_SCALE,
         jg.REG_BUMP_FACTOR)


def _uv(seed=0, nu=7, ni=5, r=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(nu, r)).astype(np.float32),
            rng.normal(size=(ni, r)).astype(np.float32))


def test_health_stats_match_reference():
    U, V = _uv()
    for poison in (False, True):
        if poison:
            U[3, 1] = np.nan
        got = guardrails.health_stats(torch.from_numpy(U),
                                      torch.from_numpy(V)).numpy()
        ref = np.asarray(jg.health_stats(jnp.asarray(U), jnp.asarray(V)))
        assert got.dtype == np.float32 and got.shape == (4,)
        assert got[0] == ref[0] == (0.0 if poison else 1.0)
        if not poison:
            np.testing.assert_allclose(got, ref, rtol=1e-6)


def _judge_script(mon, U, V, put):
    """The sentinel sequence of the reference's test: a healthy baseline,
    then NaN, a row past the band, a global jump within the band."""
    U2 = U.copy()
    U2[0] = 1e5
    return [mon.judge(1, put(U), put(V)),
            mon.judge(2, put(U * np.nan), put(V)),
            mon.judge(3, put(U2), put(V)),
            mon.judge(4, put(U * 300.0), put(V * 300.0))]


def test_each_sentinel_trips_as_in_reference():
    U, V = _uv(1, 6)
    got = _judge_script(Monitor(tals.AlsConfig(rank=4), "warn"), U, V,
                        torch.from_numpy)
    ref = _judge_script(jg.Monitor(JConfig(rank=4), "warn"), U, V,
                        jnp.asarray)
    assert got == ref == [None, "nonfinite", "norm_band", "trend"]
    evs = obs.events("guardrail_tripped")
    assert _fields(evs, "iteration", "sentinel", "mode") == \
        _fields(_jevents("guardrail_tripped"), "iteration", "sentinel",
                "mode")
    np.testing.assert_allclose([e["value"] for e in evs],
                               [e["value"] for e in
                                _jevents("guardrail_tripped")], rtol=1e-5)


def test_trend_baseline_only_advances_when_healthy():
    U, V = (torch.from_numpy(x) for x in _uv(2, 6))
    mon = Monitor(tals.AlsConfig(rank=4), "warn")
    assert mon.judge(1, U, V) is None
    base = mon._prev_fro
    assert mon.judge(2, U * torch.nan, V) == "nonfinite"
    assert mon._prev_fro == base
    assert mon.judge(3, U * 2.0, V * 2.0) is None
    assert mon._prev_fro > base


def test_rollback_perturbs_bumps_reg_and_replays():
    U, V = (torch.from_numpy(x) for x in _uv(3, 6))
    outs = []
    for _ in range(2):
        mon = Monitor(tals.AlsConfig(rank=4, seed=3, reg_param=0.1),
                      "recover")
        mon.keep_last_good(U, V)
        U2, V2, scale = mon.rollback(2, "nonfinite")
        assert scale == guardrails.REG_BUMP_FACTOR
        assert not torch.equal(U2, U)
        # within PERTURB_SCALE noise of the snapshot
        torch.testing.assert_close(U2, U, atol=1e-2, rtol=0)
        torch.testing.assert_close(V2, V, atol=1e-2, rtol=0)
        outs.append((U2, V2))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    # another iteration (or attempt) draws other noise
    mon = Monitor(tals.AlsConfig(rank=4, seed=3), "recover")
    mon.keep_last_good(U, V)
    assert not torch.equal(mon.rollback(3, "trend")[0], outs[0][0])
    assert obs.counter_value("train.rollbacks") == 3
    ev = obs.events("train_rollback")[0]
    assert (ev["attempt"], ev["sentinel"]) == (1, "nonfinite")
    np.testing.assert_allclose(ev["reg_param"],
                               0.1 * guardrails.REG_BUMP_FACTOR)


def test_rollback_budget_and_snapshot_rules():
    U, V = (torch.from_numpy(x) for x in _uv(4, 6))
    mon = Monitor(tals.AlsConfig(rank=4), "recover",
                  policy=RetryPolicy(max_attempts=1, base_delay=0.0,
                                     jitter=0.0))
    mon.keep_last_good(U, V)
    mon.rollback(2, "nonfinite")
    with pytest.raises(TrainDiverged) as ei:
        mon.rollback(2, "nonfinite")
    assert (ei.value.rollbacks, ei.value.sentinel) == (1, "nonfinite")
    with pytest.raises(TrainDiverged):
        Monitor(tals.AlsConfig(rank=4), "recover").rollback(1, "nonfinite")
    mon = Monitor(tals.AlsConfig(rank=4), "recover")
    mon.keep_last_good(U, V)
    mon.keep_last_good(U * torch.nan, V, retry=True)
    assert torch.isfinite(mon._snap[0]).all()
    # the snapshot is a copy: writing the factors afterwards leaves it
    U[0] = torch.nan
    assert torch.isfinite(mon._snap[0]).all()
    with pytest.raises(ValueError):
        Monitor(tals.AlsConfig(rank=4), "off")


def _retry_both(monkeypatch, fn_for, **policy_kw):
    """``retry_call`` of each package under the same policy; per package
    the sleeps, the ``on_attempt`` infos, the events, and the result or
    the exception."""
    monkeypatch.delenv("TPU_ALS_TRACE", raising=False)
    out = []
    for mod, o, events in ((retry, obs, obs.events), (jretry, jobs,
                                                      _jevents)):
        sleeps, infos = [], []
        pol = mod.RetryPolicy(sleep=sleeps.append, **policy_kw)
        try:
            res = mod.retry_call(fn_for(), policy=pol, what="flaky",
                                 on_attempt=infos.append)
        except Exception as e:  # compared across the packages below
            res = e
        evs = ([_fields(events("retry_attempt"), "what", "attempt",
                        "attempts", "reason"),
                _fields(events("retry_exhausted"), "what", "attempts",
                        "reason")])
        for i in infos:
            assert i.pop("elapsed_seconds") >= 0
        out.append((sleeps, infos, evs, res))
    return out


def _failing(n, exc=OSError):
    def make():
        calls = [0]

        def flaky(x=3):
            calls[0] += 1
            if calls[0] <= n:
                raise exc(f"transient {calls[0]}")
            return x * 14
        return flaky
    return make


@pytest.mark.parametrize("fails,policy", [
    (0, dict()),
    (2, dict()),
    (2, dict(max_attempts=3, jitter=0.0, base_delay=0.5, factor=3.0,
             max_delay=1.0)),
    (4, dict(max_attempts=5, seed=7, jitter=1.0, factor=1.0)),
    (3, dict(max_attempts=3, seed=11)),
    (1, dict(max_attempts=1)),
])
def test_retry_call_schedule_and_events_match_reference(monkeypatch, fails,
                                                        policy):
    """The backoff schedule (same ``random.Random(seed)`` draws, so
    equal to the bit), the attempt events and infos, and exhaustion."""
    (ps, pi, pe, pr), (js, ji, je, jr) = _retry_both(
        monkeypatch, _failing(fails), **policy)
    assert ps == js and pi == ji and pe == je
    attempts = policy.get("max_attempts", 3)
    assert len(pi) == min(fails, attempts)
    assert len(ps) == min(fails, attempts - 1)
    if fails < attempts:
        assert pr == jr == 42
    else:
        assert isinstance(pr, retry.RetryExhausted)
        assert isinstance(jr, jretry.RetryExhausted)
        assert str(pr) == str(jr)
        assert (pr.attempts, str(pr.last)) == (jr.attempts, str(jr.last))
        assert len(pe[1]) == 1


def test_retry_call_passes_non_transient_errors_and_times_out(monkeypatch):
    (ps, pi, pe, pr), (js, ji, je, jr) = _retry_both(
        monkeypatch, _failing(1, ValueError))
    assert isinstance(pr, ValueError) and isinstance(jr, ValueError)
    assert ps == js == [] and pi == ji == [] and pe == je == [[], []]
    obs.reset()
    jobs.reset()
    release = threading.Event()
    try:
        (ps, pi, pe, pr), (js, ji, je, jr) = _retry_both(
            monkeypatch, lambda: (lambda: release.wait(5.0)),
            max_attempts=2, timeout=0.05, jitter=0.0)
    finally:
        release.set()
    for r, mod in ((pr, retry), (jr, jretry)):
        assert isinstance(r, mod.RetryExhausted)
        assert isinstance(r.last, mod.AttemptTimeout)
    assert ps == js and pi == ji and pe == je
    for bad in (dict(max_attempts=0), dict(base_delay=-1.0),
                dict(jitter=1.5)):
        for mod in (retry, jretry):
            with pytest.raises(ValueError):
                mod.RetryPolicy(**bad)


def _unit_rows(rng, n, r):
    x = rng.normal(size=(n, r)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _problem(nu=80, ni=60, nnz=1500, r=4, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, nu, nnz)
    i = rng.integers(0, ni, nnz)
    v = rng.uniform(0.5, 5.0, nnz).astype(np.float32)
    return (u, i, v, nu, ni, _unit_rows(rng, nu, r), _unit_rows(rng, ni, r))


_PORT = (tbuild, tals.AlsConfig, tals.train, guardrails, faults,
         {"device": "cpu"})
_REF = (jbuild, JConfig, jtrain, jg, jfaults, {})


def _fit_both(mode, spec, max_iter=4, packages=(_PORT, _REF), **kw):
    """The same fit through both packages under ``mode`` and the fault
    ``spec``, from one injected init."""
    u, i, v, nu, ni, U0, V0 = _problem()
    out = []
    for build, cfg_t, train, g, f, extra in packages:
        cfg = cfg_t(rank=4, max_iter=max_iter, reg_param=0.1, **kw)
        if spec:
            f.install(spec)
        with g.scoped(mode):
            U, V = train(build(u, i, v, nu, min_width=4,
                               chunk_elems=1 << 12),
                         build(i, u, v, ni, min_width=4,
                               chunk_elems=1 << 12),
                         cfg, init=(U0, V0), **extra)
        f.clear()
        out.append((np.asarray(U), np.asarray(V)))
    return out


def test_disarmed_and_warn_are_bitwise_the_plain_fit():
    off, = _fit_both("off", None, packages=(_PORT,))
    warn, = _fit_both("warn", None, packages=(_PORT,))
    np.testing.assert_array_equal(off[0], warn[0])
    np.testing.assert_array_equal(off[1], warn[1])
    assert not obs.events("guardrail_tripped")


def test_healthy_recover_fit_matches_reference():
    (tU, tV), (jU, jV) = _fit_both("recover", None)
    np.testing.assert_allclose(tU, jU, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tV, jV, atol=ATOL, rtol=RTOL)
    assert obs.counter_value("train.rollbacks") == 0


def test_recover_rolls_back_the_injected_nan_once():
    (tU, tV), (jU, jV) = _fit_both("recover", "solve.gram=corrupt@nth=2")
    assert np.isfinite(tU).all() and np.isfinite(tV).all()
    assert obs.counter_value("train.rollbacks") == \
        jobs.counter_value("train.rollbacks") == 1
    assert _fields(obs.events("guardrail_tripped"), "iteration",
                   "sentinel") == \
        _fields(_jevents("guardrail_tripped"), "iteration", "sentinel") \
        == [(2, "nonfinite")]
    assert _fields(obs.events("train_rollback"), "iteration", "attempt") \
        == _fields(_jevents("train_rollback"), "iteration", "attempt") \
        == [(2, 1)]
    assert _fields(obs.events("fault_injected"), "point", "hit") == \
        [("solve.gram", 2)]
    np.testing.assert_allclose(tU, jU, atol=RECOVER_ATOL, rtol=0)
    np.testing.assert_allclose(tV, jV, atol=RECOVER_ATOL, rtol=0)
    # the recovery replays exactly
    (tU2, tV2), = _fit_both("recover", "solve.gram=corrupt@nth=2",
                            packages=(_PORT,))
    np.testing.assert_array_equal(tU, tU2)
    np.testing.assert_array_equal(tV, tV2)


def test_warn_trips_and_never_rolls_back():
    (tU, _), (jU, _) = _fit_both("warn", "solve.gram=corrupt@nth=2",
                                 max_iter=3)
    assert _fields(obs.events("guardrail_tripped"), "sentinel") == \
        _fields(_jevents("guardrail_tripped"), "sentinel")
    assert obs.events("guardrail_tripped")
    assert obs.counter_value("train.rollbacks") == \
        jobs.counter_value("train.rollbacks") == 0
    assert not obs.events("train_rollback")
    assert not np.isfinite(tU).all() and not np.isfinite(jU).all()


def test_budget_spent_raises_train_diverged_in_both():
    u, i, v, nu, ni, U0, V0 = _problem()
    for build, cfg, train, g, f, extra in (
            (tbuild, tals.AlsConfig(rank=4, max_iter=4), tals.train,
             guardrails, faults, {"device": "cpu"}),
            (jbuild, JConfig(rank=4, max_iter=4), jtrain, jg, jfaults, {})):
        f.install("solve.gram=corrupt@every=1")
        with g.scoped("recover"):
            with pytest.raises(g.TrainDiverged) as ei:
                train(build(u, i, v, nu, min_width=4),
                      build(i, u, v, ni, min_width=4), cfg,
                      init=(U0, V0), **extra)
        assert ei.value.rollbacks == 3
        f.clear()


def _poisoned(seed=5, n=200):
    rng = np.random.default_rng(seed)
    r = rng.uniform(1.0, 5.0, n).astype(np.float32)
    r[7], r[13], r[21] = np.nan, 1e9, -np.inf
    return {"user": rng.integers(0, 30, n), "item": rng.integers(0, 20, n),
            "rating": r}


@pytest.mark.parametrize("mode", ["warn", "recover"])
def test_estimator_quarantines_as_the_reference(mode):
    data = _poisoned()
    model = tpu_als_torch.ALS(rank=4, maxIter=2, guardrails=mode,
                              device="cpu").fit(data)
    JALS(rank=4, maxIter=2, guardrails=mode).fit(JFrame(dict(data)))
    assert torch.isfinite(model._U).all() and torch.isfinite(model._V).all()
    assert obs.counter_value("ingest.quarantined_rows") == \
        jobs.counter_value("ingest.quarantined_rows") == 3
    keys = ("path", "rows", "reasons")
    assert _fields(obs.events("ingest_quarantined"), *keys) == \
        _fields(_jevents("ingest_quarantined"), *keys)
    assert obs.events("ingest_quarantined")[0]["reasons"] == \
        {"malformed": 0, "nonfinite": 2, "out_of_range": 1}
    # the fit ran armed, and the process's mode is back to 'off' after it
    assert guardrails.guardrails_mode() == "off"


def test_estimator_env_mode_and_mesh_fit_quarantine(monkeypatch):
    monkeypatch.setenv(guardrails.ENV_VAR, "warn")
    tpu_als_torch.ALS(rank=4, maxIter=1, device="cpu").fit(_poisoned())
    mesh = make_mesh(devices=["cpu"] * 2)
    model = tpu_als_torch.ALS(rank=4, maxIter=1, mesh=mesh,
                              guardrails="recover").fit(_poisoned(6))
    assert torch.isfinite(model._U).all()
    assert obs.counter_value("ingest.quarantined_rows") == 6
    # guardrails='off' overrides the env: poisoned ratings fail the fit
    with pytest.raises(ValueError, match="non-finite"):
        tpu_als_torch.ALS(rank=4, maxIter=1, guardrails="off",
                          device="cpu").fit(_poisoned())


def test_estimator_disarmed_rejects_and_unknown_modes_raise():
    with pytest.raises(ValueError, match="non-finite"):
        tpu_als_torch.ALS(rank=4, maxIter=2, device="cpu").fit(_poisoned())
    for bad in ("loud", "Warn"):
        with pytest.raises(ValueError, match="unknown guardrails mode"):
            tpu_als_torch.ALS(guardrails=bad)
        with pytest.raises(ValueError, match="unknown guardrails mode"):
            JALS(guardrails=bad)


def test_cli_train_recover_under_a_fault_spec(tmp_path, monkeypatch,
                                              capsys):
    monkeypatch.setenv(faults.ENV_VAR, "solve.gram=corrupt@nth=1")
    out = tmp_path / "m"
    cli.main(["train", "--data", "synthetic:300x120x6000", "--rank", "4",
              "--max-iter", "3", "--device", "cpu", "--guardrails",
              "recover", "--output", str(out)])
    assert np.isfinite(json.loads(capsys.readouterr().out)["holdout_rmse"])
    with open(out / "obs" / "events.jsonl") as f:
        types = [json.loads(line)["type"] for line in f]
    for t in ("fault_injected", "guardrail_tripped", "train_rollback",
              "snapshot"):
        assert t in types
    with open(out / "obs" / "run_manifest.json") as f:
        manifest = json.load(f)
    assert manifest["torch"] == torch.__version__
    monkeypatch.setenv(faults.ENV_VAR, "solve.gram=explode")
    with pytest.raises(SystemExit) as ei:
        cli.main(["train", "--data", "synthetic:30x12x60", "--device",
                  "cpu"])
    assert ei.value.code == 2
    assert "FaultSpecError" in capsys.readouterr().err
    assert os.environ[faults.ENV_VAR] == "solve.gram=explode"
