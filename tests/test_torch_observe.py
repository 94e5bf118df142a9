"""The port's fit observability and numerical-safety tools against the
reference's, on the CPU:

- ``utils/observe.py``: ``IterationLogger`` on equal factors (the port
  handed tensors) writes the reference's records, field for field but
  the two times, bitwise; ``trace`` degrades to the reference's warning
  events (``trace_unavailable``, ``trace_skipped``, ``trace_stop_failed``)
  and lets the body's own exceptions through; a working ``trace`` writes
  a Chrome trace that names the ``train.fit`` span;
- ``utils/debug.py``: ``checked_predict``'s four messages are the
  reference's, ``debug_mode`` raises at the first NaN-producing op and
  restores the dispatch state, ``assert_all_finite``'s message is the
  reference's;
- ``obs``: ``active``, ``update_manifest`` and ``maybe_rotate``
  (``TPU_ALS_OBS_ROTATE_BYTES``) behave as the reference's; the readers
  ``obs/report.py`` and ``obs/explain.py`` give the reference's output
  on the same (rotated) trail.
"""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify
from torch.utils._python_dispatch import _get_current_dispatch_mode

from tpu_als import obs as jobs
from tpu_als.obs import explain as jexplain
from tpu_als.obs import metrics as jmetrics
from tpu_als.obs import report as jreport
from tpu_als.utils import debug as jdebug
from tpu_als.utils import observe as jobserve
from tpu_als_torch import obs as tobs
from tpu_als_torch.obs import explain as texplain
from tpu_als_torch.obs import metrics as tmetrics
from tpu_als_torch.obs import report as treport
from tpu_als_torch.utils import debug as tdebug
from tpu_als_torch.utils import observe as tobserve

TIMES = ("seconds", "total_seconds")


@pytest.fixture(autouse=True)
def _fresh():
    jobs.reset()
    tobs.reset()
    yield
    jobs.reset()
    tobs.reset()


def _factors(seed=0):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(30, 5)).astype(np.float32)
    V = rng.normal(size=(20, 5)).astype(np.float32)
    probe = (rng.integers(0, 30, 64), rng.integers(0, 20, 64),
             rng.uniform(1, 5, 64).astype(np.float32))
    return U, V, probe


def _untimed(rec):
    return {k: v for k, v in rec.items() if k not in TIMES}


def test_iteration_logger_matches_reference(tmp_path):
    U, V, probe = _factors()
    tpath, jpath = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    with tobserve.IterationLogger(probe=probe, stream=None,
                                  path=str(tpath)) as tl, \
            jobserve.IterationLogger(probe=probe, stream=None,
                                     path=str(jpath)) as jl:
        assert not tpath.exists()   # opened lazily, at the first record
        for it in (1, 2):
            tl(it, torch.from_numpy(U * it), torch.from_numpy(V))
            jl(it, U * it, V)
    assert [_untimed(r) for r in tl.records] == \
        [_untimed(r) for r in jl.records]
    assert set(tl.records[0]) == set(jl.records[0]) >= {"probe_rmse",
                                                         *TIMES}
    lines = [json.loads(x) for x in tpath.read_text().splitlines()]
    assert [_untimed(r) for r in lines] == [_untimed(r) for r in tl.records]
    # closed: a later record is kept in memory only
    tl(3, torch.from_numpy(U), torch.from_numpy(V))
    assert len(tpath.read_text().splitlines()) == 2
    # no probe: no probe_rmse, as the reference
    t, j = tobserve.IterationLogger(stream=None), \
        jobserve.IterationLogger(stream=None)
    t(1, torch.from_numpy(U), torch.from_numpy(V))
    j(1, U, V)
    assert _untimed(t.records[0]) == _untimed(j.records[0])


def _warnings(mod):
    return [e["what"] for e in mod.events("warning")] \
        if hasattr(mod, "events") else \
        [e["what"] for e in mod.default_registry()._events
         if e["type"] == "warning"]


def test_trace_degrades_like_the_reference(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no profiler here")

    ran = []
    monkeypatch.setattr(tobserve, "_start_profiler", boom)
    with tobserve.trace(str(tmp_path / "t")):
        ran.append("port")
    import jax

    monkeypatch.setattr(jax.profiler, "start_trace", boom)
    with jobserve.trace(str(tmp_path / "j")):
        ran.append("ref")
    assert ran == ["port", "ref"]
    assert _warnings(tobs) == _warnings(jobs) == ["trace_unavailable"]
    assert not tobserve._trace_active


def test_trace_nested_and_stop_failure(tmp_path, monkeypatch):
    d = str(tmp_path / "prof")
    with tobserve.trace(d):
        assert tobserve._trace_active
        with tobserve.trace(d):   # nested: skipped, the outer one runs on
            torch.ones(8) @ torch.ones(8)
    assert not tobserve._trace_active
    assert _warnings(tobs) == ["trace_skipped"]
    assert len(glob.glob(os.path.join(d, "*.json"))) == 1

    def boom(prof, logdir):
        prof.stop()
        raise OSError("disk full")

    monkeypatch.setattr(tobserve, "_stop_profiler", boom)
    with pytest.raises(ValueError, match="the body's own"):
        with tobserve.trace(d):
            raise ValueError("the body's own")
    assert not tobserve._trace_active
    assert _warnings(tobs) == ["trace_skipped", "trace_stop_failed"]


def test_trace_of_a_fit_names_its_spans(tmp_path):
    from tpu_als_torch.api.estimator import ALS

    rng = np.random.default_rng(0)
    frame = {"user": rng.integers(0, 40, 600),
             "item": rng.integers(0, 30, 600),
             "rating": rng.uniform(1, 5, 600).astype(np.float32)}
    with tobserve.trace(str(tmp_path)):
        ALS(rank=4, maxIter=2, device="cpu").fit(frame)
    (path,) = glob.glob(str(tmp_path / "*.json"))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert {"train.block", "train.fit"} <= names


@pytest.mark.parametrize("u,i", [([10], [0]), ([-1], [0]), ([0], [-1]),
                                 ([0], [8]), ([-1], [8])])
def test_checked_predict_messages_are_the_references(u, i):
    rng = np.random.default_rng(1)
    U = rng.normal(size=(10, 4)).astype(np.float32)
    V = rng.normal(size=(8, 4)).astype(np.float32)
    with pytest.raises(checkify.JaxRuntimeError) as ref:
        jdebug.checked_predict(jnp.asarray(U), jnp.asarray(V), np.array(u),
                               np.array(i))
    with pytest.raises(tdebug.IndexCheckError) as got:
        tdebug.checked_predict(torch.from_numpy(U), torch.from_numpy(V),
                               np.array(u), np.array(i))
    assert str(ref.value).startswith(str(got.value))
    assert isinstance(got.value, IndexError)


def test_checked_predict_scores():
    rng = np.random.default_rng(2)
    U = rng.normal(size=(10, 4)).astype(np.float32)
    V = rng.normal(size=(8, 4)).astype(np.float32)
    u, i = np.array([0, 9, 3]), np.array([7, 3, 0])
    got = tdebug.checked_predict(torch.from_numpy(U), torch.from_numpy(V),
                                 u, i)
    want = jdebug.checked_predict(jnp.asarray(U), jnp.asarray(V), u, i)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_debug_mode_raises_on_nan_and_restores():
    before = _get_current_dispatch_mode()
    with pytest.raises(FloatingPointError, match="aten.log"):
        with tdebug.debug_mode():
            ok = torch.zeros(3) - 1.0   # finite: passes
            torch.log(ok)
    assert _get_current_dispatch_mode() is before
    assert torch.isnan(torch.log(torch.zeros(3) - 1.0)).all()
    # nans=False, and disable_jit (eager torch has none), change nothing
    with tdebug.debug_mode(nans=False, disable_jit=True):
        assert torch.isnan(torch.log(torch.zeros(1) - 1.0)).all()
    with tdebug.debug_mode(disable_jit=True):
        assert torch.isfinite(torch.log(torch.ones(2))).all()
    assert _get_current_dispatch_mode() is before


def test_assert_all_finite_messages_are_the_references():
    ok = np.ones((3, 2), np.float32)
    tdebug.assert_all_finite(1, torch.from_numpy(ok), ok)
    bad = ok.copy()
    bad[1, 1] = np.nan
    bad[2, 0] = np.inf
    with pytest.raises(FloatingPointError) as ref:
        jdebug.assert_all_finite(7, ok, bad)
    with pytest.raises(FloatingPointError) as got:
        tdebug.assert_all_finite(7, torch.from_numpy(ok),
                                 torch.from_numpy(bad))
    assert str(got.value) == str(ref.value)


def test_active_and_update_manifest_like_the_reference(tmp_path):
    for mod, d in ((tobs, tmp_path / "t"), (jobs, tmp_path / "j")):
        assert not mod.active()
        mod.update_manifest(ignored=1)   # no run: a no-op
        mod.configure(str(d), config={"a": 1}, argv=["x"])
        assert mod.active()
        mod.update_manifest(resolved="auto", shards=4)
        mod.finalize()
        mod.deconfigure()
        assert not mod.active()
        man = json.load(open(d / "run_manifest.json"))
        assert man["resolved"] == "auto" and man["shards"] == 4
        assert "ignored" not in man and man["config"] == {"a": 1}


def test_maybe_rotate_like_the_reference(tmp_path, monkeypatch):
    for mod, sub in ((tmetrics, "t"), (jmetrics, "j")):
        d = tmp_path / sub
        d.mkdir()
        assert mod.maybe_rotate(str(d), bound=10) is None  # no file yet
        (d / "events.jsonl").write_text("x" * 20)
        assert mod.maybe_rotate(str(d), bound=100) is None
        assert os.path.basename(mod.maybe_rotate(str(d), bound=10)) == \
            "events.000.jsonl"
        (d / "events.jsonl").write_text("y" * 20)
        assert os.path.basename(mod.maybe_rotate(str(d), bound=10)) == \
            "events.001.jsonl"
        assert mod.maybe_rotate(str(d), bound=0) is None
    # finalize rotates a full trail first; the readers read it in order
    monkeypatch.setenv(tmetrics.ROTATE_ENV, "200")
    assert tmetrics.ROTATE_ENV == jmetrics.ROTATE_ENV
    for mod, rep, d in ((tobs, treport, tmp_path / "rt"),
                        (jobs, jreport, tmp_path / "rj")):
        mod.configure(str(d))
        for k in range(3):
            with mod.span("cli.train"):
                mod.emit("command", cmd="train", argv=[str(k)])
            mod.finalize()
        mod.deconfigure()
        files = sorted(os.listdir(d))
        assert files == ["events.000.jsonl", "events.001.jsonl",
                         "events.jsonl", "metrics.prom",
                         "run_manifest.json"], files
        evs = rep.load_events(str(d))
        assert [e["argv"] for e in evs if e["type"] == "command"] == \
            [["0"], ["1"], ["2"]]


def _trail(path):
    """A serving-style trail: spans, iterations, gauges, a warning, a
    trace with a breach, and a snapshot."""
    ev = [
        {"ts": 1.0, "type": "command", "cmd": "serve-bench", "argv": []},
        {"ts": 1.1, "type": "span", "name": "serve_bench.warmup",
         "path": "cli.serve-bench/serve_bench.warmup", "seconds": 0.25},
        {"ts": 1.2, "type": "iteration", "iteration": 1, "seconds": 0.5,
         "total_seconds": 0.5, "u_norm": 1.0, "v_norm": 2.0,
         "probe_rmse": 0.9},
        {"ts": 1.3, "type": "metric", "kind": "gauge",
         "name": "serving.queue_depth", "value": 3, "labels": {}},
        {"ts": 1.4, "type": "warning", "what": "w", "reason": "r"},
        {"ts": 1.5, "type": "trace_span", "trace_id": "t00-00000001",
         "span_id": "s00-00000001", "parent_id": None,
         "name": "serve.admit", "status": "ok", "seconds": 0.001},
        {"ts": 1.6, "type": "trace_span", "trace_id": "t00-00000001",
         "span_id": "s00-00000002", "parent_id": "s00-00000001",
         "name": "serve.score", "status": "ok", "seconds": 0.002,
         "path": "exact"},
        {"ts": 1.7, "type": "flight_record", "seq": 1,
         "trigger": "slo_breach", "status": "ok", "spans": {},
         "trace_id": "t00-00000001"},
        {"ts": 1.8, "type": "span", "name": "cli.serve-bench",
         "path": "cli.serve-bench", "seconds": 1.5},
        {"ts": 1.9, "type": "snapshot", "counters": {"serving.requests": 9},
         "gauges": {}, "histograms": {"serving.e2e_seconds": {
             "count": 9, "sum": 0.1, "min": 0.001, "max": 0.03,
             "p50": 0.01, "p95": 0.03}}},
    ]
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "events.jsonl"), "w") as f:
        for e in ev:
            f.write(json.dumps(e) + "\n")
    return str(path)


def test_readers_give_the_references_output(tmp_path):
    run = _trail(tmp_path / "obs")
    assert treport.summarize_events(treport.load_events(run)) == \
        jreport.summarize_events(jreport.load_events(run))
    for kw in ({}, {"since": 0.5}, {"window": "0.2:0.6"}):
        assert treport.cmd_summarize(run, as_json=True, **kw) == \
            jreport.cmd_summarize(run, as_json=True, **kw)
    assert treport.render_summary(treport.summarize_events(
        treport.load_events(run))) == jreport.render_summary(
        jreport.summarize_events(jreport.load_events(run)))
    for kw in ({"n": 3}, {"event": "trace_span"},
               {"trace": "t00-00000001"}):
        assert treport.cmd_tail(run, **kw) == jreport.cmd_tail(run, **kw)
    for kw in ({}, {"trace": "t00-00000001"}, {"breach": "last"}):
        assert texplain.explain(run, **kw) == jexplain.explain(run, **kw)
    with pytest.raises(ValueError, match="not in the trail"):
        texplain.explain(run, trace="t99")
    with pytest.raises(FileNotFoundError):
        treport.load_events(str(tmp_path / "nowhere"))
