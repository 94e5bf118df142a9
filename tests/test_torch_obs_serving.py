"""Parity of the obs pieces serving reads with ``tpu_als.obs`` and
``tpu_als.plan``: the registry's histograms, gauges and spans, the
Prometheus text, causal-trace ids, the flight recorder, the disarmed
planner resolvers, the fold-in and checkpoint histograms, and the retry
policy's deterministic schedules.

Every comparison is exact: both sides are stdlib Python over the same
observations (fixed log buckets, the same counter-based ids), so
quantiles, counts, texts and ids must be equal, not close.
"""

import numpy as np
import pytest

from tpu_als import obs as jobs
from tpu_als import plan as jplan
from tpu_als.obs import trace as jtrace
from tpu_als.obs import tracing as jtracing
from tpu_als.resilience.retry import RetryPolicy as JRetryPolicy
from tpu_als_torch import obs as tobs
from tpu_als_torch import plan as tplan
from tpu_als_torch.obs import trace as ttrace
from tpu_als_torch.obs import tracing as ttracing
from tpu_als_torch.resilience.retry import RetryPolicy as TRetryPolicy

QUANTILES = (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Fresh registries, tracing off, and the reference's planner
    disarmed (the port's has no cache)."""
    monkeypatch.setenv("TPU_ALS_PLAN_CACHE", "off")
    monkeypatch.delenv("TPU_ALS_TRACE", raising=False)
    jreg, treg = jobs.reset(), tobs.reset()
    yield jreg, treg
    jtracing.disable_tracing()
    ttracing.disable_tracing()


def _observations(seed):
    rng = np.random.default_rng(seed)
    xs = np.concatenate([rng.lognormal(-6, 2, 500), [0.0, 1e-7, 2e6],
                         rng.integers(1, 200, 50)])
    return [float(x) for x in xs]


@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_quantiles_and_counts_match_reference(_fresh, seed):
    jreg, treg = _fresh
    xs = _observations(seed)
    for x in xs:
        jobs.histogram("serving.e2e_seconds", x)
        tobs.histogram("serving.e2e_seconds", x)
        jobs.histogram("serving.score_seconds", x / 2, path="int8")
        tobs.histogram("serving.score_seconds", x / 2, path="int8")
    for name, labels in (("serving.e2e_seconds", {}),
                         ("serving.score_seconds", {"path": "int8"})):
        for q in QUANTILES:
            assert tobs.histogram_quantile(name, q, **labels) == \
                jobs.histogram_quantile(name, q, **labels)
        assert tobs.histogram_count(name, **labels) == \
            jobs.histogram_count(name, **labels) == len(xs)
    assert np.isnan(tobs.histogram_quantile("serving.e2e_seconds", 0.5,
                                            path="exact"))
    assert tobs.histogram_count("serving.batch_rows") == 0
    assert treg.snapshot()["histograms"] == jreg.snapshot()["histograms"]


def test_prometheus_text_matches_reference(_fresh):
    jreg, treg = _fresh
    for reg, o in ((jreg, jobs), (treg, tobs)):
        for x in _observations(2)[:40]:
            o.histogram("serving.e2e_seconds", x, tenant="a")
            o.histogram("serving.publish_seconds", x, mode="delta")
        o.counter("serving.requests", 40)
        o.gauge("serving.queue_depth", 3)
    assert treg.prometheus_text() == jreg.prometheus_text()
    text = treg.prometheus_text()
    assert "# TYPE tpu_als_serving_e2e_seconds histogram" in text
    assert 'tpu_als_serving_e2e_seconds_bucket{tenant="a",le="+Inf"} 40' \
        in text
    assert treg.snapshot()["gauges"] == {"serving.queue_depth": 3}
    assert [e["name"] for e in tobs.events("metric")] == \
        ["serving.queue_depth"]


def test_undeclared_names_and_labels_raise():
    with pytest.raises(KeyError, match="not declared"):
        tobs.histogram("serving.nonexistent_seconds", 1.0)
    with pytest.raises(TypeError, match="declared as a histogram"):
        tobs.counter("serving.e2e_seconds")
    with pytest.raises(ValueError, match="label"):
        tobs.histogram("serving.e2e_seconds", 1.0, path="int8")
    with pytest.raises(KeyError, match="TRACE_SPANS"):
        with ttracing.traced():
            ttracing.start_trace("serve.nowhere")


def test_spans_nest_like_the_reference(_fresh):
    for o in (jobs, tobs):
        with o.span("serve_bench.warmup"):
            with o.span("inner", stage="x"):
                pass
    pick = [(e["name"], e["path"], e.get("stage")) for e in
            tobs.events("span")]
    assert pick == [(e["name"], e["path"], e.get("stage")) for e in
                    jobs.default_registry()._events if e["type"] == "span"]
    assert pick[0] == ("inner", "serve_bench.warmup/inner", "x")


def _trace_trail(tracing, o):
    tracing.reset_trace_ids(0)
    assert tracing.start_trace("serve.admit") is None    # disarmed
    with tracing.traced():
        tracing.reset_trace_ids(3)
        a = tracing.start_trace("serve.admit", tenant="t", seconds=0.5)
        a = tracing.record_span(a, "serve.queue", seconds=0.25)
        b = tracing.start_trace("serve.admit")
        tracing.record_span(b, "serve.queue", status="shed", seconds=0.0)
        a = tracing.record_span(a, "serve.score", path="int8")
        assert tracing.record_span(None, "serve.score") is None
    keys = ("trace_id", "span_id", "parent_id", "name", "status",
            "seconds", "tenant", "path")
    return [tuple(e.get(k) for k in keys)
            for e in o.default_registry()._events
            if e["type"] == "trace_span"]


def test_trace_ids_match_reference(_fresh):
    trail = _trace_trail(ttracing, tobs)
    assert trail == _trace_trail(jtracing, jobs)
    assert trail[0][:3] == ("t03-00000001", "s03-00000002", None)
    assert trail[-1][2] == trail[1][1]          # score's parent: queue


def test_flight_recorder_ring_and_watermark(_fresh):
    def drive(FlightRecorder, o):
        fr = FlightRecorder(capacity=4, labels={"tenant": "t"})
        for i in range(6):
            fr.record("ok", {"score": 0.001 * (i + 1), "bogus": 1.0},
                      e2e_seconds=0.01, path="int8")
        assert len(fr) == 4
        n1 = fr.dump("slo_breach")
        n2 = fr.dump("slo_breach")            # watermark: nothing new
        fr.record("shed", {"admission": 1e-4})
        n3 = fr.dump("shed")
        evs = [{k: v for k, v in e.items() if k != "ts"}
               for e in o.default_registry()._events
               if e["type"] == "flight_record"]
        return (n1, n2, n3), evs

    got = drive(ttrace.FlightRecorder, tobs)
    assert got == drive(jtrace.FlightRecorder, jobs)
    (n1, n2, n3), evs = got
    assert (n1, n2, n3) == (4, 0, 1)
    assert [e["seq"] for e in evs] == [3, 4, 5, 6, 7]
    assert all(set(e["spans"]) == set(ttrace.SPAN_KEYS) for e in evs)
    assert ttrace.SPAN_KEYS == jtrace.SPAN_KEYS


@pytest.mark.parametrize("kw", [
    {}, {"requested": (4, 16)}, {"observed": [1, 1, 2, 3, 7, 7, 30, 100]},
    {"observed": []}, {"observed": [0, -1]}, {"rank": 64}])
def test_resolve_serving_buckets_matches_reference(kw):
    assert tplan.resolve_serving_buckets(**kw) == \
        jplan.resolve_serving_buckets(**kw)


@pytest.mark.parametrize("requested", [None, {"max_batch": 32},
                                       {"compact_delta_frac": 0.5,
                                        "compact_min_rows": 8}])
def test_resolve_live_cadence_matches_reference(requested):
    assert tplan.resolve_live_cadence(requested=requested) == \
        jplan.resolve_live_cadence(requested=requested)
    assert tplan.DEFAULT_LIVE_CADENCE == jplan.DEFAULT_LIVE_CADENCE


@pytest.mark.parametrize("env,deterministic", [(None, None), ("1", None),
                                               (None, True)])
def test_retry_deterministic_schedules_match_reference(monkeypatch, env,
                                                       deterministic):
    if env is not None:
        monkeypatch.setenv("TPU_ALS_TRACE", env)
    j = JRetryPolicy(max_attempts=5, seed=7, deterministic=deterministic)
    t = TRetryPolicy(max_attempts=5, seed=7, deterministic=deterministic)
    assert t.deterministic == j.deterministic
    j.delay(0)
    t.delay(0)                                   # a draw already made
    assert [t.delay(a) for a in range(4)] == [j.delay(a) for a in range(4)]


def test_foldin_and_checkpoint_histograms(_fresh, tmp_path):
    """``FoldInServer`` writes the reference's ``foldin.*`` series, and
    ``save_factors``/``load_factors`` their ``checkpoint.*_seconds``."""
    import tpu_als_torch
    from tpu_als_torch.io.checkpoint import load_factors

    rng = np.random.default_rng(0)
    params = {"userCol": "user", "itemCol": "item", "ratingCol": "rating",
              "predictionCol": "prediction", "coldStartStrategy": "nan",
              "blockSize": 4096, "regParam": 0.1}
    m = tpu_als_torch.model_from_arrays(
        4, np.arange(5), rng.normal(size=(5, 4)), np.arange(7),
        rng.normal(size=(7, 4)), params, device="cpu")
    srv = tpu_als_torch.FoldInServer(m)
    srv.update({"user": np.array([0, 9, 9]), "item": np.array([1, 2, 3]),
                "rating": np.array([3.0, 4.0, 5.0])})
    srv.update_items({"user": np.array([1]), "item": np.array([2]),
                      "rating": np.array([2.0])})
    assert tobs.histogram_count("foldin.update_seconds", side="user") == 1
    assert tobs.histogram_count("foldin.update_seconds", side="item") == 1
    hists = tobs.snapshot()["histograms"]
    assert hists['foldin.batch_rows{side="user"}']["sum"] == 2  # users
    assert tobs.counter_value("foldin.ratings") == 4
    m.save(str(tmp_path / "m"))
    load_factors(str(tmp_path / "m"))
    assert tobs.histogram_count("checkpoint.save_seconds") == 1
    assert tobs.histogram_count("checkpoint.load_seconds") == 1


@pytest.mark.parametrize("strategy,k,n_items", [
    ("all_gather", 5, 24), ("ring", 5, 24), ("merge_ring", 5, 24),
    ("merge_ring", 130, 150)])
def test_sharded_serve_metrics_match_reference(_fresh, strategy, k,
                                               n_items):
    """``topk_sharded`` writes the reference's ``serve.requests``,
    ``serve.rows`` and ``serve.request_seconds{strategy}`` on the clean,
    the degraded and the empty path, the strategy being the one that ran
    (K8's candidate sets hold at most 128: 'merge_ring' above runs 'ring';
    an empty query set runs nothing and keeps the one asked for)."""
    from tpu_als.parallel import serve as jserve
    from tpu_als.parallel.mesh import make_mesh as jmake_mesh
    from tpu_als.resilience import faults as jfaults
    from tpu_als_torch.parallel import serve as tserve
    from tpu_als_torch.parallel.mesh import make_mesh as tmake_mesh
    from tpu_als_torch.resilience import faults as tfaults

    jreg, treg = _fresh
    rng = np.random.default_rng(0)
    U = rng.normal(size=(16, 8)).astype(np.float32)
    V = rng.normal(size=(n_items, 8)).astype(np.float32)
    for serve, faults, mesh in ((jserve, jfaults, jmake_mesh(4)),
                                (tserve, tfaults,
                                 tmake_mesh(devices=["cpu"] * 4))):
        serve.reset_last_good()
        faults.install("serve.gather=corrupt@nth=2")
        try:
            serve.topk_sharded(U, V, k, mesh, strategy=strategy)
            out = serve.topk_sharded(U[:5], V, k, mesh, strategy=strategy,
                                     return_info=True)
            assert out[-1]["degraded"] is True
            serve.topk_sharded(U[:0], V, k, mesh, strategy=strategy)
        finally:
            faults.clear()
    ran = "ring" if k > 128 else strategy
    for name in ("serve.requests", "serve.rows", "serve.degraded"):
        assert tobs.counter_value(name) == jobs.counter_value(name), name
    assert tobs.counter_value("serve.requests") == 3
    assert tobs.counter_value("serve.rows") == 21
    counts = {}
    for label in {strategy, ran}:
        counts[label] = tobs.histogram_count("serve.request_seconds",
                                             strategy=label)
        assert counts[label] == jobs.histogram_count(
            "serve.request_seconds", strategy=label), label
    assert sum(counts.values()) == 3 and counts[ran] >= 2
    assert [e["strategy"] for e in treg.events("serve_degraded")] == \
        [e["strategy"] for e in jreg._events
         if e["type"] == "serve_degraded"] == [ran]
