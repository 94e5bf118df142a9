"""Parity of the port's micro-batcher and serving engine with
``tpu_als.serving``, driven synchronously through ``serve_batch`` (and
the engine thread where the case needs it), in one process with the
reference: JAX on the CPU, torch with ``device="cpu"``.

Tolerances: answers against the reference's by the index rule of
``tests/test_torch_serving_index.py`` (scores within SERVE_ULPS units in
the last place, ids equal on rows with unique scores, every id earning
its score within 1e-5); counters, publish modes, ``serving_publish``
fields and causal-trace trails (ids, names, statuses, parents, paths;
times excluded) exactly.  The reference's planner is disarmed
(``TPU_ALS_PLAN_CACHE=off``): the port has no plan cache.
"""

import time

import numpy as np
import pytest
import torch

from tpu_als import obs as jobs
from tpu_als import serving as jserving
from tpu_als.obs import tracing as jtracing
from tpu_als.parallel.mesh import make_mesh as jmake_mesh
from tpu_als.resilience import faults as jfaults
from tpu_als_torch import obs as tobs
from tpu_als_torch import serving as tserving
from tpu_als_torch.obs import tracing as ttracing
from tpu_als_torch.ops import cuda_topk
from tpu_als_torch.ops.topk import NEG_INF, chunked_topk_scores
from tpu_als_torch.parallel.mesh import make_mesh
from tpu_als_torch.resilience import faults as tfaults

SERVE_ULPS = 4
EARN_TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("TPU_ALS_PLAN_CACHE", "off")
    monkeypatch.delenv("TPU_ALS_TRACE", raising=False)
    for f in (jfaults, tfaults):
        f.clear()
    yield jobs.reset(), tobs.reset()
    for f in (jfaults, tfaults):
        f.clear()
    jtracing.disable_tracing()
    ttracing.disable_tracing()


# ---------------------------------------------------------------------------
# the admission queue (tests/test_serving.py's cases, on the port)


def test_bucket_for():
    for n, b in ((1, 8), (8, 8), (9, 32), (128, 128)):
        assert tserving.bucket_for(n, (8, 32, 128)) == b
    with pytest.raises(ValueError, match="largest bucket"):
        tserving.bucket_for(129, (8, 32, 128))
    assert tserving.DEFAULT_BUCKETS == jserving.DEFAULT_BUCKETS


def test_batcher_coalesces_and_stamps(_fresh):
    b = tserving.MicroBatcher(buckets=(4, 8), max_wait_s=0.01)
    tickets = [b.submit(i) for i in range(3)]
    batch = b.next_batch(timeout=1.0)
    assert [t.payload for t in batch] == [0, 1, 2]
    assert all(t.t_dequeue is not None for t in batch)
    assert b.depth() == 0
    assert tobs.histogram_count("serving.enqueue_seconds") == 3
    assert tickets[0] is batch[0]
    assert tobs.snapshot()["gauges"]["serving.queue_depth"] == 0


def test_batcher_caps_dequeue_at_largest_bucket():
    b = tserving.MicroBatcher(buckets=(2, 4), max_wait_s=0.0)
    for i in range(6):
        b.submit(i)
    assert len(b.next_batch(timeout=1.0)) == 4
    assert len(b.next_batch(timeout=1.0)) == 2


def test_batcher_sheds_when_full():
    b = tserving.MicroBatcher(buckets=(8,), max_queue=2, max_wait_s=0.0)
    b.submit(0)
    b.submit(1)
    with pytest.raises(tserving.Overloaded):
        b.submit(2)
    assert tobs.snapshot()["counters"]["serving.shed"] == 1


def test_batcher_timeout_close_and_bad_buckets():
    b = tserving.MicroBatcher(max_wait_s=0.0)
    assert b.next_batch(timeout=0.01) is None
    b = tserving.MicroBatcher(buckets=(8,), max_wait_s=0.0)
    b.submit(0)
    b.close()
    assert len(b.next_batch(timeout=0.1)) == 1
    assert b.next_batch(timeout=0.1) is None
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(1)
    with pytest.raises(ValueError, match="sorted and unique"):
        tserving.MicroBatcher(buckets=(32, 8))


# ---------------------------------------------------------------------------
# the engine, both packages side by side


def _tables(seed, n=40, Ni=300, r=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, r)).astype(np.float32),
            rng.normal(size=(Ni, r)).astype(np.float32))


def _engines(U, V, quantize=True, k=5, jkw=None, tkw=None, **kw):
    kw = dict(k=k, buckets=(8, 32), shortlist_k=32, max_wait_s=0.0, **kw)
    j = jserving.ServingEngine(**kw, **(jkw or {}))
    t = tserving.ServingEngine(**kw, **(tkw or {"device": "cpu"}))
    for eng in (j, t):
        eng.publish(U, V, quantize=quantize)
    return j, t


def _serve(eng, payloads, **kw):
    tickets = [eng.submit(p, **kw) for p in payloads]
    eng.serve_batch(eng.batcher.next_batch(timeout=1.0))
    return tickets


def _same_answer(jt, tt, queries, V):
    for jtk, ttk, q in zip(jt, tt, queries):
        js, jx = jtk.result(timeout=1.0)
        ts, tx = ttk.result(timeout=1.0)
        js, ts = np.asarray(js), np.asarray(ts)
        real = js > NEG_INF
        np.testing.assert_array_equal(ts > NEG_INF, real)
        ulps = np.abs(ts - js)[real] / np.spacing(np.abs(js[real]))
        assert ulps.max(initial=0) <= SERVE_ULPS
        if len(np.unique(js[real])) == real.sum():
            np.testing.assert_array_equal(tx[real], np.asarray(jx)[real])
        own = V.astype(np.float64)[tx[real]] @ q.astype(np.float64)
        np.testing.assert_allclose(own, ts[real], rtol=EARN_TOL,
                                   atol=EARN_TOL)


@pytest.mark.parametrize("quantize", [True, False])
def test_roundtrip_ids_and_foldin_rows(quantize):
    U, V = _tables(0)
    j, t = _engines(U, V, quantize=quantize)
    payloads = [7, U[3] * 0.5, 39]
    _same_answer(_serve(j, payloads), _serve(t, payloads),
                 [U[7], U[3] * 0.5, U[39]], V)
    path = "int8" if quantize else "exact"
    assert tobs.histogram_count("serving.score_seconds", path=path) == 1
    assert tobs.histogram_count("serving.e2e_seconds") == 3


def test_per_request_k_and_guards():
    U, V = _tables(1)
    _, t = _engines(U, V, k=8)
    (tk,) = _serve(t, [0], k=3)
    s, ix = tk.result(timeout=1.0)
    assert s.shape == (3,) and ix.shape == (3,)
    for eng in (jserving.ServingEngine(k=5),
                tserving.ServingEngine(k=5, device="cpu")):
        mod = jserving if isinstance(eng, jserving.ServingEngine) \
            else tserving
        with pytest.raises(mod.NoModelPublished):
            eng.submit(0)
        eng.publish(np.ones((4, 6), np.float32), np.ones((9, 6), np.float32))
        with pytest.raises(ValueError, match="outside the published table"):
            eng.submit(4)
        with pytest.raises(ValueError, match="payload shape"):
            eng.submit(np.ones(5, np.float32))
        with pytest.raises(ValueError, match="per-request k"):
            eng.submit(0, k=6)


def test_deadline_expires_in_queue():
    U, V = _tables(2)
    _, t = _engines(U, V)
    tk = t.submit(0, deadline_s=0.0)
    time.sleep(0.01)
    t.serve_batch(t.batcher.next_batch(timeout=1.0))
    with pytest.raises(tserving.DeadlineExceeded):
        tk.result(timeout=1.0)
    assert tobs.counter_value("serving.expired") == 1


def test_publish_swaps_atomically():
    U, V = _tables(3)
    j, t = _engines(U, V)
    first = _serve(t, [0])[0].result(timeout=1.0)[0]
    assert j.publish(U, -V) == t.publish(U, -V) == 2
    _same_answer(_serve(j, [0]), _serve(t, [0]), [U[0]], -V)
    assert not np.allclose(first, _serve(t, [0])[0].result(1.0)[0])
    assert [e["seq"] for e in tobs.events("serving_publish")] == [1, 2]
    assert tobs.counter_value("serving.publishes") == 2


def _fallbacks():
    return (jobs.counter_value("serving.fallback_exact"),
            tobs.counter_value("serving.fallback_exact"))


def test_stale_index_answers_exact():
    U, V = _tables(4)
    j, t = _engines(U, V)
    V2 = -V[::-1].copy()
    for eng in (j, t):
        eng.publish(U, V2, quantize=False)      # index carried, stale
    _same_answer(_serve(j, [2]), _serve(t, [2]), [U[2]], V2)
    assert _fallbacks() == (1, 1)
    assert tobs.histogram_count("serving.score_seconds", path="exact") == 1


def test_torn_first_publish_goes_indexless():
    U, V = _tables(5)
    for f in (jfaults, tfaults):
        f.install("serving.publish=corrupt@nth=1")
    j, t = _engines(U, V)
    assert j.published_index is None and t.published_index is None
    _same_answer(_serve(j, [1]), _serve(t, [1]), [U[1]], V)
    assert _fallbacks() == (0, 0)
    assert tobs.events("serving_publish")[-1]["quantized"] is False


def test_torn_publish_carries_the_stale_index():
    U, V = _tables(6)
    j, t = _engines(U, V)
    first, seq = t.published_index, t.published_index.seq
    for f in (jfaults, tfaults):
        f.install("serving.publish=corrupt@nth=1")
    for eng in (j, t):
        eng.publish(U, V)
    assert t.published_index is first and first.seq == seq
    _same_answer(_serve(j, [1]), _serve(t, [1]), [U[1]], V)
    assert _fallbacks() == (1, 1)


def test_score_corrupt_answers_exact():
    U, V = _tables(7)
    j, t = _engines(U, V)
    for f in (jfaults, tfaults):
        f.install("serving.score=corrupt@nth=1")
    _same_answer(_serve(j, [1]), _serve(t, [1]), [U[1]], V)
    assert _fallbacks() == (1, 1)
    assert len(tobs.events("flight_record")) == 1      # degraded dump


def test_score_raise_fails_waiting_callers_and_the_loop_survives():
    U, V = _tables(8)
    _, t = _engines(U, V)
    tfaults.install("serving.score=raise@nth=1")
    with t:
        with pytest.raises(tfaults.InjectedFault):
            t.submit(0).result(timeout=5.0)
        s, _ = t.recommend(1, timeout=5.0)
    assert s.shape == (5,)
    assert [e["status"] for e in tobs.events("flight_record")] == []
    assert len(t.flight) == 2          # the failed record and the ok one


def test_warmup_records_no_latency_samples():
    U, V = _tables(9)
    _, t = _engines(U, V)
    t.warmup()
    t.warmup_live(max_delta_rows=4)
    assert tobs.snapshot()["histograms"] == {
        k: v for k, v in tobs.snapshot()["histograms"].items()
        if k.startswith("serving.publish_seconds")}


def test_small_catalog_skips_the_index():
    rng = np.random.default_rng(10)
    U = rng.normal(size=(4, 3)).astype(np.float32)
    V = rng.normal(size=(6, 3)).astype(np.float32)
    j, t = _engines(U, V, k=10)
    assert t.published_index is None and j.published_index is None
    _same_answer(_serve(j, [0]), _serve(t, [0]), [U[0]], V)
    s, _ = _serve(t, [0])[0].result(timeout=1.0)
    assert (s > NEG_INF).sum() == 6


def _update_sequence(eng, U, V, rng):
    """publish, then the reference's publish_update modes in order:
    retag, delta, delta (appended), compact, full (rows out of range),
    full (shrink), and a last retag."""
    r = V.shape[1]
    out = [eng.publish(U, V)]
    out.append(eng.publish_update(U, V.copy()))
    # a fresh array for every publish: the engine keeps what it is given
    Vb = V.copy()
    Vb[[3, 7]] = rng.normal(size=(2, r))
    out.append(eng.publish_update(U, Vb, touched_items=[3, 7]))
    Vb = np.concatenate([Vb, rng.normal(size=(2, r))]).astype(np.float32)
    out.append(eng.publish_update(U, Vb))
    many = np.arange(10, 90)
    Vb = Vb.copy()
    Vb[many] = rng.normal(size=(len(many), r))
    out.append(eng.publish_update(U, Vb, touched_items=many))
    out.append(eng.publish_update(U, Vb.copy(), touched_items=[5, 400]))
    out.append(eng.publish_update(U, Vb[:250].copy()))
    out.append(eng.publish_update(U, Vb[:250].copy()))
    return out, Vb[:250]


def _publish_events(o):
    keys = ("seq", "items", "quantized", "mode", "delta_rows")
    return [tuple(e.get(k) for k in keys) for e in
            o.default_registry()._events if e["type"] == "serving_publish"]


@pytest.mark.parametrize("backend", ["local", "sharded", "merge_ring"])
def test_publish_update_modes_match_reference(backend):
    U, V = _tables(11, n=30, Ni=300, r=8)
    kw = dict(k=5, buckets=(8,), shortlist_k=32, max_wait_s=0.0)
    if backend == "local":
        j = jserving.ServingEngine(**kw)
        t = tserving.ServingEngine(**kw, device="cpu")
    else:
        j = jserving.ServingEngine(**kw, mesh=jmake_mesh(3),
                                   serve_backend=backend)
        t = tserving.ServingEngine(**kw, mesh=make_mesh(devices=["cpu"] * 3),
                                   serve_backend=backend)
    jout, _ = _update_sequence(j, U, V, np.random.default_rng(0))
    tout, Vf = _update_sequence(t, U, V, np.random.default_rng(0))
    assert tout == jout
    assert _publish_events(tobs) == _publish_events(jobs)
    if backend != "merge_ring":       # the reference's needs a TPU kernel
        _same_answer(_serve(j, [4, 9]), _serve(t, [4, 9]), [U[4], U[9]],
                     Vf)
    else:
        valid = torch.ones(len(Vf), dtype=torch.bool)
        es, _ = chunked_topk_scores(torch.from_numpy(U[[4]]),
                                    torch.from_numpy(Vf), valid, 5)
        s, _ = _serve(t, [4])[0].result(timeout=1.0)
        es = es[0].numpy()
        assert (np.abs(s - es) / np.spacing(np.abs(es))).max() <= SERVE_ULPS


def _span_trail(serving, tracing, o, U, V, jkw):
    tracing.reset_trace_ids(0)
    with tracing.traced():
        eng = serving.ServingEngine(k=5, buckets=(8,), shortlist_k=32,
                                    max_wait_s=0.0, max_queue=3, **jkw)
        eng.publish(U, V)
        eng.submit(1)
        eng.submit(U[2])
        eng.submit(3, deadline_s=0.0)
        with pytest.raises(serving.Overloaded):
            eng.submit(4)
        time.sleep(0.01)
        eng.serve_batch(eng.batcher.next_batch(timeout=1.0))
    keys = ("trace_id", "span_id", "parent_id", "name", "status", "path",
            "tenant")
    return [tuple(e.get(k) for k in keys) for e in
            o.default_registry()._events if e["type"] == "trace_span"]


def test_span_trail_matches_reference():
    U, V = _tables(12)
    trail = _span_trail(tserving, ttracing, tobs, U, V, {"device": "cpu"})
    assert trail == _span_trail(jserving, jtracing, jobs, U, V, {})
    assert {s[3] for s in trail} == {"serve.admit", "serve.queue",
                                     "serve.score", "serve.expired"}
    assert ("shed" in {s[4] for s in trail}
            and "expired" in {s[4] for s in trail})


@pytest.mark.parametrize("backend", ["sharded", "merge_ring"])
def test_mesh_backends_on_three_logical_shards(backend):
    U, V = _tables(13, Ni=301)
    mesh = make_mesh(devices=["cpu"] * 3)
    t = tserving.ServingEngine(k=5, buckets=(8,), shortlist_k=301,
                               max_wait_s=0.0, mesh=mesh,
                               serve_backend=backend)
    t.publish(U, V)
    loc = tserving.ServingEngine(k=5, buckets=(8,), shortlist_k=301,
                                 max_wait_s=0.0, device="cpu")
    loc.publish(U, V)
    if backend == "sharded":
        j = jserving.ServingEngine(k=5, buckets=(8,), shortlist_k=301,
                                   max_wait_s=0.0, mesh=jmake_mesh(3),
                                   serve_backend="sharded")
        j.publish(U, V)
        _same_answer(_serve(j, [0, 5]), _serve(t, [0, 5]), [U[0], U[5]], V)
    _same_answer(_serve(loc, [0, 5]), _serve(t, [0, 5]), [U[0], U[5]], V)
    path = "int8_sharded" if backend == "sharded" else "merge_ring"
    assert tobs.histogram_count("serving.score_seconds", path=path) == \
        (2 if backend == "sharded" else 1)
    assert [e["backend"] for e in tobs.events("serving_backend")] == \
        [backend]


def test_auto_backend_follows_k():
    mesh = make_mesh(devices=["cpu"] * 2)
    U, V = _tables(14)
    small = tserving.ServingEngine(k=10, mesh=mesh)
    large = tserving.ServingEngine(k=cuda_topk.MAX_K + 1, mesh=mesh)
    for eng in (small, large):
        eng.publish(U, V)
    assert (small._backend, large._backend) == ("merge_ring", "sharded")
    with pytest.raises(ValueError, match="k <= 128"):
        tserving.ServingEngine(k=129, mesh=mesh, serve_backend="merge_ring")
    with pytest.raises(ValueError, match="requires a mesh"):
        tserving.ServingEngine(serve_backend="sharded", device="cpu")
