"""Parity of the port's live loop (``tpu_als_torch.live.LiveUpdater``)
with ``tpu_als.live.LiveUpdater``, driven synchronously: both packages'
``_process`` on the same micro-batches over the same injected factors
(JAX on the CPU, torch with ``device="cpu"``).

Tolerances: the model's factor tables after each batch within
``tests/test_torch_foldin.py``'s band (1e-4 of each row's norm + 1e-5);
the answers served afterwards by the rule of
``tests/test_torch_serving_engine.py`` (4 units in the last place, every
id earning its score within 1e-5) widened by what the fold-in band lets
a score move (``_same_served``); publish modes, ``live_update`` /
``ingest_quarantined`` / ``live_freshness_breach`` fields, counters,
flight-record span keys and causal-trace trails exactly (times
excluded).  No test waits on a clock or asserts a time: the background
loop is driven by closing the queue first and running ``_run`` on the
test's own thread.
"""

import numpy as np
import pytest
import torch

from tpu_als import obs as jobs
from tpu_als import serving as jserving
from tpu_als.api.estimator import ALSModel as JALSModel
from tpu_als.core.ratings import IdMap as JIdMap
from tpu_als.live import LiveUpdater as JLiveUpdater
from tpu_als.obs import tracing as jtracing
from tpu_als.stream.microbatch import FoldInServer as JFoldInServer
from tpu_als_torch import model_from_arrays
from tpu_als_torch import obs as tobs
from tpu_als_torch import serving as tserving
from tpu_als_torch.live import LiveUpdater as TLiveUpdater
from tpu_als_torch.live.updater import LIVE_SPAN_KEYS
from tpu_als_torch.obs import tracing as ttracing
from tpu_als_torch.ops.topk import NEG_INF
from tpu_als_torch.stream.microbatch import FoldInServer as TFoldInServer

REL, ATOL = 1e-4, 1e-5          # tests/test_torch_foldin.py
SERVE_ULPS, EARN_TOL = 4, 1e-5  # tests/test_torch_serving_engine.py
PARAMS = {"userCol": "user", "itemCol": "item", "ratingCol": "rating",
          "predictionCol": "prediction", "coldStartStrategy": "nan",
          "blockSize": 4096, "regParam": 0.05, "rank": 8,
          "implicitPrefs": False, "alpha": 1.0, "nonnegative": False}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("TPU_ALS_PLAN_CACHE", "off")
    monkeypatch.delenv("TPU_ALS_TRACE", raising=False)
    yield jobs.reset(), tobs.reset()
    jtracing.disable_tracing()
    ttracing.disable_tracing()


def _stacks(quantize=True, fold_items=False, seed=0, n=40, Ni=300, r=8,
            **kw):
    """The same factors, engine and updater in both packages."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n, r)).astype(np.float32)
    V = rng.normal(size=(Ni, r)).astype(np.float32)
    ekw = dict(k=5, buckets=(8, 32), shortlist_k=32, max_wait_s=0.0)
    jm = JALSModel(r, JIdMap(ids=np.arange(n)), JIdMap(ids=np.arange(Ni)),
                   U.copy(), V.copy(), PARAMS)
    tm = model_from_arrays(r, np.arange(n), U, np.arange(Ni), V, PARAMS,
                           device="cpu")
    je = jserving.ServingEngine(**ekw)
    te = tserving.ServingEngine(**ekw, device="cpu")
    je.publish(U, V, quantize=quantize)
    te.publish(U, V, quantize=quantize)
    ju = JLiveUpdater(je, JFoldInServer(jm, keep_history=False),
                      fold_items=fold_items, **kw)
    tu = TLiveUpdater(te, TFoldInServer(tm, keep_history=False),
                      fold_items=fold_items, device="cpu", **kw)
    return ju, tu


def _events_of(n_batch, seed, n_users=40, n_items=300, new_items=False):
    """One micro-batch of (user, item, rating): known and new users,
    known items (and new ones with ``new_items``), NaN and 1e9 poison."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users + 6, n_batch)      # 6 new users
    hi = n_items + (4 if new_items else 0)
    items = rng.integers(0, hi, n_batch)
    ratings = (rng.integers(1, 11, n_batch) * 0.5).astype(np.float32)
    ratings[rng.random(n_batch) < 0.1] = np.nan
    ratings[rng.random(n_batch) < 0.05] = 1e9
    return [(int(u), int(i), float(x)) for u, i, x in
            zip(users, items, ratings)]


def _batch(events):
    import time

    t = time.perf_counter()
    return [(u, i, r, t, None) for u, i, r in events]


def _traced_batch(tracing, events):
    import time

    t = time.perf_counter()
    return [(u, i, r, t, tracing.start_trace("live.admit"))
            for u, i, r in events]


def _fields(o, etype, drop=("ts", "freshness_seconds", "slo_s")):
    return [{k: v for k, v in e.items() if k not in drop}
            for e in o.default_registry()._events if e["type"] == etype]


def _close(t, j):
    t, j = t.detach().numpy(), np.asarray(j)
    assert t.shape == j.shape
    scale = np.linalg.norm(j, axis=1, keepdims=True)
    assert np.all(np.abs(t - j) <= REL * scale + ATOL)


def _same_models(tu, ju):
    tm, jm = tu.foldin.model, ju.foldin.model
    np.testing.assert_array_equal(tm._user_map.ids, jm._user_map.ids)
    np.testing.assert_array_equal(tm._item_map.ids, jm._item_map.ids)
    _close(tm._U, jm._U)
    _close(tm._V, jm._V)


def _answers(eng, users):
    tickets = [eng.submit(int(u)) for u in users]
    eng.serve_batch(eng.batcher.next_batch(timeout=1.0))
    return [t.result(timeout=1.0) for t in tickets]


def _same_served(tu, ju, users):
    """The answers served after the batches.  Each package serves its
    own folded factors, which agree within the fold-in band, so a score
    may move by ``tol`` = (REL·|u| + ATOL)·|v|₁ + (REL·|v| + ATOL)·|u|₁
    over the row's candidates: the port's scores are held to the
    reference's within ``tol`` plus SERVE_ULPS, its ids to the
    reference's wherever the reference's scores are more than 2·tol
    apart, and every id earns its score on the port's own factors."""
    tU, tV = tu.foldin.model._U.numpy(), tu.foldin.model._V.numpy()
    jU, jV = np.asarray(ju.foldin.model._U), np.asarray(ju.foldin.model._V)
    for (js, jx), (ts, tx), u in zip(_answers(ju.engine, users),
                                     _answers(tu.engine, users), users):
        js, ts, jx = np.asarray(js), np.asarray(ts), np.asarray(jx)
        real = js > NEG_INF
        np.testing.assert_array_equal(ts > NEG_INF, real)
        un = np.linalg.norm(jU[u])
        vn = np.linalg.norm(jV, axis=1).max()
        tol = ((REL * un + ATOL) * np.abs(jV).sum(1).max()
               + (REL * vn + ATOL) * np.abs(jU[u]).sum())
        band = tol + SERVE_ULPS * np.spacing(np.abs(js[real]))
        assert np.all(np.abs(ts[real] - js[real]) <= band)
        gaps = np.abs(np.diff(js[real]))
        apart = np.ones(real.sum(), bool)
        apart[:-1] &= gaps > 2 * tol
        apart[1:] &= gaps > 2 * tol
        np.testing.assert_array_equal(tx[real][apart], jx[real][apart])
        own = tV.astype(np.float64)[tx[real]] @ tU[u].astype(np.float64)
        np.testing.assert_allclose(own, ts[real], rtol=EARN_TOL,
                                   atol=EARN_TOL)


@pytest.mark.parametrize("quantize,fold_items", [
    (False, False), (True, False), (True, True)])
def test_process_matches_reference(quantize, fold_items):
    """Three micro-batches through both packages' ``_process``: the
    exact route (its first live publish builds the index: 'full', then
    'retag'), int8 user-only ('retag') and int8 with item fold-ins
    ('delta', appended items included)."""
    ju, tu = _stacks(quantize, fold_items)
    for b in range(3):
        events = _events_of(24, seed=b, new_items=fold_items)
        ju._process(_batch(events))
        tu._process(_batch(events))
        _same_models(tu, ju)
        assert _fields(tobs, "live_update") == _fields(jobs, "live_update")
        assert _fields(tobs, "serving_publish") == \
            _fields(jobs, "serving_publish")
    assert _fields(tobs, "ingest_quarantined") == \
        _fields(jobs, "ingest_quarantined")
    q = tobs.counter_value("ingest.quarantined_rows")
    assert q == jobs.counter_value("ingest.quarantined_rows") > 0
    modes = [e["mode"] for e in _fields(tobs, "live_update")]
    want = {(False, False): ["full", "retag", "retag"],
            (True, False): ["retag"] * 3,
            (True, True): ["delta"] * 3}[(quantize, fold_items)]
    assert modes == want
    folded = sum(e["events"] for e in _fields(tobs, "live_update"))
    assert folded + q == 3 * 24
    assert tobs.histogram_count("live.freshness_seconds") == folded
    assert tobs.histogram_count("live.batch_rows") == 3
    for upd in (tu, ju):
        rec = list(upd.flight._ring)[-1]
        assert rec["status"] == "ok" and set(rec["spans"]) == \
            set(LIVE_SPAN_KEYS)
        assert all(rec["spans"][k] is not None for k in LIVE_SPAN_KEYS)
    dense = tu.foldin.model._user_map.to_dense(np.arange(40, 46))
    _same_served(tu, ju, [0, 7, 39, *dense[dense >= 0].tolist()])


def test_process_publishes_a_copy_of_the_factors():
    """The fold-in server writes its tables in place; the engine must
    keep serving the generation it was handed."""
    _, tu = _stacks(fold_items=True)
    tu._process(_batch(_events_of(16, seed=4)))
    m = tu.engine._model
    before = m.U.clone()
    tu._process(_batch(_events_of(16, seed=5)))
    assert torch.equal(m.U, before)
    m2 = tu.engine._model
    assert torch.equal(m2.U, tu.foldin.model._U)
    assert torch.equal(m2.V, tu.foldin.model._V)
    assert m2.U.data_ptr() != tu.foldin.model._U.data_ptr()


def test_all_poisoned_batch_records_quarantined_only():
    ju, tu = _stacks()
    events = [(0, 1, float("nan")), (2, 3, 1e9), (4, 5, float("-inf"))]
    ju._process(_batch(events))
    tu._process(_batch(events))
    assert _fields(tobs, "ingest_quarantined") == \
        _fields(jobs, "ingest_quarantined")
    assert _fields(tobs, "live_update") == []
    for upd in (tu, ju):
        rec = list(upd.flight._ring)[-1]
        assert rec["status"] == "quarantined"
        assert rec["spans"]["foldin"] is None


def test_trace_trail_matches_reference():
    ju, tu = _stacks(fold_items=True)
    trails = []
    for tracing, upd, o in ((jtracing, ju, jobs), (ttracing, tu, tobs)):
        tracing.reset_trace_ids(0)
        with tracing.traced():
            upd._process(_traced_batch(tracing, _events_of(12, seed=9)))
        trails.append([(e["trace_id"], e["span_id"], e["parent_id"],
                        e["name"], e["status"], e.get("seq"),
                        e.get("mode"))
                       for e in o.default_registry()._events
                       if e["type"] == "trace_span"])
    assert trails[1] == trails[0] and trails[1]
    assert {t[3] for t in trails[1]} >= {
        "live.admit", "live.queue", "live.quarantine", "live.foldin",
        "live.publish", "live.visible"}


def test_shed_at_capacity_and_submit_after_stop_match_reference():
    ju, tu = _stacks(max_queue=2)
    errs = []
    for upd in (ju, tu):
        upd.submit(0, 0, 1.0)
        upd.submit(1, 1, 1.0)
        with pytest.raises(Exception) as e:
            upd.submit(2, 2, 1.0)
        errs.append(e.type.__name__)
        assert upd.queue_depth == 2
        upd.stop()
        with pytest.raises(RuntimeError, match="stopped"):
            upd.submit(3, 3, 1.0)
    assert errs == ["Overloaded", "Overloaded"]
    assert tobs.counter_value("live.shed") == \
        jobs.counter_value("live.shed") == 1


def test_run_drains_a_closed_queue_and_survives_errors():
    """``_run`` on the test's thread: stop() closes the queue, the loop
    drains it in ``max_batch`` batches and returns; a batch that raises
    is a ``warning`` event with what="live.update", and the next batch
    is served."""
    outs = []
    for upd, o in zip(_stacks(max_batch=8), (jobs, tobs)):
        model = upd.foldin.model
        calls = {"n": 0}
        real = upd.foldin.update

        def flaky(frame, real=real, calls=calls):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("fold-in failed")
            return real(frame)

        upd.foldin.update = flaky
        for u, i, r in _events_of(30, seed=2):
            upd.submit(u, i, r)
        upd.stop()          # closes admission; no thread was started
        upd._run()
        assert upd.queue_depth == 0 and upd.foldin.model is model
        warns = [e for e in o.default_registry()._events
                 if e["type"] == "warning" and e["what"] == "live.update"]
        outs.append((len(warns), [e["events"] for e in
                                  _fields(o, "live_update")]))
    assert outs[1] == outs[0] and outs[1][0] == 1
    assert len(outs[1][1]) == 3          # 4 batches of 8, one failed


def test_freshness_breach_dumps_the_ring_like_reference():
    ju, tu = _stacks(fold_items=True, slo_s=0.0)
    for b in range(2):
        events = _events_of(10, seed=20 + b)
        ju._process(_batch(events))
        tu._process(_batch(events))
    assert _fields(tobs, "live_freshness_breach") == \
        _fields(jobs, "live_freshness_breach")
    assert len(_fields(tobs, "live_freshness_breach")) == 2
    drop = ("ts", "e2e_seconds", "spans")
    assert _fields(tobs, "flight_record", drop) == \
        _fields(jobs, "flight_record", drop)
    dumps = _fields(tobs, "flight_record", ("ts",))
    assert dumps and all(d["trigger"] == "freshness_breach" and
                         set(d["spans"]) == set(LIVE_SPAN_KEYS)
                         for d in dumps)


def test_tenant_label_rides_every_live_series():
    rng = np.random.default_rng(1)
    U = rng.normal(size=(20, 4)).astype(np.float32)
    V = rng.normal(size=(60, 4)).astype(np.float32)
    eng = tserving.ServingEngine(k=3, buckets=(8,), shortlist_k=16,
                                 tenant="acme", device="cpu")
    eng.publish(U, V)
    m = model_from_arrays(4, np.arange(20), U, np.arange(60), V, PARAMS,
                          device="cpu")
    upd = TLiveUpdater(eng, TFoldInServer(m), device="cpu")
    assert upd.tenant == "acme"
    upd._process(_batch([(1, 2, 3.0), (5, 6, float("nan"))]))
    assert tobs.histogram_count("live.freshness_seconds",
                                tenant="acme") == 1
    assert tobs.histogram_count("live.freshness_seconds") == 0
    assert _fields(tobs, "live_update")[0]["tenant"] == "acme"
    assert _fields(tobs, "ingest_quarantined")[0]["tenant"] == "acme"
    assert list(upd.flight._ring)[-1]["tenant"] == "acme"


def test_device_rules(monkeypatch):
    """``device=None`` is the card and raises without CUDA; an engine or
    fold-in server on another device is refused."""
    _, tu = _stacks()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TLiveUpdater(tu.engine, tu.foldin)
    monkeypatch.undo()
    meta = type("E", (), {"device": torch.device("meta"), "tenant": None})
    with pytest.raises(ValueError, match="engine runs on meta"):
        TLiveUpdater(meta(), tu.foldin, device="cpu")
