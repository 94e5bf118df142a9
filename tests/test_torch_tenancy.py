"""Parity of the port's tenancy control plane (``tpu_als_torch.tenancy``)
with ``tpu_als.tenancy``, in one process (JAX on the CPU, torch with
``device="cpu"``).  The scheduler thread is not started: each test
admits its requests, then runs one ``_drain_round`` on its own thread,
so the fair-share sequence is a function of the queues alone.

Tolerances: answers by the rule of ``tests/test_torch_serving_engine.py``
(scores within 4 units in the last place, ids equal on rows with unique
scores, every id earning its score within 1e-5); exception types, the
scheduler's pick/charge sequence, virtual times, served rows, counters,
publish sequences, events and plans exactly.  No test asserts a time.
The reference's planner is disarmed (``TPU_ALS_PLAN_CACHE=off``).
"""

import numpy as np
import pytest
import torch

from tpu_als import obs as jobs
from tpu_als import plan as jplan
from tpu_als import tenancy as jten
from tpu_als.resilience import faults as jfaults
from tpu_als_torch import model_from_arrays
from tpu_als_torch import obs as tobs
from tpu_als_torch import plan as tplan
from tpu_als_torch import tenancy as tten
from tpu_als_torch.ops.topk import NEG_INF
from tpu_als_torch.resilience import faults as tfaults
from tpu_als_torch.stream.microbatch import FoldInServer

SERVE_ULPS, EARN_TOL = 4, 1e-5


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("TPU_ALS_PLAN_CACHE", "off")
    for f in (jfaults, tfaults):
        f.clear()
    yield jobs.reset(), tobs.reset()
    for f in (jfaults, tfaults):
        f.clear()


def _factors(seed, users=32, items=48, rank=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(users, rank)).astype(np.float32),
            rng.normal(size=(items, rank)).astype(np.float32))


def _engines(specs, quantize=True):
    """Both packages' MultiTenantEngine with the same tenants; ``specs``
    is [(name, weight, seed, kwargs)]."""
    j = jten.MultiTenantEngine()
    t = tten.MultiTenantEngine(device="cpu")
    for name, w, seed, kw in specs:
        U, V = _factors(seed, **kw.pop("shape", {}))
        for mod, eng in ((jten, j), (tten, t)):
            eng.add_tenant(mod.TenantSpec(name=name, weight=w, k=5,
                                          shortlist_k=16, buckets=(8, 32),
                                          max_wait_s=0.0, **kw),
                           U, V, quantize=quantize)
    return j, t


def _same_answer(js, jx, ts, tx, q, V):
    js, ts = np.asarray(js), np.asarray(ts)
    real = js > NEG_INF
    np.testing.assert_array_equal(ts > NEG_INF, real)
    ulps = np.abs(ts - js)[real] / np.spacing(np.abs(js[real]))
    assert ulps.max(initial=0) <= SERVE_ULPS
    if len(np.unique(js[real])) == real.sum():
        np.testing.assert_array_equal(tx[real], np.asarray(jx)[real])
    own = V.astype(np.float64)[tx[real]] @ q.astype(np.float64)
    np.testing.assert_allclose(own, ts[real], rtol=EARN_TOL, atol=EARN_TOL)


def _fields(o, etype, drop=("ts",)):
    return [{k: v for k, v in e.items() if k not in drop}
            for e in o.default_registry()._events if e["type"] == etype]


@pytest.mark.parametrize("kw,match", [
    ({"name": "Bad Name!"}, "must match"), ({"name": ""}, "must match"),
    ({"name": "a", "weight": 0}, "weight"),
    ({"name": "a", "weight": -1.0}, "weight"),
    ({"name": "a", "guardrail_mode": "yolo"}, "guardrail_mode")])
def test_spec_validation_raises_like_reference(kw, match):
    msgs = []
    for mod in (jten, tten):
        with pytest.raises(ValueError, match=match) as e:
            mod.TenantSpec(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert tten.TenantSpec(name="team-a_01") == \
        tten.TenantSpec(name="team-a_01")
    assert tten.GUARDRAIL_MODES == jten.GUARDRAIL_MODES


def test_registry_lifecycle_matches_reference():
    U, V = _factors(0)
    U2, V2 = _factors(1, users=70, items=500)
    out = []
    for mod, kw in ((jten, {}), (tten, {"device": "cpu"})):
        reg = mod.TenantRegistry(**kw)
        a = reg.register(mod.TenantSpec(name="a"), U, V)
        reg.register(mod.TenantSpec(name="b", weight=2.0), U, V)
        reg.register(mod.TenantSpec(name="c"), U2, V2)
        with pytest.raises(mod.DuplicateTenant) as dup:
            reg.register(mod.TenantSpec(name="a"), U, V)
        with pytest.raises(mod.UnknownTenant) as unk:
            reg.get("zz")
        assert isinstance(unk.value, mod.TenancyError)
        removed = reg.remove("b")
        with pytest.raises(mod.UnknownTenant):
            reg.remove("b")
        out.append((a.engine.published_seq, a.engine.tenant, reg.names(),
                    len(reg), "a" in reg, "b" in reg, reg.shape_classes(),
                    str(dup.value), unk.value.available, str(unk.value),
                    removed.name, a.shape_class))
    assert out[1] == out[0]
    for etype in ("tenant_registered", "tenant_removed"):
        assert _fields(tobs, etype) == _fields(jobs, etype)
    assert tobs.default_registry().snapshot()["gauges"] == \
        jobs.default_registry().snapshot()["gauges"]


def _tenant_records(mod, names_weights):
    return {n: mod.Tenant(spec=mod.TenantSpec(name=n, weight=w),
                          engine=None)
            for n, w in names_weights}


def test_scheduler_pick_and_charge_sequence_matches_reference():
    """A seeded schedule of backlogs, joins, idles and batch sizes: the
    picks, virtual times and served rows equal the reference's step by
    step."""
    nw = [("a", 1.0), ("b", 3.0), ("c", 0.5), ("d", 2.0)]
    seqs = []
    for mod, o in ((jten, jobs), (tten, tobs)):
        rng = np.random.default_rng(7)
        recs = _tenant_records(mod, nw)
        s = mod.FairShareScheduler()
        seq = []
        for _ in range(200):
            present = [recs[n] for n, _ in nw if rng.random() < 0.6]
            if not present:
                continue
            t = s.pick(present)
            rows = int(rng.integers(1, 33))
            s.charge(t, rows)
            seq.append((t.name, rows, t.vtime))
        seqs.append((seq, {n: (r.vtime, r.served_rows)
                           for n, r in recs.items()},
                     [o.counter_value("tenancy.served_rows", tenant=n)
                      for n, _ in nw]))
    assert seqs[1] == seqs[0]


def test_joiner_is_floored_to_the_virtual_clock():
    s = tten.FairShareScheduler()
    recs = _tenant_records(tten, [("old", 1.0), ("new", 1.0)])
    for _ in range(10):
        s.charge(s.pick([recs["old"]]), 10)
    assert s.pick([recs["old"], recs["new"]]).name == "new"
    assert recs["new"].vtime == 90.0


@pytest.mark.parametrize("quantize", [True, False])
def test_recommend_matches_reference(quantize):
    j, t = _engines([("a", 1.0, 0, {}), ("b", 2.0, 1, {}),
                     ("c", 1.0, 2, {"shape": {"users": 20, "items": 90}})],
                    quantize=quantize)
    req = [("a", 3), ("b", 3), ("c", 19), ("a", 31), ("b", 0), ("c", 0)]
    answers = []
    for eng in (j, t):
        tickets = [eng.submit(n, u) for n, u in req]
        assert eng._drain_round()
        answers.append([tk.result(timeout=1.0) for tk in tickets])
    for (n, u), (js, jx), (ts, tx) in zip(req, *answers):
        U, V = _factors({"a": 0, "b": 1, "c": 2}[n],
                        **({"users": 20, "items": 90} if n == "c" else {}))
        _same_answer(js, jx, ts, tx, U[u], V)
    assert {n: t.tenant(n).served_rows for n in "abc"} == \
        {n: j.tenant(n).served_rows for n in "abc"}
    path = "int8" if quantize else "exact"
    assert tobs.histogram_count("serving.score_seconds", path=path,
                                tenant="c") == 1
    assert tobs.histogram_count("serving.e2e_seconds") == 0


def test_weighted_fair_share_under_contention_matches_reference():
    out = []
    for eng in _engines([("heavy", 3.0, 0, {}), ("light", 1.0, 1, {})]):
        tickets = []
        for k in range(60):
            tickets.append(eng.submit("heavy", k % 32))
            tickets.append(eng.submit("light", k % 32))
        eng._drain_round()
        for tk in tickets:
            tk.result(timeout=1.0)
        h, li = eng.tenant("heavy"), eng.tenant("light")
        assert h.served_rows == li.served_rows == 60
        assert h.vtime == pytest.approx(li.vtime / 3.0)
        out.append((h.vtime, li.vtime, eng._round))
    assert out[1] == out[0]


def test_tenant_overloaded_is_typed_and_isolated():
    for mod, eng in zip((jten, tten), _engines(
            [("a", 1.0, 0, {"max_queue": 2}), ("b", 1.0, 1, {})])):
        eng.submit("a", 0)
        eng.submit("a", 1)
        with pytest.raises(mod.TenantOverloaded) as e:
            eng.submit("a", 2)
        assert e.value.tenant == "a"
        assert e.type.__mro__[1].__name__ == "Overloaded"
        eng.submit("b", 0)             # the neighbor still admits
        with pytest.raises(mod.UnknownTenant):
            eng.submit("zz", 0)
    assert tobs.counter_value("serving.shed", tenant="a") == \
        jobs.counter_value("serving.shed", tenant="a") == 1
    assert tobs.counter_value("serving.shed", tenant="b") == 0


def test_batch_fault_is_isolated_to_its_tenant():
    """``serving.score`` armed for one batch fails only the tenant whose
    batch it hit (the first pick: 'a'); 'b' is served in the same
    round; ``tenancy.batch_errors`` counts against 'a' only."""
    outs = []
    for f, o, eng in zip((jfaults, tfaults), (jobs, tobs), _engines(
            [("a", 1.0, 0, {}), ("b", 1.0, 1, {})])):
        f.install("serving.score=raise@nth=1")
        ta = [eng.submit("a", u) for u in (1, 2)]
        tb = [eng.submit("b", u) for u in (1, 2)]
        eng._drain_round()
        f.clear()
        failed = []
        for tk in ta:
            with pytest.raises(IOError) as e:
                tk.result(timeout=1.0)
            failed.append(type(e.value).__name__)
        for tk in tb:
            tk.result(timeout=1.0)
        outs.append((failed,
                     o.counter_value("tenancy.batch_errors", tenant="a"),
                     o.counter_value("tenancy.batch_errors", tenant="b"),
                     eng.tenant("a").served_rows,
                     eng.tenant("b").served_rows,
                     [e["status"] for e in _fields(o, "flight_record")]))
    assert outs[1] == outs[0]
    assert outs[1][:3] == (["InjectedFault"] * 2, 1, 0)


def test_publish_sequences_are_namespaced():
    U, V = _factors(0)
    out = []
    for eng in _engines([("a", 1.0, 0, {}), ("b", 1.0, 0, {})]):
        seq = eng.publish("a", U, -V)
        s2, m2 = eng.publish_update("a", U, -V.copy())
        tickets = [eng.submit("a", 4), eng.submit("b", 4)]
        eng._drain_round()
        (sa, ia), (sb, ib) = [tk.result(timeout=1.0) for tk in tickets]
        out.append((seq, s2, m2, eng.published_seq("a"),
                    eng.published_seq("b")))
        _same_answer(sa, ia, sa, ia, U[4], -V)
        _same_answer(sb, ib, sb, ib, U[4], V)
        assert not np.array_equal(np.asarray(ia), np.asarray(ib))
    assert out[1] == out[0] == (2, 3, "retag", 3, 1)
    assert _fields(tobs, "serving_publish") == \
        _fields(jobs, "serving_publish")


def test_tenant_plan_matches_reference():
    for kw in ({"rank": 8}, {"rank": 16, "n_users": 1000, "n_items": 70},
               {"rank": 128, "n_users": 162541, "n_items": 59047,
                "requested_buckets": (4, 16),
                "requested_cadence": {"max_batch": 7}}):
        assert tplan.resolve_tenant_plan(**kw) == \
            jplan.resolve_tenant_plan(**kw)
    for args in ((), (5,), (None, 9), (1, 1, 1), (0, 3, 1 << 20)):
        assert tplan.shape_class(*args) == jplan.shape_class(*args)


def test_attach_live_labels_the_updater_and_the_device_rules(monkeypatch):
    eng = tten.MultiTenantEngine(device="cpu")
    U, V = _factors(3)
    eng.add_tenant(tten.TenantSpec(name="a", freshness_slo_s=9.0,
                                   fold_items=True), U, V)
    m = model_from_arrays(8, np.arange(32), U, np.arange(48), V,
                          {"userCol": "user", "itemCol": "item",
                           "ratingCol": "rating", "regParam": 0.05},
                          device="cpu")
    upd = eng.registry.attach_live("a", FoldInServer(m))
    assert (upd.tenant, upd.slo_s, upd.fold_items) == ("a", 9.0, True)
    assert upd.device == torch.device("cpu")
    with pytest.raises(tten.TenancyError, match="already has"):
        eng.registry.attach_live("a", FoldInServer(m))
    upd._process([(1, 2, 3.0, 0.0, None), (40, 3, 4.0, 0.0, None)])
    assert tobs.histogram_count("live.freshness_seconds", tenant="a") == 2
    assert eng.published_seq("a") == 2
    with pytest.raises(ValueError, match="registry"):
        tten.MultiTenantEngine(registry=eng.registry, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for ctor in (tten.MultiTenantEngine, tten.TenantRegistry):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ctor()
