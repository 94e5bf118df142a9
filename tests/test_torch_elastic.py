"""Elastic training on logical shards, held against ``tpu_als``.

- The mechanics of ``resilience/elastic.py`` beside the reference's on
  the forced 8-device CPU: the lost registry, ``_victim_index``,
  ``classify``, ``surviving_devices`` (the survivors keep their logical
  ids, so a second loss by position names the same shard as the
  reference's), and ``wrap_step``: a transient failure retried in place,
  a dead shard raising ``DeviceLost``, the transient budget exhausted.
  The stated divergence: a ``RuntimeError`` from the step propagates
  unprobed in the port, where the reference also catches JAX's runtime
  error (a ``RuntimeError``).
- The elastic fit end to end: both packages' ``fit_sharded`` with
  ``elastic=True`` on 4 shards, a checkpoint every iteration and
  ``mesh.device_lost=corrupt@nth=3``, from one injected ``(U0, V0)``.
  Within the port the recovered factors equal bitwise a fault-free
  3-shard fit resumed from the same checkpoint (the reference's
  device-loss scenario judge); against the reference they agree within
  TRAIN_TOL, the band of the port's sharded parity tests
  (``tests/test_torch_ring.py``); the event trail and the
  ``train.reformations`` counter are the reference's, and so is the
  traced recovery tree that ``observe explain`` rebuilds.
"""

import shutil

import numpy as np
import pytest

import jax

from tpu_als import obs as jobs
from tpu_als.obs import tracing as jtracing
from tpu_als.api import fitting as jfitting
from tpu_als.api.estimator import ALS as JALS
from tpu_als.core.als import AlsConfig as JConfig
from tpu_als.core.ratings import remap_ids as j_remap_ids
from tpu_als.parallel.mesh import make_mesh as j_make_mesh
from tpu_als.resilience import elastic as jelastic
from tpu_als.resilience import faults as jfaults
import tpu_als_torch
from tpu_als_torch import obs
from tpu_als_torch.obs import explain, tracing
from tpu_als_torch.api import fitting
from tpu_als_torch.core import als as tals
from tpu_als_torch.core.ratings import remap_ids
from tpu_als_torch.parallel.mesh import make_mesh
from tpu_als_torch.resilience import elastic, faults
from tpu_als_torch.resilience.retry import RetryPolicy

TRAIN_TOL = 2e-3            # the port's sharded parity band
RECOVERY = ("device_lost", "mesh_reformed", "elastic_resume")


@pytest.fixture(autouse=True)
def _clean():
    for pkg in (elastic, jelastic):
        pkg.clear_lost()
    for pkg in (faults, jfaults):
        pkg.clear()
    yield
    for pkg in (elastic, jelastic):
        pkg.clear_lost()
    for pkg in (faults, jfaults):
        pkg.clear()


def _fast(max_attempts=2):
    return RetryPolicy(max_attempts=max_attempts, base_delay=0.0,
                       jitter=0.0, sleep=lambda s: None,
                       retry_on=(OSError, TimeoutError))


def _cpu_mesh(S, ids=None):
    return make_mesh(devices=["cpu"] * S, ids=ids)


def test_registry_and_victim_index_match_the_reference():
    for pkg in (elastic, jelastic):
        assert pkg.lost_devices() == frozenset()
        pkg.mark_lost(2, 5)
        assert pkg.lost_devices() == frozenset({2, 5})
        pkg.clear_lost()
        assert pkg.lost_devices() == frozenset()
    for env in ({}, {"TPU_ALS_LOST_DEVICE": "1"}, {"TPU_ALS_LOST_DEVICE": ""}):
        assert elastic._victim_index(4, environ=env) == \
            jelastic._victim_index(4, environ=env)
    for bad, match in (("x", "not an integer"), ("4", "out of range"),
                       ("-1", "out of range")):
        for pkg in (elastic, jelastic):
            with pytest.raises(ValueError, match=match):
                pkg._victim_index(4, environ={"TPU_ALS_LOST_DEVICE": bad})


def test_classify_reports_only_dead_shards_as_the_reference():
    mesh = _cpu_mesh(4)
    jdev = jax.devices()[:4]
    policy = RetryPolicy(max_attempts=2, base_delay=0.0, jitter=0.0)
    assert elastic.classify(mesh.shards, policy=policy) == () == \
        jelastic.classify(jdev, policy=policy)
    elastic.mark_lost(mesh.ids[2])
    jelastic.mark_lost(jdev[2].id)
    assert elastic.classify(mesh.shards, policy=policy) == (2,) == \
        jelastic.classify(jdev, policy=policy)


def test_survivors_keep_their_ids_and_a_second_loss_matches(monkeypatch):
    """One loss, the mesh re-formed on the survivors, then a second loss
    by position (``TPU_ALS_LOST_DEVICE=1``): the port names the same
    logical shard as the reference, because the survivors keep their
    ids."""
    mesh, jmesh = _cpu_mesh(4), j_make_mesh(4)
    elastic.mark_lost(1)
    jelastic.mark_lost(int(jmesh.devices.flat[1].id))
    surv = elastic.surviving_devices(mesh)
    jsurv = jelastic.surviving_devices(jmesh)
    assert [s.id for s in surv] == [int(d.id) for d in jsurv] == [0, 2, 3]
    mesh3 = make_mesh(devices=[s.device for s in surv],
                      ids=[s.id for s in surv])
    jmesh3 = j_make_mesh(devices=jsurv)
    assert mesh3.ids == (0, 2, 3)
    monkeypatch.setenv("TPU_ALS_LOST_DEVICE", "1")
    lost = []
    for pkg, fpkg, m in ((elastic, faults, mesh3), (jelastic, jfaults,
                                                      jmesh3)):
        fpkg.install("mesh.device_lost=corrupt@once")
        with pytest.raises(pkg.DeviceLost) as ei:
            pkg.wrap_step(lambda U, V: (U, V), m, policy=_fast())(0, 0)
        lost.append((ei.value.lost, ei.value.surviving))
    assert lost[0] == lost[1] == ((2,), 2)


@pytest.mark.parametrize("case", ["transient", "dead", "exhausted"])
def test_wrap_step_behaves_as_the_reference(case):
    """A transient failure retried in place; a dead shard raising
    ``DeviceLost`` (lost the last position's id, 3 surviving, caused by
    ``ProbeFailed``); a failure that persists with every shard healthy
    re-raised once the transient budget is spent."""
    out = []
    for pkg, fpkg, mesh in ((elastic, faults, _cpu_mesh(4)),
                            (jelastic, jfaults, j_make_mesh(4))):
        calls = []

        def step(U, V):
            calls.append(1)
            if case == "exhausted" or (case == "transient"
                                       and len(calls) < 2):
                raise OSError("link hiccup")
            return U, V

        if case == "dead":
            fpkg.install("mesh.device_lost=corrupt@once")
        wrapped = pkg.wrap_step(step, mesh, policy=_fast(),
                                max_transient=2)
        if case == "transient":
            out.append((wrapped(1, 2), len(calls)))
        elif case == "dead":
            with pytest.raises(pkg.DeviceLost) as ei:
                wrapped(0, 0)
            assert isinstance(ei.value.__cause__, pkg.ProbeFailed)
            out.append((ei.value.lost, ei.value.surviving, len(calls)))
            fpkg.clear()
        else:
            with pytest.raises(OSError, match="hiccup"):
                wrapped(0, 0)
            out.append(len(calls))
    assert out[0] == out[1]
    assert out[0] == {"transient": ((1, 2), 2), "dead": ((3,), 3, 0),
                      "exhausted": 3}[case]


def test_runtime_error_propagates_unprobed(monkeypatch):
    """The stated divergence: a ``RuntimeError`` (a CUDA error, a kernel
    failure) from the step is not probed, not retried and not turned
    into ``DeviceLost``; the reference's failure types add JAX's
    runtime error, a ``RuntimeError``."""
    probed, calls = [], []
    monkeypatch.setattr(elastic, "classify",
                        lambda *a, **k: probed.append(1) or ())

    def step(U, V):
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access")

    wrapped = elastic.wrap_step(step, _cpu_mesh(4), policy=_fast())
    with pytest.raises(RuntimeError, match="illegal memory"):
        wrapped(0, 0)
    assert calls == [1] and probed == []
    assert not any(issubclass(t, RuntimeError)
                   for t in elastic._step_failure_types())
    assert any(issubclass(t, RuntimeError)
               for t in jelastic._step_failure_types())


# -- the elastic fit end to end ---------------------------------------------

NU, NI, RANK, ITERS = 60, 45, 4, 3


def _data():
    rng = np.random.default_rng(2)
    u = rng.integers(0, NU, 1100)
    i = rng.integers(0, NI, 1100)
    r = (rng.integers(1, 11, 1100) * 0.5).astype(np.float32)
    g = np.random.default_rng(3)
    U0 = g.normal(size=(NU, RANK)).astype(np.float32)
    V0 = g.normal(size=(NI, RANK)).astype(np.float32)
    return u, i, r, U0, V0


def _kw(ckdir):
    return dict(rank=RANK, maxIter=ITERS, regParam=0.05,
                checkpointDir=str(ckdir), checkpointInterval=1)


def _recovery(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "path")}
            for e in events if e["type"] in RECOVERY]


@pytest.fixture(scope="module")
def elastic_fits(tmp_path_factory):
    """The port's elastic fit (and a copy of every checkpoint it resumed
    past), the port's fault-free 3-shard fit resumed from the same
    checkpoint, and the reference's elastic fit, from one init."""
    tmp = tmp_path_factory.mktemp("elastic")
    u, i, r, U0, V0 = _data()
    u_idx, umap = remap_ids(u)
    i_idx, imap = remap_ids(i)
    init = (U0[:len(umap)], V0[:len(imap)])
    cfg = tals.AlsConfig(rank=RANK, max_iter=ITERS, reg_param=0.05)

    kept = tmp / "kept"

    def keep(it, U, V):
        # the checkpoint on disk before this iteration's save: the one a
        # resumed pass started from
        src = tmp / "port" / "als_checkpoint"
        if src.is_dir() and not (kept / str(it - 1)).exists():
            shutil.copytree(src, kept / str(it - 1))

    obs.reset()
    tracing.reset_trace_ids(0)
    faults.install("mesh.device_lost=corrupt@nth=3")
    est = tpu_als_torch.ALS(mesh=_cpu_mesh(4), elastic=True,
                            fitCallback=keep, **_kw(tmp / "port"))
    with tracing.traced():
        U, V = fitting.fit_sharded(est, u_idx, i_idx, r, umap, imap, cfg,
                                   init, 0,
                                   callback=est._callback(umap, imap))
    faults.clear()
    events = obs.events()
    counters = obs.snapshot()["counters"]
    resumed = [e for e in events if e["type"] == "elastic_resume"][0]

    # fault-free on the 3 survivors, from the checkpoint the fit resumed
    elastic.clear_lost()
    ref3 = tpu_als_torch.ALS(
        mesh=_cpu_mesh(3), rank=RANK, maxIter=ITERS, regParam=0.05,
        resumeFrom=str(kept / str(resumed["iteration"]))).fit(
            {"user": u, "item": i, "rating": r})

    ju_idx, jumap = j_remap_ids(u)
    ji_idx, jimap = j_remap_ids(i)
    jest = JALS(mesh=j_make_mesh(4), elastic=True, **_kw(tmp / "ref"))
    jreg = jobs.reset()
    jtracing.reset_trace_ids(0)
    jfaults.install("mesh.device_lost=corrupt@nth=3")
    with jtracing.traced():
        JU, JV = jfitting.fit_sharded(
            jest, ju_idx, ji_idx, r, jumap, jimap,
            JConfig(rank=RANK, max_iter=ITERS, reg_param=0.05), init, 0)
    jfaults.clear()
    return {"U": U.numpy(), "V": V.numpy(), "events": events,
            "counters": counters, "mesh3": (ref3._U.numpy(),
                                            ref3._V.numpy()),
            "ref": (np.asarray(JU), np.asarray(JV)),
            "ref_events": list(jreg._events),
            "ref_counters": jreg.snapshot()["counters"],
            "resumed": resumed}


def test_elastic_fit_equals_a_fresh_shrunk_fit_bitwise(elastic_fits):
    f = elastic_fits
    assert f["resumed"]["source"] == "checkpoint"
    assert f["resumed"]["iteration"] == 2 and f["resumed"]["devices"] == 3
    assert np.isfinite(f["U"]).all() and np.isfinite(f["V"]).all()
    np.testing.assert_array_equal(f["U"], f["mesh3"][0])
    np.testing.assert_array_equal(f["V"], f["mesh3"][1])


def test_elastic_fit_matches_the_reference(elastic_fits):
    f = elastic_fits
    for got, ref in zip((f["U"], f["V"]), f["ref"]):
        np.testing.assert_allclose(got, ref, atol=TRAIN_TOL, rtol=TRAIN_TOL)


def test_elastic_event_trail_matches_the_reference(elastic_fits):
    f = elastic_fits
    mine, theirs = _recovery(f["events"]), _recovery(f["ref_events"])
    assert [e["type"] for e in mine] == list(RECOVERY)
    assert mine == theirs
    assert f["counters"]["train.reformations"] == 1 == \
        f["ref_counters"]["train.reformations"]
    assert mine[0]["lost"] == [3] and mine[0]["iteration"] == 3


def test_recovery_tree_matches_the_reference(elastic_fits):
    """Armed tracing: the recovery's ``elastic.detect`` → ``elastic.reform``
    → ``elastic.resume`` spans, ids, parent links and fields equal the
    reference's, and ``observe explain`` rebuilds the tree from the
    events alone."""
    def spans(events):
        return [{k: v for k, v in e.items() if k not in ("ts", "seconds")}
                for e in events if e["type"] == "trace_span"]

    mine, theirs = spans(elastic_fits["events"]), spans(
        elastic_fits["ref_events"])
    assert [e["name"] for e in mine] == ["elastic.detect", "elastic.reform",
                                         "elastic.resume"]
    assert mine == theirs
    traces = explain.build_traces(elastic_fits["events"])
    (tid, tree), = traces.items()
    text = explain.render_trace(tid, tree)
    for name in ("elastic.detect", "elastic.reform", "elastic.resume"):
        assert name in text


def test_no_surviving_shard_propagates_device_lost():
    """One shard left to lose: ``DeviceLost`` propagates, through
    ``train_sharded(elastic=True)`` and through the estimator."""
    u, i, r, _, _ = _data()
    faults.install("mesh.device_lost=corrupt@once")
    with pytest.raises(elastic.DeviceLost) as ei:
        tpu_als_torch.ALS(mesh=_cpu_mesh(1), elastic=True, rank=RANK,
                          maxIter=2).fit({"user": u, "item": i,
                                          "rating": r})
    assert ei.value.lost == (0,) and ei.value.iteration == 1
    # two shards, each lost in turn: one reformation, then nothing left
    elastic.clear_lost()
    obs.reset()
    faults.install("mesh.device_lost=corrupt@first=2")
    with pytest.raises(elastic.DeviceLost):
        tpu_als_torch.ALS(mesh=_cpu_mesh(2), elastic=True, rank=RANK,
                          maxIter=2).fit({"user": u, "item": i,
                                          "rating": r})
    assert obs.snapshot()["counters"]["train.reformations"] == 1
    assert [e["source"] for e in obs.events("elastic_resume")] == \
        ["scratch"]
