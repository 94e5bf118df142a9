"""Stage attribution in the port (``perf/attribution.py``,
``obs/trace.py``) against ``tpu_als``'s.

- The decomposed twin computes the production iteration: its factors
  equal ``core.als.als_step``'s (which runs ``local_half_step``) at rel
  1e-5 (on the CPU they are bitwise), on every exact route: 'auto' with
  K4 and K3 buckets mixed (``SPLIT_WIDTH`` monkeypatched low, as the
  ring tests do), 'unfused', 'gather_fused', 'gather_fused_solve' and
  nonnegative; explicit and implicit.  Each bucket is fenced under its
  route's stage names.
- CG raises ``AttributionUnsupported``, as the reference's twin.
- Disarmed, ``train`` is bitwise the loop of ``als_step`` and records no
  stage; armed (``stage_attribution`` or the variable), it records
  ``train.stage_seconds`` and ends bitwise the disarmed fit.
- ``measure_attributed``'s stages cover at least 90 % of its wall.
- ``attribution_report`` and ``render_attribution`` give the
  reference's dict and text for the same measured dict and roofline.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_als.perf import attribution as jattr
from tpu_als.perf.roofline import roofline as jroofline
from tpu_als_torch import obs
from tpu_als_torch.core import als as tals
from tpu_als_torch.core.ratings import build_csr_buckets
from tpu_als_torch.obs import trace
from tpu_als_torch.perf import attribution
from tpu_als_torch.perf.attribution import AttributionUnsupported

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny tensors: under the suite's
    workers a thread pool per small op mostly waits for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh():
    obs.reset()
    trace.disable_stage_attribution()
    yield
    obs.reset()
    trace.disable_stage_attribution()


def _problem(nU=80, nI=50, nnz=1200, seed=0):
    gen = np.random.default_rng(seed)
    u = np.minimum(gen.zipf(1.4, nnz), nU) - 1
    i = np.minimum(gen.zipf(1.3, nnz), nI) - 1
    r = gen.uniform(0.5, 5.0, nnz).astype(np.float32)
    return (build_csr_buckets(u, i, r, nU, min_width=4, chunk_elems=1 << 12),
            build_csr_buckets(i, u, r, nI, min_width=4, chunk_elems=1 << 12))


def _init(cfg, nU, nI):
    g = torch.Generator().manual_seed(cfg.seed)
    return (tals.init_factors(nU, cfg.rank, g),
            tals.init_factors(nI, cfg.rank, g))


ROUTE_STAGES = {"gatherfused_solve": {"gather_fused_solve"},
                "gatherfused+pallas_cholesky": {"gather_fused_ne", "solve"},
                "gatherfused+pallas_lanes": {"gather_fused_ne", "solve"},
                "einsum+pallas_lanes": {"gather_stream", "normal_eq", "solve"},
                "einsum+nnls": {"gather_stream", "normal_eq", "solve"}}


@pytest.mark.parametrize("implicit", [True, False])
@pytest.mark.parametrize("backend", ["auto", "unfused", "gather_fused",
                                     "gather_fused_solve", "nonnegative"])
def test_twin_equals_the_production_iteration(backend, implicit,
                                              monkeypatch):
    monkeypatch.setattr(tals, "SPLIT_WIDTH", 32)
    ucsr, icsr = _problem()
    cfg = tals.AlsConfig(rank=4, implicit_prefs=implicit, alpha=4.0,
                         reg_param=0.05)
    cfg = (dataclasses.replace(cfg, nonnegative=True)
           if backend == "nonnegative"
           else dataclasses.replace(cfg, solve_backend=backend))
    nU, nI = ucsr.num_rows, icsr.num_rows
    ub, ib = ucsr.to("cpu"), icsr.to("cpu")
    U, V = _init(cfg, nU, nI)
    Uf, Vf = tals.als_step(U, V, ub, ib, nU, nI, cfg, ucsr.chunk_elems,
                           icsr.chunk_elems)
    sink = {}
    step = attribution.make_attributed_step(ub, ib, nU, nI, cfg,
                                            ucsr.chunk_elems,
                                            icsr.chunk_elems, sink=sink)
    Ua, Va = step(U, V)
    np.testing.assert_allclose(Ua.numpy(), Uf.numpy(), rtol=RTOL, atol=0)
    np.testing.assert_allclose(Va.numpy(), Vf.numpy(), rtol=RTOL, atol=0)
    if backend == "auto":
        assert set(step.routes) == {"gatherfused_solve",
                                    "gatherfused+pallas_cholesky"}
    want = {"gather_stream", "scatter"} | ({"yty"} if implicit else set())
    for route in step.routes:
        want |= ROUTE_STAGES[route]
    assert set(sink) == want


def test_cg_has_no_twin():
    ucsr, icsr = _problem(nU=30, nI=20, nnz=300)
    with pytest.raises(AttributionUnsupported):
        attribution.make_attributed_step(
            ucsr.to("cpu"), icsr.to("cpu"), ucsr.num_rows, icsr.num_rows,
            tals.AlsConfig(rank=4, cg_iters=3))
    # a ValueError, as the reference's
    assert issubclass(AttributionUnsupported, ValueError)
    assert issubclass(jattr.AttributionUnsupported, ValueError)


def test_disarmed_train_is_the_plain_loop():
    ucsr, icsr = _problem(nU=40, nI=30, nnz=400)
    cfg = tals.AlsConfig(rank=4, max_iter=2, implicit_prefs=True)
    U1, V1 = tals.train(ucsr, icsr, cfg, device="cpu")
    U, V = _init(cfg, ucsr.num_rows, icsr.num_rows)
    for _ in range(2):
        U, V = tals.als_step(U, V, ucsr.to("cpu"), icsr.to("cpu"),
                             ucsr.num_rows, icsr.num_rows, cfg,
                             ucsr.chunk_elems, icsr.chunk_elems)
    assert torch.equal(U1, U) and torch.equal(V1, V)
    assert not any(k.startswith("train.stage_seconds")
                   for k in obs.snapshot()["histograms"])


@pytest.mark.parametrize("how", ["scoped", "variable"])
def test_armed_train_records_stages_and_matches(how, monkeypatch):
    ucsr, icsr = _problem(nU=40, nI=30, nnz=400)
    cfg = tals.AlsConfig(rank=4, max_iter=2, implicit_prefs=True)
    U1, V1 = tals.train(ucsr, icsr, cfg, device="cpu")
    obs.reset()
    if how == "variable":
        monkeypatch.setenv(trace._ENV_FLAG, "1")
        assert trace.stage_attribution_armed()
        U2, V2 = tals.train(ucsr, icsr, cfg, device="cpu")
        monkeypatch.setenv(trace._ENV_FLAG, "0")
        assert not trace.stage_attribution_armed()
    else:
        with trace.stage_attribution():
            U2, V2 = tals.train(ucsr, icsr, cfg, device="cpu")
        assert not trace.stage_attribution_armed()
    assert torch.equal(U1, U2) and torch.equal(V1, V2)
    hists = {k: v for k, v in obs.snapshot()["histograms"].items()
             if k.startswith("train.stage_seconds")}
    stages = {k.split('stage="')[1].rstrip('"}') for k in hists}
    assert {"gather_fused_solve", "scatter", "yty", "gather_stream"} <= stages
    assert all(v["count"] >= 2 for v in hists.values())


def test_fence_passes_cpu_tensors_and_host_values():
    x = (torch.ones(3), {"a": [1, "b"]})
    assert trace.fence(x) is x


def test_measure_attributed_coverage():
    ucsr, icsr = _problem(nU=150, nI=100, nnz=3000)
    cfg = tals.AlsConfig(rank=8, implicit_prefs=True)
    m = attribution.measure_attributed(ucsr, icsr, cfg, iters=2, warmup=1,
                                       device="cpu")
    assert m["wall_s_per_iter"] > 0 and m["stage_seconds"]
    assert m["sum_stage_s_per_iter"] == pytest.approx(
        sum(m["stage_seconds"].values()))
    assert 0.9 <= m["coverage"] <= 1.01, m
    assert m["unattributed_s_per_iter"] == pytest.approx(
        m["wall_s_per_iter"] - m["sum_stage_s_per_iter"])
    assert m["fused_s_per_iter"] > 0
    assert m["ne_path"] == "gather_fused_solve"
    assert m["resolved_solve_path"] == "gatherfused_solve"


def test_report_and_render_equal_the_reference():
    measured = {
        "stage_seconds": {"solve": 0.004, "mystery": 0.001,
                          "gather_stream": 0.002},
        "wall_s_per_iter": 0.01, "sum_stage_s_per_iter": 0.007,
        "coverage": 0.7, "unattributed_s_per_iter": 0.003,
        "resolved_solve_path": "einsum", "iters": 2, "warmup": 1,
        "fused_s_per_iter": 0.002,
    }
    rl = jroofline(1000, 500, 20000, 8, dtype="float32", implicit=True,
                   padding_waste=1.2)
    mine = attribution.attribution_report(measured, rl)
    theirs = jattr.attribution_report(measured, rl)
    assert mine == theirs
    assert attribution.render_attribution(mine) == \
        jattr.render_attribution(theirs)
    rows = {r["stage"]: r for r in mine["rows"]}
    assert rows["mystery"]["floor_s"] is None
    assert rows["normal_eq"]["measured_s"] is None
    assert rows["solve"]["gap_x"] == pytest.approx(
        0.004 / rows["solve"]["floor_s"])
