"""The gather strategies 'all_gather_chunked', 'all_to_all' and 'auto'
against ``tpu_als``.

- The host plans are numpy on both sides, held exactly:
  ``gather_block_plan``, and ``build_a2a`` field by field (``send_idx``,
  the compact buckets, R, ``padding_ratio``, ``degenerate``) on a sparse
  layout, a degenerate one and the ``'stub'`` build.
- One iteration (an item then a user half-step) of each strategy on 3
  logical CPU shards from one injected init, against the reference's
  ``shard_map`` step on the forced 8-device CPU and against the port's
  ``'all_gather'``, at STEP_TOL (f32; each side sums the same terms in
  its own order).
- ``comm_bytes_per_iter``, ``gather_model`` and
  ``resolve_gather_strategy`` equal the reference's integers and picks;
  ``ALS(mesh=, gatherStrategy=)`` sets the reference's
  ``lastFitStrategy`` and ``lastFitCommBytes``, the fallback of a
  degenerate all_to_all plan included (the reference's trainer stubbed
  out: the bookkeeping comes before it).
"""

import warnings

import numpy as np
import pytest
import torch

from tpu_als import plan as jplan
from tpu_als.api.estimator import ALS as JALS
from tpu_als.core.als import AlsConfig as JConfig
from tpu_als.parallel import a2a as ja2a
from tpu_als.parallel import comm as jcomm
from tpu_als.parallel import data as jdata
from tpu_als.parallel import trainer as jtrainer
from tpu_als.parallel.mesh import make_mesh as j_make_mesh
import tpu_als_torch
from tpu_als_torch import plan
from tpu_als_torch.convert import entity_rows
from tpu_als_torch.core import als as tals
from tpu_als_torch.parallel import a2a, comm, data, trainer
from tpu_als_torch.parallel.mesh import make_mesh

STEP_TOL = 1e-4
S = 3


def _ratings(kind):
    """``'sparse'``: every (user shard, item shard) pair references fewer
    rows than a shard holds (a working a2a plan); ``'dense'``: some pair
    references all of them (degenerate)."""
    rng = np.random.default_rng(5)
    if kind == "sparse":
        nu, ni, nnz = 200, 150, 600
    else:
        nu, ni, nnz = 60, 45, 1100
    u = rng.integers(0, nu, nnz)
    i = rng.integers(0, ni, nnz)
    r = (rng.integers(1, 11, nnz) * 0.5).astype(np.float32)
    r[rng.random(nnz) < 0.1] *= -1
    return nu, ni, u, i, r


def _parts(pkg, kind):
    nu, ni, u, i, r = _ratings(kind)
    return (pkg.partition_balanced(np.bincount(u, minlength=nu), S),
            pkg.partition_balanced(np.bincount(i, minlength=ni), S))


@pytest.mark.parametrize("per,n_blocks", [(1, 1), (7, 3), (15, 4), (16, 4),
                                          (5, 8), (100, 7)])
def test_gather_block_plan_matches_the_reference(per, n_blocks):
    got = comm.gather_block_plan(per, n_blocks)
    assert got == jcomm.gather_block_plan(per, n_blocks)
    assert sum(got[2]) == per


def _same_a2a(t, j):
    np.testing.assert_array_equal(t.send_idx, j.send_idx)
    assert t.send_idx.dtype == j.send_idx.dtype
    for name in ("rows_per_shard", "request_budget", "chunk_elems", "nnz",
                 "padding_ratio", "degenerate"):
        assert getattr(t, name) == getattr(j, name), name
    assert len(t.buckets) == len(j.buckets)
    for tb, jb in zip(t.buckets, j.buckets):
        for f in ("rows", "cols", "vals", "mask"):
            a, b = getattr(tb, f), getattr(jb, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("kind,on_degenerate", [("sparse", "build"),
                                                ("dense", "build"),
                                                ("dense", "stub")])
def test_build_a2a_matches_the_reference(kind, on_degenerate):
    nu, ni, u, i, r = _ratings(kind)
    tu, ti = _parts(data, kind)
    ju, ji = _parts(jdata, kind)
    for (tr, tc, jr, jc, rows, cols) in ((tu, ti, ju, ji, u, i),
                                         (ti, tu, ji, ju, i, u)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t = a2a.build_a2a(tr, tc, rows, cols, r, min_width=4,
                              on_degenerate=on_degenerate)
            j = ja2a.build_a2a(jr, jc, rows, cols, r, min_width=4,
                               on_degenerate=on_degenerate)
        _same_a2a(t, j)
        assert t.degenerate == (kind == "dense")
        if on_degenerate == "stub":
            assert t.buckets == [] and t.send_idx.shape == (S, S, 0)


def _containers(pkg_data, pkg_a2a, strategy, parts, u, i, r):
    up, ip = parts
    if strategy == "all_to_all":
        return (pkg_a2a.build_a2a(up, ip, u, i, r, min_width=4),
                pkg_a2a.build_a2a(ip, up, i, u, r, min_width=4))
    return (pkg_data.shard_csr(up, ip, u, i, r, min_width=4),
            pkg_data.shard_csr(ip, up, i, u, r, min_width=4))


def _init(nu, ni):
    g = np.random.default_rng(3)
    U0 = g.normal(size=(nu, 4)).astype(np.float32)
    V0 = g.normal(size=(ni, 4)).astype(np.float32)
    return U0, V0


@pytest.mark.parametrize("strategy", ["all_gather_chunked", "all_to_all"])
@pytest.mark.parametrize("implicit", [False, True])
def test_one_iteration_matches_the_reference_and_all_gather(strategy,
                                                            implicit):
    nu, ni, u, i, r = _ratings("sparse")
    U0, V0 = _init(nu, ni)
    kw = dict(rank=4, max_iter=1, reg_param=0.05, implicit_prefs=implicit,
              alpha=6.0)
    tparts, jparts = _parts(data, "sparse"), _parts(jdata, "sparse")
    us, is_ = _containers(data, a2a, strategy, tparts, u, i, r)
    mesh = make_mesh(devices=["cpu"] * S)
    got = trainer.train_sharded(mesh, *tparts, us, is_, tals.AlsConfig(**kw),
                                strategy=strategy, init=(U0, V0))
    ag = trainer.train_sharded(
        mesh, *tparts, *_containers(data, a2a, "all_gather", tparts, u, i,
                                    r), tals.AlsConfig(**kw),
        strategy="all_gather", init=(U0, V0))
    jus, jis = _containers(jdata, ja2a, strategy, jparts, u, i, r)
    JU, JV = jtrainer.train_sharded(j_make_mesh(S), *jparts, jus, jis,
                                    JConfig(**kw), strategy=strategy,
                                    init=(U0, V0))
    for part, g, a, j in ((tparts[0], got[0], ag[0], JU),
                          (tparts[1], got[1], ag[1], JV)):
        g, a = entity_rows(part, g).numpy(), entity_rows(part, a).numpy()
        j = np.asarray(j)[jparts[0 if part is tparts[0] else 1].slot]
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, j, atol=STEP_TOL, rtol=STEP_TOL)
        np.testing.assert_allclose(g, a, atol=STEP_TOL, rtol=STEP_TOL)


@pytest.mark.parametrize("implicit", [False, True])
def test_comm_bytes_per_iter_matches_the_reference(implicit):
    nu, ni, u, i, r = _ratings("sparse")
    tparts, jparts = _parts(data, "sparse"), _parts(jdata, "sparse")
    cases = [("all_gather", None), ("all_gather_chunked", "sharded"),
             ("ring", "ring"), ("ring_overlap", "ring"),
             ("all_to_all", "a2a"), ("gather_fused_ring", "ring")]
    for strategy, kind in cases:
        for dtype in (("float32", "bfloat16")
                      if strategy == "gather_fused_ring" else ("float32",)):
            built = []
            for pkg_data, pkg_comm, pkg_a2a, (up, ip) in (
                    (data, comm, a2a, tparts),
                    (jdata, jcomm, ja2a, jparts)):
                if kind == "ring":
                    c = (pkg_comm.shard_csr_grid(up, ip, u, i, r),
                         pkg_comm.shard_csr_grid(ip, up, i, u, r))
                elif kind == "a2a":
                    c = _containers(pkg_data, pkg_a2a, "all_to_all",
                                    (up, ip), u, i, r)
                elif kind == "sharded":
                    c = _containers(pkg_data, pkg_a2a, "all_gather",
                                    (up, ip), u, i, r)
                else:
                    c = (None, None)
                built.append(c)
            got = trainer.comm_bytes_per_iter(
                strategy, *tparts, 8, *built[0], implicit=implicit,
                compute_dtype=dtype)
            ref = jtrainer.comm_bytes_per_iter(
                strategy, *jparts, 8, *built[1], implicit=implicit,
                compute_dtype=dtype)
            assert isinstance(got, int) and got == ref, (strategy, dtype)
    with pytest.raises(ValueError, match="A2aCsr"):
        trainer.comm_bytes_per_iter("all_to_all", *tparts, 8)
    with pytest.raises(ValueError, match="unknown strategy"):
        trainer.comm_bytes_per_iter("auto", *tparts, 8)


@pytest.mark.parametrize("n_users,n_items,rank,D,implicit", [
    (60, 45, 4, 3, False), (60, 45, 4, 3, True), (162541, 59047, 128, 4,
                                                  True),
    (10, 1000, 16, 8, False), (7, 7, 2, 1, True)])
def test_resolve_gather_strategy_matches_the_reference(n_users, n_items,
                                                       rank, D, implicit):
    kw = dict(n_users=n_users, n_items=n_items, rank=rank, n_devices=D,
              implicit=implicit)
    assert plan.gather_model(**kw) == jplan.gather_model(**kw)
    assert plan.GATHER_CANDIDATES == jplan.GATHER_CANDIDATES
    for req in ("auto", "ring", "all_to_all"):
        assert plan.resolve_gather_strategy(requested=req, **kw) == \
            jplan.resolve_gather_strategy(requested=req, **kw)


@pytest.mark.parametrize("strategy,kind", [
    ("all_gather_chunked", "sparse"), ("all_to_all", "sparse"),
    ("all_to_all", "dense"), ("auto", "dense"), ("ring", "dense")])
def test_estimator_bookkeeping_matches_the_reference(monkeypatch, strategy,
                                                     kind):
    """``lastFitStrategy`` and ``lastFitCommBytes`` after ``ALS(mesh=,
    gatherStrategy=).fit``: the effective strategy (``'auto'`` resolved,
    a degenerate all_to_all fallen back to ``'all_gather'``) and its
    traffic, as the reference computes them before training."""
    nu, ni, u, i, r = _ratings(kind)
    frame = {"user": u, "item": i, "rating": r}

    def no_training(mesh, up, ip, us, is_, cfg, **kw):
        return (np.zeros((up.padded_rows, cfg.rank), np.float32),
                np.zeros((ip.padded_rows, cfg.rank), np.float32))

    monkeypatch.setattr(jtrainer, "train_sharded", no_training)
    kw = dict(rank=4, maxIter=2, regParam=0.05, implicitPrefs=True)
    jest = JALS(mesh=j_make_mesh(S), gatherStrategy=strategy, **kw)
    est = tpu_als_torch.ALS(mesh=make_mesh(devices=["cpu"] * S),
                            gatherStrategy=strategy, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jest.fit(frame)
        model = est.fit(frame)
    assert est.lastFitStrategy == jest.lastFitStrategy
    assert est.lastFitCommBytes == jest.lastFitCommBytes
    want = {"auto": "all_gather", "all_to_all": (
        "all_to_all" if kind == "sparse" else "all_gather")}
    assert est.lastFitStrategy == want.get(strategy, strategy)
    assert torch.isfinite(model._U).all()
    # a single-device fit clears the mesh fit's bookkeeping
    est.mesh, est.device = None, "cpu"
    est.fit(frame)
    assert est.lastFitStrategy is None and est.lastFitCommBytes is None
