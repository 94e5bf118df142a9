"""Parity of the port's single-device training with ``tpu_als``.

Both packages start from the same injected ``(U0, V0)`` (torch cannot
reproduce jax.random's bits) on the same buckets and run three ALS
iterations on the CPU: the port through its kernels' plain versions on
each route, the JAX package through its CPU path (einsum + XLA
Cholesky).  The bar is the reference's own band for two solve paths over
three iterations, atol 5e-4 and rtol 5e-3 (``tests/test_gather_solve.py``).
The estimator is held to the same band when both packages resume from
one checkpoint in the shared format, and the ``train`` command writes a
model the reference loads.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpu_als
from tpu_als.core.als import AlsConfig as JConfig
from tpu_als.core.als import train as jtrain
from tpu_als.core.ratings import build_csr_buckets as jbuild
from tpu_als.io.checkpoint import load_factors as jload
from tpu_als.io.checkpoint import save_factors as jsave
import tpu_als_torch
from tpu_als_torch.core import als as tals
from tpu_als_torch.core.ratings import build_csr_buckets as tbuild

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 5e-4, 5e-3
NU, NI, NNZ, RANK = 40, 30, 500, 16

CONFIGS = {
    "explicit": {},
    "implicit": {"implicit_prefs": True, "alpha": 4.0},
    "nnls": {"nonnegative": True},
    "cg3_matfree": {"cg_iters": 3},
    "cg3_dense_implicit": {"cg_iters": 3, "cg_mode": "dense",
                           "implicit_prefs": True, "alpha": 4.0},
}


def _unit_rows(rng, n, r):
    x = rng.normal(size=(n, r)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@functools.lru_cache(maxsize=None)
def _problem():
    rng = np.random.default_rng(0)
    u = rng.integers(0, NU, NNZ)
    i = rng.integers(0, NI, NNZ)
    r = np.abs(rng.normal(size=NNZ)).astype(np.float32) + 0.1
    r[rng.random(NNZ) < 0.1] *= -1  # implicit: confidence, no preference
    return u, i, r, _unit_rows(rng, NU, RANK), _unit_rows(rng, NI, RANK)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's three iterations for CONFIGS[name]; a name ending
    in '_bf16' runs that config with the bf16 table."""
    u, i, r, U0, V0 = _problem()
    base, bf16, _ = name.partition("_bf16")
    extra = {"compute_dtype": "bfloat16"} if bf16 else {}
    cfg = JConfig(rank=RANK, max_iter=3, reg_param=0.1, **CONFIGS[base],
                  **extra)
    U, V = jtrain(jbuild(u, i, r, NU, native=False),
                  jbuild(i, u, r, NI, native=False), cfg, init=(U0, V0))
    return np.asarray(U), np.asarray(V)


def _port(name, **extra):
    u, i, r, U0, V0 = _problem()
    cfg = tals.AlsConfig(rank=RANK, max_iter=3, reg_param=0.1,
                         **CONFIGS[name], **extra)
    U, V = tals.train(tbuild(u, i, r, NU), tbuild(i, u, r, NI), cfg,
                      init=(U0, V0), device="cpu")
    return U.numpy(), V.numpy()


def _assert_close(got, ref):
    for g, j in zip(got, ref):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, j, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_three_iterations_match_reference(name):
    _assert_close(_port(name), _reference(name))


@pytest.mark.parametrize("backend", ["unfused", "gather_fused",
                                     "gather_fused_solve"])
def test_forced_routes_match_reference(backend):
    _assert_close(_port("implicit", solve_backend=backend),
                  _reference("implicit"))


@pytest.mark.parametrize("backend", ["auto", "unfused", "gather_fused",
                                     "gather_fused_solve"])
@pytest.mark.parametrize("name", ["explicit", "implicit"])
def test_bfloat16_table_on_every_route_matches_reference(name, backend):
    """``compute_dtype='bfloat16'`` (the gathered table and the weights in
    bf16, every sum in f32) on each route against the reference's bf16
    run.  The two frameworks round to bf16 at different points, so the
    band is bf16's: 2e-2 absolute on unit-scale factors."""
    ref = _reference(name + "_bf16")
    got = _port(name, compute_dtype="bfloat16", solve_backend=backend)
    for g, j in zip(got, ref):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, j, atol=2e-2, rtol=0)


def test_split_width_route_matches_reference(monkeypatch):
    """With the split width lowered to 8, every bucket wider than 8 goes
    through K3 (width cut into chunks of 8) + the tail + K1; with the
    memory budget lowered too, those buckets launch a few rows at a time
    (a 32-wide row's 4 partial Grams fill the budget of 3 rows)."""
    monkeypatch.setattr(tals, "SPLIT_WIDTH", 8)
    monkeypatch.setattr(tals, "_MEM_ELEMS", 12 * RANK * RANK)
    assert tals._chunk_rows("gatherfused+pallas_cholesky", 10, 32, RANK,
                            1 << 19) == 3
    u, i, r, _, _ = _problem()
    cfg = tals.AlsConfig(rank=RANK, implicit_prefs=True)
    labels = {tals.resolve_solve_path(cfg, RANK, b.width)
              for b in tbuild(u, i, r, NU).buckets}
    assert labels == {"gatherfused_solve", "gatherfused+pallas_cholesky"}
    _assert_close(_port("implicit"), _reference("implicit"))


def test_resolve_solve_path_labels():
    c = tals.AlsConfig
    assert tals.resolve_solve_path(c(), 128, 64) == "gatherfused_solve"
    assert tals.resolve_solve_path(c(), 128, tals.SPLIT_WIDTH * 2) == \
        "gatherfused+pallas_cholesky"
    assert tals.resolve_solve_path(c(), 256, 64) == "gatherfused_solve"
    assert tals.resolve_solve_path(c(), 256, tals.SPLIT_WIDTH * 2) == \
        "gatherfused+pallas_lanes_blocked"
    assert tals.resolve_solve_path(c(solve_backend="unfused"), 256, 8) == \
        "einsum+pallas_lanes_blocked"
    assert tals.resolve_solve_path(c(solve_backend="gather_fused"), 256,
                                   8) == "gatherfused+pallas_lanes_blocked"
    assert tals.resolve_solve_path(c(solve_backend="unfused"), 128, 8) == \
        "einsum+pallas_lanes"
    assert tals.resolve_solve_path(c(solve_backend="gather_fused"), 64,
                                   8) == "gatherfused+pallas_lanes"
    assert tals.resolve_solve_path(c(nonnegative=True), 16, 8) == \
        "einsum+nnls"
    assert tals.resolve_solve_path(c(cg_iters=2), 16, 8) == \
        "matfree_cg2_warmstart"
    assert tals.resolve_solve_path(c(cg_iters=2, cg_mode="dense"), 16,
                                   8) == "einsum+cg2_warmstart"
    # the one-shard ring on the local path: K4 on every bucket (K7 runs
    # under the sharded 'ring' strategies)
    assert tals.resolve_solve_path(c(solve_backend="gather_fused_ring"),
                                   16, tals.SPLIT_WIDTH * 2) == \
        "gatherfused_ring"
    with pytest.raises(NotImplementedError):
        tals.resolve_solve_path(c(adaptive_solve=True), 16, 8)
    with pytest.raises(ValueError):
        tals.resolve_solve_path(c(solve_backend="bogus"), 16, 8)


def test_auto_above_rank_128_keeps_the_gather_kernels():
    """Above K3/K4's rank 256, 'auto' still routes through them: on the
    card their wrappers raise (saying what is missing) rather than fall
    back to the torch Gram; on the CPU their plain versions take any rank
    and agree with the explicit 'unfused' route."""
    from tpu_als_torch.ops import cuda_gather_ne as gne

    class OnCard:
        device = torch.device("cuda")
        shape = (30, 264)

    with pytest.raises(NotImplementedError, match="at most rank 256"):
        gne._cuda_ready("gather_solve", OnCard())
    u, i, r, _, _ = _problem()
    g = torch.Generator().manual_seed(3)
    init = (tals.init_factors(NU, 264, g), tals.init_factors(NI, 264, g))
    got = {}
    for backend in ("auto", "unfused"):
        cfg = tals.AlsConfig(rank=264, max_iter=1, reg_param=0.1,
                             implicit_prefs=True, alpha=4.0,
                             solve_backend=backend)
        got[backend] = tals.train(tbuild(u, i, r, NU), tbuild(i, u, r, NI),
                                  cfg, init=init, device="cpu")
    _assert_close([x.numpy() for x in got["auto"]],
                  [x.numpy() for x in got["unfused"]])


@pytest.mark.parametrize("backend", ["auto", "unfused"])
@pytest.mark.parametrize("name", ["explicit", "implicit"])
def test_two_iterations_at_rank_256_match_reference(name, backend):
    """BASELINE config 3's width: two iterations from one injected init
    against the reference's ``train(..., init=)``.  'auto' goes through
    K4's plain version (every bucket here is narrow), 'unfused' through
    the torch normal equations and K6's plain factorization."""
    u, i, r, _, _ = _problem()
    rng = np.random.default_rng(256)
    U0, V0 = _unit_rows(rng, NU, 256), _unit_rows(rng, NI, 256)
    jcfg = JConfig(rank=256, max_iter=2, reg_param=0.1, **CONFIGS[name])
    ref = jtrain(jbuild(u, i, r, NU, native=False),
                 jbuild(i, u, r, NI, native=False), jcfg, init=(U0, V0))
    cfg = tals.AlsConfig(rank=256, max_iter=2, reg_param=0.1,
                         solve_backend=backend, **CONFIGS[name])
    got = tals.train(tbuild(u, i, r, NU), tbuild(i, u, r, NI), cfg,
                     init=(U0, V0), device="cpu")
    _assert_close([x.numpy() for x in got], [np.asarray(x) for x in ref])


def test_rank_256_checkpoint_loads_in_reference(tmp_path):
    """A rank-256 fit's checkpoint and saved model, written by the port,
    load in the reference with the same arrays."""
    data = _frame(seed=5)
    out = str(tmp_path / "ck")
    tm = tpu_als_torch.ALS(rank=256, maxIter=1, regParam=0.1,
                           checkpointDir=out, checkpointInterval=1,
                           device="cpu").fit(data)
    manifest, cu, cU, ci, cV = jload(os.path.join(out, "als_checkpoint"))
    assert manifest["rank"] == 256 and cU.shape[1] == 256
    np.testing.assert_array_equal(cU, tm._U.numpy())
    np.testing.assert_array_equal(cV, tm._V.numpy())
    path = str(tmp_path / "model")
    tm.save(path)
    jm = tpu_als.ALSModel.load(path)
    assert jm.rank == 256
    np.testing.assert_array_equal(np.asarray(jm._U), tm._U.numpy())
    np.testing.assert_array_equal(jm._user_map.ids, tm._user_map.ids)


def _frame(seed=1, n=400):
    rng = np.random.default_rng(seed)
    return {"user": 100 + 3 * rng.integers(0, 25, n),
            "item": 7 + 2 * rng.integers(0, 20, n),
            "rating": (rng.integers(1, 11, n) * 0.5).astype(np.float32)}


def test_fit_resumes_from_a_shared_checkpoint(tmp_path):
    data = _frame()
    uids, iids = np.unique(data["user"]), np.unique(data["item"])
    rng = np.random.default_rng(4)
    U0, V0 = _unit_rows(rng, len(uids), 8), _unit_rows(rng, len(iids), 8)
    params = {"regParam": 0.1, "implicitPrefs": True, "alpha": 4.0,
              "nonnegative": False, "cgIters": 0, "cgMode": "matfree"}
    ck = str(tmp_path / "ck")
    jsave(ck, uids, U0, iids, V0, params=params, iteration=1)
    kw = dict(rank=8, maxIter=3, regParam=0.1, implicitPrefs=True,
              alpha=4.0, resumeFrom=ck)
    jm = tpu_als.ALS(**kw).fit(data)
    out = str(tmp_path / "out")
    tm = tpu_als_torch.ALS(checkpointDir=out, checkpointInterval=1,
                           device="cpu", **kw).fit(data)
    np.testing.assert_array_equal(tm._user_map.ids, jm._user_map.ids)
    _assert_close((tm._U.numpy(), tm._V.numpy()), (jm._U, jm._V))
    # the port's checkpoint is the shared format, at the last iteration
    manifest, cu, cU, ci, cV = jload(os.path.join(out, "als_checkpoint"))
    assert manifest["iteration"] == 3
    np.testing.assert_array_equal(cU, tm._U.numpy())
    with pytest.raises(ValueError, match="regParam"):
        tpu_als_torch.ALS(device="cpu", **{**kw, "regParam": 0.2}).fit(data)


def test_fit_callback_and_later_slice_knobs():
    seen = []
    tpu_als_torch.ALS(rank=4, maxIter=2, device="cpu",
                      fitCallback=lambda it, U, V: seen.append(it)).fit(
        _frame())
    assert seen == [1, 2]
    for knob in ({"guardrails": "warn"}, {"elastic": True},
                 {"dataMode": "per_host"}, {"checkpointSharded": True},
                 {"gatherStrategy": "all_to_all"},
                 {"gatherStrategy": "all_gather_chunked"}):
        with pytest.raises(NotImplementedError):
            tpu_als_torch.ALS(**knob)
    with pytest.raises(TypeError, match="make_mesh"):
        tpu_als_torch.ALS(mesh=object())
    with pytest.raises(ValueError, match="non-finite"):
        bad = _frame()
        bad["rating"][3] = np.nan
        tpu_als_torch.ALS(device="cpu").fit(bad)


def test_cli_train_writes_a_model_the_reference_loads(tmp_path):
    data = _frame(seed=2, n=600)
    csv = tmp_path / "ratings.csv"
    with open(csv, "w") as f:
        f.write("userId,movieId,rating,timestamp\n")
        for u, i, r in zip(data["user"], data["item"], data["rating"]):
            f.write(f"{u},{i},{r},0\n")
    out = str(tmp_path / "model")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-m", "tpu_als_torch.cli", "train", "--data",
         f"csv:{csv}", "--rank", "4", "--max-iter", "2", "--implicit",
         "--device", "cpu", "--output", out], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    rmse = json.loads(res.stdout.strip().splitlines()[-1])["holdout_rmse"]
    assert np.isfinite(rmse)
    jm = tpu_als.ALSModel.load(out)
    tm = tpu_als_torch.ALSModel.load(out, device="cpu")
    assert jm.rank == tm.rank == 4
    np.testing.assert_array_equal(jm._U, tm._U.numpy())
