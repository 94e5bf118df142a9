"""The port stands alone and never hides its kernels.

- Every ``tpu_als_torch`` module, and everything ``chip_smoke.py``
  imports, imports with ``jax`` and ``tpu_als`` made unimportable.
- ``device=None`` entry points raise without a CUDA device instead of
  running quietly on the CPU.
- The kernel wrappers (K1-K6) and a CPU ``ALS.fit`` run the plain
  versions on CPU tensors and leave the launch counters at 0; TF32 stays
  off.
- The sharded path (K7, K8): CPU logical shards take the plain versions;
  any other tensor gets the kernel or an error, never a plain version; a
  mesh over two cards raises ``NotImplementedError`` naming what is
  missing; ``parallel/peer.py`` (their transport across processes on
  one card) imports without ``jax`` and ``tpu_als``; 'all_gather_chunked', 'all_to_all' and ``elastic=True`` run
  and agree with 'all_gather', and ``train_sharded('auto')`` raises the
  reference's ``ValueError``.
- ``chip_smoke.py`` fails, printing no result, without a CUDA device and
  when it stands in a directory without the rest of the repository.
- The input path and the guardrails (the native bucketizer and CSV
  reader, the MovieLens loaders, ``obs``, ``resilience``, the adaptive
  ladder) run with ``jax`` and ``tpu_als`` unimportable, and the native
  libraries are built from the port's own sources into
  ``tpu_als_torch/_build/``.
- The Spark ML surface (pipeline, tuners, legacy API) and the checkpoint
  lifecycle (preemption, ``discover_resume``) run with ``jax`` and
  ``tpu_als`` unimportable; ``tune``, ``evaluate`` and
  ``legacy.ALS.train`` with no device raise without a CUDA device.
- The stream and the live loop: ``train``, ``tune`` and ``evaluate``
  on a ``stream:`` data spec (the byte-range reader, its native interner
  built from the port's own source) run with ``jax`` and ``tpu_als``
  unimportable, and raise without a CUDA device when no device is
  given; ``io.stream``, ``live`` and ``tenancy`` are in the import sweep
  (``pkgutil.walk_packages`` finds every module of the port).
- The two-tower model and the rest of ``train``'s command line
  (``models.two_tower``, ``utils.observe``, ``utils.debug``,
  ``obs.report``, ``obs.explain``): ``tt-train``, ``train --log-file
  --profile-dir --obs-dir`` and ``observe summarize|tail|explain`` run
  with ``jax`` and ``tpu_als`` unimportable, ``obs/explain.py`` runs as
  a file on its own, and ``tt-train`` and ``train --log-file
  --profile-dir`` with no device raise without a CUDA device.
- The serving engine (``serving``, ``plan``, ``obs.tracing``,
  ``serve-bench``) runs with ``jax`` and ``tpu_als`` unimportable;
  ``ServingEngine()`` and ``serve-bench`` with no device raise without a
  CUDA device; on the CPU the engine's exact and merge-ring routes run
  K5's and K8's plain versions and launch nothing.
- Elastic training and the rest of the single-card sharded path
  (``resilience/elastic.py``, ``parallel/a2a.py``, the extended ``plan``
  and ``parallel/serve.py``'s degraded mode): an elastic fit through a
  lost shard, the chunked and all_to_all fits, ``'auto'`` and a
  degraded sharded serve run with ``jax`` and ``tpu_als`` unimportable.
- The measurement tools and the sharding flags (``perf/``,
  ``obs/regress.py``, ``obs/trace.py``'s stage attribution,
  ``observe roofline|attribution|regress``, ``train|recommend
  --devices``) run with ``jax`` and ``tpu_als`` unimportable; the
  subpackages ``core``, ``ops`` and ``resilience`` export the
  reference's names, and importing them loads no kernel library; no
  file of the port carries a TPU v5e constant or the v5e headline time.
- The execution planner (``plan/cache.py``, ``plan/planner.py``,
  ``perf/autotune.py``, ``plan show|warm|tune|clear``) runs with ``jax``
  and ``tpu_als`` unimportable, and an armed fit and recommend bank and
  read back their plan there; ``plan/cache.py`` loads as a file on its
  own with ``torch`` unimportable too (stdlib only); ``tpu_als_torch.plan``
  exports the reference's 24 names; ``plan warm`` and ``plan tune`` with
  no device raise without a CUDA device.
- Multi-process training (``parallel/multihost.py``): the module, a
  one-process ``init_distributed``/``rejoin`` and the CLI's
  ``train --per-host-data`` refusal in one process run with ``jax`` and
  ``tpu_als`` unimportable and create no process group;
  ``torch.distributed`` is read through ``sys.modules`` and imported
  only where a group is created (``init_distributed``); the CLI under
  ``--per-host-data`` across two processes is driven with ``jax``
  blocked by ``tests/test_torch_multihost.py``.  The fault points are
  now the reference's eleven.
- The analysis layer (``analysis/lint.py``, ``analysis/vocab.py``,
  ``analysis/contracts.py``, ``parallel/comm_audit.py``, ``lint``): the
  linter and the vocabulary engine, three contracts and the audit run
  with ``jax`` and ``tpu_als`` unimportable; ``lint.py`` and
  ``vocab.py`` load as files with ``torch`` unimportable too (stdlib
  only); in one process no collective crosses anything, so the audit
  counts nothing.
- The scenarios and the soak (``scenario/``, ``soak/``, ``scenario
  run|list``, ``soak``): a toy scenario, torn-publish, the traffic model,
  the chaos schedule and ``scenario list`` run with ``jax`` and
  ``tpu_als`` unimportable; ``soak/verdict.py`` and ``scenario/spec.py``
  load as files with ``torch``, ``numpy`` and the package unimportable
  too (stdlib only); ``run_scenario``, ``run_soak``, ``bank_result``,
  ``scenario run`` and ``soak`` with no device raise without a CUDA
  device, and ``scenario list`` runs without one, touching no device.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpu_als_torch
from tpu_als_torch.ops import cuda_gather_ne, cuda_lanes, cuda_solve
from tpu_als_torch import _build
from tpu_als_torch.ops import cuda_lanes_blocked, cuda_topk
from tpu_als_torch.parallel import data as pdata
from tpu_als_torch.parallel import mesh as pmesh
from tpu_als_torch.parallel import trainer as ptrainer
from tpu_als_torch.parallel.comm import shard_csr_grid
from tpu_als_torch.parallel.serve import topk_sharded
from tpu_als_torch.utils.platform import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = {"userCol": "user", "itemCol": "item", "ratingCol": "rating",
          "predictionCol": "prediction", "coldStartStrategy": "nan",
          "blockSize": 4096, "regParam": 0.1}

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["tpu_als"] = None
import tpu_als_torch
names = [m.name for m in pkgutil.walk_packages(tpu_als_torch.__path__,
                                               "tpu_als_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m, v in sys.modules.items() if v is not None
       and (m == "jax" or m.startswith(("jax.", "tpu_als.")))]
assert not bad, bad
print(len(names), "modules")
"""

_DRIVE_NEW_MODULES = r"""
import os, sys
sys.modules["jax"] = None
sys.modules["tpu_als"] = None
import numpy as np, torch
from tpu_als_torch import _build, obs
from tpu_als_torch.core.ratings import build_csr_buckets
from tpu_als_torch.io import fastbucket, fastcsv, movielens
from tpu_als_torch.ops.solve import solve_spd_checked
from tpu_als_torch.resilience import faults, guardrails
rng = np.random.default_rng(0)
u, i = rng.integers(0, 50, 4000), rng.integers(0, 30, 4000)
r = rng.uniform(0.5, 5, 4000).astype(np.float32)
a = build_csr_buckets(u, i, r, 50, native=True)
b = build_csr_buckets(u, i, r, 50, native=False)
assert all(np.array_equal(x, y) for p, q in zip(a.buckets, b.buckets)
           for x, y in zip(p, q))
path = sys.argv[1]
with open(path, "w") as f:
    f.write("userId,movieId,rating,timestamp\n1,2,3.5,4\n5,6,1,7\n")
assert movielens.load_movielens_csv(path)["rating"].tolist() == [3.5, 1.0]
A = torch.eye(4).repeat(3, 1, 1)
assert solve_spd_checked(A, torch.ones(3, 4), torch.ones(3)).shape == (3, 4)
faults.install("solve.gram=corrupt@nth=1")
with guardrails.scoped("recover"):
    assert faults.check("solve.gram") == "corrupt"
assert obs.events("fault_injected")
# the libraries loaded are the port's, built into its own directory
for lib in (fastbucket._lib, fastcsv._lib):
    assert os.path.dirname(lib._name) == _build.BUILD_DIR, lib._name
bad = [m for m, v in sys.modules.items() if v is not None
       and (m == "jax" or m.startswith(("jax.", "tpu_als.")))]
assert not bad, bad
print("ok")
"""


def _env():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def test_port_imports_without_jax_or_the_reference():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 70


def test_input_path_and_guardrails_run_without_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", _DRIVE_NEW_MODULES,
                          str(tmp_path / "ratings.csv")], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _model(device="cpu"):
    rng = np.random.default_rng(0)
    return tpu_als_torch.model_from_arrays(
        4, np.arange(5), rng.normal(size=(5, 4)), np.arange(7),
        rng.normal(size=(7, 4)), PARAMS, device=device)


def test_entry_points_without_cuda_raise(tmp_path, monkeypatch):
    path = str(tmp_path / "m")
    _model().save(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpu_als_torch.ALSModel.load(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _model(device=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpu_als_torch.ALS(rank=2, maxIter=1).fit(_ratings())
    assert tpu_als_torch.ALSModel.load(path, device="cpu").device.type \
        == "cpu"


def _ratings():
    rng = np.random.default_rng(3)
    return {"user": rng.integers(0, 12, 150), "item": rng.integers(0, 9, 150),
            "rating": (rng.integers(1, 11, 150) * 0.5).astype(np.float32)}


def _launches():
    return (cuda_lanes.LAUNCHES, cuda_topk.LAUNCHES, cuda_solve.LAUNCHES,
            cuda_gather_ne.GRAM_LAUNCHES, cuda_gather_ne.SOLVE_LAUNCHES,
            cuda_lanes_blocked.LAUNCHES)


def test_wrappers_on_cpu_run_plain_versions_without_launching():
    cuda_lanes.LAUNCHES = cuda_topk.LAUNCHES = cuda_solve.LAUNCHES = 0
    cuda_gather_ne.GRAM_LAUNCHES = cuda_gather_ne.SOLVE_LAUNCHES = 0
    cuda_lanes_blocked.LAUNCHES = 0
    rng = np.random.default_rng(1)
    M = rng.normal(size=(6, 5, 5)).astype(np.float32)
    A = torch.from_numpy(M @ M.transpose(0, 2, 1) + np.eye(5,
                                                            dtype=np.float32))
    b = torch.from_numpy(rng.normal(size=(6, 5)).astype(np.float32))
    np.testing.assert_array_equal(cuda_lanes.spd_solve_lanes(A, b).numpy(),
                                  cuda_lanes.chol_solve_plain(A, b).numpy())
    m = _model()
    srv = tpu_als_torch.FoldInServer(m)
    srv.update({"user": np.array([0, 9]), "item": np.array([1, 2]),
                "rating": np.array([3.0, 4.0])})
    m.recommendForAllUsers(3)
    m.recommend_arrays(3)
    np.testing.assert_array_equal(
        cuda_solve.spd_solve_blocked(A, b).numpy(),
        cuda_lanes.chol_solve_plain(A, b).numpy())
    V = torch.from_numpy(rng.normal(size=(20, 5)).astype(np.float32))
    cols = torch.from_numpy(rng.integers(0, 20, (4, 8)).astype(np.int32))
    w = torch.ones(4, 8)
    S, bb = cuda_gather_ne.gather_gram(V, cols, w, w, two_sided=True)
    Sp, bp = cuda_gather_ne.gather_gram_plain(V, cols, w, w, two_sided=True)
    assert torch.equal(S, Sp) and torch.equal(bb, bp)
    x = cuda_gather_ne.gather_solve(V, cols, w, w, w, two_sided=True,
                                    reg=0.1)
    assert torch.equal(x, cuda_gather_ne.gather_solve_plain(
        V, cols, w, w, w, two_sided=True, reg=0.1))
    L = cuda_lanes_blocked.chol_lanes_blocked(A.clone())
    assert torch.equal(L, cuda_lanes_blocked.chol_lanes_blocked_plain(
        A.clone()))
    assert torch.equal(
        cuda_lanes_blocked.spd_solve_lanes_blocked(A.clone(), b),
        cuda_lanes_blocked.chol_lanes_blocked_solve_plain(A.clone(), b))
    model = tpu_als_torch.ALS(rank=4, maxIter=2, implicitPrefs=True,
                              device="cpu").fit(_ratings())
    assert torch.isfinite(model._U).all()
    # above rank 128 the CPU fit and fold-in take K6's plain version
    wide = tpu_als_torch.ALS(rank=136, maxIter=1, implicitPrefs=True,
                             device="cpu").fit(_ratings())
    tpu_als_torch.FoldInServer(wide).update(
        {"user": np.array([0, 99]), "item": np.array([1, 2]),
         "rating": np.array([3.0, 4.0])})
    assert torch.isfinite(wide._U).all()
    assert _launches() == (0, 0, 0, 0, 0, 0)


def test_tf32_is_off_on_every_entry_point():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    _model()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_cuda_or_without_the_repo(tmp_path,
                                                           alone):
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    else:
        cwd = REPO
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, whatever the host has
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_mesh_over_two_cards_raises(monkeypatch):
    with pytest.raises(NotImplementedError, match="peer-mapped"):
        pmesh.make_mesh(devices=["cuda:0", "cuda:1"])
    with pytest.raises(NotImplementedError, match="peer-mapped"):
        pmesh.make_mesh(devices=["cpu", "cuda:0"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="peer-mapped"):
        pmesh.make_mesh(2)
    with pytest.raises(ValueError, match="silently smaller"):
        pmesh.make_mesh(3)
    mesh = pmesh.make_mesh(devices=["cuda:0"] * 4)
    assert mesh.size == 4 and mesh.device == torch.device("cuda:0")


def _sharded_problem(S=3):
    u, i, r = _ratings()["user"], _ratings()["item"], _ratings()["rating"]
    up = pdata.partition_balanced(np.bincount(u, minlength=12), S)
    ip = pdata.partition_balanced(np.bincount(i, minlength=9), S)
    return u, i, r, up, ip


@pytest.mark.parametrize("strategy", ["all_gather_chunked", "all_to_all",
                                      "auto"])
def test_strategies_not_ported_raise(strategy):
    """Once these raised ``NotImplementedError``; now ported:
    ``train_sharded`` runs 'all_gather_chunked' and 'all_to_all' (also
    with ``elastic=True``) to 'all_gather''s factors within 1e-4, and
    refuses 'auto' with the reference's ``ValueError`` (the estimator
    resolves it); ``ALS(mesh=, gatherStrategy=)`` takes all three."""
    from tpu_als_torch.parallel.a2a import build_a2a

    u, i, r, up, ip = _sharded_problem()
    cfg = tpu_als_torch.core.als.AlsConfig(rank=2, max_iter=1)
    mesh = pmesh.make_mesh(devices=["cpu"] * 3)
    us, is_ = pdata.shard_csr(up, ip, u, i, r), pdata.shard_csr(ip, up, i, u,
                                                                r)
    want = ptrainer.train_sharded(mesh, up, ip, us, is_, cfg)
    if strategy == "auto":
        with pytest.raises(ValueError, match="unknown gather strategy 'auto'"):
            ptrainer.train_sharded(mesh, up, ip, us, is_, cfg,
                                   strategy=strategy)
    else:
        if strategy == "all_to_all":
            with pytest.warns(UserWarning, match="request budget"):
                us = build_a2a(up, ip, u, i, r)
                is_ = build_a2a(ip, up, i, u, r)
        for elastic in (False, True):
            got = ptrainer.train_sharded(mesh, up, ip, us, is_, cfg,
                                         strategy=strategy, elastic=elastic)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    assert tpu_als_torch.ALS(mesh=mesh, gatherStrategy=strategy).mesh is mesh
    with pytest.raises(ValueError, match="unknown gather strategy"):
        ptrainer.train_sharded(mesh, up, ip, us, is_, cfg, strategy="bogus")


def test_sharded_path_on_cpu_takes_plain_versions_without_launching():
    cuda_gather_ne.RING_LAUNCHES = cuda_topk.MERGE_LAUNCHES = 0
    u, i, r, up, ip = _sharded_problem()
    mesh = pmesh.make_mesh(devices=["cpu"] * 3)
    cfg = tpu_als_torch.core.als.AlsConfig(
        rank=4, max_iter=2, implicit_prefs=True,
        solve_backend="gather_fused_ring")
    counts = (ptrainer.stacked_counts(up, u, r, positive_only=True),
              ptrainer.stacked_counts(ip, i, r, positive_only=True))
    U, V = ptrainer.train_sharded(mesh, up, ip, shard_csr_grid(up, ip, u, i,
                                                               r),
                                  shard_csr_grid(ip, up, i, u, r), cfg,
                                  strategy="ring", ring_counts=counts)
    s, ix = topk_sharded(U, V, 3, mesh, strategy="merge_ring")
    assert torch.isfinite(U).all() and torch.isfinite(s).all()
    assert cuda_gather_ne.RING_LAUNCHES == cuda_topk.MERGE_LAUNCHES == 0


def test_ring_kernel_wrappers_raise_rather_than_run_plain(monkeypatch,
                                                          tmp_path):
    """K7 and K8 on a tensor that is not on the CPU: the kernel or an
    error.  A 'meta' tensor is refused by the device check; with that
    check waved through, a build without nvcc raises from ``_build`` —
    neither ever reaches a plain version."""
    S, per, r, n, w = 2, 5, 4, 3, 4
    meta = dict(device="meta")
    V = torch.empty(S, per, r, **meta)
    cols = torch.empty(S, S, n, w, dtype=torch.int32, **meta)
    wts = torch.empty(S, S, n, w, **meta)
    U = torch.empty(n, r, **meta)
    valid = torch.empty(S, per, dtype=torch.bool, **meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_gather_ne.gather_solve_ring(V, cols, wts, wts, wts,
                                         two_sided=True, reg=0.1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_topk.topk_merge_ring(U, V, valid, 2)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))  # nothing built
    monkeypatch.setattr(cuda_gather_ne, "_cuda_ready", lambda *a: None)
    monkeypatch.setattr(cuda_gather_ne, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    before = cuda_gather_ne.RING_LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_gather_ne.gather_solve_ring(V, cols, wts, wts, wts,
                                         two_sided=True, reg=0.1)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("topk_merge_ring")
    assert cuda_gather_ne.RING_LAUNCHES == before


_DRIVE_PEER = r"""
import sys
sys.modules["jax"] = None
sys.modules["tpu_als"] = None
import torch
from tpu_als_torch import _build
from tpu_als_torch.parallel import peer
try:
    peer.PeerBuffer(64, "cpu")
    raise AssertionError("a peer buffer on the CPU")
except ValueError as e:
    assert "CUDA device" in str(e), e
assert peer.OPEN == {"mapped": 0, "exported": 0}, peer.OPEN
assert not _build._LIBS, _build._LIBS  # importing loads no library
bad = [m for m, v in sys.modules.items() if v is not None
       and (m == "jax" or m.startswith(("jax.", "tpu_als.")))]
assert not bad, bad
print("ok")
"""


def test_peer_transport_imports_without_jax_or_the_reference():
    """``parallel/peer.py``, the CUDA IPC transport of K7 and K8 across
    processes, imports with ``jax`` and ``tpu_als`` unimportable, loads
    no kernel library when imported, and refuses a buffer off the
    card."""
    out = subprocess.run([sys.executable, "-c", _DRIVE_PEER], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


_DRIVE_USER_SURFACE = r"""
import os, sys
sys.modules["jax"] = None
sys.modules["tpu_als"] = None
import numpy as np
import tpu_als_torch as t
from tpu_als_torch.api import legacy
from tpu_als_torch.cli import main
from tpu_als_torch.io.checkpoint import discover_resume
from tpu_als_torch.resilience import preempt
rng = np.random.default_rng(0)
n = 600
frame = {"u": np.array([f"u{k}" for k in rng.integers(0, 40, n)], object),
         "i": np.array([f"i{k}" for k in rng.integers(0, 20, n)], object),
         "rating": rng.uniform(1, 5, n).astype(np.float32)}
als = t.ALS(userCol="uid", itemCol="iid", rank=2, maxIter=2,
            coldStartStrategy="drop", device="cpu")
pipe = t.Pipeline(stages=[
    t.StringIndexer(inputCol="u", outputCol="uid", handleInvalid="skip"),
    t.StringIndexer(inputCol="i", outputCol="iid", handleInvalid="skip"),
    als])
grid = t.ParamGridBuilder().addGrid(als.regParam, [0.01, 1.0]).build()
for tuner in (t.CrossValidator(numFolds=2, seed=1, estimator=pipe,
                               estimatorParamMaps=grid,
                               evaluator=t.RegressionEvaluator(labelCol="rating")),
              t.TrainValidationSplit(seed=1, estimator=pipe,
                                     estimatorParamMaps=grid,
                                     evaluator=t.RegressionEvaluator(labelCol="rating"))):
    m = tuner.fit(frame)
    m.save(os.path.join(sys.argv[1], type(m).__name__))
back = t.PipelineModel.load(os.path.join(sys.argv[1], "CrossValidatorModel",
                                         "bestModel"), device="cpu")
assert len(back.transform(frame)) == n
mf = legacy.ALS.train([(0, 1, 3.0), (1, 2, 4.0), (2, 1, 1.0)], rank=2,
                      iterations=2, device="cpu")
assert len(mf.recommendProducts(0, 2)) == 2
assert t.RankingMetrics([([1, 2], [2])]).precisionAt(1) == 0.0
ck = os.path.join(sys.argv[1], "ck")
os.environ[preempt.ENV_PREEMPT_AT] = "2"
try:
    main(["train", "--data", "synthetic:60x30x900", "--rank", "2",
          "--max-iter", "3", "--device", "cpu", "--checkpoint-dir", ck])
    raise AssertionError("not preempted")
except SystemExit as e:
    assert e.code == preempt.EXIT_PREEMPTED, e.code
del os.environ[preempt.ENV_PREEMPT_AT]
assert discover_resume(ck).endswith("als_checkpoint")
bad = [m for m, v in sys.modules.items() if v is not None
       and (m == "jax" or m.startswith(("jax.", "tpu_als.")))]
assert not bad, bad
print("ok")
"""


def test_user_surface_and_checkpoint_lifecycle_run_without_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", _DRIVE_USER_SURFACE,
                          str(tmp_path)], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_user_surface_without_cuda_raises(tmp_path, monkeypatch):
    """``tune``, ``evaluate`` and ``legacy.ALS.train`` with no device
    given raise without a CUDA device instead of running on the CPU."""
    from tpu_als_torch.api import legacy
    from tpu_als_torch.cli import main

    path = str(tmp_path / "m")
    _model().save(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["tune", "--data", "synthetic:40x20x400", "--ranks", "2",
              "--reg-params", "0.1", "--folds", "2", "--max-iter", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["evaluate", "--model", path, "--data",
              "synthetic:40x20x400"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        legacy.ALS.train([(0, 1, 3.0), (1, 2, 4.0)], rank=2, iterations=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        legacy.ALS.trainImplicit([(0, 1, 3.0), (1, 2, 4.0)], rank=2,
                                 iterations=1)


_DRIVE_STREAM_SPEC = r"""
import json, os, sys
sys.modules["jax"] = None
sys.modules["tpu_als"] = None
import numpy as np
from tpu_als_torch.cli import main
from tpu_als_torch.io import stream
from tpu_als_torch import _build
tmp, cmd = sys.argv[1], sys.argv[2]
data = os.path.join(tmp, "ratings.csv")
# not seed 0: the CV folds draw from default_rng(0) too, and the same
# stream would put each user in one fold
rng = np.random.default_rng(11)
with open(data, "w") as f:
    f.write("user_id,parent_asin,rating,timestamp\n")
    for u, i, r in zip(rng.integers(0, 40, 900), rng.integers(0, 25, 900),
                       rng.integers(1, 11, 900) * 0.5):
        f.write(f"user-{u},item-{i},{r},1\n")
spec = "stream:" + data
model = os.path.join(tmp, "m")
if cmd == "tune":
    main(["tune", "--data", spec, "--ranks", "2", "--reg-params", "0.1",
          "--folds", "2", "--max-iter", "2", "--device", "cpu",
          "--output", model])
    model = os.path.join(model, "bestModel")
else:
    main(["train", "--data", spec, "--rank", "2", "--max-iter", "2",
          "--device", "cpu", "--output", model])
side = np.load(os.path.join(os.path.dirname(model) if cmd == "tune"
                            else model, "stream_labels.npz"))
assert side["users"][0] == b"user-0" and len(side["items"]) == 25
if cmd == "evaluate":
    main(["evaluate", "--model", model, "--data", spec, "--device", "cpu"])
assert os.path.dirname(stream._lib._name) == _build.BUILD_DIR
bad = [m for m, v in sys.modules.items() if v is not None
       and (m == "jax" or m.startswith(("jax.", "tpu_als.")))]
assert not bad, bad
print("ok")
"""


@pytest.mark.parametrize("cmd", [
    ["train"], ["tune", "--device", "cpu"],
    ["evaluate", "--model", "unused", "--device", "cpu"]])
def test_stream_data_spec_is_not_ported(cmd, tmp_path, monkeypatch):
    """Each command that once refused ``stream:``: now ported, run on the
    CPU with ``jax`` and ``tpu_als`` unimportable (``train`` and ``tune``
    write the ``stream_labels.npz`` sidecar, ``evaluate`` reads it); with
    no ``--device`` each raises without a CUDA device."""
    from tpu_als_torch.cli import main

    out = subprocess.run([sys.executable, "-c", _DRIVE_STREAM_SPEC,
                          str(tmp_path), cmd[0]], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
    if cmd[0] == "evaluate":
        assert json.loads(out.stdout.strip().splitlines()[-2])["rmse"] > 0
    data = tmp_path / "ratings.csv"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bare = {"train": ["train"],
            "tune": ["tune", "--ranks", "2", "--folds", "2"],
            "evaluate": ["evaluate", "--model", str(tmp_path / "m")]}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(bare[cmd[0]] + ["--data", f"stream:{data}"])


_DRIVE_SERVING = r"""
import sys
sys.modules["jax"] = None
sys.modules["tpu_als"] = None
import numpy as np
from tpu_als_torch import obs, plan
from tpu_als_torch.cli import main
from tpu_als_torch.obs import tracing
from tpu_als_torch.parallel.mesh import make_mesh
from tpu_als_torch.serving import ServingEngine
rng = np.random.default_rng(0)
U = rng.normal(size=(20, 4)).astype(np.float32)
V = rng.normal(size=(90, 4)).astype(np.float32)
assert plan.resolve_serving_buckets() == (8, 32, 128)
with tracing.traced():
    for kw in ({"device": "cpu"},
               {"mesh": make_mesh(devices=["cpu"] * 3)}):
        eng = ServingEngine(k=3, shortlist_k=16, **kw)
        eng.publish(U, V)
        eng.warmup()
        with eng:
            s, ix = eng.recommend(2, timeout=10.0)
        assert s.shape == (3,)
assert obs.events("trace_span")
main(["serve-bench", "--users", "30", "--items", "90", "--rank", "4",
      "--qps", "200", "--duration", "0.1", "--device", "cpu"])
bad = [m for m, v in sys.modules.items() if v is not None
       and (m == "jax" or m.startswith(("jax.", "tpu_als.")))]
assert not bad, bad
print("ok")
"""


def test_serving_engine_runs_without_jax():
    out = subprocess.run([sys.executable, "-c", _DRIVE_SERVING], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


_DRIVE_ELASTIC = r"""
import sys, tempfile
sys.modules["jax"] = None
sys.modules["tpu_als"] = None
import numpy as np
import tpu_als_torch
from tpu_als_torch import obs, plan
from tpu_als_torch.parallel import serve
from tpu_als_torch.parallel.mesh import make_mesh
from tpu_als_torch.resilience import elastic, faults
rng = np.random.default_rng(0)
frame = {"user": rng.integers(0, 40, 400), "item": rng.integers(0, 30, 400),
         "rating": rng.uniform(1, 5, 400).astype(np.float32)}
faults.install("mesh.device_lost=corrupt@nth=2")
est = tpu_als_torch.ALS(mesh=make_mesh(devices=["cpu"] * 3), elastic=True,
                        rank=3, maxIter=3, checkpointDir=tempfile.mkdtemp(),
                        checkpointInterval=1)
m = est.fit(frame)
assert [e["type"] for e in obs.events() if e["type"] in (
    "device_lost", "mesh_reformed", "elastic_resume")] == [
    "device_lost", "mesh_reformed", "elastic_resume"]
faults.clear()
elastic.clear_lost()
for strategy in ("all_gather_chunked", "all_to_all", "auto"):
    est = tpu_als_torch.ALS(mesh=make_mesh(devices=["cpu"] * 3),
                            gatherStrategy=strategy, rank=3, maxIter=2)
    est.fit(frame)
    assert est.lastFitStrategy in plan.GATHER_CANDIDATES + ("all_to_all",)
mesh = make_mesh(devices=["cpu"] * 3)
serve.topk_sharded(m._U, m._V, 4, mesh)
faults.install("serve.gather=raise@once")
s, ix, info = serve.topk_sharded(m._U, m._V, 4, mesh, return_info=True)
assert info["degraded"] and obs.counter_value("serve.degraded") == 1
bad = [k for k, v in sys.modules.items() if v is not None
       and (k == "jax" or k.startswith(("jax.", "tpu_als.")))]
assert not bad, bad
print("ok")
"""


def test_elastic_strategies_and_degraded_serve_run_without_jax():
    out = subprocess.run([sys.executable, "-W", "ignore", "-c",
                          _DRIVE_ELASTIC], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_serving_without_cuda_raises(monkeypatch):
    from tpu_als_torch.cli import main
    from tpu_als_torch.serving import ServingEngine, build_index

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_index(np.ones((5, 3), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["serve-bench", "--users", "10", "--items", "20", "--rank",
              "2", "--duration", "0.01"])


@pytest.mark.parametrize("backend", ["exact", "merge_ring"])
def test_engine_routes_on_cpu_take_plain_versions_without_launching(
        backend):
    from tpu_als_torch.serving import ServingEngine

    cuda_topk.LAUNCHES = cuda_topk.MERGE_LAUNCHES = 0
    rng = np.random.default_rng(4)
    U = rng.normal(size=(12, 4)).astype(np.float32)
    V = rng.normal(size=(50, 4)).astype(np.float32)
    if backend == "exact":
        eng = ServingEngine(k=3, buckets=(8,), device="cpu")
        eng.publish(U, V, quantize=False)
    else:
        eng = ServingEngine(k=3, buckets=(8,),
                            mesh=pmesh.make_mesh(devices=["cpu"] * 3))
        eng.publish(U, V)
    t = eng.submit(5)
    eng.serve_batch(eng.batcher.next_batch(timeout=1.0))
    s, ix = t.result(timeout=1.0)
    ref = U[5].astype(np.float64) @ V.astype(np.float64).T
    np.testing.assert_allclose(s, np.sort(ref)[::-1][:3], rtol=1e-5)
    np.testing.assert_array_equal(ix, np.argsort(-ref)[:3])
    assert cuda_topk.LAUNCHES == cuda_topk.MERGE_LAUNCHES == 0


_DRIVE_TWO_TOWER = r"""
import json, os, subprocess, sys
sys.modules["jax"] = None
sys.modules["tpu_als"] = None
import numpy as np, torch
from tpu_als_torch.cli import main
from tpu_als_torch.models import two_tower
from tpu_als_torch.utils import debug, observe
tmp = sys.argv[1]
main(["tt-train", "--data", "synthetic:120x60x3000", "--epochs", "1",
      "--als-rank", "4", "--als-iters", "1", "--embed-dim", "8",
      "--device", "cpu", "--output", os.path.join(tmp, "tt")])
m, cfg, nu, ni = two_tower.load_two_tower(os.path.join(tmp, "tt"),
                                          device="cpu")
assert m.user_embed.shape == (nu, 8)
run = os.path.join(tmp, "obs")
main(["train", "--data", "synthetic:60x30x900", "--rank", "2",
      "--max-iter", "2", "--device", "cpu", "--log-file",
      os.path.join(tmp, "log.jsonl"), "--profile-dir",
      os.path.join(tmp, "prof"), "--obs-dir", run])
assert len(open(os.path.join(tmp, "log.jsonl")).readlines()) == 2
assert os.listdir(os.path.join(tmp, "prof"))
main(["observe", "summarize", run, "--json"])
main(["observe", "tail", run, "-n", "2"])
main(["observe", "explain", run])
with debug.debug_mode():
    debug.assert_all_finite(1, torch.ones(2, 2), np.ones((2, 2)))
out = subprocess.run([sys.executable, "tpu_als_torch/obs/explain.py", run],
                     capture_output=True, text=True)
assert out.returncode == 0 and "no trace_span events" in out.stdout, out
bad = [m for m, v in sys.modules.items() if v is not None
       and (m == "jax" or m.startswith(("jax.", "tpu_als.")))]
assert not bad, bad
print("ok")
"""


def test_two_tower_and_train_observability_run_without_jax(tmp_path,
                                                           monkeypatch):
    from tpu_als_torch.cli import main

    out = subprocess.run([sys.executable, "-c", _DRIVE_TWO_TOWER,
                          str(tmp_path)], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["tt-train", "--data", "synthetic:40x20x400", "--cold"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["train", "--data", "synthetic:40x20x400", "--max-iter", "1",
              "--log-file", str(tmp_path / "l.jsonl"), "--profile-dir",
              str(tmp_path / "p")])
    from tpu_als_torch.models import two_tower

    with pytest.raises(RuntimeError, match="device='cpu'"):
        two_tower.train_two_tower(np.arange(4), np.arange(4), 4, 4)


_DRIVE_MEASUREMENT = r"""
import json, os, sys
sys.modules["jax"] = None
sys.modules["tpu_als"] = None
import tpu_als_torch.core, tpu_als_torch.ops, tpu_als_torch.resilience
from tpu_als_torch import _build
assert not _build._LIBS, _build._LIBS
names = {m: sorted(n for n in dir(sys.modules["tpu_als_torch." + m])
                   if not n.startswith("_"))
         for m in ("core", "ops", "resilience")}
from tpu_als_torch.cli import main
tmp = sys.argv[1]
main(["train", "--data", "synthetic:40x20x300", "--rank", "3",
      "--max-iter", "1", "--device", "cpu", "--devices", "3",
      "--gather-strategy", "all_gather", "--elastic", "--output",
      os.path.join(tmp, "m")])
main(["recommend", "--model", os.path.join(tmp, "m"), "--device", "cpu",
      "--devices", "3", "--gather-strategy", "ring", "--limit", "2"])
main(["observe", "roofline", "--json"])
main(["observe", "regress", tmp, "--json"])
rep = main(["observe", "attribution", "--data", "synthetic:40x20x300",
            "--rank", "3", "--iters", "1", "--device", "cpu", "--json"])
assert rep["coverage"] > 0
from tpu_als_torch.perf.ne_audit import gather_out_bytes, kernel_cost_bytes
bad = [k for k, v in sys.modules.items() if v is not None
       and (k == "jax" or k.startswith(("jax.", "tpu_als.")))]
assert not bad, bad
print(json.dumps(names))
"""


def test_measurement_tools_and_flags_run_without_jax(tmp_path):
    # one intra-op thread: tiny tensors, beside the suite's workers
    out = subprocess.run([sys.executable, "-W", "ignore", "-c",
                          _DRIVE_MEASUREMENT, str(tmp_path)], cwd=REPO,
                         env={**_env(), "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"AlsConfig", "train", "predict", "fold_in", "build_csr_buckets",
            "remap_ids", "IdMap", "Bucket", "CsrBuckets"} <= set(
        names["core"])
    assert {"solve_spd", "solve_nnls", "normal_eq_explicit",
            "normal_eq_implicit", "compute_yty",
            "chunked_topk_scores"} <= set(names["ops"])


_DRIVE_PLAN = r"""
import importlib.util, json, os, sys, tempfile
sys.modules["jax"] = None
sys.modules["tpu_als"] = None
os.environ["TPU_ALS_PLAN_CACHE"] = tempfile.mkdtemp()
import numpy as np
import tpu_als_torch
from tpu_als_torch import obs, plan
from tpu_als_torch.cli import main
from tpu_als_torch.perf import autotune
rng = np.random.default_rng(0)
frame = {"user": rng.integers(0, 40, 400), "item": rng.integers(0, 30, 400),
         "rating": rng.uniform(1, 5, 400).astype(np.float32)}
for _ in range(2):
    m = tpu_als_torch.ALS(rank=3, maxIter=2, device="cpu").fit(frame)
    m.recommend_arrays(4)
hits = [e["component"] for e in obs.events("plan_cache_hit")]
assert len(hits) == 2 and hits[1] == "topk:k=4", hits
main(["plan", "warm", "--rank", "3", "--k", "4", "--device", "cpu"])
main(["plan", "tune", "--rank", "3", "--device", "cpu", "--n", "16",
      "--w", "4", "--max-w", "32", "--reps", "1"])
main(["plan", "show"])
main(["plan", "clear"])
assert len(obs.events("tune_trial")) == len(autotune.enumerate_configs())
bad = [k for k, v in sys.modules.items() if v is not None
       and (k == "jax" or k.startswith(("jax.", "tpu_als.")))]
assert not bad, bad
print("ok")
"""

_DRIVE_PLAN_CACHE = r"""
import importlib.util, os, sys, tempfile
sys.modules["torch"] = None
sys.modules["numpy"] = None
sys.modules["jax"] = None
spec = importlib.util.spec_from_file_location("plan_cache", sys.argv[1])
cache = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cache)
root = tempfile.mkdtemp()
key = {"rank": 4, "dtype": "float32", "torch_version": cache._torch_version()}
cache.store_entry(key, {"schema_version": 1, "plan_key": key, "probes": {},
                        "components": {"x": {"resolved": 1, "provenance": {
                            "banked_at": "now"}}}}, root)
assert cache.suggested_probe_budget(600, root)[0] == 120.0
assert cache.clear(root) == 1
print("ok")
"""


def test_planner_runs_without_jax():
    out = subprocess.run([sys.executable, "-W", "ignore", "-c",
                          _DRIVE_PLAN], cwd=REPO,
                         env={**_env(), "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_plan_cache_is_stdlib_only():
    path = os.path.join(REPO, "tpu_als_torch", "plan", "cache.py")
    out = subprocess.run([sys.executable, "-c", _DRIVE_PLAN_CACHE, path],
                         cwd=REPO, env=_env(), capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_plan_exports_the_references_names():
    from tpu_als import plan as jplan
    from tpu_als_torch import plan as tplan

    want = [n for n in vars(jplan) if not n.startswith("_")
            and not isinstance(getattr(jplan, n), type(sys))]
    assert len(want) == 24
    assert not [n for n in want if not hasattr(tplan, n)]


@pytest.mark.parametrize("verb", ["warm", "tune"])
def test_plan_verbs_without_cuda_raise(verb, monkeypatch, tmp_path):
    from tpu_als_torch.cli import main

    monkeypatch.setenv("TPU_ALS_PLAN_CACHE", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["plan", verb, "--rank", "4"])


def test_subpackages_export_the_references_names():
    import importlib

    for sub in ("core", "ops", "resilience"):
        ref = importlib.import_module("tpu_als." + sub)
        port = importlib.import_module("tpu_als_torch." + sub)
        want = getattr(ref, "__all__", None) or [
            n for n, v in vars(ref).items() if not n.startswith("_")
            and not isinstance(v, type(sys)) and getattr(
                v, "__module__", "").startswith("tpu_als.")]
        missing = [n for n in want if not hasattr(port, n)]
        assert not missing, (sub, missing)
        for n in want:
            if hasattr(getattr(ref, n), "__qualname__"):   # classes, defs
                assert getattr(port, n).__qualname__ == \
                    getattr(ref, n).__qualname__
    from tpu_als import resilience as jres
    from tpu_als_torch import resilience as tres

    assert tres.__all__ == jres.__all__
    assert tres.FAULT_SPEC_ENV == jres.FAULT_SPEC_ENV
    assert tres.EXIT_PREEMPTED == jres.EXIT_PREEMPTED
    # every point of the reference is wired, multihost.init included
    assert set(tres.FAULT_POINTS) == set(jres.FAULT_POINTS)


_DRIVE_MULTIHOST = r"""
import ast, inspect, sys
sys.modules["jax"] = None
sys.modules["tpu_als"] = None
from tpu_als_torch.parallel import multihost
from tpu_als_torch.parallel.mesh import make_mesh
import torch.distributed as dist
assert multihost.init_distributed() == (0, 1)
assert multihost.rejoin() == (0, 1)
assert not dist.is_initialized() and multihost.ROUTE is None
mesh = make_mesh(devices=["cpu"] * 3)
assert mesh.positions == (0, 1, 2) and mesh.global_size == 3
# torch.distributed is imported only where the group is created
tree = ast.parse(inspect.getsource(multihost))
top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
names = [a.name for n in top for a in n.names] + [
    getattr(n, "module", None) or "" for n in top]
assert not any("distributed" in x for x in names), names
from tpu_als_torch.cli import main
try:
    main(["train", "--data", "synthetic:30x20x200", "--per-host-data",
          "--devices", "0", "--device", "cpu"])
except SystemExit as e:
    assert "multi-process only" in str(e), e
else:
    raise AssertionError("--per-host-data ran in one process")
bad = [m for m, v in sys.modules.items() if v is not None
       and (m == "jax" or m.startswith(("jax.", "tpu_als.")))]
assert not bad, bad
print("ok")
"""


def test_multihost_runs_without_jax():
    out = subprocess.run([sys.executable, "-W", "ignore", "-c",
                          _DRIVE_MULTIHOST], cwd=REPO,
                         env={**_env(), "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_no_tpu_number_in_the_port():
    import re

    pat = re.compile(r"V5E|v5e|\b1\.184\b|\b819(\.0)?\b|197e12|98\.5e12")
    hits = []
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "tpu_als_torch")):
        paths += [os.path.join(root, f) for f in files
                  if f.endswith((".py", ".cu", ".cuh", ".cc"))]
    for path in paths:
        with open(path, encoding="utf-8") as f:
            for k, line in enumerate(f, 1):
                if pat.search(line):
                    hits.append(f"{os.path.relpath(path, REPO)}:{k}")
    assert not hits, hits


_DRIVE_ANALYSIS = r"""
import importlib.util, os, sys
sys.modules["jax"] = None
sys.modules["tpu_als"] = None
import torch
from tpu_als_torch.analysis import contracts
from tpu_als_torch.cli import main
from tpu_als_torch.parallel import comm_audit, multihost
assert main(["lint"]) == 0
for name in ("live_delta_index", "serve_comm_audit", "elastic_disarmed"):
    r = contracts.verify(name, device="cpu")
    assert r.ok, r.detail
x = torch.ones(3, 2)
assert comm_audit.collective_bytes(
    lambda: (multihost.all_gather(x), multihost.all_reduce_sum(x[None]),
             multihost.ppermute(x)), axis_size=4) == (0, {})
bad = [m for m, v in sys.modules.items() if v is not None
       and (m == "jax" or m.startswith(("jax.", "tpu_als.")))]
assert not bad, bad
print("ok")
"""

_DRIVE_LINT_FILES = r"""
import importlib.util, sys
for name in ("torch", "numpy", "jax", "tpu_als", "tpu_als_torch"):
    sys.modules[name] = None
for path in sys.argv[1:]:
    spec = importlib.util.spec_from_file_location("_f", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--paths", path]) == 0
print("ok")
"""


def test_analysis_layer_runs_without_jax():
    out = subprocess.run([sys.executable, "-W", "ignore", "-c",
                          _DRIVE_ANALYSIS], cwd=REPO,
                         env={**_env(), "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_lint_and_vocab_load_as_files_without_torch():
    paths = [os.path.join(REPO, "tpu_als_torch", "analysis", f)
             for f in ("lint.py", "vocab.py")]
    out = subprocess.run([sys.executable, "-c", _DRIVE_LINT_FILES, *paths],
                         cwd=REPO, env=_env(), capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


_DRIVE_SCENARIOS = r"""
import sys
sys.modules["jax"] = None
sys.modules["tpu_als"] = None
import io
from contextlib import redirect_stdout
from tpu_als_torch import cli, scenario
from tpu_als_torch.scenario.spec import Assertion, Phase, ScenarioSpec
from tpu_als_torch.soak import chaos, traffic
toy = ScenarioSpec(name="toy", doc="inline",
                   phases=(Phase("p", lambda c: c.facts.update(x=1)),),
                   assertions=(Assertion("x", "fact", fact="x", op="==",
                                         value=1),))
assert scenario.run_scenario(toy, device="cpu")["passed"]
r = scenario.run_scenario(scenario.get_scenario("torn-publish"),
                          device="cpu")
assert r["passed"], r["assertions"]
assert traffic.stream_bytes(traffic.TrafficConfig(windows=2))
assert "device-loss" in chaos.default_schedule(8).describe()
buf = io.StringIO()
with redirect_stdout(buf):
    cli.main(["scenario", "list"])
assert buf.getvalue().count("\n    ") >= 12
bad = [m for m, v in sys.modules.items() if v is not None
       and (m == "jax" or m.startswith(("jax.", "tpu_als.")))]
assert not bad, bad
print("ok")
"""


def test_scenarios_and_soak_run_without_jax():
    out = subprocess.run([sys.executable, "-W", "ignore", "-c",
                          _DRIVE_SCENARIOS], cwd=REPO,
                         env={**_env(), "OMP_NUM_THREADS": "1",
                              "TPU_ALS_PLAN_CACHE": "off"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


_LOAD_STDLIB_FILES = r"""
import importlib.util, sys
for name in ("torch", "numpy", "jax", "tpu_als", "tpu_als_torch"):
    sys.modules[name] = None
mods = []
for i, path in enumerate(sys.argv[1:]):
    spec = importlib.util.spec_from_file_location(f"_f{i}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod        # dataclasses look it up
    spec.loader.exec_module(mod)
    mods.append(mod)
verdict, spec_mod = mods
assert verdict.judge([])["windows"] == 0
ctx = spec_mod.RunContext(None, {"b": 2}, None, None, device="cpu")
assert spec_mod.resolve_bound("$b", ctx.config) == 2
bad = [m for m, v in sys.modules.items() if v is not None
       and m.split(".")[0] in ("torch", "numpy", "tpu_als_torch")]
assert not bad, bad
print("ok")
"""


def test_verdict_and_spec_load_as_files_without_torch():
    paths = [os.path.join(REPO, "tpu_als_torch", *rel) for rel in
             (("soak", "verdict.py"), ("scenario", "spec.py"))]
    out = subprocess.run([sys.executable, "-c", _LOAD_STDLIB_FILES, *paths],
                         cwd=REPO, env=_env(), capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_scenarios_and_soak_without_cuda_raise(monkeypatch, tmp_path,
                                               capsys):
    from tpu_als_torch import scenario
    from tpu_als_torch.cli import main
    from tpu_als_torch.soak import orchestrator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scenario.run_scenario(scenario.get_scenario("cold-start"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        orchestrator.run_soak()
    result = scenario.run_scenario(scenario.SCENARIOS["torn-publish"],
                                   device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scenario.bank_result(result, str(tmp_path / "b.json"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["scenario", "run", "torn-publish"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["soak", "--windows", "1"])
    capsys.readouterr()
    main(["scenario", "list"])
    assert "production-week" in capsys.readouterr().out
