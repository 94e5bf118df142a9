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
  mesh over two cards and the strategies not ported yet raise
  ``NotImplementedError`` naming what is missing.
- ``chip_smoke.py`` fails, printing no result, without a CUDA device and
  when it stands in a directory without the rest of the repository.
"""

import contextlib
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


def _env():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def test_port_imports_without_jax_or_the_reference():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 27


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
        cuda_solve.chol_blocked_plain(A, b).numpy())
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
        cuda_lanes_blocked.substitute(L, b))
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
    u, i, r, up, ip = _sharded_problem()
    us, is_ = pdata.shard_csr(up, ip, u, i, r), pdata.shard_csr(ip, up, i, u,
                                                                r)
    cfg = tpu_als_torch.core.als.AlsConfig(rank=2, max_iter=1)
    mesh = pmesh.make_mesh(devices=["cpu"] * 3)
    with pytest.raises(NotImplementedError, match="slice"):
        ptrainer.train_sharded(mesh, up, ip, us, is_, cfg, strategy=strategy)
    with pytest.raises(NotImplementedError, match="slice"):
        tpu_als_torch.ALS(mesh=mesh, gatherStrategy=strategy)
    with pytest.raises(NotImplementedError, match="resilience"):
        ptrainer.train_sharded(mesh, up, ip, us, is_, cfg, elastic=True)
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
