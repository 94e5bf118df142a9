"""The port stands alone and never hides its kernels.

- Every ``tpu_als_torch`` module, and everything ``chip_smoke.py``
  imports, imports with ``jax`` and ``tpu_als`` made unimportable.
- ``device=None`` entry points raise without a CUDA device instead of
  running quietly on the CPU.
- The kernel wrappers (K1-K6) and a CPU ``ALS.fit`` run the plain
  versions on CPU tensors and leave the launch counters at 0; TF32 stays
  off.
- ``chip_smoke.py`` fails, printing no result, without a CUDA device and
  when it stands in a directory without the rest of the repository.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpu_als_torch
from tpu_als_torch.ops import cuda_gather_ne, cuda_lanes, cuda_solve
from tpu_als_torch.ops import cuda_lanes_blocked, cuda_topk
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
