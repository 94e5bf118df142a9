"""``foldin-bench`` and ``serve-bench`` on the port's command line against
the reference's, in one process (JAX on the CPU, ``--device cpu``).

The JSON lines must carry the reference's keys (nested ``config``
included); the numbers are wall-clock readings of two different
programs, so only their types and ranges are held.  ``serve-bench
--update-qps`` (the live loop) and ``--tenants`` (the multi-tenant
engine) run on the CPU with ``jax`` and ``tpu_als`` unimportable and
print the reference's key set; with no ``--device`` they raise without
a CUDA device.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_als import obs as jobs
from tpu_als.cli import main as jmain
from tpu_als_torch import model_from_arrays
from tpu_als_torch import obs as tobs
from tpu_als_torch.cli import main as tmain

TINY = ["--users", "64", "--items", "300", "--rank", "8", "--k", "5",
        "--shortlist-k", "32", "--qps", "400", "--duration", "0.2",
        "--slo-ms", "5000", "--buckets", "8,32", "--foldin-frac", "0.2"]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("TPU_ALS_PLAN_CACHE", "off")
    jobs.reset()
    tobs.reset()


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def test_foldin_bench_matches_reference_keys(tmp_path, capsys):
    rng = np.random.default_rng(0)
    params = {"userCol": "user", "itemCol": "item", "ratingCol": "rating",
              "predictionCol": "prediction", "coldStartStrategy": "nan",
              "blockSize": 4096, "regParam": 0.05, "rank": 8,
              "implicitPrefs": False, "alpha": 1.0, "nonnegative": False}
    path = str(tmp_path / "m")
    model_from_arrays(8, np.arange(50), rng.normal(size=(50, 8)),
                      np.arange(40), rng.normal(size=(40, 8)), params,
                      device="cpu").save(path)
    args = ["foldin-bench", "--model", path, "--batches", "3",
            "--batch-size", "64"]
    jmain(args)
    ref = _last_json(capsys)
    tmain(args + ["--device", "cpu"])
    got = _last_json(capsys)
    assert _keys(got) == _keys(ref)
    assert got["metric"] == "foldin_p50_latency" and got["value"] > 0
    assert (got["batches"], got["batch_size"]) == (3, 64)


@pytest.mark.parametrize("extra", [
    [], ["--exact"], ["--mesh-devices", "3", "--serve-backend", "sharded"]])
def test_serve_bench_matches_reference_keys(extra, tmp_path, capsys):
    jmain(["serve-bench", *TINY, *extra])
    ref = _last_json(capsys)
    bank = tmp_path / "BENCH_serve_test.json"
    tobs.reset()
    got = tmain(["serve-bench", *TINY, *extra, "--device", "cpu",
                 "--bench-json", str(bank)])
    assert _last_json(capsys) == got
    assert _keys(got) == _keys(ref)
    assert got["config"]["path"] == ("exact" if extra == ["--exact"]
                                     else "int8")
    assert got["scored"] == 80 and got["slo_met"] is True
    assert got["value"] > 0 and 0.0 <= got["shed_rate"] <= 1.0
    banked = json.loads(bank.read_text())
    assert banked["banked_by"] == "tpu_als_torch serve-bench"
    assert banked["banked_at"].endswith("+00:00")
    assert banked["value"] == got["value"]
    if extra[:1] == ["--mesh-devices"]:
        assert got["backend"] == "sharded"


def test_serve_bench_forced_breach_emits_flight_records(capsys):
    got = tmain(["serve-bench", "--users", "100", "--items", "300",
                 "--rank", "4", "--qps", "300", "--duration", "0.1",
                 "--slo-ms", "0.000001", "--buckets", "8",
                 "--device", "cpu"])
    assert got["slo_met"] is False and got["scored"] >= 8
    assert got["flight_records"] >= min(got["scored"], 8)


_SERVE_BENCH_NO_JAX = r"""
import json, sys
sys.modules["jax"] = None
sys.modules["tpu_als"] = None
from tpu_als_torch.cli import main
out = main(sys.argv[1:])
bad = [m for m, v in sys.modules.items() if v is not None
       and (m == "jax" or m.startswith(("jax.", "tpu_als.")))]
assert not bad, bad
"""


@pytest.mark.parametrize("extra", [["--update-qps", "1"],
                                   ["--tenants", "2"]])
def test_serve_bench_live_and_tenants_are_not_ported(extra, capsys,
                                                     monkeypatch):
    """The two variants that once raised ``NotImplementedError``: now
    ported, run here with ``jax`` and ``tpu_als`` unimportable, the
    reference's key set; ``device=None`` raises without CUDA."""
    jmain(["serve-bench", *TINY, *extra])
    ref = _last_json(capsys)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _SERVE_BENCH_NO_JAX, "serve-bench", *TINY,
         *extra, "--device", "cpu"], cwd=repo, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert _keys(got) == _keys(ref)
    assert got["metric"] == ("live_freshness_p99_ms" if extra[0] ==
                             "--update-qps" else "tenancy_worst_p99_ms")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmain(["serve-bench", *TINY, *extra])
