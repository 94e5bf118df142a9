"""``foldin-bench`` and ``serve-bench`` on the port's command line against
the reference's, in one process (JAX on the CPU, ``--device cpu``).

The JSON lines must carry the reference's keys (nested ``config``
included); the numbers are wall-clock readings of two different
programs, so only their types and ranges are held.  ``serve-bench
--update-qps`` and ``--tenants`` raise ``NotImplementedError`` naming
the ROADMAP item that ports them.
"""

import json

import numpy as np
import pytest

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


@pytest.mark.parametrize("extra", [["--update-qps", "1"],
                                   ["--tenants", "2"]])
def test_serve_bench_live_and_tenants_are_not_ported(extra):
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        tmain(["serve-bench", *TINY, *extra, "--device", "cpu"])
