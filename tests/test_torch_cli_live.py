"""The ``stream:`` data spec and the live/tenancy ``serve-bench`` on the
port's command line against the reference's, in one process (JAX on the
CPU, ``--device cpu``).

- ``train --data stream:`` writes a ``stream_labels.npz`` equal to the
  reference's (labels and dtypes, bit for bit);
- a stream model saved by either package evaluates in the other's
  ``evaluate`` (``stream:`` densified through the model's sidecar) to
  the same JSON within 2e-4 (the metrics are rounded to 4 decimals;
  the two programs sum in different orders);
- ``recommend --foldin-data stream:`` on new string ids gives the
  reference's string ids, scores within 1e-3 (4 decimals, after a
  fold-in that agrees within ``tests/test_torch_foldin.py``'s band);
- ``serve-bench --update-qps`` and ``--tenants`` print the reference's
  key set (their numbers are wall-clock readings of two programs), the
  set ``chip_smoke.py`` holds the card's runs to.
"""

import json

import numpy as np
import pytest

import chip_smoke
from tpu_als import obs as jobs
from tpu_als.cli import main as jmain
from tpu_als_torch import obs as tobs
from tpu_als_torch.cli import main as tmain

TRAIN = ["--rank", "4", "--max-iter", "3", "--reg-param", "0.05",
         "--seed", "3"]
TINY = ["--users", "64", "--items", "300", "--rank", "8", "--k", "5",
        "--shortlist-k", "32", "--qps", "400", "--duration", "0.2",
        "--slo-ms", "5000", "--buckets", "8,32"]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("TPU_ALS_PLAN_CACHE", "off")
    jobs.reset()
    tobs.reset()


def _stream_file(path, n=2400, seed=0, new_users=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 90, n)
    i = rng.integers(0, 60, n)
    r = rng.integers(1, 11, n) * 0.5
    with open(path, "w", encoding="utf-8") as f:
        f.write("user_id,parent_asin,rating,timestamp\n")
        for a, b, c in zip(u, i, r):
            name = f"nouveau-{a % new_users}" if new_users else f"U{a:03d}"
            f.write(f"{name},itém-{b:02d},{c},1700000000\n")
        if new_users:
            f.write("nouveau-0,never-seen,4.0,1700000000\n")
    return str(path)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The same stream file trained by both packages."""
    d = tmp_path_factory.mktemp("stream_cli")
    data = _stream_file(d / "ratings.csv")
    jmain(["train", "--data", f"stream:{data}", *TRAIN, "--output",
           str(d / "jm")])
    tmain(["train", "--data", f"stream:{data}", *TRAIN, "--output",
           str(d / "tm"), "--device", "cpu"])
    return d, data


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_train_writes_the_reference_sidecar(models):
    d, _ = models
    j = np.load(d / "jm" / "stream_labels.npz")
    t = np.load(d / "tm" / "stream_labels.npz")
    assert sorted(t.files) == sorted(j.files) == ["items", "users"]
    for k in ("users", "items"):
        assert t[k].dtype == j[k].dtype
        np.testing.assert_array_equal(t[k], j[k])
    assert t["users"][0] == b"U000" and len(t["items"]) == 60


@pytest.mark.parametrize("model", ["jm", "tm"])
def test_stream_model_evaluates_in_both_packages(models, model, capsys):
    d, data = models
    jmain(["evaluate", "--model", str(d / model), "--data",
           f"stream:{data}", "--ranking-k", "5"])
    ref = _last_json(capsys)
    tmain(["evaluate", "--model", str(d / model), "--data",
           f"stream:{data}", "--ranking-k", "5", "--device", "cpu"])
    got = _last_json(capsys)
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert got[k] == pytest.approx(v, abs=2e-4), k


def test_recommend_foldin_stream_gives_reference_ids(models, tmp_path,
                                                     capsys):
    d, _ = models
    new = _stream_file(tmp_path / "new.csv", n=40, seed=9, new_users=3)
    args = ["recommend", "--model", str(d / "tm"), "--foldin-data",
            f"stream:{new}", "--users", "nouveau-0,U007,nouveau-2",
            "--k", "4"]
    jmain(args)
    ref = [json.loads(x) for x in capsys.readouterr().out.splitlines()
           if x.startswith("{")]
    tmain(args + ["--device", "cpu"])
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines()
           if x.startswith("{")]
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert (g["user"], g["user_id"]) == (r["user"], r["user_id"])
        assert g["item_ids"] == r["item_ids"]
        assert all(x.startswith("itém-") for x in g["item_ids"])
        np.testing.assert_allclose([s for _, s in g["items"]],
                                   [s for _, s in r["items"]], atol=1e-3)
    assert sorted(g["user_id"] for g in got) == ["U007", "nouveau-0",
                                                 "nouveau-2"]


def test_stream_eval_without_sidecar_exits(models, tmp_path):
    from tpu_als_torch import model_from_arrays

    _, data = models
    path = str(tmp_path / "plain")
    rng = np.random.default_rng(0)
    model_from_arrays(2, np.arange(3), rng.normal(size=(3, 2)),
                      np.arange(4), rng.normal(size=(4, 2)),
                      {"userCol": "user", "itemCol": "item",
                       "ratingCol": "rating", "predictionCol": "prediction",
                       "coldStartStrategy": "nan", "blockSize": 4096},
                      device="cpu").save(path)
    with pytest.raises(SystemExit, match="stream_labels.npz"):
        tmain(["evaluate", "--model", path, "--data", f"stream:{data}",
               "--device", "cpu"])


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in d.items()}


@pytest.mark.parametrize("extra", [
    ["--update-qps", "40", "--update-items", "--update-poison-frac",
     "0.2", "--update-max-batch", "2", "--update-max-wait-ms", "5"],
    ["--tenants", "2", "--tenant-weights", "3,1", "--exact"],
    ["--tenants", "3", "--update-qps", "30", "--update-max-batch", "2"]])
def test_live_and_tenants_serve_bench_match_reference_keys(extra, capsys):
    jmain(["serve-bench", *TINY, *extra])
    ref = _last_json(capsys)
    tobs.reset()
    got = tmain(["serve-bench", *TINY, *extra, "--device", "cpu"])
    assert _last_json(capsys) == got
    if "--tenants" in extra:
        # per-tenant publish modes appear once a live update lands
        for t in (*got["tenants"].values(), *ref["tenants"].values()):
            t.pop("publish_modes", None)
        got.pop("publish_modes", None)
        ref.pop("publish_modes", None)
    else:
        for out in (got, ref):
            out["live"]["publish_modes"] = {}
    assert _keys(got) == _keys(ref)
    assert got["metric"] == ref["metric"] and "slo_met" in got
    shape = (chip_smoke.TENANT_BENCH_SHAPE if "--tenants" in extra
             else chip_smoke.LIVE_BENCH_SHAPE)
    assert chip_smoke.key_shape(ref) == chip_smoke.key_shape(got) == shape
    if "--tenants" in extra:
        assert len(got["tenants"]) == int(extra[1])
        assert list(got["shape_classes"].values()) == \
            [sorted(got["tenants"])]
        assert got["fairness_judged"] is False
    else:
        live = got["live"]
        assert live["events_scored"] + live["quarantined_rows"] == 8
        assert live["updates_shed"] == 0 and live["publish_delta_ms"] > 0
