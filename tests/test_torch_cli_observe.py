"""The rest of ``train``'s command line and the run-directory readers, on
the port's CLI against the reference's, in one process (JAX on the CPU,
``--device cpu``):

- ``train --log-file --obs-dir`` then ``observe summarize --json`` on
  both packages' run directories, both fits started from the same
  numpy-drawn factors (``tests/test_torch_tuning.py::inject_init``): the
  same phases (``cli.train``, ``cli.train/data.load``,
  ``cli.train/train.block``, ``cli.train/train.fit``), the same
  iterations, ``probe_rmse`` within 1e-4 relative (the tuners' metric
  band: the two programs solve in different orders), the log file's
  lines the iteration records;
- ``train --output`` alone writes the four spans into ``<output>/obs``;
- ``observe tail`` and ``observe explain`` of the port's and the
  reference's readers agree on a ``serve-bench`` run directory with an
  SLO breach (tracing armed);
- ``tt-train``, warm and ``--cold``: the key set and counts (pairs,
  users, items, epochs) of the reference's ``--cold`` run, which splits
  the data the same way (the recall differs with the init), the save
  loadable by either package;
- ``observe roofline|attribution|regress``, which raised
  ``NotImplementedError`` before they were ported, run;
- ``train --devices 4 --gather-strategy all_gather`` (and with
  ``--elastic``) on 4 logical CPU shards against the reference's CLI on 4
  of its 8 forced CPU devices, both fits from the same numpy-drawn
  factors (``fit_sharded`` wrapped in both packages): holdout RMSE
  within METRIC_RTOL, the saved factors within the tuners' ATOL/RTOL;
  ``recommend --devices 4 --gather-strategy ring`` on the same saved
  model: the same users and items, scores within 1e-4 (printed to 4
  decimals); and on a model of more users than one block of lines the
  port writes at once, every user's line in order;
- ``observe roofline --json``: the reference's stages, bytes and FLOPs
  at the card's rates; ``observe attribution --device cpu --obs-dir``:
  coverage >= 0.9, the ``attribution`` event and ``train.stage_seconds``
  in the run directory.
"""

import json

import numpy as np
import pytest
import torch

from tests.test_torch_tuning import ATOL, RTOL, _init_for, inject_init
from tpu_als import obs as jobs
from tpu_als.cli import main as jmain
from tpu_als_torch import obs as tobs
from tpu_als_torch.cli import main as tmain

DATA = "synthetic:300x120x8000"
TRAIN = ["train", "--data", DATA, "--rank", "4", "--max-iter", "3",
         "--reg-param", "0.05", "--seed", "3"]
PHASES = {"cli.train", "cli.train/data.load", "cli.train/train.block",
          "cli.train/train.fit"}
METRIC_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("TPU_ALS_PLAN_CACHE", "off")
    jobs.reset()
    tobs.reset()
    yield
    jobs.reset()
    tobs.reset()


def _summary(main, run, capsys):
    capsys.readouterr()
    main(["observe", "summarize", run, "--json"])
    return json.loads(capsys.readouterr().out)


def test_train_log_file_and_obs_dir_match_reference(tmp_path, monkeypatch,
                                                    capsys):
    inject_init(monkeypatch)
    runs = {}
    for name, main, extra in (("port", tmain, ["--device", "cpu"]),
                              ("ref", jmain, [])):
        log, run = tmp_path / f"{name}.jsonl", str(tmp_path / f"{name}_obs")
        main(TRAIN + ["--log-file", str(log), "--obs-dir", run] + extra)
        err = capsys.readouterr().err
        assert f"run metrics written to {run}" in err
        runs[name] = (_summary(main, run, capsys),
                      [json.loads(x) for x in log.read_text().splitlines()])
    (ts, tlog), (js, jlog) = runs["port"], runs["ref"]
    assert set(ts["phases"]) == set(js["phases"]) == PHASES
    assert all(p["count"] == 1 for p in ts["phases"].values())
    assert [e["iteration"] for e in ts["iterations"]] == \
        [e["iteration"] for e in js["iterations"]] == [1, 2, 3]
    np.testing.assert_allclose([e["probe_rmse"] for e in ts["iterations"]],
                               [e["probe_rmse"] for e in js["iterations"]],
                               rtol=METRIC_RTOL)
    # the iteration events carry the log's records, less the tag
    assert len(tlog) == 3
    for r, e in zip(tlog, ts["iterations"]):
        assert {k: v for k, v in r.items() if k != "tag"} == \
            {k: e[k] for k in r if k != "tag"}
    assert set(ts["iterations"][0]) == set(js["iterations"][0])
    assert ts["manifest"]["argv"][0] == "train"
    # the reference's reader reads the port's run directory the same way
    assert _summary(jmain, str(tmp_path / "port_obs"), capsys)["phases"] \
        == ts["phases"]


def test_train_output_records_the_fit_spans_and_profile(tmp_path, capsys):
    """Without ``--obs-dir`` the run directory is ``<output>/obs`` and
    holds the reference's four phases of a fit; ``--profile-dir`` writes
    a trace naming them (one run checks both)."""
    out, prof = str(tmp_path / "m"), tmp_path / "prof"
    tmain(TRAIN + ["--device", "cpu", "--output", out, "--profile-dir",
                   str(prof)])
    assert "profiler trace written to" in capsys.readouterr().err
    with open(f"{out}/obs/events.jsonl") as f:
        evs = [json.loads(x) for x in f]
    paths = {e["path"] for e in evs if e["type"] == "span"}
    assert PHASES <= paths, paths
    # a live run directory records the iterations without --log-file
    assert [e["iteration"] for e in evs if e["type"] == "iteration"] == \
        [1, 2, 3]
    (trace,) = list(prof.glob("*.json"))
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert {"train.block", "train.fit"} <= names   # the profiled fit


SERVE = ["serve-bench", "--users", "64", "--items", "300", "--rank", "8",
         "--k", "5", "--shortlist-k", "32", "--qps", "400", "--duration",
         "0.2", "--slo-ms", "0.001", "--buckets", "8,32"]


def test_tail_and_explain_on_a_breached_serve_run(tmp_path, monkeypatch,
                                                  capsys):
    monkeypatch.setenv("TPU_ALS_TRACE", "1")
    run = str(tmp_path / "sb")
    tmain(SERVE + ["--device", "cpu", "--obs-dir", run])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["slo_met"] is False and res["flight_records"] > 0

    def both(args):
        out = {}
        for name, main in (("port", tmain), ("ref", jmain)):
            capsys.readouterr()
            main(args)
            out[name] = capsys.readouterr().out
        assert out["port"] == out["ref"]
        return out["port"]

    tail = both(["observe", "tail", run, "--event", "flight_record",
                 "-n", "4"])
    recs = [json.loads(x) for x in tail.splitlines()]
    assert len(recs) == 4 and all(r["trigger"] == "slo_breach"
                                  for r in recs)
    tree = both(["observe", "explain", run, "--breach", "last"])
    assert tree.startswith("breach: flight_record trigger=slo_breach")
    assert "serve.admit" in tree and "serve.score" in tree
    tid = recs[-1]["trace_id"]
    assert both(["observe", "explain", run, "--trace", tid]).startswith(
        f"trace {tid}:")
    assert both(["observe", "tail", run, "--trace", tid])
    # observe writes no run directory of its own
    assert not tobs.active()
    with pytest.raises(SystemExit, match="not in the trail"):
        tmain(["observe", "explain", run, "--trace", "t99"])


def test_tt_train_keys_and_counts_match_reference(tmp_path, capsys):
    from tpu_als.models.two_tower import load_two_tower as jload
    from tpu_als_torch.models.two_tower import load_two_tower as tload

    args = ["tt-train", "--data", "synthetic:200x80x5000", "--epochs", "1",
            "--als-rank", "4", "--als-iters", "2", "--embed-dim", "8"]
    jmain(args + ["--cold"])   # the one reference run
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ref["warm_start"] is False
    for extra in ([], ["--cold"]):
        out = str(tmp_path / f"tt{len(extra)}")
        tmain(args + ["--device", "cpu", "--output", out,
                      "--obs-dir", str(tmp_path / f"o{len(extra)}")] + extra)
        got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert set(got) == set(ref) | {"saved"}
        assert got["warm_start"] is (not extra)
        for k in ("train_pairs", "test_pairs", "users", "items", "epochs"):
            assert got[k] == ref[k], k
        assert 0.0 <= got["filtered_recall_at_10"] <= 1.0
        m, cfg, nu, ni = tload(out, device="cpu")
        assert (nu, ni) == (ref["users"], ref["items"])
        assert cfg.embed_dim == 8 and cfg.epochs == 1
        jp, jcfg, _, _ = jload(out)
        np.testing.assert_array_equal(np.asarray(jp["user_embed"]),
                                      m.user_embed.detach().numpy())
    with open(tmp_path / "o0" / "events.jsonl") as f:
        assert "cli.tt-train" in {json.loads(x).get("path") for x in f}


@pytest.fixture
def one_thread():
    """One intra-op thread for the tiny fits below: under the suite's
    workers a thread pool per small op mostly waits for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("tool", ["roofline", "attribution", "regress"])
def test_observe_tools_not_ported_raise(tool, tmp_path, capsys):
    """The three tools raised ``NotImplementedError`` until they were
    ported; now each runs and prints one JSON object."""
    extra = {"roofline": [],
             "attribution": ["--data", "synthetic:60x30x800", "--rank", "4",
                             "--iters", "1", "--device", "cpu"],
             "regress": [str(tmp_path)]}[tool]
    out = tmain(["observe", tool, "--json"] + extra)
    assert json.loads(capsys.readouterr().out) == json.loads(
        json.dumps(out))


def _inject_sharded_init(monkeypatch):
    """Both packages' mesh fits start from ``_init_for``'s factors."""
    from tpu_als.api import fitting as jfitting
    from tpu_als_torch.api import estimator as testimator

    def wrap(fit):
        def seeded(est, u_idx, i_idx, r, user_map, item_map, cfg, init,
                   start_iter, **kw):
            if init is None:
                init = _init_for(len(user_map), len(item_map), cfg.rank,
                                 cfg.seed)
            return fit(est, u_idx, i_idx, r, user_map, item_map, cfg, init,
                       start_iter, **kw)
        return seeded

    monkeypatch.setattr(jfitting, "fit_sharded",
                        wrap(jfitting.fit_sharded))
    monkeypatch.setattr(testimator, "fit_sharded",
                        wrap(testimator.fit_sharded))


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("elastic", [False, True])
def test_train_and_recommend_devices_match_reference(elastic, tmp_path,
                                                     monkeypatch, capsys):
    from tpu_als_torch.io.checkpoint import load_factors

    _inject_sharded_init(monkeypatch)
    flags = ["--devices", "4", "--gather-strategy", "all_gather"] + (
        ["--elastic"] if elastic else [])
    train = ["train", "--data", "synthetic:120x60x2000", "--rank", "4",
             "--max-iter", "2", "--reg-param", "0.05", "--seed", "3"]
    rmse, factors = {}, {}
    for name, main, extra in (("port", tmain, ["--device", "cpu"]),
                              ("ref", jmain, [])):
        out = str(tmp_path / name)
        capsys.readouterr()
        main(train + flags + ["--output", out] + extra)
        rmse[name] = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])["holdout_rmse"]
        factors[name] = load_factors(out)
    np.testing.assert_allclose(rmse["port"], rmse["ref"], rtol=METRIC_RTOL)
    (_, tu, tU, ti, tV), (_, ju, jU, ji, jV) = factors["port"], \
        factors["ref"]
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_array_equal(ti, ji)
    for got, ref in ((tU, jU), (tV, jV)):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    if elastic:
        return
    recs = {}
    for name, main, extra in (("port", tmain, ["--device", "cpu"]),
                              ("ref", jmain, [])):
        capsys.readouterr()
        main(["recommend", "--model", str(tmp_path / "port"), "--devices",
              "4", "--gather-strategy", "ring", "--k", "5", "--limit", "0"]
             + extra)
        recs[name] = [json.loads(x) for x in
                      capsys.readouterr().out.strip().splitlines()]
    assert len(recs["port"]) == len(recs["ref"]) == 120
    for a, b in zip(recs["port"], recs["ref"]):
        assert a["user"] == b["user"]
        assert [i for i, _ in a["items"]] == [i for i, _ in b["items"]]
        np.testing.assert_allclose([s for _, s in a["items"]],
                                   [s for _, s in b["items"]], atol=1e-4)


def test_observe_roofline_json_matches_reference(capsys):
    args = ["observe", "roofline", "--ne-path", "gather_fused_solve",
            "--rank", "64", "--devices", "4", "--strategy", "ring",
            "--tiles", "3", "--json"]
    tmain(args)
    mine = json.loads(capsys.readouterr().out)
    jmain(args)
    theirs = json.loads(capsys.readouterr().out)
    assert [(s["name"], s["bytes"], s["flops"]) for s in mine["stages"]] \
        == [(s["name"], s["bytes"], s["flops"]) for s in theirs["stages"]]
    assert mine["config"]["hbm_gbps"] == 3350.0
    assert "measured_s_per_iter" not in mine
    assert "measured_s_per_iter" in json.loads(
        json.dumps(tmain(args[:-1] + ["--measured-s-per-iter", "0.1"])))


@pytest.mark.usefixtures("one_thread")
def test_observe_attribution_writes_its_run_directory(tmp_path, capsys):
    run = tmp_path / "obs"
    rep = tmain(["observe", "attribution", "--data", "synthetic:100x60x2000",
                 "--rank", "4", "--iters", "2", "--device", "cpu", "--json",
                 "--obs-dir", str(run)])
    out = json.loads(capsys.readouterr().out)
    assert out["coverage"] == rep["coverage"] >= 0.9
    assert {"gather_fused_solve", "scatter", "yty"} <= {
        r["stage"] for r in out["rows"] if r["measured_s"] is not None}
    events = [json.loads(x) for x in open(run / "events.jsonl") if x.strip()]
    attr = [e for e in events if e["type"] == "attribution"]
    assert len(attr) == 1 and attr[0]["coverage"] == out["coverage"]
    snap = [e for e in events if e["type"] == "snapshot"][-1]
    assert any(k.startswith("train.stage_seconds")
               for k in snap["histograms"])


@pytest.mark.usefixtures("one_thread")
def test_recommend_prints_every_user_across_its_write_blocks(tmp_path,
                                                            capsys):
    # more users than one block of lines the port writes at once: every
    # user's line, in order, as the reference prints them one by one
    out = str(tmp_path / "m")
    tmain(["train", "--data", "synthetic:6000x40x30000", "--rank", "4",
           "--max-iter", "1", "--seed", "3", "--device", "cpu", "--output",
           out])
    recs = {}
    for name, main, extra in (("port", tmain, ["--device", "cpu"]),
                              ("ref", jmain, [])):
        capsys.readouterr()
        main(["recommend", "--model", out, "--k", "3", "--limit", "0"]
             + extra)
        recs[name] = [json.loads(x) for x in
                      capsys.readouterr().out.strip().splitlines()]
    assert len(recs["port"]) == len(recs["ref"]) > 4096
    for a, b in zip(recs["port"], recs["ref"]):
        assert a["user"] == b["user"]
        assert [i for i, _ in a["items"]] == [i for i, _ in b["items"]]
        np.testing.assert_allclose([s for _, s in a["items"]],
                                   [s for _, s in b["items"]], atol=1e-4)
