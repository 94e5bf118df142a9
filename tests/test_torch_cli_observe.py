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
- ``observe roofline|attribution|regress`` raise ``NotImplementedError``.
"""

import json

import numpy as np
import pytest

from tests.test_torch_tuning import inject_init
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


@pytest.mark.parametrize("tool", ["roofline", "attribution", "regress"])
def test_observe_tools_not_ported_raise(tool):
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        tmain(["observe", tool, "--json"])
