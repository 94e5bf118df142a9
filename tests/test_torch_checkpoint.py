"""The port's checkpoint lifecycle against ``tpu_als``'s.

Both packages write the same format and the same integrity contract:
retried writes under ``checkpoint.write=raise`` (the same attempts,
events and backoff draws), a torn save under ``checkpoint.write=corrupt``
quarantined to ``.corrupt/`` with the ``.old`` generation loaded, a crash
between the renames under ``checkpoint.rename``, and ``discover_resume``.
``save_factors`` takes the reference's signature, ``extra=`` (by name
or as the eighth argument) written into the manifest.  Then the port's
fit end to end on the CPU: ``TPU_ALS_PREEMPT_AT`` stops
``train`` with exit 43 and a checkpoint, and ``--resume auto`` ends equal
to an uninterrupted fit, bit for bit (the same plain versions, from the
same factors).  Every comparison here is exact.
"""

import os
import shutil

import numpy as np
import pytest

from tpu_als import obs as jobs
from tpu_als.io import checkpoint as jck
from tpu_als.resilience import faults as jfaults
from tpu_als.resilience import retry as jretry
from tpu_als_torch import obs as tobs
from tpu_als_torch.cli import main as tmain
from tpu_als_torch.io import checkpoint as tck
from tpu_als_torch.resilience import faults as tfaults
from tpu_als_torch.resilience import preempt
from tpu_als_torch.resilience import retry as tretry

PKGS = {"port": (tck, tfaults, tretry, tobs),
        "reference": (jck, jfaults, jretry, jobs)}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(preempt.ENV_PREEMPT_AT, raising=False)
    for _, faults, _, obs in PKGS.values():
        faults.clear()
        obs.reset()
    yield
    for _, faults, _, _ in PKGS.values():
        faults.clear()


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return (np.arange(10), rng.normal(size=(10, 3)).astype(np.float32),
            np.arange(7) * 3, rng.normal(size=(7, 3)).astype(np.float32))


def _save(ck, path, iteration=1, seed=0, **kw):
    ids_u, U, ids_i, V = _arrays(seed)
    ck.save_factors(path, ids_u, U, ids_i, V, params={"rank": 3},
                    iteration=iteration, **kw)
    return U


def _events(obs, etype):
    return [e for e in obs.default_registry()._events if e["type"] == etype]


def _policy(retry, sleeps, attempts=3):
    return retry.RetryPolicy(max_attempts=attempts, base_delay=0.01,
                             jitter=0.25, seed=3, sleep=sleeps.append)


@pytest.mark.parametrize("how", ["keyword", "positional", "none"])
def test_save_factors_writes_extra_as_the_reference(tmp_path, how):
    import json

    ids_u, U, ids_i, V = _arrays()
    extra = {"note": "x", "sources": [1, 2]}
    manifests = {}
    for name, (ck, _, retry, _) in PKGS.items():
        path = str(tmp_path / name)
        if how == "keyword":
            ck.save_factors(path, ids_u, U, ids_i, V, {"rank": 3}, 4,
                            extra=extra)
        elif how == "positional":
            ck.save_factors(path, ids_u, U, ids_i, V, {"rank": 3}, 4, extra,
                            retry.RetryPolicy(max_attempts=1))
        else:
            ck.save_factors(path, ids_u, U, ids_i, V, {"rank": 3}, 4)
        with open(os.path.join(path, "manifest.json")) as f:
            manifests[name] = json.load(f)
        assert ck.load_factors(path)[0]["extra"] == \
            ({} if how == "none" else extra)
    mine, theirs = manifests["port"], manifests["reference"]
    assert mine == theirs
    assert mine["extra"] == ({} if how == "none" else extra)


@pytest.mark.parametrize("spec,attempts", [
    ("checkpoint.write=raise@nth=1", 3), ("checkpoint.write=raise@first=2", 3),
    ("checkpoint.write=raise@first=3", 3), ("checkpoint.rename=raise@nth=1", 2)])
def test_retry_schedule_and_events_match_reference(tmp_path, spec,
                                                   attempts):
    out = {}
    for name, (ck, faults, retry, obs) in PKGS.items():
        path = str(tmp_path / name / "ck")
        sleeps = []
        faults.install(spec)
        try:
            _save(ck, path, iteration=1, retry_policy=_policy(retry, sleeps,
                                                              attempts))
            err = None
        except retry.RetryExhausted as e:
            err = (e.attempts, type(e.last).__name__)
        point = spec.split("=")[0]
        out[name] = {
            "err": err, "sleeps": sleeps, "hits": faults.hits(point),
            "attempts": [(e["what"], e["attempt"], e["attempts"])
                         for e in _events(obs, "retry_attempt")],
            "exhausted": [(e["what"], e["attempts"])
                          for e in _events(obs, "retry_exhausted")],
            "fired": [(e["point"], e["mode"], e["hit"])
                      for e in _events(obs, "fault_injected")],
            "saves": [(e["bytes"], e["iteration"])
                      for e in _events(obs, "checkpoint_save")],
            "files": sorted(os.listdir(tmp_path / name)),
        }
        faults.clear()
    assert out["port"] == out["reference"]
    assert out["port"]["attempts"], out["port"]
    if out["port"]["err"] is None:
        for name, (ck, *_rest) in PKGS.items():
            manifest, _, U, _, _ = ck.load_factors(str(tmp_path / name /
                                                       "ck"))
            np.testing.assert_array_equal(U, _arrays()[1])


def _torn_with_old(ck, faults, root):
    """A torn primary at iteration 2 beside a complete iteration-1
    ``.old``: the crash-window state the ``.old`` contract exists for."""
    path = str(root / "ck")
    U1 = _save(ck, str(root / "gen1"), iteration=1, seed=1)
    faults.install("checkpoint.write=corrupt@nth=1")
    _save(ck, path, iteration=2, seed=2)   # the writer lets it through
    faults.clear()
    shutil.move(str(root / "gen1"), path + ".old")
    return path, U1


@pytest.mark.parametrize("writer", sorted(PKGS))
def test_torn_save_is_quarantined_and_old_loaded(tmp_path, writer):
    ck_w, faults_w, _, _ = PKGS[writer]
    seen = {}
    for name, (ck, _, _, obs) in PKGS.items():
        root = tmp_path / name
        root.mkdir()
        path, U1 = _torn_with_old(ck_w, faults_w, root)
        manifest, _, U, _, _ = ck.load_factors(path)
        q = _events(obs, "checkpoint_quarantined")
        seen[name] = (manifest["iteration"], len(q), "digest mismatch"
                      in q[0]["reason"], sorted(os.listdir(root)),
                      len(os.listdir(root / ".corrupt")))
        np.testing.assert_array_equal(U, U1)
        # without an .old generation the typed error propagates
        faults_w.install("checkpoint.write=corrupt@nth=1")
        _save(ck_w, str(root / "lone"), iteration=2)
        faults_w.clear()
        with pytest.raises(ck.CheckpointCorrupt, match="digest mismatch"):
            ck.load_factors(str(root / "lone"))
    assert seen["port"] == seen["reference"] == \
        (1, 1, True, [".corrupt", "ck.old"], 1)


def test_crash_between_the_renames(tmp_path):
    for name, (ck, faults, retry, _) in PKGS.items():
        path = str(tmp_path / name / "ck")
        U1 = _save(ck, path, iteration=1, seed=1)
        faults.install("checkpoint.rename=raise@nth=1")
        with pytest.raises(retry.RetryExhausted):
            _save(ck, path, iteration=2, seed=2,
                  retry_policy=retry.RetryPolicy(max_attempts=1))
        faults.clear()
        assert not os.path.exists(os.path.join(path, "manifest.json"))
        manifest, _, U, _, _ = ck.load_factors(path)
        assert manifest["iteration"] == 1
        np.testing.assert_array_equal(U, U1)
        # a retried rename completes the swap
        faults.install("checkpoint.rename=raise@nth=1")
        U3 = _save(ck, path, iteration=3, seed=3,
                   retry_policy=retry.RetryPolicy(base_delay=0.0))
        faults.clear()
        manifest, _, U, _, _ = ck.load_factors(path)
        assert manifest["iteration"] == 3
        np.testing.assert_array_equal(U, U3)


def test_discover_resume_matches_reference(tmp_path):
    for name, (ck, _, _, obs) in PKGS.items():
        root = tmp_path / name
        root.mkdir()
        assert ck.discover_resume(str(root)) is None
        live = str(root / "als_checkpoint")
        _save(ck, live, iteration=5)
        _save(ck, live + ".old", iteration=3)
        assert ck.discover_resume(str(root)) == live
        assert ck.discover_resume(live) == live
        with open(os.path.join(live, "user_factors.npz"), "ab") as f:
            f.write(b"bitrot")
        assert ck.discover_resume(str(root)) == live + ".old"
        assert len(_events(obs, "checkpoint_quarantined")) == 1
        assert sorted(os.listdir(root)) == [".corrupt", "als_checkpoint.old"]
    # each package reads the other's save
    for a, b in (("port", "reference"), ("reference", "port")):
        ck_a, ck_b = PKGS[a][0], PKGS[b][0]
        path = str(tmp_path / f"{a}_save")
        _save(ck_a, path, iteration=4)
        manifest, *_ = ck_b.load_factors(path)
        assert manifest["iteration"] == 4


def test_preempt_at_knob_and_its_errors(monkeypatch):
    monkeypatch.setenv(preempt.ENV_PREEMPT_AT, "3")
    assert preempt.enabled() and not preempt.pending(2)
    assert preempt.pending(3)
    p = preempt.Preempted(7, "/x/ck")
    assert isinstance(p, SystemExit) and p.code == preempt.EXIT_PREEMPTED == 43
    for bad in ("three", "0", "-2", "2.5"):
        monkeypatch.setenv(preempt.ENV_PREEMPT_AT, bad)
        with pytest.raises(preempt.PreemptAtError):
            with preempt.PreemptionGuard():
                pass
        assert preempt.installed() is None
        with pytest.raises(preempt.PreemptAtError):
            preempt.pending(1)
    with pytest.raises(preempt.PreemptAtError):
        tmain(["train", "--data", "synthetic:40x20x400", "--rank", "2",
               "--max-iter", "2", "--device", "cpu"])


def test_guard_records_a_signal():
    import signal

    with preempt.PreemptionGuard() as g:
        assert preempt.installed() is g and preempt.enabled()
        assert not preempt.pending(1)
        signal.raise_signal(signal.SIGTERM)
        assert g.triggered() and g.signum == signal.SIGTERM
        assert preempt.pending(2)
    assert preempt.installed() is None


def _train(tmp_path, name, *extra, env=None, monkeypatch=None):
    argv = ["train", "--data", "synthetic:80x40x1500", "--rank", "4",
            "--max-iter", "6", "--reg-param", "0.05", "--seed", "7",
            "--device", "cpu", *extra]
    if name:
        argv += ["--output", str(tmp_path / name)]
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    try:
        tmain(argv)
        return 0
    except SystemExit as e:
        return e.code
    finally:
        for k in env or {}:
            monkeypatch.delenv(k)


def _same_model(a, b):
    for side in ("user_factors.npz", "item_factors.npz"):
        x, y = np.load(os.path.join(a, side)), np.load(os.path.join(b, side))
        np.testing.assert_array_equal(x["factors"], y["factors"])
        np.testing.assert_array_equal(x["ids"], y["ids"])


def test_cli_preempt_then_resume_auto_is_exact(tmp_path, monkeypatch,
                                               capsys):
    ck = str(tmp_path / "ck")
    assert _train(tmp_path, "full") == 0
    rc = _train(tmp_path, None, "--checkpoint-dir", ck,
                "--checkpoint-interval", "100",
                env={preempt.ENV_PREEMPT_AT: "3"}, monkeypatch=monkeypatch)
    assert rc == preempt.EXIT_PREEMPTED
    assert "preempted" in capsys.readouterr().err
    assert tck.load_factors(os.path.join(ck, "als_checkpoint"))[0][
        "iteration"] == 3
    assert tobs.events("preempted")[-1]["iteration"] == 3
    assert _train(tmp_path, "res", "--checkpoint-dir", ck,
                  "--resume", "auto") == 0
    assert "resuming from" in capsys.readouterr().err
    _same_model(str(tmp_path / "full"), str(tmp_path / "res"))
    # nothing on disk: --resume auto starts from scratch
    assert _train(tmp_path, None, "--checkpoint-dir",
                  str(tmp_path / "empty"), "--resume", "auto") == 0
    assert "starting from scratch" in capsys.readouterr().err


def test_cli_resume_auto_quarantines_a_torn_save(tmp_path, monkeypatch,
                                                 capsys):
    """The torn save (``checkpoint.write=corrupt`` on the second write,
    iteration 4) beside an iteration-2 ``.old``: ``--resume auto``
    quarantines it, resumes from ``.old`` and ends equal to an
    uninterrupted fit."""
    ck, ck2 = str(tmp_path / "ck"), str(tmp_path / "ck2")
    assert _train(tmp_path, "full") == 0
    rc = _train(tmp_path, None, "--checkpoint-dir", ck,
                "--checkpoint-interval", "2",
                env={preempt.ENV_PREEMPT_AT: "4",
                     tfaults.ENV_VAR: "checkpoint.write=corrupt@nth=2"},
                monkeypatch=monkeypatch)
    tfaults.clear()
    assert rc == preempt.EXIT_PREEMPTED
    primary = os.path.join(ck, "als_checkpoint")
    with pytest.raises(tck.CheckpointCorrupt):
        tck.validate_dir(primary)
    # ALS iterations do not depend on maxIter, so a finished maxIter=2
    # run's checkpoint is the iteration-2 generation
    argv = ["train", "--data", "synthetic:80x40x1500", "--rank", "4",
            "--max-iter", "2", "--reg-param", "0.05", "--seed", "7",
            "--device", "cpu", "--checkpoint-dir", ck2,
            "--checkpoint-interval", "2"]
    tmain(argv)
    shutil.move(os.path.join(ck2, "als_checkpoint"), primary + ".old")
    capsys.readouterr()
    assert _train(tmp_path, "res", "--checkpoint-dir", ck,
                  "--resume", "auto") == 0
    assert "als_checkpoint.old" in capsys.readouterr().err
    assert os.listdir(os.path.join(ck, ".corrupt"))
    _same_model(str(tmp_path / "full"), str(tmp_path / "res"))


def test_callback_copies_only_on_due_iterations(tmp_path, monkeypatch):
    import tpu_als_torch

    rng = np.random.default_rng(1)
    frame = {"user": rng.integers(0, 30, 600), "item": rng.integers(0, 20, 600),
             "rating": rng.uniform(1, 5, 600).astype(np.float32)}
    seen, saved = [], []
    est = tpu_als_torch.ALS(rank=3, maxIter=6, device="cpu",
                            checkpointDir=str(tmp_path), checkpointInterval=2,
                            fitCallback=lambda it, U, V: seen.append(it),
                            fitCallbackInterval=3)
    monkeypatch.setattr(est, "_save_checkpoint",
                        lambda um, im, it, U, V: saved.append(it))
    est.fit(frame)
    assert seen == [3, 6] and saved == [2, 4, 6]
    assert [it for it in range(1, 7) if est._callback_due(it)] == \
        [2, 3, 4, 6]
    monkeypatch.setenv(preempt.ENV_PREEMPT_AT, "5")
    with pytest.raises(preempt.Preempted) as ei:
        est.fit(frame)
    assert ei.value.iteration == 5 and saved[-1] == 5
    assert ei.value.checkpoint_path == os.path.join(str(tmp_path),
                                                    "als_checkpoint")
