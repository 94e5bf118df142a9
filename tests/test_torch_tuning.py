"""Parity of the port's tuners and CLI ``tune``/``evaluate`` with ``tpu_als``.

torch cannot reproduce ``jax.random``, and every inner fit of a tuner
seeds its own init, so :func:`inject_init` wraps both packages'
module-level ``_train`` to pass ``init=`` drawn from a numpy generator
keyed on (num_users, num_items, rank, seed).  Then both packages see the
same folds (numpy draws) and the same starting factors, and differ only
in the route (the reference's einsum + XLA Cholesky on the CPU, the
port's kernels' plain versions).  Bars (``tests/test_torch_train.py``'s):
factors within atol 5e-4 and rtol 5e-3 after 3 iterations, metrics within
1e-4 relative; the grids' points differ by far more (regParam 0.01
against 1.0), so the best index is a fact.  The CLI's JSON is rounded to
4 decimals, so it is held within one unit of the last printed place.
"""

import json

import numpy as np
import pytest

import tpu_als
import tpu_als.api.estimator as jest
import tpu_als.api.tuning as jtuning
import tpu_als_torch
import tpu_als_torch.api.estimator as test_
import tpu_als_torch.api.tuning as ttuning
from tests.conftest import make_ratings

ATOL, RTOL, METRIC_RTOL = 5e-4, 5e-3, 1e-4


def _init_for(num_users, num_items, rank, seed):
    rng = np.random.default_rng([num_users, num_items, rank, seed])

    def rows(n):
        x = np.abs(rng.normal(size=(n, rank))).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    return rows(num_users), rows(num_items)


def inject_init(monkeypatch):
    """Both packages' fits start from the same numpy-drawn factors."""
    def wrap(train):
        def seeded(ucsr, icsr, cfg, callback=None, init=None, start_iter=0,
                   **kw):
            if init is None:
                init = _init_for(ucsr.num_rows, icsr.num_rows, cfg.rank,
                                 cfg.seed)
            return train(ucsr, icsr, cfg, callback=callback, init=init,
                         start_iter=start_iter, **kw)
        return seeded

    monkeypatch.setattr(jest, "_train", wrap(jest._train))
    monkeypatch.setattr(test_, "_train", wrap(test_._train))


def factors(model):
    """(U, V) of either package's ALSModel as numpy."""
    U, V = model._U, model._V
    if hasattr(U, "numpy"):
        U, V = U.cpu().numpy(), V.cpu().numpy()
    return np.asarray(U), np.asarray(V)


def assert_models_close(got, ref):
    np.testing.assert_array_equal(got._user_map.ids, ref._user_map.ids)
    np.testing.assert_array_equal(got._item_map.ids, ref._item_map.ids)
    for g, j in zip(factors(got), factors(ref)):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, j, atol=ATOL, rtol=RTOL)


def _frame():
    rng = np.random.default_rng(5)
    u, i, r, _, _ = make_ratings(rng, 150, 60, rank=3, density=0.12,
                                 noise=0.05)
    # 30 users with one rating each: every fold's validation rows hold
    # users its training rows lack
    lone = np.arange(150, 180)
    return {"user": np.r_[u, lone], "item": np.r_[i, lone % 60],
            "rating": np.r_[r, rng.normal(size=30).astype(np.float32)]}


def _tuner(pkg, kind, cold):
    est = pkg.ALS(rank=3, maxIter=3, seed=4, coldStartStrategy=cold,
                  **({"device": "cpu"} if pkg is tpu_als_torch else {}))
    grid = pkg.ParamGridBuilder().addGrid(est.regParam, [0.01, 1.0]).build()
    ev = pkg.RegressionEvaluator(labelCol="rating")
    if kind == "cv":
        return pkg.CrossValidator(estimator=est, estimatorParamMaps=grid,
                                  evaluator=ev, numFolds=2, seed=7)
    return pkg.TrainValidationSplit(estimator=est, estimatorParamMaps=grid,
                                    evaluator=ev, trainRatio=0.75, seed=7)


def _spy_splits(monkeypatch, mod):
    seen = []
    orig = mod._ValidatorBase._fit_score

    def spy(self, train, val):
        seen.append((train.to_dict(), val.to_dict()))
        return orig(self, train, val)

    monkeypatch.setattr(mod._ValidatorBase, "_fit_score", spy)
    return seen


@pytest.mark.parametrize("cold", ["drop", "nan"])
@pytest.mark.parametrize("kind", ["cv", "tvs"])
def test_tuner_matches_reference(monkeypatch, kind, cold):
    inject_init(monkeypatch)
    t_splits = _spy_splits(monkeypatch, ttuning)
    j_splits = _spy_splits(monkeypatch, jtuning)
    frame = _frame()
    got = _tuner(tpu_als_torch, kind, cold).fit(frame)
    ref = _tuner(tpu_als, kind, cold).fit(frame)
    # the folds (or the split) row for row, and cold users in each
    assert len(t_splits) == len(j_splits) == (2 if kind == "cv" else 1)
    for (tt, tv), (jt, jv) in zip(t_splits, j_splits):
        for c in ("user", "item", "rating"):
            np.testing.assert_array_equal(tt[c], jt[c])
            np.testing.assert_array_equal(tv[c], jv[c])
        assert not np.isin(tv["user"], tt["user"]).all()
    if kind == "cv":
        np.testing.assert_allclose(got.foldMetrics, ref.foldMetrics,
                                   rtol=METRIC_RTOL)
        metrics, ref_metrics = got.avgMetrics, ref.avgMetrics
    else:
        metrics, ref_metrics = got.validationMetrics, ref.validationMetrics
    np.testing.assert_allclose(metrics, ref_metrics, rtol=METRIC_RTOL)
    # the two maps' metrics lie far apart, so the best index is a fact
    assert abs(ref_metrics[0] - ref_metrics[1]) > 100 * METRIC_RTOL
    assert int(np.argmin(metrics)) == int(np.argmin(ref_metrics))
    assert_models_close(got.bestModel, ref.bestModel)
    assert got.bestModel.device.type == "cpu"
    # transform's cold-start semantics on the whole frame plus unseen ids
    probe = {"user": np.r_[frame["user"][:50], 9999],
             "item": np.r_[frame["item"][:50], 0],
             "rating": np.r_[frame["rating"][:50], 3.0]}
    tp, jp = got.transform(probe), ref.transform(probe)
    assert len(tp) == len(jp) == (50 if cold == "drop" else 51)
    np.testing.assert_allclose(tp["prediction"], jp["prediction"],
                               atol=5e-3, equal_nan=True)


def test_param_grid_and_copy_keep_runtime_knobs():
    als = tpu_als_torch.ALS(device="cpu", guardrails="warn", cgIters=2,
                            cgMode="dense", fitCallbackInterval=3)
    grid = (tpu_als_torch.ParamGridBuilder()
            .addGrid(als.rank, [2, 4]).addGrid(als.regParam, [0.01, 0.1])
            .baseOn({als.maxIter: 2}).build())
    jals = tpu_als.ALS()
    jgrid = (tpu_als.ParamGridBuilder()
             .addGrid(jals.rank, [2, 4]).addGrid(jals.regParam, [0.01, 0.1])
             .baseOn({jals.maxIter: 2}).build())
    assert [{p.name: v for p, v in m.items()} for m in grid] == \
        [{p.name: v for p, v in m.items()} for m in jgrid]
    c = als.copy(grid[3])
    assert (c.getRank(), c.getRegParam(), c.getMaxIter()) == (4, 0.1, 2)
    assert (c.device, c.guardrails, c.cgIters, c.cgMode,
            c.fitCallbackInterval) == ("cpu", "warn", 2, "dense", 3)
    assert als.getRank() == 10
    with pytest.raises(ValueError):
        tpu_als_torch.CrossValidator(numFolds=1)
    with pytest.raises(ValueError):
        tpu_als_torch.TrainValidationSplit(trainRatio=1.0)


def test_tuned_saves_load_in_both_packages(monkeypatch, tmp_path):
    inject_init(monkeypatch)
    frame = _frame()
    for kind, t_cls, j_cls, key in (
            ("cv", ttuning.CrossValidatorModel, jtuning.CrossValidatorModel,
             "avgMetrics"),
            ("tvs", ttuning.TrainValidationSplitModel,
             jtuning.TrainValidationSplitModel, "validationMetrics")):
        got = _tuner(tpu_als_torch, kind, "drop").fit(frame)
        ref = _tuner(tpu_als, kind, "drop").fit(frame)
        got.save(str(tmp_path / f"t_{kind}"))
        ref.save(str(tmp_path / f"j_{kind}"))
        meta = json.loads((tmp_path / f"t_{kind}" / "tuning.json")
                          .read_text())
        assert meta["modelClass"] == "tpu_als.api.estimator.ALSModel"
        j_back = j_cls.load(str(tmp_path / f"t_{kind}"))   # port -> ref
        t_back = t_cls.load(str(tmp_path / f"j_{kind}"), device="cpu")
        assert getattr(j_back, key) == getattr(got, key)
        assert getattr(t_back, key) == getattr(ref, key)
        for a, b in ((j_back.bestModel, got.bestModel),
                     (t_back.bestModel, ref.bestModel)):
            for x, y in zip(factors(a), factors(b)):
                np.testing.assert_array_equal(x, y)


def test_tuned_load_refuses_a_foreign_class(tmp_path):
    p = tmp_path / "evil"
    p.mkdir()
    (p / "tuning.json").write_text(json.dumps(
        {"kind": "tvs", "validationMetrics": [],
         "modelClass": "os.path.join"}))
    with pytest.raises(ValueError, match="refusing to load"):
        ttuning.TrainValidationSplitModel.load(str(p), device="cpu")
    (p / "tuning.json").write_text(json.dumps(
        {"kind": "tvs", "validationMetrics": [],
         "modelClass": "tpu_als_torch.api.estimator.ALSModel"}))
    with pytest.raises(ValueError, match="refusing to load"):
        ttuning.TrainValidationSplitModel.load(str(p), device="cpu")


def _cli_json(main, argv, capsys):
    main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def _assert_json_close(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, (list, float)):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1.01e-4)
        else:
            assert got[k] == v, k


def test_cli_tune_and_evaluate_match_reference(monkeypatch, tmp_path,
                                                 capsys):
    from tpu_als.cli import main as jmain
    from tpu_als_torch.cli import main as tmain

    inject_init(monkeypatch)
    tune = ["tune", "--data", "synthetic:200x80x5000", "--ranks", "2,6",
            "--reg-params", "0.01,1.0", "--folds", "2", "--max-iter", "3",
            "--seed", "3"]
    t = _cli_json(tmain, tune + ["--device", "cpu", "--output",
                                 str(tmp_path / "t")], capsys)
    j = _cli_json(jmain, tune + ["--output", str(tmp_path / "j")], capsys)
    _assert_json_close(t, j)
    assert t["best_regParam"] == 0.01 and t["grid_size"] == 4
    # the test frame holds users and items the models never saw: cold
    # users count as empty rankings, cold rows drop out of the RMSE
    ev = ["evaluate", "--data", "synthetic:260x90x3000", "--ranking-k",
          "5", "--positive-threshold", "3.0"]
    for model in ("t", "j"):   # each package's save, in both packages
        path = str(tmp_path / model / "bestModel")
        te = _cli_json(tmain, ev + ["--model", path, "--device", "cpu"],
                       capsys)
        je = _cli_json(jmain, ev + ["--model", path], capsys)
        _assert_json_close(te, je)
        assert te["ranking_users_cold"] > 0
        assert te["ranking_users"] > te["ranking_users_cold"]
