"""Parity of the port's regression evaluators and params with ``tpu_als``.

Both are plain numpy / Python on the host, so the same frame gives the
same float64 metric up to summation order: rtol 1e-12.
"""

import numpy as np
import pytest

from tpu_als.api.estimator import ALS as JALS
from tpu_als.api.evaluation import RegressionEvaluator as JEval
from tpu_als.api.evaluation import RegressionMetrics as JMetrics
import tpu_als_torch
from tpu_als_torch.api.evaluation import RegressionMetrics as TMetrics


def _frame():
    rng = np.random.default_rng(7)
    label = (rng.integers(1, 11, 300) * 0.5).astype(np.float32)
    pred = (label + rng.normal(scale=0.7, size=300)).astype(np.float32)
    pred[rng.random(300) < 0.1] = np.nan  # cold-start rows
    return {"rating": label, "prediction": pred}


@pytest.mark.parametrize("metric,origin", [
    ("rmse", False), ("mse", False), ("mae", False), ("r2", False),
    ("r2", True), ("var", False)])
def test_regression_evaluator_matches_reference(metric, origin):
    kw = dict(labelCol="rating", metricName=metric, throughOrigin=origin)
    tev = tpu_als_torch.RegressionEvaluator(**kw)
    got = tev.evaluate(_frame())
    ref = JEval(**kw).evaluate(_frame())
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    assert tev.isLargerBetter() == JEval(**kw).isLargerBetter()
    # an override map evaluates a copy and leaves the evaluator as it was
    assert tev.evaluate(_frame(), {tev.getParam("metricName"): "mae"}) == \
        pytest.approx(JEval(labelCol="rating", metricName="mae")
                      .evaluate(_frame()), rel=1e-12)
    assert tev.getOrDefault("metricName") == metric


def test_regression_metrics_match_reference():
    f = _frame()
    ok = ~np.isnan(f["prediction"])
    pairs = list(zip(f["prediction"][ok], f["rating"][ok]))
    t, j = TMetrics(pairs), JMetrics(pairs)
    for name in ("meanSquaredError", "rootMeanSquaredError",
                 "meanAbsoluteError", "r2", "explainedVariance"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name),
                                   rtol=1e-12)
    with pytest.raises(ValueError):
        TMetrics([])


def test_als_params_and_defaults_match_reference():
    """Every param of the reference's ALS exists in the port with the same
    default; explainParams lists them alike."""
    t, j = tpu_als_torch.ALS(), JALS()
    tmap = {p.name: v for p, v in t.extractParamMap().items()}
    jmap = {p.name: v for p, v in j.extractParamMap().items()}
    assert tmap == jmap
    t2 = t.copy({t.getParam("rank"): 7})
    assert t2.getRank() == 7 and t.getRank() == 10
    assert t.explainParam("rank") == j.explainParam("rank")
    with pytest.raises(TypeError):
        tpu_als_torch.ALS(bogus=1)


# -- ranking metrics: pure Python on the host, the same arithmetic in the
# same order, so the bar is 1e-12 relative

def _ranking_cases():
    rng = np.random.default_rng(11)
    rand = []
    for _ in range(40):
        pred = rng.permutation(30)[:rng.integers(0, 15)].tolist()
        rel = rng.choice(30, rng.integers(0, 8), replace=False).tolist()
        rand.append((pred, rel))
    return {
        # the reference's own cases (tests/test_evaluation_tuning.py)
        "hand": [([1, 2, 3], [1, 3])],
        "empty_truth": [([1, 2], []), ([1, 2], [1])],
        "all_empty_truth": [([1, 2], []), ([], [])],
        "short_lists": [([4], [4, 5, 6]), ([], [1])],
        "random": rand,
    }


@pytest.mark.parametrize("case", sorted(_ranking_cases()))
def test_ranking_metrics_match_reference(case):
    from tpu_als.api.evaluation import RankingMetrics as JRank
    from tpu_als_torch.api.evaluation import RankingMetrics as TRank

    pairs = _ranking_cases()[case]
    t, j = TRank(pairs), JRank(pairs)
    # k = 20 and 50 lie beyond every list
    for k in (1, 2, 3, 5, 20, 50):
        for name in ("precisionAt", "recallAt", "meanAveragePrecisionAt",
                     "ndcgAt"):
            np.testing.assert_allclose(getattr(t, name)(k),
                                       getattr(j, name)(k), rtol=1e-12)
    np.testing.assert_allclose(t.meanAveragePrecision,
                               j.meanAveragePrecision, rtol=1e-12)
    assert TRank([]).precisionAt(3) == JRank([]).precisionAt(3) == 0.0
    for name in ("precisionAt", "recallAt", "ndcgAt"):
        with pytest.raises(ValueError):
            getattr(t, name)(0)


@pytest.mark.parametrize("metric", [
    "meanAveragePrecision", "meanAveragePrecisionAtK", "precisionAtK",
    "ndcgAtK", "recallAtK"])
def test_ranking_evaluator_matches_reference(metric):
    from tpu_als.api.evaluation import RankingEvaluator as JRankEval

    pairs = _ranking_cases()["random"]
    frame = {"prediction": np.array([p for p, _ in pairs], dtype=object),
             "label": np.array([l for _, l in pairs], dtype=object)}
    for k in (3, 40):
        t = tpu_als_torch.RankingEvaluator(metricName=metric, k=k)
        j = JRankEval(metricName=metric, k=k)
        np.testing.assert_allclose(t.evaluate(frame), j.evaluate(frame),
                                   rtol=1e-12)
        assert t.isLargerBetter() and j.isLargerBetter()
    with pytest.raises(ValueError):
        tpu_als_torch.RankingEvaluator(metricName="bogus").evaluate(frame)
