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
