"""Evaluators: regression metrics and ranking metrics.

Counterpart of ``tpu_als/api/evaluation.py`` (an own copy): the
``pyspark.ml.evaluation.RegressionEvaluator`` surface (rmse, mse, mae,
r2, var; NaN predictions excluded, as after
``coldStartStrategy='drop'``), the legacy ``RegressionMetrics``, the
``pyspark.mllib.evaluation.RankingMetrics`` (precision@k, recall@k, MAP,
MAP@k, NDCG@k) and ``pyspark.ml.evaluation.RankingEvaluator``.  Plain
numpy on the host — these run once per evaluation.
"""

from __future__ import annotations

import numpy as np

from tpu_als_torch.api.params import Params, TypeConverters
from tpu_als_torch.utils.frame import as_frame


class RegressionEvaluator(Params):
    """rmse (default) | mse | mae | r2 | var, NaN predictions excluded the
    way the reference evaluator sees them after coldStartStrategy='drop'."""

    def __init__(self, **kwargs):
        super().__init__()
        self._declareParam("predictionCol", "prediction column",
                           TypeConverters.toString, "prediction")
        self._declareParam("labelCol", "label column",
                           TypeConverters.toString, "label")
        self._declareParam("metricName", "rmse|mse|mae|r2|var",
                           TypeConverters.toString, "rmse")
        self._declareParam("throughOrigin", "r2 through origin",
                           TypeConverters.toBoolean, False)
        self._set(**kwargs)

    def setParams(self, **kwargs):
        return self._set(**kwargs)

    def evaluate(self, dataset, params=None):
        if params:
            return self.copy(params).evaluate(dataset)
        frame = as_frame(dataset)
        pred = np.asarray(frame[self.getOrDefault("predictionCol")], np.float64)
        label = np.asarray(frame[self.getOrDefault("labelCol")], np.float64)
        ok = ~(np.isnan(pred) | np.isnan(label))
        pred, label = pred[ok], label[ok]
        if len(pred) == 0:
            return float("nan")
        err = pred - label
        metric = self.getOrDefault("metricName")
        if metric == "rmse":
            return float(np.sqrt(np.mean(err**2)))
        if metric == "mse":
            return float(np.mean(err**2))
        if metric == "mae":
            return float(np.mean(np.abs(err)))
        if metric == "r2":
            if self.getOrDefault("throughOrigin"):
                ss_tot = np.sum(label**2)
            else:
                ss_tot = np.sum((label - label.mean()) ** 2)
            return float(1.0 - np.sum(err**2) / ss_tot)
        if metric == "var":
            return float(np.var(err))
        raise ValueError(f"unknown metricName {metric!r}")

    def isLargerBetter(self):
        return self.getOrDefault("metricName") in ("r2",)


class RegressionMetrics:
    """Legacy ``pyspark.mllib.evaluation.RegressionMetrics`` surface:
    constructed from (prediction, observation) pairs, exposing the five
    metric properties (canonical upstream
    ``mllib/.../evaluation/RegressionMetrics.scala`` — SURVEY.md §2.B7).
    The DataFrame-era equivalent is :class:`RegressionEvaluator`."""

    def __init__(self, pred_and_obs):
        arr = np.asarray([(float(p), float(o)) for p, o in pred_and_obs],
                         dtype=np.float64)
        if arr.size == 0:
            raise ValueError("RegressionMetrics needs at least one "
                             "(prediction, observation) pair")
        self._pred = arr[:, 0]
        self._obs = arr[:, 1]

    @property
    def meanSquaredError(self):
        return float(np.mean((self._pred - self._obs) ** 2))

    @property
    def rootMeanSquaredError(self):
        return float(np.sqrt(self.meanSquaredError))

    @property
    def meanAbsoluteError(self):
        return float(np.mean(np.abs(self._pred - self._obs)))

    @property
    def r2(self):
        ss_res = float(np.sum((self._obs - self._pred) ** 2))
        ss_tot = float(np.sum((self._obs - np.mean(self._obs)) ** 2))
        return 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0

    @property
    def explainedVariance(self):
        # reference semantics: SSreg/n = E[(pred - E[obs])^2] (the
        # mllib summarizer's definition — always >= 0), NOT the
        # var(obs) - var(residuals) form, which coincides only for
        # unbiased OLS-style fits
        return float(np.mean((self._pred - np.mean(self._obs)) ** 2))


class RankingMetrics:
    """Ranking quality over (predicted ranking, ground-truth set) pairs.

    ``pred_and_labels``: iterable of (predicted_ids_in_rank_order,
    relevant_ids) — the exact input shape of the reference's
    ``mllib.evaluation.RankingMetrics`` (SURVEY.md §4 'Ranking metrics').
    """

    def __init__(self, pred_and_labels):
        self._pairs = [
            (list(p), set(l)) for p, l in pred_and_labels  # noqa: E741
        ]

    def precisionAt(self, k):
        if k <= 0:
            raise ValueError("k must be > 0")
        vals = []
        for pred, rel in self._pairs:
            if not rel:
                vals.append(0.0)
                continue
            topk = pred[:k]
            vals.append(sum(1 for p in topk if p in rel) / k)
        return float(np.mean(vals)) if vals else 0.0

    def recallAt(self, k):
        if k <= 0:
            raise ValueError("k must be > 0")
        vals = []
        for pred, rel in self._pairs:
            if not rel:
                vals.append(0.0)
                continue
            topk = pred[:k]
            vals.append(sum(1 for p in topk if p in rel) / len(rel))
        return float(np.mean(vals)) if vals else 0.0

    @property
    def meanAveragePrecision(self):
        return self._map(None)

    def meanAveragePrecisionAt(self, k):
        return self._map(k)

    def _map(self, k):
        vals = []
        for pred, rel in self._pairs:
            if not rel:
                vals.append(0.0)
                continue
            cut = pred if k is None else pred[:k]
            hits, s = 0, 0.0
            for rank, p in enumerate(cut, start=1):
                if p in rel:
                    hits += 1
                    s += hits / rank
            denom = len(rel) if k is None else min(len(rel), k)
            vals.append(s / denom)
        return float(np.mean(vals)) if vals else 0.0

    def ndcgAt(self, k):
        if k <= 0:
            raise ValueError("k must be > 0")
        vals = []
        for pred, rel in self._pairs:
            if not rel:
                vals.append(0.0)
                continue
            dcg = sum(
                1.0 / np.log2(rank + 1)
                for rank, p in enumerate(pred[:k], start=1) if p in rel
            )
            ideal = sum(
                1.0 / np.log2(rank + 1)
                for rank in range(1, min(len(rel), k) + 1)
            )
            vals.append(dcg / ideal)
        return float(np.mean(vals)) if vals else 0.0


class RankingEvaluator(Params):
    """DataFrame-style wrapper over RankingMetrics, like
    ``pyspark.ml.evaluation.RankingEvaluator``: expects a prediction column
    of id arrays (rank order) and a label column of relevant-id arrays."""

    def __init__(self, **kwargs):
        super().__init__()
        self._declareParam("predictionCol", "ranked prediction id arrays",
                           TypeConverters.toString, "prediction")
        self._declareParam("labelCol", "relevant id arrays",
                           TypeConverters.toString, "label")
        self._declareParam(
            "metricName",
            "meanAveragePrecision|meanAveragePrecisionAtK|precisionAtK|"
            "ndcgAtK|recallAtK", TypeConverters.toString,
            "meanAveragePrecision")
        self._declareParam("k", "cutoff for @K metrics",
                           TypeConverters.toInt, 10)
        self._set(**kwargs)

    def evaluate(self, dataset, params=None):
        if params:
            return self.copy(params).evaluate(dataset)
        frame = as_frame(dataset)
        pairs = list(zip(frame[self.getOrDefault("predictionCol")],
                         frame[self.getOrDefault("labelCol")]))
        m = RankingMetrics(pairs)
        k = self.getOrDefault("k")
        name = self.getOrDefault("metricName")
        if name == "meanAveragePrecision":
            return m.meanAveragePrecision
        if name == "meanAveragePrecisionAtK":
            return m.meanAveragePrecisionAt(k)
        if name == "precisionAtK":
            return m.precisionAt(k)
        if name == "ndcgAtK":
            return m.ndcgAt(k)
        if name == "recallAtK":
            return m.recallAt(k)
        raise ValueError(f"unknown metricName {name!r}")

    def isLargerBetter(self):
        return True
