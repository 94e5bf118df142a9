"""Hyper-parameter tuning: ParamGridBuilder, CrossValidator,
TrainValidationSplit.

Counterpart of ``tpu_als/api/tuning.py`` (``pyspark.ml.tuning``): a grid
keyed on Param objects, k-fold cross validation and a single
train/validation split, each fitting a copy of the estimator per param
map and scoring it with an evaluator, then refitting the best map on all
the data.  The folds (``default_rng(seed).integers(0, numFolds, n)``)
and the split (``ColumnarFrame.randomSplit``) are numpy draws, the
reference's row for row.  Every inner fit runs where the estimator was
told to (``estimator.copy`` keeps ``device``); each map's model is
dropped once scored, so a grid holds at most two sets of factors.
Saves record the reference's class names
(:mod:`tpu_als_torch.api.classes`), so each package loads the other's.
"""

from __future__ import annotations

import itertools
import json
import os

import numpy as np

from tpu_als_torch.api import classes
from tpu_als_torch.utils.frame import as_frame


def _save_tuned(model, path, metrics_payload):
    """The best model through its own save, then the metrics as JSON with
    the best model's saved class name, so that load restores its type."""
    best = model.bestModel
    model_class = classes.saved_name(best)
    os.makedirs(path, exist_ok=True)
    if hasattr(best, "write"):
        best.write().overwrite().save(os.path.join(path, "bestModel"))
    else:
        best.save(os.path.join(path, "bestModel"))
    metrics_payload["modelClass"] = model_class
    tmp = os.path.join(path, "tuning.json.tmp")
    with open(tmp, "w") as f:
        json.dump(metrics_payload, f)
    os.replace(tmp, os.path.join(path, "tuning.json"))


def _load_tuned(path, kind, device=None):
    with open(os.path.join(path, "tuning.json")) as f:
        meta = json.load(f)
    if meta.get("kind") != kind:
        raise ValueError(
            f"{path} holds a {meta.get('kind')!r} tuning save, not {kind!r}")
    # tuning.json may come from an untrusted directory: its class name is
    # looked up in the fixed table, never imported
    name = meta.get("modelClass", "tpu_als.api.estimator.ALSModel")
    best = classes.load(name, os.path.join(path, "bestModel"), device)
    return best, meta


class ParamGridBuilder:
    def __init__(self):
        self._grid = {}

    def addGrid(self, param, values):
        self._grid[param] = list(values)
        return self

    def baseOn(self, *args):
        base = {}
        for a in args:
            if isinstance(a, dict):
                base.update(a)
            else:
                k, v = a
                base[k] = v
        for k, v in base.items():
            self._grid[k] = [v]
        return self

    def build(self):
        keys = list(self._grid)
        combos = itertools.product(*(self._grid[k] for k in keys))
        return [dict(zip(keys, c)) for c in combos]


class _ValidatorBase:
    def __init__(self, estimator=None, estimatorParamMaps=None, evaluator=None,
                 seed=None):
        self.estimator = estimator
        self.estimatorParamMaps = estimatorParamMaps
        self.evaluator = evaluator
        self.seed = seed

    def _fit_score(self, train, val):
        scores = []
        for pm in self.estimatorParamMaps:
            model = self.estimator.copy(pm).fit(train)
            scores.append(self.evaluator.evaluate(model.transform(val)))
            del model  # its factors go before the next map's fit
        return scores

    def _best_index(self, avg):
        avg = np.asarray(avg)
        return int(np.nanargmax(avg) if self.evaluator.isLargerBetter()
                   else np.nanargmin(avg))


class CrossValidator(_ValidatorBase):
    """k-fold CV over the param grid; refits the best map on all data."""

    def __init__(self, estimator=None, estimatorParamMaps=None, evaluator=None,
                 numFolds=3, seed=None, collectSubModels=False):
        super().__init__(estimator, estimatorParamMaps, evaluator, seed)
        if numFolds < 2:
            raise ValueError("numFolds must be >= 2")
        self.numFolds = numFolds
        self.collectSubModels = collectSubModels

    def fit(self, dataset):
        frame = as_frame(dataset)
        rng = np.random.default_rng(self.seed)
        fold = rng.integers(0, self.numFolds, len(frame))
        metrics = np.zeros((len(self.estimatorParamMaps), self.numFolds))
        for f in range(self.numFolds):
            train = frame.filter(fold != f)
            val = frame.filter(fold == f)
            metrics[:, f] = self._fit_score(train, val)
        avg = metrics.mean(axis=1)
        best = self._best_index(avg)
        best_model = self.estimator.copy(self.estimatorParamMaps[best]).fit(frame)
        return CrossValidatorModel(best_model, avg.tolist(), metrics.tolist())


class CrossValidatorModel:
    def __init__(self, bestModel, avgMetrics, foldMetrics=None):
        self.bestModel = bestModel
        self.avgMetrics = avgMetrics
        self.foldMetrics = foldMetrics

    def transform(self, dataset):
        return self.bestModel.transform(dataset)

    def write(self):
        from tpu_als_torch.api.estimator import MLWriter

        return MLWriter(self)

    def save(self, path):
        self.write().save(path)

    def _save_to(self, path):
        _save_tuned(self, path, {"kind": "cv", "avgMetrics": self.avgMetrics,
                                 "foldMetrics": self.foldMetrics})

    @classmethod
    def load(cls, path, device=None):
        best, meta = _load_tuned(path, "cv", device)
        return cls(best, meta["avgMetrics"], meta.get("foldMetrics"))


class TrainValidationSplit(_ValidatorBase):
    """Single split tuning — ``trainRatio`` of the data trains, the rest
    validates; refits the best map on all data."""

    def __init__(self, estimator=None, estimatorParamMaps=None, evaluator=None,
                 trainRatio=0.75, seed=None):
        super().__init__(estimator, estimatorParamMaps, evaluator, seed)
        if not 0 < trainRatio < 1:
            raise ValueError("trainRatio must be in (0, 1)")
        self.trainRatio = trainRatio

    def fit(self, dataset):
        frame = as_frame(dataset)
        train, val = frame.randomSplit(
            [self.trainRatio, 1 - self.trainRatio], seed=self.seed)
        scores = self._fit_score(train, val)
        best = self._best_index(scores)
        best_model = self.estimator.copy(self.estimatorParamMaps[best]).fit(frame)
        return TrainValidationSplitModel(best_model, list(scores))


class TrainValidationSplitModel:
    def __init__(self, bestModel, validationMetrics):
        self.bestModel = bestModel
        self.validationMetrics = validationMetrics

    def transform(self, dataset):
        return self.bestModel.transform(dataset)

    def write(self):
        from tpu_als_torch.api.estimator import MLWriter

        return MLWriter(self)

    def save(self, path):
        self.write().save(path)

    def _save_to(self, path):
        _save_tuned(self, path,
                    {"kind": "tvs", "validationMetrics":
                     self.validationMetrics})

    @classmethod
    def load(cls, path, device=None):
        best, meta = _load_tuned(path, "tvs", device)
        return cls(best, meta["validationMetrics"])
