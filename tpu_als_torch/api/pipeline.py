"""Pipeline composition and the string-id feature stages.

Counterpart of ``tpu_als/api/pipeline.py``: the recommender workflow of
``pyspark.ml`` chains ``StringIndexer`` stages (raw string ids -> dense
integer ids) into a ``Pipeline`` with the ALS estimator, cross-validates
the whole pipeline, and maps ids back with ``IndexToString``.

- ``Pipeline`` / ``PipelineModel``: ordered stages; fit folds the data
  through them (a transformer applies, an estimator fits and its model
  applies); transform applies every stage in order; both save and load.
- ``StringIndexer`` / ``StringIndexerModel`` / ``IndexToString``: a
  frequency- or alphabet-ordered vocabulary (four ``stringOrderType``
  values), ``handleInvalid`` in ``{'error', 'skip', 'keep'}`` ('keep'
  maps unseen values to ``len(labels)``), and the inverse mapping.

As in the reference, the indexer emits int64 indices (the ALS estimator
takes integer ids) and indexes values by their string form.  Stages
duck-type: anything with ``fit`` is an estimator, anything with
``transform`` a transformer.  Saves record the reference's class names
(:mod:`tpu_als_torch.api.classes`), so each package loads the other's.
"""

from __future__ import annotations

import json
import os

import numpy as np

from tpu_als_torch.api import classes
from tpu_als_torch.api.estimator import MLWriter, recover_interrupted_overwrite
from tpu_als_torch.api.params import Estimator, Params, TypeConverters
from tpu_als_torch.utils.frame import as_frame

_ORDER_TYPES = ("frequencyDesc", "frequencyAsc", "alphabetDesc",
                "alphabetAsc")
_INVALID_POLICIES = ("error", "skip", "keep")


class StringIndexer(Estimator):
    """Estimator mapping a column of arbitrary values to dense int64
    indices ordered by ``stringOrderType`` (reference default
    ``frequencyDesc``: most frequent value gets index 0; ties break
    alphabetically ascending so the fit is deterministic)."""

    def __init__(self, *, inputCol=None, outputCol=None,
                 handleInvalid="error", stringOrderType="frequencyDesc"):
        super().__init__()
        self._declareParam("inputCol", "input column name",
                           TypeConverters.toString)
        self._declareParam("outputCol", "output column name",
                           TypeConverters.toString)
        self._declareParam("handleInvalid",
                           "how to handle unseen labels at transform time: "
                           "'error', 'skip' (drop rows) or 'keep' (map to "
                           "index len(labels))",
                           TypeConverters.toString, default="error")
        self._declareParam("stringOrderType",
                           "label ordering: frequencyDesc | frequencyAsc | "
                           "alphabetDesc | alphabetAsc",
                           TypeConverters.toString, default="frequencyDesc")
        self.setParams(inputCol=inputCol, outputCol=outputCol,
                       handleInvalid=handleInvalid,
                       stringOrderType=stringOrderType)

    def setParams(self, **kwargs):
        self._set(**kwargs)
        for name in ("handleInvalid", "stringOrderType"):
            allowed = (_INVALID_POLICIES if name == "handleInvalid"
                       else _ORDER_TYPES)
            if self.isDefined(self.getParam(name)) and \
                    self.getOrDefault(self.getParam(name)) not in allowed:
                raise ValueError(
                    f"{name} must be one of {allowed}, got "
                    f"{self.getOrDefault(self.getParam(name))!r}")
        return self

    def _fit(self, dataset):
        df = as_frame(dataset)
        col = self.getOrDefault(self.getParam("inputCol"))
        if col not in df:
            raise ValueError(f"inputCol {col!r} not in {df.columns}")
        values = np.asarray(df[col]).astype(str)
        uniq, counts = np.unique(values, return_counts=True)
        order = self.getOrDefault(self.getParam("stringOrderType"))
        if order == "frequencyDesc":
            # np.unique returns uniq ascending; stable sort on -counts
            # keeps the alphabetical tiebreak
            idx = np.argsort(-counts, kind="stable")
        elif order == "frequencyAsc":
            idx = np.argsort(counts, kind="stable")
        elif order == "alphabetAsc":
            idx = np.arange(len(uniq))
        else:  # alphabetDesc
            idx = np.arange(len(uniq))[::-1]
        model = StringIndexerModel(labels=[str(v) for v in uniq[idx]])
        model._copy_config_from(self)
        return model

    # -- estimator persistence (DefaultParamsWritable parity) -----------
    def write(self):
        return MLWriter(self)

    def save(self, path):
        self.write().save(path)

    def _save_to(self, path):
        os.makedirs(path, exist_ok=True)
        payload = {
            "class": "tpu_als.api.pipeline.StringIndexer",
            "paramMap": {p.name: v for p, v in self._paramMap.items()},
        }
        tmp = os.path.join(path, "indexer.json.tmp")
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(path, "indexer.json"))

    @classmethod
    def load(cls, path):
        recover_interrupted_overwrite(path)
        with open(os.path.join(path, "indexer.json")) as f:
            meta = json.load(f)
        if meta.get("class") != "tpu_als.api.pipeline.StringIndexer":
            raise ValueError(f"{path} holds {meta.get('class')!r}, not a "
                             "StringIndexer")
        est = cls()
        est._set(**meta.get("paramMap", {}))
        return est


class StringIndexerModel(Params):
    """Fitted vocabulary: ``labels[i]`` is the value mapped to index i."""

    def __init__(self, *, labels=None, inputCol=None, outputCol=None,
                 handleInvalid="error"):
        super().__init__()
        self._declareParam("inputCol", "input column name",
                           TypeConverters.toString)
        self._declareParam("outputCol", "output column name",
                           TypeConverters.toString)
        self._declareParam("handleInvalid",
                           "'error' | 'skip' | 'keep'",
                           TypeConverters.toString, default="error")
        if handleInvalid not in _INVALID_POLICIES:
            raise ValueError(f"handleInvalid must be one of "
                             f"{_INVALID_POLICIES}, got {handleInvalid!r}")
        self.labels = list(labels or [])
        self._set(inputCol=inputCol, outputCol=outputCol,
                  handleInvalid=handleInvalid)

    @classmethod
    def from_labels(cls, labels, inputCol=None, outputCol=None,
                    handleInvalid="error"):
        """Reference's ``StringIndexerModel.from_labels``."""
        return cls(labels=labels, inputCol=inputCol, outputCol=outputCol,
                   handleInvalid=handleInvalid)

    def _copy_config_from(self, est):
        self._set(inputCol=est.getOrDefault(est.getParam("inputCol")),
                  outputCol=est.getOrDefault(est.getParam("outputCol")),
                  handleInvalid=est.getOrDefault(
                      est.getParam("handleInvalid")))

    def setHandleInvalid(self, value):
        if value not in _INVALID_POLICIES:
            raise ValueError(f"handleInvalid must be one of "
                             f"{_INVALID_POLICIES}, got {value!r}")
        return self._set(handleInvalid=value)

    def transform(self, dataset):
        df = as_frame(dataset)
        in_col = self.getOrDefault(self.getParam("inputCol"))
        out_col = self.getOrDefault(self.getParam("outputCol"))
        if in_col not in df:
            raise ValueError(f"inputCol {in_col!r} not in {df.columns}")
        values = np.asarray(df[in_col]).astype(str)
        lut = {v: i for i, v in enumerate(self.labels)}
        idx = np.fromiter((lut.get(v, -1) for v in values),
                          dtype=np.int64, count=len(values))
        unseen = idx < 0
        if unseen.any():
            policy = self.getOrDefault(self.getParam("handleInvalid"))
            if policy == "error":
                examples = sorted(set(values[unseen]))[:5]
                raise ValueError(
                    f"StringIndexerModel({out_col}): unseen labels "
                    f"{examples} (and possibly more); set "
                    "handleInvalid='skip' or 'keep' to accept them")
            if policy == "skip":
                df = df.filter(~unseen)
                idx = idx[~unseen]
            else:  # keep — the reference maps all unseen to one bucket
                idx = np.where(unseen, len(self.labels), idx)
        return df.withColumn(out_col, idx)

    # -- persistence ----------------------------------------------------
    def write(self):
        return MLWriter(self)

    def save(self, path):
        self.write().save(path)

    def _save_to(self, path):
        os.makedirs(path, exist_ok=True)
        payload = {
            "class": "tpu_als.api.pipeline.StringIndexerModel",
            "labels": self.labels,
            "paramMap": {p.name: v for p, v in self._paramMap.items()},
        }
        tmp = os.path.join(path, "indexer.json.tmp")
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(path, "indexer.json"))

    @classmethod
    def load(cls, path):
        recover_interrupted_overwrite(path)
        with open(os.path.join(path, "indexer.json")) as f:
            meta = json.load(f)
        if meta.get("class") != "tpu_als.api.pipeline.StringIndexerModel":
            raise ValueError(f"{path} holds {meta.get('class')!r}, not a "
                             "StringIndexerModel")
        m = cls(labels=meta["labels"])
        m._set(**meta.get("paramMap", {}))
        return m


class IndexToString(Params):
    """Inverse of ``StringIndexerModel``: int indices → original labels
    (reference ``pyspark.ml.feature.IndexToString``)."""

    def __init__(self, *, inputCol=None, outputCol=None, labels=None):
        super().__init__()
        self._declareParam("inputCol", "input column name",
                           TypeConverters.toString)
        self._declareParam("outputCol", "output column name",
                           TypeConverters.toString)
        self.labels = list(labels or [])
        self._set(inputCol=inputCol, outputCol=outputCol)

    # -- persistence (a pipeline ending in IndexToString must save) -----
    def write(self):
        return MLWriter(self)

    def save(self, path):
        self.write().save(path)

    def _save_to(self, path):
        os.makedirs(path, exist_ok=True)
        payload = {
            "class": "tpu_als.api.pipeline.IndexToString",
            "labels": self.labels,
            "paramMap": {p.name: v for p, v in self._paramMap.items()},
        }
        tmp = os.path.join(path, "index_to_string.json.tmp")
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(path, "index_to_string.json"))

    @classmethod
    def load(cls, path):
        recover_interrupted_overwrite(path)
        with open(os.path.join(path, "index_to_string.json")) as f:
            meta = json.load(f)
        if meta.get("class") != "tpu_als.api.pipeline.IndexToString":
            raise ValueError(f"{path} holds {meta.get('class')!r}, not an "
                             "IndexToString")
        t = cls(labels=meta["labels"])
        t._set(**meta.get("paramMap", {}))
        return t

    def transform(self, dataset):
        df = as_frame(dataset)
        in_col = self.getOrDefault(self.getParam("inputCol"))
        out_col = self.getOrDefault(self.getParam("outputCol"))
        if not self.labels:
            raise ValueError("IndexToString needs labels (pass labels= or "
                             "use StringIndexerModel.labels)")
        idx = np.asarray(df[in_col])
        if not np.issubdtype(idx.dtype, np.integer):
            if np.issubdtype(idx.dtype, np.floating) and \
                    np.all(np.isfinite(idx)) and np.all(idx == idx.astype(np.int64)):
                idx = idx.astype(np.int64)
            else:
                raise ValueError(
                    f"IndexToString inputCol {in_col!r} must hold integer "
                    f"indices, got dtype {idx.dtype}")
        if idx.size and (idx.min() < 0 or idx.max() >= len(self.labels)):
            raise ValueError(
                f"index out of range for {len(self.labels)} labels: "
                f"[{idx.min()}, {idx.max()}]")
        arr = np.asarray(self.labels, dtype=object)
        return df.withColumn(out_col, arr[idx])


class Pipeline(Estimator):
    """Ordered composition of transformers and estimators (reference
    ``pyspark.ml.Pipeline``).  ``fit`` folds the dataset through the
    stages: a transformer stage applies; an estimator stage fits on the
    current dataset and its model applies; the result is a
    ``PipelineModel`` of the materialized transformer chain."""

    def __init__(self, *, stages=None):
        super().__init__()
        self._declareParam("stages", "pipeline stages")
        if stages is not None:
            self.setStages(stages)

    def setStages(self, stages):
        stages = list(stages)
        for s in stages:
            if not (hasattr(s, "fit") or hasattr(s, "transform")):
                raise TypeError(
                    f"pipeline stage {s!r} is neither an estimator "
                    "(has .fit) nor a transformer (has .transform)")
        self._paramMap[self.getParam("stages")] = stages
        return self

    def getStages(self):
        return list(self.getOrDefault(self.getParam("stages")))

    def _fit(self, dataset):
        df = as_frame(dataset)
        stages = self.getStages()
        last_est = max((i for i, s in enumerate(stages)
                        if hasattr(s, "fit")), default=-1)
        fitted = []
        for i, stage in enumerate(stages):
            model = stage.fit(df) if hasattr(stage, "fit") else stage
            fitted.append(model)
            # nothing after the last estimator consumes the dataset
            # during fit — in particular the fitted model must not score
            # the whole training set just to feed discarded output
            if i < last_est:
                df = model.transform(df)
        return PipelineModel(fitted)

    def copy(self, extra=None):
        """Stage-aware copy: grid params (``extra`` keyed by Param) are
        routed to the stage that declares them — this is what lets a
        ``CrossValidator`` grid over ALS params drive a whole Pipeline
        (``estimator.copy(paramMap).fit`` in tuning.py).

        Routing prefers *instance* identity (``param.parent is stage`` —
        the reference's uid semantics): a grid built from ``als.rank``
        drives exactly the ``als`` stage even when a sibling stage has
        the same class.  Class+name routing is the fallback (grids built
        against a detached instance), but it REFUSES to fan one param
        out to multiple same-class stages — silently configuring both
        ``StringIndexer``s with one ``inputCol`` would corrupt the fit.
        """
        extra = extra or {}
        stages = self.getStages()
        per_stage = [dict() for _ in stages]
        for k, v in extra.items():
            if not hasattr(k, "name"):
                raise TypeError(f"expected Param keys in extra, got {k!r}")
            owner = [i for i, s in enumerate(stages)
                     if getattr(k, "parent", None) is s]
            if not owner:
                owner = [i for i, s in enumerate(stages)
                         if s.hasParam(k.name)
                         and type(k.parent) is type(s)]
            if not owner:
                raise ValueError(
                    f"grid param {k.name!r} (declared by "
                    f"{type(k.parent).__name__}) matches no pipeline "
                    "stage (params resolve by declaring instance, then "
                    "class + name)")
            if len(owner) > 1:
                raise ValueError(
                    f"grid param {k.name!r} matches "
                    f"{len(owner)} {type(k.parent).__name__} stages — "
                    "ambiguous; key the grid with the stage instance's "
                    "own Param (e.g. pipeline.getStages()[i].paramName)")
            per_stage[owner[0]][k] = v
        # copy every copyable stage, not only the ones given params: the
        # fitMultiple snapshot relies on copy() isolating later mutations
        # of the original stages; stages without copy() pass through
        return Pipeline(stages=[
            stage.copy(own or None) if hasattr(stage, "copy") else stage
            for stage, own in zip(stages, per_stage)])

    # -- persistence ----------------------------------------------------
    def write(self):
        return MLWriter(self)

    def save(self, path):
        self.write().save(path)

    def _save_to(self, path):
        _save_stages(path, "tpu_als.api.pipeline.Pipeline",
                     self.getStages())

    @classmethod
    def load(cls, path, device=None):
        """A pipeline saved by either package; ``device``: where its ALS
        stage fits (None -> the card)."""
        return cls(stages=_load_stages(
            path, "tpu_als.api.pipeline.Pipeline", device))


class PipelineModel:
    """Fitted pipeline: every stage is now a transformer; ``transform``
    applies them in order.  ``stages[i]`` exposes the fitted stage models
    (e.g. the ``ALSModel`` for ``recommendForAllUsers``)."""

    def __init__(self, stages):
        self.stages = list(stages)

    def transform(self, dataset):
        df = as_frame(dataset)
        for stage in self.stages:
            df = stage.transform(df)
        return df

    def write(self):
        return MLWriter(self)

    def save(self, path):
        self.write().save(path)

    def _save_to(self, path):
        _save_stages(path, "tpu_als.api.pipeline.PipelineModel",
                     self.stages)

    @classmethod
    def load(cls, path, device=None):
        """A fitted pipeline saved by either package; ``device``: where
        its ALSModel stage's factors go (None -> the card)."""
        return cls(stages=_load_stages(
            path, "tpu_als.api.pipeline.PipelineModel", device))


# -- shared stage persistence ---------------------------------------------

def _save_stages(path, class_path, stages):
    for s in stages:
        if not hasattr(s, "_save_to"):
            raise ValueError(
                f"pipeline stage {type(s).__name__} is not persistable "
                "(no _save_to); fit the pipeline or drop the stage "
                "before saving")
    # refuse before writing anything: a stage outside the table would
    # make a save that can never be read back
    names = [classes.saved_name(s) for s in stages]
    os.makedirs(path, exist_ok=True)
    meta = {"class": class_path, "stages": names}
    for i, s in enumerate(stages):
        s._save_to(os.path.join(path, f"stage_{i:02d}"))
    tmp = os.path.join(path, "pipeline.json.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    os.replace(tmp, os.path.join(path, "pipeline.json"))


def _load_stages(path, expect_class, device=None):
    recover_interrupted_overwrite(path)
    with open(os.path.join(path, "pipeline.json")) as f:
        meta = json.load(f)
    if meta.get("class") != expect_class:
        raise ValueError(f"{path} holds {meta.get('class')!r}, not "
                         f"{expect_class}")
    return [classes.load(name, os.path.join(path, f"stage_{i:02d}"),
                         device)
            for i, name in enumerate(meta["stages"])]
