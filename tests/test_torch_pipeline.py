"""Parity of the port's pipeline stages with ``tpu_als``.

``StringIndexer``, ``StringIndexerModel`` and ``IndexToString`` are numpy
on the host: labels, indices and errors must be exact.  A ``Pipeline``
with an ALS stage starts both packages from the same injected init
(``tests/test_torch_tuning.py::inject_init``) and holds the factors to
``tests/test_torch_train.py``'s band (atol 5e-4, rtol 5e-3 after 3
iterations) and the predictions to 5e-3 absolute (a rank-3 dot product
of factors within that band).  Every save loads in the other package,
both ways.
"""

import json

import numpy as np
import pytest

import tpu_als
import tpu_als_torch
from tests.test_torch_tuning import (assert_models_close, factors,
                                     inject_init)
from tpu_als_torch.utils.frame import ColumnarFrame

ORDERS = ("frequencyDesc", "frequencyAsc", "alphabetDesc", "alphabetAsc")


def _strings():
    rng = np.random.default_rng(2)
    # ties in frequency ('b' and 'd' twice each) exercise the tiebreak
    vals = np.array(list("aaabbcddeeeef"), dtype=object)
    return {"name": rng.permutation(vals),
            "n": np.arange(len(vals)) % 4}


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("col", ["name", "n"])
def test_string_indexer_labels_match_reference(order, col):
    kw = dict(inputCol=col, outputCol="idx", stringOrderType=order)
    t = tpu_als_torch.StringIndexer(**kw).fit(_strings())
    j = tpu_als.StringIndexer(**kw).fit(_strings())
    assert t.labels == j.labels
    out_t, out_j = t.transform(_strings()), j.transform(_strings())
    np.testing.assert_array_equal(out_t["idx"], out_j["idx"])
    assert out_t["idx"].dtype == np.int64
    back = tpu_als_torch.IndexToString(inputCol="idx", outputCol="back",
                                       labels=t.labels).transform(out_t)
    assert [str(v) for v in back["back"]] == [str(v) for v in _strings()[col]]


@pytest.mark.parametrize("policy", ["error", "skip", "keep"])
def test_handle_invalid_matches_reference(policy):
    unseen = {"name": np.array(["a", "zz", "b", "yy"], dtype=object)}
    t = tpu_als_torch.StringIndexer(inputCol="name", outputCol="idx",
                                    handleInvalid=policy).fit(_strings())
    j = tpu_als.StringIndexer(inputCol="name", outputCol="idx",
                              handleInvalid=policy).fit(_strings())
    if policy == "error":
        with pytest.raises(ValueError, match="unseen labels"):
            t.transform(unseen)
        with pytest.raises(ValueError, match="unseen labels"):
            j.transform(unseen)
        return
    out_t, out_j = t.transform(unseen), j.transform(unseen)
    np.testing.assert_array_equal(out_t["idx"], out_j["idx"])
    np.testing.assert_array_equal(out_t["name"], out_j["name"])
    # the model's own setter switches the policy as the reference's does
    assert len(t.setHandleInvalid("skip").transform(unseen)) == 2


def test_stage_errors_match_reference():
    for pkg in (tpu_als_torch, tpu_als):
        with pytest.raises(ValueError):
            pkg.StringIndexer(inputCol="x", stringOrderType="bogus")
        with pytest.raises(ValueError):
            pkg.StringIndexerModel(labels=["a"], handleInvalid="bogus")
        its = pkg.IndexToString(inputCol="i", outputCol="s", labels=["a"])
        with pytest.raises(ValueError, match="out of range"):
            its.transform({"i": np.array([0, 1])})
        with pytest.raises(ValueError, match="integer"):
            its.transform({"i": np.array([0.5])})
        assert list(its.transform({"i": np.array([0.0])})["s"]) == ["a"]
        with pytest.raises(TypeError):
            pkg.Pipeline(stages=[object()])


def _string_frame():
    rng = np.random.default_rng(9)
    n = 2000
    u = rng.integers(0, 90, n)
    i = rng.integers(0, 40, n)
    r = (rng.integers(1, 11, n) * 0.5).astype(np.float32)
    return {"userName": np.array([f"u{k:03d}" for k in u], dtype=object),
            "movie": np.array([f"m{k:03d}" for k in i], dtype=object),
            "rating": r}


def _pipeline(pkg, **als_kw):
    als = pkg.ALS(userCol="user", itemCol="item", rank=3, maxIter=3,
                  regParam=0.05, seed=1, coldStartStrategy="drop",
                  **als_kw)
    pipe = pkg.Pipeline(stages=[
        pkg.StringIndexer(inputCol="userName", outputCol="user",
                          handleInvalid="skip"),
        pkg.StringIndexer(inputCol="movie", outputCol="item",
                          handleInvalid="skip"),
        als])
    return pipe, als


def test_pipeline_fit_transform_and_cv_match_reference(monkeypatch):
    inject_init(monkeypatch)
    frame = _string_frame()
    tpipe, tals = _pipeline(tpu_als_torch, device="cpu")
    jpipe, jals = _pipeline(tpu_als)
    tm, jm = tpipe.fit(frame), jpipe.fit(frame)
    assert [s.labels for s in tm.stages[:2]] == \
        [s.labels for s in jm.stages[:2]]
    assert_models_close(tm.stages[2], jm.stages[2])
    probe = dict(frame)
    probe["userName"] = np.append(frame["userName"][:-1], "never-seen")
    to, jo = tm.transform(probe), jm.transform(probe)
    assert len(to) == len(jo) == len(frame["rating"]) - 1
    np.testing.assert_allclose(to["prediction"], jo["prediction"],
                               atol=5e-3)
    # the examples/02 workflow: a CrossValidator over the pipeline, the
    # grid keyed on the ALS stage's own params
    tgrid = tpu_als_torch.ParamGridBuilder().addGrid(
        tals.regParam, [0.01, 1.0]).build()
    jgrid = tpu_als.ParamGridBuilder().addGrid(
        jals.regParam, [0.01, 1.0]).build()
    tcv = tpu_als_torch.CrossValidator(
        estimator=tpipe, estimatorParamMaps=tgrid, numFolds=2, seed=3,
        evaluator=tpu_als_torch.RegressionEvaluator(labelCol="rating"))
    jcv = tpu_als.CrossValidator(
        estimator=jpipe, estimatorParamMaps=jgrid, numFolds=2, seed=3,
        evaluator=tpu_als.RegressionEvaluator(labelCol="rating"))
    tcvm, jcvm = tcv.fit(frame), jcv.fit(frame)
    np.testing.assert_allclose(tcvm.foldMetrics, jcvm.foldMetrics,
                               rtol=1e-4)
    assert abs(jcvm.avgMetrics[0] - jcvm.avgMetrics[1]) > 1e-2
    assert np.argmin(tcvm.avgMetrics) == np.argmin(jcvm.avgMetrics)
    assert isinstance(tcvm.bestModel, tpu_als_torch.PipelineModel)
    assert_models_close(tcvm.bestModel.stages[2], jcvm.bestModel.stages[2])


def test_pipeline_copy_routes_params_by_stage():
    pipe, als = _pipeline(tpu_als_torch, device="cpu")
    c = pipe.copy({als.rank: 7})
    assert c.getStages()[2].getRank() == 7 and als.getRank() == 3
    assert c.getStages()[2].device == "cpu"
    # a detached instance's param routes by class + name
    other = tpu_als_torch.ALS()
    assert pipe.copy({other.maxIter: 9}).getStages()[2].getMaxIter() == 9
    # one StringIndexer param fanned out to two stages is ambiguous
    with pytest.raises(ValueError, match="ambiguous"):
        pipe.copy({tpu_als_torch.StringIndexer().inputCol: "x"})


def _save(obj, path):
    obj.save(str(path))
    return str(path)


def test_every_save_loads_in_the_other_package(monkeypatch, tmp_path):
    """Estimators, transformers, the fitted and the unfitted pipeline: a
    save of each package loads in the other with the same content, and
    records the reference's class names."""
    inject_init(monkeypatch)
    frame = _string_frame()
    out = {}
    for tag, pkg, kw in (("t", tpu_als_torch, {"device": "cpu"}),
                         ("j", tpu_als, {})):
        pipe, als = _pipeline(pkg, **kw)
        model = pipe.fit(frame)
        out[tag] = {
            "pipe": (pipe, _save(pipe, tmp_path / f"{tag}_pipe")),
            "model": (model, _save(model, tmp_path / f"{tag}_model")),
            "als": (als, _save(als, tmp_path / f"{tag}_als")),
            "its": (pkg.IndexToString(inputCol="item", outputCol="m",
                                      labels=model.stages[1].labels),
                    None),
        }
        out[tag]["its"] = (out[tag]["its"][0],
                           _save(out[tag]["its"][0], tmp_path / f"{tag}_its"))
    meta = json.loads((tmp_path / "t_model" / "pipeline.json").read_text())
    assert meta == json.loads(
        (tmp_path / "j_model" / "pipeline.json").read_text())
    assert meta["stages"][2] == "tpu_als.api.estimator.ALSModel"
    for src, dst, load_kw in (("t", tpu_als, {}),
                              ("j", tpu_als_torch, {"device": "cpu"})):
        pipe, ppath = out[src]["pipe"]
        back = dst.Pipeline.load(ppath, **load_kw)
        assert [type(s).__name__ for s in back.getStages()] == \
            ["StringIndexer", "StringIndexer", "ALS"]
        assert back.getStages()[2].getRank() == 3
        assert back.getStages()[0].getOrDefault("handleInvalid") == "skip"
        model, mpath = out[src]["model"]
        mback = dst.PipelineModel.load(mpath, **load_kw)
        assert [s.labels for s in mback.stages[:2]] == \
            [s.labels for s in model.stages[:2]]
        for x, y in zip(factors(mback.stages[2]), factors(model.stages[2])):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(
            mback.transform(frame)["prediction"],
            model.transform(frame)["prediction"])
        als, apath = out[src]["als"]
        aback = dst.ALS.load(apath, **load_kw)
        assert {p.name: v for p, v in aback.extractParamMap().items()} == \
            {p.name: v for p, v in als.extractParamMap().items()}
        its, ipath = out[src]["its"]
        assert dst.IndexToString.load(ipath).labels == its.labels
        # an unfitted StringIndexer and a fitted one on their own
        si = pipe.getStages()[0]
        sback = dst.StringIndexer.load(_save(si, tmp_path / f"{src}_si"))
        assert sback.getOrDefault("inputCol") == "userName"
        sm = model.stages[0]
        smback = dst.StringIndexerModel.load(
            _save(sm, tmp_path / f"{src}_sm"))
        assert smback.labels == sm.labels
    # the port's ALS.load hands its fits to the given device
    assert tpu_als_torch.ALS.load(out["j"]["als"][1], device="cpu") \
        .device == "cpu"


def test_stage_outside_the_table_is_refused(tmp_path):
    class Own:
        def transform(self, df):
            return df

        def _save_to(self, path):
            raise AssertionError("never reached")

    with pytest.raises(ValueError, match="no saved name"):
        tpu_als_torch.PipelineModel([Own()]).save(str(tmp_path / "p"))
    p = tmp_path / "q"
    p.mkdir()
    (p / "pipeline.json").write_text(json.dumps(
        {"class": "tpu_als.api.pipeline.PipelineModel",
         "stages": ["os.system"]}))
    with pytest.raises(ValueError, match="refusing to load"):
        tpu_als_torch.PipelineModel.load(str(p), device="cpu")


def test_frame_helpers_keep_the_reference_contract():
    f = ColumnarFrame(_strings())
    assert len(f.filter(np.asarray(f["n"]) > 0)) == 9


def test_frame_count_matches_reference():
    """Spark's ``df.count()``: the reference aliases ``__len__``."""
    from tpu_als.utils.frame import ColumnarFrame as JFrame

    data = _strings()
    for n in (len(data["n"]), 0):
        sub = {k: v[:n] for k, v in data.items()}
        assert ColumnarFrame(sub).count() == JFrame(sub).count() == n
