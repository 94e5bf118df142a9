"""Parity of the port's legacy ``mllib`` API with ``tpu_als.api.legacy``.

Both packages start from the same injected init
(``tests/test_torch_tuning.py::inject_init``).  Bars: factors within
atol 5e-4 and rtol 5e-3 after 3 iterations (``tests/test_torch_train.py``);
predictions and recommendation scores within 5e-3 absolute (rank-3 dot
products of such factors); recommended ids equal wherever the
reference's consecutive scores are more than 1e-2 apart, and otherwise
each id earning its score.  Saves load in the other package, both ways.
"""

import numpy as np
import pytest

from tests.conftest import make_ratings
from tests.test_torch_tuning import inject_init
from tpu_als.api import legacy as jlegacy
from tpu_als_torch.api import legacy as tlegacy

ATOL, RTOL, SCORE_ATOL = 5e-4, 5e-3, 5e-3


def _ratings():
    u, i, r, _, _ = make_ratings(np.random.default_rng(4), 40, 25, rank=2,
                                 density=0.5)
    return [tlegacy.Rating(int(a), int(b), float(c))
            for a, b, c in zip(u, i, r)]


def _train(mod, implicit, **kw):
    fn = mod.ALS.trainImplicit if implicit else mod.ALS.train
    extra = {"alpha": 5.0} if implicit else {}
    return fn(_ratings(), rank=3, iterations=3, lambda_=0.05, seed=2,
              **extra, **kw)


def _features(rows):
    ids = np.array([i for i, _ in rows])
    return ids, np.stack([f for _, f in rows])


def _assert_recs(got, ref, model):
    """Lists of Rating: scores close, ids equal where the order is a fact
    (the reference's neighbouring scores more than 1e-2 apart), and every
    id earning its score from ``model``'s own factors."""
    assert len(got) == len(ref)
    gs = np.array([x.rating for x in got])
    rs = np.array([x.rating for x in ref])
    np.testing.assert_allclose(gs, rs, atol=SCORE_ATOL)
    assert list(gs) == sorted(gs, reverse=True)
    gap = np.r_[np.inf, np.abs(np.diff(rs)), np.inf]
    sep = (gap[:-1] > 1e-2) & (gap[1:] > 1e-2)
    for k in range(len(got)):
        if sep[k]:
            assert got[k][:2] == ref[k][:2]
        assert model.predict(got[k].user, got[k].product) == \
            pytest.approx(got[k].rating, abs=1e-5)


@pytest.mark.parametrize("implicit", [False, True])
def test_train_and_recommend_match_reference(monkeypatch, implicit):
    inject_init(monkeypatch)
    t = _train(tlegacy, implicit, device="cpu")
    j = _train(jlegacy, implicit)
    assert t.rank == j.rank == 3
    for got, ref in ((t.userFeatures(), j.userFeatures()),
                     (t.productFeatures(), j.productFeatures())):
        gi, gf = _features(got)
        ri, rf = _features(ref)
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_allclose(gf, rf, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(t.predict(3, 4), j.predict(3, 4),
                               atol=SCORE_ATOL)
    assert np.isnan(t.predict(999, 4)) and np.isnan(j.predict(999, 4))
    pairs = [(0, 1), (5, 7), (999, 1)]
    tp, jp = t.predictAll(pairs), j.predictAll(pairs)
    assert [x[:2] for x in tp] == [x[:2] for x in jp]
    np.testing.assert_allclose([x.rating for x in tp],
                               [x.rating for x in jp], atol=SCORE_ATOL,
                               equal_nan=True)
    _assert_recs(t.recommendProducts(3, 5), j.recommendProducts(3, 5), t)
    _assert_recs(t.recommendUsers(4, 6), j.recommendUsers(4, 6), t)
    tu, ju = t.recommendProductsForUsers(4), j.recommendProductsForUsers(4)
    assert [u for u, _ in tu] == [u for u, _ in ju]
    for (_, a), (_, b) in zip(tu, ju):
        _assert_recs(a, b, t)
    ti, ji = t.recommendUsersForProducts(3), j.recommendUsersForProducts(3)
    assert [p for p, _ in ti] == [p for p, _ in ji]
    for (_, a), (_, b) in zip(ti, ji):
        _assert_recs(a, b, t)
    for m in (t, j):
        with pytest.raises(ValueError, match="not in the model"):
            m.recommendProducts(999, 3)
        with pytest.raises(ValueError, match="not in the model"):
            m.recommendUsers(999, 3)


def test_saves_load_in_both_packages(monkeypatch, tmp_path):
    inject_init(monkeypatch)
    t = _train(tlegacy, False, device="cpu")
    j = _train(jlegacy, False)
    t.save(str(tmp_path / "t"))
    j.save(str(tmp_path / "j"))
    jt = jlegacy.MatrixFactorizationModel.load(str(tmp_path / "t"))
    tj = tlegacy.MatrixFactorizationModel.load(str(tmp_path / "j"),
                                               device="cpu")
    for a, b in ((jt, t), (tj, j)):
        for x, y in zip(_features(a.userFeatures()),
                        _features(b.userFeatures())):
            np.testing.assert_array_equal(x, y)
        assert a.predict(3, 4) == pytest.approx(b.predict(3, 4), rel=1e-6)
    assert tj._model.device.type == "cpu"
