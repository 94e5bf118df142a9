"""The legacy RDD-style API: ``ALS.train`` and ``MatrixFactorizationModel``.

Counterpart of ``tpu_als/api/legacy.py`` (``pyspark.mllib.recommendation``):
the functional ``train``/``trainImplicit`` entry points, the ``Rating``
tuple and the ``MatrixFactorizationModel`` methods, delegating to the
port's :class:`~tpu_als_torch.api.estimator.ALS`.  Like every entry point
of the port they run on the card unless ``device='cpu'`` is passed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from tpu_als_torch.api.estimator import ALS as _ALS, ALSModel
from tpu_als_torch.utils.frame import ColumnarFrame


class Rating(NamedTuple):
    user: int
    product: int
    rating: float


def _to_frame(ratings):
    arr = [Rating(int(u), int(p), float(r)) for (u, p, r) in ratings]
    return ColumnarFrame({
        "user": np.asarray([a.user for a in arr], dtype=np.int64),
        "product": np.asarray([a.product for a in arr], dtype=np.int64),
        "rating": np.asarray([a.rating for a in arr], dtype=np.float32),
    })


class MatrixFactorizationModel:
    """Wraps the fitted factors with the legacy method names."""

    def __init__(self, model: ALSModel):
        self._model = model
        self.rank = model.rank

    # -- prediction -----------------------------------------------------
    def predict(self, user, product):
        return self._model.predict(user, product)

    def predictAll(self, user_product):
        """[(user, product)] -> [Rating] (prediction as the rating)."""
        pairs = list(user_product)
        frame = ColumnarFrame({
            "user": np.asarray([u for u, _ in pairs], dtype=np.int64),
            "product": np.asarray([p for _, p in pairs], dtype=np.int64),
        })
        out = self._model.transform(frame)
        return [
            Rating(int(u), int(p), float(s))
            for u, p, s in zip(out["user"], out["product"], out["prediction"])
        ]

    # -- recommendation -------------------------------------------------
    def recommendProducts(self, user, num):
        frame = ColumnarFrame({"user": np.asarray([user])})
        recs = self._model.recommendForUserSubset(frame, num)
        if len(recs) == 0:
            raise ValueError(f"user {user} not in the model")
        return [Rating(int(user), int(p), float(s))
                for p, s in recs["recommendations"][0]]

    def recommendUsers(self, product, num):
        frame = ColumnarFrame({"product": np.asarray([product])})
        recs = self._model.recommendForItemSubset(frame, num)
        if len(recs) == 0:
            raise ValueError(f"product {product} not in the model")
        return [Rating(int(u), int(product), float(s))
                for u, s in recs["recommendations"][0]]

    def recommendProductsForUsers(self, num):
        recs = self._model.recommendForAllUsers(num)
        return [
            (int(u), [Rating(int(u), int(p), float(s)) for p, s in rs])
            for u, rs in zip(recs[recs.columns[0]], recs["recommendations"])
        ]

    def recommendUsersForProducts(self, num):
        recs = self._model.recommendForAllItems(num)
        return [
            (int(p), [Rating(int(u), int(p), float(s)) for u, s in rs])
            for p, rs in zip(recs[recs.columns[0]], recs["recommendations"])
        ]

    # -- factor access ---------------------------------------------------
    def userFeatures(self):
        uf = self._model.userFactors
        return [(int(i), np.asarray(f)) for i, f in zip(uf["id"], uf["features"])]

    def productFeatures(self):
        itf = self._model.itemFactors
        return [(int(i), np.asarray(f)) for i, f in zip(itf["id"], itf["features"])]

    # -- persistence ------------------------------------------------------
    def save(self, path):
        self._model.save(path)

    @classmethod
    def load(cls, path, device=None):
        return cls(ALSModel.load(path, device=device))


class ALS:
    """Legacy functional entry points (``pyspark.mllib.recommendation.ALS``)."""

    @classmethod
    def train(cls, ratings, rank, iterations=5, lambda_=0.01, blocks=-1,
              nonnegative=False, seed=None, device=None):
        est = _ALS(
            rank=rank, maxIter=iterations, regParam=lambda_,
            nonnegative=nonnegative, seed=seed if seed is not None else 0,
            userCol="user", itemCol="product", ratingCol="rating",
            device=device,
        )
        if blocks > 0:
            est.setNumUserBlocks(blocks).setNumItemBlocks(blocks)
        return MatrixFactorizationModel(est.fit(_to_frame(ratings)))

    @classmethod
    def trainImplicit(cls, ratings, rank, iterations=5, lambda_=0.01,
                      blocks=-1, alpha=0.01, nonnegative=False, seed=None,
                      device=None):
        est = _ALS(
            rank=rank, maxIter=iterations, regParam=lambda_, alpha=alpha,
            implicitPrefs=True, nonnegative=nonnegative,
            seed=seed if seed is not None else 0,
            userCol="user", itemCol="product", ratingCol="rating",
            device=device,
        )
        if blocks > 0:
            est.setNumUserBlocks(blocks).setNumItemBlocks(blocks)
        return MatrixFactorizationModel(est.fit(_to_frame(ratings)))
