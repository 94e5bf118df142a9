"""ALSModel — the fitted-model surface of the reference, in PyTorch.

Counterpart of ``tpu_als/api/estimator.py::ALSModel`` (itself mirroring
``pyspark.ml.recommendation.ALSModel``): the same column names, the same
structured ``recommendations`` dtype, the same ``coldStartStrategy``
semantics, ``save``/``load`` in the shared checkpoint format, and the
settable serving-time params.  The factor tables are float32 tensors on
the model's device; id maps stay numpy.  Sharded serving (``mesh=``) and
the ``ALS`` estimator (``fit``) belong to later slices.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from tpu_als_torch.core.als import predict as _predict
from tpu_als_torch.core.ratings import IdMap
from tpu_als_torch.io.checkpoint import load_factors, save_factors
from tpu_als_torch.ops.cuda_topk import topk_scores
from tpu_als_torch.utils.frame import ColumnarFrame, as_frame
from tpu_als_torch.utils.platform import resolve_device


def recover_interrupted_overwrite(path):
    """If an overwrite-save crashed between its two renames, ``path`` is
    missing but the old save sits complete at ``path + '.overwritten.tmp'``
    — move it back."""
    aside = path.rstrip("/\\") + ".overwritten.tmp"
    if not os.path.exists(path) and os.path.exists(aside):
        os.rename(aside, path)


class MLWriter:
    """``model.write().overwrite().save(path)``; without ``overwrite()``
    saving onto an existing path raises, as in the reference."""

    def __init__(self, instance):
        self._instance = instance
        self._shouldOverwrite = False

    def overwrite(self):
        self._shouldOverwrite = True
        return self

    def save(self, path):
        recover_interrupted_overwrite(path)
        if not os.path.exists(path):
            self._instance._save_to(path)
            return
        if not self._shouldOverwrite:
            raise IOError(f"path {path} already exists; use "
                          ".write().overwrite().save(path) to replace it")
        # write the new save beside the old one first, then swap: a failed
        # write leaves the old save untouched
        base = path.rstrip("/\\")
        fresh, aside = base + ".new.tmp", base + ".overwritten.tmp"
        for tmp in (fresh, aside):
            if os.path.exists(tmp):
                shutil.rmtree(tmp, ignore_errors=True)
        try:
            self._instance._save_to(fresh)
        except BaseException:
            shutil.rmtree(fresh, ignore_errors=True)
            raise
        os.rename(path, aside)
        os.rename(fresh, path)
        shutil.rmtree(aside, ignore_errors=True)


class ALSModel:
    """Fitted model: factor tables on a device + original-id maps."""

    # the serving-time knobs transform/recommend* read at call time
    _MODEL_PARAMS = ("userCol", "itemCol", "predictionCol",
                     "coldStartStrategy", "blockSize")
    # scoring chunk for transform: bounds the per-call gather
    _TRANSFORM_CHUNK = 1 << 20

    def __init__(self, rank, user_map, item_map, user_factors, item_factors,
                 params, device=None):
        self.device = resolve_device(device)
        self.rank = rank
        self._user_map = user_map
        self._item_map = item_map
        self._U = torch.as_tensor(np.asarray(user_factors, np.float32)) \
            .to(self.device)
        self._V = torch.as_tensor(np.asarray(item_factors, np.float32)) \
            .to(self.device)
        self._params = dict(params)

    def _get(self, name):
        return self._params[name]

    def _set(self, **kwargs):
        for name, v in kwargs.items():
            if name not in self._MODEL_PARAMS:
                raise TypeError(
                    f"{name!r} is not a settable model param "
                    f"(settable: {list(self._MODEL_PARAMS)})")
            if name == "coldStartStrategy" and v not in ("nan", "drop"):
                raise ValueError(
                    "coldStartStrategy must be 'nan' or 'drop'")
            self._params[name] = v
        return self

    # -- prediction ----------------------------------------------------
    def transform(self, dataset):
        frame = as_frame(dataset)
        u = self._user_map.to_dense(frame[self._get("userCol")])
        i = self._item_map.to_dense(frame[self._get("itemCol")])
        preds = np.empty(len(u), dtype=np.float32)
        for s in range(0, len(u), self._TRANSFORM_CHUNK):
            ub = torch.from_numpy(u[s:s + self._TRANSFORM_CHUNK]) \
                .to(self.device)
            ib = torch.from_numpy(i[s:s + self._TRANSFORM_CHUNK]) \
                .to(self.device)
            preds[s:s + len(ub)] = _predict(
                self._U, self._V, ub, ib, ub >= 0, ib >= 0).cpu().numpy()
        out = frame.withColumn(self._get("predictionCol"), preds)
        if self._get("coldStartStrategy") == "drop":
            out = out.filter(~np.isnan(preds))
        return out

    def predict(self, user, item):
        """Scalar prediction for one (user, item) pair."""
        out = self.transform(ColumnarFrame({
            self._get("userCol"): np.asarray([user]),
            self._get("itemCol"): np.asarray([item]),
        }))
        return (float(out[self._get("predictionCol")][0]) if len(out)
                else float("nan"))

    # -- top-k recommendation ------------------------------------------
    def recommendForAllUsers(self, numItems):
        return self._recommend(self._U, self._user_map.ids, numItems,
                               users=True)

    def recommendForAllItems(self, numUsers):
        return self._recommend(self._V, self._item_map.ids, numUsers,
                               users=False)

    def recommendForUserSubset(self, dataset, numItems):
        ids = np.unique(as_frame(dataset)[self._get("userCol")])
        dense = self._user_map.to_dense(ids)
        keep = dense >= 0
        rows = torch.from_numpy(dense[keep]).to(self.device)
        return self._recommend(self._U[rows], ids[keep], numItems,
                               users=True)

    def recommendForItemSubset(self, dataset, numUsers):
        ids = np.unique(as_frame(dataset)[self._get("itemCol")])
        dense = self._item_map.to_dense(ids)
        keep = dense >= 0
        rows = torch.from_numpy(dense[keep]).to(self.device)
        return self._recommend(self._V[rows], ids[keep], numUsers,
                               users=False)

    def _recommend(self, Q, q_ids, k, users):
        """Top-k for the query rows ``Q``, ``blockSize`` rows per call."""
        other = self._V if users else self._U
        other_ids = self._item_map.ids if users else self._user_map.ids
        other_col = self._get("itemCol") if users else self._get("userCol")
        if other_col == "rating":
            raise ValueError(
                f"{'itemCol' if users else 'userCol'}='rating' collides "
                "with the fixed 'rating' score field of the "
                "recommendations struct (reference schema); rename the "
                "column before calling recommendFor*")
        k = min(k, other.shape[0])
        block = max(1, int(self._get("blockSize")))
        valid = torch.ones(other.shape[0], dtype=torch.bool,
                           device=self.device)
        ids_out = np.empty((Q.shape[0], k), dtype=other_ids.dtype)
        scores_out = np.empty((Q.shape[0], k), dtype=np.float32)
        for s in range(0, Q.shape[0], block):
            sc, ix = topk_scores(Q[s:s + block].contiguous(), other, valid,
                                 k, item_chunk=block)
            ids_out[s:s + block] = other_ids[ix.cpu().numpy()]
            scores_out[s:s + block] = sc.cpu().numpy()
        # one [n, k] structured array with the reference's struct field
        # names ((itemCol|userCol), 'rating'): column[row] is a [k] record
        # view whose elements unpack like (id, score) tuples
        recs = np.empty(ids_out.shape,
                        dtype=[(other_col, ids_out.dtype),
                               ("rating", np.float32)])
        recs[other_col] = ids_out
        recs["rating"] = scores_out
        key_col = self._get("userCol") if users else self._get("itemCol")
        return ColumnarFrame({key_col: q_ids, "recommendations": recs})

    def recommend_arrays(self, numItems, for_users=True):
        """Dense variant of recommendForAll*: (query_ids, ids [n, k],
        scores [n, k]) as numpy arrays."""
        frame_ids = self._user_map.ids if for_users else self._item_map.ids
        Q = self._U if for_users else self._V
        other = self._V if for_users else self._U
        other_ids = self._item_map.ids if for_users else self._user_map.ids
        k = min(numItems, other.shape[0])
        sc, ix = topk_scores(
            Q, other,
            torch.ones(other.shape[0], dtype=torch.bool, device=self.device),
            k)
        return frame_ids, other_ids[ix.cpu().numpy()], sc.cpu().numpy()

    # -- persistence ----------------------------------------------------
    def save(self, path):
        """Raises if ``path`` exists; ``write().overwrite().save`` replaces."""
        self.write().save(path)

    def write(self):
        return MLWriter(self)

    def _save_to(self, path):
        save_factors(path, self._user_map.ids, self._U.cpu().numpy(),
                     self._item_map.ids, self._V.cpu().numpy(),
                     params=self._params)

    @classmethod
    def load(cls, path, device=None):
        """Load a model saved by either package onto ``device`` (None ->
        the CUDA device)."""
        device = resolve_device(device)
        recover_interrupted_overwrite(path)
        manifest, u_ids, U, i_ids, V = load_factors(path)
        return cls(rank=manifest["rank"], user_map=IdMap(ids=u_ids),
                   item_map=IdMap(ids=i_ids), user_factors=U,
                   item_factors=V, params=manifest["params"], device=device)


def _attach_model_accessors(cls):
    for name in cls._MODEL_PARAMS:
        cap = name[0].upper() + name[1:]

        def getter(self, _n=name):
            return self._params[_n]

        def setter(self, value, _n=name):
            return self._set(**{_n: value})

        setattr(cls, f"get{cap}", getter)
        setattr(cls, f"set{cap}", setter)


_attach_model_accessors(ALSModel)
