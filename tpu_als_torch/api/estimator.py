"""The ALS estimator and ALSModel, in PyTorch.

Counterpart of ``tpu_als/api/estimator.py`` (mirroring
``pyspark.ml.recommendation.{ALS, ALSModel}``).  ``ALS`` has the
reference's params and defaults and its single-device ``fit``: id remap,
the non-finite check, the bucketed CSR build both ways, the training loop
on the card (``device=None``) or the CPU (``device='cpu'``), resumable
checkpoints in the shared format (``checkpointDir``/``checkpointInterval``,
``resumeFrom``), ``fitCallback``, and inexact ALS (``cgIters``,
``cgMode``).  ``ALSModel`` keeps the same column names, the structured
``recommendations`` dtype, the ``coldStartStrategy`` semantics,
``save``/``load`` in the shared format, and the settable serving-time
params; its factor tables are float32 tensors on the model's device, id
maps stay numpy.  Sharded training and serving (``mesh=`` with a
``gatherStrategy``) run over a mesh of logical shards on one device
(:mod:`tpu_als_torch.parallel`).  Guardrails, elastic training, per-host
data and preemption belong to later slices and raise
``NotImplementedError``.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from tpu_als_torch.api.fitting import fit_sharded
from tpu_als_torch.api.params import Estimator, Params, TypeConverters
from tpu_als_torch.core.als import AlsConfig, predict as _predict
from tpu_als_torch.core.als import train as _train
from tpu_als_torch.core.ratings import IdMap, build_csr_buckets, remap_ids
from tpu_als_torch.io.checkpoint import load_factors, save_factors
from tpu_als_torch.ops.cuda_topk import topk_scores
from tpu_als_torch.parallel.mesh import Mesh
from tpu_als_torch.parallel.serve import topk_sharded
from tpu_als_torch.parallel.trainer import check_strategy
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


def _factor_table(x, device):
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.float32))
    return x.to(device=device, dtype=torch.float32)


_STORAGE_LEVELS = {
    "NONE", "DISK_ONLY", "MEMORY_ONLY", "MEMORY_AND_DISK",
    "MEMORY_ONLY_SER", "MEMORY_AND_DISK_SER", "OFF_HEAP",
}

# (name, doc, converter, default): the reference's names and defaults
_ALS_PARAMS = [
    ("rank", "rank of the factorization", TypeConverters.toInt, 10),
    ("maxIter", "max number of iterations (>= 0)", TypeConverters.toInt, 10),
    ("regParam", "regularization parameter (>= 0)", TypeConverters.toFloat,
     0.1),
    ("numUserBlocks", "number of user blocks", TypeConverters.toInt, 10),
    ("numItemBlocks", "number of item blocks", TypeConverters.toInt, 10),
    ("implicitPrefs", "whether to use implicit preference",
     TypeConverters.toBoolean, False),
    ("alpha", "alpha for implicit preference", TypeConverters.toFloat, 1.0),
    ("userCol", "column name for user ids", TypeConverters.toString, "user"),
    ("itemCol", "column name for item ids", TypeConverters.toString, "item"),
    ("ratingCol", "column name for ratings", TypeConverters.toString,
     "rating"),
    ("predictionCol", "prediction column name", TypeConverters.toString,
     "prediction"),
    ("nonnegative", "whether to use nonnegative constraint for least squares",
     TypeConverters.toBoolean, False),
    ("checkpointInterval", "checkpoint interval (>= 1), -1 disables",
     TypeConverters.toInt, 10),
    ("intermediateStorageLevel",
     "storage level for intermediate datasets (accepted for API parity; "
     "factors live in device memory here)", TypeConverters.toString,
     "MEMORY_AND_DISK"),
    ("finalStorageLevel", "storage level for final factors (API parity)",
     TypeConverters.toString, "MEMORY_AND_DISK"),
    ("coldStartStrategy",
     "strategy for unknown/unfitted ids at predict time: 'nan' or 'drop'",
     TypeConverters.toString, "nan"),
    ("seed", "random seed", TypeConverters.toInt, 0),
    ("blockSize", "block size for blocked top-k scoring",
     TypeConverters.toInt, 4096),
    ("solver", "'jax_tpu' (the batched-Cholesky core; the name is the "
     "reference's)", TypeConverters.toString, "jax_tpu"),
]


class _ALSParams(Params):
    def __init__(self):
        super().__init__()
        for name, doc, conv, default in _ALS_PARAMS:
            self._declareParam(name, doc, conv, default)

    def _validate(self):
        m = self.extractParamMap()
        get = lambda n: m[self.getParam(n)]  # noqa: E731
        if get("rank") <= 0:
            raise ValueError("rank must be > 0")
        if get("maxIter") < 0:
            raise ValueError("maxIter must be >= 0")
        if get("regParam") < 0:
            raise ValueError("regParam must be >= 0")
        if get("coldStartStrategy") not in ("nan", "drop"):
            raise ValueError("coldStartStrategy must be 'nan' or 'drop'")
        if get("solver") not in ("jax_tpu", "als"):
            raise ValueError("solver must be 'jax_tpu' or 'als'")
        for lvl in ("intermediateStorageLevel", "finalStorageLevel"):
            if get(lvl) not in _STORAGE_LEVELS:
                raise ValueError(f"{lvl}: unknown storage level {get(lvl)!r}")
        if get("checkpointInterval") == 0 or get("checkpointInterval") < -1:
            raise ValueError("checkpointInterval must be >= 1 or -1")
        if get("alpha") < 0:
            raise ValueError("alpha must be >= 0")
        if get("blockSize") < 1:
            raise ValueError("blockSize must be >= 1")


def _later_slice(knob, slice_name):
    raise NotImplementedError(
        f"ALS({knob}) is not ported yet: it comes with the {slice_name} "
        "slice of the port")


def _attach_accessors(cls, names):
    for name in names:
        cap = name[0].upper() + name[1:]

        def getter(self, _n=name):
            return self.getOrDefault(self.getParam(_n))

        def setter(self, value, _n=name):
            return self._set(**{_n: value})

        setattr(cls, f"get{cap}", getter)
        setattr(cls, f"set{cap}", setter)


class ALS(_ALSParams, Estimator):
    """ALS matrix factorization (explicit and implicit feedback), fit on
    one device or over a mesh of shards.

    Runtime knobs besides the params: ``device`` (None -> the card;
    ``'cpu'`` runs the kernels' plain versions); ``checkpointDir`` —
    where every ``checkpointInterval`` iterations a resumable checkpoint
    ``als_checkpoint`` is written in the shared format; ``resumeFrom`` — a
    checkpoint to warm-start from (its rank, id maps and solver params
    must match; the fit runs only the remaining iterations);
    ``fitCallback(iteration, U, V)`` every ``fitCallbackInterval``
    iterations; ``cgIters`` > 0 replaces the exact solve by that many
    warm-started CG steps, ``cgMode`` 'matfree' (default) or 'dense';
    ``mesh`` — a :class:`~tpu_als_torch.parallel.mesh.Mesh` to fit over
    (its shards share one device; the fit runs there), with
    ``gatherStrategy`` a row of
    ``tpu_als_torch.parallel.trainer.GATHER_STRATEGIES``.
    ``dataMode='per_host'``, ``checkpointSharded``, ``guardrails``,
    ``elastic`` and the strategies not ported yet raise
    ``NotImplementedError``: they belong to later slices.
    """

    def __init__(self, *, mesh=None, gatherStrategy="all_gather",
                 checkpointDir=None, resumeFrom=None, fitCallback=None,
                 fitCallbackInterval=1, dataMode="replicated", cgIters=0,
                 cgMode="matfree", checkpointSharded=False, guardrails=None,
                 elastic=False, device=None, **kwargs):
        super().__init__()
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError("mesh must be a tpu_als_torch.parallel.mesh.Mesh "
                            f"(make_mesh), got {type(mesh).__name__}")
        check_strategy(gatherStrategy)
        if dataMode == "per_host":
            _later_slice("dataMode='per_host'", "multi-GPU")
        if dataMode != "replicated":
            raise ValueError(f"unknown dataMode {dataMode!r} (expected "
                             "'replicated' or 'per_host')")
        if checkpointSharded:
            _later_slice("checkpointSharded=True", "multi-GPU")
        if guardrails not in (None, "off"):
            if guardrails not in ("warn", "recover"):
                raise ValueError(f"unknown guardrails mode {guardrails!r} "
                                 "(expected 'off', 'warn' or 'recover')")
            _later_slice(f"guardrails={guardrails!r}", "resilience")
        if elastic:
            _later_slice("elastic=True", "resilience")
        if int(cgIters) < 0:
            raise ValueError("cgIters must be >= 0 (0 = exact solve)")
        if cgMode not in ("matfree", "dense"):
            raise ValueError(f"unknown cgMode {cgMode!r} (expected "
                             "'matfree' or 'dense')")
        if int(fitCallbackInterval) < 1:
            raise ValueError("fitCallbackInterval must be >= 1")
        self.mesh = mesh
        self.gatherStrategy = gatherStrategy
        self.dataMode = dataMode
        self.cgIters = int(cgIters)
        self.cgMode = cgMode
        self.checkpointDir = checkpointDir
        self.resumeFrom = resumeFrom
        self.fitCallback = fitCallback
        self.fitCallbackInterval = int(fitCallbackInterval)
        self.device = device
        self.setParams(**kwargs)

    def setParams(self, **kwargs):
        unknown = [k for k in kwargs if not self.hasParam(k)]
        if unknown:
            raise TypeError(f"unknown param(s): {unknown}")
        return self._set(**kwargs)

    def _config(self):
        m = self.extractParamMap()
        get = lambda n: m[self.getParam(n)]  # noqa: E731
        return AlsConfig(
            rank=get("rank"), max_iter=get("maxIter"),
            reg_param=get("regParam"), implicit_prefs=get("implicitPrefs"),
            alpha=get("alpha"), nonnegative=get("nonnegative"),
            seed=get("seed") or 0, cg_iters=self.cgIters,
            cg_mode=self.cgMode)

    def _extract_columns(self, frame):
        """(u_raw, i_raw, r) with the reference's schema checks: integer
        ids, ``ratingCol=''`` meaning unit ratings, no nan/inf rating."""
        userCol, itemCol = self.getUserCol(), self.getItemCol()
        ratingCol = self.getRatingCol()
        for c in (userCol, itemCol):
            if c not in frame:
                raise ValueError(f"column {c!r} not in dataset "
                                 f"(columns: {frame.columns})")
            if not np.issubdtype(frame[c].dtype, np.integer):
                raise ValueError(
                    f"ALS only supports integer ids; column {c!r} has "
                    f"dtype {frame[c].dtype}; index string ids first")
        if ratingCol == "":
            r = np.ones(len(frame), dtype=np.float32)
        elif ratingCol in frame:
            r = np.asarray(frame[ratingCol], dtype=np.float32)
        else:
            raise ValueError(f"column {ratingCol!r} not in dataset "
                             f"(columns: {frame.columns}); set ratingCol='' "
                             "for unit ratings")
        nonfinite = int((~np.isfinite(r)).sum())
        if nonfinite:
            raise ValueError(
                f"ratingCol {ratingCol!r} contains {nonfinite} non-finite "
                "value(s) (nan/inf); clean the input before fit")
        return frame[userCol], frame[itemCol], r

    def _resume(self, cfg, user_map, item_map):
        """``(init, start_iter)`` from ``resumeFrom``, after the
        reference's compatibility checks."""
        manifest, c_uids, c_U, c_iids, c_V = load_factors(self.resumeFrom)
        if manifest.get("rank") != cfg.rank:
            raise ValueError(
                f"resumeFrom checkpoint has rank {manifest.get('rank')}, "
                f"estimator is configured with rank {cfg.rank}")
        if not (np.array_equal(c_uids, user_map.ids)
                and np.array_equal(c_iids, item_map.ids)):
            raise ValueError("resumeFrom checkpoint id maps do not match "
                             "the dataset being fit")
        ck = manifest.get("params", {})
        for name in ("regParam", "implicitPrefs", "alpha", "nonnegative",
                     "cgIters", "cgMode"):
            if name in ck:
                mine = (getattr(self, name) if name.startswith("cg")
                        else self.getOrDefault(self.getParam(name)))
                if ck[name] != mine:
                    raise ValueError(
                        f"resumeFrom checkpoint was trained with "
                        f"{name}={ck[name]!r}, estimator has {mine!r}; "
                        "resume cannot reproduce the original run")
        return (c_U, c_V), int(manifest.get("iteration") or 0)

    def _fit(self, dataset):
        self._validate()
        if self.mesh is not None and self.device is not None:
            raise ValueError("pass device= or mesh=, not both: a mesh fit "
                             "runs on its shards' device")
        device = resolve_device(self.device if self.mesh is None
                                else self.mesh.device)
        u_raw, i_raw, r = self._extract_columns(as_frame(dataset))
        u_idx, user_map = remap_ids(u_raw)
        i_idx, item_map = remap_ids(i_raw)
        cfg = self._config()
        init, start_iter = None, 0
        if self.resumeFrom is not None:
            init, start_iter = self._resume(cfg, user_map, item_map)
        callback = self._callback(user_map, item_map)
        if self.mesh is not None:
            U, V = fit_sharded(self, u_idx, i_idx, r, user_map, item_map,
                               cfg, init, start_iter, callback=callback)
            return self._make_model(user_map, item_map, U, V, device)
        ucsr = build_csr_buckets(u_idx, i_idx, r, len(user_map))
        icsr = build_csr_buckets(i_idx, u_idx, r, len(item_map))
        U, V = _train(ucsr, icsr, cfg, callback=callback, init=init,
                      start_iter=start_iter, device=device)
        return self._make_model(user_map, item_map, U, V, device)

    def _make_model(self, user_map, item_map, U, V, device):
        return ALSModel(rank=self.getRank(), user_map=user_map,
                        item_map=item_map, user_factors=U, item_factors=V,
                        params=self._ckpt_params(), device=device)

    def _ckpt_params(self):
        """The param map plus the trajectory-changing runtime knobs,
        persisted with checkpoints and models."""
        params = {p.name: v for p, v in self.extractParamMap().items()}
        params["cgIters"] = self.cgIters
        params["cgMode"] = self.cgMode
        return params

    def _callback(self, user_map, item_map):
        interval = self.getCheckpointInterval()
        ckpt = self.checkpointDir is not None and interval >= 1
        if not ckpt and self.fitCallback is None:
            return None

        def cb(iteration, U, V):
            if self.fitCallback is not None \
                    and iteration % self.fitCallbackInterval == 0:
                self.fitCallback(iteration, U, V)
            if ckpt and iteration % interval == 0:
                save_factors(
                    os.path.join(self.checkpointDir, "als_checkpoint"),
                    user_map.ids, U.cpu().numpy(), item_map.ids,
                    V.cpu().numpy(), params=self._ckpt_params(),
                    iteration=iteration)

        return cb


_attach_accessors(ALS, [n for n, _, _, _ in _ALS_PARAMS])


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
        self._U = _factor_table(user_factors, self.device)
        self._V = _factor_table(item_factors, self.device)
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
    # mesh/gatherStrategy are keyword-only, as in the reference: serve
    # over a mesh (parallel/serve.py) with one of its strategies
    def recommendForAllUsers(self, numItems, *, mesh=None,
                             gatherStrategy="all_gather"):
        return self._recommend(self._U, self._user_map.ids, numItems,
                               users=True, mesh=mesh,
                               gatherStrategy=gatherStrategy)

    def recommendForAllItems(self, numUsers, *, mesh=None,
                             gatherStrategy="all_gather"):
        return self._recommend(self._V, self._item_map.ids, numUsers,
                               users=False, mesh=mesh,
                               gatherStrategy=gatherStrategy)

    def recommendForUserSubset(self, dataset, numItems, *, mesh=None,
                               gatherStrategy="all_gather"):
        ids = np.unique(as_frame(dataset)[self._get("userCol")])
        dense = self._user_map.to_dense(ids)
        keep = dense >= 0
        rows = torch.from_numpy(dense[keep]).to(self.device)
        return self._recommend(self._U[rows], ids[keep], numItems,
                               users=True, mesh=mesh,
                               gatherStrategy=gatherStrategy)

    def recommendForItemSubset(self, dataset, numUsers, *, mesh=None,
                               gatherStrategy="all_gather"):
        ids = np.unique(as_frame(dataset)[self._get("itemCol")])
        dense = self._item_map.to_dense(ids)
        keep = dense >= 0
        rows = torch.from_numpy(dense[keep]).to(self.device)
        return self._recommend(self._V[rows], ids[keep], numUsers,
                               users=False, mesh=mesh,
                               gatherStrategy=gatherStrategy)

    def _recommend(self, Q, q_ids, k, users, mesh=None,
                   gatherStrategy="all_gather"):
        """Top-k for the query rows ``Q``, ``blockSize`` rows per call, or
        with ``mesh`` one sharded call (parallel/serve.py) with the
        serving strategy ``gatherStrategy``."""
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
        if mesh is not None:
            sc, ix = topk_sharded(Q, other, k, mesh, strategy=gatherStrategy)
            ids_out = other_ids[ix.cpu().numpy()]
            scores_out = sc.cpu().numpy()
        else:
            block = max(1, int(self._get("blockSize")))
            valid = torch.ones(other.shape[0], dtype=torch.bool,
                               device=self.device)
            ids_out = np.empty((Q.shape[0], k), dtype=other_ids.dtype)
            scores_out = np.empty((Q.shape[0], k), dtype=np.float32)
            for s in range(0, Q.shape[0], block):
                sc, ix = topk_scores(Q[s:s + block].contiguous(), other,
                                     valid, k, item_chunk=block)
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

    def recommend_arrays(self, numItems, for_users=True, mesh=None,
                         gatherStrategy="all_gather"):
        """Dense variant of recommendForAll*: (query_ids, ids [n, k],
        scores [n, k]) as numpy arrays; ``mesh``: serve sharded, with the
        serving strategy ``gatherStrategy`` (parallel/serve.py)."""
        frame_ids = self._user_map.ids if for_users else self._item_map.ids
        Q = self._U if for_users else self._V
        other = self._V if for_users else self._U
        other_ids = self._item_map.ids if for_users else self._user_map.ids
        k = min(numItems, other.shape[0])
        if mesh is not None:
            sc, ix = topk_sharded(Q, other, k, mesh, strategy=gatherStrategy)
        else:
            sc, ix = topk_scores(
                Q, other, torch.ones(other.shape[0], dtype=torch.bool,
                                     device=self.device), k)
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
