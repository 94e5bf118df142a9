"""Command line: ``python -m tpu_als_torch.cli train|evaluate|recommend|tune``.

``train`` is the counterpart of ``tpu_als/cli.py::cmd_train`` on one
device: load ``--data`` (``ml-100k:PATH`` a ``u.data`` or its directory,
``dat:PATH`` an ml-1m/ml-10m ``ratings.dat``, ``csv:PATH`` a
``ratings.csv`` with a header, strict ``int,int,float,int``, or
``synthetic:UxIxN``, MovieLens-shaped from ``--seed``; ``stream:PATH``
raises ``NotImplementedError``: it comes with the serving slice), hold
out ``--holdout`` of it with the seeded ``randomSplit``, fit ``ALS``
(``--checkpoint-dir``/``--checkpoint-interval`` write resumable
checkpoints, ``--resume PATH|auto`` continues one, ``auto`` the newest
valid generation under ``--checkpoint-dir``; ``--guardrails
off|warn|recover`` arms the numerical guardrails), print
``{"holdout_rmse": ...}`` and save the model to ``--output`` (replacing
it), with the run's events, metrics and manifest under ``--output/obs``.
SIGTERM, SIGINT or ``TPU_ALS_PREEMPT_AT=N`` stop the fit at an iteration
boundary, write the resume point to ``--checkpoint-dir`` and exit 43.
A ``TPU_ALS_FAULT_SPEC`` that does not parse exits 2 before any work.

``evaluate`` (``cmd_evaluate``) scores ``--data`` with a saved model (an
``ALSModel`` or a ``PipelineModel`` save of either package) and prints
``{"rmse", "mae", "r2"}``; with ``--ranking-k K`` also precision@K,
recall@K, MAP and NDCG@K: each test user's items rated at least
``--positive-threshold`` are the truth, the model's top K the ranking,
and a test user the model cannot serve counts as an empty ranking
(``ranking_users_cold``).

``tune`` (``cmd_tune``) cross-validates ``ALS`` over ``--ranks`` x
``--reg-params`` (x ``--alphas``) in ``--folds`` folds and prints the
best map and the average RMSEs; ``--output`` saves the
``CrossValidatorModel`` (the best model under ``--output/bestModel``).

``recommend`` is the counterpart of ``cmd_recommend``: load a saved model
(either package's save), optionally fold new ratings in — items first
(``--foldin-items-data``), then users (``--foldin-data``) — and print one
JSON line per user, ``{"user": id, "items": [[item, score], ...]}`` with
scores rounded to 4 decimals, and with ``--titles`` (``u.item``,
``movies.dat``, ``movies.csv`` or their directory) the items' titles
under ``"titles"``.  Fold-in data is ``csv:PATH``.

``--device`` defaults to the CUDA device; pass ``--device cpu`` to run on
the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np


def _load_foldin(spec):
    from tpu_als_torch.io.ratings_csv import load_ratings_csv

    kind, _, arg = spec.partition(":")
    if kind != "csv":
        raise SystemExit(f"unknown fold-in data spec {spec!r} (use "
                         "csv:PATH)")
    return load_ratings_csv(arg)


def _load_train_data(spec):
    from tpu_als_torch.io import movielens

    kind, _, arg = spec.partition(":")
    if kind == "stream":
        raise NotImplementedError(
            f"data spec {spec!r}: the stream: reader (io/stream.py) is not "
            "ported yet: it comes with the serving slice of the port")
    if kind == "ml-100k":
        return movielens.load_movielens_100k(arg)
    if kind == "dat":
        return movielens.load_movielens_dat(arg)
    if kind == "csv":
        return movielens.load_movielens_csv(arg)
    if kind == "synthetic":
        try:
            nu, ni, nnz = (int(x) for x in arg.split("x"))
        except ValueError:
            raise SystemExit(f"synthetic data takes UxIxN, got {arg!r}") \
                from None
        return movielens.synthetic_movielens(nu, ni, nnz)
    raise SystemExit(f"unknown data spec {spec!r} (use ml-100k:PATH | "
                     "dat:PATH (ml-1m/10m ratings.dat) | csv:PATH | "
                     "synthetic:UxIxN)")


def _load_model_any(path, device=None):
    """An ``ALSModel`` save, or a ``PipelineModel`` save (a fitted
    pipeline evaluates through the same command).  Returns (model,
    is_pipeline)."""
    from tpu_als_torch.api.estimator import ALSModel
    from tpu_als_torch.api.pipeline import PipelineModel

    if os.path.exists(os.path.join(path, "pipeline.json")):
        return PipelineModel.load(path, device=device), True
    return ALSModel.load(path, device=device), False


def _resolve_resume(args):
    """``--resume PATH`` loads that checkpoint; ``--resume auto`` the
    newest valid generation under ``--checkpoint-dir`` (digests checked,
    corrupt generations quarantined, ``.old`` considered), or nothing
    (a fresh start) when none exists."""
    if not args.resume:
        return None
    if args.resume != "auto":
        return args.resume
    if not args.checkpoint_dir:
        raise SystemExit("--resume auto needs --checkpoint-dir (it "
                         "searches that directory for the newest valid "
                         "checkpoint)")
    from tpu_als_torch.io.checkpoint import discover_resume

    path = discover_resume(args.checkpoint_dir)
    if path is None:
        print("--resume auto: no valid checkpoint under "
              f"{args.checkpoint_dir}; starting from scratch",
              file=sys.stderr)
    else:
        print(f"--resume auto: resuming from {path}", file=sys.stderr)
    return path


def _arm_fault_spec():
    """Arm ``TPU_ALS_FAULT_SPEC`` when it is set; one that does not parse
    exits 2 with the typed error."""
    from tpu_als_torch.resilience import faults

    if not os.environ.get(faults.ENV_VAR, "").strip():
        return
    try:
        faults.install_from_env()
    except faults.FaultSpecError as e:
        print(f"tpu_als_torch: FaultSpecError: {faults.ENV_VAR} is "
              f"unparseable: {e}", file=sys.stderr)
        raise SystemExit(2) from e


def cmd_train(args):
    from tpu_als_torch.api.estimator import ALS
    from tpu_als_torch.api.evaluation import RegressionEvaluator
    from tpu_als_torch.resilience import preempt

    frame = _load_train_data(args.data)
    train, test = frame.randomSplit([1 - args.holdout, args.holdout],
                                    seed=args.seed)
    als = ALS(rank=args.rank, maxIter=args.max_iter, regParam=args.reg_param,
              implicitPrefs=args.implicit, alpha=args.alpha,
              nonnegative=args.nonnegative, seed=args.seed,
              coldStartStrategy="drop", cgIters=args.cg_iters,
              checkpointDir=args.checkpoint_dir,
              checkpointInterval=args.checkpoint_interval,
              resumeFrom=_resolve_resume(args), guardrails=args.guardrails,
              device=args.device)
    print(f"training on {len(train):,} ratings ({len(test):,} held out)",
          file=sys.stderr)
    try:
        # SIGTERM/SIGINT: finish the iteration in flight, checkpoint, and
        # exit with EXIT_PREEMPTED (rerun with --resume auto)
        with preempt.PreemptionGuard():
            model = als.fit(train)
    except preempt.Preempted as p:
        print(f"preempted — {p}; rerun with --resume auto to continue",
              file=sys.stderr)
        raise  # SystemExit(EXIT_PREEMPTED); main still finalizes obs
    if len(test):
        rmse = RegressionEvaluator(labelCol="rating").evaluate(
            model.transform(test))
        print(json.dumps({"holdout_rmse": round(rmse, 4)}))
    if args.output:
        model.write().overwrite().save(args.output)


def ranking_eval(model, frame, k, positive_threshold=3.5):
    """The ranking protocol of ``evaluate --ranking-k``: per test user,
    the truth is their items in ``frame`` rated at least
    ``positive_threshold``, the ranking the model's top ``k``
    (``recommendForUserSubset``, K5 on the card).  A test user the model
    cannot serve (absent from its fit) counts as an empty ranking, not as
    excluded.  Returns the unrounded metrics, ``ranking_users`` and
    ``ranking_users_cold``."""
    from tpu_als_torch.api.evaluation import RankingMetrics
    from tpu_als_torch.utils.frame import ColumnarFrame

    p = model._params
    u = np.asarray(frame[p["userCol"]])
    i = np.asarray(frame[p["itemCol"]])
    pos = np.asarray(frame[p["ratingCol"]],
                     np.float32) >= positive_threshold
    truth = {}
    for uu, ii in zip(u[pos].tolist(), i[pos].tolist()):
        truth.setdefault(uu, set()).add(ii)
    users = np.array(sorted(truth), dtype=u.dtype)
    recs = model.recommendForUserSubset(
        ColumnarFrame({p["userCol"]: users}), k)
    key = recs.columns[0]
    served = recs[key].tolist()
    rec_ids = recs["recommendations"][p["itemCol"]].tolist()
    pairs = [(ids, truth[uu]) for uu, ids in zip(served, rec_ids)]
    served = set(served)
    cold = [uu for uu in truth if uu not in served]
    pairs.extend(([], truth[uu]) for uu in cold)
    rm = RankingMetrics(pairs)
    return {f"precision_at_{k}": rm.precisionAt(k),
            f"recall_at_{k}": rm.recallAt(k),
            "map": rm.meanAveragePrecision,
            f"ndcg_at_{k}": rm.ndcgAt(k),
            "ranking_users": len(pairs),
            "ranking_users_cold": len(cold)}


def cmd_evaluate(args):
    from tpu_als_torch.api.evaluation import RegressionEvaluator

    model, is_pipeline = _load_model_any(args.model, device=args.device)
    if is_pipeline and args.ranking_k > 0:
        raise SystemExit(
            "--ranking-k needs an ALSModel save (the ranking protocol "
            "runs recommendForUserSubset on raw ids); evaluate the "
            "pipeline's ALS stage directly, or drop --ranking-k for "
            "regression metrics through the full pipeline")
    # the reference's eval loader differs only for a stream: spec (read in
    # the model's id space), which _load_train_data refuses
    frame = _load_train_data(args.data)
    out = model.transform(frame)
    result = {}
    for metric in ("rmse", "mae", "r2"):
        v = RegressionEvaluator(labelCol="rating",
                                metricName=metric).evaluate(out)
        # None, not NaN (every row unservable): json.dumps would write
        # the non-standard NaN token
        result[metric] = round(v, 4) if math.isfinite(v) else None
    if args.ranking_k > 0:
        rk = ranking_eval(model, frame, args.ranking_k,
                          args.positive_threshold)
        result.update({name: v if isinstance(v, int) else round(v, 4)
                       for name, v in rk.items()})
    print(json.dumps(result))


def cmd_tune(args):
    """Grid search over rank/regParam (and alpha) with CrossValidator."""
    from tpu_als_torch.api.estimator import ALS
    from tpu_als_torch.api.evaluation import RegressionEvaluator
    from tpu_als_torch.api.tuning import CrossValidator, ParamGridBuilder

    frame = _load_train_data(args.data)
    als = ALS(maxIter=args.max_iter, implicitPrefs=args.implicit,
              alpha=args.alpha, seed=args.seed, coldStartStrategy="drop",
              cgIters=args.cg_iters, device=args.device)
    gb = (ParamGridBuilder()
          .addGrid(als.rank, [int(x) for x in args.ranks.split(",")])
          .addGrid(als.regParam,
                   [float(x) for x in args.reg_params.split(",")]))
    if args.alphas:
        gb = gb.addGrid(als.alpha,
                        [float(x) for x in args.alphas.split(",")])
    grid = gb.build()
    cv = CrossValidator(estimator=als, estimatorParamMaps=grid,
                        evaluator=RegressionEvaluator(labelCol="rating"),
                        numFolds=args.folds, seed=args.seed)
    cv_model = cv.fit(frame)
    best = cv_model.bestModel
    out = {
        "best_rank": int(best._params["rank"]),
        "best_regParam": float(best._params["regParam"]),
        "avg_metrics": [round(float(m), 4) for m in cv_model.avgMetrics],
        "grid_size": len(grid),
    }
    if args.alphas:
        out["best_alpha"] = float(best._params["alpha"])
    print(json.dumps(out))
    if args.output:
        cv_model.write().overwrite().save(args.output)
        print(f"best model saved to {args.output}", file=sys.stderr)


def cmd_recommend(args):
    from tpu_als_torch.api.estimator import ALSModel
    from tpu_als_torch.stream.microbatch import FoldInServer
    from tpu_als_torch.utils.frame import ColumnarFrame

    model = ALSModel.load(args.model, device=args.device)
    if args.foldin_data or args.foldin_items_data:
        srv = FoldInServer(model)
        if args.foldin_items_data:
            batch = _load_foldin(args.foldin_items_data)
            touched = srv.update_items(batch)
            print(f"folded in {len(batch)} ratings touching "
                  f"{len(touched)} items", file=sys.stderr)
        if args.foldin_data:
            batch = _load_foldin(args.foldin_data)
            touched = srv.update(batch)
            print(f"folded in {len(batch)} ratings touching "
                  f"{len(touched)} users", file=sys.stderr)
    if args.users:
        try:
            ids = np.array([int(x) for x in args.users.split(",")])
        except ValueError:
            raise SystemExit(f"--users takes comma-separated integer ids, "
                             f"got {args.users!r}") from None
        recs = model.recommendForUserSubset(
            ColumnarFrame({model._params["userCol"]: ids}), args.k)
    else:
        recs = model.recommendForAllUsers(args.k)
    titles = None
    if args.titles:
        from tpu_als_torch.io.movielens import load_movielens_movies

        t = load_movielens_movies(args.titles)
        titles = dict(zip(t["item"].tolist(), t["title"].tolist()))
    key = recs.columns[0]
    limit = args.limit if args.limit > 0 else len(recs)
    for row in range(min(limit, len(recs))):
        out = {"user": int(recs[key][row]),
               "items": [[int(i), round(float(s), 4)]
                         for i, s in recs["recommendations"][row]]}
        if titles is not None:
            out["titles"] = [titles.get(int(i))
                             for i, _ in recs["recommendations"][row]]
        print(json.dumps(out))


def main(argv=None):
    parser = argparse.ArgumentParser(prog="tpu_als_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train", help="fit an ALS model on one device")
    t.add_argument("--data", required=True,
                   help="ml-100k:PATH | dat:PATH | csv:PATH | "
                        "synthetic:UxIxN")
    t.add_argument("--rank", type=int, default=10)
    t.add_argument("--max-iter", type=int, default=10)
    t.add_argument("--reg-param", type=float, default=0.1)
    t.add_argument("--implicit", action="store_true")
    t.add_argument("--alpha", type=float, default=1.0)
    t.add_argument("--nonnegative", action="store_true")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--holdout", type=float, default=0.2)
    t.add_argument("--output", default=None)
    t.add_argument("--cg-iters", type=int, default=0,
                   help="> 0: inexact ALS, warm-started CG with this many "
                        "steps per half-step (0 = exact Cholesky)")
    t.add_argument("--checkpoint-dir", default=None,
                   help="write resumable checkpoints under this directory "
                        "every --checkpoint-interval iterations")
    t.add_argument("--checkpoint-interval", type=int, default=10)
    t.add_argument("--resume", default=None, metavar="PATH|auto",
                   help="warm-start from a checkpoint: a directory, or "
                        "'auto' for the newest valid generation under "
                        "--checkpoint-dir (corrupt generations are "
                        "quarantined to .corrupt/)")
    t.add_argument("--guardrails", default=None,
                   choices=("off", "warn", "recover"),
                   help="numerical-health guardrails: 'warn' reads the "
                        "divergence sentinels each iteration and reports a "
                        "trip; 'recover' adds the adaptive solve and "
                        "bounded rollback to the last good factors; "
                        "default: TPU_ALS_GUARDRAILS (unset = off)")
    t.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the "
                        "kernels' plain versions)")
    t.set_defaults(fn=cmd_train)
    e = sub.add_parser("evaluate", help="score a dataset with a saved model")
    e.add_argument("--model", required=True)
    e.add_argument("--data", required=True)
    e.add_argument("--ranking-k", type=int, default=0,
                   help="> 0: also report precision/recall@k, MAP and "
                        "NDCG@k (test items rated >= --positive-threshold "
                        "are each user's truth)")
    e.add_argument("--positive-threshold", type=float, default=3.5)
    e.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the "
                        "kernels' plain versions)")
    e.set_defaults(fn=cmd_evaluate)
    r = sub.add_parser("recommend", help="top-k recommendations")
    r.add_argument("--model", required=True)
    r.add_argument("--users", default=None,
                   help="comma-separated original user ids (default: all)")
    r.add_argument("--k", type=int, default=10)
    r.add_argument("--limit", type=int, default=20,
                   help="max users to print (0 = all)")
    r.add_argument("--foldin-data", default=None,
                   help="ratings (csv:PATH) to fold into the user factors "
                        "before recommending")
    r.add_argument("--titles", default=None,
                   help="movie metadata (u.item, movies.dat, movies.csv, "
                        "or their directory): print each item's title")
    r.add_argument("--foldin-items-data", default=None,
                   help="ratings (csv:PATH) whose items are folded in "
                        "against the fixed user factors; applied before "
                        "--foldin-data")
    r.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the "
                        "kernels' plain versions)")
    r.set_defaults(fn=cmd_recommend)
    g = sub.add_parser("tune", help="cross-validated grid search")
    g.add_argument("--data", required=True)
    g.add_argument("--ranks", default="8,16,32",
                   help="comma-separated rank grid")
    g.add_argument("--reg-params", default="0.01,0.05,0.1",
                   help="comma-separated regParam grid")
    g.add_argument("--max-iter", type=int, default=10)
    g.add_argument("--folds", type=int, default=3)
    g.add_argument("--implicit", action="store_true")
    g.add_argument("--alpha", type=float, default=1.0)
    g.add_argument("--alphas", default=None,
                   help="comma-separated alpha grid (implicit feedback)")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--output", default=None,
                   help="save the CrossValidatorModel here (the best model "
                        "under OUTPUT/bestModel)")
    g.add_argument("--cg-iters", type=int, default=0,
                   help="> 0: inexact ALS (CG) for every fit of the grid")
    g.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the "
                        "kernels' plain versions)")
    g.set_defaults(fn=cmd_tune)
    args = parser.parse_args(argv)
    _arm_fault_spec()
    from tpu_als_torch import obs

    run_dir = (os.path.join(args.output, "obs")
               if getattr(args, "output", None) else None)
    if run_dir is not None:
        argl = list(argv) if argv is not None else sys.argv[1:]
        obs.configure(run_dir, config={k: v for k, v in vars(args).items()
                                       if k != "fn"}, argv=argl)
        obs.emit("command", cmd=args.cmd, argv=argl)
    try:
        return args.fn(args)
    finally:
        if run_dir is not None:
            # after the command: the model save replaces --output, so the
            # run directory under it is written once the model is in place
            obs.finalize()
            obs.deconfigure()


if __name__ == "__main__":
    main()
