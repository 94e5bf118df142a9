"""Command line: ``python -m tpu_als_torch.cli train|recommend ...``.

``train`` is the counterpart of ``tpu_als/cli.py::cmd_train`` on one
device: load ``--data`` (``ml-100k:PATH`` a ``u.data`` or its directory,
``dat:PATH`` an ml-1m/ml-10m ``ratings.dat``, ``csv:PATH`` a
``ratings.csv`` with a header, strict ``int,int,float,int``, or
``synthetic:UxIxN``, MovieLens-shaped from ``--seed``), hold out
``--holdout`` of it with the seeded ``randomSplit``, fit ``ALS``
(``--checkpoint-dir``/``--checkpoint-interval`` write resumable
checkpoints, ``--resume PATH`` continues one, ``--guardrails
off|warn|recover`` arms the numerical guardrails), print
``{"holdout_rmse": ...}`` and save the model to ``--output`` (replacing
it), with the run's events, metrics and manifest under ``--output/obs``.
A ``TPU_ALS_FAULT_SPEC`` that does not parse exits 2 before any work.

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

    frame = _load_train_data(args.data)
    train, test = frame.randomSplit([1 - args.holdout, args.holdout],
                                    seed=args.seed)
    als = ALS(rank=args.rank, maxIter=args.max_iter, regParam=args.reg_param,
              implicitPrefs=args.implicit, alpha=args.alpha,
              nonnegative=args.nonnegative, seed=args.seed,
              coldStartStrategy="drop", cgIters=args.cg_iters,
              checkpointDir=args.checkpoint_dir,
              checkpointInterval=args.checkpoint_interval,
              resumeFrom=args.resume, guardrails=args.guardrails,
              device=args.device)
    print(f"training on {len(train):,} ratings ({len(test):,} held out)",
          file=sys.stderr)
    model = als.fit(train)
    if len(test):
        rmse = RegressionEvaluator(labelCol="rating").evaluate(
            model.transform(test))
        print(json.dumps({"holdout_rmse": round(rmse, 4)}))
    if args.output:
        model.write().overwrite().save(args.output)


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
    t.add_argument("--resume", default=None, metavar="PATH",
                   help="warm-start from this checkpoint directory")
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
