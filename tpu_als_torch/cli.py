"""Command line: ``python -m tpu_als_torch.cli train|evaluate|recommend|tune|
foldin-bench|serve-bench``.

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

``foldin-bench`` (``cmd_foldin_bench``) folds ``--batches`` seeded
batches of ``--batch-size`` ratings of new users into a saved model and
prints the reference's JSON line, the p50 of the batches after the first
(``FoldInServer.latency``).

``serve-bench`` (``cmd_serve_bench``) is the single-tenant open-loop
serving benchmark: seeded factors published into a ``ServingEngine``
(int8 index unless ``--exact``; ``--mesh-devices N`` serves from N
logical shards of the one device with ``--serve-backend``), requests at a
fixed ``--qps`` for ``--duration`` seconds scheduled by the clock, and
p50/p99/shed read back from the obs histograms and judged against
``--slo-ms``; ``--bench-json`` banks the JSON with a ``banked_at`` UTC
stamp.  ``--update-qps > 0`` and ``--tenants`` raise
``NotImplementedError``: the live loop and tenancy are not ported (ROADMAP
Queue 1 item 4).

``--device`` defaults to the CUDA device; pass ``--device cpu`` to run on
the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

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
            "ported yet: it comes after the serving slice, with the live "
            "loop (ROADMAP Queue 1 item 4)")
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


def cmd_foldin_bench(args):
    from tpu_als_torch.api.estimator import ALSModel
    from tpu_als_torch.stream.microbatch import FoldInServer
    from tpu_als_torch.utils.frame import ColumnarFrame

    model = ALSModel.load(args.model, device=args.device)
    srv = FoldInServer(model)
    rng = np.random.default_rng(0)
    item_ids = model._item_map.ids
    p = model._params
    base_user = int(model._user_map.ids.max()) + 1
    for b in range(args.batches):
        n = args.batch_size
        batch = ColumnarFrame({
            p["userCol"]: rng.integers(base_user, base_user + 1000, n),
            p["itemCol"]: rng.choice(item_ids, n),
            p["ratingCol"]: rng.uniform(0.5, 5.0, n).astype(np.float32),
        })
        t0 = time.perf_counter()
        srv.update(batch)
        if b == 0:
            print(f"warmup batch: {time.perf_counter()-t0:.3f}s",
                  file=sys.stderr)
    print(json.dumps({
        "metric": "foldin_p50_latency",
        "value": round(srv.latency(0.5, skip_warmup=True), 4),
        "unit": "seconds",
        "batches": args.batches,
        "batch_size": args.batch_size,
    }))


def open_loop(engine, payloads, qps, wait_s):
    """Submit ``payloads`` to a started ``engine`` at ``qps`` requests a
    second, scheduled by the clock (open loop: arrivals do not wait for
    completions), then wait up to ``wait_s`` for each admitted ticket.
    Returns the number shed at admission."""
    from tpu_als_torch.serving import Overloaded

    tickets, shed = [], 0
    t0 = time.perf_counter()
    for j, payload in enumerate(payloads):
        delay = t0 + j / qps - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        try:
            tickets.append(engine.submit(payload))
        except Overloaded:
            shed += 1
    for t in tickets:
        try:
            t.result(timeout=wait_s)
        except Exception:  # noqa: BLE001 — expired/failed: counted by obs
            pass
    return shed


def cmd_serve_bench(args):
    """Open-loop serving latency benchmark: seeded factors, a fixed
    request rate for a fixed window, p50/p99/shed read back from the obs
    histograms and judged against ``--slo-ms``."""
    import datetime as _dt

    from tpu_als_torch import obs, plan
    from tpu_als_torch.serving import ServingEngine
    from tpu_als_torch.utils.platform import resolve_device

    if args.update_qps > 0 or args.tenants:
        raise NotImplementedError(
            "serve-bench --update-qps/--tenants: the live loop (live/) and "
            "tenancy (tenancy/) are not ported yet (ROADMAP Queue 1 item 4)")
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    U = rng.normal(size=(args.users, args.rank)).astype(np.float32)
    V = rng.normal(size=(args.items, args.rank)).astype(np.float32)
    # no --buckets: the planner's ladder (DEFAULT_BUCKETS, disarmed)
    buckets = (tuple(int(b) for b in args.buckets.split(","))
               if args.buckets else None)
    mesh = None
    if args.mesh_devices:
        from tpu_als_torch.parallel.mesh import make_mesh

        mesh = make_mesh(devices=[dev] * args.mesh_devices)
    engine = ServingEngine(
        k=args.k, buckets=buckets, shortlist_k=args.shortlist_k,
        mesh=mesh, serve_backend=args.serve_backend,
        max_queue=args.max_queue, max_wait_s=args.max_wait_ms / 1e3,
        default_deadline_s=(args.deadline_ms / 1e3
                            if args.deadline_ms else None),
        # the SLO is also the flight recorder's breach trigger
        slo_s=args.slo_ms / 1e3, device=dev)
    engine.publish(U, V, quantize=not args.exact)
    with obs.span("serve_bench.warmup"):
        engine.warmup()

    path = "exact" if args.exact else "int8"
    n_req = max(1, int(args.qps * args.duration))
    print(f"serve-bench: {n_req} requests at {args.qps:g} rps over "
          f"{args.duration:g}s ({path} path, {args.items:,} items, rank "
          f"{args.rank}, device {dev})", file=sys.stderr)
    foldin_ids = rng.random(n_req) < args.foldin_frac
    uids = rng.integers(0, args.users, n_req)
    payloads = [U[uids[j]] if foldin_ids[j] else int(uids[j])
                for j in range(n_req)]
    engine.start()
    try:
        with obs.span("serve_bench.drive"):
            shed = open_loop(engine, payloads, args.qps,
                             max(5.0, 10 * args.slo_ms / 1e3))
    finally:
        engine.stop()

    p50 = obs.histogram_quantile("serving.e2e_seconds", 0.5)
    p99 = obs.histogram_quantile("serving.e2e_seconds", 0.99)
    scored = obs.histogram_count("serving.e2e_seconds")
    admitted = obs.counter_value("serving.requests")
    shed_obs = obs.counter_value("serving.shed")
    expired = obs.counter_value("serving.expired")
    attempted = admitted + shed_obs
    if scored == 0:
        raise SystemExit("serve-bench: no request completed — the "
                         "latency histograms are empty")
    if shed != shed_obs:
        raise RuntimeError(f"serve-bench: the driver counted {shed} shed "
                           f"requests, obs {shed_obs}")
    result = {
        "metric": "serve_e2e_p99_ms",
        "value": round(p99 * 1e3, 3),
        "unit": "ms",
        "slo_ms": args.slo_ms,
        "slo_met": bool(p99 * 1e3 <= args.slo_ms),
        "p50_ms": round(p50 * 1e3, 3),
        "shed_rate": round(shed_obs / attempted, 4) if attempted else 0.0,
        "expired": int(expired),
        "scored": int(scored),
        "queue_wait_p99_ms": round(
            obs.histogram_quantile("serving.enqueue_seconds", 0.99) * 1e3,
            3),
        "flight_records": len(obs.events("flight_record")),
        "config": {
            "path": path, "users": args.users, "items": args.items,
            "rank": args.rank, "k": args.k,
            "shortlist_k": args.shortlist_k, "qps": args.qps,
            "duration_s": args.duration,
            "buckets": list(engine.batcher.buckets),
            "max_queue": args.max_queue, "max_wait_ms": args.max_wait_ms,
            "deadline_ms": args.deadline_ms,
            "foldin_frac": args.foldin_frac,
        },
    }
    if mesh is not None:
        result["backend"] = engine._backend
        result["config"]["mesh_devices"] = int(args.mesh_devices)
        result["config"]["serve_backend"] = args.serve_backend
    # the observed request-size mix, as the planner would bank it: the
    # batch_rows histogram's {p50, p90, p99, max} weighted back into a
    # sample
    if obs.histogram_count("serving.batch_rows"):
        bq = [obs.histogram_quantile("serving.batch_rows", q)
              for q in (0.5, 0.9, 0.99, 1.0)]
        sample = [bq[0]] * 50 + [bq[1]] * 40 + [bq[2]] * 9 + [bq[3]]
        result["derived_buckets"] = list(plan.resolve_serving_buckets(
            rank=args.rank, observed=sample))
    print(json.dumps(result))
    if args.bench_json:
        with open(args.bench_json, "w") as f:
            json.dump({
                **result,
                "banked_by": "tpu_als_torch serve-bench",
                "banked_at": _dt.datetime.now(
                    _dt.timezone.utc).isoformat(timespec="seconds"),
            }, f, indent=2)
            f.write("\n")
        print(f"result banked to {args.bench_json}", file=sys.stderr)
    return result


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
    f = sub.add_parser("foldin-bench",
                       help="fold-in latency micro-benchmark")
    f.add_argument("--model", required=True)
    f.add_argument("--batches", type=int, default=20)
    f.add_argument("--batch-size", type=int, default=512)
    f.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the "
                        "kernels' plain versions)")
    f.set_defaults(fn=cmd_foldin_bench)
    sb = sub.add_parser(
        "serve-bench",
        help="open-loop serving latency benchmark against an SLO "
             "(micro-batched engine, int8 index unless --exact)")
    sb.add_argument("--users", type=int, default=20_000)
    sb.add_argument("--items", type=int, default=50_000)
    sb.add_argument("--rank", type=int, default=64)
    sb.add_argument("--k", type=int, default=10)
    sb.add_argument("--shortlist-k", type=int, default=64,
                    help="int8 shortlist rescored exactly in f32 "
                         "(>= items makes the shortlist the catalog)")
    sb.add_argument("--exact", action="store_true",
                    help="skip the int8 index; score every request on "
                         "the exact route (K5 on the card)")
    sb.add_argument("--qps", type=float, default=200.0,
                    help="open-loop arrival rate (requests/second)")
    sb.add_argument("--duration", type=float, default=5.0,
                    help="measured window in seconds")
    sb.add_argument("--slo-ms", type=float, default=50.0,
                    help="end-to-end p99 target the report is judged "
                         "against")
    sb.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline; requests that exceed it "
                         "while queued fail instead of being scored")
    sb.add_argument("--max-queue", type=int, default=1024,
                    help="admission-queue depth beyond which requests "
                         "are shed (typed Overloaded)")
    sb.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="micro-batch coalescing window")
    sb.add_argument("--buckets", default=None,
                    help="comma-separated padded batch sizes; default: "
                         "the planner's ladder (8,32,128)")
    sb.add_argument("--foldin-frac", type=float, default=0.0,
                    help="fraction of requests carrying a fold-in "
                         "factor row instead of a user id")
    sb.add_argument("--mesh-devices", type=int, default=0,
                    help="> 0 serves from this many logical shards of "
                         "the one device")
    sb.add_argument("--serve-backend", default="auto",
                    choices=("auto", "local", "sharded", "merge_ring"),
                    help="scoring backend on the mesh: the sharded int8 "
                         "index, the merge-ring top-k (K8), or auto "
                         "(merge_ring for k <= 128); local ignores the "
                         "mesh")
    sb.add_argument("--update-qps", type=float, default=0.0,
                    help="the live update stream: not ported yet "
                         "(> 0 raises NotImplementedError)")
    sb.add_argument("--tenants", type=int, default=0,
                    help="the multi-tenant variant: not ported yet "
                         "(raises NotImplementedError)")
    sb.add_argument("--seed", type=int, default=0)
    sb.add_argument("--bench-json", default=None, metavar="PATH",
                    help="also bank the result JSON (with banked_at "
                         "provenance) here")
    sb.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    sb.set_defaults(fn=cmd_serve_bench)
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
