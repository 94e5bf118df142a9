"""Command line: ``python -m tpu_als_torch.cli train|evaluate|recommend|tune|
foldin-bench|serve-bench|tt-train|observe|plan|lint|scenario|soak``.

``train`` is the counterpart of ``tpu_als/cli.py::cmd_train`` on one
device: load ``--data`` (``ml-100k:PATH`` a ``u.data`` or its directory,
``dat:PATH`` an ml-1m/ml-10m ``ratings.dat``, ``csv:PATH`` a
``ratings.csv`` with a header, strict ``int,int,float,int``, or
``synthetic:UxIxN``, MovieLens-shaped from ``--seed``, or ``stream:PATH``
a ``user_id,item_id,rating,timestamp`` file with a header and STRING ids,
read by the byte-range stream reader, its ids densified in lexicographic
order), hold out ``--holdout`` of it with the seeded ``randomSplit``, fit
``ALS``
(``--checkpoint-dir``/``--checkpoint-interval`` write resumable
checkpoints, ``--resume PATH|auto`` continues one, ``auto`` the newest
valid generation under ``--checkpoint-dir``; ``--guardrails
off|warn|recover`` arms the numerical guardrails), print
``{"holdout_rmse": ...}`` and save the model to ``--output`` (replacing
it), with the run's events, metrics and manifest under ``--output/obs``;
a ``stream:`` fit also saves ``stream_labels.npz`` beside the model (the
string id behind each dense id, the reference's format).  SIGTERM,
SIGINT or ``TPU_ALS_PREEMPT_AT=N`` stop the fit at an iteration
boundary, write the resume point to ``--checkpoint-dir`` and exit 43.
A ``TPU_ALS_FAULT_SPEC`` that does not parse exits 2 before any work.
``--log-file`` writes one JSON line per iteration (``IterationLogger``:
factor norms and the RMSE of a held-out probe of at most 100,000 rows),
and ``--profile-dir`` a ``torch.profiler`` trace of the fit.

Every command that runs something writes its run directory (events,
metrics, manifest) to ``--obs-dir``, by default ``<--output>/obs``,
with a ``cli.<cmd>`` span around the command (``train`` adds
``data.load``, ``train.block``, ``train.fit`` and an ``iteration``
event per iteration).  ``observe summarize|tail|explain RUN`` read such
a directory and write none.  ``observe roofline`` prints the per-stage
floor of an iteration at the H100's rates (``perf/roofline.py``),
``observe attribution`` fits ``--data`` with each stage fenced and joins
the measured seconds against that floor (``perf/attribution.py``;
``--obs-dir`` keeps the ``attribution`` event and the
``train.stage_seconds`` histograms), and ``observe regress`` gates the
bench series (``obs/regress.py``, exit 1/2/3 on a finding).

``train --devices N`` (N > 1) fits over N logical shards of the one
device with ``--gather-strategy`` (``--elastic``: a lost shard re-forms
the mesh), and ``recommend --devices N --gather-strategy
all_gather|ring`` serves over them; ``--devices 0`` takes every visible
card, the single-device path on a one-card box.

``tt-train`` (``cmd_tt_train``) trains the two-tower retrieval model
(BASELINE config 5) on ``--data``'s positives (rating >=
``--positive-threshold``), ``--holdout`` of them held out, warm-started
from an implicit ALS fit (``--als-rank``, ``--als-iters``) unless
``--cold``, prints the reference's JSON (filtered recall@k and the
counts) and saves the towers to ``--output`` in the reference's format.

``evaluate`` (``cmd_evaluate``) scores ``--data`` with a saved model (an
``ALSModel`` or a ``PipelineModel`` save of either package) and prints
``{"rmse", "mae", "r2"}``; with ``--ranking-k K`` also precision@K,
recall@K, MAP and NDCG@K: each test user's items rated at least
``--positive-threshold`` are the truth, the model's top K the ranking,
and a test user the model cannot serve counts as an empty ranking
(``ranking_users_cold``).  A ``stream:`` spec is densified in the MODEL's
id space through its ``stream_labels.npz``; rows with ids the model never
saw are dropped.

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
under ``"titles"``.  Fold-in data is ``csv:PATH`` or ``stream:PATH``: a
stream batch maps known string ids through the model's
``stream_labels.npz`` and gives new ones fresh dense ids after the
model's; ``--users`` then takes string ids, and each line also names
``"user_id"`` and ``"item_ids"``.

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
stamp.  ``--update-qps > 0`` also drives the live loop: seeded rating
events (``--update-poison-frac`` of them NaN) through a ``LiveUpdater``
(fold-in, ``--update-items`` for the item side, incremental publish), and
the headline becomes ``live_freshness_p99_ms`` against
``--freshness-slo-ms``.  ``--tenants N`` serves N same-shaped models
behind one ``MultiTenantEngine`` (``--tenant-weights``), headline
``tenancy_worst_p99_ms`` with the weighted ``fairness_ratio``.

``plan show|warm|tune|clear`` (``cmd_plan``) drive the execution
planner's cache (``TPU_ALS_PLAN_CACHE`` names its directory, ``off``
disarms it): ``show`` prints every entry with its provenance (a corrupt
file flagged, not fatal), ``warm`` resolves the whole plan for one
configuration (cold: walked and banked; warm: read back), ``tune`` runs
the measured autotune of the kernel knobs (``perf/autotune.py``: the
split width, K4's scratch tile, the table's type) on the card and banks
the winner (warm: a cache read with no trial; ``--force`` re-tunes;
``--bank-out`` writes the winner as a bench bank), ``clear`` drops the
entries.

``lint`` (``cmd_lint``) runs the port's linter over ``tpu_als_torch/``
and ``chip_smoke.py`` against its empty baseline
(``analysis/lint.py``: ``--paths``, ``--baseline``,
``--write-baseline``, ``--rules``) and exits 1 on a finding; with
``--contracts`` (or ``--contract NAME``) it also verifies the contract
registry (``analysis/contracts.py``) on ``--device``.  It writes no run
directory.

``scenario run NAME`` (``cmd_scenario``) runs one of the reference's
twelve production-day scenarios (``scenario/library.py``) and exits 0
only if every assertion holds: 1 on a failed assertion or a phase that
raised, 2 naming the scenarios for an unknown name; ``--slo-ms``,
``--freshness-slo-ms`` and ``--seed`` override its config, ``--json``
prints the result, ``--bench-json`` banks it with the card's name.
``scenario list`` prints every scenario, its chaos and its phases and
touches no device.  ``soak`` (``cmd_soak``) runs the production week
(``soak/``): seeded zipfian/diurnal traffic over two tenants with live
fold-in and periodic refits under the chaos schedule, and exits 0 only
when the SLO verdict passes; ``--plan`` prints the schedule, and the
verdict re-derives from the run directory alone with ``python
tpu_als_torch/soak/verdict.py DIR``.  The CLI children both start get
the parent's ``--device``.

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


def _vocab_lookup(labels, g):
    """Positions of ``labels`` in the sorted vocabulary ``g`` and a
    known-mask, with both widths normalized once."""
    w = max(labels.dtype.itemsize, g.dtype.itemsize, 1)
    lw = labels.astype(f"S{w}")
    gw = g.astype(f"S{w}")
    pos = np.searchsorted(gw, lw)
    known = np.zeros(len(labels), dtype=bool)
    inb = pos < len(g)
    known[inb] = gw[pos[inb]] == lw[inb]
    return pos, known


def _load_stream(path, vocab=None, host_index=0, num_hosts=1):
    """``stream:PATH``: a STRING-id ``user_id,item_id,rating,timestamp``
    file with a header, read by the byte-range stream reader (this
    process's split ``host_index`` of ``num_hosts``) and densified in the
    lexicographic entity space.  Returns ``(frame, user_labels,
    item_labels)`` (labels: numpy ``S`` arrays).

    The vocabularies are agreed across processes
    (``multihost.global_vocab_union``; one process: ``np.unique``), and
    this process's byte-range claim rides the user-vocabulary union, so
    a stale split count on any process fails here instead of silently
    double-reading or dropping ratings; a single process splitting for a
    larger count cannot see its peers' claims and strips them unchecked,
    as the reference does.  ``vocab``: ``(user_labels, item_labels)`` of a
    trained model's ``stream_labels.npz``; the data is then densified in
    the MODEL's id space, and rows with ids the model never saw are
    dropped with a count on stderr.
    """
    from tpu_als_torch.io.stream import (split_claim, stream_ingest,
                                         strip_split_claims,
                                         validate_split_claims)
    from tpu_als_torch.parallel.multihost import (global_vocab_union,
                                                  process_count)
    from tpu_als_torch.utils.frame import ColumnarFrame

    u_loc, i_loc, r, ul, il = stream_ingest(path, host_index, num_hosts,
                                            require_cols=4, skip_header=1)
    if vocab is None:
        claim = np.array([split_claim(host_index, num_hosts)])
        w = max(ul.dtype.itemsize, claim.dtype.itemsize, 1)
        claimed = np.concatenate([ul.astype(f"S{w}"),
                                  claim.astype(f"S{w}")])
        union = global_vocab_union(claimed)
        if process_count() >= num_hosts:
            g_ul, _ = validate_split_claims(union)
        else:
            g_ul = strip_split_claims(union)
        g_il = global_vocab_union(il)
        u = np.searchsorted(g_ul, ul)[u_loc]
        i = np.searchsorted(g_il, il)[i_loc]
    else:
        g_ul, g_il = vocab
        pu, ku = _vocab_lookup(ul, g_ul)
        pi, ki = _vocab_lookup(il, g_il)
        keep = ku[u_loc] & ki[i_loc]
        dropped = int(len(u_loc) - keep.sum())
        if dropped:
            print(f"stream eval: dropped {dropped:,}/{len(u_loc):,} "
                  "rows with user/item ids unknown to the model",
                  file=sys.stderr)
        u = pu[u_loc][keep]
        i = pi[i_loc][keep]
        r = r[keep]
    return (ColumnarFrame({"user": u, "item": i, "rating": r}),
            g_ul, g_il)


def _load_data(spec):
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
                     "stream:PATH | synthetic:UxIxN)")


def _load_train_data(spec, pid=0, pcount=1, per_host=False):
    """``(frame, stream_labels or None)``: a ``stream:`` spec also
    returns the ``(user_labels, item_labels)`` the model's sidecar
    keeps.

    Across ``pcount`` processes (this one ``pid``): a ``{proc}``
    placeholder expands to the process index, ONLY under a real
    multi-process group (one process expanding it to 0 would silently
    train on 1/N of the data where the literal path fails loudly).  For
    ``stream:``, a placeholder means the files are per-process splits
    already, each streamed whole; else ``per_host`` byte-splits the one
    shared file, and a replicated load streams it whole everywhere."""
    expanded = spec.replace("{proc}", str(pid)) if pcount > 1 else spec
    kind, _, arg = expanded.partition(":")
    if kind != "stream":
        return _load_data(expanded), None
    host, hosts = (pid, pcount) if per_host and expanded == spec else (0, 1)
    frame, g_ul, g_il = _load_stream(arg, host_index=host, num_hosts=hosts)
    return frame, (g_ul, g_il)


def _model_vocab(model_dir):
    side = os.path.join(model_dir, "stream_labels.npz")
    if not os.path.exists(side):
        raise SystemExit(
            "stream: eval data needs the model's stream_labels.npz "
            "sidecar (present when the model was trained with "
            "--data stream:...); this model has none")
    z = np.load(side)
    return z["users"], z["items"]


def _load_eval_data(spec, model_dir):
    """A ``stream:`` spec densified in the MODEL's id space through its
    ``stream_labels.npz``; any other spec as ``train`` loads it."""
    kind, _, arg = spec.partition(":")
    if kind != "stream":
        return _load_data(spec)
    frame, _, _ = _load_stream(arg, vocab=_model_vocab(model_dir))
    return frame


def _load_foldin_data(spec, model_dir, new_side):
    """Fold-in data: ``csv:PATH`` (strict ``int,int,float,int``), or
    ``stream:PATH``, where the ``new_side`` ("user" for --foldin-data,
    "item" for --foldin-items-data) maps known labels through the model's
    sidecar and gives FRESH dense ids (after the model's, first-seen
    order) to new ones; the opposite side must be known (its factors do
    the folding), and its unknown rows are dropped with a count.

    Returns ``(frame, new_labels)``: ``new_labels[j]`` is the string id
    behind dense id ``len(model side) + j``.
    """
    kind, _, arg = spec.partition(":")
    if kind == "csv":
        from tpu_als_torch.io.ratings_csv import load_ratings_csv

        return load_ratings_csv(arg), []
    if kind != "stream":
        raise SystemExit(f"unknown fold-in data spec {spec!r} (use "
                         "csv:PATH | stream:PATH)")
    from tpu_als_torch.io.stream import stream_ingest
    from tpu_als_torch.utils.frame import ColumnarFrame

    g_ul, g_il = _model_vocab(model_dir)
    u_loc, i_loc, r, ul, il = stream_ingest(arg, require_cols=4,
                                            skip_header=1)
    pu, ku = _vocab_lookup(ul, g_ul)
    pi, ki = _vocab_lookup(il, g_il)
    # the keep-filter (opposite side known) runs FIRST: a new entity
    # whose every row is dropped gets no fresh id (it would resolve in
    # --users to a row the fold-in never solved)
    if new_side == "user":
        keep, loc, base, labels_side = ki[i_loc], u_loc, g_ul, ul
        pos, unknown = pu, ~ku
    else:
        keep, loc, base, labels_side = ku[u_loc], i_loc, g_il, il
        pos, unknown = pi, ~ki
    surviving = np.zeros(len(labels_side), dtype=bool)
    surviving[np.unique(loc[keep])] = True
    fresh = unknown & surviving
    pos[fresh] = len(base) + np.arange(int(fresh.sum()))
    new_labels = [s.decode() for s in labels_side[fresh].tolist()]
    dropped = int(len(u_loc) - keep.sum())
    if dropped:
        opp = "item" if new_side == "user" else "user"
        print(f"stream fold-in: dropped {dropped:,}/{len(u_loc):,} "
              f"rows with {opp} ids unknown to the model (the known "
              f"{opp} factors are what fold the new {new_side}s in)",
              file=sys.stderr)
    frame = ColumnarFrame({"user": pu[u_loc][keep],
                           "item": pi[i_loc][keep], "rating": r[keep]})
    if new_labels:
        print(f"stream fold-in: {len(new_labels)} new {new_side} ids "
              f"-> dense {len(base)}+ (first-seen): {new_labels[:5]}"
              f"{'...' if len(new_labels) > 5 else ''}", file=sys.stderr)
    return frame, new_labels


def _save_stream_labels(out_dir, user_labels, item_labels):
    """The sidecar mapping dense ids to the original string ids, beside
    the model (the reference's ``stream_labels.npz``)."""
    np.savez(os.path.join(out_dir, "stream_labels.npz"),
             users=user_labels, items=item_labels)


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


def _train_probe(train, test, max_rows=100_000):
    """Held-out (u_idx, i_idx, rating) triple in the DENSE id space the
    fitted model will use (``remap_ids`` over the train columns, the
    first-seen order ``fit`` derives), for the per-iteration probe RMSE.
    Test rows whose user or item never appears in train are dropped;
    more than ``max_rows`` are thinned by a stride.  None when nothing
    survives."""
    from tpu_als_torch.core.ratings import remap_ids

    if not len(test):
        return None
    _, umap = remap_ids(np.asarray(train["user"]))
    _, imap = remap_ids(np.asarray(train["item"]))
    u = umap.to_dense(np.asarray(test["user"]))
    i = imap.to_dense(np.asarray(test["item"]))
    keep = (u >= 0) & (i >= 0)
    u, i = u[keep], i[keep]
    r = np.asarray(test["rating"], dtype=np.float32)[keep]
    if not len(u):
        return None
    if len(u) > max_rows:
        step = len(u) // max_rows + 1
        u, i, r = u[::step], i[::step], r[::step]
    return u, i, r


def _iteration_cb(logger):
    """Wrap an IterationLogger so each record also lands in the metrics
    registry as an ``iteration`` event (what ``observe summarize``
    tables)."""
    from tpu_als_torch import obs

    def cb(iteration, U, V):
        logger(iteration, U, V)
        rec = logger.records[-1]
        obs.emit("iteration",
                 **{k: v for k, v in rec.items() if k != "tag"})
    return cb


def _mesh(devices, device):
    """The mesh ``--devices`` asks for on ``device``: None for one
    device (``--devices 1``, or 0 where one card is visible), else
    ``devices`` logical shards of that one device.  ``--devices 0`` is
    every visible card, and a mesh over several cards raises
    ``NotImplementedError`` (the transport between cards is not
    ported)."""
    if devices < 0:
        raise SystemExit(f"--devices must be >= 0, got {devices}")
    if devices == 1:
        return None
    import torch

    from tpu_als_torch.parallel.mesh import make_mesh
    from tpu_als_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    if devices == 0:
        visible = torch.cuda.device_count() if dev.type == "cuda" else 1
        return None if visible == 1 else make_mesh(visible)
    return make_mesh(devices=[dev] * devices)


def cmd_train(args):
    from tpu_als_torch import obs
    from tpu_als_torch.api.estimator import ALS
    from tpu_als_torch.api.evaluation import RegressionEvaluator
    from tpu_als_torch.resilience import preempt
    from tpu_als_torch.utils.observe import IterationLogger

    # the multi-process branch is chosen before any load: every process
    # runs this same command, and _train_multiprocess loads its own split
    if args.devices != 1:
        from tpu_als_torch.parallel.multihost import init_distributed

        _, pcount = init_distributed()  # one process: a no-op
        if pcount > 1:
            return _train_multiprocess(args)
    if args.per_host_data:
        raise SystemExit(
            "--per-host-data is multi-process only (each process loads "
            "its own split); launch under a torch.distributed group "
            "(torchrun, or WORLD_SIZE/RANK/MASTER_ADDR/MASTER_PORT) with "
            "--devices 0 — single-process runs load one dataset")
    mesh = _mesh(args.devices, args.device)
    with obs.span("data.load"):
        frame, stream_labels = _load_train_data(args.data)
    train, test = frame.randomSplit([1 - args.holdout, args.holdout],
                                    seed=args.seed)
    # per-iteration records when asked for (--log-file) or when a run
    # directory is live: its iteration events are the convergence table
    # of `observe summarize`
    logger = fit_cb = None
    if args.log_file or obs.active():
        logger = IterationLogger(
            probe=_train_probe(train, test), path=args.log_file,
            stream=sys.stderr if args.log_file else None)
        fit_cb = _iteration_cb(logger)
    als = ALS(rank=args.rank, maxIter=args.max_iter, regParam=args.reg_param,
              implicitPrefs=args.implicit, alpha=args.alpha,
              nonnegative=args.nonnegative, seed=args.seed,
              coldStartStrategy="drop", fitCallback=fit_cb,
              cgIters=args.cg_iters, checkpointDir=args.checkpoint_dir,
              checkpointInterval=args.checkpoint_interval,
              resumeFrom=_resolve_resume(args), guardrails=args.guardrails,
              mesh=mesh, gatherStrategy=args.gather_strategy,
              elastic=args.elastic,
              device=args.device if mesh is None else None)
    print(f"training on {len(train):,} ratings ({len(test):,} held out)",
          file=sys.stderr)
    try:
        # SIGTERM/SIGINT: finish the iteration in flight, checkpoint, and
        # exit with EXIT_PREEMPTED (rerun with --resume auto)
        with preempt.PreemptionGuard():
            if args.profile_dir:
                from tpu_als_torch.utils.observe import trace

                with trace(args.profile_dir):
                    model = als.fit(train)
                print(f"profiler trace written to {args.profile_dir}",
                      file=sys.stderr)
            else:
                model = als.fit(train)
    except preempt.Preempted as p:
        print(f"preempted — {p}; rerun with --resume auto to continue",
              file=sys.stderr)
        raise  # SystemExit(EXIT_PREEMPTED); main still finalizes obs
    finally:
        if logger is not None:
            logger.close()
    if len(test):
        rmse = RegressionEvaluator(labelCol="rating").evaluate(
            model.transform(test))
        print(json.dumps({"holdout_rmse": round(rmse, 4)}))
    if args.output:
        model.write().overwrite().save(args.output)
        if stream_labels is not None:
            _save_stream_labels(args.output, *stream_labels)


def _train_multiprocess(args):
    """``train`` in every process of a group: each process calls the same
    ``ALS(mesh=...).fit``, whose multi-process branch blocks only the
    positions it holds and trains through the collectives.  The mesh:
    one shard per process on its device for ``--devices 0``, N logical
    shards of it for ``--devices N``.  Default is a replicated load;
    with ``--per-host-data`` each process reads its own split (a
    ``{proc}`` in ``--data`` expands to the process index; a ``stream:``
    file without one is byte-split) and the estimator runs
    ``dataMode='per_host'``.  The split seed is the same on every
    process, so an accidentally shared file still meets the trainer's
    duplicated-split check.  ``--log-file`` logs from process 0 (the
    iteration gather is collective; peers pass an inert callback).
    Process 0 evaluates its holdout and saves the model."""
    import contextlib

    import torch

    from tpu_als_torch.api.estimator import ALS
    from tpu_als_torch.api.evaluation import RegressionEvaluator
    from tpu_als_torch.parallel.mesh import make_mesh
    from tpu_als_torch.parallel.multihost import process_count, process_index
    from tpu_als_torch.resilience import preempt
    from tpu_als_torch.utils.observe import IterationLogger
    from tpu_als_torch.utils.platform import resolve_device

    pid, pcount = process_index(), process_count()
    if args.devices < 0:
        raise SystemExit(f"--devices must be >= 0, got {args.devices}")
    dev = resolve_device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(devices=[dev] * max(1, args.devices))
    spec = args.data.replace("{proc}", str(pid))
    if (args.per_host_data and args.data == spec
            and spec.partition(":")[0] != "stream"):
        print(f"[proc {pid}] warning: --per-host-data without a {{proc}} "
              "placeholder in --data — every process loads the same path "
              "(valid only for process-local disks holding different "
              "splits; identical content is rejected at train time)",
              file=sys.stderr)
    frame, stream_labels = _load_train_data(args.data, pid, pcount,
                                            args.per_host_data)
    train, test = frame.randomSplit([1 - args.holdout, args.holdout],
                                    seed=args.seed)
    logger = fit_cb = None
    if args.log_file:
        if pid == 0:
            logger = IterationLogger(path=args.log_file)
            fit_cb = _iteration_cb(logger)
        else:
            fit_cb = (lambda iteration, U, V: None)
    print(f"[proc {pid}/{pcount}] training {len(train):,} ratings "
          f"({'per-host' if args.per_host_data else 'replicated'} load) "
          f"over {mesh.global_size} positions", file=sys.stderr)
    als = ALS(rank=args.rank, maxIter=args.max_iter, regParam=args.reg_param,
              implicitPrefs=args.implicit, alpha=args.alpha,
              nonnegative=args.nonnegative, seed=args.seed,
              coldStartStrategy="drop", mesh=mesh,
              gatherStrategy=args.gather_strategy, fitCallback=fit_cb,
              dataMode="per_host" if args.per_host_data else "replicated",
              cgIters=args.cg_iters, checkpointDir=args.checkpoint_dir,
              checkpointInterval=args.checkpoint_interval,
              resumeFrom=_resolve_resume(args), guardrails=args.guardrails,
              elastic=args.elastic)
    ctx = contextlib.nullcontext()
    if args.profile_dir:
        from tpu_als_torch.utils.observe import trace

        ctx = trace(os.path.join(args.profile_dir, f"proc{pid}"))
    try:
        # the preemption decision is collective inside fit: a signal on
        # ANY process checkpoints and stops EVERY process at one boundary
        with preempt.PreemptionGuard(), ctx:
            model = als.fit(train)
    except preempt.Preempted as p:
        print(f"[proc {pid}] preempted — {p}; rerun with --resume auto",
              file=sys.stderr)
        raise
    finally:
        if logger is not None:
            logger.close()
    if pid != 0:
        return None
    if len(test):
        rmse = RegressionEvaluator(labelCol="rating").evaluate(
            model.transform(test))
        print(json.dumps({"holdout_rmse": round(rmse, 4)}))
    if args.output:
        model.write().overwrite().save(args.output)
        if stream_labels is not None:
            _save_stream_labels(args.output, *stream_labels)
        print(f"model saved to {args.output}", file=sys.stderr)
    return model


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
    frame = _load_eval_data(args.data, args.model)
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

    frame, stream_labels = _load_train_data(args.data)
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
        if stream_labels is not None:
            _save_stream_labels(args.output, *stream_labels)
        print(f"best model saved to {args.output}", file=sys.stderr)


def cmd_recommend(args):
    from tpu_als_torch.api.estimator import ALSModel
    from tpu_als_torch.stream.microbatch import FoldInServer
    from tpu_als_torch.utils.frame import ColumnarFrame

    model = ALSModel.load(args.model, device=args.device)
    mesh = _mesh(args.devices, args.device)
    new_user_labels, new_item_labels = [], []
    if args.foldin_data or args.foldin_items_data:
        srv = FoldInServer(model)
        if args.foldin_items_data:
            batch, new_item_labels = _load_foldin_data(
                args.foldin_items_data, args.model, "item")
            touched = srv.update_items(batch)
            print(f"folded in {len(batch)} ratings touching "
                  f"{len(touched)} items", file=sys.stderr)
        if args.foldin_data:
            batch, new_user_labels = _load_foldin_data(
                args.foldin_data, args.model, "user")
            touched = srv.update(batch)
            print(f"folded in {len(batch)} ratings touching "
                  f"{len(touched)} users", file=sys.stderr)
    stream_names = None   # (dense user -> label, item labels) for output
    if args.users:
        toks = args.users.split(",")
        try:
            ids = np.array([int(x) for x in toks])
        except ValueError:
            # string ids: the stream-trained model's sidecar, plus the
            # users folded in by this invocation
            g_ul, g_il = _model_vocab(args.model)
            index = {s.decode(): k for k, s in enumerate(g_ul.tolist())}
            for j, lab in enumerate(new_user_labels):
                index.setdefault(lab, len(g_ul) + j)

            def resolve(t):
                if t not in index:
                    raise SystemExit(
                        f"unknown user id {t!r} (not in the model's "
                        "stream_labels sidecar nor in --foldin-data)")
                return index[t]

            ids = np.array([resolve(t) for t in toks])
            stream_names = ({v: k for k, v in index.items()}, g_il)
        recs = model.recommendForUserSubset(
            ColumnarFrame({model._params["userCol"]: ids}), args.k,
            mesh=mesh, gatherStrategy=args.gather_strategy)
    else:
        recs = model.recommendForAllUsers(args.k, mesh=mesh,
                                          gatherStrategy=args.gather_strategy)
    titles = None
    if args.titles:
        from tpu_als_torch.io.movielens import load_movielens_movies

        t = load_movielens_movies(args.titles)
        titles = dict(zip(t["item"].tolist(), t["title"].tolist()))
    key = recs.columns[0]
    limit = args.limit if args.limit > 0 else len(recs)
    lines = []
    for row in range(min(limit, len(recs))):
        out = {"user": int(recs[key][row]),
               "items": [[int(i), round(float(s), 4)]
                         for i, s in recs["recommendations"][row]]}
        if stream_names is not None:
            rev_u, g_il = stream_names

            def item_name(i):
                if i < len(g_il):
                    return g_il[i].decode()
                j = i - len(g_il)   # an item folded in by this call
                return (new_item_labels[j]
                        if j < len(new_item_labels) else None)

            out["user_id"] = rev_u.get(int(recs[key][row]))
            out["item_ids"] = [item_name(int(i))
                               for i, _ in recs["recommendations"][row]]
        if titles is not None:
            out["titles"] = [titles.get(int(i))
                             for i, _ in recs["recommendations"][row]]
        lines.append(json.dumps(out))
        if len(lines) == 4096:
            # one write a block of users: an unbuffered stdout (python -u,
            # PYTHONUNBUFFERED) would otherwise take a system call a user
            print("\n".join(lines))
            lines.clear()
    if lines:
        print("\n".join(lines))


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


def cmd_tt_train(args):
    """Train the two-tower retrieval model (BASELINE config 5) from a
    ratings file: the ALS warm start (unless --cold) through the port's
    trainer, the filtered-recall holdout report, the towers saved in the
    reference's format."""
    from tpu_als_torch.core.als import AlsConfig, train as als_train
    from tpu_als_torch.core.ratings import build_csr_buckets, remap_ids
    from tpu_als_torch.models.two_tower import (TwoTowerConfig,
                                                recall_at_k,
                                                save_two_tower,
                                                train_two_tower)
    from tpu_als_torch.utils.platform import resolve_device

    dev = resolve_device(args.device)
    frame, _ = _load_train_data(args.data)
    u_raw = np.asarray(frame["user"])
    i_raw = np.asarray(frame["item"])
    r = np.asarray(frame["rating"], dtype=np.float32)
    u, umap = remap_ids(u_raw)
    i, imap = remap_ids(i_raw)
    nU, nI = len(umap), len(imap)
    pos = r >= args.positive_threshold
    u, i, r = u[pos], i[pos], r[pos]
    rng = np.random.default_rng(args.seed)
    test = rng.random(len(u)) < args.holdout
    ut, it_ = u[test], i[test]
    u2, i2 = u[~test], i[~test]

    warm_kw = {}
    if not args.cold:
        als_cfg = AlsConfig(rank=args.als_rank, max_iter=args.als_iters,
                            reg_param=0.005, implicit_prefs=True,
                            alpha=20.0, seed=args.seed)
        ucsr = build_csr_buckets(u2, i2, r[~test], nU)
        icsr = build_csr_buckets(i2, u2, r[~test], nI)
        U, V = als_train(ucsr, icsr, als_cfg, device=dev)
        warm_kw = {"als_user_factors": U.cpu().numpy(),
                   "als_item_factors": V.cpu().numpy()}
        print("ALS warm-start factors trained", file=sys.stderr)

    cfg = TwoTowerConfig(embed_dim=args.embed_dim, out_dim=args.embed_dim,
                         epochs=args.epochs, seed=args.seed)
    params = train_two_tower(u2, i2, nU, nI, cfg, device=dev, **warm_kw)
    # None, not NaN: json.dumps would write the non-standard NaN token
    rec = (round(recall_at_k(params, ut, it_, k=args.k, exclude=(u2, i2)),
                 4) if len(ut) else None)
    out = {"filtered_recall_at_%d" % args.k: rec,
           "train_pairs": int(len(u2)), "test_pairs": int(len(ut)),
           "users": nU, "items": nI, "epochs": cfg.epochs,
           "warm_start": not args.cold}
    if args.output:
        save_two_tower(args.output, params, cfg, nU, nI)
        out["saved"] = args.output
    print(json.dumps(out))


def _observe_regress(args):
    from tpu_als_torch.obs import regress

    result = regress.check(args.root, noise=args.noise, strict=args.strict,
                           trend=args.trend, trend_window=args.trend_window)
    print(json.dumps(result) if args.as_json else regress.render(result))
    if result["exit_code"]:
        raise SystemExit(result["exit_code"])
    return result


def _observe_attribution(args):
    from tpu_als_torch import obs
    from tpu_als_torch.core.als import AlsConfig
    from tpu_als_torch.core.ratings import build_csr_buckets, remap_ids
    from tpu_als_torch.perf.attribution import (attribution_report,
                                                measure_attributed,
                                                render_attribution)
    from tpu_als_torch.perf.roofline import roofline

    if args.obs_dir:
        obs.configure(args.obs_dir,
                      config={k: v for k, v in vars(args).items()
                              if k != "fn"})
    frame = _load_data(args.data)
    u, _ = remap_ids(np.asarray(frame["user"]))
    i, _ = remap_ids(np.asarray(frame["item"]))
    r = np.asarray(frame["rating"], dtype=np.float32)
    nU, nI = int(u.max()) + 1, int(i.max()) + 1
    ucsr = build_csr_buckets(u, i, r, nU)
    icsr = build_csr_buckets(i, u, r, nI)
    cfg = AlsConfig(rank=args.rank, implicit_prefs=not args.explicit,
                    reg_param=args.reg, alpha=args.alpha,
                    compute_dtype=args.dtype,
                    solve_backend=args.solve_backend)
    measured = measure_attributed(ucsr, icsr, cfg, iters=args.iters,
                                  warmup=args.warmup, device=args.device)
    # each stage priced over the buckets that ran it
    rl = roofline(nU, nI, len(r), args.rank, dtype=args.dtype,
                  implicit=not args.explicit, ne_path=measured["ne_path"],
                  cfg=cfg, user_counts=ucsr.counts, item_counts=icsr.counts)
    rep = attribution_report(measured, rl)
    obs.emit("attribution", stages=rep["rows"],
             wall_s_per_iter=rep["wall_s_per_iter"],
             coverage=rep["coverage"],
             resolved_solve_path=rep["resolved_solve_path"],
             config=rl["config"])
    print(json.dumps(rep) if args.as_json else render_attribution(rep))
    if args.obs_dir:
        obs.finalize()
        obs.deconfigure()
    return rep


def _observe_roofline(args):
    from tpu_als_torch.perf.roofline import render, roofline

    report = roofline(
        n_users=args.users, n_items=args.items, nnz=args.ratings,
        rank=args.rank, dtype=args.dtype, implicit=not args.explicit,
        padding_waste=args.padding_waste, devices=args.devices,
        strategy=args.strategy, tiles_user=args.tiles,
        tiles_item=args.tiles, ne_path=args.ne_path,
        measured_s_per_iter=args.measured_s_per_iter)
    print(json.dumps(report) if args.as_json else render(report))
    return report


def cmd_observe(args):
    """Read a run directory written by the other commands:
    ``summarize`` (phases, iterations, gauges, counters, histograms),
    ``tail`` (the last raw events, filtered) and ``explain`` (causal
    trees); or run a measurement tool: ``roofline`` (the per-stage
    floor of an iteration at the card's rates), ``attribution`` (the
    measured per-stage seconds joined against that floor) and
    ``regress`` (the bench-series gate, exit 1/2/3 on a finding)."""
    tools = {"regress": _observe_regress,
             "attribution": _observe_attribution,
             "roofline": _observe_roofline}
    if args.action in tools:
        return tools[args.action](args)
    if args.action == "explain":
        from tpu_als_torch.obs import explain as explain_mod

        try:
            print(explain_mod.explain(args.run_dir, trace=args.trace,
                                      breach=args.breach))
        except (FileNotFoundError, ValueError) as err:
            raise SystemExit(str(err)) from err
        except BrokenPipeError:
            # `observe explain RUN | head` closing the pipe early is
            # normal; point stdout at devnull so the exit-time flush
            # does not raise again
            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return
    from tpu_als_torch.obs import report

    try:
        if args.action == "summarize":
            print(report.cmd_summarize(args.run_dir, as_json=args.as_json,
                                       since=args.since,
                                       window=args.window))
        else:
            print(report.cmd_tail(args.run_dir, n=args.lines,
                                  event=args.event, tenant=args.tenant,
                                  trace=args.trace))
    except (FileNotFoundError, ValueError) as err:
        raise SystemExit(str(err)) from err


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


def _live_server(U, V, rank, dev):
    """The fold-in server the live branches run over: seeded factors in
    a model whose ids are the row numbers (the reference's params),
    ``keep_history=False`` so a row's width stays the batch's own
    multiplicity (1-2) and the prewarm covers every shape."""
    from tpu_als_torch.convert import model_from_arrays
    from tpu_als_torch.stream.microbatch import FoldInServer

    model = model_from_arrays(
        rank, np.arange(U.shape[0]), U.copy(), np.arange(V.shape[0]),
        V.copy(), {"userCol": "user", "itemCol": "item",
                   "ratingCol": "rating", "regParam": 0.05,
                   "implicitPrefs": False, "alpha": 1.0,
                   "nonnegative": False}, device=dev)
    return FoldInServer(model, keep_history=False)


def _prewarm_ladder(max_batch):
    """The fold-in row counts a live stream of micro-batches up to
    ``max_batch`` events produces, as powers of two."""
    from tpu_als_torch.core.ratings import _next_pow2

    return tuple(sorted({int(_next_pow2(max(1, max_batch >> s)))
                         for s in range(max_batch.bit_length())}))


def _bank(args, result, by):
    import datetime as _dt

    with open(args.bench_json, "w") as f:
        json.dump({**result, "banked_by": by,
                   "banked_at": _dt.datetime.now(
                       _dt.timezone.utc).isoformat(timespec="seconds")},
                  f, indent=2)
        f.write("\n")
    print(f"result banked to {args.bench_json}", file=sys.stderr)


def _serve_bench_tenants(args, dev):
    """The ``--tenants N`` branch: N same-shaped models behind one
    :class:`MultiTenantEngine`, equal open-loop load per tenant, judged
    per tenant from the tenant-labeled obs series.  The headline is
    ``tenancy_worst_p99_ms``; ``slo_met`` needs every tenant's p99 within
    ``--slo-ms`` and, when some tenant shed (the scheduler arbitrated),
    the weighted goodput ratio within ``--fairness-bound``.
    ``--update-qps > 0`` gives every tenant its own live stream."""
    import threading

    from tpu_als_torch import obs
    from tpu_als_torch.tenancy import (MultiTenantEngine, TenantOverloaded,
                                       TenantSpec)

    if args.tenants < 2:
        raise SystemExit("serve-bench: --tenants needs >= 2")
    rng = np.random.default_rng(args.seed)
    names = [f"t{i}" for i in range(args.tenants)]
    weights = ([float(w) for w in args.tenant_weights.split(",")]
               if args.tenant_weights else [1.0] * args.tenants)
    if len(weights) != args.tenants:
        raise SystemExit("serve-bench: --tenant-weights needs exactly "
                         f"{args.tenants} comma-separated weights")
    buckets = (tuple(int(b) for b in args.buckets.split(","))
               if args.buckets else None)

    eng = MultiTenantEngine(device=dev)
    factors = {}
    for name, w in zip(names, weights):
        U = rng.normal(size=(args.users, args.rank)).astype(np.float32)
        V = rng.normal(size=(args.items, args.rank)).astype(np.float32)
        factors[name] = (U, V)
        eng.add_tenant(
            TenantSpec(name=name, weight=w, k=args.k,
                       shortlist_k=args.shortlist_k, buckets=buckets,
                       max_queue=args.max_queue,
                       max_wait_s=args.max_wait_ms / 1e3,
                       default_deadline_s=(args.deadline_ms / 1e3
                                           if args.deadline_ms else None),
                       slo_s=args.slo_ms / 1e3),
            U, V, quantize=not args.exact)
    with obs.span("serve_bench.warmup"):
        eng.warmup()

    updaters = {}
    if args.update_qps > 0:
        with obs.span("serve_bench.live_prewarm"):
            for name in names:
                srv = _live_server(*factors[name], args.rank, dev)
                upd = eng.attach_live(
                    name, srv, max_batch=args.update_max_batch,
                    max_wait_ms=args.update_max_wait_ms,
                    slo_s=args.freshness_slo_ms / 1e3)
                if name == names[0]:
                    srv.prewarm(rows=_prewarm_ladder(upd.max_batch),
                                widths=(1, 2), sides=("user",))
                updaters[name] = upd

    per_qps = args.qps / args.tenants
    n_req = max(1, int(per_qps * args.duration))
    path = "exact" if args.exact else "int8"
    print(f"serve-bench: {args.tenants} tenants x {n_req} requests at "
          f"{per_qps:g} rps each over {args.duration:g}s ({path} path, "
          f"{args.items:,} items, rank {args.rank}, device {dev})",
          file=sys.stderr)
    shed = {name: 0 for name in names}

    def _drive(name, seed):
        trng = np.random.default_rng(seed)
        uids = trng.integers(0, args.users, n_req)
        tickets = []
        t0 = time.perf_counter()
        for j in range(n_req):
            delay = (t0 + j / per_qps) - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            try:
                tickets.append(eng.submit(name, int(uids[j])))
            except TenantOverloaded:
                shed[name] += 1
        for t in tickets:
            try:
                t.result(timeout=max(5.0, 10 * args.slo_ms / 1e3))
            except Exception:  # noqa: BLE001 — counted from obs below
                pass

    def _drive_updates(name, seed):
        urng = np.random.default_rng(seed)
        rate = args.update_qps / args.tenants
        n_upd = max(1, int(rate * args.duration))
        uu = urng.integers(0, args.users, n_upd)
        ii = urng.integers(0, args.items, n_upd)
        rr = urng.uniform(0.5, 5.0, n_upd).astype(np.float32)
        tu = time.perf_counter()
        for j in range(n_upd):
            delay = tu + j / rate - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            try:
                updaters[name].submit(int(uu[j]), int(ii[j]), float(rr[j]))
            except Exception:  # noqa: BLE001 — live.shed counts it
                pass

    eng.start()
    try:
        with obs.span("serve_bench.drive"):
            threads = [threading.Thread(
                target=_drive, args=(name, args.seed + 100 + i),
                name=f"serve-bench-{name}")
                for i, name in enumerate(names)]
            threads += [threading.Thread(
                target=_drive_updates, args=(name, args.seed + 200 + i),
                name=f"serve-bench-upd-{name}")
                for i, name in enumerate(updaters)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            deadline = time.perf_counter() + 30.0
            while (any(u.queue_depth for u in updaters.values())
                   and time.perf_counter() < deadline):
                time.sleep(0.02)
    finally:
        eng.stop()

    per_tenant, worst_p99, modes_all, goodput = {}, 0.0, {}, []
    events = obs.events("live_update")
    for name, w in zip(names, weights):
        p50 = obs.histogram_quantile("serving.e2e_seconds", 0.5,
                                     tenant=name)
        p99 = obs.histogram_quantile("serving.e2e_seconds", 0.99,
                                     tenant=name)
        scored = obs.histogram_count("serving.e2e_seconds", tenant=name)
        if scored == 0:
            raise SystemExit(f"serve-bench: tenant {name!r} completed no "
                             "request — its histogram is empty")
        shed_obs = obs.counter_value("serving.shed", tenant=name)
        admitted = obs.counter_value("serving.requests", tenant=name)
        if shed[name] != shed_obs:
            raise RuntimeError(f"serve-bench: tenant {name!r}: the load loop "
                               f"counted {shed[name]} shed, obs {shed_obs}")
        served = obs.counter_value("tenancy.served_rows", tenant=name)
        goodput.append(served / w)
        modes = {}
        for e in events:
            if e.get("tenant") == name:
                modes[e["mode"]] = modes.get(e["mode"], 0) + 1
        for m, c in modes.items():
            modes_all[m] = modes_all.get(m, 0) + c
        worst_p99 = max(worst_p99, p99)
        per_tenant[name] = {
            "p50_ms": round(p50 * 1e3, 3),
            "p99_ms": round(p99 * 1e3, 3),
            "slo_met": bool(p99 * 1e3 <= args.slo_ms),
            "scored": int(scored),
            "shed_rate": (round(shed_obs / (admitted + shed_obs), 4)
                          if admitted + shed_obs else 0.0),
            "served_rows": int(served),
            "weight": w,
            **({"publish_modes": modes} if modes else {}),
        }
    fairness = (max(goodput) / min(goodput)) if min(goodput) else None
    all_in_slo = all(t["slo_met"] for t in per_tenant.values())
    # fairness is a property of contention: judged only when some tenant
    # shed (always reported)
    contended = any(shed[name] > 0 for name in names)
    fair_ok = (not contended or (fairness is not None
                                 and fairness <= args.fairness_bound))
    result = {
        "metric": "tenancy_worst_p99_ms",
        "value": round(worst_p99 * 1e3, 3),
        "unit": "ms",
        "slo_ms": args.slo_ms,
        "fairness_ratio": (round(fairness, 3)
                           if fairness is not None else None),
        "fairness_bound": args.fairness_bound,
        "fairness_judged": contended,
        "slo_met": bool(all_in_slo and fairness is not None and fair_ok),
        "tenants": per_tenant,
        "shape_classes": {k: sorted(v) for k, v in
                          eng.registry.shape_classes().items()},
        **({"publish_modes": modes_all} if modes_all else {}),
        "config": {
            "path": path, "tenants": args.tenants,
            "tenant_weights": weights, "users": args.users,
            "items": args.items, "rank": args.rank, "k": args.k,
            "shortlist_k": args.shortlist_k, "qps": args.qps,
            "qps_per_tenant": per_qps, "duration_s": args.duration,
            "max_queue": args.max_queue,
            "max_wait_ms": args.max_wait_ms,
            "deadline_ms": args.deadline_ms,
            "update_qps": args.update_qps,
        },
    }
    print(json.dumps(result))
    if args.bench_json:
        _bank(args, result, "tpu_als_torch serve-bench --tenants")
    return result


def _publish_probe(engine, model, dev):
    """The incremental publish priced against a rebuild: min of 3 of
    ``with_updates`` on 64 rows and of ``build_index`` of the catalog
    (host clock, the device synchronized), or {} when serving exact."""
    import torch

    from tpu_als_torch.serving import build_index

    idx = engine.published_index
    if idx is None:
        return {}
    Vcur = model._V.detach().to("cpu", torch.float32).numpy()
    pr = np.arange(min(64, idx.n_items), dtype=np.int64)
    vr = np.ascontiguousarray(Vcur[pr])

    def _min3(fn):
        best = float("inf")
        for _ in range(3):
            tp = time.perf_counter()
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            best = min(best, time.perf_counter() - tp)
        return best

    d_s = _min3(lambda: idx.with_updates(pr, vr, seq=idx.seq + 1))
    f_s = _min3(lambda: build_index(Vcur, shortlist_k=idx.shortlist_k,
                                    device=dev))
    return {"publish_delta_ms": round(d_s * 1e3, 3),
            "publish_full_ms": round(f_s * 1e3, 3),
            "publish_speedup": round(f_s / d_s, 2) if d_s else None,
            "probe_rows": int(pr.size),
            "catalog_rows": int(idx.n_items)}


def _tune_on_data(args, dev, search):
    """``plan tune --data``: the search a ``train`` of the same data,
    holdout, seed, rank and type runs on a miss under
    ``TPU_ALS_AUTOTUNE=1``, on that fit's own buckets and initial
    factors (an explicit fit: the knobs move the gathers and Grams both
    kinds run), banked under the same key.  Returns ``(config, shape
    class)``."""
    import torch

    from tpu_als_torch import plan as plan_pkg
    from tpu_als_torch.core import als as core_als
    from tpu_als_torch.core.ratings import build_csr_buckets, remap_ids

    frame, _ = _load_train_data(args.data)
    train, _ = frame.randomSplit([1 - args.holdout, args.holdout],
                                 seed=args.seed)
    u_idx, user_map = remap_ids(np.asarray(train["user"]))
    i_idx, item_map = remap_ids(np.asarray(train["item"]))
    r = np.asarray(train["rating"], dtype=np.float32)
    ucsr = build_csr_buckets(u_idx, i_idx, r, len(user_map))
    icsr = build_csr_buckets(i_idx, u_idx, r, len(item_map))
    cfg = core_als.AlsConfig(rank=int(args.rank), seed=int(args.seed),
                             compute_dtype=args.dtype)
    g = torch.Generator().manual_seed(int(cfg.seed))
    U = core_als.init_factors(ucsr.num_rows, cfg.rank, g).to(dev)
    V = core_als.init_factors(icsr.num_rows, cfg.rank, g).to(dev)
    ub, ib = ucsr.to(dev), icsr.to(dev)

    def prepare(knobs):
        return lambda: core_als.als_step(U, V, ub, ib, ucsr.num_rows,
                                         icsr.num_rows, cfg,
                                         ucsr.chunk_elems, icsr.chunk_elems,
                                         knobs)

    config = core_als.tuned_kernel_knobs(cfg, dev, prepare, (ucsr, icsr),
                                         ucsr.num_rows, icsr.num_rows,
                                         **search)
    return config, plan_pkg.shape_class(ucsr.num_rows, icsr.num_rows,
                                        ucsr.nnz)


def cmd_plan(args):
    """The execution planner's verbs: ``show`` renders the cache (mode,
    entries, each component's provenance, the model beside the
    measurement where one was banked; corrupt files flagged); ``warm``
    resolves the whole ``ExecutionPlan`` for one configuration on
    ``--device`` and prints it with the resolve's wall time; ``tune``
    runs the kernel-knob autotune (cold: every trial timed on the
    device and the winner banked; warm: read back with no trial;
    ``--force`` re-tunes; ``--bank-out`` writes the bench bank);
    ``clear`` drops the on-disk entries."""
    from tpu_als_torch import plan as plan_pkg
    from tpu_als_torch.plan import cache as plan_cache

    if args.plan_cmd == "show":
        entries = []
        for path, doc in plan_cache.list_entries():
            if isinstance(doc, dict):
                comps = {}
                for name, comp in doc["components"].items():
                    prov = comp["provenance"]
                    comps[name] = {
                        "resolved": comp["resolved"],
                        "banked_at": prov["banked_at"],
                        "walk_seconds": prov.get("walk_seconds"),
                        "probes_executed": prov.get("probes_executed"),
                        "model": prov.get("model"),
                    }
                    if prov.get("measured_seconds") is not None:
                        comps[name]["model_vs_measured"] = {
                            "prediction_s": prov.get("model_seconds"),
                            "measured_s": prov.get("measured_seconds"),
                            "ratio": prov.get("ratio"),
                            "source": prov.get("source"),
                            "tuned_config": comp["resolved"],
                            "invalidated": prov.get("invalidated"),
                        }
                entries.append({"path": path, "plan_key": doc["plan_key"],
                                "probes": doc["probes"],
                                "components": comps})
            else:                       # PlanCacheCorrupt: shown, not fatal
                entries.append({"path": path, "corrupt": str(doc)})
        print(json.dumps({"mode": plan_pkg.mode(),
                          "cache_dir": plan_cache.cache_dir(),
                          "entries": entries}, indent=2, default=str))
        return

    if args.plan_cmd == "warm":
        from tpu_als_torch.utils.platform import resolve_device

        dev = resolve_device(args.device)
        t0 = time.perf_counter()
        ep = plan_pkg.resolve_execution_plan(
            rank=args.rank, compute_dtype=args.dtype,
            solve_backend=args.solve_backend, cg_iters=args.cg_iters,
            k=args.k, n_users=args.users, n_items=args.items,
            n_devices=args.devices, device=dev)
        out = ep.summary()
        out["resolve_seconds"] = round(time.perf_counter() - t0, 4)
        out["mode"] = plan_pkg.mode()
        print(json.dumps(out, default=str))
        return out

    if args.plan_cmd == "tune":
        from tpu_als_torch.perf import autotune
        from tpu_als_torch.utils.platform import resolve_device

        if not plan_pkg.armed():
            print(json.dumps({"error": "plan cache is off "
                              "(TPU_ALS_PLAN_CACHE=off): nothing to "
                              "tune against"}))
            raise SystemExit(2)
        space = None
        if args.space is not None:
            try:
                space = json.loads(args.space)
                autotune.enumerate_configs(space)
            except (json.JSONDecodeError, ValueError, TypeError,
                    AttributeError) as e:
                print(f"tpu_als_torch: --space: {e}", file=sys.stderr)
                raise SystemExit(2) from e
        dev = resolve_device(args.device)
        t0 = time.perf_counter()
        search = dict(tune=True, force=args.force, budget_s=args.budget_s,
                      space=space, k=args.reps)
        if args.data is None:
            config = plan_pkg.resolve_kernel_config(
                rank=args.rank, compute_dtype=args.dtype, n=args.n,
                w=args.w, max_w=args.max_w, seed=args.seed, device=dev,
                **search)
            shape_class = "generic"
        else:
            config, shape_class = _tune_on_data(args, dev, search)
        key = plan_pkg.plan_key(rank=int(args.rank), dtype=str(args.dtype),
                                device=dev, shape_class=shape_class)
        entry = plan_cache.load_entry(key)
        comp = (entry or {}).get("components", {}).get("kernel_config")
        prov = (comp or {}).get("provenance") or {}
        out = {"mode": plan_pkg.mode(), "config": config,
               "provenance": prov,
               "resolve_seconds": round(time.perf_counter() - t0, 4)}
        if args.bank_out is not None and prov:
            bank = {"metric": "autotune_fused_solve_speedup_"
                              + ("cpu" if prov["source"] == "plain"
                                 else "gpu"),
                    "value": (prov["default_seconds"]
                              / prov["measured_seconds"]),
                    "unit": "x",
                    "kernel": "local_half_step",
                    "source": prov["source"],
                    "config": comp["resolved"],
                    "default_seconds": prov["default_seconds"],
                    "tuned_seconds": prov["measured_seconds"],
                    "model_seconds": prov["model_seconds"],
                    "tune_seconds": prov["tune_seconds"],
                    "shape": prov["model"]["shape"],
                    "banked_at": prov["banked_at"]}
            with open(args.bank_out, "w") as f:
                json.dump(bank, f, indent=2)
                f.write("\n")
            out["bank_out"] = args.bank_out
        print(json.dumps(out, default=str))
        return out

    if args.plan_cmd == "clear":
        root = plan_cache.cache_dir()
        n = plan_pkg.clear()
        print(json.dumps({"cleared_entries": n, "cache_dir": root}))
        return


def cmd_serve_bench(args):
    """Open-loop serving latency benchmark: seeded factors, a fixed
    request rate for a fixed window, p50/p99/shed read back from the obs
    histograms and judged against ``--slo-ms``.  ``--update-qps > 0``
    adds the live stream (headline ``live_freshness_p99_ms``);
    ``--tenants N`` is :func:`_serve_bench_tenants`."""
    import threading

    from tpu_als_torch import obs, plan
    from tpu_als_torch.serving import Overloaded, ServingEngine
    from tpu_als_torch.utils.platform import resolve_device

    dev = resolve_device(args.device)
    if args.tenants:
        return _serve_bench_tenants(args, dev)
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

    updater, srv, upd_stats = None, None, {"shed": 0}
    if args.update_qps > 0:
        from tpu_als_torch.live import LiveUpdater

        srv = _live_server(U, V, args.rank, dev)
        updater = LiveUpdater(
            engine, srv, max_batch=args.update_max_batch,
            max_wait_ms=args.update_max_wait_ms,
            slo_s=args.freshness_slo_ms / 1e3,
            fold_items=args.update_items, device=dev)
        with obs.span("serve_bench.live_prewarm"):
            srv.prewarm(rows=_prewarm_ladder(updater.max_batch),
                        widths=(1, 2),
                        sides=(("user", "item") if args.update_items
                               else ("user",)))
            if args.update_items and not args.exact:
                # each event touches one item: the delta segment never
                # outgrows the stream's own event count
                engine.warmup_live(max_delta_rows=max(
                    1, int(args.update_qps * args.duration)))

    path = "exact" if args.exact else "int8"
    n_req = max(1, int(args.qps * args.duration))
    print(f"serve-bench: {n_req} requests at {args.qps:g} rps over "
          f"{args.duration:g}s ({path} path, {args.items:,} items, rank "
          f"{args.rank}, device {dev})", file=sys.stderr)
    foldin_ids = rng.random(n_req) < args.foldin_frac
    uids = rng.integers(0, args.users, n_req)
    payloads = [U[uids[j]] if foldin_ids[j] else int(uids[j])
                for j in range(n_req)]

    upd_thread = None
    if updater is not None:
        n_upd = max(1, int(args.update_qps * args.duration))
        upd_u = rng.integers(0, args.users, n_upd)
        upd_i = rng.integers(0, args.items, n_upd)
        upd_r = rng.uniform(0.5, 5.0, n_upd).astype(np.float32)
        upd_r[rng.random(n_upd) < args.update_poison_frac] = np.nan
        print(f"serve-bench: +{n_upd} rating events at "
              f"{args.update_qps:g}/s (live fold-in -> publish, "
              f"freshness SLO {args.freshness_slo_ms:g}ms)",
              file=sys.stderr)

        def _drive_updates():
            tu = time.perf_counter()
            for j in range(n_upd):
                delay = tu + j / args.update_qps - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                try:
                    updater.submit(int(upd_u[j]), int(upd_i[j]),
                                   float(upd_r[j]))
                except Overloaded:
                    upd_stats["shed"] += 1

        updater.start()
        upd_thread = threading.Thread(target=_drive_updates,
                                      name="serve-bench-updates")
    engine.start()
    try:
        with obs.span("serve_bench.drive"):
            if upd_thread is not None:
                upd_thread.start()
            shed = open_loop(engine, payloads, args.qps,
                             max(5.0, 10 * args.slo_ms / 1e3))
            if upd_thread is not None:
                upd_thread.join()
                # freshness is judged on a DRAINED queue
                updater.stop(drain_timeout_s=max(
                    30.0, 10 * args.freshness_slo_ms / 1e3))
    finally:
        if updater is not None:
            updater.stop()
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
        raise RuntimeError(f"serve-bench: the load loop counted {shed} shed "
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
    if updater is not None:
        fr_p50 = obs.histogram_quantile("live.freshness_seconds", 0.5)
        fr_p99 = obs.histogram_quantile("live.freshness_seconds", 0.99)
        fr_n = obs.histogram_count("live.freshness_seconds")
        if fr_n == 0:
            raise SystemExit("serve-bench: no update event reached a "
                             "publish — the freshness histogram is empty")
        modes = {}
        for e in obs.events("live_update"):
            modes[e["mode"]] = modes.get(e["mode"], 0) + 1
        result.update({
            "metric": "live_freshness_p99_ms",
            "value": round(fr_p99 * 1e3, 3),
            "slo_ms": args.freshness_slo_ms,
            "slo_met": bool(fr_p99 * 1e3 <= args.freshness_slo_ms),
            "p50_ms": round(fr_p50 * 1e3, 3),
            "serve": {
                "p99_ms": round(p99 * 1e3, 3),
                "p50_ms": round(p50 * 1e3, 3),
                "slo_ms": args.slo_ms,
                "slo_met": bool(p99 * 1e3 <= args.slo_ms),
            },
            "live": {
                "events_scored": int(fr_n),
                "updates_shed": int(upd_stats["shed"]),
                "quarantined_rows": int(
                    obs.counter_value("ingest.quarantined_rows")),
                "publish_modes": modes,
                **_publish_probe(engine, srv.model, dev),
            },
        })
        result["config"].update({
            "update_qps": args.update_qps,
            "update_items": bool(args.update_items),
            "update_poison_frac": args.update_poison_frac,
            "update_max_batch": updater.max_batch,
            "update_max_wait_ms": updater.max_wait_s * 1e3,
        })
    print(json.dumps(result))
    if args.bench_json:
        _bank(args, result, "tpu_als_torch serve-bench")
    return result


def cmd_lint(args):
    """The port's linter (``analysis/lint.py``), its argv rebuilt: the
    engine owns the flags, and ``python tpu_als_torch/analysis/lint.py``
    runs the same code without torch."""
    from tpu_als_torch.analysis import lint

    argv = []
    if args.paths is not None:
        argv += ["--paths", *args.paths]
    if args.baseline is not None:
        argv += ["--baseline", args.baseline]
    if args.write_baseline:
        argv.append("--write-baseline")
    if args.rules:
        argv.append("--rules")
    if args.contracts:
        argv.append("--contracts")
    for name in args.contract or ():
        argv += ["--contract", name]
    if args.device is not None:
        argv += ["--device", args.device]
    rc = lint.main(argv)
    if rc:
        raise SystemExit(rc)  # `python -m tpu_als_torch.cli lint` exits rc
    return rc


def cmd_scenario(args):
    """Run (or list) a production-day scenario: composed chaos over
    train, serve and stream, judged by hard assertions evaluated from
    the obs trail (``tpu_als_torch.scenario``)."""
    from tpu_als_torch import scenario

    if args.action == "list":
        for name in scenario.names():
            spec = scenario.SCENARIOS[name]
            chaos = f"  [faults: {spec.fault_spec}]" if spec.fault_spec \
                else ""
            print(f"{name}{chaos}")
            print(f"    {' '.join(spec.doc.split())}")
            for p in spec.phases:
                print(f"      - {p.name}: {p.doc}")
        return

    try:
        spec = scenario.get_scenario(args.name)
    except scenario.UnknownScenario as e:
        print(f"tpu_als_torch scenario: {e}", file=sys.stderr)
        raise SystemExit(2) from e
    overrides = {"slo_ms": args.slo_ms,
                 "freshness_slo_ms": args.freshness_slo_ms,
                 "seed": args.seed}
    try:
        result = scenario.run_scenario(spec, config=overrides,
                                       device=args.device)
    except scenario.PhaseFailed as e:
        # harness breakage (a phase body raised), as opposed to a judged
        # assertion failure: one clean line, still non-zero
        print(f"tpu_als_torch scenario: {e}", file=sys.stderr)
        raise SystemExit(1) from e
    print(scenario.render_result(result))
    if args.as_json:
        print(json.dumps(result, default=str))
    if args.bench_json:
        scenario.bank_result(result, args.bench_json, device=args.device)
        print(f"banked {args.bench_json}", file=sys.stderr)
    if not result["passed"]:
        raise SystemExit(1)


def cmd_soak(args):
    """Run the production-week soak (``tpu_als_torch.soak``): seeded
    zipfian/diurnal traffic over a multi-tenant fleet with live fold-in
    and periodic refit, under the declarative chaos schedule; exit 0
    only when the SLO verdict passes.  The verdict re-derives offline
    from the run dir alone: ``python tpu_als_torch/soak/verdict.py
    <obs-dir>``."""
    from tpu_als_torch.soak import chaos, orchestrator, traffic

    cfg = traffic.TrafficConfig(
        seed=args.seed, windows=args.windows, window_s=args.window_s,
        base_qps=args.base_qps, update_qps=args.update_qps,
        poison_frac=args.poison_frac)
    schedule = chaos.default_schedule(
        cfg.windows, victim=cfg.tenants[0][0],
        subprocesses=not args.no_subprocess_chaos)
    if args.plan:
        print(f"{cfg.windows} windows x {cfg.window_s}s "
              f"(~{cfg.windows * cfg.window_s / 60.0:.2f} scheduled "
              f"minutes), tenants "
              + ", ".join(f"{n}:{w:g}" for n, w in cfg.tenants))
        print(schedule.describe())
        return
    result = orchestrator.run_soak(
        cfg, schedule, rank=args.rank, refit_every=args.refit_every,
        judge_config={"slo_ms": args.slo_ms,
                      "freshness_slo_ms": args.freshness_slo_ms,
                      "fairness_max": args.fairness_max,
                      "shed_max": args.shed_max},
        device=args.device)
    print(orchestrator.render(result))
    if args.as_json:
        print(json.dumps(result, default=str))
    if args.bench_json:
        orchestrator.bank_result(result, args.bench_json)
        print(f"banked {args.bench_json}", file=sys.stderr)
    if not result["passed"]:
        raise SystemExit(1)


def main(argv=None):
    from tpu_als_torch.parallel.trainer import (EXECUTABLE_STRATEGIES,
                                                GATHER_STRATEGIES,
                                                strategy_help)

    parser = argparse.ArgumentParser(prog="tpu_als_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    # every run-producing command can write a metrics/events run dir;
    # the default (when only --output is given) is <output>/obs
    obs_common = argparse.ArgumentParser(add_help=False)
    obs_common.add_argument(
        "--obs-dir", default=None,
        help="write metrics/tracing events for this run here "
             "(default: <--output>/obs when --output is set; "
             "inspect with `tpu_als_torch observe summarize DIR`)")
    t = sub.add_parser("train", help="fit an ALS model on one device",
                       parents=[obs_common])
    t.add_argument("--data", required=True,
                   help="ml-100k:PATH | dat:PATH | csv:PATH | "
                        "stream:PATH | synthetic:UxIxN")
    t.add_argument("--rank", type=int, default=10)
    t.add_argument("--max-iter", type=int, default=10)
    t.add_argument("--reg-param", type=float, default=0.1)
    t.add_argument("--implicit", action="store_true")
    t.add_argument("--alpha", type=float, default=1.0)
    t.add_argument("--nonnegative", action="store_true")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--holdout", type=float, default=0.2)
    t.add_argument("--output", default=None)
    t.add_argument("--log-file", default=None,
                   help="write per-iteration JSON log lines here")
    t.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of the fit "
                        "(Chrome/Perfetto JSON) under this directory")
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
    t.add_argument("--devices", type=int, default=1,
                   help="train sharded over N logical shards of the one "
                        "device (0 = all visible cards, which on a "
                        "one-card box is the single-device path; 1 = "
                        "single device, the default); under a "
                        "torch.distributed group (torchrun, or WORLD_SIZE/"
                        "RANK/MASTER_ADDR/MASTER_PORT) any value but 1 "
                        "trains across the processes: 0 = one shard a "
                        "process, N = N logical shards a process")
    t.add_argument("--gather-strategy", default="all_gather",
                   choices=list(GATHER_STRATEGIES),
                   help="how sharded half-steps move the opposite factors "
                        "(table: parallel.trainer.GATHER_STRATEGIES — "
                        f"{strategy_help()})")
    t.add_argument("--per-host-data", action="store_true",
                   help="multi-process only: each process loads its OWN "
                        "--data split ('{proc}' in the spec expands to "
                        "the process index; a stream: file is byte-split) "
                        "instead of a replicated load")
    t.add_argument("--elastic", action="store_true",
                   help="elastic mesh training (needs --devices > 1): the "
                        "loss of a shard re-forms the mesh on the "
                        "surviving shards and training resumes from the "
                        "last checkpoint in --checkpoint-dir")
    t.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the "
                        "kernels' plain versions)")
    t.set_defaults(fn=cmd_train)
    e = sub.add_parser("evaluate", help="score a dataset with a saved model",
                       parents=[obs_common])
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
    r = sub.add_parser("recommend", help="top-k recommendations",
                       parents=[obs_common])
    r.add_argument("--model", required=True)
    r.add_argument("--users", default=None,
                   help="comma-separated original user ids (default: all)")
    r.add_argument("--k", type=int, default=10)
    r.add_argument("--limit", type=int, default=20,
                   help="max users to print (0 = all)")
    r.add_argument("--foldin-data", default=None,
                   help="ratings (csv:PATH | stream:PATH) to fold into "
                        "the user factors "
                        "before recommending")
    r.add_argument("--titles", default=None,
                   help="movie metadata (u.item, movies.dat, movies.csv, "
                        "or their directory): print each item's title")
    r.add_argument("--foldin-items-data", default=None,
                   help="ratings (csv:PATH | stream:PATH) whose items "
                        "are folded in "
                        "against the fixed user factors; applied before "
                        "--foldin-data")
    r.add_argument("--devices", type=int, default=1,
                   help="serve top-k sharded over N logical shards of the "
                        "one device (0 = all visible cards, which on a "
                        "one-card box is the single-device path; 1 = "
                        "single device)")
    r.add_argument("--gather-strategy", default="all_gather",
                   choices=["all_gather", "ring"],
                   help="sharded serving: gather the catalog once, or "
                        "stream its shards in ring order")
    r.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the "
                        "kernels' plain versions)")
    r.set_defaults(fn=cmd_recommend)
    g = sub.add_parser("tune", help="cross-validated grid search",
                       parents=[obs_common])
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
                       help="fold-in latency micro-benchmark",
                       parents=[obs_common])
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
             "(micro-batched engine, int8 index unless --exact)",
        parents=[obs_common])
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
                    help="concurrent rating-event rate through the live "
                         "fold-in -> publish pipeline; > 0 makes the "
                         "headline metric live_freshness_p99_ms")
    sb.add_argument("--freshness-slo-ms", type=float, default=5000.0,
                    help="arrival -> servable p99 target for the live "
                         "stream (a breach dumps the updater's flight "
                         "ring)")
    sb.add_argument("--update-poison-frac", type=float, default=0.0,
                    help="fraction of update events with a non-finite "
                         "rating: quarantined, never folded")
    sb.add_argument("--update-items", action="store_true",
                    help="also fold the ITEM side of each micro-batch "
                         "(the index's incremental delta re-quantization)")
    sb.add_argument("--update-max-batch", type=int, default=None,
                    help="live micro-batch cap (default: the planner's "
                         "live cadence)")
    sb.add_argument("--update-max-wait-ms", type=float, default=None,
                    help="live micro-batch deadline (default: the "
                         "planner's live cadence)")
    sb.add_argument("--tenants", type=int, default=0,
                    help=">= 2 runs the multi-tenant variant: N "
                         "same-shaped models behind one MultiTenantEngine, "
                         "equal open-loop load per tenant, headline "
                         "tenancy_worst_p99_ms judged per tenant plus a "
                         "goodput fairness ratio")
    sb.add_argument("--tenant-weights", default=None,
                    help="comma-separated fair-share weights, one per "
                         "tenant (default: all 1.0); the fairness ratio is "
                         "computed on served rows per weight")
    sb.add_argument("--fairness-bound", type=float, default=1.5,
                    help="max/min weighted-goodput ratio above which the "
                         "multi-tenant report fails its SLO")
    sb.add_argument("--seed", type=int, default=0)
    sb.add_argument("--bench-json", default=None, metavar="PATH",
                    help="also bank the result JSON (with banked_at "
                         "provenance) here")
    sb.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    sb.set_defaults(fn=cmd_serve_bench)
    tt = sub.add_parser("tt-train",
                        help="train + persist the two-tower retrieval "
                             "model (ALS warm start by default)",
                        parents=[obs_common])
    tt.add_argument("--data", required=True)
    tt.add_argument("--output", default=None,
                    help="save the trained towers here")
    tt.add_argument("--epochs", type=int, default=5)
    tt.add_argument("--embed-dim", type=int, default=32)
    tt.add_argument("--als-rank", type=int, default=32)
    tt.add_argument("--als-iters", type=int, default=8)
    tt.add_argument("--cold", action="store_true",
                    help="skip the ALS warm start")
    tt.add_argument("--holdout", type=float, default=0.1)
    tt.add_argument("--positive-threshold", type=float, default=3.5)
    tt.add_argument("--k", type=int, default=10)
    tt.add_argument("--seed", type=int, default=0)
    tt.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    tt.set_defaults(fn=cmd_tt_train)
    o = sub.add_parser("observe",
                       help="inspect a run directory's metrics/events")
    osub = o.add_subparsers(dest="action", required=True)
    os1 = osub.add_parser("summarize",
                          help="per-phase timings, per-iteration RMSE, "
                               "gauges, counters, histograms")
    os1.add_argument("run_dir",
                     help="run dir (--output / --obs-dir of a past run)")
    os1.add_argument("--json", dest="as_json", action="store_true",
                     help="emit the summary as one JSON object")
    os1.add_argument("--since", type=float, default=None, metavar="S",
                     help="only events at/after S seconds into the "
                          "trail (relative to its first event)")
    os1.add_argument("--window", default=None, metavar="A:B",
                     help="only events in [A, B) seconds into the trail "
                          "(either side may be empty)")
    os2 = osub.add_parser("tail", help="print the last N raw events")
    os2.add_argument("run_dir")
    os2.add_argument("-n", "--lines", type=int, default=20)
    os2.add_argument("--event", default=None, metavar="TYPE",
                     help="only events of this type — the last N AFTER "
                          "filtering")
    os2.add_argument("--tenant", default=None, metavar="NAME",
                     help="only events labeled tenant=NAME — the last N "
                          "AFTER filtering")
    os2.add_argument("--trace", default=None, metavar="ID",
                     help="only events of one causal trace (trace_id "
                          "match, or membership in an event's trace_ids)")
    os3 = osub.add_parser(
        "explain",
        help="reconstruct a request/event's causal tree from the trail's "
             "trace_span events; --breach last starts from the latest "
             "freshness/SLO breach")
    os3.add_argument("run_dir", help="run dir / obs dir / events.jsonl")
    os3.add_argument("--trace", default=None, metavar="ID",
                     help="render one trace's tree")
    os3.add_argument("--breach", default=None, choices=("last",),
                     help="start from the trail's last breach event and "
                          "render the trace it names")
    from tpu_als_torch.perf.roofline import HEADLINE

    os4 = osub.add_parser(
        "roofline",
        help="the per-stage bytes/FLOPs floor of one ALS iteration at the "
             "H100's rates (defaults: the headline configuration, ML-25M "
             "rank 128 implicit)")
    os4.add_argument("--users", type=int, default=HEADLINE["n_users"])
    os4.add_argument("--items", type=int, default=HEADLINE["n_items"])
    os4.add_argument("--ratings", type=int, default=HEADLINE["nnz"])
    os4.add_argument("--rank", type=int, default=HEADLINE["rank"])
    os4.add_argument("--dtype", default=HEADLINE["dtype"],
                     choices=["float32", "bfloat16"])
    os4.add_argument("--explicit", action="store_true",
                     help="explicit feedback (default: implicit)")
    os4.add_argument("--padding-waste", type=float,
                     default=HEADLINE["padding_waste"],
                     help="padded_nnz / nnz of the built containers")
    os4.add_argument("--devices", type=int, default=HEADLINE["devices"],
                     help="cards the iteration is spread over (logical "
                          "shards of one card are priced as 1)")
    os4.add_argument("--strategy", default=None,
                     choices=list(EXECUTABLE_STRATEGIES),
                     help="price the collective stage too (devices > 1; "
                          "table: parallel.trainer.GATHER_STRATEGIES)")
    os4.add_argument("--tiles", type=int, default=1,
                     help="row-tile count (ring/chunked strategies "
                          "re-stream the opposite factors per tile)")
    os4.add_argument("--ne-path", default="einsum",
                     choices=["einsum", "gather_fused",
                              "gather_fused_solve"],
                     help="normal-equation build to price: the unfused "
                          "gather + Gram, K3 + a solve (factor rows read "
                          "once, V[cols] never in HBM), or K4 (the solve "
                          "fused in, only x written)")
    os4.add_argument("--measured-s-per-iter", type=float, default=None,
                     help="overlay a measured point (seconds per "
                          "iteration)")
    os4.add_argument("--json", dest="as_json", action="store_true")
    os5 = osub.add_parser(
        "attribution",
        help="measure where an iteration's seconds go: fence-timed "
             "per-stage seconds joined against the roofline floor")
    os5.add_argument("--data", default="synthetic:943x1682x100000",
                     help="same specs as train --data; default: the "
                          "ml-100k shape, synthetic")
    os5.add_argument("--rank", type=int, default=16)
    os5.add_argument("--iters", type=int, default=3,
                     help="fence-timed iterations (after --warmup ones)")
    os5.add_argument("--warmup", type=int, default=1)
    os5.add_argument("--explicit", action="store_true",
                     help="explicit feedback (default: implicit)")
    os5.add_argument("--dtype", default="float32",
                     choices=["float32", "bfloat16"])
    os5.add_argument("--reg", type=float, default=0.1)
    os5.add_argument("--alpha", type=float, default=1.0)
    os5.add_argument("--solve-backend", default="auto",
                     choices=["auto", "unfused", "gather_fused",
                              "gather_fused_solve"],
                     help="exact routes only (CG has no decomposed twin)")
    os5.add_argument("--obs-dir", default=None, metavar="DIR",
                     help="also write the stage histograms and the "
                          "attribution event as a run directory")
    os5.add_argument("--json", dest="as_json", action="store_true")
    os5.add_argument("--device", default=None,
                     help="torch device (default: cuda; 'cpu' runs the "
                          "kernels' plain versions)")
    os6 = osub.add_parser(
        "regress",
        help="bench regression gate over the committed BENCH_*/"
             "MULTICHIP_* series; exit 1 = regression, 2 = null bank, "
             "3 = provenance")
    os6.add_argument("root", nargs="?", default=".",
                     help="directory holding the bench artifacts "
                          "(default: cwd)")
    os6.add_argument("--noise", type=float, default=0.10,
                     help="relative band a latest-vs-best-prior move "
                          "must exceed to count as a regression")
    os6.add_argument("--strict", action="store_true",
                     help="historical nulls and unparseable rounds become "
                          "errors instead of warnings")
    os6.add_argument("--trend", action="store_true",
                     help="also fit the last --trend-window rounds of "
                          "each series and fail on a sustained drift the "
                          "worse way beyond the noise band")
    os6.add_argument("--trend-window", type=int, default=5, metavar="N",
                     help="rounds in the trend fit (needs >= 3 effective "
                          "points; default 5)")
    os6.add_argument("--json", dest="as_json", action="store_true")
    o.set_defaults(fn=cmd_observe)

    pl = sub.add_parser(
        "plan",
        help="execution planner: inspect, warm, tune or clear the "
             "persistent plan cache (TPU_ALS_PLAN_CACHE names its "
             "directory, 'off' disarms)")
    plsub = pl.add_subparsers(dest="plan_cmd", required=True)
    pls = plsub.add_parser(
        "show", help="render the cache: mode, entries, per-component "
                     "provenance (corrupt files flagged, not fatal)")
    pls.set_defaults(fn=cmd_plan, obs_dir=None)
    plw = plsub.add_parser(
        "warm", parents=[obs_common],
        help="resolve the whole ExecutionPlan for one configuration: a "
             "cold resolve walks and banks, a warm one reads the bank")
    plw.add_argument("--rank", type=int, default=128)
    plw.add_argument("--dtype", default="float32",
                     choices=["float32", "bfloat16"])
    plw.add_argument("--solve-backend", default="auto",
                     choices=["auto", "unfused", "gather_fused",
                              "gather_fused_solve", "gather_fused_ring"])
    plw.add_argument("--cg-iters", type=int, default=0)
    plw.add_argument("--k", type=int, default=10,
                     help="serving top-k (the top-k route keys on it)")
    plw.add_argument("--users", type=int, default=None,
                     help="with --items and --devices > 1: also resolve "
                          "the gather strategy for this shape")
    plw.add_argument("--items", type=int, default=None)
    plw.add_argument("--devices", type=int, default=1)
    plw.add_argument("--device", default=None,
                     help="torch device the plan is for (default: cuda; "
                          "plan keys name the device)")
    plw.set_defaults(fn=cmd_plan)
    plt = plsub.add_parser(
        "tune", parents=[obs_common],
        help="measured autotune of the kernel knobs (split width, K4's "
             "scratch tile): cold, the timed call (--data: one iteration "
             "of that fit; else one synthetic local_half_step) min-of-k "
             "per trial and the winner banked; warm, the banked config "
             "read back with no trial (--force re-tunes)")
    plt.add_argument("--rank", type=int, default=128)
    plt.add_argument("--dtype", default="float32",
                     choices=["float32", "bfloat16"])
    plt.add_argument("--budget-s", type=float, default=None,
                     help="wall-clock tuning budget in seconds; the "
                          "trial loop stops when exceeded (default: "
                          "120)")
    plt.add_argument("--space", default=None,
                     help="JSON dict restricting the search space, e.g. "
                          "'{\"split_width\": [4096, 16384]}'; knobs: "
                          "split_width, scratch_elems (another knob "
                          "exits 2)")
    plt.add_argument("--data", default=None,
                     help="tune on this data's fit (as train's --data): "
                          "one iteration of that fit timed per trial and "
                          "banked under the key its train run reads with "
                          "TPU_ALS_AUTOTUNE=1 (default: the synthetic "
                          "timer of --n/--w/--max-w, which no fit reads)")
    plt.add_argument("--holdout", type=float, default=0.2,
                     help="with --data: the held-out share, as train's")
    plt.add_argument("--n", type=int, default=4096,
                     help="the timer's rows in its narrowest bucket")
    plt.add_argument("--w", type=int, default=64,
                     help="the timer's narrowest bucket width")
    plt.add_argument("--max-w", type=int, default=1 << 17,
                     help="the timer's widest bucket width (widths "
                          "double from --w)")
    plt.add_argument("--reps", type=int, default=3,
                     help="min-of-k repetitions per trial")
    plt.add_argument("--seed", type=int, default=0)
    plt.add_argument("--force", action="store_true",
                     help="re-tune even when a valid banked config "
                          "exists (a config measured on the card still "
                          "refuses a plain-version overwrite)")
    plt.add_argument("--bank-out", default=None,
                     help="also write a BENCH-style direct bank to this "
                          "path")
    plt.add_argument("--device", default=None,
                     help="torch device (default: cuda; 'cpu' times the "
                          "kernels' plain versions)")
    plt.set_defaults(fn=cmd_plan)
    plc = plsub.add_parser(
        "clear", help="drop the on-disk entries (.corrupt/ evidence is "
                      "kept)")
    plc.set_defaults(fn=cmd_plan, obs_dir=None)
    sc = sub.add_parser(
        "scenario",
        help="scripted production-day scenarios: composed chaos over "
             "train + serve + stream, judged by hard assertions "
             "evaluated from the obs trail")
    scsub = sc.add_subparsers(dest="action", required=True)
    scr = scsub.add_parser(
        "run", help="run one named scenario; exit 0 only if every "
                    "assertion holds", parents=[obs_common])
    scr.add_argument("name",
                     help="scenario name (see `tpu_als_torch scenario "
                          "list`)")
    scr.add_argument("--slo-ms", type=float, default=None,
                     help="override the latency-SLO bound scenarios "
                          "judge p99 against (traffic-spike)")
    scr.add_argument("--freshness-slo-ms", type=float, default=None,
                     help="override the rating-arrival -> servable "
                          "bound (cold-start)")
    scr.add_argument("--seed", type=int, default=None,
                     help="override the scenario's default seed")
    scr.add_argument("--bench-json", default=None, metavar="PATH",
                     help="also bank the result JSON (with banked_at "
                          "provenance and the card's name) here")
    scr.add_argument("--json", dest="as_json", action="store_true",
                     help="also print the result as one JSON object")
    scr.add_argument("--device", default=None,
                     help="torch device (default: cuda; 'cpu' runs the "
                          "kernels' plain versions); the scenario's CLI "
                          "children get the same")
    scr.set_defaults(fn=cmd_scenario)
    scl = scsub.add_parser(
        "list", help="list the scenarios, their chaos and their phases")
    scl.set_defaults(fn=cmd_scenario, obs_dir=None)

    sk = sub.add_parser(
        "soak",
        help="the production week at compressed timescale: synthetic "
             "zipfian/diurnal traffic drives multi-tenant serve + live "
             "fold-in + refit under a chaos schedule; exit 0 only when "
             "the SLO verdict passes",
        parents=[obs_common])
    sk.add_argument("--windows", type=int, default=8,
                    help="soak windows (the compressed week's length)")
    sk.add_argument("--window-s", type=float, default=3.0,
                    help="wall seconds per window")
    sk.add_argument("--base-qps", type=float, default=40.0,
                    help="serve queries/sec at the diurnal mean")
    sk.add_argument("--update-qps", type=float, default=25.0,
                    help="rating arrivals/sec at the diurnal mean")
    sk.add_argument("--poison-frac", type=float, default=0.02,
                    help="per-event probability a rating arrives "
                         "poisoned (nan -> quarantine path)")
    sk.add_argument("--seed", type=int, default=17,
                    help="traffic seed; (seed, schedule) replays the "
                         "whole workload byte-for-byte")
    sk.add_argument("--rank", type=int, default=8)
    sk.add_argument("--refit-every", type=int, default=3,
                    help="periodic refit-and-republish cadence, in "
                         "windows (0 disables; chaos refits still run)")
    sk.add_argument("--no-subprocess-chaos", action="store_true",
                    help="drop the CLI-child injections (preempt, "
                         "device loss) for a fast in-process soak")
    sk.add_argument("--slo-ms", type=float, default=None,
                    help="serve p99 bound for victim-free tenants")
    sk.add_argument("--freshness-slo-ms", type=float, default=None,
                    help="rating-arrival -> servable p99 bound")
    sk.add_argument("--fairness-max", type=float, default=None,
                    help="max/min answered-rate ratio across tenants")
    sk.add_argument("--shed-max", type=float, default=None,
                    help="shed/offered ceiling over the whole soak")
    sk.add_argument("--plan", action="store_true",
                    help="print the chaos schedule and exit (no soak)")
    sk.add_argument("--bench-json", default=None, metavar="PATH",
                    help="bank the verdict (survived-minutes headline, "
                         "tz-aware banked_at) here")
    sk.add_argument("--json", dest="as_json", action="store_true",
                    help="also print the result as one JSON object")
    sk.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions); the chaos children "
                         "get the same")
    sk.set_defaults(fn=cmd_soak)
    ln = sub.add_parser(
        "lint", help="the port's linter and contract registry (the AST "
                     "pass is stdlib-only; --contracts verifies the byte "
                     "and signature pins on --device)")
    ln.add_argument("--paths", nargs="*", default=None,
                    help="files/dirs to lint (default: tpu_als_torch/ and "
                         "chip_smoke.py)")
    ln.add_argument("--baseline", default=None,
                    help="baseline file of accepted findings (default: "
                         "tpu_als_torch/analysis/lint_baseline.txt; "
                         "'none' disables)")
    ln.add_argument("--write-baseline", action="store_true",
                    help="write current findings to the baseline file")
    ln.add_argument("--rules", action="store_true",
                    help="print the rule catalog and exit")
    ln.add_argument("--contracts", action="store_true",
                    help="also verify every registered contract")
    ln.add_argument("--contract", action="append", default=None,
                    help="verify only this named contract (repeatable; "
                         "implies --contracts)")
    ln.add_argument("--device", default=None,
                    help="torch device for the contracts (default: cuda, "
                         "raising without it; 'cpu' runs the kernels' "
                         "plain versions)")
    ln.set_defaults(fn=cmd_lint)
    args = parser.parse_args(argv)
    _arm_fault_spec()
    if args.cmd in ("observe", "lint"):
        return args.fn(args)  # read-only: writes no run directory
    from tpu_als_torch import obs

    run_dir = args.obs_dir
    if run_dir is None and getattr(args, "output", None):
        run_dir = os.path.join(args.output, "obs")
    if run_dir is not None:
        argl = list(argv) if argv is not None else sys.argv[1:]
        obs.configure(run_dir, config={k: v for k, v in vars(args).items()
                                       if k != "fn"}, argv=argl)
        obs.emit("command", cmd=args.cmd, argv=argl)
    try:
        with obs.span("cli." + args.cmd):
            return args.fn(args)
    finally:
        if run_dir is not None:
            # after the command: the model save replaces --output, so the
            # run directory under it is written once the model is in
            # place; deconfigure so a later command in this process
            # writes nothing here
            out = obs.finalize()
            obs.deconfigure()
            if out is not None:
                print(f"run metrics written to {out} "
                      f"(tpu_als_torch observe summarize {out})",
                      file=sys.stderr)


if __name__ == "__main__":
    main()
