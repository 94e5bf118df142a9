"""The declared observability vocabulary of the port.

Counterpart of ``tpu_als/obs/schema.py`` (stdlib only), holding the rows
of the metrics, events and trace spans the port's modules write: the
guardrails' trips and rollbacks, the estimator's quarantine of poisoned
ratings, the fault points, the retry helper, the checkpoints, the
fold-in server, the serving engine (its histograms, gauge and counters,
publishes, backend and flight records, and the causal-trace hops of a
request) and the run's final snapshot and spans.  The registry
(:mod:`tpu_als_torch.obs.metrics`) checks every name against these
tables when it is written, so an undeclared name raises instead of
minting a series nothing downstream reads.  Help texts are the
reference's, so the two packages' Prometheus texts agree.  The other
rows of the reference (live, tenancy, soak, scenario, plan, elastic)
arrive with the modules that write them.
"""

from __future__ import annotations

# metric name -> (kind, unit, help text); kind in {counter, gauge,
# histogram}, and a name written as another kind raises
METRICS = {
    "foldin.update_seconds": (
        "histogram", "seconds",
        "FoldInServer micro-batch latency, labeled side=user|item"),
    "foldin.ratings": (
        "counter", "rows", "ratings folded in by FoldInServer"),
    "foldin.batch_rows": (
        "histogram", "rows",
        "entities solved per FoldInServer micro-batch (the padded "
        "bucket is the next pow2 above this)"),
    "checkpoint.save_seconds": (
        "histogram", "seconds", "save_factors wall-clock duration"),
    "checkpoint.load_seconds": (
        "histogram", "seconds", "load_factors wall-clock duration"),
    "serving.enqueue_seconds": (
        "histogram", "seconds",
        "time a request waited in the admission queue "
        "(serving.batcher: enqueue -> dequeue)"),
    "serving.score_seconds": (
        "histogram", "seconds",
        "device scoring time per serving micro-batch, labeled "
        "path=int8|exact"),
    "serving.e2e_seconds": (
        "histogram", "seconds",
        "end-to-end serving request latency (submit -> completion)"),
    "serving.batch_rows": (
        "histogram", "rows",
        "real (unpadded) requests per dequeued serving micro-batch — "
        "shows bucket fill under the offered load"),
    "serving.queue_depth": (
        "gauge", "requests",
        "admission-queue backlog sampled after each batch dequeue"),
    "serving.requests": (
        "counter", "requests", "requests admitted by the serving engine"),
    "serving.shed": (
        "counter", "requests",
        "requests refused at admission (queue at capacity; the typed "
        "Overloaded the caller sees)"),
    "serving.expired": (
        "counter", "requests",
        "requests whose deadline passed while queued (failed with "
        "DeadlineExceeded instead of being scored)"),
    "serving.fallback_exact": (
        "counter", "requests",
        "requests scored on the exact path because the int8 index was "
        "stale (publish without requantize, or injected staleness)"),
    "serving.publishes": (
        "counter", "publishes",
        "model generations atomically swapped into the serving engine"),
    "serving.publish_seconds": (
        "histogram", "seconds",
        "wall-clock cost of one model publish, labeled "
        "mode=full|retag|delta|compact|none — the O(touched)-vs-"
        "O(catalog) incremental-publish claim is measured here"),
    "train.rollbacks": (
        "counter", "rollbacks",
        "guardrail rollbacks: iterations retried from the last-good "
        "factor snapshot after a sentinel trip (resilience.guardrails, "
        "recover mode)"),
    "checkpoint.save_bytes": (
        "counter", "bytes", "bytes written by save_factors"),
    "checkpoint.load_bytes": (
        "counter", "bytes", "bytes read by load_factors"),
    "ingest.quarantined_rows": (
        "counter", "rows",
        "rating records the estimator's input scrub set aside (non-"
        "finite or out of range) instead of aborting the fit"),
}

# metric name -> label keys its writers may attach; a metric absent from
# this table takes no labels
LABELS = {
    "foldin.update_seconds": ("side",),
    "foldin.batch_rows": ("side",),
    "serving.enqueue_seconds": ("tenant",),
    "serving.score_seconds": ("path", "tenant"),
    "serving.e2e_seconds": ("tenant",),
    "serving.batch_rows": ("tenant",),
    "serving.queue_depth": ("tenant",),
    "serving.requests": ("tenant",),
    "serving.shed": ("tenant",),
    "serving.expired": ("tenant",),
    "serving.fallback_exact": ("tenant",),
    "serving.publishes": ("tenant",),
    "serving.publish_seconds": ("mode", "tenant"),
}

# -- causal-trace vocabulary (tpu_als_torch/obs/tracing.py) ----------------
# every hop a request takes is one named span, validated when recorded;
# the live, tenancy and elastic hops arrive with their modules
TRACE_SPANS = (
    "serve.admit",        # request admitted at the serving front door
    "serve.queue",        # waited in the MicroBatcher admission queue
    "serve.score",        # scored on device (path=int8|exact|...)
    "serve.expired",      # deadline passed while queued
)

# per-span outcome vocabulary: "ok", or the typed refusal/failure
TRACE_STATUSES = ("ok", "shed", "expired", "failed", "quarantined")

# the serving flight recorder's per-record span breakdown
SERVE_SPAN_KEYS = ("admission", "queue_wait", "score", "rescore",
                   "respond")

# event type -> (required fields beyond ts/type, help text).  Extra
# fields are allowed; a missing required field raises when emitted.
EVENTS = {
    "command": (
        ("cmd", "argv"),
        "one per CLI invocation: the subcommand and its argv"),
    "span": (
        ("name", "path", "seconds"),
        "one per closed span(): wall-clock duration; path is the "
        "'/'-joined stack of enclosing span names (the tree structure)"),
    "metric": (
        ("kind", "name", "value"),
        "a gauge set (gauges are point-in-time, so each set is an "
        "event; counters/histograms appear only in the final snapshot)"),
    "warning": (
        ("what", "reason"),
        "a degraded-but-continuing condition (e.g. a delta publish the "
        "index could not express, rebuilt in full)"),
    "serving_publish": (
        ("seq", "items", "quantized"),
        "one per ServingEngine.publish: the generation sequence number, "
        "catalog size, and whether an int8 index was built for it"),
    "serving_backend": (
        ("backend", "n_shards"),
        "one per ServingEngine, at first publish: the scoring backend "
        "the engine resolved (local / sharded / merge_ring)"),
    "flight_record": (
        ("seq", "trigger", "status", "spans"),
        "one per-request trace dumped by the serving flight recorder "
        "on an SLO breach, shed, or degraded-mode answer: spans is the "
        "admission/queue_wait/score/rescore/respond breakdown in "
        "seconds (serving.engine.FlightRecorder)"),
    "trace_span": (
        ("trace_id", "span_id", "parent_id", "name", "status",
         "seconds"),
        "one causal-trace hop (obs.tracing): deterministic trace/span/"
        "parent ids link admission -> queue -> score (name in "
        "TRACE_SPANS, status in TRACE_STATUSES; seconds may be null "
        "for instantaneous hops)"),
    "checkpoint_save": (
        ("path", "seconds", "bytes"),
        "one per save_factors call"),
    "checkpoint_load": (
        ("path", "seconds", "bytes"),
        "one per load_factors call"),
    "checkpoint_quarantined": (
        ("path", "reason"),
        "load_factors or discover_resume moved a corrupt checkpoint "
        "generation aside to .corrupt/ (and load_factors fell back to "
        ".old when present)"),
    "preempted": (
        ("iteration", "signum"),
        "a fit stopped at an iteration boundary after SIGTERM/SIGINT or "
        "TPU_ALS_PREEMPT_AT; a resumable checkpoint was written if a "
        "checkpoint dir is configured"),
    "retry_attempt": (
        ("what", "attempt", "attempts", "elapsed_seconds", "reason"),
        "one per failed attempt inside resilience.retry.retry_call (the "
        "call will be retried)"),
    "retry_exhausted": (
        ("what", "attempts", "reason"),
        "retry_call gave up: every attempt in the budget failed"),
    "fault_injected": (
        ("point", "mode", "hit"),
        "a resilience.faults fault point fired (chaos testing only; "
        "never emitted when TPU_ALS_FAULT_SPEC is unset)"),
    "guardrail_tripped": (
        ("iteration", "sentinel", "mode"),
        "a numerical-health sentinel fired at a training iteration "
        "boundary (resilience.guardrails; sentinel is one of "
        "nonfinite|norm_band|trend)"),
    "train_rollback": (
        ("iteration", "attempt", "sentinel", "reg_param"),
        "recover-mode guardrails restored the last-good factor snapshot "
        "(seeded perturbation + regularization bump) and are retrying "
        "the iteration"),
    "ingest_quarantined": (
        ("path", "rows", "reasons"),
        "one per ingest call that quarantined records: total rows set "
        "aside and the per-reason breakdown (malformed/nonfinite/"
        "out_of_range)"),
    "snapshot": (
        ("counters", "gauges", "histograms"),
        "final registry state, appended once by finalize() so the JSONL "
        "alone reconstructs every counter, gauge and histogram"),
}


def check_metric(name, kind):
    """Raise if ``name`` is undeclared or declared with another kind."""
    decl = METRICS.get(name)
    if decl is None:
        raise KeyError(f"metric {name!r} is not declared in "
                       "tpu_als_torch.obs.schema.METRICS — declare it there "
                       "before writing it")
    if decl[0] != kind:
        raise TypeError(f"metric {name!r} is declared as a {decl[0]}, "
                        f"used as a {kind}")


def check_labels(name, labels):
    """Raise if a write attaches a label key that ``name``'s LABELS row
    does not declare (no row = no labels)."""
    if not labels:
        return
    allowed = LABELS.get(name, ())
    unknown = sorted(k for k in labels if k not in allowed)
    if unknown:
        raise ValueError(f"metric {name!r} does not declare label key(s) "
                         f"{unknown} (declared: {list(allowed)})")


def check_trace_span(name, status="ok"):
    """Raise if a causal-trace span names an undeclared hop or ends in
    an undeclared status."""
    if name not in TRACE_SPANS:
        raise KeyError(f"trace span {name!r} is not declared in "
                       "tpu_als_torch.obs.schema.TRACE_SPANS — declare it "
                       "there before recording it")
    if status not in TRACE_STATUSES:
        raise ValueError(f"trace span {name!r} carries undeclared status "
                         f"{status!r} (declared: {list(TRACE_STATUSES)})")


def check_event(etype, fields):
    """Raise if ``etype`` is undeclared or missing a required field."""
    decl = EVENTS.get(etype)
    if decl is None:
        raise KeyError(f"event type {etype!r} is not declared in "
                       "tpu_als_torch.obs.schema.EVENTS — declare it there "
                       "before emitting it")
    missing = [f for f in decl[0] if f not in fields]
    if missing:
        raise ValueError(f"event {etype!r} is missing required field(s) "
                         f"{missing} (declared: {list(decl[0])})")
