"""The declared observability vocabulary of the port.

Counterpart of ``tpu_als/obs/schema.py`` (stdlib only), holding the rows
of the metrics and events the port's modules write: the guardrails'
trips and rollbacks, the estimator's quarantine of poisoned ratings, the
fault points, the retry helper and the run's final snapshot.  The
registry (:mod:`tpu_als_torch.obs.metrics`) checks every name against
these tables when it is written, so an undeclared name raises instead of
minting a series nothing downstream reads.  The checkpoint rows carry the
bytes and events of the reference; its ``checkpoint.*_seconds``
histograms wait for the port's first histogram (each event carries its
``seconds``).  The other rows of the reference (serving, live, tenancy,
soak, scenario, tracing) arrive with the modules that write them.
"""

from __future__ import annotations

# metric name -> (kind, unit, help text); kind in {counter, gauge,
# histogram} (the port writes counters so far), and a name written as
# another kind raises
METRICS = {
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
LABELS = {}

# event type -> (required fields beyond ts/type, help text).  Extra
# fields are allowed; a missing required field raises when emitted.
EVENTS = {
    "command": (
        ("cmd", "argv"),
        "one per CLI invocation: the subcommand and its argv"),
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
