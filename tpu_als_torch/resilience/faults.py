"""Deterministic fault injection: every failure path reachable on demand.

Counterpart of ``tpu_als/resilience/faults.py``, deliberately
stdlib-only (``analysis/vocab.py`` loads it by file path): the
switchboard a test or a chip run uses to make a failure happen at a named
point, deterministically, so that it can assert the recovery instead of
hoping a flake exercises it.

The port wires the reference's eleven points:

========================  ====================================================
``checkpoint.write``      inside ``io.checkpoint.save_factors``' write body,
                          before the atomic install (raise = a transient
                          write error, retried; corrupt = a torn npz that
                          the writer lets through and the digest catches
                          at load)
``checkpoint.rename``     inside ``io.checkpoint.atomic_install``, between
                          the two renames (a crash mid-swap)
``solve.gram``            per training iteration of ``core.als.train``
                          (host-level, after the iteration's half-steps;
                          corrupt = NaN-poison a factor row, what a blown
                          Gram solve leaves behind)
``serving.publish``       inside ``serving.ServingEngine.publish`` (corrupt
                          = a torn publish: the fresh index or shard
                          placement is dropped before the swap, and the
                          score path answers exact)
``serving.score``         per micro-batch in ``ServingEngine.serve_batch``
                          (corrupt = treat the index as stale for the
                          batch; raise = fail the batch's tickets)
``multihost.init``        inside ``parallel.multihost.init_distributed``'s
                          rendezvous attempt (raise = a failed rendezvous,
                          retried)
``ingest.read_chunk``     per chunk read in ``io.stream.stream_ingest``
                          (raise = a transient read error, retried;
                          corrupt = a stray newline tears a line, which
                          the strict parser rejects)
``ingest.record``         per record of a chunk in ``io.stream``, walked
                          only when armed (corrupt = the record's rating
                          rewritten to ``nan`` before parsing)
``comm.ring_step``        per ring step of ``parallel.trainer``, wrapped
                          only when armed (raise = a failed collective
                          before the step; corrupt = NaN-poisoned factors
                          after it, caught as ``FactorsCorrupt``)
``serve.gather``          per sharded top-k in ``parallel.serve`` (raise =
                          a failed gather; corrupt = a stale/lost shard:
                          both answer degraded from the last-good catalog
                          or raise ``ServeShardLost``)
``mesh.device_lost``      per step of an elastic fit
                          (``resilience.elastic.wrap_step``; corrupt =
                          the victim shard dies, raise = a transient step
                          failure with every shard healthy)
========================  ====================================================

Spec grammar (``TPU_ALS_FAULT_SPEC`` env var, or :func:`install`)::

    SPEC  ::= RULE (';' RULE)*
    RULE  ::= POINT '=' MODE ('@' SCHED)?
    MODE  ::= 'raise' | 'corrupt' | 'hang:' SECONDS
    SCHED ::= 'once' | 'nth=' K | 'first=' N | 'every=' K
            | 'prob=' P (',seed=' S)?

Hit indices are 1-based per point; ``once`` == ``nth=1`` (the default).
``prob`` draws from a dedicated ``random.Random(seed)`` per rule, so the
schedule is a pure function of (spec, hit index) and a failing run
replays exactly.  At the site, ``raise`` raises :class:`InjectedFault`
(an ``IOError``, so the retry policies treat it as transient), ``hang:S``
sleeps S seconds and continues, and ``corrupt`` makes :func:`check`
return ``"corrupt"`` for the site to apply its own corruption.  Disarmed,
:func:`check` is one attribute load and a ``None`` compare.
"""

from __future__ import annotations

import os
import random
import sys
import threading
import time
import warnings

FAULT_POINTS = ("checkpoint.write", "checkpoint.rename", "ingest.read_chunk",
                "multihost.init", "comm.ring_step", "serve.gather",
                "serving.publish", "serving.score", "solve.gram",
                "ingest.record", "mesh.device_lost")

MODES = ("raise", "corrupt", "hang")

ENV_VAR = "TPU_ALS_FAULT_SPEC"


class InjectedFault(IOError):
    """Raised by an armed ``raise``-mode fault point.

    Subclasses ``IOError`` deliberately: the injected failure stands in
    for a transient I/O error, so the retry policies
    (:mod:`tpu_als_torch.resilience.retry`) classify it as retryable."""

    def __init__(self, point, hit):
        super().__init__(
            f"injected fault at {point!r} (hit {hit}) — "
            f"{ENV_VAR} / tpu_als_torch.resilience.faults.install")
        self.point = point
        self.hit = hit


class FaultSpecError(ValueError):
    """A malformed ``TPU_ALS_FAULT_SPEC`` string."""


class _Rule:
    __slots__ = ("point", "mode", "hang_seconds", "sched", "k",
                 "prob", "_rng", "hits", "fired")

    def __init__(self, point, mode, hang_seconds, sched, k, prob, seed):
        self.point = point
        self.mode = mode
        self.hang_seconds = hang_seconds
        self.sched = sched
        self.k = k
        self.prob = prob
        self._rng = random.Random(seed) if sched == "prob" else None
        self.hits = 0      # times the point was reached
        self.fired = 0     # times the fault actually triggered

    def due(self):
        """Advance the hit counter and decide whether this hit fires."""
        self.hits += 1
        if self.sched == "nth":
            hit = self.hits == self.k
        elif self.sched == "first":
            hit = self.hits <= self.k
        elif self.sched == "every":
            hit = self.hits % self.k == 0
        else:  # prob
            hit = self._rng.random() < self.prob
        if hit:
            self.fired += 1
        return hit


def _parse_rule(text):
    text = text.strip()
    point, sep, rest = text.partition("=")
    point = point.strip()
    if not sep or not rest:
        raise FaultSpecError(
            f"fault rule {text!r} is not POINT=MODE[@SCHED]")
    if point not in FAULT_POINTS:
        raise FaultSpecError(
            f"unknown fault point {point!r} (known: {list(FAULT_POINTS)})")
    mode_part, _, sched_part = rest.partition("@")
    mode_part = mode_part.strip()
    hang_seconds = 0.0
    if mode_part.startswith("hang:"):
        mode = "hang"
        try:
            hang_seconds = float(mode_part[len("hang:"):])
        except ValueError:
            raise FaultSpecError(
                f"hang mode needs 'hang:SECONDS', got {mode_part!r}")
        if hang_seconds < 0:
            raise FaultSpecError("hang seconds must be >= 0")
    elif mode_part in ("raise", "corrupt"):
        mode = mode_part
    else:
        raise FaultSpecError(
            f"unknown fault mode {mode_part!r} (known: raise, corrupt, "
            "hang:SECONDS)")
    sched, k, prob, seed = "nth", 1, 0.0, 0
    sched_part = sched_part.strip()
    if sched_part and sched_part != "once":
        key, _, val = sched_part.partition("=")
        key = key.strip()
        if key in ("nth", "first", "every"):
            sched = key
            try:
                k = int(val)
            except ValueError:
                raise FaultSpecError(
                    f"schedule {sched_part!r}: K must be an integer")
            if k < 1:
                raise FaultSpecError(f"schedule {sched_part!r}: K must "
                                     "be >= 1")
        elif key == "prob":
            sched = "prob"
            body, _, seed_part = val.partition(",")
            try:
                prob = float(body)
            except ValueError:
                raise FaultSpecError(
                    f"schedule {sched_part!r}: P must be a float")
            if not 0.0 <= prob <= 1.0:
                raise FaultSpecError("prob must be in [0, 1]")
            if seed_part:
                skey, _, sval = seed_part.partition("=")
                if skey.strip() != "seed":
                    raise FaultSpecError(
                        f"schedule {sched_part!r}: expected ',seed=S'")
                try:
                    seed = int(sval)
                except ValueError:
                    raise FaultSpecError(
                        f"schedule {sched_part!r}: seed must be an "
                        "integer")
        else:
            raise FaultSpecError(
                f"unknown schedule {sched_part!r} (known: once, nth=K, "
                "first=N, every=K, prob=P[,seed=S])")
    return _Rule(point, mode, hang_seconds, sched, k, prob, seed)


def parse_spec(spec):
    """Parse a spec string into ``{point: _Rule}``; raises
    :class:`FaultSpecError` on any malformed rule."""
    rules = {}
    for part in spec.split(";"):
        if not part.strip():
            continue
        rule = _parse_rule(part)
        if rule.point in rules:
            raise FaultSpecError(
                f"fault point {rule.point!r} appears twice in the spec")
        rules[rule.point] = rule
    if not rules:
        raise FaultSpecError(f"empty fault spec {spec!r}")
    return rules


# the installed rule table; None = disarmed (the common case — check()
# is then one load + compare).  A lock guards install/clear against
# readers on other threads; the armed fast path reads one reference
# without taking it.
_rules = None
_lock = threading.Lock()

# saved rule tables for push_spec/pop_spec (scoped arming windows)
_stack = []


def install(spec):
    """Arm the harness: ``spec`` is a grammar string or a pre-parsed
    ``{point: _Rule}``.  Replaces any previous installation."""
    global _rules
    rules = parse_spec(spec) if isinstance(spec, str) else dict(spec)
    with _lock:
        _rules = rules
    return rules


def push_spec(spec):
    """Arm ``spec`` as a scoped overlay over the current rule table and
    save the previous table for :func:`pop_spec`.  Points named by
    ``spec`` get fresh rules; every other armed point keeps its rule (hit
    counters and all).  LIFO: every ``push_spec`` is paired with exactly
    one ``pop_spec``."""
    global _rules
    rules = parse_spec(spec) if isinstance(spec, str) else dict(spec)
    with _lock:
        _stack.append(_rules)
        base = dict(_rules) if _rules else {}
        base.update(rules)
        _rules = base
    return rules


def pop_spec():
    """Restore the rule table saved by the matching :func:`push_spec`
    (``None`` restores the disarmed state).  Raises ``RuntimeError`` on
    an unbalanced pop: a silent no-op would leave chaos armed."""
    global _rules
    with _lock:
        if not _stack:
            raise RuntimeError(
                "faults.pop_spec() without a matching push_spec()")
        _rules = _stack.pop()


def push_depth():
    """How many scoped specs are pushed."""
    with _lock:
        return len(_stack)


def install_from_env(environ=None):
    """Arm from ``TPU_ALS_FAULT_SPEC`` if set; no-op (and disarm) when
    unset.  Called once at import, callable again by tests."""
    spec = (environ if environ is not None else os.environ).get(ENV_VAR)
    if spec:
        return install(spec)
    clear()
    return None


def clear():
    """Disarm every fault point, and drop any scoped specs still
    pushed."""
    global _rules
    with _lock:
        _rules = None
        _stack.clear()


def active():
    """True when any fault point is armed."""
    return _rules is not None


def armed(point):
    """True when ``point`` specifically is armed: a call site uses this
    to skip its hook entirely when disarmed."""
    r = _rules
    return r is not None and point in r


def hits(point):
    """(times reached, times fired) for an armed point; (0, 0) when
    disarmed."""
    r = _rules
    if r is None or point not in r:
        return (0, 0)
    rule = r[point]
    return (rule.hits, rule.fired)


def check(point):
    """The fault point itself.  Returns ``None`` (continue normally) or
    ``"corrupt"`` (the caller must corrupt its artifact); raises
    :class:`InjectedFault` for raise mode; sleeps for hang mode.

    Disarmed cost: one module-attribute load and an ``is None`` test.
    """
    r = _rules
    if r is None:
        return None
    rule = r.get(point)
    if rule is None or not rule.due():
        return None
    _emit_fired(rule)
    if rule.mode == "raise":
        raise InjectedFault(point, rule.hits)
    if rule.mode == "hang":
        time.sleep(rule.hang_seconds)
        return None
    return "corrupt"


def _emit_fired(rule):
    """One ``fault_injected`` obs event per firing, once the obs module is
    loaded: it is looked up in ``sys.modules`` at the firing, as the
    reference does, so this module loads by file path on its own, without
    torch or the package."""
    obs = sys.modules.get("tpu_als_torch.obs")
    if obs is not None:
        obs.emit("fault_injected", point=rule.point, mode=rule.mode,
                 hit=rule.hits)


try:
    install_from_env()
except FaultSpecError as _e:
    # an unparseable spec must not kill every importer with a traceback,
    # but silently disarming chaos would be worse: leave the harness
    # disarmed with a warning; the CLI re-parses the spec and exits with
    # the typed error before a command runs, and explicit
    # install_from_env()/install() calls still raise
    warnings.warn(f"{ENV_VAR} is unparseable and was IGNORED (faults "
                  f"disarmed): {_e}", RuntimeWarning)
