"""The soak verdict: SLOs judged from the obs trail ALONE.

Counterpart of ``tpu_als/soak/verdict.py``, a copy of it (not a
re-export): the same checks from the same events, so either package's
judge re-derives the other's verdict.

``judge(events, config)`` consumes nothing but a list of event dicts —
the same records ``events.jsonl`` holds — and returns the full verdict:
serve p99 (worst window, victim-free tenants), freshness p99 (from the
``live.visible`` trace spans, whose ``seconds`` field IS the per-event
arrival→servable freshness), fairness ratio, shed rate, zero errors on
victim-free tenants, and every scheduled chaos injection observed AND
recovered.  Because the inputs are events only, the verdict is
re-derivable offline from a run dir copied off the host, pinned by a
test that runs this file with ``torch`` and ``tpu_als_torch``
unimportable.

Deliberately stdlib-only, ZERO torch and tpu_als_torch imports: runnable
as ``python tpu_als_torch/soak/verdict.py RUN_DIR`` on a machine with
nothing but Python.  The trail loader reads rotated
``events.NNN.jsonl`` files before the live one (duplicated from
``obs/report.py`` on purpose, as ``obs/explain.py`` duplicates it).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

# the judge's SLO knobs (the reference's); config overrides per key.
# slo_ms is generous for the CPU tests (chaos children compete for the
# same cores); callers may pass tighter bounds.
DEFAULTS = {
    "slo_ms": 1000.0,            # serve p99, victim-free tenants
    "freshness_slo_ms": 5623.5,  # arrival->servable p99 (bucket rung)
    "fairness_max": 3.0,         # max/min answered-rate across tenants
    "shed_max": 0.5,             # shed / offered, whole soak
}


def resolve_events_path(target):
    if os.path.isfile(target):
        return target
    for cand in (os.path.join(target, "obs", "events.jsonl"),
                 os.path.join(target, "events.jsonl")):
        if os.path.isfile(cand):
            return cand
    raise FileNotFoundError(
        f"no events.jsonl under {target!r} (expected <run>/obs/"
        "events.jsonl — was the command run with --output/--obs-dir?)")


def resolve_events_paths(target):
    live = resolve_events_path(target)
    d = os.path.dirname(live)
    if os.path.basename(live) != "events.jsonl":
        return [live]
    rotated = sorted(
        f for f in os.listdir(d)
        if f.startswith("events.") and f.endswith(".jsonl")
        and f != "events.jsonl")
    return [os.path.join(d, f) for f in rotated] + [live]


def load_events(target):
    events = []
    for path in resolve_events_paths(target):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    events.append(json.loads(line))
    return events


def p99(values):
    """Nearest-rank p99 of a plain list (None when empty)."""
    if not values:
        return None
    vs = sorted(values)
    return vs[max(0, math.ceil(0.99 * len(vs)) - 1)]


def _check(name, observed, op, expected, doc=""):
    ops = {"<=": lambda a, b: a <= b, ">=": lambda a, b: a >= b,
           "==": lambda a, b: a == b}
    ok = observed is not None and bool(ops[op](observed, expected))
    rec = {"check": name, "ok": ok, "observed": observed, "op": op,
           "expected": expected}
    if doc:
        rec["doc"] = doc
    return rec


def judge(events, config=None):
    """The verdict, from events alone.  Returns::

        {"passed": bool, "checks": [...], "survived_minutes": float,
         "worst_window_p99_ms", "freshness_p99_ms", "fairness_ratio",
         "shed_rate", "injections", "recoveries", "windows"}
    """
    cfg = dict(DEFAULTS)
    if config:
        cfg.update({k: v for k, v in config.items()
                    if k in DEFAULTS and v is not None})
    start = next((e for e in events if e.get("type") == "soak_start"),
                 None)
    windows = [e for e in events if e.get("type") == "soak_window"]
    injections = [e for e in events if e.get("type") == "soak_injection"]
    victims_by_window = {}
    for inj in injections:
        if inj.get("victim"):
            victims_by_window.setdefault(inj["window"], set()).add(
                inj["victim"])

    # serve p99: worst window over VICTIM-FREE tenants (a tenant a chaos
    # window targets may legitimately degrade; everyone else must hold)
    worst_p99 = None
    offered = answered = shed = 0
    victim_free_errors = 0
    per_tenant = {}     # tenant -> [answered, offered], victim-free only
    for wev in windows:
        w = wev.get("window")
        victims = victims_by_window.get(w, set())
        offered += wev.get("offered", 0)
        answered += wev.get("answered", 0)
        shed += wev.get("shed", 0)
        for name, t in (wev.get("tenants") or {}).items():
            if name in victims:
                continue
            victim_free_errors += t.get("errors", 0)
            q = t.get("p99_ms")
            if q is not None and (worst_p99 is None or q > worst_p99):
                worst_p99 = q
            acc = per_tenant.setdefault(name, [0, 0])
            acc[0] += t.get("answered", 0)
            acc[1] += t.get("offered", 0)

    # freshness: the live.visible span's seconds IS the per-event
    # arrival->servable freshness (tpu_als.live.updater's contract)
    fresh = [e.get("seconds") for e in events
             if e.get("type") == "trace_span"
             and e.get("name") == "live.visible"
             and e.get("seconds") is not None]
    fresh_p99_ms = (round(1e3 * p99(fresh), 3) if fresh else None)

    rates = [a / o for a, o in per_tenant.values() if o]
    fairness = (round(max(rates) / min(rates), 4)
                if rates and min(rates) > 0 else None)
    shed_rate = round(shed / offered, 4) if offered else 0.0

    recovered = sum(1 for i in injections
                    if i.get("fired") and i.get("recovered"))
    scheduled = (start or {}).get("scheduled_injections",
                                  len(injections))

    checks = [
        _check("windows_completed", len(windows), "==",
               (start or {}).get("windows", len(windows)),
               "every scheduled window ran and reported"),
        _check("serve_p99_victim_free", worst_p99, "<=", cfg["slo_ms"],
               "worst window p99 over tenants no chaos targeted"),
        _check("freshness_p99", fresh_p99_ms, "<=",
               cfg["freshness_slo_ms"],
               "arrival->servable p99 from live.visible spans"),
        _check("fairness_ratio", fairness, "<=", cfg["fairness_max"],
               "max/min answered-per-offered across victim-free "
               "tenant-windows"),
        _check("shed_rate", shed_rate, "<=", cfg["shed_max"],
               "shedding is the valve, not the norm"),
        _check("victim_free_errors", victim_free_errors, "==", 0,
               "tenants no chaos window targeted never erred"),
        _check("injections_observed", len(injections), "==", scheduled,
               "every scheduled chaos injection left a soak_injection "
               "record"),
        _check("injections_recovered", recovered, "==", scheduled,
               "every injection fired AND its recovery evidence is in "
               "the trail"),
    ]
    window_s = (start or {}).get("window_s", 0.0)
    result = {
        "passed": all(c["ok"] for c in checks),
        "checks": checks,
        "windows": len(windows),
        "survived_minutes": round(len(windows) * window_s / 60.0, 3),
        "worst_window_p99_ms": worst_p99,
        "freshness_p99_ms": fresh_p99_ms,
        "freshness_samples": len(fresh),
        "fairness_ratio": fairness,
        "shed_rate": shed_rate,
        "offered": offered,
        "answered": answered,
        "injections": len(injections),
        "recoveries": recovered,
    }
    return result


def render(result):
    """The human verdict table (the CLI's stdout)."""
    lines = [f"soak: {'PASS' if result['passed'] else 'FAIL'}  "
             f"({result['windows']} windows, "
             f"{result['survived_minutes']} survived-minutes, "
             f"{result['answered']}/{result['offered']} answered)"]
    for c in result["checks"]:
        mark = "ok  " if c["ok"] else "FAIL"
        lines.append(f"  {mark} {c['check']:<24} "
                     f"{c['observed']} {c['op']} {c['expected']}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="verdict",
        description="re-derive the soak verdict from a run dir's "
                    "events.jsonl alone (stdlib-only; torch-free)")
    ap.add_argument("run_dir", help="run dir / obs dir / events.jsonl")
    ap.add_argument("--json", dest="as_json", action="store_true")
    for key, dv in DEFAULTS.items():
        ap.add_argument("--" + key.replace("_", "-"), dest=key,
                        type=float, default=None,
                        help=f"override (default {dv})")
    args = ap.parse_args(argv)
    try:
        events = load_events(args.run_dir)
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return 2
    result = judge(events, {k: getattr(args, k) for k in DEFAULTS})
    print(json.dumps(result) if args.as_json else render(result))
    return 0 if result["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
