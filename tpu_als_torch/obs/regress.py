"""Bench regression gate: judge the committed bench-series artifacts.

Counterpart of ``tpu_als/obs/regress.py``, the port's own copy (stdlib
only: it imports neither torch nor the reference).  The repo banks one
JSON artifact per sweep round (``BENCH_rNN.json``, ``MULTICHIP_rNN.json``)
plus direct single-point banks (``BENCH_serve_cpu.json``).  ``check()``
classifies every artifact, rebuilds each series, and returns typed
findings with a typed exit code:

- 0  OK: warnings at most (historical nulls, unparseable rounds);
- 1  REGRESSION: the latest effective value is worse than the best
     previous one beyond the noise band (the direction from the unit:
     ``iters/sec`` up is good, ``ms``/``s`` down is good), the latest
     multichip round is failing, or (with ``trend=True``) the
     least-squares fit over the last ``trend_window`` rounds drifts the
     worse way beyond the band;
- 2  NULL BANK: the latest round banked ``value: null`` with no
     same-round fallback, or a direct bank carries a null value;
- 3  PROVENANCE: a direct bank lacks a timezone-aware ``banked_at``.

Historical nulls are warnings (``--strict`` makes them errors).  A null
round whose wrapper carries a same-round sweep fallback counts as
measured at that value.  ``observe regress`` runs it.
"""

from __future__ import annotations

import datetime
import glob
import json
import os
import re

EXIT_OK = 0
EXIT_REGRESSION = 1
EXIT_NULL_BANK = 2
EXIT_PROVENANCE = 3

# units where a larger number is a worse result
_LOWER_BETTER = ("ms", "s", "seconds", "sec", "s/iter", "seconds/iter")

_ROUND_RE = re.compile(r"^(?P<series>.+)_r(?P<n>\d+)\.json$")


def _finding(severity, code, where, message):
    return {"severity": severity, "code": code, "where": where,
            "message": message}


def _effective_value(payload):
    """The value a wrapper round actually measured: ``value``, else the
    same-round sweep fallback's value."""
    if payload.get("value") is not None:
        return float(payload["value"]), "value"
    fb = payload.get("last_builder_measured") or {}
    if fb.get("value") is not None:
        return float(fb["value"]), "sweep_fallback"
    return None, None


def _tz_aware(stamp):
    try:
        dt = datetime.datetime.fromisoformat(
            str(stamp).replace("Z", "+00:00"))
    except ValueError:
        return False
    return dt.tzinfo is not None


def _trend_drift(window):
    """Least-squares slope over the series window, normalized to a
    fractional drift across it: ``slope * (npts - 1) / y-intercept``.
    A -0.04 means the fitted line loses 4% of its starting value over
    the window.  Fitting the LINE (not latest-vs-best) is the point:
    a single lucky latest round can sit inside the noise band of the
    best prior value while the fit still shows a sustained slide."""
    n = len(window)
    xbar = (n - 1) / 2.0
    ybar = sum(window) / n
    num = sum((i - xbar) * (y - ybar) for i, y in enumerate(window))
    den = sum((i - xbar) ** 2 for i in range(n))
    slope = num / den
    y0 = ybar - slope * xbar
    if y0 == 0:
        return 0.0
    return slope * (n - 1) / y0


def _check_trend(name, points, noise, trend_window, findings):
    """Direction-aware trend gate over the series tail.  Needs >= 3
    effective points (a 2-point 'trend' is just latest-vs-prior, which
    the plain gate already judges); drift toward the worse direction
    beyond the noise band is a REGRESSION even when the latest value
    alone survives the latest-vs-best check."""
    if len(points) < 3:
        return
    unit = points[-1][3] or ""
    lower_better = unit in _LOWER_BETTER
    window = [v for _, v, _, _ in points[-min(trend_window, len(points)):]]
    drift = _trend_drift(window)
    worse = drift > 0 if lower_better else drift < 0
    if worse and abs(drift) > noise:
        latest_n = points[-1][0]
        word = "rising" if lower_better else "falling"
        findings.append(_finding(
            "error", EXIT_REGRESSION, f"{name}_r{latest_n:02d}.json",
            f"series {name}: trend over the last {len(window)} rounds is "
            f"{word} {abs(drift):.1%} ({unit}), beyond the {noise:.0%} "
            "noise band — sustained drift even though the latest round "
            "alone may pass"))


def _check_bench_series(name, rounds, noise, strict, findings,
                        trend=False, trend_window=5):
    """``rounds``: sorted [(n, fname, doc)] of ``{n, rc, parsed}``
    wrappers.  Appends findings; returns nothing."""
    last_n = rounds[-1][0]
    points = []                     # (n, value, source, unit)
    for n, fname, doc in rounds:
        payload = doc.get("parsed")
        if payload is None:
            sev = "error" if strict else "warning"
            findings.append(_finding(
                sev, EXIT_NULL_BANK if strict else EXIT_OK, fname,
                f"round {n} banked no parseable bench payload "
                f"(rc={doc.get('rc')})"))
            continue
        value, source = _effective_value(payload)
        if value is None:
            latest = n == last_n
            sev = "error" if (latest or strict) else "warning"
            findings.append(_finding(
                sev, EXIT_NULL_BANK if sev == "error" else EXIT_OK, fname,
                f"round {n} banked value: null with no same-round "
                f"fallback ({payload.get('error') or 'no error recorded'})"
                + ("" if latest else " [historical]")))
            continue
        if source == "sweep_fallback":
            findings.append(_finding(
                "info", EXIT_OK, fname,
                f"round {n} value {value} recovered via "
                "last_builder_measured sweep fallback"))
        points.append((n, value, source, payload.get("unit")))

    if len(points) < 2:
        return
    unit = points[-1][3] or ""
    lower_better = unit in _LOWER_BETTER
    latest_n, latest, _, _ = points[-1]
    prior = [v for _, v, _, _ in points[:-1]]
    best = min(prior) if lower_better else max(prior)
    regressed = (latest > best * (1.0 + noise) if lower_better
                 else latest < best * (1.0 - noise))
    if regressed:
        direction = "above" if lower_better else "below"
        findings.append(_finding(
            "error", EXIT_REGRESSION, f"{name}_r{latest_n:02d}.json",
            f"series {name}: latest {latest} {unit} is {direction} the "
            f"best prior {best} {unit} beyond the {noise:.0%} noise band"))
    if trend:
        _check_trend(name, points, noise, trend_window, findings)


def _check_multichip_series(name, rounds, strict, findings):
    """Pass/fail rounds (``{n_devices, rc, ok, skipped}``): the latest
    must be passing; historical failures are warnings."""
    last_n = rounds[-1][0]
    for n, fname, doc in rounds:
        if doc.get("skipped"):
            continue
        if not doc.get("ok"):
            latest = n == last_n
            sev = "error" if (latest or strict) else "warning"
            findings.append(_finding(
                sev, EXIT_REGRESSION if sev == "error" else EXIT_OK, fname,
                f"round {n} multichip run failing (rc={doc.get('rc')})"
                + ("" if latest else " [historical]")))


def _check_direct_bank(fname, doc, findings):
    """Single-point bank (``{metric, value, unit, ..., banked_at}``)."""
    if doc.get("value") is None:
        findings.append(_finding(
            "error", EXIT_NULL_BANK, fname,
            f"direct bank {doc.get('metric')!r} carries value: null"))
    stamp = doc.get("banked_at")
    if stamp is None:
        findings.append(_finding(
            "error", EXIT_PROVENANCE, fname,
            f"direct bank {doc.get('metric')!r} is missing banked_at "
            "provenance"))
    elif not _tz_aware(stamp):
        findings.append(_finding(
            "error", EXIT_PROVENANCE, fname,
            f"direct bank {doc.get('metric')!r} banked_at={stamp!r} is "
            "not a timezone-aware ISO stamp"))


def check(root=".", noise=0.10, strict=False, files=None, trend=False,
          trend_window=5):
    """Gate every bench artifact under ``root`` (or the explicit
    ``files`` list).  Returns ``{"findings", "exit_code", "series",
    "checked"}`` — exit_code is the max error code found (0 when only
    warnings/info survive).  ``trend=True`` additionally fits the last
    ``trend_window`` effective points of each series and flags a
    sustained drift in the worse direction beyond the noise band — the
    gate that catches a slow decline the latest-vs-best check misses
    when each individual round stays inside the band (needs >= 3
    effective points; shorter series are plain-gated only)."""
    if files is None:
        files = sorted(glob.glob(os.path.join(root, "BENCH_*.json"))
                       + glob.glob(os.path.join(root, "MULTICHIP_*.json")))
    findings = []
    series = {}                     # name -> [(n, fname, doc)]
    checked = []
    for path in files:
        fname = os.path.basename(path)
        checked.append(fname)
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            findings.append(_finding(
                "error", EXIT_NULL_BANK, fname,
                f"unreadable bench artifact: {e}"))
            continue
        m = _ROUND_RE.match(fname)
        if m and isinstance(doc, dict) and "rc" in doc:
            series.setdefault(m.group("series"), []).append(
                (int(m.group("n")), fname, doc))
        elif isinstance(doc, dict) and "metric" in doc and "value" in doc:
            _check_direct_bank(fname, doc, findings)
        else:
            findings.append(_finding(
                "warning", EXIT_OK, fname,
                "unrecognized bench artifact shape (neither a _rNN "
                "round wrapper nor a metric/value bank)"))

    for name, rounds in sorted(series.items()):
        rounds.sort()
        if any("parsed" in doc for _, _, doc in rounds):
            _check_bench_series(name, rounds, noise, strict, findings,
                                trend=trend, trend_window=trend_window)
        else:
            _check_multichip_series(name, rounds, strict, findings)

    exit_code = max(
        (f["code"] for f in findings if f["severity"] == "error"),
        default=EXIT_OK)
    return {
        "findings": findings,
        "exit_code": exit_code,
        "series": {name: [fname for _, fname, _ in rounds]
                   for name, rounds in sorted(series.items())},
        "checked": checked,
        "noise": float(noise),
        "strict": bool(strict),
        "trend": bool(trend),
        "trend_window": int(trend_window),
    }


def render(result):
    """Human-readable verdict for ``tpu_als observe regress``."""
    lines = [f"bench regression gate — {len(result['checked'])} "
             f"artifact(s), noise band {result['noise']:.0%}"
             + (" [strict]" if result["strict"] else "")
             + (f" [trend window {result['trend_window']}]"
                if result.get("trend") else "")]
    if not result["checked"]:
        lines.append("  (no BENCH_*/MULTICHIP_* artifacts found)")
    for f in result["findings"]:
        lines.append(f"  {f['severity'].upper():<8}{f['where']}: "
                     f"{f['message']}")
    if not result["findings"]:
        lines.append("  all clean")
    verdict = {EXIT_OK: "OK", EXIT_REGRESSION: "REGRESSION",
               EXIT_NULL_BANK: "NULL BANK",
               EXIT_PROVENANCE: "PROVENANCE"}[result["exit_code"]]
    lines.append(f"verdict: {verdict} (exit {result['exit_code']})")
    return "\n".join(lines)
