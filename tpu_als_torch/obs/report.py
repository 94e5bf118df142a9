"""Render a run directory's JSONL into a per-phase timing report.

Counterpart of ``tpu_als/obs/report.py``: the ``observe summarize`` and
``observe tail`` commands of ``python -m tpu_als_torch.cli``.  Pure
stdlib: it reads only what ``obs.finalize`` wrote (``events.jsonl``, its
rotations ``events.NNN.jsonl``, ``run_manifest.json``), so it works on a
run directory copied off the machine that trained.  The phases it tables
are the port's spans (``cli.<cmd>``, ``data.load``, ``train.block``,
``train.fit``, ``serve_bench.*``, ...).
"""

from __future__ import annotations

import json
import os


def resolve_events_path(target):
    """Accept a run dir (``<output>``), its obs dir (``<output>/obs``),
    or the events file itself."""
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
    """Every file of a possibly-rotated trail, in emission order: the
    ``events.NNN.jsonl`` rotations sorted numerically, then the live
    ``events.jsonl`` (obs.metrics.maybe_rotate writes them that way).
    A bare file target reads as a one-file trail."""
    live = resolve_events_path(target)
    d = os.path.dirname(live)
    base = os.path.basename(live)
    if base != "events.jsonl":
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


def filter_window(events, since=None, window=None):
    """Slice a trail by RELATIVE seconds from its first event's ts:
    ``since=S`` keeps events at/after t0+S; ``window="A:B"`` keeps
    ``t0+A <= ts < t0+B`` (either side of the colon may be empty).
    Soak trails are sliced per chaos window with exactly this."""
    if since is None and window is None:
        return events
    if not events:
        return events
    t0 = events[0].get("ts") or 0.0
    lo = hi = None
    if since is not None:
        lo = t0 + float(since)
    if window is not None:
        a, sep, b = str(window).partition(":")
        if not sep:
            raise ValueError(
                f"--window takes 'A:B' relative seconds, got {window!r}")
        if a.strip():
            wlo = t0 + float(a)
            lo = wlo if lo is None else max(lo, wlo)
        if b.strip():
            hi = t0 + float(b)
    return [ev for ev in events
            if (lo is None or (ev.get("ts") or 0.0) >= lo)
            and (hi is None or (ev.get("ts") or 0.0) < hi)]


def load_manifest(target):
    path = os.path.join(os.path.dirname(resolve_events_path(target)),
                        "run_manifest.json")
    if os.path.isfile(path):
        with open(path) as f:
            return json.load(f)
    return None


def summarize_events(events):
    """Aggregate an event list into the report dict ``render_summary``
    prints (also the ``observe summarize --json`` payload)."""
    spans = {}
    iterations = []
    gauges = {}
    warnings = []
    ingest = {"rows": 0, "bytes": 0, "seconds": 0.0, "stall_seconds": 0.0,
              "calls": 0}
    snapshot = None
    for ev in events:
        t = ev.get("type")
        if t == "span":
            s = spans.setdefault(ev["path"], {"count": 0, "total_seconds": 0.0,
                                              "max_seconds": 0.0})
            s["count"] += 1
            s["total_seconds"] += ev["seconds"]
            s["max_seconds"] = max(s["max_seconds"], ev["seconds"])
        elif t == "iteration":
            iterations.append(ev)
        elif t == "metric" and ev.get("kind") == "gauge":
            labels = ev.get("labels") or {}
            lab = ("{" + ",".join(f'{k}="{v}"' for k, v
                                  in sorted(labels.items())) + "}"
                   if labels else "")
            gauges[ev["name"] + lab] = ev["value"]
        elif t == "ingest":
            ingest["calls"] += 1
            for k in ("rows", "bytes", "seconds", "stall_seconds"):
                ingest[k] += ev.get(k, 0)
        elif t == "warning":
            warnings.append(ev)
        elif t == "snapshot":
            snapshot = ev
    for s in spans.values():
        s["total_seconds"] = round(s["total_seconds"], 6)
        # derived from the rounded total WITHOUT re-rounding: a 6-decimal
        # round of the mean breaks mean == total/count whenever the total
        # is an odd number of microseconds (sub-µs spans in tests)
        s["mean_seconds"] = s["total_seconds"] / s["count"]
    out = {"phases": spans, "iterations": iterations, "gauges": gauges,
           "warnings": warnings}
    if ingest["calls"]:
        ingest["rows_per_sec"] = round(
            ingest["rows"] / ingest["seconds"], 2) if ingest["seconds"] \
            else None
        out["ingest"] = ingest
    if snapshot is not None:
        out["counters"] = snapshot.get("counters", {})
        out["histograms"] = snapshot.get("histograms", {})
        # snapshot gauges cover anything set before the events we read
        for k, v in (snapshot.get("gauges") or {}).items():
            gauges.setdefault(k, v)
        serve = {k: v for k, v in out["histograms"].items()
                 if k.startswith("serve.request_seconds")}
        rows = sum(v for k, v in out["counters"].items()
                   if k.startswith("serve.rows"))
        secs = sum(v["sum"] for v in serve.values())
        reqs = sum(v["count"] for v in serve.values())
        if reqs:
            out["serve"] = {"requests": reqs, "rows": rows,
                            "seconds": round(secs, 6),
                            "rows_per_sec": (round(rows / secs, 2)
                                             if secs else None)}
    return out


def _fmt_secs(v):
    return f"{v:.4f}s" if v < 100 else f"{v:.1f}s"


def render_summary(summary, manifest=None):
    lines = []
    if manifest:
        head = "run: " + " ".join(manifest.get("argv") or [])
        git = manifest.get("git")
        lines.append(head.rstrip())
        lines.append(
            "  tpu_als_torch " + str(manifest.get("tpu_als_torch_version"))
            + (f" ({git})" if git else "")
            + f" | torch {manifest.get('torch')}"
            + f" | devices {manifest.get('device_count', '?')}"
            + f" ({manifest.get('device_name', '?')})")
    phases = summary.get("phases") or {}
    if phases:
        lines.append("phases:")
        width = max(len(p) for p in phases)
        lines.append(f"  {'path':<{width}}  {'count':>5}  {'total':>10}"
                     f"  {'mean':>10}  {'max':>10}")
        for path in sorted(phases, key=lambda p: -phases[p]["total_seconds"]):
            s = phases[path]
            lines.append(
                f"  {path:<{width}}  {s['count']:>5}"
                f"  {_fmt_secs(s['total_seconds']):>10}"
                f"  {_fmt_secs(s['mean_seconds']):>10}"
                f"  {_fmt_secs(s['max_seconds']):>10}")
    iterations = summary.get("iterations") or []
    if iterations:
        lines.append("iterations:")
        lines.append(f"  {'it':>4}  {'seconds':>9}  {'total':>9}"
                     f"  {'probe_rmse':>10}  {'u_norm':>8}  {'v_norm':>8}")
        for ev in iterations:
            rmse = ev.get("probe_rmse")
            row = (f"  {ev['iteration']:>4}  {ev['seconds']:>9.4f}"
                   f"  {ev['total_seconds']:>9.4f}")
            row += (f"  {rmse:>10.4f}" if rmse is not None
                    else f"  {'-':>10}")
            row += (f"  {ev.get('u_norm', float('nan')):>8.4f}"
                    f"  {ev.get('v_norm', float('nan')):>8.4f}")
            lines.append(row)
    gauges = summary.get("gauges") or {}
    if gauges:
        lines.append("gauges:")
        for k in sorted(gauges):
            v = gauges[k]
            extra = ""
            if k.startswith("train.comm_bytes_per_iter"):
                extra = f"  ({v / 1e6:.3g} MB/device/iter)"
            lines.append(f"  {k} = {v}{extra}")
    counters = summary.get("counters") or {}
    if counters:
        lines.append("counters:")
        for k in sorted(counters):
            lines.append(f"  {k} = {counters[k]}")
    hists = summary.get("histograms") or {}
    if hists:
        lines.append("histograms:")
        for k in sorted(hists):
            h = hists[k]
            lines.append(
                f"  {k}: count={h['count']} sum={h['sum']:.6g}"
                f" p50={h['p50']:.3g} p95={h['p95']:.3g}"
                f" max={h['max']:.6g}")
    for key, label in (("ingest", "ingest"), ("serve", "serve")):
        blk = summary.get(key)
        if blk:
            rate = blk.get("rows_per_sec")
            lines.append(
                f"{label}: {blk['rows']:,} rows in {blk['seconds']:.4f}s"
                + (f" ({rate:,.0f} rows/sec)" if rate else ""))
    warnings = summary.get("warnings") or []
    for w in warnings:
        lines.append(f"warning: {w.get('what')}: {w.get('reason')}")
    if not lines:
        lines.append("(no events)")
    return "\n".join(lines)


def cmd_summarize(target, as_json=False, since=None, window=None):
    events = filter_window(load_events(target), since=since,
                           window=window)
    summary = summarize_events(events)
    manifest = load_manifest(target)
    if as_json:
        if manifest is not None:
            summary["manifest"] = manifest
        return json.dumps(summary, default=str)
    return render_summary(summary, manifest)


def cmd_tail(target, n=20, event=None, tenant=None, trace=None):
    """Last ``n`` raw events, optionally filtered by declared type
    (``event=``), by ``tenant=`` label, or by causal trace (``trace=``
    matches an event's ``trace_id`` or membership in its ``trace_ids``
    list, so publishes linked to the trace show up too).  All filters
    apply BEFORE the tail slice, so ``--event flight_record -n 8`` is
    the last 8 flight records, not whatever flight records happen to
    sit in the last 8 lines — and ``--tenant b -n 8`` is tenant b's
    last 8 events even if tenant a wrote the last thousand lines."""
    events = load_events(target)
    if event is not None:
        events = [ev for ev in events if ev.get("type") == event]
    if tenant is not None:
        events = [ev for ev in events if ev.get("tenant") == tenant]
    if trace is not None:
        events = [ev for ev in events
                  if ev.get("trace_id") == trace
                  or trace in (ev.get("trace_ids") or ())]
    return "\n".join(json.dumps(ev) for ev in events[-n:])
