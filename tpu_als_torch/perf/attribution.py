"""Stage attribution: measure where an ALS iteration's time goes.

Counterpart of ``tpu_als/perf/attribution.py``.  ``perf/roofline.py``
models what each stage of an iteration should cost from bytes and
FLOPs; this module measures what each stage costs and joins the two
into a gap table.

The production iteration (``core.als.als_step``) enqueues its kernels
back to back and waits for none of them, so it cannot be fence-timed
from outside.  Attribution runs a decomposed twin of
``core.als.local_half_step`` instead: the same routes, the same chunks
and the same calls, each stage wrapped in an ``obs.trace.stage`` fence
(a device synchronize), with the per-iteration-invariant prep (the
buckets' chunk split, the rating stream's cast to the compute dtype)
hoisted out.  'auto' picks a route per bucket from its width
(``core.als.resolve_solve_path``), so each bucket is fenced under its own
route's stages, named as the roofline's:

- a K4 bucket (``gatherfused_solve``): one stage, ``gather_fused_solve``;
- a K3 bucket (``gatherfused+...``): ``gather_fused_ne``, then ``solve``
  (K1 up to rank 128, K6 above);
- an unfused bucket (``einsum+...``): ``gather_stream`` (``V[cols]``),
  ``normal_eq`` and ``solve`` (K2 or K6; NNLS when nonnegative);

every route ends with ``scatter``, and implicit fits add ``yty``.  The
roofline prices each stage over the buckets that ran it (its
``ne_path='auto'`` splits the iteration at the same split width).
The CG routes have no twin (:class:`AttributionUnsupported`).

The twin loses the overlap of host and device across stages, so its wall
clock is an upper bound on the production iteration's;
:func:`measure_attributed` times the production iteration beside it.
``core.als.train`` reaches this module only when
``obs.trace.stage_attribution_armed()``; disarmed, the iteration runs as
it is.
"""

from __future__ import annotations

import time

import torch

from tpu_als_torch.core import als
from tpu_als_torch.obs import trace
from tpu_als_torch.ops import cuda_gather_ne as gne
from tpu_als_torch.ops.solve import (compute_yty, normal_eq_explicit,
                                     normal_eq_implicit, solve_nnls,
                                     solve_spd)
from tpu_als_torch.utils.platform import resolve_device


class AttributionUnsupported(ValueError):
    """The configuration resolves to a route with no decomposed twin (the
    CG routes): attribution covers the exact routes."""


def _bucket_plan(buckets, cfg, rank, chunk_elems, split_width):
    """Each bucket's route and its chunks as ``local_half_step`` cuts
    them at ``split_width``, the rating stream cast to the compute dtype
    once."""
    cdt = getattr(torch, cfg.compute_dtype)
    plan = []
    for b in buckets:
        nb, w = b.cols.shape
        path = als.resolve_solve_path(cfg, rank, w, split_width)
        vals, mask = b.vals.to(cdt), b.mask.to(cdt)
        step = als._chunk_rows(path, nb, w, rank, chunk_elems, split_width)
        plan.append({"path": path, "rows": b.rows, "chunks": [
            (b.cols[s:s + step], vals[s:s + step], mask[s:s + step])
            for s in range(0, nb, step)]})
    return plan


def make_attributed_step(user_buckets, item_buckets, num_users, num_items,
                         cfg: als.AlsConfig, user_chunk_elems=1 << 19,
                         item_chunk_elems=1 << 19, sink=None, knobs=None):
    """The decomposed, fence-timed twin of ``core.als.als_step``.

    ``user_buckets``/``item_buckets``: each side's buckets as tensors
    (``CsrBuckets.to``); ``knobs``: the kernel knobs, as
    ``core.als.local_half_step``'s (None or an absent knob: the module
    constant, read here).  Returns ``step(U, V) -> (U, V)``, the same
    iteration (the item half-step, then the user half-step) with each
    stage in an ``obs.trace.stage`` fence: its seconds land in
    ``train.stage_seconds{stage=...}`` and, with a ``sink`` dict, add up
    there by stage name.
    """
    if cfg.cg_iters > 0:
        raise AttributionUnsupported(
            f"no decomposed twin for cg_iters={cfg.cg_iters} (attribution "
            "covers the exact routes)")
    r = cfg.rank
    cdt = getattr(torch, cfg.compute_dtype)
    reg, alpha, jitter = cfg.reg_param, cfg.alpha, cfg.jitter
    knobs = knobs or {}
    split = als._split(knobs.get("split_width"))
    scratch = knobs.get("scratch_elems")
    item_plan = _bucket_plan(item_buckets, cfg, r, item_chunk_elems, split)
    user_plan = _bucket_plan(user_buckets, cfg, r, user_chunk_elems, split)

    def fused_solve(V_comp, c, v, m, YtY):
        if cfg.implicit_prefs:
            return gne.gather_fused_solve_implicit(
                V_comp, c, v, m, reg, alpha, YtY, jitter=jitter,
                scratch_elems=scratch)
        return gne.gather_fused_solve_explicit(V_comp, c, v, m, reg,
                                               jitter=jitter,
                                               scratch_elems=scratch)

    def fused_ne(V_comp, c, v, m, YtY):
        if cfg.implicit_prefs:
            return gne.gather_normal_eq_implicit(
                V_comp, c, v, m, reg, alpha, YtY, split_width=split)
        return gne.gather_normal_eq_explicit(V_comp, c, v, m, reg,
                                             split_width=split)

    def normal_eq(Vg, v, m, YtY):
        if cfg.implicit_prefs:
            return normal_eq_implicit(Vg, v, m, reg, alpha, YtY.float())
        return normal_eq_explicit(Vg, v, m, reg)

    def solve(path, A, rhs, count):
        if cfg.nonnegative:
            return solve_nnls(A, rhs, count, sweeps=cfg.nnls_sweeps,
                              jitter=jitter)
        return solve_spd(A, rhs, count, jitter=jitter,
                         backend=als._SOLVER_BACKEND.get(
                             path.partition("+")[2]),
                         adaptive=cfg.adaptive_solve)

    def half_step(V_full, plan, num_rows, YtY):
        with trace.stage("gather_stream", sink) as keep:
            V_comp = keep(V_full.to(cdt).contiguous())
        with trace.stage("scatter", sink) as keep:
            # one spare row takes the padding rows' scatter
            out = keep(torch.zeros(num_rows + 1, r, dtype=torch.float32,
                                   device=V_full.device))
        for b in plan:
            path, xs = b["path"], []
            for c, v, m in b["chunks"]:
                if path in als._K4_PATHS:
                    with trace.stage("gather_fused_solve", sink) as keep:
                        xs.append(keep(fused_solve(V_comp, c, v, m, YtY)))
                    continue
                if path.startswith("gatherfused+"):
                    with trace.stage("gather_fused_ne", sink) as keep:
                        A, rhs, count = keep(fused_ne(V_comp, c, v, m, YtY))
                else:
                    with trace.stage("gather_stream", sink) as keep:
                        Vg = keep(V_comp[c.long()])
                    with trace.stage("normal_eq", sink) as keep:
                        A, rhs, count = keep(normal_eq(Vg, v, m, YtY))
                    del Vg
                with trace.stage("solve", sink) as keep:
                    xs.append(keep(solve(path, A, rhs, count)))
                del A, rhs, count
            with trace.stage("scatter", sink) as keep:
                out[b["rows"]] = torch.cat(xs)
                keep(out)
        return out[:num_rows]

    def step(U, V):
        if cfg.implicit_prefs:
            with trace.stage("yty", sink) as keep:
                yty_u = keep(compute_yty(U))
            V = half_step(U, item_plan, num_items, yty_u)
            with trace.stage("yty", sink) as keep:
                yty_v = keep(compute_yty(V))
            U = half_step(V, user_plan, num_users, yty_v)
        else:
            V = half_step(U, item_plan, num_items, None)
            U = half_step(V, user_plan, num_users, None)
        return U, V

    step.routes = {}
    for b in item_plan + user_plan:
        step.routes[b["path"]] = step.routes.get(b["path"], 0) + 1
    return step


def roofline_ne_path(routes):
    """The roofline ``ne_path`` that prices an iteration whose buckets
    ran ``routes`` (route labels): 'auto' when K4 and K3 buckets are
    mixed."""
    k4 = any(p in als._K4_PATHS for p in routes)
    k3 = any(p.startswith("gatherfused+") for p in routes)
    if k4 and k3:
        return "auto"
    if k4:
        return "gather_fused_solve"
    if k3:
        return "gather_fused"
    return "einsum"


def _timed_iterations(step, U, V, warmup, iters, before=None):
    for _ in range(warmup):
        U, V = step(U, V)
    trace.fence((U, V))
    if before is not None:
        before()
    t0 = time.perf_counter()
    for _ in range(iters):
        U, V = step(U, V)
    trace.fence((U, V))
    return (time.perf_counter() - t0) / iters


def measure_attributed(user_csr, item_csr, cfg: als.AlsConfig, iters=2,
                       warmup=1, compare_fused=True, device=None):
    """``iters`` fence-timed attributed iterations (after ``warmup``
    untimed ones) from the seeded init of ``core.als.train``, on
    ``device`` (None: the card).

    With ``compare_fused`` the production iteration is timed on the same
    problem, the same way, so the report states the twin's overhead.
    Returns ``stage_seconds`` (per iteration, by roofline stage name),
    ``wall_s_per_iter``, ``coverage`` (sum of stages / wall),
    ``unattributed_s_per_iter``, ``fused_s_per_iter``, the buckets per
    route (``routes``), ``resolved_solve_path`` (the routes' labels) and
    the roofline ``ne_path`` that prices them.
    """
    device = resolve_device(device)
    num_users, num_items = user_csr.num_rows, item_csr.num_rows
    ub, ib = user_csr.to(device), item_csr.to(device)

    def init():
        g = torch.Generator().manual_seed(int(cfg.seed))
        return (als.init_factors(num_users, cfg.rank, g).to(device),
                als.init_factors(num_items, cfg.rank, g).to(device))

    sink = {}
    with trace.stage_attribution():
        astep = make_attributed_step(
            ub, ib, num_users, num_items, cfg, user_csr.chunk_elems,
            item_csr.chunk_elems, sink=sink)
        wall = _timed_iterations(astep, *init(), warmup, iters, sink.clear)

    stage_seconds = {k: v / iters for k, v in sink.items()}
    attributed = sum(stage_seconds.values())
    out = {
        "stage_seconds": stage_seconds,
        "wall_s_per_iter": wall,
        "sum_stage_s_per_iter": attributed,
        "coverage": attributed / wall if wall else 0.0,
        "unattributed_s_per_iter": wall - attributed,
        "resolved_solve_path": ", ".join(sorted(astep.routes)),
        "routes": dict(astep.routes),
        "ne_path": roofline_ne_path(astep.routes),
        "iters": int(iters), "warmup": int(warmup),
    }
    if compare_fused:
        def step(U, V):
            return als.als_step(U, V, ub, ib, num_users, num_items, cfg,
                                user_csr.chunk_elems, item_csr.chunk_elems)

        out["fused_s_per_iter"] = _timed_iterations(step, *init(), warmup,
                                                    iters)
    return out


def attribution_report(measured, rl):
    """Join measured per-stage seconds against a ``roofline()`` report.

    One row per stage present in either side (a modeled stage with no
    measurement shows measured None; a measured stage the model lacks
    shows floor None), each with gap × (measured / modeled floor) and %
    of the measured iteration.
    """
    wall = measured["wall_s_per_iter"]
    stage_s = dict(measured["stage_seconds"])
    rows = []
    for s in rl["stages"]:
        m = stage_s.pop(s["name"], None)
        rows.append({
            "stage": s["name"], "measured_s": m,
            "floor_s": s["floor_seconds"], "bound": s["bound"],
            "gap_x": (m / s["floor_seconds"]
                      if m is not None and s["floor_seconds"] else None),
            "pct_of_iter": (100.0 * m / wall
                            if m is not None and wall else None),
        })
    for name, m in sorted(stage_s.items()):
        rows.append({"stage": name, "measured_s": m, "floor_s": None,
                     "bound": None, "gap_x": None,
                     "pct_of_iter": 100.0 * m / wall if wall else None})
    report = {
        "config": rl["config"],
        "rows": rows,
        "wall_s_per_iter": wall,
        "sum_stage_s_per_iter": measured["sum_stage_s_per_iter"],
        "unattributed_s_per_iter": measured["unattributed_s_per_iter"],
        "coverage": measured["coverage"],
        "roofline_floor_s_per_iter": rl["roofline_floor_s_per_iter"],
        "resolved_solve_path": measured["resolved_solve_path"],
        "iters": measured["iters"],
    }
    if "routes" in measured:
        report["routes"] = measured["routes"]
    if "fused_s_per_iter" in measured:
        report["fused_s_per_iter"] = measured["fused_s_per_iter"]
        report["attribution_overhead_x"] = (
            wall / measured["fused_s_per_iter"]
            if measured["fused_s_per_iter"] else None)
    return report


def render_attribution(report):
    """Human-readable gap table for ``observe attribution``."""
    c = report["config"]
    lines = [
        ("ALS stage attribution — measured vs modeled floor — "
         f"{c['n_users']}x{c['n_items']} nnz={c['nnz']} rank={c['rank']} "
         f"{c['dtype']} {'implicit' if c['implicit'] else 'explicit'} "
         f"waste={c['padding_waste']:.3f} "
         f"path={report['resolved_solve_path']}"),
        f"({report['iters']} fence-timed iterations, warm)",
        "",
        f"{'stage':<16}{'measured s':>12}{'floor s':>12}"
        f"{'gap x':>9}{'% iter':>8}",
    ]

    def num(v, fmt, width):
        return f"{v:>{width}{fmt}}" if v is not None else f"{'-':>{width}}"

    for row in report["rows"]:
        lines.append(
            f"{row['stage']:<16}"
            + num(row["measured_s"], ".5f", 12)
            + num(row["floor_s"], ".5f", 12)
            + num(row["gap_x"], ".1f", 9)
            + num(row["pct_of_iter"], ".1f", 8))
    cov = 100.0 * report["coverage"]
    lines += [
        f"{'sum of stages':<16}"
        f"{report['sum_stage_s_per_iter']:>12.5f}{'':>12}{'':>9}"
        f"{cov:>8.1f}",
        f"{'unattributed':<16}"
        f"{report['unattributed_s_per_iter']:>12.5f}{'':>12}{'':>9}"
        f"{100.0 - cov:>8.1f}",
        "",
        f"wall (attributed twin):  {report['wall_s_per_iter']:.5f} s/iter",
        f"roofline floor:          "
        f"{report['roofline_floor_s_per_iter']:.5f} s/iter",
    ]
    if report.get("fused_s_per_iter"):
        lines.append(
            f"production fused step:   {report['fused_s_per_iter']:.5f} "
            f"s/iter  (twin overhead "
            f"{report['attribution_overhead_x']:.2f}x; the fused step "
            "is the real speed, the twin is where the time goes)")
    return "\n".join(lines)
