"""The execution planner: shapes propose, the walk decides, the verdict
persists.

Counterpart of ``tpu_als/plan/planner.py``.  Every dispatch decision of
the port that depends on no tensor's values (the training routes, the
top-k route, the gather strategy, the serving ladder, the live cadence,
a tenant's plan, and the tuned kernel knobs) resolves through one
discipline, :func:`_resolve_component`:

- The *plan key* is (device kind, torch version, rank, dtype, shape
  class, mesh shape, device count).  The device kind is the device the
  resolve is for: ``cuda:<torch.cuda.get_device_name(d)>`` for a card,
  ``cpu:<platform.machine()>`` for the CPU, so a ``device='cpu'`` fit on
  a box with a card keys apart from the card's.
- A warm entry emits ``plan_cache_hit`` and ``plan_resolved(source=
  "cache")``; the walk still computes the verdict (the bank is
  provenance), except for the configuration-like components
  (``serving_buckets``, ``live_cadence``), whose banked value wins.
- A cold resolve emits ``plan_cache_miss``, runs the walk, emits one
  ``plan_probe`` for it (``kernel="walk:<component>"``), banks the
  verdict with ``banked_at``, ``walk_seconds`` and the model's proposal,
  and emits ``plan_resolved(source="probe")``.  A corrupt entry is
  quarantined (``.corrupt/``) and read as a miss.
- ``TPU_ALS_PLAN_CACHE=off`` disarms everything: no resolver touches the
  disk or emits an event, and every dispatch site runs as if the
  planner did not exist.

The port has no probes, by design: its routes are chosen from shapes
alone (on the card each kernel launches or raises; the reference's
``utils/platform.py`` probe caches are not carried).  So an entry's
``probes`` is ``{}``, a component's ``probes_executed`` is ``[]``, and
the only ``plan_probe`` event a resolve emits is its walk's own.

The gather strategy is the one component whose verdict is always the
comm model's, never the bank's (as in the reference): the entry is
provenance for ``plan show``.

The measured component, ``kernel_config``, is the autotuner's
(:mod:`tpu_als_torch.perf.autotune`): the split width and K4's scratch
tile.  It is read by ``core.als.train`` and
``parallel.trainer.train_sharded`` only when the planner is armed *and*
``TPU_ALS_AUTOTUNE=1``; otherwise nothing is consulted and every path is
the untuned one.  A fit keys it on its own problem's shape class and, on
a miss, tunes on its own iteration.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import platform
import time
from dataclasses import dataclass, field
from datetime import datetime, timezone

from tpu_als_torch import obs
from tpu_als_torch.plan import cache as plan_cache

PlanCacheCorrupt = plan_cache.PlanCacheCorrupt

# auto-tune on a miss: with TPU_ALS_AUTOTUNE=1 an armed resolve whose
# entry has no banked kernel config runs the measured search
# (perf.autotune) and banks the winner; otherwise the knobs stay the
# module constants, and with the gate off the fit never consults the bank
AUTOTUNE_ENV = "TPU_ALS_AUTOTUNE"


def autotune_enabled():
    return os.environ.get(AUTOTUNE_ENV, "") == "1"


# the strategies 'auto' chooses among (the reference's order: a tie goes
# to the earlier)
GATHER_CANDIDATES = ("all_gather", "all_gather_chunked", "ring_overlap",
                     "ring")

# live-pipeline cadence: micro-batch accumulation + index compaction
# (the reference's constants)
DEFAULT_LIVE_CADENCE = {
    "max_batch": 256,
    "max_wait_ms": 50.0,
    "compact_delta_frac": 0.25,
    "compact_min_rows": 64,
}


def mode():
    """``"off"`` or the active cache directory."""
    return plan_cache.mode()


def armed():
    return plan_cache.mode() != "off"


def _now():
    return datetime.now(timezone.utc).isoformat(timespec="seconds")


def _device_kind(device=None):
    """``cuda:<name>`` for a CUDA device, ``cpu:<machine>`` for the CPU;
    ``device`` None: the card when one is visible, else the CPU."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    d = torch.device(device)
    if d.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(d)}"
    return f"{d.type}:{platform.machine()}"


def shape_class(n_users=None, n_items=None, nnz=None):
    """Coarse log2 bucketing of a problem's sizes, so near-identical
    sizes share a plan; ``"generic"`` when no size is given."""
    if n_users is None and n_items is None and nnz is None:
        return "generic"

    def b(x):
        return "?" if not x else f"2^{int(math.log2(max(1, int(x))))}"

    return f"u{b(n_users)}.i{b(n_items)}.nnz{b(nnz)}"


def plan_key(*, rank, dtype, shape_class="generic", mesh_shape=None,
             device_count=None, device=None):
    # device_count is its own component (default: the mesh_shape
    # product), so a mesh re-formed on fewer devices keys apart
    if device_count is None and mesh_shape:
        device_count = 1
        for n in mesh_shape:
            device_count *= int(n)
    return {
        "device_kind": _device_kind(device),
        "torch_version": plan_cache._torch_version(),
        "rank": int(rank),
        "dtype": str(dtype),
        "shape_class": shape_class,
        "mesh_shape": list(mesh_shape) if mesh_shape else None,
        "device_count": int(device_count) if device_count else None,
    }


def _key_str(key):
    mesh = key.get("mesh_shape")
    dc = key.get("device_count")
    return (f"{key['device_kind']}|torch{key['torch_version']}"
            f"|r{key['rank']}|{key['dtype']}|{key['shape_class']}"
            f"|mesh{'x'.join(map(str, mesh)) if mesh else '-'}"
            f"|D{dc if dc else '-'}")


def _summ(resolved):
    if isinstance(resolved, dict):
        return str(resolved.get("resolved_solve_path", resolved))
    return str(resolved)


def _jsonable(x):
    return json.loads(json.dumps(x, default=str))


def _new_entry(key):
    return {"schema_version": plan_cache.SCHEMA_VERSION, "plan_key": key,
            "probes": {}, "components": {}}


def _store(key, entry, what):
    try:
        plan_cache.store_entry(key, entry)
    except OSError as e:
        obs.emit("warning", what="plan_cache",
                 reason=f"could not bank {what}: {e}")
        return False
    return True


def _load_or_quarantine(key):
    """``(entry_or_None, miss_reason_or_None)``: a corrupt entry is moved
    to ``.corrupt/`` (never crashed on, never trusted) and reads as a
    miss with reason ``"corrupt"``."""
    try:
        return plan_cache.load_entry(key), None
    except PlanCacheCorrupt as e:
        qpath = plan_cache.quarantine(e.path, e.reason)
        obs.emit("warning", what="plan_cache",
                 reason=f"quarantined corrupt entry to {qpath}: {e.reason}")
        return None, "corrupt"


def _resolve_component(key, component, walk, *, model=None,
                       use_banked=False):
    """The shared resolve discipline.  On a hit ``walk()`` re-derives the
    verdict (``use_banked=True``: the banked value is taken instead, for
    configuration-like components); on a miss the walk runs, one
    ``plan_probe`` records it, and the verdict is banked with its
    provenance."""
    entry, reason = _load_or_quarantine(key)
    if entry is not None and component in entry["components"]:
        obs.emit("plan_cache_hit", key=_key_str(key), component=component,
                 path=plan_cache.entry_path(key), seeded=0)
        resolved = (entry["components"][component]["resolved"]
                    if use_banked else walk())
        obs.emit("plan_resolved", key=_key_str(key), component=component,
                 source="cache", resolved=_summ(resolved))
        return resolved

    obs.emit("plan_cache_miss", key=_key_str(key), component=component,
             reason=(reason or "absent") if entry is None
             else "component_absent")
    t0 = time.perf_counter()
    resolved = walk()
    walk_s = time.perf_counter() - t0
    obs.emit("plan_probe", kernel=f"walk:{component}",
             outcome=_summ(resolved), seconds=walk_s)
    if entry is None:
        entry = _new_entry(key)
    entry["components"][component] = {
        "resolved": _jsonable(resolved),
        "provenance": {
            "banked_at": _now(),
            "walk_seconds": round(walk_s, 6),
            "probes_executed": [],
            "probe_timings": {},
            "model": _jsonable(model) if model is not None else None,
        },
    }
    _store(key, entry, "plan entry")
    obs.emit("plan_resolved", key=_key_str(key), component=component,
             source="probe", resolved=_summ(resolved))
    return resolved


# -- component resolvers (one per dispatch site) ------------------------


def resolve_training(*, rank, compute_dtype, label, walk, device=None):
    """Consulted once per fit by ``core.als.train`` and
    ``parallel.trainer.train_sharded`` when armed (None when disarmed).
    ``walk`` is ``core.als.training_walk``: the narrow and the wide
    buckets' routes at the fit's split width.  Warm or cold, its return
    is the verdict; the entry is provenance."""
    if not armed():
        return None
    key = plan_key(rank=rank, dtype=compute_dtype, device=device)
    return _resolve_component(key, f"training:{label}", walk,
                              model=training_model(rank, compute_dtype))


def training_model(rank, compute_dtype):
    """The roofline's proposal for the training resolve: the modeled HBM
    bytes of K4 (``fused_solve_kernel_bytes``: the Gram and its solve in
    one kernel), K3 (``fused_ne_kernel_bytes``: A and b written out for a
    separate solve) and the unfused build (``einsum_ne_build_bytes``) at
    the reference's instance (2,048 rows of 256 entries), and the solve
    kernel a wide bucket takes at this rank."""
    rl = importlib.import_module("tpu_als_torch.perf.roofline")

    db = 2 if "bfloat16" in str(compute_dtype) else 4
    n, w = 2048, 256
    P = n * w
    by = {"gather_fused_solve": rl.fused_solve_kernel_bytes(P, n, rank, db),
          "gather_fused": rl.fused_ne_kernel_bytes(P, n, rank, db),
          "einsum": rl.einsum_ne_build_bytes(P, n, rank, db)}
    return {
        "ne_bytes": by,
        "ne_proposal": min(by, key=by.get),
        "solve_preference": (["pallas_cholesky"] if rank <= 128
                             else ["pallas_lanes_blocked"]),
    }


def resolve_topk(*, rank, k, walk, device=None):
    """Consulted once per call by the estimator's ``recommendForAll*`` and
    ``recommend_arrays`` and by ``plan warm`` (never per batch); ``walk``
    is ``ops.cuda_topk.topk_route``."""
    if not armed():
        return None
    from tpu_als_torch.ops.cuda_topk import MAX_K

    key = plan_key(rank=rank, dtype="float32", device=device)
    k = int(k)
    model = {"proposal": ("empty" if k == 0
                          else "kernel" if k <= MAX_K else "scan"),
             "reason": f"K5 holds k <= {MAX_K} per row in registers; a "
                       "larger k takes the chunked scan"}
    return _resolve_component(key, f"topk:k={k}", walk, model=model)


def gather_model(*, n_users, n_items, rank, n_devices, implicit=False):
    """Closed-form per-device collective bytes of one full ALS iteration
    for each candidate strategy (the balanced-shard, one-row-tile case of
    ``parallel.trainer.comm_bytes_per_iter``) and the proposal, the
    cheapest."""
    D = max(1, int(n_devices))
    fb = 4 * int(rank)
    ru = -(-int(n_users) // D)
    ri = -(-int(n_items) // D)
    ag = (D - 1) * ri * fb + (D - 1) * ru * fb
    ring = D * ri * fb + D * ru * fb
    psum = 4 * (D - 1) / D * rank * rank * 4 if implicit else 0
    by = {"all_gather": ag + psum, "all_gather_chunked": ag + psum,
          "ring_overlap": ring + psum, "ring": ring + psum}
    proposal = min(GATHER_CANDIDATES, key=lambda s: by[s])
    return {"comm_bytes_per_iter": by, "proposal": proposal,
            "n_devices": D}


def resolve_gather_strategy(*, requested="auto", n_users, n_items, rank,
                            n_devices, implicit=False):
    """An explicit strategy passes through; ``'auto'`` is
    :func:`gather_model`'s proposal, banked as provenance when armed."""
    if requested != "auto":
        return requested
    model = gather_model(n_users=n_users, n_items=n_items, rank=rank,
                         n_devices=n_devices, implicit=implicit)
    choice = model["proposal"]
    if armed():
        key = plan_key(
            rank=rank, dtype="float32",
            shape_class=shape_class(n_users=n_users, n_items=n_items),
            mesh_shape=(n_devices,))
        _resolve_component(key, f"gather:D={int(n_devices)}",
                           walk=lambda: choice, model=model)
    return choice


def _ladder_from_observed(observed):
    """One bucket per {p50, p90, p99, max} of the observed batch sizes,
    each rounded up to the next power of two; None when there is nothing
    to learn from."""
    from tpu_als_torch.core.ratings import _next_pow2

    xs = sorted(int(s) for s in observed if int(s) > 0)
    if not xs:
        return None
    rungs = {int(_next_pow2(xs[min(len(xs) - 1,
                                   int(round(q * (len(xs) - 1))))]))
             for q in (0.50, 0.90, 0.99, 1.0)}
    return tuple(sorted(rungs))


def resolve_serving_buckets(*, rank=0, requested=None, observed=None):
    """Serving batch-bucket ladder.  ``requested`` passes through;
    ``observed`` (served batch sizes, e.g. read back from the
    ``serving.batch_rows`` histogram) gives :func:`_ladder_from_observed`'s
    ladder and, armed, re-banks it; the bare default takes a banked
    ladder, else ``serving.batcher.DEFAULT_BUCKETS``."""
    from tpu_als_torch.serving.batcher import DEFAULT_BUCKETS

    if requested is not None:
        return tuple(int(b) for b in requested)
    if observed is not None:
        observed = list(observed)
        ladder = _ladder_from_observed(observed) or tuple(DEFAULT_BUCKETS)
        if armed():
            key = plan_key(rank=int(rank or 0), dtype="float32")
            entry, _ = _load_or_quarantine(key)
            if entry is None:
                entry = _new_entry(key)
            entry["components"]["serving_buckets"] = {
                "resolved": [int(b) for b in ladder],
                "provenance": {
                    "banked_at": _now(),
                    "walk_seconds": 0.0,
                    "probes_executed": [],
                    "probe_timings": {},
                    "model": {"observed_n": len(observed),
                              "reason": "pow2 quantile ladder "
                                        "(p50/p90/p99/max) from the "
                                        "observed request-size mix"},
                },
            }
            _store(key, entry, "observed ladder")
            obs.emit("plan_resolved", key=_key_str(key),
                     component="serving_buckets", source="observed",
                     resolved=_summ(list(ladder)))
        return ladder
    if not armed():
        return tuple(DEFAULT_BUCKETS)
    key = plan_key(rank=int(rank or 0), dtype="float32")
    model = {"proposal": list(DEFAULT_BUCKETS),
             "reason": "geometric ladder bounds pad waste while keeping "
                       "one batch shape per bucket"}
    resolved = _resolve_component(key, "serving_buckets",
                                  walk=lambda: list(DEFAULT_BUCKETS),
                                  model=model, use_banked=True)
    return tuple(int(b) for b in resolved)


def resolve_kernel_config(*, rank, compute_dtype="float32", budget_s=None,
                          space=None, force=False, tune=None, timer=None,
                          n=4096, w=64, max_w=None, k=3, seed=0,
                          device=None, shape_class="generic",
                          mesh_shape=None):
    """The measured component (``"kernel_config"``): the split width and
    K4's scratch tile (``perf.autotune.SPACE``), keyed on the fit's table
    type and on ``shape_class``: a fit passes its own problem's class and
    the timer of its own iteration (``core.als.tuned_kernel_knobs``); the
    synthetic timer's verdict keys as ``"generic"``, which no fit reads.

    Warm: a banked, non-invalidated config returns as a cache read,
    ``plan_cache_hit`` + ``plan_resolved(source="cache")`` and no trial.
    Cold: only when tuning is asked for (``tune=True``, ``plan tune``, or
    ``TPU_ALS_AUTOTUNE=1``) the search runs (``perf.autotune.tune``), the
    winner is banked beside its model, and ``plan_tuned`` +
    ``plan_resolved(source="measured")`` are emitted.  Returns None (keep
    the module constants) when disarmed, or when nothing is banked and no
    tuning was asked for.  ``force`` re-tunes.

    The never-override rule: a ``plain`` verdict (the CPU's plain
    versions) never replaces a banked ``device`` one (the card's
    kernels); the fresh result is dropped with a warning and the banked
    config stands, even under ``force``.
    """
    if not armed():
        return None
    if tune is None:
        tune = autotune_enabled()
    key = plan_key(rank=int(rank), dtype=str(compute_dtype), device=device,
                   shape_class=shape_class, mesh_shape=mesh_shape)
    entry, _ = _load_or_quarantine(key)
    comp = (entry or {}).get("components", {}).get("kernel_config")
    prov = (comp or {}).get("provenance") or {}
    if comp is not None and not prov.get("invalidated") and not force:
        obs.emit("plan_cache_hit", key=_key_str(key),
                 component="kernel_config",
                 path=plan_cache.entry_path(key), seeded=0)
        obs.emit("plan_resolved", key=_key_str(key),
                 component="kernel_config", source="cache",
                 resolved=_summ(comp["resolved"]))
        return dict(comp["resolved"])
    if not tune:
        return dict(comp["resolved"]) if comp is not None \
            and not prov.get("invalidated") else None

    from tpu_als_torch.perf import autotune

    obs.emit("plan_cache_miss", key=_key_str(key),
             component="kernel_config",
             reason="invalidated" if prov.get("invalidated")
             else ("forced" if (force and comp is not None)
                   else ("component_absent" if entry is not None
                         else "absent")))
    kwargs = dict(rank=int(rank), compute_dtype=str(compute_dtype),
                  space=space, timer=timer, n=n, w=w, k=k, seed=seed,
                  device=device)
    if max_w is not None:
        kwargs["max_w"] = int(max_w)
    if budget_s is not None:
        kwargs["budget_s"] = float(budget_s)
    verdict = autotune.tune(**kwargs)
    if prov.get("source") == "device" and verdict["source"] == "plain":
        obs.emit("warning", what="plan_cache",
                 reason="plain-version autotune verdict discarded: the "
                        "banked kernel config measured on the card stands "
                        "(never-override rule)")
        return dict(comp["resolved"])
    if entry is None:
        entry = _new_entry(key)
    ratio = (verdict["measured_seconds"] / verdict["model_seconds"]
             if verdict["model_seconds"] else None)
    entry["components"]["kernel_config"] = {
        "resolved": _jsonable(verdict["config"]),
        "provenance": {
            "banked_at": _now(),
            "source": verdict["source"],
            "measured_seconds": verdict["measured_seconds"],
            "model_seconds": verdict["model_seconds"],
            "default_seconds": verdict["default_seconds"],
            "ratio": ratio,
            "tune_seconds": round(verdict["tune_seconds"], 6),
            "trials": len(verdict["trials"]),
            "walk_seconds": round(verdict["tune_seconds"], 6),
            "probes_executed": [],
            "model": {"shape": verdict["shape"],
                      "reason": "one-at-a-time measured search over "
                                "perf.autotune.SPACE; model_seconds is "
                                "the sum of perf/roofline.py's kernel "
                                "bounds over the timed buckets at the "
                                "winning config"},
        },
    }
    _store(key, entry, "tuned kernel config")
    obs.emit("plan_tuned", key=_key_str(key), component="kernel_config",
             source=verdict["source"], config=_jsonable(verdict["config"]),
             measured_seconds=verdict["measured_seconds"],
             model_seconds=verdict["model_seconds"])
    obs.emit("plan_resolved", key=_key_str(key), component="kernel_config",
             source="measured", resolved=_summ(verdict["config"]))
    return dict(verdict["config"])


def invalidate_kernel_config(*, rank, compute_dtype="float32",
                             reason="drift", device=None,
                             shape_class="generic", mesh_shape=None):
    """Mark the banked kernel config stale (its measured/modeled ratio
    left its band, ``perf.autotune.drifted``), so the next armed resolve
    re-tunes instead of riding it.  Returns True when an entry was
    invalidated."""
    if not armed():
        return False
    key = plan_key(rank=int(rank), dtype=str(compute_dtype), device=device,
                   shape_class=shape_class, mesh_shape=mesh_shape)
    entry, _ = _load_or_quarantine(key)
    comp = (entry or {}).get("components", {}).get("kernel_config")
    if comp is None:
        return False
    prov = comp.setdefault("provenance", {})
    if prov.get("invalidated"):
        return False
    prov["invalidated"] = {"at": _now(), "reason": str(reason)}
    if not _store(key, entry, "the stale mark"):
        return False
    obs.emit("warning", what="plan_cache",
             reason=f"kernel config invalidated ({reason}): the next armed "
                    "resolve re-tunes")
    return True


def resolve_live_cadence(*, rank=0, requested=None):
    """Live fold-in -> publish cadence: micro-batch bounds and the delta
    index's compaction threshold.  ``requested`` overrides entries of
    :data:`DEFAULT_LIVE_CADENCE`; the default takes a banked cadence for
    this device and rank, else the constants."""
    if requested is not None:
        out = dict(DEFAULT_LIVE_CADENCE)
        out.update(requested)
    elif not armed():
        out = dict(DEFAULT_LIVE_CADENCE)
    else:
        key = plan_key(rank=int(rank or 0), dtype="float32")
        model = {"proposal": dict(DEFAULT_LIVE_CADENCE),
                 "reason": "accumulate ~max_batch events or max_wait_ms "
                           "(whichever first) per fold-in; compact the "
                           "delta segment past max(compact_min_rows, "
                           "compact_delta_frac * catalog)"}
        out = dict(_resolve_component(key, "live_cadence",
                                      walk=lambda: dict(
                                          DEFAULT_LIVE_CADENCE),
                                      model=model, use_banked=True))
    return {"max_batch": int(out["max_batch"]),
            "max_wait_ms": float(out["max_wait_ms"]),
            "compact_delta_frac": float(out["compact_delta_frac"]),
            "compact_min_rows": int(out["compact_min_rows"])}


def resolve_tenant_plan(*, rank, n_users=None, n_items=None,
                        requested_buckets=None, requested_cadence=None):
    """One tenant's plan for the multi-tenant control plane: its serving
    bucket ladder, its live cadence and its ``shape_class``.  Neither
    component keys on the tenant's name, so same-shaped tenants resolve
    to the same plan entry."""
    return {
        "shape_class": shape_class(n_users=n_users, n_items=n_items),
        "buckets": resolve_serving_buckets(rank=rank,
                                           requested=requested_buckets),
        "cadence": resolve_live_cadence(rank=rank,
                                        requested=requested_cadence),
    }


def probe_budget_s(default_s):
    """Probe-budget suggestion; see
    ``plan.cache.suggested_probe_budget``."""
    return plan_cache.suggested_probe_budget(default_s)


def clear():
    """Drop the on-disk entries (the ``plan clear`` verb; the port keeps
    no in-process probe registry).  Returns the number of files
    removed."""
    return plan_cache.clear()


# -- the whole plan (``plan warm`` / ``plan show``) ---------------------


@dataclass(frozen=True)
class ExecutionPlan:
    """Everything the planner decides, in one place."""

    key: dict
    solve: dict | None                # core.als.training_walk's dict
    topk_backend: str | None
    gather_strategy: str | None
    serving_buckets: tuple
    probe_budget_s: float
    probe_budget_reason: str
    notes: dict = field(default_factory=dict)
    kernel_config: dict | None = None  # tuned knobs (None = constants)

    def summary(self):
        return {
            "key": _key_str(self.key),
            "resolved_solve_path": (self.solve or {}).get(
                "resolved_solve_path"),
            "topk_backend": self.topk_backend,
            "gather_strategy": self.gather_strategy,
            "serving_buckets": list(self.serving_buckets),
            "probe_budget_s": self.probe_budget_s,
            "probe_budget_reason": self.probe_budget_reason,
            "kernel_config": self.kernel_config,
        }


def resolve_execution_plan(*, rank=128, compute_dtype="float32",
                           solve_backend="auto", cg_iters=0,
                           cg_mode="dense", nonnegative=False, k=10,
                           n_users=None, n_items=None, n_devices=1,
                           default_probe_budget_s=600.0, device=None):
    """Resolve the whole plan for one configuration on ``device`` (the
    ``plan warm`` entry point): each component through the resolver its
    dispatch site consults, so warming here is the resolve a fit or a
    recommend performs."""
    from tpu_als_torch.core import als as core_als
    from tpu_als_torch.ops.cuda_topk import topk_route

    cfg = core_als.AlsConfig(rank=int(rank), solve_backend=solve_backend,
                             cg_iters=int(cg_iters), cg_mode=cg_mode,
                             nonnegative=bool(nonnegative),
                             compute_dtype=compute_dtype)
    solve = core_als.plan_training(cfg, int(rank), device=device)
    if armed():
        topk = resolve_topk(rank=int(rank), k=int(k),
                            walk=lambda: topk_route(int(k)), device=device)
    else:
        topk = topk_route(int(k))
    gather = None
    if n_devices and int(n_devices) > 1 and n_users and n_items:
        gather = resolve_gather_strategy(
            requested="auto", n_users=int(n_users), n_items=int(n_items),
            rank=int(rank), n_devices=int(n_devices))
    buckets = resolve_serving_buckets(rank=int(rank))
    # the warm read whenever armed; the search itself runs only behind
    # TPU_ALS_AUTOTUNE=1 (resolve_kernel_config)
    kcfg = (resolve_kernel_config(rank=int(rank),
                                  compute_dtype=compute_dtype,
                                  device=device)
            if armed() else None)
    budget, why = plan_cache.suggested_probe_budget(default_probe_budget_s)
    return ExecutionPlan(
        key=plan_key(rank=int(rank), dtype=compute_dtype, device=device),
        solve=solve, topk_backend=topk, gather_strategy=gather,
        serving_buckets=buckets, probe_budget_s=budget,
        probe_budget_reason=why,
        notes={"mode": mode()},
        kernel_config=kcfg)
