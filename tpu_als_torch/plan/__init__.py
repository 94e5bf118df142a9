"""The execution planner's serving and gather resolvers, disarmed.

Counterpart of ``shape_class``, ``resolve_serving_buckets``,
``resolve_live_cadence``, ``resolve_tenant_plan``, ``gather_model`` and
``resolve_gather_strategy`` in ``tpu_als/plan/planner.py`` as they
resolve with the reference's plan cache off: an explicit request passes
through, an observed request-size mix gives a power-of-two quantile
ladder, the default is the built-in constant, and a gather strategy of
``'auto'`` is the comm model's pick (which the reference never takes
from its cache either).  The port has no plan cache yet (nothing is banked,
nothing is read back, no ``plan_*`` event is emitted; ROADMAP Queue 1).
"""

from __future__ import annotations

import math

from tpu_als_torch.core.ratings import _next_pow2

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


def _ladder_from_observed(observed):
    """One bucket per {p50, p90, p99, max} of the observed batch sizes,
    each rounded up to the next power of two; None when there is nothing
    to learn from."""
    xs = sorted(int(s) for s in observed if int(s) > 0)
    if not xs:
        return None
    rungs = {int(_next_pow2(xs[min(len(xs) - 1,
                                   int(round(q * (len(xs) - 1))))]))
             for q in (0.50, 0.90, 0.99, 1.0)}
    return tuple(sorted(rungs))


def resolve_serving_buckets(*, rank=0, requested=None, observed=None):
    """Serving batch-bucket ladder: ``requested`` passes through;
    ``observed`` (served batch sizes, e.g. read back from the
    ``serving.batch_rows`` histogram) gives :func:`_ladder_from_observed`'s
    ladder; else ``serving.batcher.DEFAULT_BUCKETS``.  ``rank`` keys the
    reference's cache and is unused here."""
    from tpu_als_torch.serving.batcher import DEFAULT_BUCKETS

    if requested is not None:
        return tuple(int(b) for b in requested)
    if observed is not None:
        return _ladder_from_observed(observed) or tuple(DEFAULT_BUCKETS)
    return tuple(DEFAULT_BUCKETS)


def resolve_live_cadence(*, rank=0, requested=None):
    """Live fold-in -> publish cadence: micro-batch bounds and the delta
    index's compaction threshold; ``requested`` overrides entries of
    :data:`DEFAULT_LIVE_CADENCE`."""
    out = dict(DEFAULT_LIVE_CADENCE)
    if requested is not None:
        out.update(requested)
    return {"max_batch": int(out["max_batch"]),
            "max_wait_ms": float(out["max_wait_ms"]),
            "compact_delta_frac": float(out["compact_delta_frac"]),
            "compact_min_rows": int(out["compact_min_rows"])}


def shape_class(n_users=None, n_items=None, nnz=None):
    """Coarse log2 bucketing of a problem's sizes, so near-identical
    sizes share a plan; ``"generic"`` when no size is given."""
    if n_users is None and n_items is None and nnz is None:
        return "generic"

    def b(x):
        return "?" if not x else f"2^{int(math.log2(max(1, int(x))))}"

    return f"u{b(n_users)}.i{b(n_items)}.nnz{b(nnz)}"


def resolve_tenant_plan(*, rank, n_users=None, n_items=None,
                        requested_buckets=None, requested_cadence=None):
    """One tenant's plan for the multi-tenant control plane: its serving
    bucket ladder, its live cadence and its ``shape_class``.  Neither
    component keys on the tenant's name, so same-shaped tenants resolve
    to the same plan."""
    return {
        "shape_class": shape_class(n_users=n_users, n_items=n_items),
        "buckets": resolve_serving_buckets(rank=rank,
                                           requested=requested_buckets),
        "cadence": resolve_live_cadence(rank=rank,
                                        requested=requested_cadence),
    }


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
    :func:`gather_model`'s proposal."""
    if requested != "auto":
        return requested
    return gather_model(n_users=n_users, n_items=n_items, rank=rank,
                        n_devices=n_devices,
                        implicit=implicit)["proposal"]
