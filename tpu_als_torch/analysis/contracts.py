"""The port's contract registry: its byte and signature pins, by name.

Counterpart of ``tpu_als/analysis/contracts.py``.  Each pin is a
``Contract(name, build, pin)``: ``build(device)`` runs the program(s)
and counts what they did, ``pin(artifact)`` asserts the invariant and
returns a one-line verdict.  ``python -m tpu_als_torch.cli lint
--contracts [--device cpu]`` verifies all of them, ``--contract NAME``
one.  The full-strength versions stay with the tests named on each.

The reference pins "byte-identical jaxpr"; eager torch has no jaxpr, so
the port's twin is a **step signature** (:func:`step_signature`): the
ordered list of aten operations a call dispatches, each with its
arguments' shapes, dtypes and devices (a ``TorchDispatchMode``), plus
each kernel's launch-counter delta: the kernels are ``ctypes`` calls,
invisible to a dispatch mode.  On the CPU the kernels' plain versions
run, so there the signature is the aten operations alone.

- ``ne_audit``: the einsum build gathers exactly one ``V[cols]`` of
  ``n·w·r·4`` bytes; K3 declares ``fused_ne_kernel_bytes`` at its shapes;
  on the card K3's route gathers nothing (on the CPU its plain version
  gathers, so that half holds only where kernels run).
- ``fused_solve_audit``: K4 declares ``fused_solve_kernel_bytes``,
  strictly below K3's declared bytes plus the A/b handoff the fusion
  deletes; on the card K4 gathers nothing.
- ``guardrails_disarmed``, ``tracing_disarmed``, ``plan_cache_off``: the
  signature of one ``core.als.als_step`` iteration (the reference's
  ``_tiny_csr``, rank 4) is identical under ``guardrails.scoped(
  "recover")``, under ``obs.tracing.traced()``, and with
  ``TPU_ALS_PLAN_CACHE=off`` against a warm cache directory.
- ``comm_audit``: ``parallel/comm_audit.py::collective_bytes`` over a
  spawned gloo group (two processes, one shard each, on the device)
  equals ``comm_bytes_per_iter`` for every strategy of the multi-process
  path, explicit and implicit; ``remote_dma_bytes`` over the fused ring
  step (K7) equals its ``gather_fused_ring`` term.
- ``live_delta_index``: an incremental publish and its compaction give
  top-k bitwise a full rebuild's; the compacted arrays equal it.
- ``serve_comm_audit``: the merge ring (K8) over 4 logical shards
  declares exactly ``serve_merge_remote_bytes``, in one K8 call (on the
  card one launch and no torch gather of per-shard lists), and its
  top-k is bitwise ``chunked_topk_scores`` on the reference's tie
  catalog.
- ``elastic_disarmed``: the elastic wrapper around a sharded step, its
  fault point armed with a schedule that never fires, has the raw
  step's signature and result.
- ``floor_audit``: an autotune bank as ``plan tune --bank-out`` writes
  it, read from the path in ``TPU_ALS_FLOOR_AUDIT_BANK``; when the
  variable is unset, the contract first tunes a synthetic bank on the
  device with ``plan tune --bank-out`` in a temporary plan cache (rank
  128 at the planner's default shape on the card, a small one on the
  CPU).
  Its ``model_seconds`` is re-derived through
  ``perf/autotune.py::model_seconds``; the tuned config is never slower
  than the defaults; the measured/modeled ratio stays in its band.  It
  never reads ``BENCH_autotune_cpu.json``, the JAX package's bank.

``ring_substrate`` is not carried: the reference's ``ops/ring_buffer.py``
(a Pallas DMA substrate) has no counterpart by design (ROADMAP);
:data:`REFUSED` says so, and ``--contract ring_substrate`` fails with it.

Deliberately stdlib-only at module level: torch and the package load
inside each ``build``.  Contracts assume a fresh process; the process
state they arm (guardrails mode, plan-cache variable, fault points) is
restored afterwards.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time

__all__ = [
    "Contract", "ContractViolation", "Result", "REFUSED",
    "get", "names", "step_signature", "verify", "verify_all",
]

#: Contracts of the reference the port does not carry, and why.
REFUSED = {
    "ring_substrate": (
        "not carried: it pins the reference's ops/ring_buffer.py, the "
        "Pallas async-DMA substrate of its ring kernels, which the port "
        "does not carry by design (ROADMAP Queue 3): K7 and K8 read every "
        "shard's base pointer inside one CUDA launch"),
}


class ContractViolation(AssertionError):
    """A pinned invariant no longer holds."""


@dataclasses.dataclass(frozen=True)
class Result:
    name: str
    ok: bool
    detail: str


@dataclasses.dataclass(frozen=True)
class Contract:
    """One named, re-verifiable pin: ``build(device) -> artifact``,
    ``pin(artifact) -> verdict``; ``provenance`` names the test that
    owns its full-strength version."""

    name: str
    build: "callable"
    pin: "callable"
    provenance: str

    def verify(self, device):
        t0 = time.perf_counter()
        try:
            detail = self.pin(self.build(device))
        except Exception as e:  # noqa: BLE001 — verdicts, not crashes
            return Result(self.name, False,
                          f"{type(e).__name__}: {e} [{self.provenance}]")
        dt = time.perf_counter() - t0
        return Result(self.name, True,
                      f"{detail} [{dt:.1f}s; {self.provenance}]")


def _require(cond, msg):
    if not cond:
        raise ContractViolation(msg)


# -- the step signature -----------------------------------------------------

def _launch_counts():
    from tpu_als_torch.ops import (cuda_gather_ne, cuda_lanes,
                                   cuda_lanes_blocked, cuda_solve,
                                   cuda_topk)

    return {"K1": cuda_solve.LAUNCHES, "K2": cuda_lanes.LAUNCHES,
            "K3": cuda_gather_ne.GRAM_LAUNCHES,
            "K4": cuda_gather_ne.SOLVE_LAUNCHES,
            "K5": cuda_topk.LAUNCHES,
            "K6": cuda_lanes_blocked.LAUNCHES,
            "K7": cuda_gather_ne.RING_LAUNCHES,
            "K8": cuda_topk.MERGE_LAUNCHES}


def step_signature(fn, *args):
    """``(ops, launches, out)`` of one call of ``fn(*args)``: ``ops`` the
    ordered aten operations it dispatched, each ``(name, ((shape, dtype,
    device), ...))`` over its tensor arguments; ``launches`` each
    kernel's launch-counter delta (K1-K8); ``out`` what ``fn``
    returned."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class _Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append((str(func), tuple(
                (tuple(t.shape), str(t.dtype), str(t.device))
                for t in tree_leaves((args, kwargs or {}))
                if isinstance(t, torch.Tensor))))
            return func(*args, **(kwargs or {}))

    before = _launch_counts()
    with _Record() as rec:
        out = fn(*args)
    after = _launch_counts()
    return rec.ops, {k: after[k] - before[k] for k in after}, out


def _same_signature(a, b, what):
    ops_a, la = a
    ops_b, lb = b
    if ops_a != ops_b:
        at = next((j for j, (x, y) in enumerate(zip(ops_a, ops_b))
                   if x != y), min(len(ops_a), len(ops_b)))
        got = ops_b[at] if at < len(ops_b) else "(end)"
        raise ContractViolation(
            f"{what} changed the step signature ({len(ops_a)} vs "
            f"{len(ops_b)} aten ops; first difference at op {at}: {got})")
    _require(la == lb, f"{what} changed the kernel launches ({la} vs {lb})")
    return f"{len(ops_a)} aten ops, launches {_nonzero(la)}"


def _nonzero(launches):
    return {k: v for k, v in launches.items() if v} or "none (plain)"


def _device(device):
    from tpu_als_torch.utils.platform import resolve_device

    return resolve_device(device)


# -- shared tiny problem (the guardrails/plan pin shapes) -------------------

def _tiny_csr(nU=60, nI=40, nnz=800, seed=0):
    import numpy as np

    from tpu_als_torch.core.ratings import build_csr_buckets

    gen = np.random.default_rng(seed)
    u = gen.integers(0, nU, nnz)
    i = gen.integers(0, nI, nnz)
    r = gen.uniform(0.5, 5.0, nnz).astype(np.float32)
    ucsr = build_csr_buckets(u, i, r, nU, min_width=4, chunk_elems=1 << 12)
    icsr = build_csr_buckets(i, u, r, nI, min_width=4, chunk_elems=1 << 12)
    return ucsr, icsr


def _tiny_step_signature(dev, cfg):
    """The signature of one ``als_step`` on the tiny problem from the
    seeded init, with the plan ``train`` resolves first."""
    import torch

    from tpu_als_torch.core import als as core_als

    ucsr, icsr = _tiny_csr()
    nU, nI = ucsr.num_rows, icsr.num_rows
    g = torch.Generator().manual_seed(int(cfg.seed))
    U = core_als.init_factors(nU, cfg.rank, g).to(dev)
    V = core_als.init_factors(nI, cfg.rank, g).to(dev)
    ub, ib = ucsr.to(dev), icsr.to(dev)
    core_als.plan_training(cfg, cfg.rank, None, dev)
    ops, launches, _ = step_signature(
        lambda: core_als.als_step(U, V, ub, ib, nU, nI, cfg,
                                  ucsr.chunk_elems, icsr.chunk_elems))
    return ops, launches


def _tiny_cfg():
    from tpu_als_torch.core.als import AlsConfig

    return AlsConfig(rank=4, max_iter=2, implicit_prefs=True, alpha=4.0)


# -- ne_audit ---------------------------------------------------------------

def _ne_problem(dev, n=48, w=40, r=24, N=300):
    """The provenance test's shapes and data."""
    import numpy as np
    import torch

    rng = np.random.default_rng(7)
    return tuple(torch.from_numpy(a).to(dev) for a in (
        rng.normal(size=(N, r)).astype(np.float32),
        rng.integers(0, N, size=(n, w)).astype(np.int32),
        rng.normal(size=(n, w)).astype(np.float32),
        (rng.random((n, w)) < 0.8).astype(np.float32)))


def _build_ne_audit(device):
    from tpu_als_torch.ops import cuda_gather_ne as gne
    from tpu_als_torch.ops.solve import normal_eq_explicit
    from tpu_als_torch.perf.ne_audit import gather_out_bytes, \
        kernel_cost_bytes
    from tpu_als_torch.perf.roofline import fused_ne_kernel_bytes

    dev = _device(device)
    V, cols, vals, mask = args = _ne_problem(dev)
    n, w = cols.shape
    r = V.shape[1]

    def einsum(V, c, v, m):
        return normal_eq_explicit(V[c.long()], v, m, 0.1)

    def fused(V, c, v, m):
        return gne.gather_normal_eq_explicit(V, c, v, m, 0.1)

    return {"vg_bytes": n * w * r * 4, "device": dev.type,
            "einsum_gather": gather_out_bytes(einsum, *args),
            "fused_gather": gather_out_bytes(fused, *args),
            "fused_cost": kernel_cost_bytes(fused, *args),
            "model_bytes": fused_ne_kernel_bytes(n * w, n, r, 4)}


def _pin_ne_audit(a):
    total, count = a["einsum_gather"]
    _require(count == 1 and total == a["vg_bytes"],
             f"einsum build gathered {count} time(s), {total} B; expected "
             f"exactly one gather of {a['vg_bytes']} B (V[cols])")
    ctotal, ccount = a["fused_cost"]
    _require(ccount == 1 and ctotal == a["model_bytes"],
             f"K3 declared {ctotal} B in {ccount} call(s); "
             f"fused_ne_kernel_bytes is {a['model_bytes']} B")
    if a["device"] == "cuda":
        _require(a["fused_gather"] == (0, 0),
                 f"K3's route gathered on the card: {a['fused_gather']} — "
                 "V[cols] is being materialized")
        fused = "K3 gather-free on the card"
    else:
        fused = "K3's gather-free half holds on the card only (plain here)"
    return (f"einsum gather == V[cols] ({a['vg_bytes']} B), K3 declared == "
            f"model ({a['model_bytes']} B); {fused}")


# -- fused_solve_audit ------------------------------------------------------

def _build_fused_solve_audit(device):
    from tpu_als_torch.ops import cuda_gather_ne as gne
    from tpu_als_torch.perf.ne_audit import gather_out_bytes, \
        kernel_cost_bytes
    from tpu_als_torch.perf.roofline import fused_solve_kernel_bytes

    dev = _device(device)
    V, cols, vals, mask = args = _ne_problem(dev)
    n, w = cols.shape
    r = V.shape[1]

    def fsolve(V, c, v, m):
        return gne.gather_fused_solve_explicit(V, c, v, m, 0.1)

    def ne(V, c, v, m):
        return gne.gather_normal_eq_explicit(V, c, v, m, 0.1)

    return {"device": dev.type,
            "solve_gather": gather_out_bytes(fsolve, *args),
            "solve_cost": kernel_cost_bytes(fsolve, *args),
            "model_bytes": fused_solve_kernel_bytes(n * w, n, r, 4),
            "ne_cost": kernel_cost_bytes(ne, *args),
            # what the unfused route moves beyond its K3: A [n, r, r] and
            # b [n, r] written, then read back by the solve
            "handoff": 2 * n * (r * r + r) * 4}


def _pin_fused_solve_audit(a):
    ctotal, ccount = a["solve_cost"]
    _require(ccount == 1 and ctotal == a["model_bytes"],
             f"K4 declared {ctotal} B in {ccount} call(s); "
             f"fused_solve_kernel_bytes is {a['model_bytes']} B")
    ntotal, ncount = a["ne_cost"]
    _require(ncount == 1, f"the K3 comparator declared {ncount} calls")
    unfused = ntotal + a["handoff"]
    _require(ctotal < unfused,
             f"K4's {ctotal} B not below K3 + the A/b handoff ({unfused} "
             "B) — the fusion stopped deleting traffic")
    if a["device"] == "cuda":
        _require(a["solve_gather"] == (0, 0),
                 f"K4's route gathered on the card: {a['solve_gather']}")
    drop = 100.0 * (1.0 - ctotal / unfused)
    return (f"K4 declared == model ({ctotal} B), {drop:.0f}% below K3 + "
            f"A/b handoff ({unfused} B)"
            + ("; gather-free on the card" if a["device"] == "cuda" else ""))


# -- guardrails_disarmed / tracing_disarmed / plan_cache_off ----------------

def _build_guardrails_disarmed(device):
    from tpu_als_torch.resilience import guardrails

    dev = _device(device)
    disarmed = _tiny_step_signature(dev, _tiny_cfg())
    with guardrails.scoped("recover"):
        armed = _tiny_step_signature(dev, _tiny_cfg())
    return {"disarmed": disarmed, "armed": armed}


def _pin_guardrails_disarmed(a):
    got = _same_signature(a["disarmed"], a["armed"], "arming guardrails")
    return f"armed == disarmed step signature ({got})"


def _build_tracing_disarmed(device):
    from tpu_als_torch.obs import tracing

    dev = _device(device)
    disarmed = _tiny_step_signature(dev, _tiny_cfg())
    with tracing.traced():
        armed = _tiny_step_signature(dev, _tiny_cfg())
    return {"disarmed": disarmed, "armed": armed}


def _pin_tracing_disarmed(a):
    got = _same_signature(a["disarmed"], a["armed"],
                          "arming causal tracing")
    return f"armed == disarmed step signature ({got})"


def _build_plan_cache_off(device):
    from tpu_als_torch.plan.cache import ENV_VAR

    dev = _device(device)
    saved = os.environ.get(ENV_VAR)
    try:
        with tempfile.TemporaryDirectory() as td:
            os.environ[ENV_VAR] = "off"
            off = _tiny_step_signature(dev, _tiny_cfg())
            os.environ[ENV_VAR] = os.path.join(td, "armed")
            _tiny_step_signature(dev, _tiny_cfg())   # banks the plan
            warm = _tiny_step_signature(dev, _tiny_cfg())
    finally:
        if saved is None:
            os.environ.pop(ENV_VAR, None)
        else:
            os.environ[ENV_VAR] = saved
    return {"off": off, "warm": warm}


def _pin_plan_cache_off(a):
    got = _same_signature(a["off"], a["warm"], "a warm plan cache")
    return f"cache-off == warm-cache step signature ({got})"


# -- comm_audit -------------------------------------------------------------

def _build_comm_audit(device):
    import numpy as np
    import torch

    from tpu_als_torch.core.als import AlsConfig
    from tpu_als_torch.parallel import comm_audit
    from tpu_als_torch.parallel.comm import shard_csr_grid
    from tpu_als_torch.parallel.data import partition_balanced
    from tpu_als_torch.parallel.mesh import make_mesh
    from tpu_als_torch.parallel.trainer import (comm_bytes_per_iter,
                                                make_ring_step,
                                                stacked_counts)

    dev = _device(device)
    P = 2
    gen = np.random.default_rng(3)
    nU, nI, nnz = 60, 40, 900
    u = gen.integers(0, nU, nnz)
    i = gen.integers(0, nI, nnz)
    r = np.abs(gen.normal(size=nnz)).astype(np.float32) + 0.1
    # banded-sparse triples, so the all_to_all plan is not degenerate
    aU, aI = 24 * P, 48 * P
    au = gen.integers(0, aU, 2 * aU)
    ai = gen.integers(0, aI, 2 * aU)
    ar = np.abs(gen.normal(size=2 * aU)).astype(np.float32) + 0.1
    with tempfile.TemporaryDirectory() as td:
        rows = comm_audit.spawn(
            td, u, i, r, nU, nI, 8, nproc=P, device=str(dev),
            chunk_elems=512, gather_blocks=3, a2a=(au, ai, ar, aU, aI))

    # the fused ring (K7) on one process's S logical shards: its declared
    # cross-shard payload against comm_bytes_per_iter's ring term
    S, rank = 4, 128
    upart = partition_balanced(np.bincount(u, minlength=nU), S)
    ipart = partition_balanced(np.bincount(i, minlength=nI), S)
    ug = shard_csr_grid(upart, ipart, u, i, r, min_width=4)
    ig = shard_csr_grid(ipart, upart, i, u, r, min_width=4)
    cfg = AlsConfig(rank=rank, max_iter=1, reg_param=0.1,
                    implicit_prefs=True, alpha=4.0,
                    solve_backend="gather_fused_ring")
    step = make_ring_step(
        make_mesh(devices=[str(dev)] * S), ug, ig, cfg,
        (stacked_counts(upart, u, r, positive_only=True),
         stacked_counts(ipart, i, r, positive_only=True)))
    g = torch.Generator().manual_seed(0)
    U = torch.randn(upart.padded_rows, rank, generator=g).to(dev)
    V = torch.randn(ipart.padded_rows, rank, generator=g).to(dev)
    k7 = _launch_counts()["K7"]
    ring, per_call = comm_audit.remote_dma_bytes(step, U, V)
    return {"rows": rows, "processes": P, "ring": ring,
            "ring_calls": len(per_call),
            "ring_launches": _launch_counts()["K7"] - k7,
            "device": dev.type,
            "ring_model": comm_bytes_per_iter(
                "gather_fused_ring", upart, ipart, rank,
                user_container=ug, item_container=ig, implicit=False)}


def _pin_comm_audit(a):
    bad = [(p, x["strategy"], x["implicit"], x["audited"], x["model"])
           for p, rows in enumerate(a["rows"]) for x in rows
           if x["audited"] != x["model"]]
    _require(not bad, "audited collective bytes != comm_bytes_per_iter "
                      f"(process, strategy, implicit, audited, model): {bad}")
    seen = {(x["strategy"], x["implicit"]) for x in a["rows"][0]}
    _require(len(seen) == 10, f"strategies audited: {sorted(seen)}")
    _require(a["ring"] == a["ring_model"],
             f"K7 declared {a['ring']} B cross-shard; comm_bytes_per_iter"
             f"('gather_fused_ring') is {a['ring_model']} B")
    if a["device"] == "cuda":
        _require(a["ring_launches"] == a["ring_calls"] > 0,
                 f"K7 launched {a['ring_launches']} times for "
                 f"{a['ring_calls']} declared calls")
    return (f"audited == modeled bytes for 5 strategies x explicit/implicit "
            f"across {a['processes']} processes; K7's ring {a['ring']} B "
            f"== closed form in {a['ring_calls']} calls")


# -- live_delta_index -------------------------------------------------------

def _build_live_delta(device):
    import numpy as np
    import torch

    from tpu_als_torch.serving.index import build_index

    dev = _device(device)
    rng = np.random.default_rng(17)
    Ni, r, n, k, sk = 220, 8, 13, 5, 48
    V = rng.normal(size=(Ni, r)).astype(np.float32)
    valid = rng.random(Ni) > 0.15
    U = rng.normal(size=(n, r)).astype(np.float32)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    base = build_index(t(V), item_valid=t(valid), shortlist_k=sk, seq=1,
                       device=dev)
    touched = rng.choice(Ni, 9, replace=False)
    Vn = np.concatenate([V, rng.normal(size=(5, r)).astype(np.float32)])
    Vn[touched] = rng.normal(size=(9, r)).astype(np.float32)
    validn = np.concatenate([valid, np.ones(5, bool)])
    rows = np.concatenate([touched, np.arange(Ni, Ni + 5)])
    # the update's rows arrive from the host, as the reference's do
    delta = base.with_updates(rows, Vn[rows], valid_rows=validn[rows],
                              seq=2)
    compacted = delta.compact(seq=3)
    ref = build_index(t(Vn), item_valid=t(validn), shortlist_k=sk, seq=2,
                      device=dev)
    return {"U": t(U), "k": k, "delta": delta, "compacted": compacted,
            "ref": ref, "touched": len(rows)}


def _pin_live_delta(a):
    import torch

    s_r, ix_r = a["ref"].topk(a["U"], a["k"])
    for which in ("delta", "compacted"):
        s, ix = a[which].topk(a["U"], a["k"])
        _require(torch.equal(s, s_r),
                 f"{which} top-k SCORES differ from the full rebuild")
        _require(torch.equal(ix, ix_r),
                 f"{which} top-k INDICES differ from the full rebuild")
    for arr in ("V", "Vq", "sv", "valid"):
        _require(torch.equal(getattr(a["compacted"], arr),
                             getattr(a["ref"], arr)),
                 f"compacted index array {arr!r} differs from a full "
                 "rebuild")
    return (f"delta({a['touched']} touched rows) and compacted top-k "
            "bitwise == full rebuild; compacted arrays equal")


# -- serve_comm_audit -------------------------------------------------------

def _build_serve_comm_audit(device):
    import numpy as np
    import torch

    from tpu_als_torch.ops.topk import chunked_topk_scores
    from tpu_als_torch.parallel import comm_audit
    from tpu_als_torch.parallel.mesh import make_mesh
    from tpu_als_torch.parallel.serve import topk_sharded
    from tpu_als_torch.perf.ne_audit import gather_out_bytes
    from tpu_als_torch.perf.roofline import serve_merge_remote_bytes

    dev = _device(device)
    D = 4
    # the reference's tie catalog: integer factors from a pool of 7 rows,
    # every score exact and ties everywhere, one shard all invalid
    rng = np.random.default_rng(23)
    n, Ni, r, k = 40, 87 * D, 32, 10
    pool = rng.integers(-3, 4, size=(7, r)).astype(np.float32)
    V = pool[rng.integers(0, 7, Ni)]
    U = rng.integers(-3, 4, size=(n, r)).astype(np.float32)
    valid = rng.random(Ni) < 0.9
    ni_loc = -(-Ni // D)
    valid[2 * ni_loc:3 * ni_loc] = False
    mesh = make_mesh(devices=[str(dev)] * D)
    Ut, Vt, vt = (torch.from_numpy(x).to(dev) for x in (U, V, valid))

    def serve(U, V, valid):
        return topk_sharded(U, V, k, mesh, strategy="merge_ring",
                            item_valid=valid)

    k8 = _launch_counts()["K8"]
    declared, per_call = comm_audit.remote_dma_bytes(
        serve, Ut, Vt, vt, fires=lambda g: g[0] * (D - 1))
    launches = _launch_counts()["K8"] - k8
    gathers = gather_out_bytes(serve, Ut, Vt, vt)
    s, ix = serve(Ut, Vt, vt)
    ref_s, ref_i = chunked_topk_scores(Ut, Vt, vt, k)
    tile_u = min(256, -(-n // 8) * 8)
    return {"declared": declared, "calls": len(per_call),
            "launches": launches, "gathers": gathers, "device": dev.type,
            "model": serve_merge_remote_bytes(-(-n // tile_u), D, tile_u),
            "s": s, "ix": ix, "ref_s": ref_s, "ref_i": ref_i, "shards": D,
            "queries": n}


def _pin_serve_comm_audit(a):
    import torch

    _require(a["calls"] == 1,
             f"{a['calls']} merge calls declared, expected exactly one K8 "
             "call (per-shard lists merged inside the kernel)")
    _require(a["declared"] == a["model"],
             f"K8 declared {a['declared']} B cross-shard; "
             f"serve_merge_remote_bytes is {a['model']} B")
    if a["device"] == "cuda":
        _require(a["launches"] == 1, f"K8 launched {a['launches']} times")
        _require(a["gathers"] == (0, 0),
                 f"the merge route gathered {a['gathers']} on the card — "
                 "per-shard candidate lists are materializing")
    _require(torch.equal(a["s"], a["ref_s"]),
             "merged top-k SCORES differ from chunked_topk_scores on the "
             "tie catalog")
    _require(torch.equal(a["ix"], a["ref_i"]),
             "merged top-k INDICES differ from chunked_topk_scores — tie "
             "ORDER is not reproduced")
    return (f"one K8 call, declared {a['declared']} B == closed form over "
            f"{a['shards']} shards; {a['queries']}-query top-k bitwise == "
            "chunked_topk_scores on the tie catalog"
            + ("; one launch, no gather" if a["device"] == "cuda" else ""))


# -- elastic_disarmed -------------------------------------------------------

def _build_elastic_disarmed(device):
    import numpy as np
    import torch

    from tpu_als_torch.core.als import AlsConfig
    from tpu_als_torch.convert import slot_rows
    from tpu_als_torch.parallel.data import partition_balanced, shard_csr
    from tpu_als_torch.parallel.mesh import make_mesh
    from tpu_als_torch.parallel.trainer import make_sharded_step
    from tpu_als_torch.resilience import elastic, faults

    dev = _device(device)
    D = 2
    mesh = make_mesh(devices=[str(dev)] * D)
    gen = np.random.default_rng(0)
    nU, nI, nnz = 24, 16, 200
    u = gen.integers(0, nU, nnz)
    i = gen.integers(0, nI, nnz)
    r = gen.uniform(0.5, 5.0, nnz).astype(np.float32)
    upart = partition_balanced(np.bincount(u, minlength=nU), D)
    ipart = partition_balanced(np.bincount(i, minlength=nI), D)
    cfg = AlsConfig(rank=4, max_iter=2)
    step = make_sharded_step(mesh, shard_csr(upart, ipart, u, i, r),
                             shard_csr(ipart, upart, i, u, r), cfg)
    g = torch.Generator().manual_seed(0)
    U0 = slot_rows(upart, torch.randn(nU, 4, generator=g)).to(dev)
    V0 = slot_rows(ipart, torch.randn(nI, 4, generator=g)).to(dev)
    ops, launches, raw = step_signature(step, U0, V0)
    # the detector's point armed with a schedule that never fires, and
    # the step routed through the wrapper train_sharded(elastic=True)
    # installs
    faults.push_spec("mesh.device_lost=raise@nth=999999")
    try:
        wops, wlaunches, wrapped = step_signature(
            elastic.wrap_step(step, mesh), U0, V0)
    finally:
        faults.pop_spec()
    return {"disarmed": (ops, launches), "armed": (wops, wlaunches),
            "same": all(torch.equal(x, y) for x, y in zip(raw, wrapped))}


def _pin_elastic_disarmed(a):
    got = _same_signature(a["disarmed"], a["armed"],
                          "arming the elastic detector")
    _require(a["same"], "the elastic wrapper's result differs from the raw "
                        "step's")
    return f"elastic-wrapped == raw step signature and result ({got})"


# -- floor_audit: the autotune bank stays inside its roofline band ----------

#: the bank's path (``plan tune --bank-out``); unset: a small synthetic
#: bank is tuned on the device into a temporary plan cache first
FLOOR_AUDIT_BANK_ENV = "TPU_ALS_FLOOR_AUDIT_BANK"
#: measured/modeled band for a bank measured on the card: the kernels run
#: 4-13x their bounds (PERF.md), so 32x is the "gap silently reopened"
#: tripwire; a bank of the plain versions only pins ratio > 1 (the CPU
#: cannot beat the card's floor)
FLOOR_BAND_ENV = "TPU_ALS_FLOOR_BAND"
DEFAULT_FLOOR_BAND = 32.0
# never-slower tolerance: one regress noise band
FLOOR_AUDIT_NOISE = 0.10


def _tune_bank(dev, path):
    """``plan tune --bank-out path`` in a temporary plan cache of its own:
    on the card at the planner's default synthetic shape (rank 128, ~4.2M
    padded entries: large enough that the kernels, not the launches,
    set the time), on the CPU at a small one (the plain versions)."""
    from tpu_als_torch.cli import main as cli_main
    from tpu_als_torch.plan.cache import ENV_VAR

    shape = (["--rank", "128"] if dev.type == "cuda" else
             ["--rank", "8", "--n", "32", "--w", "4", "--max-w", "64",
              "--reps", "1"])
    saved = os.environ.get(ENV_VAR)
    try:
        with tempfile.TemporaryDirectory() as td:
            os.environ[ENV_VAR] = td
            cli_main(["plan", "tune", *shape, "--device", str(dev),
                      "--bank-out", path])
    finally:
        if saved is None:
            os.environ.pop(ENV_VAR, None)
        else:
            os.environ[ENV_VAR] = saved


def _build_floor_audit(device):
    import contextlib
    import io
    import json

    from tpu_als_torch.perf import autotune

    dev = _device(device)
    path = os.environ.get(FLOOR_AUDIT_BANK_ENV)
    with tempfile.TemporaryDirectory() as td:
        if not path:
            path = os.path.join(td, "bank.json")
            with contextlib.redirect_stdout(io.StringIO()):
                _tune_bank(dev, path)
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    shape = doc["shape"]
    missing = [k for k in ("rank", "n", "w", "max_w") if k not in shape]
    _require(not missing, f"the bank's shape {shape} lacks {missing}: only "
                          "a synthetic-timer bank re-derives its model")
    # the formula is authority, the bank's own model_seconds provenance
    model_s = autotune.model_seconds(
        doc["config"], shape["rank"],
        autotune.synthetic_shapes(shape["n"], shape["w"], shape["max_w"]))
    try:
        band = float(os.environ.get(FLOOR_BAND_ENV, "")
                     or DEFAULT_FLOOR_BAND)
    except ValueError:
        band = DEFAULT_FLOOR_BAND
    return {"doc": doc, "model_s": model_s, "band": band,
            "path": os.path.basename(path)}


def _pin_floor_audit(a):
    doc, model_s, band = a["doc"], a["model_s"], a["band"]
    tuned_s = float(doc["tuned_seconds"])
    default_s = float(doc["default_seconds"])
    source = doc.get("source", "plain")
    _require(tuned_s > 0 and default_s > 0 and model_s > 0,
             f"{a['path']}: non-positive timing (tuned {tuned_s}, default "
             f"{default_s}, model {model_s})")
    _require(tuned_s <= default_s * (1.0 + FLOOR_AUDIT_NOISE),
             f"{a['path']}: the tuned config is SLOWER than the defaults "
             f"({tuned_s:.6f}s vs {default_s:.6f}s, tolerance "
             f"{FLOOR_AUDIT_NOISE:.0%})")
    banked_model = doc.get("model_seconds")
    if banked_model is not None:
        _require(abs(float(banked_model) - model_s)
                 <= 1e-6 * max(float(banked_model), model_s),
                 f"{a['path']}: banked model_seconds "
                 f"{float(banked_model):.3e} != autotune.model_seconds "
                 f"{model_s:.3e} at the banked config and shape")
    ratio = tuned_s / model_s
    if source == "device":
        _require(0.9 <= ratio <= band,
                 f"{a['path']}: measured/modeled ratio {ratio:.2f} outside "
                 f"[0.9, {band:g}] — the gap to the roofline reopened (or "
                 "the measurement beat the bound); re-tune")
    else:
        _require(ratio > 1.0,
                 f"{a['path']}: plain-version measured/modeled ratio "
                 f"{ratio:.2f} <= 1 — the CPU cannot beat the card's "
                 "bound; the bank is doctored or mis-derived")
    speedup = default_s / tuned_s
    _require(abs(float(doc["value"]) - speedup)
             <= 1e-6 * max(float(doc["value"]), speedup),
             f"{a['path']}: banked speedup {doc['value']} != "
             f"default_seconds/tuned_seconds {speedup:.6f}")
    return (f"banked {source} A/B: tuned {tuned_s:.4g}s <= default "
            f"{default_s:.4g}s ({speedup:.3f}x), measured/modeled "
            f"{ratio:.1f} inside its band")


_REGISTRY = {
    c.name: c for c in (
        Contract("ne_audit", _build_ne_audit, _pin_ne_audit,
                 "tests/test_torch_ne_audit.py"),
        Contract("fused_solve_audit", _build_fused_solve_audit,
                 _pin_fused_solve_audit, "tests/test_torch_ne_audit.py"),
        Contract("guardrails_disarmed", _build_guardrails_disarmed,
                 _pin_guardrails_disarmed,
                 "tests/test_torch_contracts.py"),
        Contract("tracing_disarmed", _build_tracing_disarmed,
                 _pin_tracing_disarmed, "tests/test_torch_contracts.py"),
        Contract("plan_cache_off", _build_plan_cache_off,
                 _pin_plan_cache_off, "tests/test_torch_contracts.py"),
        Contract("comm_audit", _build_comm_audit, _pin_comm_audit,
                 "tests/test_torch_comm_audit.py"),
        Contract("live_delta_index", _build_live_delta, _pin_live_delta,
                 "tests/test_torch_serving_index.py"),
        Contract("serve_comm_audit", _build_serve_comm_audit,
                 _pin_serve_comm_audit, "tests/test_torch_merge_ring.py"),
        Contract("elastic_disarmed", _build_elastic_disarmed,
                 _pin_elastic_disarmed, "tests/test_torch_elastic.py"),
        Contract("floor_audit", _build_floor_audit, _pin_floor_audit,
                 "tests/test_torch_autotune.py"),
    )
}


def names():
    return tuple(_REGISTRY)


def get(name):
    if name in REFUSED:
        raise KeyError(f"contract {name!r} is {REFUSED[name]}")
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no contract named {name!r}; registered: "
            f"{', '.join(_REGISTRY)}") from None


def verify(name, device=None):
    return get(name).verify(device)


def verify_all(only=None, device=None):
    """Verify every registered contract (or the named subset), in
    registration order, on ``device`` (None: the card, raising without
    CUDA; ``"cpu"``: the plain versions).  Unknown or refused names in
    ``only`` are skipped here (the CLI reports them), so the return
    covers exactly the contracts that ran."""
    _device(device)
    picked = [c for n, c in _REGISTRY.items()
              if only is None or n in set(only)]
    return [c.verify(device) for c in picked]
