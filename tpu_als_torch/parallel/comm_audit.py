"""Collective-traffic audit: the bytes a step's collectives really move
between processes, and the bytes its cross-shard kernels declare, held
against ``trainer.comm_bytes_per_iter``'s closed forms.

Counterpart of ``tpu_als/parallel/comm_audit.py``, which walks a jaxpr.
The port runs eagerly, and its only collectives are those of
:mod:`~tpu_als_torch.parallel.multihost`; on one card the logical shards
exchange nothing (a stacked table is already the gathered one).  So:

- :func:`collective_bytes` runs the function once with a recorder in
  ``multihost``'s ``all_gather``, ``ppermute``, ``all_reduce_sum`` and
  ``all_to_all`` (:data:`multihost.RECORD`) and prices each call that
  crosses processes under the reference's per-primitive conventions:

  - ``all_gather`` → received bytes, ``(S−1)/S × |out|``;
  - ``ppermute``   → ``|out|`` per rotation;
  - ``psum`` (``all_reduce_sum``) → a bidirectional-ring all-reduce,
    ``2·(S−1)/S × |out|``, ``|out|`` one shard's value;
  - ``all_to_all`` → sent + received minus the self slice,
    ``2·(S−1)/S × |out|``.

  The recorder is separate from :data:`multihost.COMM`, which goes on
  counting what the gloo transport received and staged.
- **A deliberate divergence**: the reference's ``cond`` rule (branches
  moving equal totals count once, disagreeing ones raise) and ``while``
  rule (a collective in a loop of unbounded trip count raises) have no
  counterpart.  Eager torch runs one branch and one trip count, and the
  audit counts what ran.  A data-dependent schedule is therefore not
  refused here, only measured (``tests/test_torch_comm_audit.py`` pins
  this).
- :func:`remote_dma_bytes` audits the traffic no collective carries.  K7
  (``ops/cuda_gather_ne.py::gather_solve_ring``) and K8
  (``ops/cuda_topk.py::topk_merge_ring``) read every shard inside the
  kernel, so while this audit is armed their wrappers declare each
  call's payload a hop and the grid of the reference's schedule (row or
  user tiles, shards), on either device, the idiom of
  ``perf/ne_audit.py::kernel_cost_bytes``.  On one card this is the
  traffic the schedule would move across cards, as
  ``comm_bytes_per_iter`` says of itself; no byte of it crosses a link.
  Across processes the same declarations come from K7's mapped-pointer
  entry (each process's fused ring, over all S positions) and K8's
  scan-to-sets (``'merge_ring'``), so an audit of one process's step or
  serve reports the cross-process payload per process, which the
  processes really exchange through their mapped buffers
  (``parallel/peer.py``) and which no collective counts.

:func:`audit_strategies` runs every strategy of the multi-process path
once in each process of a group (one shard a process) under
:func:`collective_bytes`, beside ``comm_bytes_per_iter``; :func:`spawn`
starts such a group (``python -m tpu_als_torch.parallel.comm_audit``)
on the CPU or on one card and returns each process's rows.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from tpu_als_torch.parallel import multihost

#: The strategies the multi-process path runs through collectives.  The
#: fused ring (K7, ``'ring'`` with ``solve_backend='gather_fused_ring'``)
#: and ``'merge_ring'`` serving (K8) move their shards and candidate sets
#: through buffers the processes map from each other on one card, not
#: through a collective: :func:`remote_dma_bytes` reports what they
#: declare.
PROCESS_STRATEGIES = ("all_gather", "all_gather_chunked", "ring",
                      "ring_overlap", "all_to_all")


def price(primitive, out_bytes, axis_size):
    """Per-device bytes of one collective under the reference's
    conventions (the module docstring)."""
    S, b = int(axis_size), int(out_bytes)
    if primitive == "all_gather":
        return (S - 1) * b // S
    if primitive == "ppermute":
        return b
    if primitive in ("psum", "all_to_all"):
        return 2 * (S - 1) * b // S
    raise ValueError(f"unknown collective {primitive!r}")


def collective_bytes(fn, *args, axis_size):
    """Per-device collective bytes of one call of ``fn(*args)``, which
    runs: ``(total_bytes, breakdown)``, breakdown mapping the reference's
    primitive names to bytes.  ``axis_size``: the processes the
    collectives run over (one shard a process, the reference's mesh
    axis).  An audit inside ``fn`` keeps its own."""
    breakdown = {}

    def record(primitive, out_bytes):
        breakdown[primitive] = breakdown.get(primitive, 0) \
            + price(primitive, out_bytes, axis_size)

    prev, multihost.RECORD = multihost.RECORD, record
    try:
        fn(*args)
    finally:
        multihost.RECORD = prev
    return int(sum(breakdown.values())), breakdown


def remote_dma_bytes(fn, *args, fires=None):
    """Per-device cross-shard bytes that K7 and K8 declare during one call
    of ``fn(*args)``: ``(total_bytes, per_call)``.

    Each call declares its payload a hop and its schedule's grid
    ``(tiles, shards)``; ``fires(grid)`` maps the grid to the hops, by
    default the fused ring's ``row_tiles·(S−1)`` (one pass per row tile,
    no homecoming hop: ``perf/roofline.py::ring_remote_bytes``).  A
    caller auditing the merge ring passes ``lambda g: g[0] * (S - 1)``,
    ``user_tiles·(S−1)`` (``serve_merge_remote_bytes``)."""
    from tpu_als_torch.ops import cuda_gather_ne, cuda_topk

    calls = []
    prev = cuda_gather_ne.REMOTE, cuda_topk.REMOTE
    cuda_gather_ne.REMOTE = cuda_topk.REMOTE = calls
    try:
        fn(*args)
    finally:
        cuda_gather_ne.REMOTE, cuda_topk.REMOTE = prev
    if fires is None:
        def fires(grid):
            return grid[0] * max(0, grid[1] - 1)
    per_call = [int(payload) * int(fires(grid)) for payload, grid in calls]
    return int(sum(per_call)), per_call


# -- the multi-process audit -----------------------------------------------

def audit_strategies(u, i, r, num_users, num_items, rank, *, implicit,
                     device, min_width=4, chunk_elems=1 << 19,
                     gather_blocks=4, a2a=None, ready=None):
    """In every process of a group, one shard a process: each strategy's
    step from one seeded init, run once under :func:`collective_bytes`,
    beside ``comm_bytes_per_iter`` of the same containers.  ``u, i, r``:
    the whole triples (every process the same); ``a2a``: other triples
    ``(u, i, r, num_users, num_items)`` for 'all_to_all', whose plan is
    built even when degenerate.  Every container is built before the
    first step, then ``ready()`` (when given) is called.  A strategy
    whose step is the same factory's closure over the same containers as
    an earlier one's ('ring_overlap' across processes is the ring's
    step) is not run again: its row carries the earlier audit and
    ``same_step_as``.  Returns one dict a strategy: ``strategy,
    implicit, audited, breakdown, model, seconds`` (the audited
    iteration's wall on the host clock, device synced; None when not
    run again)."""
    from tpu_als_torch.core import als as core_als
    from tpu_als_torch.parallel.a2a import build_a2a
    from tpu_als_torch.parallel.comm import shard_csr_grid
    from tpu_als_torch.parallel.data import partition_balanced, shard_csr
    from tpu_als_torch.parallel.mesh import make_mesh
    from tpu_als_torch.parallel.trainer import (comm_bytes_per_iter,
                                                make_process_step,
                                                stacked_counts)

    P, pid = multihost.process_count(), multihost.process_index()
    mesh = make_mesh(devices=[device])
    pos = (pid,)
    cfg = core_als.AlsConfig(rank=int(rank), max_iter=1, reg_param=0.1,
                             implicit_prefs=bool(implicit), alpha=4.0)
    built = {}

    def containers(strategy):
        """The containers of ``strategy``'s family, built once: the ring
        and its overlapped twin share the grid, 'all_gather' and the
        chunked gather the CSR shards."""
        family = {"ring_overlap": "ring",
                  "all_gather_chunked": "all_gather"}.get(strategy, strategy)
        if family in built:
            return built[family]
        uu, ii, rr, nu, ni = (u, i, r, num_users, num_items) \
            if family != "all_to_all" or a2a is None else a2a
        up = partition_balanced(np.bincount(uu, minlength=nu), P)
        ip = partition_balanced(np.bincount(ii, minlength=ni), P)
        counts = None
        if family == "ring":
            uc = shard_csr_grid(up, ip, uu, ii, rr, min_width=min_width,
                                chunk_elems=chunk_elems, positions=pos)
            ic = shard_csr_grid(ip, up, ii, uu, rr, min_width=min_width,
                                chunk_elems=chunk_elems, positions=pos)
            counts = tuple(
                stacked_counts(part, x, rr, positive_only=implicit)[list(pos)]
                for part, x in ((up, uu), (ip, ii)))
        elif family == "all_to_all":
            uc = build_a2a(up, ip, uu, ii, rr, min_width=min_width,
                           chunk_elems=chunk_elems, on_degenerate="build",
                           positions=pos)
            ic = build_a2a(ip, up, ii, uu, rr, min_width=min_width,
                           chunk_elems=chunk_elems, on_degenerate="build",
                           positions=pos)
        else:
            um = up.owner[uu] == pid
            im = ip.owner[ii] == pid
            uc = shard_csr(up, ip, uu[um], ii[um], rr[um],
                           min_width=min_width, chunk_elems=chunk_elems,
                           positions=pos,
                           row_counts=np.bincount(uu, minlength=nu))
            ic = shard_csr(ip, up, ii[im], uu[im], rr[im],
                           min_width=min_width, chunk_elems=chunk_elems,
                           positions=pos,
                           row_counts=np.bincount(ii, minlength=ni))
        built[family] = (up, ip, uc, ic, counts)
        return built[family]

    for strategy in PROCESS_STRATEGIES:
        containers(strategy)
    if ready is not None:
        ready()
    rows, seen = [], {}
    for strategy in PROCESS_STRATEGIES:
        up, ip, uc, ic, ring_counts = containers(strategy)
        step = make_process_step(mesh, strategy, uc, ic, cfg,
                                 ring_counts=ring_counts,
                                 gather_blocks=gather_blocks)
        model = comm_bytes_per_iter(strategy, up, ip, cfg.rank,
                                    user_container=uc, item_container=ic,
                                    implicit=bool(implicit))
        key = (step.__qualname__, id(uc))
        if key in seen:
            first = seen[key]
            rows.append({**first, "strategy": strategy, "model": int(model),
                         "seconds": None,
                         "same_step_as": first["strategy"]})
            continue
        g = torch.Generator().manual_seed(cfg.seed)
        U = core_als.init_factors(up.rows_per_shard, cfg.rank, g) \
            .to(mesh.device)
        V = core_als.init_factors(ip.rows_per_shard, cfg.rank, g) \
            .to(mesh.device)
        t0 = time.perf_counter()
        audited, breakdown = collective_bytes(step, U, V, axis_size=P)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        seconds = time.perf_counter() - t0
        rows.append({"strategy": strategy, "implicit": bool(implicit),
                     "audited": audited, "breakdown": breakdown,
                     "model": int(model), "seconds": seconds})
        seen[key] = rows[-1]
    return rows


def _worker(spec_dir):
    """One process of :func:`spawn`: join the group, audit, write
    ``rank<p>.json`` (this process's rows)."""
    with open(os.path.join(spec_dir, "spec.json")) as f:
        spec = json.load(f)
    multihost.init_distributed(init_method=spec["init_method"])
    if spec.get("threads"):
        torch.set_num_threads(int(spec["threads"]))
    data = np.load(os.path.join(spec_dir, "data.npz"))
    a2a = None
    if "a2a_u" in data:
        a2a = (data["a2a_u"], data["a2a_i"], data["a2a_r"],
               int(spec["a2a_users"]), int(spec["a2a_items"]))
    gate = [spec.get("gated")]

    def ready():
        # once: say so on stdout, then wait for the parent's go
        if gate[0]:
            gate[0] = False
            print("ready", flush=True)
            sys.stdin.readline()

    rows = []
    for implicit in spec["implicit"]:
        rows += audit_strategies(
            data["u"], data["i"], data["r"], int(spec["num_users"]),
            int(spec["num_items"]), int(spec["rank"]), implicit=implicit,
            device=spec["device"], min_width=int(spec["min_width"]),
            chunk_elems=int(spec["chunk_elems"]),
            gather_blocks=int(spec["gather_blocks"]), a2a=a2a, ready=ready)
    with open(os.path.join(spec_dir, f"rank{multihost.process_index()}"
                           ".json"), "w") as f:
        json.dump(rows, f)


def spawn(spec_dir, u, i, r, num_users, num_items, rank, *, nproc=2,
          device="cpu", implicit=(False, True), min_width=4,
          chunk_elems=1 << 19, gather_blocks=4, a2a=None, threads=1,
          timeout=600, env=None, gate=None):
    """Start ``nproc`` processes over gloo, joined by a ``file://``
    rendezvous in ``spec_dir`` (``multihost.file_init_method``: no port
    to collide with another group's), each one shard of the mesh on
    ``device``, and run
    :func:`audit_strategies` in all of them for each value of
    ``implicit``.  ``gate`` (a ``threading.Event``): the processes import,
    join and build their containers, then wait until it is set before
    the first step.  Returns each process's rows, in rank order; a
    process that fails or outlives ``timeout`` fails the call, and every
    process is stopped either way."""
    os.makedirs(spec_dir, exist_ok=True)
    arrays = {"u": np.asarray(u, np.int64), "i": np.asarray(i, np.int64),
              "r": np.asarray(r, np.float32)}
    spec = {"num_users": int(num_users), "num_items": int(num_items),
            "rank": int(rank), "device": str(device),
            "implicit": [bool(x) for x in implicit],
            "min_width": int(min_width),
            "chunk_elems": int(chunk_elems),
            "gather_blocks": int(gather_blocks), "threads": threads,
            "gated": gate is not None,
            "init_method": multihost.file_init_method(spec_dir)}
    if a2a is not None:
        arrays.update(a2a_u=np.asarray(a2a[0], np.int64),
                      a2a_i=np.asarray(a2a[1], np.int64),
                      a2a_r=np.asarray(a2a[2], np.float32))
        spec.update(a2a_users=int(a2a[3]), a2a_items=int(a2a[4]))
    np.savez(os.path.join(spec_dir, "data.npz"), **arrays)
    with open(os.path.join(spec_dir, "spec.json"), "w") as f:
        json.dump(spec, f)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    base = dict(os.environ if env is None else env)
    base["PYTHONPATH"] = os.pathsep.join(
        [root] + ([base["PYTHONPATH"]] if base.get("PYTHONPATH") else []))
    procs = []
    try:
        for p in range(nproc):
            penv = {**base, "WORLD_SIZE": str(nproc), "RANK": str(p)}
            if threads:
                penv["OMP_NUM_THREADS"] = str(threads)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tpu_als_torch.parallel.comm_audit",
                 spec_dir], env=penv, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
                stdin=subprocess.PIPE if gate is not None else None))
        if gate is not None:
            for p in procs:
                if p.stdout.readline().strip() != "ready":
                    raise RuntimeError("comm audit process failed before "
                                       "its first step:\n"
                                       + p.communicate()[1][-3000:])
            gate.wait()
            for p in procs:
                p.stdin.write("go\n")
                p.stdin.flush()
        errs = []
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                errs.append(err[-3000:])
        if errs:
            raise RuntimeError("comm audit process failed:\n"
                               + "\n".join(errs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    out = []
    for p in range(nproc):
        with open(os.path.join(spec_dir, f"rank{p}.json")) as f:
            out.append(json.load(f))
    return out


if __name__ == "__main__":
    _worker(sys.argv[1])
