"""Multi-process training and serving over ``torch.distributed``.

Counterpart of ``tpu_als/parallel/multihost.py``.  Every process runs the
same program; :func:`init_distributed` joins them into one process group,
and afterwards a :class:`~tpu_als_torch.parallel.mesh.Mesh` spans them:
each process lists its own L logical shards
(``make_mesh(devices=["cuda:0"] * L)``) and holds the mesh positions
``p·L .. p·L + L - 1`` of a mesh of P·L positions.  What is per process
is the data: :func:`local_positions` and :func:`local_rating_mask` give a
process the positions it owns and the ratings that land there, so
blocking (``shard_csr(positions=)``, ``shard_csr_grid(positions=)``,
``build_a2a(positions=)``) builds only the local shards, in the layout
every process agrees on.

**Launcher variables.**  torch's own, as ``torchrun`` sets them:
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK``.  The reference reads ``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``; the port does not.

**The transport.**  Every collective of the port goes through
``torch.distributed`` over gloo.  A CPU tensor goes to gloo directly.  A
CUDA tensor is copied to host memory, passed through the gloo collective
and copied back (``.cpu()`` -> gloo -> ``.to(device)``): NCCL refuses two
ranks on one card, and the transport across cards is not written yet.
The route is fixed when the group is created and printed then; it is
not a fallback.  K7 (the fused ring) and K8 (``'merge_ring'``) move no
data through a collective: on one card their processes map each other's
buffers (:mod:`.peer`, CUDA IPC), and only the handles and a barrier go
through gloo.  The compute stays on the device: only the collective
passes through the host.  Every collective adds to :data:`COMM` the
bytes it received, the bytes it staged between the device and the host,
and its wall time (staging included), so a caller reads per half-step
what moved and what it cost.

Three entry tiers, as the reference's:

1. ``ALS(mesh=...).fit(frame)`` in every process
   (``api.fitting.fit_multiprocess``), with replicated data or each
   process's own split (``dataMode='per_host'``: the id maps agreed by
   :func:`global_id_union`);
2. ``python -m tpu_als_torch.cli train --devices 0 [--per-host-data]``;
3. :func:`train_multihost` for custom loops.

Single-process, every helper is a no-op or its one-process answer, and
nothing here creates a process group.
"""

from __future__ import annotations

import datetime
import hashlib
import json
import os
import shutil
import sys
import time

import numpy as np
import torch


#: What the collectives of this process moved: ``collectives`` (calls),
#: ``bytes`` (payload received), ``staged_bytes`` (device -> host and
#: host -> device copies of the staged route) and ``seconds`` (wall time
#: in collectives, staging included, from the moment the device is idle).
#: :func:`reset_comm` zeroes it.
COMM = {"collectives": 0, "bytes": 0, "staged_bytes": 0, "seconds": 0.0}

#: The route of this process's collectives, set by :func:`init_distributed`
#: (None before a group exists).
ROUTE = None

#: ``record(primitive, out_bytes)`` while ``parallel/comm_audit.py``
#: audits a function: each collective that crosses processes calls it
#: once with the reference's primitive name and its output's bytes.
#: None otherwise, and then no collective does any bookkeeping for it
#: (:data:`COMM` counts either way).
RECORD = None

# the reference's rendezvous policy
_INIT_RETRY = dict(max_attempts=5, base_delay=1.0, max_delay=15.0)
# seconds a collective may wait for its peers
_COLLECTIVE_TIMEOUT_S = 600


def _dist():
    """``torch.distributed`` when a process group is up, else None.  Reads
    ``sys.modules`` only: nothing is imported here."""
    d = sys.modules.get("torch.distributed")
    if d is None or not d.is_available() or not d.is_initialized():
        return None
    return d


def process_count():
    """Processes in the group (1 without one): the port's
    ``jax.process_count()``."""
    d = _dist()
    return d.get_world_size() if d is not None else 1


def process_index():
    """This process's rank (0 without a group): the port's
    ``jax.process_index()``."""
    d = _dist()
    return d.get_rank() if d is not None else 0


def reset_comm():
    """Zero :data:`COMM`."""
    COMM.update(collectives=0, bytes=0, staged_bytes=0, seconds=0.0)


def init_distributed(init_method=None, world_size=None, rank=None,
                     retry_policy=None):
    """Join this process to the group (a no-op for one process).

    Resolution: explicit arguments (``init_method`` such as
    ``'tcp://localhost:29500'``, ``world_size``, ``rank``), else torch's
    launcher variables ``WORLD_SIZE`` / ``RANK`` with ``MASTER_ADDR`` /
    ``MASTER_PORT`` (``init_method='env://'``), else one process.  The
    reference's ``JAX_*`` variables are not read.  Idempotent: with a
    group up, nothing is created again.

    The rendezvous is retried under ``resilience.retry`` with the
    reference's policy (5 attempts, 1 s base, 15 s max), and the
    ``multihost.init`` fault point fires inside each attempt, so a chaos
    test drives the retry loop on the one-process path too.  With
    ``LOCAL_RANK`` set and several cards visible, the current CUDA device
    becomes ``LOCAL_RANK`` modulo the count.  Returns
    ``(process_index, process_count)``."""
    from tpu_als_torch.resilience import faults
    from tpu_als_torch.resilience.retry import RetryPolicy, retry_call

    env = os.environ
    ws = int(world_size if world_size is not None
             else env.get("WORLD_SIZE", 1))
    rk = rank if rank is not None else env.get("RANK")
    multi = ws > 1 and _dist() is None
    if multi:
        if rk is None:
            raise ValueError("a group of %d processes needs this process's "
                             "rank (rank= or RANK)" % ws)
        if init_method is None:
            if not (env.get("MASTER_ADDR") and env.get("MASTER_PORT")):
                raise ValueError(
                    "WORLD_SIZE > 1 needs MASTER_ADDR and MASTER_PORT (or "
                    "init_method='tcp://host:port')")
            init_method = "env://"

    def _rendezvous():
        # inside the retried closure, so the retry loop is exercised
        faults.check("multihost.init")
        if multi and _dist() is None:
            import torch.distributed as dist

            dist.init_process_group(
                "gloo", init_method=init_method, world_size=ws,
                rank=int(rk), timeout=datetime.timedelta(
                    seconds=_COLLECTIVE_TIMEOUT_S))
            _announce()

    policy = retry_policy if retry_policy is not None else RetryPolicy(
        retry_on=(OSError, TimeoutError, RuntimeError), **_INIT_RETRY)
    retry_call(_rendezvous, policy=policy, what="multihost.init")
    lr = env.get("LOCAL_RANK")
    if (lr is not None and torch.cuda.is_available()
            and torch.cuda.device_count() > 1):
        torch.cuda.set_device(int(lr) % torch.cuda.device_count())
    return process_index(), process_count()


def file_init_method(directory):
    """A ``file://`` rendezvous for a group that one parent starts, to
    pass to every process's :func:`init_distributed` (with its
    ``world_size`` and ``rank``): a store file that does not exist yet
    in ``directory``, which the parent owns.  No port is chosen, so no
    other group on the host can take it between the choice and the
    bind, as a port picked by binding port 0 and closing it can be."""
    import uuid

    path = os.path.join(os.path.abspath(directory),
                        f"rendezvous-{uuid.uuid4().hex}")
    return "file://" + path


def _announce():
    """Fix and print the route of this group's collectives."""
    global ROUTE
    ROUTE = ("gloo; CUDA tensors staged through host memory "
             "(.cpu() -> gloo -> .to(device))")
    print(f"multihost: process {process_index()} of {process_count()}, "
          f"collectives over {ROUTE}", file=sys.stderr, flush=True)


def rejoin(init_method=None, world_size=None, rank=None, retry_policy=None):
    """Re-run the rendezvous after an elastic mesh reformation.  One
    process (no group, no launcher variables): a no-op.  Otherwise the
    group is torn down and joined again under :func:`init_distributed`'s
    retried discipline.  Returns ``(process_index, process_count)``."""
    d = _dist()
    if d is None and init_method is None \
            and int(os.environ.get("WORLD_SIZE", 1)) <= 1:
        return process_index(), process_count()
    if d is not None:
        try:
            d.destroy_process_group()
        except Exception:
            pass  # a dead peer may have torn the group down already
    return init_distributed(init_method=init_method, world_size=world_size,
                            rank=rank, retry_policy=retry_policy)


# -- the collectives -------------------------------------------------------

def _nbytes(t):
    return t.numel() * t.element_size()


def _to_host(t):
    """``t`` as a contiguous CPU tensor; a CUDA tensor is copied out and
    the copy counted as staged."""
    t = t.detach()
    if t.device.type != "cpu":
        COMM["staged_bytes"] += _nbytes(t)
        return t.cpu().contiguous()
    return t.contiguous()


def _to_device(t, device):
    """The staged route's copy back to ``device``."""
    if device.type != "cpu":
        COMM["staged_bytes"] += _nbytes(t)
        return t.to(device)
    return t


def _start(t):
    """The clock at a collective's start, once ``t``'s device is idle:
    the staging copy would wait for the kernels in flight, and that wait
    is the compute's, not the collective's."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return time.perf_counter()


def _account(t0, received, primitive=None, out_bytes=0):
    COMM["collectives"] += 1
    COMM["bytes"] += int(received)
    COMM["seconds"] += time.perf_counter() - t0
    if RECORD is not None and primitive is not None:
        RECORD(primitive, int(out_bytes))


def all_gather(t):
    """Every process's ``t`` (one shape on every process) concatenated
    along dim 0 in process order, on ``t``'s device.  One process:
    ``t``."""
    d = _dist()
    if d is None:
        return t
    t0 = _start(t)
    h = _to_host(t)
    parts = [torch.empty_like(h) for _ in range(d.get_world_size())]
    d.all_gather(parts, h)
    out = torch.cat(parts)
    _account(t0, _nbytes(out), "all_gather", _nbytes(out))
    return _to_device(out, t.device)


def all_reduce_sum(parts):
    """The sum over every shard of the mesh of a per-shard value: the
    reference's ``psum`` over the mesh axis.  ``parts`` ``[L, ...]``:
    this process's L shards' values, in position order.  The values are
    added one shard after another in mesh-position order, so every
    process, and one process holding all the shards, gets the same bits.
    Across processes the stacks move by one gloo all-gather and each
    process adds them up; one process: the fold of its own ``L``.
    Returns ``parts[0]``'s shape on its device."""
    d = _dist()
    if d is not None:
        t0 = _start(parts)
        h = _to_host(parts)
        gathered = [torch.empty_like(h) for _ in range(d.get_world_size())]
        d.all_gather(gathered, h)
        out = torch.cat(gathered)
        _account(t0, _nbytes(out), "psum", _nbytes(out[0]))
        parts = _to_device(out, parts.device)
    total = parts[0].clone()
    for x in parts[1:]:
        total += x
    return total


def ppermute(t, shift=1):
    """Send ``t`` to process ``p + shift`` and receive the one of process
    ``p - shift`` (modulo P; one shape on every process), on ``t``'s
    device: the reference's ``ppermute``."""
    d = _dist()
    if d is None:
        return t
    t0 = _start(t)
    P, p = d.get_world_size(), d.get_rank()
    h = _to_host(t)
    out = torch.empty_like(h)
    reqs = [d.isend(h, (p + shift) % P), d.irecv(out, (p - shift) % P)]
    for q in reqs:
        q.wait()
    _account(t0, _nbytes(out), "ppermute", _nbytes(out))
    return _to_device(out, t.device)


def all_to_all(blocks):
    """``blocks[q]`` goes to process q; returns the list of what each
    process sent here (``blocks`` of one shape everywhere), on the first
    block's device."""
    d = _dist()
    if d is None:
        return list(blocks)
    t0 = _start(blocks[0])
    dev = blocks[0].device
    # one stacked buffer through all_to_all_single: gloo has no list
    # all_to_all in every torch release (2.11's raises "Backend gloo does
    # not support alltoall"), while the single-tensor form is gloo's own
    h = _to_host(torch.stack(list(blocks)))
    out = torch.empty_like(h)
    d.all_to_all_single(out, h)
    received = _nbytes(out)
    _account(t0, received, "all_to_all", received)
    return list(_to_device(out, dev).unbind(0))


def barrier():
    """Wait for every process (one process: nothing)."""
    d = _dist()
    if d is not None:
        t0 = time.perf_counter()
        d.barrier()
        _account(t0, 0)


def process_allgather(arr):
    """Every process's numpy ``arr`` (one shape and dtype everywhere),
    stacked ``[P, ...]``: the reference's ``process_allgather``.  One
    process: ``arr[None]``."""
    arr = np.ascontiguousarray(arr)
    if _dist() is None:
        return arr[None]
    g = all_gather(torch.from_numpy(arr.reshape(1, *arr.shape).copy()))
    return g.numpy()


def _ragged_allgather(arr, fill=0):
    """Every process's 1-D array concatenated, ragged lengths allowed:
    lengths first, each padded to the longest, one all-gather, the
    padding dropped.  O(P · max_len) host memory."""
    arr = np.asarray(arr)
    lens = process_allgather(np.array([len(arr)], dtype=np.int64)).ravel()
    pad = int(lens.max())
    if pad == 0:
        return arr[:0]
    buf = np.full(pad, fill, dtype=arr.dtype)
    buf[:len(arr)] = arr
    g = process_allgather(buf)
    keep = np.arange(pad)[None, :] < lens[:, None]
    return g[keep]


def _triples_digest(u, i, r):
    """Order-independent int64 digest of (u, i, r) triples: blake2b over
    the lexicographically sorted rows (the reference's arithmetic, so
    both packages digest a split alike)."""
    order = np.lexsort((np.asarray(r), np.asarray(i), np.asarray(u)))
    buf = np.concatenate([
        np.asarray(u, dtype=np.int64)[order].view(np.uint8),
        np.asarray(i, dtype=np.int64)[order].view(np.uint8),
        np.asarray(r, dtype=np.float32)[order].view(np.uint8),
    ])
    h = hashlib.blake2b(buf.tobytes(), digest_size=8).digest()
    return int(np.frombuffer(h, dtype=np.int64)[0])


def _split_signatures_duplicated(sig):
    """True when any two non-empty per-process ``(len, digest)`` rows
    match: the duplicated-load mistake.  Pairwise, so with P > 2 two
    processes reading one file are caught even when the others differ;
    empty splits are left out (several processes may hold nothing)."""
    sig = np.asarray(sig)
    nonempty = sig[sig[:, 0] > 0]
    return len(nonempty) != len(np.unique(nonempty, axis=0))


def global_id_union(local_ids):
    """The sorted union of every process's ids: the agreed entity space of
    a per-host fit.  Each process sends only its unique ids.  One process:
    ``np.unique``."""
    uniq = np.unique(np.asarray(local_ids))
    if process_count() == 1:
        return uniq
    return np.unique(_ragged_allgather(uniq.astype(np.int64)))


def global_vocab_union(labels):
    """The sorted union of every process's string vocabulary (an ``S``
    array): labels padded to the agreed width, moved as uint8 rows
    through the ragged all-gather, and uniqued.  Labels must not hold NUL
    bytes (the padding).  One process: ``np.unique``."""
    labels = np.asarray(labels, dtype="S")
    if process_count() == 1:
        return np.unique(labels)
    w = int(process_allgather(np.array(
        [max(labels.dtype.itemsize, 1)], dtype=np.int64)).max())
    rows = np.zeros((len(labels), w), dtype=np.uint8)
    if len(labels):
        loc_w = labels.dtype.itemsize
        rows[:, :loc_w] = labels.view(np.uint8).reshape(len(labels), loc_w)
    flat = _ragged_allgather(rows.ravel())
    gathered = np.ascontiguousarray(flat.reshape(-1, w)).view(f"S{w}")
    return np.unique(gathered.ravel())


def local_positions(mesh):
    """The mesh positions (0 .. P·L - 1) this process's shards hold."""
    return list(mesh.positions)


def local_rating_mask(part, row_idx, mesh=None, positions=None):
    """True where a rating's solved-side entity is owned by one of this
    process's positions (``positions`` overrides the mesh's; exactly one
    of the two is needed)."""
    if positions is None:
        if mesh is None:
            raise ValueError("pass mesh or positions")
        positions = local_positions(mesh)
    own = np.zeros(part.n_shards, dtype=bool)
    own[list(positions)] = True
    return own[part.owner[np.asarray(row_idx)]]


def gather_entity_factors(table, part, mesh):
    """Entity-space factors from this process's slot rows ``table``
    (``[L·rows_per_shard, r]``, a tensor): one all-gather of every
    process's rows and positions, then the slot space unscattered.
    Collective: every process calls it.  Returns a tensor on the table's
    device."""
    from tpu_als_torch.convert import entity_rows

    rps = part.rows_per_shard
    if process_count() > 1:
        L = len(local_positions(mesh))
        rows = all_gather(table)
        pos = process_allgather(np.asarray(local_positions(mesh),
                                           dtype=np.int64))
        slot = table.new_zeros((part.padded_rows, table.shape[-1]))
        for p, row in enumerate(pos):
            for li, at in enumerate(row):
                k = p * L + li
                slot[at * rps:(at + 1) * rps] = rows[k * rps:(k + 1) * rps]
        table = slot
    return entity_rows(part, table)


def _agree(num_users, num_items, cfg, start_iter, replicated, u, i, r):
    """The reference's agreement checks before the exchange: one entity
    space and one iteration window; with ``replicated`` the same triples
    on every process, else no two processes with the same split."""
    dims = process_allgather(np.array(
        [num_users, num_items, int(start_iter), int(cfg.max_iter)],
        dtype=np.int64))
    if not (dims == dims[0]).all():
        raise ValueError(
            "processes disagree on (num_users, num_items, start_iter, "
            f"max_iter): {dims.tolist()}; all processes must share one id "
            "mapping and one iteration window (same resumeFrom checkpoint, "
            "same maxIter)")
    if replicated:
        sig = process_allgather(np.array(
            [len(u), int(u.sum()), int(i.sum()),
             np.float64(r.astype(np.float64).sum()).view(np.int64)],
            dtype=np.int64))
        if not (sig == sig[0]).all():
            raise ValueError(
                "replicated=True but per-process rating data differ "
                f"(len/Σu/Σi/Σr signatures: {sig.tolist()}); every process "
                "must load the SAME dataset, or pass its own split with "
                "replicated=False")
        return
    sig = process_allgather(np.array([len(u), _triples_digest(u, i, r)],
                                     dtype=np.int64))
    if _split_signatures_duplicated(sig):
        raise ValueError(
            "replicated=False but two or more processes passed IDENTICAL "
            "rating triples; each process must pass its OWN disjoint split "
            "(per-host input files), or pass replicated=True for a shared "
            "load")


def train_multihost(u, i, r, num_users, num_items, cfg, mesh=None,
                    min_width=8, chunk_elems=1 << 19, replicated=False,
                    strategy="all_gather", init=None, start_iter=0,
                    callback=None, knobs=None):
    """Multi-process ALS: every process calls this with its OWN triples
    (global dense ids), or with the same full triples and
    ``replicated=True``.

    (1) The agreement checks, then the exchange: every process gathers
    every split (O(total nnz) a process; ``replicated=True`` skips it);
    (2) the global counts -> partitions -> blocking of this process's
    positions only, into the layout every process derives
    (``shard_layout``); (3) the step of ``strategy`` over this process's
    rows (``parallel.trainer``: 'all_gather' and 'all_gather_chunked'
    gather the opposite table once a half-step, the ring family rotates
    it between processes, 'all_to_all' exchanges only the referenced
    rows; a degenerate a2a plan falls back to 'all_gather' with
    ``replicated=True``, as the reference's does).

    The init: ``init`` (entity-space ``(U0, V0)``) scattered into slot
    space, else ``init_factors`` drawn from one ``torch.Generator``
    seeded with ``cfg.seed`` on every process (users first), the draw of
    the single-process ``train_sharded``, so every process starts from
    the same factors and the fit equals the one-process S-shard fit.
    ``knobs``: the kernel knobs every process agreed on (the gate); a
    multi-process fit never tunes.  ``callback(iteration, U, V, upart,
    ipart)`` gets this process's slot rows after every iteration; a
    collective inside it must run on every process.

    Returns ``(U, V, user_part, item_part)``: this process's slot rows
    ``[L·rows_per_shard, r]`` on the mesh's device."""
    from tpu_als_torch.core import als as core_als
    from tpu_als_torch.core.als import init_factors
    from tpu_als_torch.parallel.data import partition_balanced, shard_csr
    from tpu_als_torch.parallel.mesh import make_mesh
    from tpu_als_torch.parallel.trainer import (EXECUTABLE_STRATEGIES,
                                                make_process_step,
                                                stacked_counts)

    if mesh is None:
        mesh = make_mesh()
    if strategy not in EXECUTABLE_STRATEGIES:
        raise ValueError(
            f"unknown strategy {strategy!r} for multi-process training "
            f"(expected one of {EXECUTABLE_STRATEGIES})")
    # pin dtypes before any collective: gloo pairs buffers by shape/type
    u = np.asarray(u, dtype=np.int64)
    i = np.asarray(i, dtype=np.int64)
    r = np.asarray(r, dtype=np.float32)
    if process_count() > 1:
        _agree(num_users, num_items, cfg, start_iter, replicated, u, i, r)
        if not replicated:
            u, i, r = (_ragged_allgather(u), _ragged_allgather(i),
                       _ragged_allgather(r))

    D = mesh.global_size
    ucounts = np.bincount(u, minlength=num_users)
    icounts = np.bincount(i, minlength=num_items)
    upart = partition_balanced(ucounts, D)
    ipart = partition_balanced(icounts, D)
    positions = local_positions(mesh)
    ring_counts = None
    if strategy in ("ring", "ring_overlap"):
        from tpu_als_torch.parallel.comm import shard_csr_grid

        ush = shard_csr_grid(upart, ipart, u, i, r, min_width=min_width,
                             chunk_elems=chunk_elems, positions=positions)
        ish = shard_csr_grid(ipart, upart, i, u, r, min_width=min_width,
                             chunk_elems=chunk_elems, positions=positions)
        pos_only = cfg.implicit_prefs
        ring_counts = (
            stacked_counts(upart, u, r, positive_only=pos_only)[positions],
            stacked_counts(ipart, i, r, positive_only=pos_only)[positions])
    elif strategy in ("all_gather", "all_gather_chunked"):
        umask = local_rating_mask(upart, u, positions=positions)
        imask = local_rating_mask(ipart, i, positions=positions)
        ush = shard_csr(upart, ipart, u[umask], i[umask], r[umask],
                        min_width=min_width, chunk_elems=chunk_elems,
                        positions=positions, row_counts=ucounts)
        ish = shard_csr(ipart, upart, i[imask], u[imask], r[imask],
                        min_width=min_width, chunk_elems=chunk_elems,
                        positions=positions, row_counts=icounts)
    else:  # all_to_all: the plan is global, only local sources are placed
        from tpu_als_torch.parallel.a2a import build_a2a

        ush = build_a2a(upart, ipart, u, i, r, min_width=min_width,
                        chunk_elems=chunk_elems, on_degenerate="stub",
                        positions=positions)
        ish = build_a2a(ipart, upart, i, u, r, min_width=min_width,
                        chunk_elems=chunk_elems, on_degenerate="stub",
                        positions=positions)
        if ush.degenerate or ish.degenerate:
            return train_multihost(
                u, i, r, num_users, num_items, cfg, mesh=mesh,
                min_width=min_width, chunk_elems=chunk_elems,
                replicated=True, strategy="all_gather", init=init,
                start_iter=start_iter, callback=callback, knobs=knobs)

    if init is None:
        g = torch.Generator().manual_seed(int(cfg.seed))
        init = (init_factors(num_users, cfg.rank, g),
                init_factors(num_items, cfg.rank, g))
    dev = mesh.device
    U = _local_slot_rows(upart, init[0], positions, dev)
    V = _local_slot_rows(ipart, init[1], positions, dev)
    core_als.plan_training(cfg, cfg.rank, (knobs or {}).get("split_width"),
                           dev)
    step = make_process_step(mesh, strategy, ush, ish, cfg,
                             ring_counts=ring_counts, knobs=knobs)
    try:
        for it in range(start_iter, cfg.max_iter):
            U, V = step(U, V)
            if callback is not None:
                callback(it + 1, U, V, upart, ipart)
    finally:
        # the fused ring's mapped buffers (collective)
        if hasattr(step, "close"):
            step.close()
    return U, V, upart, ipart


def _local_slot_rows(part, rows, positions, device):
    """This process's rows of the slot-space table of the entity rows
    ``rows`` (padding slots 0)."""
    from tpu_als_torch.convert import slot_rows

    full = slot_rows(part, torch.as_tensor(np.asarray(rows)).float())
    rps = part.rows_per_shard
    return torch.cat([full[p * rps:(p + 1) * rps] for p in positions]) \
        .to(device)


def save_checkpoint_sharded(path, Us, Vs, upart, ipart, user_map, item_map,
                            mesh, params=None, iteration=None):
    """A shard-per-process checkpoint in the reference's sharded layout
    (``SHARDED_FORMAT``): each process writes the npz of each position it
    holds (``user_shard_00000.npz`` ...); process 0 adds ``slots.npz``
    (ids and slot arrays) and the manifest; barriers around the writes;
    then process 0 installs it with ``io.checkpoint.atomic_install``, so
    a complete checkpoint is at ``path`` or ``path + '.old'`` at every
    instant.  Factor bytes never cross processes.  ``load_factors`` of
    either package reassembles entity-space factors from it."""
    from tpu_als_torch.io.checkpoint import SHARDED_FORMAT, atomic_install

    pidx = process_index()
    multi = process_count() > 1
    tmp = path + ".tmp"
    # a crashed attempt's leftovers go before anyone writes (a run with
    # another shard count would leave wrong-generation files behind)
    if pidx == 0 and os.path.exists(tmp):
        shutil.rmtree(tmp)
    if multi:
        barrier()
    os.makedirs(tmp, exist_ok=True)
    positions = local_positions(mesh)
    for name, table, part in (("user", Us, upart), ("item", Vs, ipart)):
        rows = table.detach().cpu().numpy() \
            if isinstance(table, torch.Tensor) else np.asarray(table)
        rps = part.rows_per_shard
        for li, pos in enumerate(positions):
            np.savez(os.path.join(tmp, f"{name}_shard_{pos:05d}.npz"),
                     factors=rows[li * rps:(li + 1) * rps])
    if pidx == 0:
        np.savez(os.path.join(tmp, "slots.npz"),
                 user_ids=np.asarray(user_map.ids),
                 item_ids=np.asarray(item_map.ids),
                 user_slot=np.asarray(upart.slot),
                 item_slot=np.asarray(ipart.slot))
        manifest = {
            "format_version": SHARDED_FORMAT,
            "sharded": True,
            "n_shards": int(upart.n_shards),
            "rows_per_shard_user": int(upart.rows_per_shard),
            "rows_per_shard_item": int(ipart.rows_per_shard),
            "rank": int(Us.shape[-1]),
            "num_users": int(len(user_map)),
            "num_items": int(len(item_map)),
            "iteration": iteration,
            "params": params or {},
            "extra": {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
    if multi:
        barrier()
    if pidx == 0:
        atomic_install(tmp, path)
    if multi:
        # no process races into the next save's tmp (or a resume) while
        # the swap is in flight
        barrier()
