"""Sharded top-k serving: ``recommendForAll*`` over a mesh of shards.

Counterpart of ``tpu_als/parallel/serve.py::topk_sharded``, with its three
strategies.  The catalog is padded to S·ni_loc rows and cut into S shards
of ni_loc; global item id = s·ni_loc + local.

- ``'all_gather'``: the queries cut into S shards; each query shard runs
  kernel K5 over the whole catalog (on one device, the stacked shards).
- ``'ring'``: each query shard runs K5 over one catalog shard per
  rotation — owner d holds catalog shard (d - t) mod S after t of them —
  and folds it into its running set with the stable merge (the
  reference leaves that merge to XLA).
- ``'merge_ring'``: kernel K8 — every shard scores the whole query set
  against its own catalog shard, and the S candidate sets merge in shard
  order, bitwise ``chunked_topk_scores`` over the whole catalog, tie
  order included.  Its candidate sets hold at most 128, so above
  k = 128 :func:`topk_sharded` runs ``'ring'`` in its place, as the
  reference does; that is the only strategy swapped.

``'all_gather'`` and ``'ring'`` reach K5 through ``topk_scores``, which
sends a k above 128 to its scan route (``chunked_topk_scores``), as the
reference's dispatch does.

Degraded mode, as the reference's: when the sharded call fails (the
``serve.gather`` fault point: raise = a failed gather, corrupt = a
stale or lost shard), the request is answered from the last catalog
this same mesh served (``_last_good``; ``serve.degraded`` counter,
``serve_degraded`` event) by ``cuda_topk.topk_scores`` on the mesh's
device, K5 on the card; with no last-good catalog,
:class:`ServeShardLost` raises.  Every answered call, clean, degraded,
empty or across processes, writes the reference's
``serve.request_seconds{strategy}`` (the strategy that ran:
``'merge_ring'`` above k = 128 runs ``'ring'``, as the reference's),
``serve.requests`` and ``serve.rows`` (the query rows of ``U``).  Three
choices of the port:

- **The latency ends in a device sync** (``torch.cuda.synchronize`` on
  a CUDA mesh): the reference's clock stops once its results are on the
  host, the port's results are device tensors whose kernels may still
  be running.
- **The cache key** is the mesh's ``(device, ids)``, the counterpart of
  the reference's device ids: two meshes with other logical ids never
  answer from each other's catalog, even on one card.
- **What is caught** is :class:`ServeShardLost` and ``OSError`` (which
  includes the injected ``InjectedFault``), where the reference catches
  ``(OSError, RuntimeError)``: a ``RuntimeError`` from a kernel raises,
  so that a kernel failure is never hidden behind a degraded answer.

Across processes (a mesh of P processes × L shards,
:mod:`.multihost`): every process passes the whole ``U`` and ``V`` and
keeps only its own: the query rows of its positions and the catalog
shards of its positions.  ``'all_gather'`` gathers the catalog shards
between processes once, then scores each local query shard through K5
over the whole catalog; ``'ring'`` rotates the processes' catalog blocks
(send/recv) and folds each held shard into the running set.  The result
is this process's query rows and their global row offset, ``(scores,
ids, row_offset)``: the port's counterpart of reading
``.addressable_shards`` of the reference's global arrays.  There is no
degraded mode across processes (the processes could not agree on it):
a failure raises.  ``'merge_ring'`` runs K8 in two halves: each process
scores every query row against its own shards and writes the candidate
sets, and each merges its own query rows over every process's sets
(:func:`_merge_ring_processes`: on the card through buffers the
processes map from each other, on the CPU gathered); above k = 128 it
runs ``'ring'``, as in one process.
"""

from __future__ import annotations

import threading
import time

import torch

from tpu_als_torch import obs
from tpu_als_torch.ops import cuda_topk
from tpu_als_torch.ops.topk import NEG_INF, merge_topk
from tpu_als_torch.parallel import multihost
from tpu_als_torch.resilience import faults

STRATEGIES = ("all_gather", "ring", "merge_ring")


class ServeShardLost(RuntimeError):
    """A sharded top-k failed (a lost or stale shard) and no last-good
    catalog is cached for this mesh to answer from."""


# (V, valid) of the last successful sharded serve, one entry per mesh
# (the newest serve of any strategy replaces it), keyed by _cache_key;
# the lock guards it against concurrent serving threads
_last_good = {}
_last_good_lock = threading.Lock()


def _cache_key(mesh):
    return (mesh.device, mesh.ids)


def reset_last_good():
    """Drop the degraded-serving cache."""
    with _last_good_lock:
        _last_good.clear()


def _serve_degraded(U, k, Nu, mesh, strategy, reason, record):
    """Answer from this mesh's last-good catalog on its device: slower and
    possibly stale, but an answer."""
    with _last_good_lock:
        entry = _last_good.get(_cache_key(mesh))
    if entry is None:
        raise ServeShardLost(
            f"sharded top-k failed ({reason}) and no last-good factors "
            "are cached for this mesh to serve degraded from")
    Vg, validg = entry
    kk = min(k, Vg.shape[0])
    obs.counter("serve.degraded")
    obs.emit("serve_degraded", strategy=strategy, reason=reason)
    s, ix = cuda_topk.topk_scores(U, Vg, validg, kk)
    record(Nu)
    return s[:Nu], ix[:Nu]


def _as_f32(x, device):
    return torch.as_tensor(x).to(device=device, dtype=torch.float32) \
        .contiguous()


def topk_sharded(U, V, k, mesh, strategy="all_gather", item_valid=None,
                 item_chunk=8192, return_info=False):
    """Top-k of every row of ``U`` [Nu, r] over the catalog ``V`` [Ni, r]
    (``item_valid`` [Ni] bool, default all valid) on ``mesh``: (scores
    [Nu, k'] float32, ids [Nu, k'] int64) with ``k' = min(k, Ni)``, as
    tensors on the mesh's device.  The scores are those of
    ``chunked_topk_scores(U, V, valid, k')``; ``'merge_ring'`` also
    returns its ids, the others may order ties differently.  A failed
    call answers degraded (module docstring); ``return_info=True``
    appends ``{"degraded": bool, "reason": str or None}``.  Across
    processes (module docstring) it returns ``(scores, ids,
    row_offset)``: this process's query rows ``row_offset ..
    row_offset + len(scores)`` of ``U``."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown serving strategy {strategy!r} "
                         f"(expected one of {STRATEGIES})")
    t0 = time.perf_counter()
    dev = mesh.device

    def _record(nrows):
        # the reference's latency histogram and throughput counters; the
        # clock stops once the result's kernels are done
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        obs.histogram("serve.request_seconds", time.perf_counter() - t0,
                      strategy=strategy)
        obs.counter("serve.requests")
        obs.counter("serve.rows", nrows)

    def _info(out, degraded, reason=None):
        return out + ({"degraded": degraded, "reason": reason},) \
            if return_info else out

    U, V = _as_f32(U, dev), _as_f32(V, dev)
    Nu, r = U.shape
    Ni = V.shape[0]
    if Ni == 0 or Nu == 0 or k == 0:
        kk = min(k, Ni)
        _record(Nu)
        if mesh.process_count > 1:
            lo, hi = _process_rows(Nu, mesh)
            return _info((torch.zeros(hi - lo, kk, dtype=torch.float32,
                                      device=dev),
                          torch.zeros(hi - lo, kk, dtype=torch.int64,
                                      device=dev), lo), False)
        return _info((torch.zeros(Nu, kk, dtype=torch.float32, device=dev),
                      torch.zeros(Nu, kk, dtype=torch.int64, device=dev)),
                     False)
    if strategy == "merge_ring" and min(k, Ni) > cuda_topk.MAX_K:
        strategy = "ring"  # the merged candidate sets hold at most 128
    valid = (torch.ones(Ni, dtype=torch.bool, device=dev)
             if item_valid is None
             else torch.as_tensor(item_valid).to(device=dev,
                                                 dtype=torch.bool))
    if mesh.process_count > 1:
        # no degraded mode: every process would have to degrade alike
        if faults.check("serve.gather") == "corrupt":
            raise ServeShardLost("stale/lost factor shard (no degraded "
                                 "mode across processes)")
        out = _topk_processes(U, V, valid, k, mesh, strategy, item_chunk)
        _record(Nu)
        return _info(out, False)
    try:
        # fault point: raise = a failed gather; corrupt = a stale or lost
        # shard (nothing sane to execute against)
        if faults.check("serve.gather") == "corrupt":
            raise ServeShardLost("stale/lost factor shard")
        out = _topk_sharded(U, V, valid, k, mesh, strategy, item_chunk)
    except (ServeShardLost, OSError) as e:
        reason = f"{type(e).__name__}: {e}"
        return _info(_serve_degraded(U, k, Nu, mesh, strategy, reason,
                                     _record), True, reason)
    with _last_good_lock:
        _last_good[_cache_key(mesh)] = (V, valid)
    _record(Nu)
    return _info(out, False)


def _topk_sharded(U, V, valid, k, mesh, strategy, item_chunk):
    """The sharded call of :func:`topk_sharded` (Nu, Ni, k > 0)."""
    dev = mesh.device
    Nu, r = U.shape
    Ni = V.shape[0]
    D = mesh.size
    k_eff = min(k, Ni)
    ni_loc = -(-Ni // D)
    # the catalog in D shards of ni_loc rows; padding rows are invalid
    Vp = torch.zeros(D * ni_loc, r, dtype=torch.float32, device=dev)
    Vp[:Ni] = V
    validp = torch.zeros(D * ni_loc, dtype=torch.bool, device=dev)
    validp[:Ni] = valid
    if strategy == "merge_ring":
        return cuda_topk.topk_merge_ring(U, Vp.reshape(D, ni_loc, r),
                                         validp.reshape(D, ni_loc), k_eff)
    nu_loc = -(-Nu // D)
    k_loc = min(k_eff, ni_loc)
    out_s, out_i = [], []
    for d in range(D):
        Ud = U[d * nu_loc:(d + 1) * nu_loc]
        if strategy == "all_gather":
            s, ix = cuda_topk.topk_scores(Ud, Vp, validp, k_eff,
                                          item_chunk=min(item_chunk,
                                                         D * ni_loc))
        else:
            s = torch.full((Ud.shape[0], k_eff), NEG_INF,
                           dtype=torch.float32, device=dev)
            ix = torch.zeros(Ud.shape[0], k_eff, dtype=torch.int64,
                             device=dev)
            for t in range(D):
                own = (d - t) % D  # the catalog shard held after t rotations
                sl = slice(own * ni_loc, (own + 1) * ni_loc)
                st, it = cuda_topk.topk_scores(
                    Ud, Vp[sl], validp[sl], k_loc,
                    item_chunk=min(item_chunk, ni_loc))
                s, ix = merge_topk(s, ix, st, own * ni_loc + it, k_eff)
        out_s.append(s)
        out_i.append(ix)
    return torch.cat(out_s), torch.cat(out_i)


def _process_rows(Nu, mesh):
    """``[lo, hi)``: the query rows of this process's positions (the
    queries cut into S shards of ceil(Nu / S) rows)."""
    nu_loc = -(-Nu // mesh.global_size)
    lo = min(Nu, mesh.positions[0] * nu_loc)
    return lo, min(Nu, (mesh.positions[-1] + 1) * nu_loc)


def _topk_processes(U, V, valid, k, mesh, strategy, item_chunk):
    """This process's part of a sharded top-k across processes
    (``'all_gather'`` or ``'ring'``; module docstring): ``(scores, ids,
    row_offset)``."""
    dev = mesh.device
    Nu, r = U.shape
    Ni = V.shape[0]
    S, L = mesh.global_size, mesh.size
    P, p = mesh.process_count, mesh.process_index
    k_eff = min(k, Ni)
    ni_loc = -(-Ni // S)
    nu_loc = -(-Nu // S)
    Vp = torch.zeros(S * ni_loc, r, dtype=torch.float32, device=dev)
    Vp[:Ni] = V
    validp = torch.zeros(S * ni_loc, dtype=torch.uint8, device=dev)
    validp[:Ni] = valid
    # this process's query shards and catalog block (its positions')
    queries = [U[min(Nu, d * nu_loc):min(Nu, (d + 1) * nu_loc)]
               for d in mesh.positions]
    blk = slice(mesh.positions[0] * ni_loc, (mesh.positions[-1] + 1) * ni_loc)
    held, held_valid = Vp[blk].contiguous(), validp[blk].contiguous()
    if strategy == "merge_ring":
        lo, hi = _process_rows(Nu, mesh)
        s, ix = _merge_ring_processes(
            U, held.reshape(L, ni_loc, r),
            held_valid.bool().reshape(L, ni_loc), k_eff, mesh, lo, hi)
        return s, ix, lo
    if strategy == "all_gather":
        Vg = multihost.all_gather(held)
        vg = multihost.all_gather(held_valid).bool()
        out = [cuda_topk.topk_scores(Ud, Vg, vg, k_eff,
                                     item_chunk=min(item_chunk, S * ni_loc))
               for Ud in queries]
    else:
        k_loc = min(k_eff, ni_loc)
        out = [(torch.full((Ud.shape[0], k_eff), NEG_INF,
                           dtype=torch.float32, device=dev),
                torch.zeros(Ud.shape[0], k_eff, dtype=torch.int64,
                            device=dev)) for Ud in queries]
        for q in range(P):
            src_proc = (p - q) % P  # whose block is held after q hops
            for j, Ud in enumerate(queries):
                s, ix = out[j]
                for li in range(L):
                    sl = slice(li * ni_loc, (li + 1) * ni_loc)
                    st, it = cuda_topk.topk_scores(
                        Ud, held[sl], held_valid[sl].bool(), k_loc,
                        item_chunk=min(item_chunk, ni_loc))
                    s, ix = merge_topk(s, ix, st,
                                       (src_proc * L + li) * ni_loc + it,
                                       k_eff)
                out[j] = (s, ix)
            if q < P - 1:
                held = multihost.ppermute(held)
                held_valid = multihost.ppermute(held_valid)
    return (torch.cat([s for s, _ in out]), torch.cat([ix for _, ix in out]),
            _process_rows(Nu, mesh)[0])


def _merge_ring_processes(U, V_loc, valid_loc, k, mesh, lo, hi):
    """K8 across processes (``'merge_ring'``, k <= 128): every process
    scores every query row against its own L catalog shards
    (scan-to-sets), the candidate sets move, and each process merges its
    query rows ``lo .. hi`` over every shard's sets in shard order
    (merge-from-sets), as the reference's ring moves the packed sets and
    never the catalog.  Each shard is cut in the parts the one-process
    K8 over the S shards cuts it in, so the rows are its rows bit for
    bit.  On the card the sets go to a buffer every peer maps
    (``parallel/peer.py``), written, then a stream sync and a barrier,
    then merged, then released by the buffer's collective close (its
    first barrier waits for every merge); on the CPU they move by
    ``multihost.all_gather``."""
    from tpu_als_torch.parallel import peer

    Nu = U.shape[0]
    L, ni_loc = V_loc.shape[:2]
    S, P = mesh.global_size, mesh.process_count
    first = mesh.positions[0]
    dev = U.device
    tiles = -(-Nu // cuda_topk.TILE_U)
    if dev.type == "cpu":
        parts = 1
        shape = (tiles, L * parts, cuda_topk.TILE_U, k)
        cs = torch.empty(shape, dtype=torch.float32)
        ci = torch.empty(shape, dtype=torch.int64)
        cuda_topk.topk_sets(U, V_loc, valid_loc, k, parts=parts, first=first,
                            coll_s=cs, coll_i=ci, n_shards=S)

        def every(t):  # [P·tiles, ...] -> the processes' sets side by side
            g = multihost.all_gather(t).reshape(P, *t.shape)
            return g.permute(1, 0, 2, 3, 4).reshape(
                tiles, P * L * parts, cuda_topk.TILE_U, k)

        return cuda_topk.topk_merge_sets((every(cs), every(ci)), k, lo,
                                         hi - lo)
    parts = cuda_topk.topk_parts(Nu, ni_loc, S, cuda_topk._sms(dev))
    shape = (tiles, L * parts, cuda_topk.TILE_U, k)
    n_el = tiles * L * parts * cuda_topk.TILE_U * k
    buf = peer.PeerBuffer(n_el * (4 + 8), dev)
    try:
        cs = buf.local(shape, torch.float32)
        ci = buf.local(shape, torch.int64, offset=n_el * 4)
        cuda_topk.topk_sets(U, V_loc.contiguous(), valid_loc.contiguous(),
                            k, parts=parts, first=first, coll_s=cs,
                            coll_i=ci, n_shards=S)
        peer.publish()
        sets = cuda_topk.MappedSets(
            torch.tensor(buf.ptrs, dtype=torch.int64, device=dev),
            torch.tensor([q + n_el * 4 for q in buf.ptrs],
                         dtype=torch.int64, device=dev), L * parts)
        out = cuda_topk.topk_merge_sets(sets, k, lo, hi - lo)
    finally:
        buf.close()
    return out
