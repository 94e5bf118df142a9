"""Kernels K5 (fused score GEMM + running top-k) and K8 (the cross-shard
top-k merge) — wrappers.

K5 :func:`topk_scores`: counterpart of
``tpu_als/ops/pallas_topk.py::topk_scores_pallas``, source
``tpu_als_torch/csrc/topk.cu``.  Same contract as
:func:`tpu_als_torch.ops.topk.chunked_topk_scores`, which is its plain
version: U [n, r] f32, V [Ni, r] f32, item_valid [Ni] bool, k <= 128 ->
(scores [n, k] f32 descending, ids [n, k] int64); surplus slots hold
exactly ``NEG_INF``; tie order is not promised.  :func:`topk_scores` is
also the reference's ``topk_scores`` dispatch, routed by k alone
(:func:`topk_route`): k = 0 returns empty results, k <= 128 goes to K5,
a larger k to ``chunked_topk_scores`` (``torch.matmul`` + a stable
top-k per item chunk), the counterpart of the reference's XLA scan, not
of a Pallas kernel.

K8 :func:`topk_merge_ring`: counterpart of
``tpu_als/ops/pallas_topk.py::topk_merge_ring``, source
``tpu_als_torch/csrc/topk_merge_ring.cu``: the catalog in S shards, each
shard's stable top-k, then their stable merge in shard order — bitwise
``chunked_topk_scores`` over the concatenated catalog, tie order
included; plain version :func:`topk_merge_ring_plain`.

Both run one kernel, ``csrc/topk.cuh``'s scan, whose grid is (user tile,
set): each shard's items are cut into P contiguous parts of whole item
tiles (:func:`part_bounds`), a block per (user tile, shard, part), and
the sets merge in order, lane j of a warp holding sets j, j + 32, ...,
so K8 takes up to :data:`MAX_SETS` shards (CUDA's grid limit in y).
:func:`topk_parts` picks P from the shapes and
the card's multiprocessor count; :func:`topk_parts_plain` is K5's
function computed that way in plain PyTorch.

K8 across the processes of a group on one card splits the launch in
two, and the candidate sets, not the catalog, move between them:
:func:`topk_sets` (scan-to-sets) writes every set of this process's
shards for every query row, and :func:`topk_merge_sets`
(merge-from-sets) merges this process's rows over every process's sets
in shard and part order, on the card through buffers the processes map
from each other (``parallel/peer.py``), on the CPU through the gathered
sets (plain versions :func:`topk_sets_plain`,
:func:`topk_merge_sets_plain`).  The rows are the one-process K8's
bit for bit.

A CUDA tensor goes to a kernel (or raises); only a CPU tensor takes a
plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_als_torch import _build
from tpu_als_torch.ops.topk import NEG_INF, chunked_topk_scores, merge_topk

MAX_K = 128
# the lanes of the scan's merging warp: topk_parts keeps S·P within it
# where S allows (one set, a part of a shard, to a lane), and above it each
# shard is one set and a lane merges several
MERGE_LANES = 32
# the most sets a call takes: one block row of the grid a set, and CUDA's
# grid limit in y (csrc/topk.cuh::kMaxSetsY)
MAX_SETS = 65_535
# csrc/topk.cuh's tile: user rows per block (kTU; the scratch holds one
# candidate set per tile of this many users and set) and items per tile
# (kTI; a part is whole tiles)
TILE_U = 64
TILE_I = 128

# [(payload bytes, grid)] while parallel/comm_audit.py::remote_dma_bytes
# audits a function: each K8 call adds the candidate set one hop of the
# reference's merge ring carries and its grid (user tiles, shards), on
# either device; None otherwise
REMOTE = None
# the reference's merge ring: user rows a tile (at most) and the lanes of
# a packed candidate set (perf/roofline.py::serve_merge_remote_bytes)
RING_TILE_U, RING_LANES = 256, 128

# kernel launches in this process; a run reads them to show that its path
# went through the kernels
LAUNCHES = 0        # K5
MERGE_LAUNCHES = 0  # K8
SETS_LAUNCHES = 0        # K8 across processes: scan-to-sets
MERGE_SETS_LAUNCHES = 0  # K8 across processes: merge-from-sets
# calls of topk_scores on the card that the scan route served (k > MAX_K)
SCAN_CALLS = 0


def _check(U, V, item_valid, k):
    if U.dtype != torch.float32 or V.dtype != torch.float32:
        raise TypeError(f"top-k takes float32 factors, got {U.dtype}, "
                        f"{V.dtype}")
    if item_valid.dtype != torch.bool:
        raise TypeError(f"item_valid must be bool, got {item_valid.dtype}")
    if U.dim() != 2 or V.dim() != 2 or U.shape[1] != V.shape[1] \
            or item_valid.shape != (V.shape[0],):
        raise ValueError(f"top-k takes U [n, r], V [Ni, r], item_valid "
                         f"[Ni]; got {tuple(U.shape)}, {tuple(V.shape)}, "
                         f"{tuple(item_valid.shape)}")
    if not (U.device == V.device == item_valid.device):
        raise ValueError("U, V and item_valid must share a device")
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")


def topk_route(k):
    """The route :func:`topk_scores` takes on the card for ``k``:
    ``'empty'`` (k = 0), ``'kernel'`` (K5, k <= MAX_K) or ``'scan'``
    (``chunked_topk_scores``, as the reference's dispatch)."""
    if k == 0:
        return "empty"
    return "kernel" if k <= MAX_K else "scan"


def topk_parts(n, ni_loc, S, sms):
    """P, the parts each of S shards of ``ni_loc`` items is cut into for
    ``n`` query rows on a card of ``sms`` multiprocessors: as many as keep
    the (user tile, shard, part) blocks at most two a multiprocessor — 1
    when the user tiles alone come to that — at most MERGE_LANES // S (one
    merge lane per set; 1 above MERGE_LANES shards) and at most one part
    per item tile."""
    blocks = -(-n // TILE_U) * S
    if blocks == 0:
        return 1
    return max(1, min(2 * sms // blocks, MERGE_LANES // S,
                      -(-ni_loc // TILE_I)))


def part_bounds(ni_loc, P):
    """The item ranges [lo, hi) of the P parts of a shard of ``ni_loc``
    items, as the kernel cuts it: part p takes the item tiles
    [T·p // P, T·(p+1) // P) of the T = ceil(ni_loc / TILE_I)."""
    T = -(-ni_loc // TILE_I)
    return [(T * p // P * TILE_I, min(ni_loc, T * (p + 1) // P * TILE_I))
            for p in range(P)]


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _parts(parts, n, ni_loc, S, device):
    if parts is None:
        return topk_parts(n, ni_loc, S, _sms(device))
    top = max(1, MERGE_LANES // S)
    if not 1 <= parts <= top:
        raise ValueError(f"parts must be in [1, {top}] for {S} "
                         f"shard(s), got {parts}")
    return parts


def _launch(name, U, V, valid, n, ni_loc, S, P, k):
    """Scores and ids [n, k] of the scan over S shards of ``ni_loc``
    items cut in P parts (``csrc/topk.cuh``), launched through the C entry
    point of ``csrc/<name>.cu``."""
    r = U.shape[1]
    dev = U.device
    scores = torch.empty((n, k), dtype=torch.float32, device=dev)
    ids = torch.empty((n, k), dtype=torch.int64, device=dev)
    tiles = -(-n // TILE_U)
    if S * P > 1:
        coll_s = torch.empty(tiles * S * P * TILE_U * k, dtype=torch.float32,
                             device=dev)
        coll_i = torch.empty(tiles * S * P * TILE_U * k, dtype=torch.int64,
                             device=dev)
        tickets = torch.zeros(tiles, dtype=torch.int32, device=dev)
        scratch = (coll_s.data_ptr(), coll_i.data_ptr(), tickets.data_ptr())
    else:
        scratch = (None, None, None)
    fn = _build.load(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if name == "topk":
            err = fn(U.data_ptr(), V.data_ptr(), valid.data_ptr(), *scratch,
                     scores.data_ptr(), ids.data_ptr(), n, ni_loc, r, k, P,
                     stream)
        else:
            err = fn(U.data_ptr(), V.data_ptr(), valid.data_ptr(), *scratch,
                     scores.data_ptr(), ids.data_ptr(), n, ni_loc, S, r, k,
                     P, stream)
    _build.check(err, f"{name}_f32")
    return scores, ids


def topk_scores(U, V, item_valid, k, item_chunk=8192, parts=None):
    """Top-k per row of U: on CUDA tensors the route :func:`topk_route`
    names (K5, its catalog cut in ``parts`` parts, by default
    :func:`topk_parts`'s; or the scan for k > MAX_K), for CPU tensors the
    plain chunked version (``item_chunk`` items per step), or with
    ``parts`` :func:`topk_parts_plain`; k = 0 gives empty [n, 0] results
    and calls nothing."""
    global LAUNCHES, SCAN_CALLS
    _check(U, V, item_valid, k)
    n, r = U.shape
    route = topk_route(k)
    if route == "empty":
        return (torch.empty((n, 0), dtype=torch.float32, device=U.device),
                torch.empty((n, 0), dtype=torch.int64, device=U.device))
    if U.device.type == "cpu":
        if parts is not None:
            return topk_parts_plain(U, V, item_valid, k, parts)
        return chunked_topk_scores(U, V, item_valid, k,
                                   item_chunk=item_chunk)
    if U.device.type != "cuda":
        raise ValueError(f"top-k runs on cuda or cpu, not {U.device}")
    if route == "scan":
        SCAN_CALLS += 1
        return chunked_topk_scores(U, V, item_valid, k,
                                   item_chunk=item_chunk)
    if not (U.is_contiguous() and V.is_contiguous()
            and item_valid.is_contiguous()):
        raise ValueError("top-k takes contiguous U, V and item_valid")
    if n == 0 or V.shape[0] == 0:
        return (torch.full((n, k), NEG_INF, dtype=torch.float32,
                           device=U.device),
                torch.zeros((n, k), dtype=torch.int64, device=U.device))
    P = _parts(parts, n, V.shape[0], 1, U.device)
    out = _launch("topk", U, V, item_valid, n, V.shape[0], 1, P, k)
    LAUNCHES += 1
    return out


def topk_merge_ring_plain(U, V_shards, valid_shards, k, parts=1):
    """K8's function in plain PyTorch, its catalog cut as the kernel cuts
    it: the stable chunked top-k of every part of every shard (ids
    globalized, s·ni_loc + local), folded into the running set in shard
    and part order by the stable merge, the carried set first.  Any
    ``parts`` gives the same result."""
    S, ni_loc = V_shards.shape[:2]
    n = U.shape[0]
    best_s = torch.full((n, k), NEG_INF, dtype=torch.float32,
                        device=U.device)
    best_i = torch.zeros((n, k), dtype=torch.int64, device=U.device)
    for s in range(S):
        for lo, hi in part_bounds(ni_loc, parts):
            cs, ci = chunked_topk_scores(U, V_shards[s, lo:hi],
                                         valid_shards[s, lo:hi], k)
            best_s, best_i = merge_topk(best_s, best_i, cs,
                                        ci + s * ni_loc + lo, k)
    return best_s, best_i


def topk_parts_plain(U, V, item_valid, k, P):
    """K5's function computed as the kernel splits it: P contiguous parts
    of the catalog (:func:`part_bounds`), each part's stable top-k,
    merged in part order — the stable order, so bitwise
    ``chunked_topk_scores`` wherever the two compute the same scores."""
    return topk_merge_ring_plain(U, V[None], item_valid[None], k, P)


def topk_merge_ring(U, V_shards, valid_shards, k, parts=None):
    """Top-k over a catalog in S shards: U [n, r] f32, V_shards
    [S, ni_loc, r] f32, valid_shards [S, ni_loc] bool, 1 <= k <= 128 ->
    (scores [n, k] f32, ids [n, k] int64, global id s·ni_loc + local).
    Kernel K8 for CUDA tensors, each shard cut in ``parts`` parts (by
    default :func:`topk_parts`'s); :func:`topk_merge_ring_plain` for CPU
    tensors."""
    global MERGE_LAUNCHES
    if V_shards.dim() != 3 or valid_shards.shape != V_shards.shape[:2]:
        raise ValueError(f"topk_merge_ring takes V_shards [S, ni_loc, r] and "
                         f"valid_shards [S, ni_loc]; got "
                         f"{tuple(V_shards.shape)}, "
                         f"{tuple(valid_shards.shape)}")
    S, ni_loc, r = V_shards.shape
    _check(U, V_shards.reshape(S * ni_loc, r), valid_shards.reshape(-1), k)
    if k > MAX_K:
        raise ValueError(f"topk_merge_ring takes k <= {MAX_K}, got {k}: the "
                         "merged candidate sets hold at most that many, as "
                         "the TPU kernel's do")
    if REMOTE is not None:
        # one packed [tile_u, 2·lanes] f32 set a hop, one pass a user tile
        tile_u = min(RING_TILE_U, -(-U.shape[0] // 8) * 8)
        REMOTE.append((tile_u * 2 * RING_LANES * 4,
                       (-(-U.shape[0] // max(1, tile_u)), S)))
    if U.device.type == "cpu":
        return topk_merge_ring_plain(U, V_shards, valid_shards, k,
                                     1 if parts is None else parts)
    if U.device.type != "cuda":
        raise ValueError(f"top-k runs on cuda or cpu, not {U.device}")
    if S > MAX_SETS:
        raise ValueError(
            f"{S} shards > {MAX_SETS}: K8 launches one block row per "
            "shard, and CUDA's grid takes at most that many")
    if not (U.is_contiguous() and V_shards.is_contiguous()
            and valid_shards.is_contiguous()):
        raise ValueError("topk_merge_ring takes contiguous tensors")
    n = U.shape[0]
    if n == 0 or ni_loc == 0:
        return (torch.full((n, k), NEG_INF, dtype=torch.float32,
                           device=U.device),
                torch.zeros((n, k), dtype=torch.int64, device=U.device))
    P = _parts(parts, n, ni_loc, S, U.device)
    out = _launch("topk_merge_ring", U, V_shards, valid_shards, n, ni_loc,
                  S, P, k)
    MERGE_LAUNCHES += 1
    return out


class MappedSets(NamedTuple):
    """Every process's candidate sets as :func:`topk_merge_sets` reaches
    them across processes on one card (``parallel/peer.py``): ``bases_s``
    and ``bases_i``, CUDA int64 tensors of one device address a process
    (its own buffer's and its peers' mapped ones, in process order), each
    buffer holding ``spb`` sets of every user tile, scores
    ``[tiles, spb, TILE_U, k]`` f32 and ids int64 alike."""

    bases_s: torch.Tensor
    bases_i: torch.Tensor
    spb: int


def _sets_check(U, V_shards, valid_shards, k, coll_s, coll_i, parts):
    if V_shards.dim() != 3 or valid_shards.shape != V_shards.shape[:2]:
        raise ValueError(f"topk_sets takes V_shards [L, ni_loc, r] and "
                         f"valid_shards [L, ni_loc]; got "
                         f"{tuple(V_shards.shape)}, "
                         f"{tuple(valid_shards.shape)}")
    L, ni_loc, r = V_shards.shape
    _check(U, V_shards.reshape(L * ni_loc, r), valid_shards.reshape(-1), k)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"topk_sets takes 1 <= k <= {MAX_K}, got {k}")
    want = (-(-U.shape[0] // TILE_U), L * parts, TILE_U, k)
    if tuple(coll_s.shape) != want or tuple(coll_i.shape) != want \
            or coll_s.dtype != torch.float32 or coll_i.dtype != torch.int64:
        raise ValueError(f"topk_sets writes f32 scores and int64 ids "
                         f"{want}; got {tuple(coll_s.shape)} {coll_s.dtype},"
                         f" {tuple(coll_i.shape)} {coll_i.dtype}")


def topk_sets_plain(U, V_shards, valid_shards, k, parts, first, coll_s,
                    coll_i):
    """Scan-to-sets in plain PyTorch: each local shard's parts' stable
    chunked top-k (ids globalized, (first + s)·ni_loc + local, as
    :func:`topk_merge_ring_plain` globalizes them), written to ``coll_s``
    / ``coll_i`` ``[tiles, L·parts, TILE_U, k]`` (rows past n hold
    (NEG_INF, 0))."""
    L, ni_loc = V_shards.shape[:2]
    n = U.shape[0]
    pad = coll_s.shape[0] * TILE_U - n
    for s in range(L):
        for j, (lo, hi) in enumerate(part_bounds(ni_loc, parts)):
            cs, ci = chunked_topk_scores(U, V_shards[s, lo:hi],
                                         valid_shards[s, lo:hi], k)
            ci = ci + (first + s) * ni_loc + lo
            cs = torch.cat([cs, cs.new_full((pad, k), NEG_INF)])
            ci = torch.cat([ci, ci.new_zeros((pad, k))])
            coll_s[:, s * parts + j] = cs.reshape(-1, TILE_U, k)
            coll_i[:, s * parts + j] = ci.reshape(-1, TILE_U, k)


def topk_sets(U, V_shards, valid_shards, k, *, parts, first, coll_s, coll_i,
              n_shards):
    """K8's scan-to-sets across processes: every query row of ``U`` [n, r]
    against this process's L shards ``V_shards`` [L, ni_loc, r]
    (``valid_shards`` [L, ni_loc]), each cut in ``parts`` parts, every
    (user tile, shard, part)'s stable set written to ``coll_s`` (f32)
    and ``coll_i`` (int64) ``[ceil(n / TILE_U), L·parts, TILE_U, k]``
    (on the card: this process's exported buffer), ids globalized from
    the mesh position ``first`` of its first shard.  The kernel for
    CUDA tensors (``SETS_LAUNCHES``), :func:`topk_sets_plain` for CPU
    tensors.  ``n_shards``: the mesh's S, for the reference's declared
    payload (one packed set a hop, ``comm_audit.remote_dma_bytes``)."""
    global SETS_LAUNCHES
    _sets_check(U, V_shards, valid_shards, k, coll_s, coll_i, parts)
    L, ni_loc, r = V_shards.shape
    n = U.shape[0]
    if REMOTE is not None:
        tile_u = min(RING_TILE_U, -(-n // 8) * 8)
        REMOTE.append((tile_u * 2 * RING_LANES * 4,
                       (-(-n // max(1, tile_u)), int(n_shards))))
    if U.device.type == "cpu":
        return topk_sets_plain(U, V_shards, valid_shards, k, parts, first,
                               coll_s, coll_i)
    if U.device.type != "cuda":
        raise ValueError(f"top-k runs on cuda or cpu, not {U.device}")
    if not (U.is_contiguous() and V_shards.is_contiguous()
            and valid_shards.is_contiguous() and coll_s.is_contiguous()
            and coll_i.is_contiguous()):
        raise ValueError("topk_sets takes contiguous tensors")
    if n == 0:
        return
    fn = _build.load("topk_sets")
    with torch.cuda.device(U.device):
        err = fn(U.data_ptr(), V_shards.data_ptr(), valid_shards.data_ptr(),
                 coll_s.data_ptr(), coll_i.data_ptr(), n, ni_loc, L, r, k,
                 parts, int(first) * ni_loc,
                 torch.cuda.current_stream(U.device).cuda_stream)
    _build.check(err, "topk_sets_f32")
    SETS_LAUNCHES += 1


def topk_merge_sets_plain(sets_s, sets_i, k, q0, nq):
    """Merge-from-sets in plain PyTorch: ``sets_s`` / ``sets_i``
    ``[tiles, S·P, TILE_U, k]`` (every process's sets, in shard and part
    order), the rows ``q0 .. q0 + nq`` folded set after set by the
    stable merge, the carried set first, as
    :func:`topk_merge_ring_plain` folds them."""
    SP = sets_s.shape[1]
    flat_s = sets_s.permute(1, 0, 2, 3).reshape(SP, -1, k)[:, q0:q0 + nq]
    flat_i = sets_i.permute(1, 0, 2, 3).reshape(SP, -1, k)[:, q0:q0 + nq]
    best_s = torch.full((nq, k), NEG_INF, dtype=torch.float32,
                        device=sets_s.device)
    best_i = torch.zeros((nq, k), dtype=torch.int64, device=sets_s.device)
    for g in range(SP):
        best_s, best_i = merge_topk(best_s, best_i, flat_s[g], flat_i[g], k)
    return best_s, best_i


def topk_merge_sets(sets, k, q0, nq):
    """K8's merge-from-sets across processes: the top-k of query rows
    ``q0 .. q0 + nq`` over every process's candidate sets, in shard and
    part order.  ``sets``: a :class:`MappedSets` on the card (the
    kernel, ``MERGE_SETS_LAUNCHES``), or the gathered ``(sets_s,
    sets_i)`` ``[tiles, S·P, TILE_U, k]`` on the CPU
    (:func:`topk_merge_sets_plain`).  Returns (scores [nq, k] f32, ids
    [nq, k] int64)."""
    global MERGE_SETS_LAUNCHES
    if not 1 <= k <= MAX_K:
        raise ValueError(f"topk_merge_sets takes 1 <= k <= {MAX_K}, got {k}")
    if not isinstance(sets, MappedSets):
        sets_s, sets_i = sets
        if sets_s.device.type != "cpu":
            raise ValueError("topk_merge_sets takes MappedSets on the card")
        return topk_merge_sets_plain(sets_s, sets_i, k, q0, nq)
    dev = sets.bases_s.device
    if dev.type != "cuda" or sets.bases_s.dtype != torch.int64 \
            or sets.bases_i.shape != sets.bases_s.shape:
        raise ValueError("topk_merge_sets: mapped sets are int64 arrays of "
                         "device addresses on the card, one a process")
    nbase = sets.bases_s.shape[0]
    if nbase * sets.spb > MAX_SETS:
        raise ValueError(f"{nbase * sets.spb} sets > {MAX_SETS}")
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int64, device=dev)
    if nq == 0:
        return out_s, out_i
    fn = _build.load("topk_merge_sets")
    with torch.cuda.device(dev):
        err = fn(sets.bases_s.data_ptr(), sets.bases_i.data_ptr(), nbase,
                 sets.spb, q0, nq, k, out_s.data_ptr(), out_i.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "topk_merge_sets_f32")
    MERGE_SETS_LAUNCHES += 1
    return out_s, out_i
