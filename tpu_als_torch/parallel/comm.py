"""The ring strategy: factor shards stream past stationary accumulators.

Counterpart of ``tpu_als/parallel/comm.py``.  The ratings are blocked on
a 2-D (owner shard × source shard) grid, :class:`RingCsr`, with column
ids local to the source shard and ONE row position per entity shared by
all S sources (rows bucketed by their max-per-source degree), so a row
accumulates its normal equations across the whole ring pass before it
is solved.  The grid is built on the host with numpy, array-equal to the
reference's :func:`shard_csr_grid`.

Two half-steps over it, each for every owner at once:

- :func:`ring_half_step`, the unfused ring: per row tile, torch normal
  equations over the shard held at each of the S rotations — owner d
  holds shard (d - t) mod S after t of them — then ``solve_spd`` (kernel
  K2 up to rank 128, K6 above).  On one device the rotation is index
  arithmetic on the stacked table's shard axis, not a copy.
- :func:`ring_fused_half_step` (``solve_backend='gather_fused_ring'``):
  one launch of kernel K7 per bucket, whose blocks walk the S sources
  themselves (the long rows' streams split over blocks by width).

And ``'all_gather_chunked'``: :func:`chunked_gather_half_step` over the
stacked CSR shards of ``'all_gather'``, the opposite table taken in the
column blocks of :func:`gather_block_plan` (on one device a block is a
slice of every shard's rows, not a gather), the normal equations summed
block by block in the reference's order, then ``solve_spd`` (K2 up to
rank 128, K6 above).

Across processes (:mod:`.multihost`): ``shard_csr_grid(positions=)``
allocates and fills only one process's owner rows of the grid (the
layout is still derived from every rating, so every process agrees), and
:func:`ring_process_half_step` runs the unfused ring with the opposite
shards rotating between processes by send/recv (the reference's
``ppermute``), while :func:`ring_process_fused_half_step` runs K7 on
this process's owners over all S sources, the peers' shards reached on
the card through buffers mapped from them (:class:`ProcessSources`,
``parallel/peer.py``) and on the CPU gathered.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpu_als_torch.core import als as core_als
from tpu_als_torch.core.ratings import (
    Bucket,
    buckets_to,
    entity_widths,
    scan_chunk,
    trainer_chunk,
)
from tpu_als_torch.ops import cuda_gather_ne as gne
from tpu_als_torch.ops.solve import gram_terms, solve_cg, solve_nnls, \
    solve_spd
from tpu_als_torch.parallel import multihost


@dataclass
class RingCsr:
    """The (owner × source) grid of one side: rows [D, nb] (the entity of
    each row, shared by the sources), cols/vals/mask [D, S, nb, w] with
    shard-local column ids."""

    buckets: list  # list[Bucket]
    rows_per_shard: int
    chunk_elems: int
    nnz: int
    # None: the full grid; a tuple: one process's owner positions
    positions: tuple = None

    @property
    def padded_nnz(self):
        return sum(b.mask.size for b in self.buckets)

    def to(self, device):
        """The grid's buckets as tensors on ``device``."""
        return buckets_to(self.buckets, device)


def shard_csr_grid(row_part, col_part, row_idx, col_idx, vals, min_width=8,
                   chunk_elems=1 << 19, positions=None):
    """Build the grid with a row space shared by the source shards: every
    source stores entity u's ratings at the same (bucket, row) position,
    and entities are bucketed by their max-per-source degree (each
    source's slice of a row pads to that width).

    ``positions``: allocate and fill ONLY these owner positions' rows
    (one process of a multi-process mesh; the layout is still computed
    from every rating, so every process agrees on the shapes).  The
    result equals the full grid's slice at ``positions``."""
    D = row_part.n_shards
    S = col_part.n_shards
    row_idx = np.asarray(row_idx)
    col_idx = np.asarray(col_idx)
    vals = np.asarray(vals, dtype=np.float32)
    owner = row_part.owner[row_idx].astype(np.int64)
    local_rows = row_part.local[row_idx].astype(np.int64)
    src = col_part.owner[col_idx].astype(np.int64)
    local_cols = col_part.local[col_idx].astype(np.int64)
    num_rows = row_part.rows_per_shard
    n = len(row_idx)

    # per-entry offset within its (owner, row, source) group
    key = (owner * num_rows + local_rows) * S + src
    order = np.argsort(key, kind="stable")
    uniq_k, starts, kcounts = np.unique(
        key[order], return_index=True, return_counts=True)
    off = np.arange(n) - starts[np.repeat(np.arange(len(uniq_k)), kcounts)]

    # bucket width per (owner, entity): the max degree over the sources
    k_du = uniq_k // S
    maxdeg = np.zeros(D * num_rows, dtype=np.int64)
    np.maximum.at(maxdeg, k_du, kcounts)
    rated = np.zeros(D * num_rows, dtype=bool)
    rated[k_du] = True
    widths_all = entity_widths(maxdeg, min_width)

    bucket_widths = sorted(set(widths_all[rated].tolist()))
    local_pos = np.full(D * num_rows, -1, dtype=np.int64)
    nb_pads = []
    selections = {}  # (w, d) -> row indices, reused by the fill below
    for w in bucket_widths:
        nb_need = 0
        for d in range(D):
            lo = d * num_rows
            sel = np.flatnonzero(rated[lo:lo + num_rows]
                                 & (widths_all[lo:lo + num_rows] == w))
            selections[w, d] = sel
            local_pos[lo + sel] = np.arange(len(sel))
            nb_need = max(nb_need, len(sel))
        chunk = scan_chunk(nb_need, w, chunk_elems)
        nb_pads.append(-(-nb_need // chunk) * chunk)

    e_owner = owner[order]
    flat = e_owner * num_rows + local_rows[order]
    e_src = src[order]
    e_cols = local_cols[order]
    e_vals = vals[order]
    e_w = widths_all[flat]
    e_pos = local_pos[flat]

    local = positions is not None
    pos_list = list(positions) if local else list(range(D))
    L = len(pos_list)
    # owner position -> leading-axis index (-1: another process's owner)
    owner_to_li = np.full(D, -1, dtype=np.int64)
    owner_to_li[pos_list] = np.arange(L)
    buckets = []
    for w, nb in zip(bucket_widths, nb_pads):
        rows = np.full((L, nb), num_rows, dtype=np.int32)
        for li, d in enumerate(pos_list):
            sel = selections[w, d]
            rows[li, :len(sel)] = sel
        cols = np.zeros((L, S, nb, w), dtype=np.int32)
        v = np.zeros((L, S, nb, w), dtype=np.float32)
        m = np.zeros((L, S, nb, w), dtype=np.float32)
        esel = (e_w == w) & (owner_to_li[e_owner] >= 0)
        at = (owner_to_li[e_owner[esel]], e_src[esel], e_pos[esel],
              off[esel])
        cols[at] = e_cols[esel]
        v[at] = e_vals[esel]
        m[at] = 1.0
        buckets.append(Bucket(rows=rows, cols=cols, vals=v, mask=m))
    return RingCsr(buckets=buckets, rows_per_shard=num_rows,
                   chunk_elems=chunk_elems, nnz=n,
                   positions=tuple(pos_list) if local else None)


def _scatter(out, b, x):
    """out [D, num_rows + 1, r] <- x [D, nb, r] at each owner's rows (the
    padding rows, ``rows == num_rows``, land in the spare row)."""
    owners = torch.arange(out.shape[0], device=out.device)[:, None]
    out[owners, b.rows] = x


def ring_fused_half_step(V_stacked, ring_buckets, num_rows, n_shards, cfg,
                         YtY=None, split_width=None):
    """One half-step of every owner through kernel K7, one launch per
    bucket; a bucket whose rows' ring streams (S·w entries) are longer
    than ``split_width`` (None: ``core.als.SPLIT_WIDTH``; the fit's tuned
    one, :func:`~tpu_als_torch.parallel.trainer.train_sharded`) is split
    over blocks in chunks of that many entries, as the single-device
    trainer splits K3's wide rows.
    ``V_stacked`` [S·per, r]: the opposite factors in slot space;
    ``ring_buckets``: the grid as tensors (:meth:`RingCsr.to`).  Returns
    the solved side [D·num_rows, r] f32.  The count and the ridge come from
    the kernel's own ``cw`` sums, as in the reference."""
    r = V_stacked.shape[-1]
    cdt = getattr(torch, cfg.compute_dtype)
    V_sh = V_stacked.to(cdt).reshape(n_shards, -1, r).contiguous()
    return _fused_rows(V_sh, ring_buckets, num_rows, cfg, YtY, split_width,
                       V_stacked.device)


def _fused_rows(V_sh, ring_buckets, num_rows, cfg, YtY, split_width, dev):
    """K7 over every bucket of the grid, each launch's rows scattered into
    the owners' tables: ``V_sh`` the S source shards (a stacked ``[S,
    per, r]`` tensor, or ``MappedShards`` across processes)."""
    split = core_als._split(split_width)
    r = V_sh.shape[-1]
    cdt = getattr(torch, cfg.compute_dtype)
    D = ring_buckets[0].rows.shape[0] if ring_buckets else V_sh.shape[0]
    out = torch.zeros(D, num_rows + 1, r, dtype=torch.float32, device=dev)
    for b in ring_buckets:
        vals, mask = b.vals.to(cdt), b.mask.to(cdt)
        if cfg.implicit_prefs:
            x = gne.gather_fused_ring_implicit(
                V_sh, b.cols, vals, mask, cfg.reg_param, cfg.alpha, YtY,
                jitter=cfg.jitter, split_width=split)
        else:
            x = gne.gather_fused_ring_explicit(
                V_sh, b.cols, vals, mask, cfg.reg_param, jitter=cfg.jitter,
                split_width=split)
        _scatter(out, b, x)
    return out[:, :num_rows].reshape(D * num_rows, r)


def roll_sources(ring_buckets, first):
    """This process's owner rows of the grid (``positions=`` build, [L, S,
    nb, w] tensors) with the source axis rolled by ``first``, its first
    mesh position: source s of the result is position (first + s) mod S.
    K7 walks owner j's sources (j - t) mod S of what it is given, so on
    the rolled grid and shards local owner j walks the global order
    (first + j - t) mod S of the one-process ring.  Rolled once, when
    the step is built."""
    if not first:
        return ring_buckets
    return [Bucket(rows=b.rows, cols=torch.roll(b.cols, -first, 1),
                   vals=torch.roll(b.vals, -first, 1),
                   mask=torch.roll(b.mask, -first, 1)) for b in ring_buckets]


class ProcessSources:
    """The opposite table's S shards as this process's K7 reads them
    across processes (a mesh of P processes × L shards), in the order of
    the rolled grid (:func:`roll_sources`).

    On the card: one :class:`~tpu_als_torch.parallel.peer.PeerBuffer`
    holding this process's L shards in the compute dtype, allocated and
    mapped by every peer once, when the step is built, and the S base
    pointers (this process's own, its peers' mapped ones) as
    ``MappedShards``.  On the CPU: K7's plain version over the shards
    gathered by ``multihost.all_gather``.  :meth:`close` is collective
    (``PeerBuffer.close``)."""

    def __init__(self, mesh, per, r, dtype):
        from tpu_als_torch.parallel import peer

        self.first, self.S, self.L = (mesh.positions[0], mesh.global_size,
                                      mesh.size)
        self.per, self.r, self.dtype = int(per), int(r), dtype
        self.buf = None
        if mesh.device.type == "cuda":
            db = torch.empty((), dtype=dtype).element_size()
            self.buf = peer.PeerBuffer(self.L * self.per * self.r * db,
                                       mesh.device)
            stride = self.per * self.r * db
            ptrs = [self.buf.ptrs[s // self.L] + (s % self.L) * stride
                    for s in range(self.S)]
            rolled = [ptrs[(s + self.first) % self.S] for s in range(self.S)]
            self.mapped = gne.MappedShards(
                torch.tensor(rolled, dtype=torch.int64, device=mesh.device),
                self.per, self.r, dtype)
            self.local = self.buf.local((self.L, self.per, self.r), dtype)

    def publish(self, Y_local):
        """This process's rows ``Y_local`` [L·per, r] in; the S shards K7
        reads out, once every process's rows are in.  On the card: the
        rows copied into this process's buffer, then its stream synced
        and every process met at a barrier (the peers' rows are then
        written, and their reads of the last half-step that read this
        table are done)."""
        Y = Y_local.to(self.dtype).reshape(self.L, self.per, self.r)
        if self.buf is None:
            return torch.roll(multihost.all_gather(Y), -self.first, 0)
        from tpu_als_torch.parallel import peer

        self.local.copy_(Y)
        peer.publish()
        return self.mapped

    def close(self):
        if self.buf is not None:
            self.buf.close()


def ring_process_fused_half_step(Y_local, sources, ring_buckets, num_rows,
                                 cfg, YtY=None, split_width=None):
    """One half-step of this process's L owners through K7 over all S
    sources across processes: ``Y_local`` [L·per, r] this process's rows
    of the opposite table, ``sources`` its :class:`ProcessSources`,
    ``ring_buckets`` its owner rows of the grid rolled by
    :func:`roll_sources`.  On the card K7 reads the peers' shards
    through their mapped base pointers; on the CPU its plain version
    reads the gathered ones.  Each owner's rows are the one-process
    ring's bit for bit (the same entries in the same order, the same
    tail).  Returns [L·num_rows, r] f32."""
    return _fused_rows(sources.publish(Y_local), ring_buckets, num_rows, cfg,
                       YtY, split_width, Y_local.device)


def ring_half_step(V_stacked, ring_buckets, counts, num_rows, n_shards, cfg,
                   chunk_elems, YtY=None, prev=None, fused=False,
                   split_width=None):
    """One half-step of every owner with the factor shards streaming.

    ``V_stacked`` [S·per, r]: the opposite factors in slot space;
    ``ring_buckets``: the grid as tensors; ``counts`` [D, num_rows]: each
    row's rating count (implicit: positive ones) for the λ·n ridge;
    ``prev`` [D·num_rows, r]: the solved side's current factors, the CG
    warm start.  Per owner, bucket and row tile (``trainer_chunk``), the
    normal equations sum the held shard's terms over the S rotations, then
    the tile is solved: NNLS when nonnegative, warm-started CG when
    ``cg_iters > 0``, else ``solve_spd``.  ``fused=True`` is
    :func:`ring_fused_half_step` (not with nonnegative: NNLS has no fused
    kernel; ``split_width`` as there).  Returns [D·num_rows, r] f32."""
    if fused and not cfg.nonnegative:
        return ring_fused_half_step(V_stacked, ring_buckets, num_rows,
                                    n_shards, cfg, YtY=YtY,
                                    split_width=split_width)
    r = V_stacked.shape[-1]
    dev = V_stacked.device
    cdt = getattr(torch, cfg.compute_dtype)
    V_sh = V_stacked.to(cdt).reshape(n_shards, -1, r)
    D = counts.shape[0]
    eye = torch.eye(r, dtype=torch.float32, device=dev)
    out = torch.zeros(D, num_rows + 1, r, dtype=torch.float32, device=dev)
    for b in ring_buckets:
        _, S, nb, w = b.cols.shape
        tile = trainer_chunk(nb, w, r, chunk_elems)
        vals, mask = b.vals.to(cdt), b.mask.to(cdt)
        for d in range(D):
            for s0 in range(0, nb, tile):
                sl = slice(s0, s0 + tile)
                rows = b.rows[d, sl]
                A = torch.zeros(rows.shape[0], r, r, dtype=torch.float32,
                                device=dev)
                bb = torch.zeros(rows.shape[0], r, dtype=torch.float32,
                                 device=dev)
                for t in range(S):
                    src = (d - t) % S  # the shard held after t rotations
                    Vg = V_sh[src][b.cols[d, src, sl].long()]
                    Sg, bg, _ = gram_terms(Vg, vals[d, src, sl],
                                           mask[d, src, sl],
                                           implicit=cfg.implicit_prefs,
                                           alpha=cfg.alpha)
                    A = A + Sg
                    bb = bb + bg
                out[d, rows] = _ring_tile_solve(A, bb, rows, counts[d],
                                                num_rows, cfg, YtY, eye,
                                                _prev_rows(prev, d, num_rows))
    return out[:, :num_rows].reshape(D * num_rows, r)


def _prev_rows(prev, d, num_rows):
    return None if prev is None else prev[d * num_rows:(d + 1) * num_rows]


def _ring_tile_solve(A, bb, rows, counts, num_rows, cfg, YtY, eye, prev):
    """The ring's tail on one owner's row tile: the λ·n ridge from the
    rows' ``counts``, YᵀY when implicit, then NNLS when nonnegative,
    warm-started CG (from ``prev``, the owner's current rows) when
    ``cg_iters > 0``, else ``solve_spd``."""
    # padding rows read a real row's count; their b is 0, so they solve
    # to 0, and the scatter drops them
    at = torch.clamp(rows, max=num_rows - 1)
    cnt = counts[at]
    A = A + (cfg.reg_param * cnt)[:, None, None] * eye
    if cfg.implicit_prefs:
        A = A + YtY[None]
    if cfg.nonnegative:
        return solve_nnls(A, bb, cnt, sweeps=cfg.nnls_sweeps,
                          jitter=cfg.jitter)
    if cfg.cg_iters > 0 and cfg.solve_backend not in (
            "gather_fused_solve", "gather_fused_ring"):
        x0 = None if prev is None else prev[at]
        return solve_cg(A, bb, cnt, x0=x0, iters=cfg.cg_iters,
                        jitter=cfg.jitter)
    return solve_spd(A, bb, cnt, jitter=cfg.jitter,
                     adaptive=cfg.adaptive_solve)


def ring_process_half_step(V_local, ring_buckets, counts, num_rows, cfg,
                           chunk_elems, YtY=None, prev=None):
    """One half-step of this process's owners with the opposite shards
    rotating between processes (the unfused ring across a mesh of P
    processes × L shards).

    ``V_local`` [L·per, r]: this process's shards of the opposite
    factors; ``ring_buckets``: its owner rows of the grid as tensors
    (``shard_csr_grid(positions=)``: rows [L, nb], cols [L, S, nb, w]);
    ``counts`` [L, num_rows]; ``prev`` [L·num_rows, r], the CG warm
    start.  Per bucket and row tile, the held block of L opposite shards
    makes P hops (sent to process p + 1, received from p − 1,
    :func:`~tpu_als_torch.parallel.multihost.ppermute`), each owner
    adding the terms of every shard it holds before each; the last hop
    brings the block home, where the next tile starts from it, as the
    reference's ring returns each shard home once a tile (the bytes of
    ``comm_bytes_per_iter('ring')``).  Then the tile is solved as in
    :func:`ring_half_step`.  Every process walks the same buckets and
    tiles (the grid's layout is agreed), so the hops pair up.  The terms
    are summed in the order the shards arrive (this process's block
    first), not the one-process ring's, so the result differs from it by
    rounding.  Returns [L·num_rows, r] f32."""
    P, p = multihost.process_count(), multihost.process_index()
    r = V_local.shape[-1]
    dev = V_local.device
    cdt = getattr(torch, cfg.compute_dtype)
    L = counts.shape[0]
    home = V_local.float().reshape(L, -1, r)
    eye = torch.eye(r, dtype=torch.float32, device=dev)
    out = torch.zeros(L, num_rows + 1, r, dtype=torch.float32, device=dev)
    for b in ring_buckets:
        nb, w = b.cols.shape[-2:]
        tile = trainer_chunk(nb, w, r, chunk_elems)
        vals, mask = b.vals.to(cdt), b.mask.to(cdt)
        for s0 in range(0, nb, tile):
            sl = slice(s0, s0 + tile)
            n = b.rows[0, sl].shape[0]
            A = [torch.zeros(n, r, r, dtype=torch.float32, device=dev)
                 for _ in range(L)]
            bb = [torch.zeros(n, r, dtype=torch.float32, device=dev)
                  for _ in range(L)]
            held = home
            for q in range(P):
                src_proc = (p - q) % P  # whose block is held after q hops
                held_c = held.to(cdt)
                for j in range(L):
                    for li in range(L):
                        src = src_proc * L + li
                        Vg = held_c[li][b.cols[j, src, sl].long()]
                        Sg, bg, _ = gram_terms(Vg, vals[j, src, sl],
                                               mask[j, src, sl],
                                               implicit=cfg.implicit_prefs,
                                               alpha=cfg.alpha)
                        A[j] = A[j] + Sg
                        bb[j] = bb[j] + bg
                # P hops: the block is home again, the next tile's start
                held = multihost.ppermute(held)
            home = held
            for j in range(L):
                rows = b.rows[j, sl]
                out[j, rows] = _ring_tile_solve(
                    A[j], bb[j], rows, counts[j], num_rows, cfg, YtY, eye,
                    _prev_rows(prev, j, num_rows))
    return out[:, :num_rows].reshape(L * num_rows, r)


def gather_block_plan(per, n_blocks):
    """The column blocks of a ``rows_per_shard``-row factor shard:
    ``(sub, starts, widths)``, block c covering local rows ``[starts[c],
    starts[c] + widths[c])`` of every shard; ``sub = ceil(per /
    n_blocks)``, the last block may be ragged, and the blocks always
    partition the shard (``sum(widths) == per``)."""
    per = int(per)
    sub = -(-per // max(1, int(n_blocks)))
    starts = list(range(0, per, sub))
    widths = [min(sub, per - s) for s in starts]
    return sub, starts, widths


def chunked_gather_half_step(V_stacked, buckets, num_rows, n_shards, cfg,
                             chunk_elems, n_blocks=4, YtY=None, prev=None,
                             across_processes=False):
    """One half-step of every owner with the opposite factors taken in
    column blocks (``'all_gather_chunked'``).

    ``V_stacked`` [S·per, r]: the opposite factors in slot space
    (``across_processes``: this process's L shards, ``[L·per, r]``, and
    block c of every shard is gathered between the processes once per
    row tile, :func:`~tpu_als_torch.parallel.multihost.all_gather`, as
    the reference gathers it);
    ``buckets``: the side's stacked CSR shards as tensors (rows [D, nb],
    cols/vals/mask [D, nb, w], cols in the opposite slot space, as
    ``'all_gather'`` takes them); ``prev`` [D·num_rows, r]: the solved
    side's current factors, the CG warm start.  Per owner, bucket and row
    tile (``trainer_chunk``), block c of :func:`gather_block_plan` is
    rows ``starts[c] .. starts[c] + widths[c]`` of every shard, a
    ``[S·widths[c], r]`` table; the entries whose column falls in block c
    add their terms to the tile's normal equations (the others are masked
    out), block after block.  Then the ridge (λ·count, the count summed
    from the masks), YᵀY when implicit, and the solve: NNLS when
    nonnegative, warm-started CG when ``cg_iters > 0``, else
    ``solve_spd``, as in the reference.  Returns [D·num_rows, r] f32."""
    r = V_stacked.shape[-1]
    dev = V_stacked.device
    cdt = getattr(torch, cfg.compute_dtype)
    D = buckets[0].rows.shape[0] if buckets else n_shards
    # the opposite table's shards: all S on one process, the L owners'
    # own across processes
    V_sh = V_stacked.to(cdt).reshape(D if across_processes else n_shards,
                                      -1, r)
    per = V_sh.shape[1]
    sub, starts, widths = gather_block_plan(per, n_blocks)
    C = len(starts)
    blocks = [V_sh[:, starts[c]:starts[c] + widths[c]].reshape(-1, r)
              for c in range(C)]
    # block c of every shard, [S·widths[c], r]: across processes gathered
    # for each row tile, on one process a slice of the stacked table
    block = (lambda c: multihost.all_gather(blocks[c])) \
        if across_processes else blocks.__getitem__
    eye = torch.eye(r, dtype=torch.float32, device=dev)
    out = torch.zeros(D, num_rows + 1, r, dtype=torch.float32, device=dev)
    cg = (cfg.cg_iters > 0
          and cfg.solve_backend not in ("gather_fused_solve",
                                        "gather_fused_ring"))
    for b in buckets:
        _, nb, w = b.cols.shape
        tile = trainer_chunk(nb, w, r, chunk_elems)
        vals, mask = b.vals.to(cdt), b.mask.to(cdt)
        src = torch.div(b.cols, per, rounding_mode="floor")
        loc = b.cols - src * per
        blkid = torch.clamp(torch.div(loc, sub, rounding_mode="floor"),
                            max=C - 1)
        for s0 in range(0, nb, tile):
            sl = slice(s0, s0 + tile)
            n = b.rows[0, sl].shape[0]
            # every owner's normal equations, summed block by block
            acc = [[torch.zeros(n, r, r, dtype=torch.float32, device=dev),
                    torch.zeros(n, r, dtype=torch.float32, device=dev),
                    torch.zeros(n, dtype=torch.float32, device=dev)]
                   for _ in range(D)]
            for c in range(C):
                table = block(c)
                for d in range(D):
                    m_c = mask[d, sl] * (blkid[d, sl] == c).to(cdt)
                    # masked-out entries' indices clipped into the block
                    idx = torch.clamp(src[d, sl] * widths[c]
                                      + (loc[d, sl] - starts[c]),
                                      0, n_shards * widths[c] - 1)
                    Sg, bg, ng = gram_terms(table[idx.long()], vals[d, sl],
                                            m_c, implicit=cfg.implicit_prefs,
                                            alpha=cfg.alpha)
                    a = acc[d]
                    a[0], a[1], a[2] = a[0] + Sg, a[1] + bg, a[2] + ng.float()
            for d in range(D):
                A, bb, cnt = acc[d]
                rows = b.rows[d, sl]
                A = A + (cfg.reg_param * cnt)[:, None, None] * eye
                if cfg.implicit_prefs:
                    A = A + YtY[None]
                if cfg.nonnegative:
                    x = solve_nnls(A, bb, cnt, sweeps=cfg.nnls_sweeps,
                                   jitter=cfg.jitter)
                elif cg:
                    at = torch.clamp(rows, max=num_rows - 1)
                    x0 = (None if prev is None
                          else prev[d * num_rows:(d + 1) * num_rows][at])
                    x = solve_cg(A, bb, cnt, x0=x0, iters=cfg.cg_iters,
                                 jitter=cfg.jitter)
                else:
                    x = solve_spd(A, bb, cnt, jitter=cfg.jitter,
                                  adaptive=cfg.adaptive_solve)
                out[d, rows] = x
    return out[:, :num_rows].reshape(D * num_rows, r)
