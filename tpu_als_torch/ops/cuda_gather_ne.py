"""Kernels K3 (gather + Gram), K4 (gather + Gram + tail + solve) and K7
(K4 over the S shards of a ring).

Counterpart of ``tpu_als/ops/pallas_gather_ne.py``: ``gather_gram`` and
its wrappers ``gather_normal_eq_explicit`` / ``gather_normal_eq_implicit``
(K3, ``csrc/gather_gram.cu``), ``gather_solve`` with its wrappers
``gather_fused_solve_explicit`` / ``gather_fused_solve_implicit`` (K4,
``csrc/gather_solve.cu``), and ``gather_solve_ring`` with its wrappers
``gather_fused_ring_explicit`` / ``gather_fused_ring_implicit`` (K7,
``csrc/gather_solve_ring.cu``).  The factor rows ``V[cols]`` are gathered
inside the kernels and never materialized; the weights, the count and
the ridge/YᵀY tail are the reference builders' exact expressions.

The kernels take the table in float32 or bfloat16 and weights in the
table's type.  All three build the Gram on the tensor cores in the
3xTF32 form: up to rank 256 by ``csrc/gram_sm90.cuh``'s body, above it
by ``csrc/gram_strips.cuh``'s (the same warp tiles, each block staging
only the 32-column strips its tiles read), so K3 takes any rank (up to
:data:`GRAM_MAX_RANK`, where S's entries outgrow an int index).  K4 and
K7 write each row's Gram, b and count to scratch and solve it in a
second pass (``csrc/gather_solve.cuh``, ``csrc/chol_tiled.cuh``: K2's
routines in one block's shared memory up to rank 288; above it
``csrc/chol_cluster.cuh``, the system in a thread-block cluster's
distributed shared memory, bit for bit K1's streamed solve, see
:func:`_cluster_plan`),
up to :data:`SOLVE_MAX_RANK` = 512, the reference's own bound (its
``TileBudgetError``); above it their wrappers raise ``ValueError`` on
any device, and 'auto' takes K3 + K6 there.  The plain versions take
any rank.  S is symmetric: its lower triangle ``S[i, c] = Σ
(aw·v_i)·v_c`` (c <= i) is mirrored.

A CUDA tensor goes to a kernel (or raises); only CPU tensors take the
plain versions :func:`gather_gram_plain`, :func:`gather_solve_plain` and
:func:`gather_solve_ring_plain`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_als_torch import _build
from tpu_als_torch.ops.cuda_lanes import chol_solve_plain
from tpu_als_torch.ops.cuda_solve import ONCHIP_MAX_RANK, SMEM_BYTES
from tpu_als_torch.ops.solve import DEFAULT_JITTER, implicit_weights
from tpu_als_torch.perf.roofline import (fused_ne_kernel_bytes,
                                         fused_ring_kernel_bytes,
                                         fused_solve_kernel_bytes,
                                         ring_r_pad, ring_row_tile)

# K3's largest rank: S's entries are indexed by a 32-bit int (r·r < 2^31)
GRAM_MAX_RANK = 46340
# K4's and K7's largest rank, the reference's: its fused solve's row tile
# is capped at 2^17 / (32·r_pad) rows, below 8 above r_pad = 512, where
# it raises TileBudgetError (tpu_als/ops/pallas_gather_ne.py::_tiles_solve)
SOLVE_MAX_RANK = 512
_DTYPES = (torch.float32, torch.bfloat16)

# kernel launches in this process, per kernel; a run reads them to show
# that its path went through the kernels
GRAM_LAUNCHES = 0   # K3
SOLVE_LAUNCHES = 0  # K4
RING_LAUNCHES = 0   # K7
# [bytes, calls] while perf/ne_audit.py::kernel_cost_bytes audits a
# function: the calls of K3, K4 and K7 then add the HBM bytes each declares
# (the roofline's closed form at its shapes, a model and not a
# measurement), on either device; None otherwise, and no call does any
# bookkeeping
COST = None
# [(payload bytes, grid)] while parallel/comm_audit.py::remote_dma_bytes
# audits a function: each K7 call adds the cross-shard payload one hop of
# its ring schedule carries and the schedule's grid (row tiles, shards),
# on either device; None otherwise
REMOTE = None

# K4's and K7's scratch (each row's Gram, b and count, and K7's width
# chunks' partials) is kept within this many f32 elements a launch (1
# GiB, the trainer's per-launch budget): the rows go in tiles.  K4 takes
# another tile per call (``scratch_elems``, a knob of perf/autotune.py)
_SCRATCH_ELEMS = 1 << 28


def _row_floats(r):
    """Scratch floats a row takes: its Gram, b and count; above the
    on-chip solve's rank, rounded up to a multiple of 4 (the streamed
    solve reads each row's A by 16-byte loads): gsolve::row_floats."""
    e = r * r + r + 1
    return e + -e % 4 if r > ONCHIP_MAX_RANK else e


# Above ONCHIP_MAX_RANK the solve pass of K4 and K7 runs one thread-block
# cluster a row (csrc/chol_cluster.cuh): C blocks of 512 threads, the
# fewest of CLUSTER_SIZES whose largest share of the system (its tiles,
# the slots for the panel tiles it is handed, a handed diagonal tile, the
# vectors and tables) fits in a block's shared memory on the card
CLUSTER_SIZES = (2, 4, 8)
_TILE_FLOATS = 32 * 36
_CLUSTER_TABLE_INTS = 3 * 16 + 8 * 16 + 64


class ClusterPlan(NamedTuple):
    """``ccl::cluster_size`` / ``ccl::owner`` / ``ccl::smem_bytes``."""
    size: int           # blocks a cluster
    owners: tuple       # the block of each tile row
    tiles: tuple        # the tiles each block holds
    smem_bytes: int     # shared memory a block (the largest share)


def _cluster_owner(i, t, c):
    """The block of the ``c`` owning tile row ``i`` of ``t``: rows dealt
    from the last up in a snake (ccl::owner)."""
    p = (t - 1 - i) % (2 * c)
    return p if p < c else 2 * c - 1 - p


def _cluster_share(t, c):
    """Bytes of shared memory a block takes with ``t`` tile rows on ``c``
    blocks (ccl::smem_bytes)."""
    owners = [_cluster_owner(i, t, c) for i in range(t)]
    tiles = [sum(i + 1 for i in range(t) if owners[i] == b) for b in range(c)]
    slots = [t - owners.count(b) for b in range(c)]
    floats = ((max(tiles) + max(slots) + 1) * _TILE_FLOATS + 3 * 32
              + 2 * 32 * t + _CLUSTER_TABLE_INTS)
    return 4 * floats, tuple(owners), tuple(tiles)


def _cluster_plan(r):
    """The launcher's cluster plan at rank ``r`` (above ONCHIP_MAX_RANK, up
    to SOLVE_MAX_RANK): gsolve::launch_tail_solve's ccl::cluster_size."""
    if not ONCHIP_MAX_RANK < r <= SOLVE_MAX_RANK:
        raise ValueError(f"rank {r}: the cluster solve takes ranks "
                         f"{ONCHIP_MAX_RANK + 1} to {SOLVE_MAX_RANK}")
    t = -(-r // 32)
    for c in CLUSTER_SIZES:
        nbytes, owners, tiles = _cluster_share(t, c)
        if c <= t and nbytes <= SMEM_BYTES:
            return ClusterPlan(c, owners, tiles, nbytes)
    raise ValueError(f"rank {r}: no cluster size holds the system")


def cluster_info(r, dtype=torch.float32):
    """The card's view of K4's and K7's cluster launch at rank ``r``
    (``gather_solve_cluster_info``): ``{"size", "dynamic_smem",
    "static_smem", "registers", "max_active_clusters"}``, the shared bytes
    a block and registers a thread from ``cudaFuncGetAttributes``."""
    import ctypes

    out = (ctypes.c_longlong * 5)()
    fn = _build.load("gather_solve_cluster_info")
    _build.check(fn(int(r), int(dtype == torch.bfloat16), out),
                 "gather_solve_cluster_info")
    return dict(zip(("size", "dynamic_smem", "static_smem", "registers",
                     "max_active_clusters"), (int(v) for v in out)))


def _chunks(w, split_width):
    """Width chunks [(start, stop)] of ``split_width`` entries (one chunk
    when split_width is None or not below w)."""
    step = w if split_width is None else max(1, min(int(split_width), w))
    return [(s, min(s + step, w)) for s in range(0, w, step)]


def gather_gram_plain(V, cols, aw, bw, *, two_sided, split_width=None):
    """K3's function in plain PyTorch: ``V[cols]`` and ``torch.bmm`` per
    width chunk, the chunk sums added in order, the lower triangle
    mirrored.  ``aw·v`` is formed in float32, where the product of two
    bfloat16 values is exact."""
    n, w = cols.shape
    r = V.shape[1]
    S = torch.zeros(n, r, r, dtype=torch.float32, device=V.device)
    b = torch.zeros(n, r, dtype=torch.float32, device=V.device)
    for s, e in _chunks(w, split_width):
        Vg = V[cols[:, s:e].long()].float()
        Vw = Vg * aw[:, s:e, None].float()
        S = S + torch.bmm(Vw.transpose(1, 2), Vw if two_sided else Vg)
        b = b + torch.bmm(bw[:, None, s:e].float(), Vg)[:, 0]
    return torch.tril(S) + torch.tril(S, -1).transpose(1, 2), b


def _round(x, dtype):
    return x.to(dtype).float()


def tail_system(S, cnt, dt, YtY, reg, jitter=DEFAULT_JITTER):
    """The tail of ``gather_solve.cuh`` on summed Grams S [n, r, r] with
    counts ``cnt`` [n] (weights of type ``dt``): A += YᵀY; diag += ridge,
    then + jitter; rows with count <= 0 become (1 + jitter)·I.  The
    kernels form these entries in the same f32 operations."""
    ridge = _round(_round(cnt, dt) * _round(torch.tensor(reg), dt), dt)
    r = S.shape[-1]
    eye = torch.eye(r, dtype=torch.float32, device=S.device)
    A = S if YtY is None else S + YtY.float()[None]
    A = A + torch.diag_embed(ridge[:, None].expand(-1, r))
    A = A + jitter * eye
    return torch.where((cnt <= 0)[:, None, None], eye + jitter * eye, A)


def _tail_solve(S, b, cnt, dt, YtY, reg, jitter):
    """:func:`tail_system`, then the solve of ``chol_tiled.cuh`` (K2's
    plain version)."""
    return chol_solve_plain(
        tail_system(S, cnt, dt, YtY, reg, jitter).contiguous(), b)


def gather_solve_plain(V, cols, aw, bw, cw, YtY=None, *, two_sided, reg,
                       jitter=DEFAULT_JITTER):
    """K4's function in plain PyTorch: K3's plain Gram, then the tail of
    ``gather_solve.cuh`` (A += YᵀY; diag += ridge, then + jitter; rows
    with count <= 0 become (1 + jitter)·I), then K2's plain solve."""
    S, b = gather_gram_plain(V, cols, aw, bw, two_sided=two_sided)
    return _tail_solve(S, b, cw.float().sum(-1), V.dtype, YtY, reg, jitter)


def _check(name, V, cols, *weights):
    if V.dim() != 2 or V.dtype not in _DTYPES:
        raise TypeError(f"{name} takes V [N, r] float32 or bfloat16, got "
                        f"{tuple(V.shape)} {V.dtype}")
    if cols.dim() != 2 or cols.dtype != torch.int32:
        raise TypeError(f"{name} takes cols [n, w] int32, got "
                        f"{tuple(cols.shape)} {cols.dtype}")
    for wt in weights:
        if wt.shape != cols.shape or wt.dtype != V.dtype:
            raise TypeError(f"{name}: weights must be {tuple(cols.shape)} "
                            f"{V.dtype} like the table, got "
                            f"{tuple(wt.shape)} {wt.dtype}")
    for t in (cols,) + weights:
        if t.device != V.device:
            raise ValueError(f"{name}: V on {V.device}, an input on "
                             f"{t.device}")


def _solve_rank(name, r):
    """K4's and K7's rank bound, on every device (the plain versions
    themselves take any rank)."""
    if r > SOLVE_MAX_RANK:
        raise ValueError(
            f"{name}: rank {r} > {SOLVE_MAX_RANK}, the fused solve's bound "
            "(the reference raises TileBudgetError above r_pad 512: its "
            "row tile's cap 2^17 / (32·r_pad) falls below 8); 'auto' takes "
            "K3 + K6 there")


def _declare(closed_form, *shape):
    if COST is not None:
        COST[0] += int(closed_form(*shape))
        COST[1] += 1


def _cuda_ready(name, V, *tensors):
    if V.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {V.device}")
    if V.shape[-1] > GRAM_MAX_RANK:
        raise ValueError(f"{name}: rank {V.shape[-1]} > {GRAM_MAX_RANK}: "
                         "S's entries would outgrow an int index")
    if not all(t.is_contiguous() for t in (V,) + tensors):
        raise ValueError(f"{name} takes contiguous tensors")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def gather_gram(V, cols, aw, bw, *, two_sided, split_width=None):
    """``(S [n, r, r], b [n, r])``: kernel K3 for CUDA tensors, the plain
    version for CPU tensors.  ``split_width``: rows wider than this are
    cut into width chunks of that many entries, one block each, and the
    chunk sums added in order."""
    global GRAM_LAUNCHES
    _check("gather_gram", V, cols, aw, bw)
    _declare(fused_ne_kernel_bytes, cols.numel(), cols.shape[0], V.shape[1],
             V.element_size())
    if V.device.type == "cpu":
        return gather_gram_plain(V, cols, aw, bw, two_sided=two_sided,
                                 split_width=split_width)
    _cuda_ready("gather_gram", V, cols, aw, bw)
    n, w = cols.shape
    r = V.shape[1]
    S = torch.empty(n, r, r, dtype=torch.float32, device=V.device)
    b = torch.empty(n, r, dtype=torch.float32, device=V.device)
    if n == 0 or w == 0:
        return S.zero_(), b.zero_()
    chunks = _chunks(w, split_width)
    split = chunks[0][1]
    part_S = part_b = None
    if len(chunks) > 1:
        part_S = torch.empty(n, len(chunks), r, r, dtype=torch.float32,
                             device=V.device)
        part_b = torch.empty(n, len(chunks), r, dtype=torch.float32,
                             device=V.device)
    fn = _build.load("gather_gram")
    with torch.cuda.device(V.device):
        err = fn(V.data_ptr(), cols.data_ptr(), aw.data_ptr(), bw.data_ptr(),
                 S.data_ptr(), b.data_ptr(),
                 None if part_S is None else part_S.data_ptr(),
                 None if part_b is None else part_b.data_ptr(),
                 n, w, r, split, int(two_sided),
                 int(V.dtype == torch.bfloat16), _stream(V))
    _build.check(err, "gather_gram")
    GRAM_LAUNCHES += 1
    return S, b


def _ridge(reg, count):
    """``reg · count`` in the count's type, ``reg`` rounded to that type
    first, as JAX does for a Python scalar (torch would multiply by the
    unrounded scalar: 0.1 · 18 in bf16 lands one bf16 step apart)."""
    return torch.as_tensor(reg, dtype=count.dtype, device=count.device) \
        * count


def gather_normal_eq_explicit(V, cols, vals, mask, reg, *, split_width=None):
    """``normal_eq_explicit(V[cols], vals, mask, reg)`` without the
    gather: returns ``(A, b, count)``."""
    S, b = gather_gram(V, cols, mask, vals * mask, two_sided=True,
                       split_width=split_width)
    count = mask.sum(-1)
    eye = torch.eye(V.shape[1], dtype=S.dtype, device=S.device)
    A = S + _ridge(reg, count)[:, None, None] * eye
    return A, b, count


def gather_normal_eq_implicit(V, cols, vals, mask, reg, alpha, YtY, *,
                              split_width=None):
    """``normal_eq_implicit(V[cols], vals, mask, reg, alpha, YtY)`` without
    the gather: returns ``(A, b, count)``."""
    conf_m1, pref = implicit_weights(vals, mask, alpha)
    S, b = gather_gram(V, cols, conf_m1, (1.0 + conf_m1) * pref * mask,
                       two_sided=False, split_width=split_width)
    count = (pref * mask).sum(-1)
    eye = torch.eye(V.shape[1], dtype=S.dtype, device=S.device)
    A = S + YtY[None] + _ridge(reg, count)[:, None, None] * eye
    return A, b, count


def _yty(name, YtY, r, device):
    """YᵀY as the kernels take it: [r, r] float32, contiguous, or None."""
    if YtY is None:
        return None
    YtY = YtY.float().contiguous()
    if YtY.shape != (r, r) or YtY.device != device:
        raise ValueError(f"{name}: YtY must be [{r}, {r}] on {device}")
    return YtY


def _reg_w(reg, dtype):
    """The ridge coefficient rounded to the weight type, as a float."""
    return float(torch.tensor(float(reg)).to(dtype).float())


def gather_solve(V, cols, aw, bw, cw, YtY=None, *, two_sided, reg,
                 jitter=DEFAULT_JITTER, scratch_elems=None):
    """``x [n, r]`` f32: kernel K4 for CUDA tensors, the plain version for
    CPU tensors, rank <= :data:`SOLVE_MAX_RANK` on both (``ValueError``
    above).  ``reg`` and ``jitter`` are the ridge coefficient and the
    jitter of the in-kernel tail; ``YtY`` [r, r] f32 or None (zero).  The
    kernel's two passes run on row tiles whose scratch stays within
    ``scratch_elems`` floats (None: :data:`_SCRATCH_ELEMS`, 1,021 rows a
    tile at rank 512; at least one row's); ``SOLVE_LAUNCHES`` counts one
    per call."""
    global SOLVE_LAUNCHES
    _check("gather_solve", V, cols, aw, bw, cw)
    _solve_rank("gather_solve", V.shape[1])
    _declare(fused_solve_kernel_bytes, cols.numel(), cols.shape[0],
             V.shape[1], V.element_size())
    if V.device.type == "cpu":
        return gather_solve_plain(V, cols, aw, bw, cw, YtY,
                                  two_sided=two_sided, reg=reg,
                                  jitter=jitter)
    _cuda_ready("gather_solve", V, cols, aw, bw, cw)
    n, w = cols.shape
    r = V.shape[1]
    YtY = _yty("gather_solve", YtY, r, V.device)
    x = torch.empty(n, r, dtype=torch.float32, device=V.device)
    if n == 0:
        return x
    if w == 0:
        return x.zero_()
    scratch = _SCRATCH_ELEMS if scratch_elems is None else int(scratch_elems)
    step = max(1, min(n, scratch // _row_floats(r)))
    sums = torch.empty(step * _row_floats(r), dtype=torch.float32,
                       device=V.device)
    fn = _build.load("gather_solve")
    with torch.cuda.device(V.device):
        for row0 in range(0, n, step):
            err = fn(V.data_ptr(), cols.data_ptr(), aw.data_ptr(),
                     bw.data_ptr(), cw.data_ptr(),
                     None if YtY is None else YtY.data_ptr(), x.data_ptr(),
                     sums.data_ptr(), n, w, r, _reg_w(reg, V.dtype),
                     float(jitter), int(two_sided),
                     int(V.dtype == torch.bfloat16), row0,
                     min(step, n - row0), _stream(V))
            _build.check(err, "gather_solve")
    SOLVE_LAUNCHES += 1
    return x


def gather_fused_solve_explicit(V, cols, vals, mask, reg, *,
                                jitter=DEFAULT_JITTER, scratch_elems=None):
    """``normal_eq_explicit(V[cols], ...)`` + ``solve_spd`` in one kernel:
    returns x only."""
    return gather_solve(V, cols, mask, vals * mask, mask, two_sided=True,
                        reg=reg, jitter=jitter, scratch_elems=scratch_elems)


def gather_fused_solve_implicit(V, cols, vals, mask, reg, alpha, YtY, *,
                                jitter=DEFAULT_JITTER, scratch_elems=None):
    """``normal_eq_implicit(V[cols], ...)`` + ``solve_spd`` in one kernel:
    returns x only."""
    conf_m1, pref = implicit_weights(vals, mask, alpha)
    return gather_solve(V, cols, conf_m1, (1.0 + conf_m1) * pref * mask,
                        pref * mask, YtY, two_sided=False, reg=reg,
                        jitter=jitter, scratch_elems=scratch_elems)


def gather_solve_ring_plain(V_shards, cols, aw, bw, cw, YtY=None, *,
                            two_sided, reg, jitter=DEFAULT_JITTER,
                            split_width=None):
    """K7's function in plain PyTorch: for each owner d, its ring-ordered
    entry stream — the entries of source shard (d - t) mod S for t = 0 ..
    S-1, each source's ids offset into the stacked table — through K3's
    plain Gram, summed in chunks of ``split_width`` entries in order as
    the kernel's width split sums them (one chunk when the stream is not
    longer), then the tail of :func:`gather_solve_plain` and K1's plain
    solve: at S = 1 and no split it is K4's plain version."""
    S, per, r = V_shards.shape
    V = V_shards.reshape(S * per, r)
    xs = []
    for d in range(cols.shape[0]):
        order = [(d - t) % S for t in range(S)]
        a, b, c = (torch.cat([t[d, s] for s in order], dim=1)
                   for t in (aw, bw, cw))
        ids = torch.cat([cols[d, s] + s * per for s in order], dim=1)
        G, rhs = gather_gram_plain(V, ids, a, b, two_sided=two_sided,
                                   split_width=split_width)
        xs.append(_tail_solve(G, rhs, c.float().sum(-1), V.dtype, YtY, reg,
                              jitter))
    return torch.stack(xs)


class MappedShards(NamedTuple):
    """The S shards of a ring's opposite table as K7 reaches them across
    the processes of a group on one card (``parallel/peer.py``):
    ``bases`` a CUDA int64 tensor of S device addresses, this process's
    own shards and its peers' mapped ones, each shard ``per`` rows of
    ``r`` values of ``dtype``.  :func:`gather_solve_ring` takes it in
    place of the stacked ``V_shards``."""

    bases: torch.Tensor
    per: int
    r: int
    dtype: torch.dtype

    @property
    def shape(self):
        return (self.bases.shape[0], self.per, self.r)

    @property
    def device(self):
        return self.bases.device


def gather_solve_ring(V_shards, cols, aw, bw, cw, YtY=None, *, two_sided,
                      reg, jitter=DEFAULT_JITTER, split_width=None):
    """``x [D, n, r]`` f32 for the rows of all D owners of a ring: kernel K7
    for CUDA tensors, the plain version for CPU tensors.

    ``V_shards`` [S, per, r]: the opposite factors' S shards, stacked, or
    a :class:`MappedShards` (their base pointers across processes, on
    the card only);
    ``cols``/``aw``/``bw``/``cw`` [D, S, n, w]: each owner's bucket,
    shard-local ids, source-major and unrotated — owner d's row sums its
    entries over the sources (d - t) mod S, t = 0 .. S-1, in that order;
    ``reg``, ``jitter``, ``YtY`` as :func:`gather_solve`.
    ``split_width``: when a row's stream (S·w entries) is longer, the
    kernel splits it over blocks in chunks of that many entries (partial
    Grams, summed in order); otherwise one Gram block per row (and part).
    Then the tail and the solve per row, as K4's; the passes run on row
    tiles that keep the scratch within :data:`_SCRATCH_ELEMS`.
    ``RING_LAUNCHES`` counts one per call, whatever the number of passes
    and row tiles.  Rank <= :data:`SOLVE_MAX_RANK`, as K4."""
    global RING_LAUNCHES
    mapped = isinstance(V_shards, MappedShards)
    if cols.dim() != 4 or cols.shape[1] != V_shards.shape[0] or (
            not mapped and V_shards.dim() != 3):
        raise ValueError(f"gather_solve_ring takes V_shards [S, per, r] and "
                         f"cols [D, S, n, w]; got {tuple(V_shards.shape)}, "
                         f"{tuple(cols.shape)}")
    S, per, r = V_shards.shape
    dtype, device = V_shards.dtype, V_shards.device
    if mapped and (device.type != "cuda"
                   or V_shards.bases.dtype != torch.int64):
        raise ValueError("gather_solve_ring: mapped shards are an int64 "
                         "array of device addresses on the card")
    table = (torch.empty(0, r, dtype=dtype, device=device) if mapped
             else V_shards.reshape(S * per, r))
    _check("gather_solve_ring", table, cols[0, 0],
           *(t[0, 0] for t in (aw, bw, cw)))
    _solve_rank("gather_solve_ring", r)
    for t in (aw, bw, cw):
        if t.shape != cols.shape:
            raise TypeError(f"gather_solve_ring: weights must be "
                            f"{tuple(cols.shape)}, got {tuple(t.shape)}")
    D, _, n, w = cols.shape
    db = torch.empty((), dtype=dtype).element_size()
    # every owner's rows over all S sources; the shards share one card's
    # memory, so no ring payload crosses a link
    _declare(fused_ring_kernel_bytes, cols.numel(), D * n, r, db, 0)
    if REMOTE is not None:
        # the reference's schedule over S cards: one [per, r_pad] shard a
        # hop, one ring pass per row tile of its TN rows
        r_pad = ring_r_pad(r)
        tiles = -(-n // ring_row_tile(r_pad, -(-w // 8) * 8))
        REMOTE.append((per * r_pad * db, (tiles, S)))
    if device.type == "cpu":
        return gather_solve_ring_plain(V_shards, cols, aw, bw, cw, YtY,
                                       two_sided=two_sided, reg=reg,
                                       jitter=jitter,
                                       split_width=split_width)
    if mapped:
        _cuda_ready("gather_solve_ring", V_shards.bases, cols, aw, bw, cw)
        bases = V_shards.bases
    else:
        _cuda_ready("gather_solve_ring", V_shards, cols, aw, bw, cw)
        # the shards' base pointers; on this one-device mesh they point
        # into the stacked table
        bases = torch.tensor([V_shards[s].data_ptr() for s in range(S)],
                             dtype=torch.int64, device=device)
    if S * per >= 1 << 31:
        raise ValueError(f"gather_solve_ring: {S} x {per} rows overflow the "
                         "kernel's int32 row handles")
    YtY = _yty("gather_solve_ring", YtY, r, device)
    x = torch.empty(D, n, r, dtype=torch.float32, device=device)
    if D * n == 0:
        return x
    if w == 0:
        return x.zero_()
    split = 0 if split_width is None else max(1, int(split_width))
    # per row of every owner: its sum (and, split, its chunks' partials)
    E = _row_floats(r)
    nchunk = -(-S * w // split) if split and S * w > split else 0
    step = max(1, min(n, _SCRATCH_ELEMS // (D * (nchunk + 1) * E)))
    sums = torch.empty(D * step * E, dtype=torch.float32, device=device)
    part = None
    if nchunk:
        part = torch.empty(D * step * nchunk * E, dtype=torch.float32,
                           device=device)
    fn = _build.load("gather_solve_ring")
    with torch.cuda.device(device):
        for row0 in range(0, n, step):
            nrows = min(step, n - row0)
            err = fn(bases.data_ptr(), per, cols.data_ptr(), aw.data_ptr(),
                     bw.data_ptr(), cw.data_ptr(),
                     None if YtY is None else YtY.data_ptr(), x.data_ptr(),
                     D, S, n, w, r, _reg_w(reg, dtype),
                     float(jitter), int(two_sided),
                     int(dtype == torch.bfloat16), split, row0,
                     nrows, None if part is None else part.data_ptr(),
                     sums.data_ptr(), _stream(x))
            _build.check(err, "gather_solve_ring")
    RING_LAUNCHES += 1
    return x


def gather_fused_ring_explicit(V_shards, cols, vals, mask, reg, *,
                               jitter=DEFAULT_JITTER, split_width=None):
    """The explicit ring half-step's rows in one kernel (the reference's
    weight expressions over the unrotated [D, S, n, w] buckets): at S = 1
    and S·w <= ``split_width`` :func:`gather_fused_solve_explicit`."""
    return gather_solve_ring(V_shards, cols, mask, vals * mask, mask,
                             two_sided=True, reg=reg, jitter=jitter,
                             split_width=split_width)


def gather_fused_ring_implicit(V_shards, cols, vals, mask, reg, alpha, YtY,
                               *, jitter=DEFAULT_JITTER, split_width=None):
    """The implicit ring half-step's rows in one kernel: weights from
    :func:`implicit_weights`, the whole table's YᵀY and the weighted-λ
    tail in the kernel."""
    conf_m1, pref = implicit_weights(vals, mask, alpha)
    return gather_solve_ring(V_shards, cols, conf_m1,
                             (1.0 + conf_m1) * pref * mask, pref * mask, YtY,
                             two_sided=False, reg=reg, jitter=jitter,
                             split_width=split_width)
