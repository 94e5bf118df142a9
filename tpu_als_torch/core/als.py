"""The ALS training engine over bucketed padded CSR, in PyTorch.

Counterpart of ``tpu_als/core/als.py``: ``AlsConfig``, the per-bucket
solve route (:func:`resolve_solve_path`), ``init_factors``,
``local_half_step``, the full iteration (item half-step, then user
half-step) and the single-device ``train`` loop, plus ``predict``.

Routes, with the reference's labels.  Under ``solve_backend='auto'`` a
bucket of width <= :data:`SPLIT_WIDTH` goes through kernel K4
(``gatherfused_solve``: gather, Gram, tail and solve in one kernel, one
block per row); a wider bucket goes through kernel K3 with its width
split over blocks, the ``normal_eq`` tail, and a solve kernel: K1 up to
rank 128 (``gatherfused+pallas_cholesky``; it solves those systems
faster than K2, PERF.md), K6 and two triangular solves above
(``gatherfused+pallas_lanes_blocked``).  K3 and K4 hold rank <= 256:
above it their wrappers raise on the card and 'auto' does not step
around them; ``'unfused'`` is the explicit choice at such a rank.
``'gather_fused_solve'`` forces K4 on every bucket, and so does
``'gather_fused_ring'`` on this local path (``gatherfused_ring``, the
one-shard ring: under the sharded 'ring' strategies it is kernel K7,
:mod:`tpu_als_torch.parallel.comm`), ``'gather_fused'``
forces K3 + ``solve_spd``, ``'unfused'`` forces ``V[cols]`` + torch
normal equations + ``solve_spd`` (K2 up to rank 128, K6 above:
``einsum+pallas_lanes`` / ``einsum+pallas_lanes_blocked``); nonnegative
runs NNLS and ``cg_iters > 0`` inexact CG, as in the reference.  No
route has a probe: on the card each kernel launches or raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpu_als_torch.core.ratings import trainer_chunk
from tpu_als_torch.ops import cuda_gather_ne as gne
from tpu_als_torch.ops.solve import (
    DEFAULT_JITTER,
    auto_solve_backend,
    compute_yty,
    normal_eq_explicit,
    normal_eq_implicit,
    solve_cg,
    solve_cg_matfree,
    solve_nnls,
    solve_spd,
)
from tpu_als_torch.utils.platform import resolve_device

# Rows wider than this many padded entries are split over blocks (K3)
# instead of given one block each (K4).  The ceiling: no block may hold
# more than about 1/132 of a half-step's Gram work (the card has 132
# SMs); at ML-25M a half-step has 3.7e7 (items) to 3.9e7 (users) padded
# entries, so that is about 2.8e5 entries, just over 2^18.  Well below
# it, a launch lasts as long as its slowest block, and a bucket of a few
# dozen rows 2^16 wide (or K3's 2^16-entry chunks) keeps a few dozen SMs
# busy while the rest idle.  At 2^13 a 2^22-wide row spreads over 512
# blocks and the widest K4 rows are short.  PERF.md records one ML-25M
# iteration on an H100 at 2^16 and at 2^13 (0.56x the time).
SPLIT_WIDTH = 1 << 13

SOLVE_BACKENDS = ("auto", "unfused", "gather_fused", "gather_fused_solve",
                  "gather_fused_ring")
_SOLVER_LABEL = {"lanes": "pallas_lanes",
                 "lanes_blocked": "pallas_lanes_blocked",
                 "pallas": "pallas_cholesky"}
_SOLVER_BACKEND = {label: name for name, label in _SOLVER_LABEL.items()}
# the routes that run K4 on every bucket
_K4_PATHS = ("gatherfused_solve", "gatherfused_ring")

# a route's per-launch intermediates ([chunk, r, r] and the like) are
# each kept within this many f32 elements (trainer_chunk's default
# budget, 1 GiB)
_MEM_ELEMS = 1 << 28


@dataclass(frozen=True)
class AlsConfig:
    """Algorithm knobs; names and defaults as the reference's."""

    rank: int = 10
    max_iter: int = 10
    reg_param: float = 0.1
    implicit_prefs: bool = False
    alpha: float = 1.0
    nonnegative: bool = False
    seed: int = 0
    nnls_sweeps: int = 32
    compute_dtype: str = "float32"  # or "bfloat16": the gathered table
    solve_backend: str = "auto"     # SOLVE_BACKENDS; see module docstring
    cg_iters: int = 0               # > 0: inexact ALS, warm-started CG
    cg_mode: str = "matfree"        # or "dense"
    jitter: float = DEFAULT_JITTER
    adaptive_solve: bool = False    # the guardrails ladder: not ported


def resolve_solve_path(cfg: AlsConfig, rank, width):
    """The route label of one bucket of ``width`` at ``rank``, from the
    config and the shapes alone."""
    if cfg.solve_backend not in SOLVE_BACKENDS:
        raise ValueError(f"unknown solve_backend {cfg.solve_backend!r} "
                         f"(expected one of {SOLVE_BACKENDS})")
    if cfg.cg_mode not in ("matfree", "dense"):
        raise ValueError(f"unknown cg_mode {cfg.cg_mode!r} "
                         "(expected 'matfree' or 'dense')")
    if cfg.adaptive_solve:
        raise NotImplementedError(
            "adaptive_solve (the residual-checked jitter ladder of "
            "solve_spd) comes with the guardrails slice of the port")
    solver = _SOLVER_LABEL[auto_solve_backend(rank)]
    if cfg.nonnegative:
        return "einsum+nnls"
    if cfg.solve_backend == "gather_fused_solve":
        return "gatherfused_solve"
    if cfg.solve_backend == "gather_fused_ring":
        return "gatherfused_ring"
    if cfg.solve_backend == "gather_fused":
        return "gatherfused+" + solver
    if cfg.cg_iters > 0:
        return (f"matfree_cg{cfg.cg_iters}_warmstart"
                if cfg.cg_mode == "matfree"
                else f"einsum+cg{cfg.cg_iters}_warmstart")
    if cfg.solve_backend == "auto":
        if width <= SPLIT_WIDTH:
            return "gatherfused_solve"
        # the wide rows' systems: K1 where K2 would be auto's solver (K1
        # solves them faster, PERF.md), K6 above rank 128
        return "gatherfused+" + ("pallas_cholesky" if solver == "pallas_lanes"
                                 else solver)
    return "einsum+" + solver


def init_factors(num_rows, rank, generator):
    """Unit-norm Gaussian rows drawn on the CPU from ``generator`` (the
    reference's init; torch cannot reproduce jax.random's bits)."""
    x = torch.randn(num_rows, rank, generator=generator,
                    dtype=torch.float32)
    nrm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x / torch.clamp(nrm, min=1e-12)


def _chunk_rows(path, nb, w, r, chunk_elems):
    """Rows per launch.  K4 builds no intermediate, so it takes the whole
    bucket; a K3 route takes as many rows as keep its A [chunk, r, r], and
    K3's partial Grams [chunk, width chunks, r, r], each within the
    memory budget (its blocks run in parallel, where the TPU walked
    chunks in order); the gather routes keep the reference's
    trainer_chunk, which also bounds V[cols]."""
    if path in _K4_PATHS:
        return nb
    if path.startswith("gatherfused+"):
        return max(1, min(nb, _MEM_ELEMS // (r * r * -(-w // SPLIT_WIDTH))))
    return trainer_chunk(nb, w, r, chunk_elems)


def _solve_chunk(path, cfg, V_comp, c, v, m, rw, YtY, reg, alpha, prev,
                 num_rows):
    if path in _K4_PATHS:
        if cfg.implicit_prefs:
            return gne.gather_fused_solve_implicit(
                V_comp, c, v, m, reg, alpha, YtY, jitter=cfg.jitter)
        return gne.gather_fused_solve_explicit(V_comp, c, v, m, reg,
                                               jitter=cfg.jitter)
    backend = _SOLVER_BACKEND.get(path.partition("+")[2])
    if path.startswith("gatherfused+"):
        if cfg.implicit_prefs:
            A, rhs, count = gne.gather_normal_eq_implicit(
                V_comp, c, v, m, reg, alpha, YtY, split_width=SPLIT_WIDTH)
        else:
            A, rhs, count = gne.gather_normal_eq_explicit(
                V_comp, c, v, m, reg, split_width=SPLIT_WIDTH)
        return solve_spd(A, rhs, count, jitter=cfg.jitter, backend=backend)
    Vg = V_comp[c.long()]
    cg = "cg" in path
    # warm start of the inexact solvers: the solved side's current rows
    # (padding rows clip to a real row; their count is 0, so CG drives
    # them to 0, and the scatter drops them anyway)
    x0 = None
    if cg and prev is not None:
        x0 = prev.float()[torch.clamp(rw, max=num_rows - 1)]
    if path.startswith("matfree_cg"):
        return solve_cg_matfree(Vg, v, m, reg, implicit=cfg.implicit_prefs,
                                alpha=alpha, YtY=YtY, x0=x0,
                                iters=cfg.cg_iters, jitter=cfg.jitter)
    if cfg.implicit_prefs:
        A, rhs, count = normal_eq_implicit(Vg, v, m, reg, alpha, YtY.float())
    else:
        A, rhs, count = normal_eq_explicit(Vg, v, m, reg)
    if cfg.nonnegative:
        return solve_nnls(A, rhs, count, sweeps=cfg.nnls_sweeps,
                          jitter=cfg.jitter)
    if cg:
        return solve_cg(A, rhs, count, x0=x0, iters=cfg.cg_iters,
                        jitter=cfg.jitter)
    return solve_spd(A, rhs, count, jitter=cfg.jitter, backend=backend)


def local_half_step(V_full, buckets, num_rows, cfg: AlsConfig, YtY=None,
                    chunk_elems=1 << 19, prev=None, reg=None, alpha=None):
    """Solve every row of one side given the full opposite factors.

    ``V_full`` [N_opposite, r]; ``buckets``: the side's buckets as tensors
    (:meth:`CsrBuckets.to`); ``YtY``: the opposite side's Gram (implicit);
    ``prev``: this side's current factors, the warm start of the CG
    routes.  Returns new factors [num_rows, r] f32; rows no bucket holds
    stay 0, and padding rows (``rows == num_rows``) are dropped.
    """
    reg = cfg.reg_param if reg is None else reg
    alpha = cfg.alpha if alpha is None else alpha
    r = V_full.shape[-1]
    cdt = getattr(torch, cfg.compute_dtype)
    # cast once before the gathers: they read padded_nnz x r elements
    V_comp = V_full.to(cdt).contiguous()
    # one spare row takes the padding rows' scatter
    out = torch.zeros(num_rows + 1, r, dtype=torch.float32,
                      device=V_full.device)
    for b in buckets:
        nb, w = b.cols.shape
        path = resolve_solve_path(cfg, r, w)
        vals, mask = b.vals.to(cdt), b.mask.to(cdt)
        step = _chunk_rows(path, nb, w, r, chunk_elems)
        for s in range(0, nb, step):
            sl = slice(s, s + step)
            x = _solve_chunk(path, cfg, V_comp, b.cols[sl], vals[sl],
                             mask[sl], b.rows[sl], YtY, reg, alpha, prev,
                             num_rows)
            out[b.rows[sl]] = x
    return out[:num_rows]


def als_step(U, V, user_buckets, item_buckets, num_users, num_items,
             cfg: AlsConfig, user_chunk_elems=1 << 19,
             item_chunk_elems=1 << 19):
    """One full ALS iteration: the item half-step against the current U
    (with YᵀY = UᵀU when implicit), then the user half-step against the
    new V."""
    yty_u = compute_yty(U) if cfg.implicit_prefs else None
    V = local_half_step(U, item_buckets, num_items, cfg, yty_u,
                        item_chunk_elems, prev=V)
    yty_v = compute_yty(V) if cfg.implicit_prefs else None
    U = local_half_step(V, user_buckets, num_users, cfg, yty_v,
                        user_chunk_elems, prev=U)
    return U, V


def _as_factors(x, device):
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, dtype=np.float32))
    return x.to(device=device, dtype=torch.float32).contiguous()


def train(user_csr, item_csr, cfg: AlsConfig, callback=None, init=None,
          start_iter=0, device=None):
    """Single-device ALS training loop on ``device`` (None -> the card).

    ``user_csr``: buckets keyed by user (cols = item index), solving U;
    ``item_csr``: keyed by item, solving V.  ``callback(iteration, U, V)``
    runs after each iteration.  ``init``: an optional ``(U0, V0)`` warm
    start (a resumed checkpoint): the loop then runs iterations
    ``start_iter + 1 .. cfg.max_iter``.  Returns ``(U, V)`` on the device.
    """
    device = resolve_device(device)
    num_users, num_items = user_csr.num_rows, item_csr.num_rows
    if init is not None:
        U, V = _as_factors(init[0], device), _as_factors(init[1], device)
    else:
        g = torch.Generator().manual_seed(int(cfg.seed))
        U = init_factors(num_users, cfg.rank, g).to(device)
        V = init_factors(num_items, cfg.rank, g).to(device)
    ub, ib = user_csr.to(device), item_csr.to(device)
    it = start_iter
    while it < cfg.max_iter:
        U, V = als_step(U, V, ub, ib, num_users, num_items, cfg,
                        user_csr.chunk_elems, item_csr.chunk_elems)
        it += 1
        if callback is not None:
            callback(it, U, V)
    return U, V


def predict(U, V, u_idx, i_idx, u_valid, i_valid):
    """Gather-dot scores ``U[u]·V[i]``; NaN where a mask is False or an
    index is out of range (the ``coldStartStrategy='nan'`` semantic)."""
    u = u_idx.clamp(0, U.shape[0] - 1)
    i = i_idx.clamp(0, V.shape[0] - 1)
    ok = (u_valid & i_valid
          & (u_idx >= 0) & (u_idx < U.shape[0])
          & (i_idx >= 0) & (i_idx < V.shape[0]))
    scores = (U[u] * V[i]).sum(-1)
    return torch.where(ok, scores, torch.nan)
