"""Normal equations and batched least-squares solves.

Counterpart of ``tpu_als/ops/solve.py``: the ALS-WR and Hu–Koren–Volinsky
normal-equation builds, ``compute_yty``, ``solve_spd`` with its
contract, ``solve_nnls`` and the warm-started CG solvers of inexact
ALS.  The normal-equation contractions and CG stay PyTorch ops, as the
JAX package leaves them to XLA; the SPD solve is kernel K2
(:mod:`tpu_als_torch.ops.cuda_lanes`, rank <= 128), kernel K6
(:mod:`tpu_als_torch.ops.cuda_lanes_blocked`, above rank 128: the
factorization and both substitutions in one call) or, by name, kernel K1
(:mod:`tpu_als_torch.ops.cuda_solve`, tiled, any rank) on a CUDA
tensor, and their plain versions on a CPU tensor.  The ``adaptive=``
jitter ladder belongs to the guardrails slice and is not here.

Shapes use the padded-row convention of the reference:

  ``Vg``   [n, w, r]  gathered opposite-side factor rows per entity
  ``vals`` [n, w]     ratings (0 in padding slots)
  ``mask`` [n, w]     1.0 for real entries, 0.0 for padding
"""

from __future__ import annotations

import torch

from tpu_als_torch.ops import cuda_lanes, cuda_lanes_blocked, cuda_solve

DEFAULT_JITTER = 1e-6

# Rows wider than this are contracted in width chunks of this many
# entries, and the chunk sums added.  A batched GEMM on the card sums a
# long contraction in one sequential chain, and on a power-law catalog's
# widest rows that chain's rounding, amplified by the system's condition,
# moved x by more than 1e-3 of its norm (chip_smoke.py's float64 check of
# the widest rows reads both routes).
WIDTH_CHUNK = 512


def _contract(L, R):
    """``Σ_w L[:, w, :]ᵀ R[:, w, :]``: [n, w, a] x [n, w, c] -> [n, a, c],
    in width chunks of at most :data:`WIDTH_CHUNK` entries: the whole
    chunks in one batched product whose partials are summed, a ragged
    last chunk (when the chunk does not divide the width) added after."""
    n, w, a = L.shape
    c = R.shape[-1]
    step = max(1, min(WIDTH_CHUNK, w))
    p = w // step
    q = p * step
    part = torch.bmm(L[:, :q].reshape(n * p, step, a).transpose(1, 2),
                     R[:, :q].reshape(n * p, step, c))
    out = part.reshape(n, p, a, c).sum(1)
    if q < w:
        out = out + torch.bmm(L[:, q:].transpose(1, 2), R[:, q:])
    return out


def implicit_weights(vals, mask, alpha):
    """Hu–Koren–Volinsky weighting: ``(c − 1, preference)``."""
    conf_m1 = alpha * vals.abs() * mask
    pref = (vals > 0).to(vals.dtype)
    return conf_m1, pref


def gram_terms(Vg, vals, mask, implicit=False, alpha=1.0):
    """The data terms of the normal equations, without YᵀY and the ridge:
    ``(S [n,r,r], b [n,r], count [n])`` with ``S = Σ v vᵀ``, ``b = Σ r v``
    and ``count`` the rated entries (explicit), or ``S = Σ (c − 1) v vᵀ``,
    ``b = Σ c·p·v`` and ``count`` the positive ones (implicit)."""
    Vg = Vg.float()
    if implicit:
        conf_m1, pref = implicit_weights(vals, mask, alpha)
        S = _contract(Vg * conf_m1[..., None], Vg)
        b = _contract(((1.0 + conf_m1) * pref * mask).float()[..., None],
                      Vg)[:, 0]
        return S, b, (pref * mask).sum(-1)
    Vm = Vg * mask[..., None]
    S = _contract(Vm, Vm)
    b = _contract((vals * mask).float()[..., None], Vg)[:, 0]
    return S, b, mask.sum(-1)


def normal_eq_explicit(Vg, vals, mask, reg):
    """ALS-WR normal equations: ``A = Σ v vᵀ + λ·n·I``, ``b = Σ r v``.

    Returns ``(A [n,r,r], b [n,r], count [n])``, all float32.
    """
    A, b, count = gram_terms(Vg, vals, mask)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return A + (reg * count)[:, None, None] * eye, b, count


def normal_eq_implicit(Vg, vals, mask, reg, alpha, YtY):
    """Implicit-feedback normal equations with the YᵀY trick:

        A = YᵀY + Σ (c − 1) v vᵀ + λ·n·I        b = Σ c·p·v

    with ``c = 1 + α|r|``, ``p = [r > 0]``, and only ratings > 0 counting
    toward ``n``.  Returns ``(A [n,r,r], b [n,r], count [n])``.
    """
    A, b, count = gram_terms(Vg, vals, mask, implicit=True, alpha=alpha)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return A + YtY[None] + (reg * count)[:, None, None] * eye, b, count


def compute_yty(V):
    """YᵀY over all factor rows: [N, r] -> [r, r] float32."""
    V = V.float()
    return V.T @ V


def regularize(A, count, jitter=DEFAULT_JITTER):
    """``solve_spd``'s pre-regularization: rows with ``count <= 0`` get
    ``A := I`` (their b is 0, so x is exactly 0), then ``+ jitter·I``.
    The result is always a fresh contiguous tensor: K6 writes its factor
    over it, and the caller's A is left as it was."""
    r = A.shape[-1]
    eye = torch.eye(r, dtype=A.dtype, device=A.device)
    A = torch.where((count <= 0)[:, None, None], eye, A)
    return (A + jitter * eye).contiguous()


# the solve kernels by backend name
SOLVERS = {"lanes": cuda_lanes.spd_solve_lanes,
           "lanes_blocked": cuda_lanes_blocked.spd_solve_lanes_blocked,
           "pallas": cuda_solve.spd_solve_blocked}


def auto_solve_backend(rank):
    """'lanes' (K2) up to rank 128, 'lanes_blocked' (K6) above — the
    reference's preference order, with no probes: each name is one
    hand-written kernel."""
    return "lanes" if rank <= cuda_lanes.MAX_RANK else "lanes_blocked"


def solve_spd(A, b, count, jitter=DEFAULT_JITTER, backend="auto"):
    """Batched SPD solve x = A⁻¹ b after :func:`regularize`.

    ``backend``: 'auto' (:func:`auto_solve_backend`), or a name of
    :data:`SOLVERS`: 'lanes' forces K2, 'lanes_blocked' K6's fused
    solve, 'pallas' K1.  bfloat16 input is upcast to float32
    before the guard, solved, and the answer cast back (there is no bf16
    factorization).
    """
    if A.dtype == torch.bfloat16:
        return solve_spd(A.float(), b.float(), count, jitter=jitter,
                         backend=backend).to(torch.bfloat16)
    if backend == "auto":
        backend = auto_solve_backend(A.shape[-1])
    if backend not in SOLVERS:
        raise ValueError(f"unknown solve backend {backend!r} (expected "
                         f"'auto' or one of {sorted(SOLVERS)})")
    return SOLVERS[backend](regularize(A, count, jitter), b.contiguous())


def solve_nnls(A, b, count, sweeps=32, jitter=DEFAULT_JITTER):
    """Batched nonnegative least squares by cyclic coordinate descent —
    a fixed number of sweeps, as in the reference."""
    A = regularize(A, count, jitter)
    r = A.shape[-1]
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    x = torch.zeros_like(b)
    for _ in range(sweeps):
        for j in range(r):
            Ax_j = (A[:, j, :] * x).sum(-1)
            x[:, j] = torch.clamp(x[:, j] - (Ax_j - b[:, j]) / diag[:, j],
                                  min=0.0)
    return x


def pcg(matvec, b, diag, x0=None, iters=3):
    """Batched Jacobi-preconditioned CG with a fixed number of steps.

    ``matvec``: [n, r] -> [n, r], the batched SPD operator; ``diag``
    [n, r]: its diagonal.  The engine of :func:`solve_cg` (dense A) and
    :func:`solve_cg_matfree` (A applied through the gathered rows).
    """
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
    res = b - matvec(x)
    z = res / diag
    p = z
    rz = (res * z).sum(-1)
    for _ in range(iters):
        Ap = matvec(p)
        denom = (p * Ap).sum(-1)
        alpha = rz / torch.clamp(denom, min=1e-30)
        x = x + alpha[:, None] * p
        res = res - alpha[:, None] * Ap
        z = res / diag
        rz_new = (res * z).sum(-1)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = z + beta[:, None] * p
        rz = rz_new
    return x


def solve_cg(A, b, count, x0=None, iters=3, jitter=DEFAULT_JITTER):
    """Inexact solve: ``iters`` warm-started Jacobi-CG steps on the built
    A, with :func:`solve_spd`'s guard (rows with ``count <= 0`` act as
    A := I, so from any warm start they land on x = 0)."""
    A = regularize(A, count, jitter)
    diag = torch.diagonal(A, dim1=-2, dim2=-1)

    def matvec(p):
        return torch.bmm(A, p[:, :, None])[..., 0]

    return pcg(matvec, b, diag, x0=x0, iters=iters)


def _wsum(weights, Vg):
    """``Σ_w weights[n, w]·Vg[n, w, :]`` in float32: [n, r]."""
    return torch.bmm(weights.float()[:, None, :], Vg)[:, 0]


def solve_cg_matfree(Vg, vals, mask, reg, implicit=False, alpha=1.0,
                     YtY=None, x0=None, iters=3, jitter=DEFAULT_JITTER):
    """Matrix-free inexact solve: CG with A applied through the gathered
    rows, ``A·p = YᵀY·p + Vgᵀ((c−1) ⊙ (Vg·p)) + (λn + jitter)·p``, so the
    [n, r, r] tensor is never built.  ``Vg`` may be bfloat16; every
    reduction runs in float32.  Same weights, count rule and cold-row
    contract as the dense build."""
    dt = Vg.dtype
    mA = mask.to(dt)
    vA = vals.to(dt)
    Vf = Vg.float()
    if implicit:
        w_conf, pref = implicit_weights(vA, mA, alpha)
        rhs = _wsum((1.0 + w_conf) * pref * mA, Vf)
        count = (pref.float() * mask.float()).sum(-1)
    else:
        w_conf = mA
        rhs = _wsum(vA * mA, Vf)
        count = mask.float().sum(-1)
    w32 = w_conf.float()
    ridge = (reg * count + jitter)[:, None]
    empty = (count <= 0)[:, None]
    # the squares in Vg's type, as the reference's ``Vg * Vg``
    diag = _wsum(w32, (Vg * Vg).float()) + ridge
    YtYf = YtY.float() if implicit else None
    if YtYf is not None:
        diag = diag + torch.diagonal(YtYf)[None, :]
    diag = torch.where(empty, torch.ones_like(diag), diag)

    def matvec(p):
        t = torch.bmm(Vf, p[:, :, None])[..., 0]
        mv = _wsum(w32 * t, Vf) + ridge * p
        if YtYf is not None:
            mv = mv + p @ YtYf
        return torch.where(empty, p, mv)

    return pcg(matvec, rhs, diag, x0=x0, iters=iters)
