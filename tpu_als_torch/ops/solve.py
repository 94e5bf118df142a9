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
tensor, and their plain versions on a CPU tensor.  ``adaptive=True``
(the guardrails' ladder, :func:`solve_spd`) checks each row's residual
and re-solves the rows that fail with more jitter through the same
kernel, then with CG; :func:`solve_spd_checked` raises the typed
:class:`SolveUnstable` for rows nothing saves.

Shapes use the padded-row convention of the reference:

  ``Vg``   [n, w, r]  gathered opposite-side factor rows per entity
  ``vals`` [n, w]     ratings (0 in padding slots)
  ``mask`` [n, w]     1.0 for real entries, 0.0 for padding
"""

from __future__ import annotations

import torch

from tpu_als_torch.ops import cuda_lanes, cuda_lanes_blocked, cuda_solve
from tpu_als_torch.utils.platform import pin_fp32

DEFAULT_JITTER = 1e-6

# The adaptive solve's ladder: absolute jitter levels tried after the
# configured jitter, in order, before the CG fallback.  A row passes when
# its solution is finite and its residual is within _ADAPTIVE_TOL of
# ||b|| + 1: loose enough that a healthy float32 Cholesky clears it at
# once (the armed cost is then one residual product), tight enough that
# a numerically singular factorization (non-finite x, or a wild x from a
# near-zero pivot) fails it.
ADAPTIVE_JITTER_RUNGS = (1e-4, 1e-2)
_ADAPTIVE_TOL = 1e-2


class SolveUnstable(ArithmeticError):
    """Every rung of the adaptive ladder failed on some rows: their
    systems are beyond what jitter and the CG fallback can stabilize (the
    data is numerically hostile, not the program wrong)."""

    def __init__(self, bad_rows, total_rows):
        super().__init__(
            f"adaptive SPD solve failed on {bad_rows} of {total_rows} rows "
            f"after jitter escalation {ADAPTIVE_JITTER_RUNGS} and the CG "
            "fallback — the Gram systems are numerically unsalvageable")
        self.bad_rows = bad_rows
        self.total_rows = total_rows

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


def _guard(A, count):
    """Rows with ``count <= 0`` get ``A := I`` (their b is 0, so x is
    exactly 0); a fresh tensor."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.where((count <= 0)[:, None, None], eye, A)


def _plus_jitter(A0, jitter):
    """``A0 + jitter·I``, a fresh contiguous tensor (a solver may write
    over it)."""
    eye = torch.eye(A0.shape[-1], dtype=A0.dtype, device=A0.device)
    return (A0 + jitter * eye).contiguous()


def regularize(A, count, jitter=DEFAULT_JITTER):
    """``solve_spd``'s pre-regularization: rows with ``count <= 0`` get
    ``A := I`` (their b is 0, so x is exactly 0), then ``+ jitter·I``.
    The result is always a fresh contiguous tensor: K6 writes its factor
    over it, and the caller's A is left as it was."""
    return _plus_jitter(_guard(A, count), jitter)


# the solve kernels by backend name
SOLVERS = {"lanes": cuda_lanes.spd_solve_lanes,
           "lanes_blocked": cuda_lanes_blocked.spd_solve_lanes_blocked,
           "pallas": cuda_solve.spd_solve_blocked}


def _backend(A, backend):
    """``backend`` with 'auto' resolved from A's rank; raises for a name
    outside :data:`SOLVERS`."""
    if backend == "auto":
        backend = auto_solve_backend(A.shape[-1])
    if backend not in SOLVERS:
        raise ValueError(f"unknown solve backend {backend!r} (expected "
                         f"'auto' or one of {sorted(SOLVERS)})")
    return backend


def auto_solve_backend(rank):
    """'lanes' (K2) up to rank 128, 'lanes_blocked' (K6) above — the
    reference's preference order, with no probes: each name is one
    hand-written kernel."""
    return "lanes" if rank <= cuda_lanes.MAX_RANK else "lanes_blocked"


def solve_spd(A, b, count, jitter=DEFAULT_JITTER, backend="auto",
              adaptive=False):
    """Batched SPD solve x = A⁻¹ b after :func:`regularize`.

    ``backend``: 'auto' (:func:`auto_solve_backend`), or a name of
    :data:`SOLVERS`: 'lanes' forces K2, 'lanes_blocked' K6's fused
    solve, 'pallas' K1.  bfloat16 input is upcast to float32
    before the guard, solved, and the answer cast back (there is no bf16
    factorization).

    ``adaptive=True`` (the guardrails' 'recover' mode, or
    ``AlsConfig(adaptive_solve=True)``): the same solve, then each row's
    residual ``(A0 + jitter·I)·x − b`` is checked against A0, the guarded
    A (never against a tensor a solver was given: K6 writes L over its
    input).  When every row passes — the healthy case — that residual
    product and one host sync are the whole cost, and x is the plain
    solve's, bit for bit.  Otherwise the failing rows alone are solved
    again at each jitter of :data:`ADAPTIVE_JITTER_RUNGS`, through the
    same kernel, a row keeping the first answer that passes; the rows
    that pass no rung get ``min(2r, 32)`` Jacobi-CG steps on
    ``A0 + 1e-2·I`` from their last finite answer, and keep that answer
    whatever it is (:func:`solve_spd_checked` raises for them).
    """
    if A.dtype == torch.bfloat16:
        return solve_spd(A.float(), b.float(), count, jitter=jitter,
                         backend=backend,
                         adaptive=adaptive).to(torch.bfloat16)
    backend = _backend(A, backend)
    if not adaptive:
        return SOLVERS[backend](regularize(A, count, jitter), b.contiguous())
    return _adaptive(A, b, count, jitter, backend)[0]


def _residual_ok(A0, rung, x, b):
    """Rows whose x is finite and solves ``(A0 + rung·I)·x = b`` within
    :data:`_ADAPTIVE_TOL` of ``||b|| + 1``; ``A0 + rung·I`` is applied as
    ``A0·x + rung·x``."""
    res = torch.bmm(A0, x[:, :, None])[..., 0] + rung * x - b
    bound = _ADAPTIVE_TOL * (torch.linalg.vector_norm(b, dim=-1) + 1.0)
    return (torch.isfinite(x).all(-1)
            & (torch.linalg.vector_norm(res, dim=-1) <= bound))


def _adaptive(A, b, count, jitter, backend):
    """The ladder of :func:`solve_spd`; returns ``(x, A0, cg_rows)``, the
    guarded A and the index of the rows no rung settled."""
    pin_fp32()
    solve = SOLVERS[backend]
    b = b.contiguous()
    A0 = _guard(A, count)
    x = solve(_plus_jitter(A0, jitter), b)
    ok = _residual_ok(A0, jitter, x, b)
    if bool(ok.all()):
        return x, A0, torch.empty(0, dtype=torch.long, device=x.device)
    rows = (~ok).nonzero()[:, 0]
    for rung in ADAPTIVE_JITTER_RUNGS:
        Ar, br = A0[rows], b[rows]
        xr = solve(_plus_jitter(Ar, rung), br)
        ok = _residual_ok(Ar, rung, xr, br)
        x[rows[ok]] = xr[ok]
        rows, xr = rows[~ok], xr[~ok]
        if not len(rows):
            return x, A0, rows
    # the last rung: CG on the heaviest-jittered system, factorization-
    # free, so a Cholesky that breaks down on every rung still gets a
    # descent answer
    rung = ADAPTIVE_JITTER_RUNGS[-1]
    Ac, bc = A0[rows], b[rows]
    diag = torch.diagonal(Ac, dim1=-2, dim2=-1) + rung

    def matvec(p):
        return torch.bmm(Ac, p[:, :, None])[..., 0] + rung * p

    warm = torch.where(torch.isfinite(xr), xr, torch.zeros_like(xr))
    x[rows] = pcg(matvec, bc, diag, x0=warm,
                  iters=min(2 * A.shape[-1], 32))
    return x, A0, rows


def solve_spd_checked(A, b, count, jitter=DEFAULT_JITTER, backend="auto"):
    """The adaptive solve with a host-side verdict: raises
    :class:`SolveUnstable` when rows stay non-finite or fail the residual
    rule after every rung; returns x otherwise.  A row is saved when its
    answer satisfies any rung's system (the configured jitter's or a
    ladder rung's): a row solved at the base jitter is not judged against
    a heavier rung it never needed."""
    if A.dtype == torch.bfloat16:
        return solve_spd_checked(A.float(), b.float(), count, jitter=jitter,
                                 backend=backend).to(torch.bfloat16)
    x, A0, rows = _adaptive(A, b, count, jitter, _backend(A, backend))
    if len(rows):
        xc, Ac, bc = x[rows], A0[rows], b[rows].contiguous()
        ok = torch.zeros(len(rows), dtype=torch.bool, device=x.device)
        for rung in (jitter,) + ADAPTIVE_JITTER_RUNGS:
            ok |= _residual_ok(Ac, rung, xc, bc)
        nbad = int((~ok).sum())
        if nbad:
            raise SolveUnstable(nbad, int(x.shape[0]))
    return x


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
