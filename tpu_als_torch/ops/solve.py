"""Normal equations and batched least-squares solves.

Counterpart of ``tpu_als/ops/solve.py``: the ALS-WR and Hu–Koren–Volinsky
normal-equation builds, ``compute_yty``, ``solve_spd`` with its
contract, and ``solve_nnls``.  The normal-equation contractions stay
PyTorch ops, as the JAX package leaves them to XLA; the SPD solve is
kernel K2 (:mod:`tpu_als_torch.ops.cuda_lanes`) on a CUDA tensor and its
plain version on a CPU tensor.  The adaptive jitter ladder and the CG
solvers belong to training and are not here.

Shapes use the padded-row convention of the reference:

  ``Vg``   [n, w, r]  gathered opposite-side factor rows per entity
  ``vals`` [n, w]     ratings (0 in padding slots)
  ``mask`` [n, w]     1.0 for real entries, 0.0 for padding
"""

from __future__ import annotations

import torch

from tpu_als_torch.ops import cuda_lanes

DEFAULT_JITTER = 1e-6


def normal_eq_explicit(Vg, vals, mask, reg):
    """ALS-WR normal equations: ``A = Σ v vᵀ + λ·n·I``, ``b = Σ r v``.

    Returns ``(A [n,r,r], b [n,r], count [n])``, all float32.
    """
    Vg = Vg.float()
    Vm = Vg * mask[..., None]
    A = torch.bmm(Vm.transpose(1, 2), Vm)
    b = torch.bmm((vals * mask)[:, None, :], Vg)[:, 0]
    count = mask.sum(-1)
    r = Vg.shape[-1]
    eye = torch.eye(r, dtype=A.dtype, device=A.device)
    A = A + (reg * count)[:, None, None] * eye
    return A, b, count


def implicit_weights(vals, mask, alpha):
    """Hu–Koren–Volinsky weighting: ``(c − 1, preference)``."""
    conf_m1 = alpha * vals.abs() * mask
    pref = (vals > 0).to(vals.dtype)
    return conf_m1, pref


def normal_eq_implicit(Vg, vals, mask, reg, alpha, YtY):
    """Implicit-feedback normal equations with the YᵀY trick:

        A = YᵀY + Σ (c − 1) v vᵀ + λ·n·I        b = Σ c·p·v

    with ``c = 1 + α|r|``, ``p = [r > 0]``, and only ratings > 0 counting
    toward ``n``.  Returns ``(A [n,r,r], b [n,r], count [n])``.
    """
    Vg = Vg.float()
    conf_m1, pref = implicit_weights(vals, mask, alpha)
    A = torch.bmm((Vg * conf_m1[..., None]).transpose(1, 2), Vg)
    b = torch.bmm(((1.0 + conf_m1) * pref * mask)[:, None, :], Vg)[:, 0]
    count = (pref * mask).sum(-1)
    r = Vg.shape[-1]
    eye = torch.eye(r, dtype=A.dtype, device=A.device)
    A = A + YtY[None] + (reg * count)[:, None, None] * eye
    return A, b, count


def compute_yty(V):
    """YᵀY over all factor rows: [N, r] -> [r, r] float32."""
    V = V.float()
    return V.T @ V


def regularize(A, count, jitter=DEFAULT_JITTER):
    """``solve_spd``'s pre-regularization: rows with ``count <= 0`` get
    ``A := I`` (their b is 0, so x is exactly 0), then ``+ jitter·I``."""
    r = A.shape[-1]
    eye = torch.eye(r, dtype=A.dtype, device=A.device)
    A = torch.where((count <= 0)[:, None, None], eye, A)
    return (A + jitter * eye).contiguous()


def solve_spd(A, b, count, jitter=DEFAULT_JITTER):
    """Batched SPD solve x = A⁻¹ b after :func:`regularize`.

    bfloat16 input is upcast to float32 before the guard, solved, and the
    answer cast back (there is no bf16 factorization).
    """
    if A.dtype == torch.bfloat16:
        return solve_spd(A.float(), b.float(), count,
                         jitter=jitter).to(torch.bfloat16)
    return cuda_lanes.spd_solve_lanes(regularize(A, count, jitter),
                                      b.contiguous())


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
