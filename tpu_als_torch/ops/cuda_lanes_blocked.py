"""Kernel K6: batched Cholesky factor for ranks above 128 — wrapper and
plain version.

Counterpart of ``tpu_als/ops/pallas_lanes_blocked.py::chol_lanes_blocked``
and ``spd_solve_lanes_blocked``.  The CUDA source is
``tpu_als_torch/csrc/chol_lanes_blocked.cu``.  Same contract: A [N, r, r]
f32 already regularized by :func:`tpu_als_torch.ops.solve.solve_spd`;
only its lower triangle is read; the lower factor L (A = L Lᵀ), with
exact zeros above the diagonal, is written **over A** — the reference's
``input_output_aliases``: at rank 256 a 4,096-system batch is 1 GiB, so
a second copy is not free.  Pivots are scaled by ``rsqrt(max(d, 1e-30))``
in the diagonal blocks, and the blocks below divide by
``max(L_jj, 1e-30)``.  The kernel takes any rank; the solve dispatch
sends it the ranks above 128.

A CUDA tensor goes to the kernel (or raises); only a CPU tensor takes
:func:`chol_lanes_blocked_plain`.
"""

from __future__ import annotations

import torch

from tpu_als_torch import _build
from tpu_als_torch.ops.cuda_solve import factorize_plain

BLOCK = 64  # the kernel's block column width
PIVOT_FLOOR = 1e-30

# kernel launches in this process; a run reads it to show that its path
# went through the kernel
LAUNCHES = 0


def chol_lanes_blocked_plain(A):
    """The kernel's arithmetic in plain PyTorch, batched over N, written
    over A (which it returns).  Per block column of :data:`BLOCK`
    columns, left-looking: the Schur corrections from every earlier block
    column, one column product at a time in order; the diagonal block
    factorized by K1's plain recurrence; the rows below solved against
    its transpose column by column.  Element-wise products only (no
    matmul), so no TF32 rounding can enter on the card."""
    r = A.shape[-1]
    for c0 in range(0, r, BLOCK):
        c1 = min(c0 + BLOCK, r)
        bk = c1 - c0
        W = A[:, c0:, c0:c1].clone()
        W[:, :bk] = torch.tril(W[:, :bk])
        for m0 in range(0, c0, BLOCK):
            P = A[:, c0:, m0:m0 + BLOCK]     # final L of block column m
            for c in range(P.shape[-1]):
                W -= P[:, :, c, None] * P[:, None, :bk, c]
        Lkk = factorize_plain(W[:, :bk])
        X = W[:, bk:]
        for j in range(bk):
            X[:, :, j] /= torch.clamp(Lkk[:, j, j], min=PIVOT_FLOOR)[:, None]
            X[:, :, j + 1:] -= X[:, :, j, None] * Lkk[:, None, j + 1:, j]
        A[:, c0:c1, c0:c1] = torch.tril(Lkk)
        A[:, c1:, c0:c1] = X
        A[:, :c0, c0:c1] = 0.0
    return A


def _check(A):
    if A.dtype != torch.float32:
        raise TypeError(f"chol_lanes_blocked takes float32, got {A.dtype}")
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"chol_lanes_blocked takes A [N, r, r], got "
                         f"{tuple(A.shape)}")


def chol_lanes_blocked(A):
    """L with A = L Lᵀ, lower, zeros above the diagonal, **written over
    A** (which is returned): kernel K6 for a CUDA tensor, the plain
    version for a CPU tensor."""
    global LAUNCHES
    _check(A)
    if A.device.type == "cpu":
        return chol_lanes_blocked_plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"chol_lanes_blocked runs on cuda or cpu, not "
                         f"{A.device}")
    if not A.is_contiguous():
        raise ValueError("chol_lanes_blocked takes a contiguous A (it "
                         "writes L over it)")
    N, r = A.shape[0], A.shape[-1]
    if N == 0 or r == 0:
        return A
    fn = _build.load("chol_lanes_blocked")
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), N, r, stream)
    _build.check(err, "chol_lanes_blocked_f32")
    LAUNCHES += 1
    return A


def substitute(L, b):
    """x with L Lᵀ x = b: the two batched triangular solves, which the
    reference also leaves outside its kernel (to XLA)."""
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(1, 2), y,
                                         upper=True)[..., 0]


def spd_solve_lanes_blocked(A, b):
    """Batched x = A⁻¹ b: :func:`chol_lanes_blocked` (which writes L over
    A), then :func:`substitute`."""
    _check(A)
    if b.dtype != torch.float32:
        raise TypeError(f"spd_solve_lanes_blocked takes float32, got b "
                        f"{b.dtype}")
    if b.shape != A.shape[:2] or b.device != A.device:
        raise ValueError(f"spd_solve_lanes_blocked takes b [N, r] beside A "
                         f"{tuple(A.shape)} on {A.device}; got "
                         f"{tuple(b.shape)} on {b.device}")
    return substitute(chol_lanes_blocked(A), b)
