"""Kernel K1: batched SPD solve by blocked Cholesky — wrapper and plain version.

Counterpart of ``tpu_als/ops/pallas_solve.py::spd_solve_pallas``.  The
CUDA source is ``tpu_als_torch/csrc/chol_blocked.cu`` (device routines in
``csrc/chol_blocked.cuh``, whose factorization kernel K6 also calls).
Same contract: A [N, r, r] f32 already regularized by
:func:`tpu_als_torch.ops.solve.solve_spd`, b [N, r] f32 -> x [N, r] f32;
only the lower triangle of A is read; a row with b = 0 solves to x = 0;
pivots are scaled by ``rsqrt(max(d, 1e-30))``.  It takes any rank whose
packed triangle fits one block's shared memory (r <= 323).

A CUDA tensor goes to the kernel (or raises); only a CPU tensor takes
:func:`chol_blocked_plain`.
"""

from __future__ import annotations

import torch

from tpu_als_torch import _build

PANEL = 16
PIVOT_FLOOR = 1e-30
SMEM_BYTES = 232448  # shared memory one Hopper block may use


def smem_bytes(r):
    """Shared memory the kernel needs at rank r: the packed lower
    triangle, the transposed panel and the substitution vector."""
    return (r * (r + 1) // 2 + PANEL * r + r) * 4


MAX_RANK = max(r for r in range(1, 512) if smem_bytes(r) <= SMEM_BYTES)

# kernel launches in this process; a run reads it to show that its path
# went through the kernel
LAUNCHES = 0


def factorize_plain(A, panel=PANEL):
    """L with A = L Lᵀ, in the kernel's order: per panel of ``panel``
    columns, the column recurrence restricted to the panel, then one
    trailing update of everything right of it.  Element-wise products
    only (no matmul), so no TF32 rounding can enter on the card."""
    r = A.shape[-1]
    L = torch.tril(A).clone()
    for p in range(0, r, panel):
        q = min(p + panel, r)
        for j in range(p, q):
            inv = torch.rsqrt(torch.clamp(L[:, j, j], min=PIVOT_FLOOR))
            col = L[:, j:, j] * inv[:, None]          # L[j:, j]
            # panel columns j+1 .. q-1, rows at or below the column
            upd = col[:, 1:, None] * col[:, None, 1:q - j]
            L[:, j + 1:, j + 1:q] -= torch.tril(upd)
            L[:, j:, j] = col
        if q < r:
            Lp = L[:, q:, p:q]                        # rows >= q of the panel
            acc = torch.zeros_like(L[:, q:, q:])
            for k in range(q - p):
                acc += Lp[:, :, k, None] * Lp[:, None, :, k]
            L[:, q:, q:] -= torch.tril(acc)
    return L


def substitute_plain(L, b):
    """x with L Lᵀ x = b: column-oriented forward, row-oriented back
    substitution, the order of ``chol_blocked.cuh::substitute``."""
    r = L.shape[-1]
    res = b.clone()
    for j in range(r):
        res[:, j] = res[:, j] / L[:, j, j]
        res[:, j + 1:] -= res[:, j, None] * L[:, j + 1:, j]
    x = torch.empty_like(b)
    for j in range(r - 1, -1, -1):
        x[:, j] = res[:, j] / L[:, j, j]
        res[:, :j] -= x[:, j, None] * L[:, j, :j]
    return x


def chol_blocked_plain(A, b):
    """The kernel's arithmetic in plain PyTorch, batched over N."""
    return substitute_plain(factorize_plain(A), b)


def _check(A, b):
    if A.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"spd_solve_blocked takes float32, got A {A.dtype}, "
                        f"b {b.dtype}")
    if A.dim() != 3 or A.shape[1] != A.shape[2] or b.dim() != 2 \
            or b.shape != A.shape[:2]:
        raise ValueError(f"spd_solve_blocked takes A [N, r, r] and b [N, r], "
                         f"got {tuple(A.shape)} and {tuple(b.shape)}")
    if A.device != b.device:
        raise ValueError(f"A on {A.device}, b on {b.device}")


def spd_solve_blocked(A, b):
    """Batched x = A⁻¹ b: kernel K1 for a CUDA tensor, the plain version
    for a CPU tensor."""
    global LAUNCHES
    _check(A, b)
    if A.device.type == "cpu":
        return chol_blocked_plain(A, b)
    if A.device.type != "cuda":
        raise ValueError(f"spd_solve_blocked runs on cuda or cpu, not "
                         f"{A.device}")
    N, r = b.shape
    if r > MAX_RANK:
        raise NotImplementedError(
            f"rank {r} > {MAX_RANK}: the system does not fit one block's "
            "shared memory; the streamed rank-256+ solve "
            "(tpu_als/ops/pallas_lanes_blocked.py::chol_lanes_blocked, "
            "K6) is not ported to CUDA yet")
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError("spd_solve_blocked takes contiguous A and b")
    x = torch.empty_like(b)
    if N == 0:
        return x
    fn = _build.load("chol_blocked")
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), b.data_ptr(), x.data_ptr(), N, r, stream)
    _build.check(err, "chol_blocked_f32")
    LAUNCHES += 1
    return x
