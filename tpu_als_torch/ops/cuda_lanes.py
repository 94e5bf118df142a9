"""Kernel K2: batched SPD solve for rank <= 128 — wrapper and plain version.

Counterpart of ``tpu_als/ops/pallas_lanes.py::spd_solve_lanes``.  The
CUDA source is ``tpu_als_torch/csrc/chol_solve.cu`` (device routines in
``csrc/chol_tiled.cuh``, which kernels K1 and K6 and the solve pass of
kernels K4 and K7 also run).  Same contract: A [N, r, r] f32 already
regularized by :func:`tpu_als_torch.ops.solve.solve_spd`, b [N, r] f32
-> x [N, r] f32; only the lower triangle of A is read; a row with b = 0
solves to x = 0; pivots are scaled by ``rsqrt(max(d, 1e-30))``.

A CUDA tensor goes to the kernel (or raises); only a CPU tensor takes
:func:`chol_solve_plain`.
"""

from __future__ import annotations

import torch

from tpu_als_torch import _build

MAX_RANK = 128
PIVOT_FLOOR = 1e-30
TILE = 32  # the kernel's tile side and block column width

# kernel launches in this process; a run reads it to show that its path
# went through the kernel
LAUNCHES = 0


def factorize_plain(A, divide=False):
    """L with A = L Lᵀ, in the order of ``csrc/chol_tiled.cuh``: per block
    column of :data:`TILE` columns, the diagonal tile column by column
    (right-looking inside it; the pivot scaled by ``rsqrt(max(d,
    1e-30))``), the rows below it column by column with the same scale
    (``divide``: divided by ``max(L_jj, 1e-30)``, K6's rule), then one
    trailing update Σ_q P[:, q] P[:, q]ᵀ over the block column's columns
    q in order.  Element-wise products only (no matmul), so no TF32
    rounding can enter on the card."""
    N, r = A.shape[0], A.shape[-1]
    L = torch.tril(A)
    for k0 in range(0, r, TILE):
        k1 = min(k0 + TILE, r)
        inv = []
        for j in range(k0, k1):  # the diagonal tile
            iv = torch.rsqrt(torch.clamp(L[:, j, j], min=PIVOT_FLOOR))
            inv.append(iv)
            col = L[:, j:k1, j] * iv[:, None]
            L[:, j:k1, j] = col
            L[:, j + 1:k1, j + 1:k1] -= torch.tril(col[:, 1:, None]
                                                   * col[:, None, 1:])
        if k1 == r:
            break
        for j in range(k0, k1):  # the rows below it
            if divide:
                l = L[:, k1:, j] / torch.clamp(L[:, j, j],
                                               min=PIVOT_FLOOR)[:, None]
            else:
                l = L[:, k1:, j] * inv[j - k0][:, None]
            L[:, k1:, j] = l
            L[:, k1:, j + 1:k1] -= l[:, :, None] * L[:, None, j + 1:k1, j]
        P = L[:, k1:, k0:k1]
        acc = torch.zeros(N, r - k1, r - k1, dtype=A.dtype, device=A.device)
        for q in range(k1 - k0):
            acc += P[:, :, q, None] * P[:, None, :, q]
        L[:, k1:, k1:] -= torch.tril(acc)
    return L


def substitute_plain(L, b, divide=False):
    """x with L Lᵀ x = b: column-oriented forward, row-oriented back
    substitution, each dividing by L_jj (``divide``: by ``max(L_jj,
    1e-30)``), the order of ``chol_tiled.cuh``'s substitutions."""
    r = L.shape[-1]
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    if divide:
        d = torch.clamp(d, min=PIVOT_FLOOR)
    res = b.clone()
    for j in range(r):
        res[:, j] = res[:, j] / d[:, j]
        res[:, j + 1:] -= res[:, j, None] * L[:, j + 1:, j]
    x = torch.empty_like(b)
    for j in range(r - 1, -1, -1):
        x[:, j] = res[:, j] / d[:, j]
        res[:, :j] -= x[:, j, None] * L[:, j, :j]
    return x


def chol_solve_plain(A, b):
    """The kernel's arithmetic in plain PyTorch, batched over N (any
    rank: it is also the solve of K1's, K4's and K7's plain versions):
    the tiled factorization, then the substitutions (column-oriented
    forward and back, dividing by L_jj), whose order the kernel's warp
    follows."""
    return substitute_plain(factorize_plain(A), b)


def _check(A, b):
    if A.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"spd_solve_lanes takes float32, got A {A.dtype}, "
                        f"b {b.dtype}")
    if A.dim() != 3 or A.shape[1] != A.shape[2] or b.dim() != 2 \
            or b.shape != A.shape[:2]:
        raise ValueError(f"spd_solve_lanes takes A [N, r, r] and b [N, r], "
                         f"got {tuple(A.shape)} and {tuple(b.shape)}")
    if A.device != b.device:
        raise ValueError(f"A on {A.device}, b on {b.device}")


def spd_solve_lanes(A, b):
    """Batched x = A⁻¹ b: kernel K2 for a CUDA tensor, the plain version
    for a CPU tensor."""
    global LAUNCHES
    _check(A, b)
    if A.device.type == "cpu":
        return chol_solve_plain(A, b)
    if A.device.type != "cuda":
        raise ValueError(f"spd_solve_lanes runs on cuda or cpu, not "
                         f"{A.device}")
    N, r = b.shape
    if r > MAX_RANK:
        raise NotImplementedError(
            f"rank {r} > {MAX_RANK}: K2 takes ranks up to {MAX_RANK}; "
            "solve_spd sends larger ranks to K6 (backend 'lanes_blocked', "
            "ops/cuda_lanes_blocked.py) and K1 ('pallas', "
            "ops/cuda_solve.py) takes any rank")
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError("spd_solve_lanes takes contiguous A and b")
    x = torch.empty_like(b)
    if N == 0:
        return x
    fn = _build.load("chol_solve")
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), b.data_ptr(), x.data_ptr(), N, r, stream)
    _build.check(err, "chol_solve_f32")
    LAUNCHES += 1
    return x
