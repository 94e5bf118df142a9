"""Kernel K2: batched SPD solve for rank <= 128 — wrapper and plain version.

Counterpart of ``tpu_als/ops/pallas_lanes.py::spd_solve_lanes``.  The
CUDA source is ``tpu_als_torch/csrc/chol_solve.cu`` (device routines in
``csrc/chol.cuh``).  Same contract: A [N, r, r] f32 already regularized
by :func:`tpu_als_torch.ops.solve.solve_spd`, b [N, r] f32 -> x [N, r]
f32; only the lower triangle of A is read; a row with b = 0 solves to
x = 0; pivots are scaled by ``rsqrt(max(d, 1e-30))``.

A CUDA tensor goes to the kernel (or raises); only a CPU tensor takes
:func:`chol_solve_plain`.
"""

from __future__ import annotations

import torch

from tpu_als_torch import _build

MAX_RANK = 128
PIVOT_FLOOR = 1e-30

# kernel launches in this process; a run reads it to show that its path
# went through the kernel
LAUNCHES = 0


def chol_solve_plain(A, b):
    """The kernel's arithmetic in plain PyTorch, batched over N.

    Right-looking column Cholesky of the lower triangle with the clamped
    pivot, then column-oriented forward and back substitution — the order
    of ``csrc/chol.cuh``.  Element-wise products only (no matmul), so no
    TF32 rounding can enter on the card.
    """
    r = A.shape[-1]
    L = torch.tril(A)
    for j in range(r):
        inv = torch.rsqrt(torch.clamp(L[:, j, j], min=PIVOT_FLOOR))
        L[:, j:, j] *= inv[:, None]
        col = L[:, j + 1:, j]
        L[:, j + 1:, j + 1:] -= torch.tril(col[:, :, None] * col[:, None, :])
    res = b.clone()
    y = torch.empty_like(b)
    for j in range(r):
        y[:, j] = res[:, j] / L[:, j, j]
        res[:, j + 1:] -= y[:, j, None] * L[:, j + 1:, j]
    x = torch.empty_like(b)
    for j in range(r - 1, -1, -1):
        x[:, j] = y[:, j] / L[:, j, j]
        y[:, :j] -= x[:, j, None] * L[:, j, :j]
    return x


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
            f"rank {r} > {MAX_RANK}: the rank-256 solve kernel "
            "(tpu_als/ops/pallas_lanes_blocked.py::chol_lanes_blocked, "
            "K6) is not ported to CUDA yet")
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
