"""Kernel K1: batched SPD solve by tiled Cholesky — wrapper and plain version.

Counterpart of ``tpu_als/ops/pallas_solve.py::spd_solve_pallas``.  The
CUDA source is ``tpu_als_torch/csrc/chol_blocked.cu`` (device routines in
``csrc/chol_tiled.cuh``, shared with K2 and K6).  Same contract: A [N, r,
r] f32 already regularized by :func:`tpu_als_torch.ops.solve.solve_spd`,
b [N, r] f32 -> x [N, r] f32; only the lower triangle of A is read; a
row with b = 0 solves to x = 0; pivots are scaled by ``rsqrt(max(d,
1e-30))``.  It takes any rank: up to :data:`ONCHIP_MAX_RANK` the system
sits in one block's shared memory; above it the kernel streams the
system through device memory, writing L over a copy of A that this
wrapper makes (the caller's A is left as it was).

Its arithmetic is K2's tiled order, so its plain version is
:func:`tpu_als_torch.ops.cuda_lanes.chol_solve_plain`.  A CUDA tensor
goes to the kernel (or raises); only a CPU tensor takes the plain
version.
"""

from __future__ import annotations

import torch

from tpu_als_torch import _build
from tpu_als_torch.ops.cuda_lanes import TILE, chol_solve_plain

SMEM_BYTES = 232448  # shared memory one Hopper block may use


def smem_bytes(r):
    """Shared memory the on-chip kernel needs at rank r: the lower
    triangle in 32 x 32 tiles of 32 x 36 floats (``csrc/chol_tiled.cuh``),
    then three vectors of 32 floats a tile row."""
    t = -(-r // TILE)
    return (t * (t + 1) // 2 * TILE * 36 + 3 * TILE * t) * 4


# the largest rank whose system fits one block's shared memory (288: 9
# tiles a side, ``chol_tiled.cuh``'s kMaxTiles); above it the streamed path
ONCHIP_MAX_RANK = max(r for r in range(1, 512)
                      if smem_bytes(r) <= SMEM_BYTES)

# kernel launches in this process; a run reads it to show that its path
# went through the kernel
LAUNCHES = 0


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
        return chol_solve_plain(A, b)
    if A.device.type != "cuda":
        raise ValueError(f"spd_solve_blocked runs on cuda or cpu, not "
                         f"{A.device}")
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError("spd_solve_blocked takes contiguous A and b")
    N, r = b.shape
    x = torch.empty_like(b)
    if N == 0:
        return x
    if r > ONCHIP_MAX_RANK:  # the streamed path writes L over its A
        A = A.clone()
    fn = _build.load("chol_blocked")
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), b.data_ptr(), x.data_ptr(), N, r, stream)
    _build.check(err, "chol_blocked_f32")
    LAUNCHES += 1
    return x
