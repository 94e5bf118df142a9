"""Kernel K6: batched Cholesky factor for ranks above 128, and the fused
solve — wrapper and plain versions.

Counterpart of ``tpu_als/ops/pallas_lanes_blocked.py::chol_lanes_blocked``
and ``spd_solve_lanes_blocked``.  The CUDA source is
``tpu_als_torch/csrc/chol_lanes_blocked.cu`` (device routines in
``csrc/chol_tiled.cuh``).  Same contract: A [N, r, r] f32 already
regularized by :func:`tpu_als_torch.ops.solve.solve_spd`; only its lower
triangle is read; the lower factor L (A = L Lᵀ), with exact zeros above
the diagonal, is written **over A** — the reference's
``input_output_aliases``: at rank 256 a 4,096-system batch is 1 GiB, so
a second copy is not free.  Pivots are scaled by ``rsqrt(max(d, 1e-30))``
in the diagonal blocks, and the blocks below divide by
``max(L_jj, 1e-30)``.  The kernel takes any rank: up to
:data:`~tpu_als_torch.ops.cuda_solve.ONCHIP_MAX_RANK` the system sits in
one block's shared memory, above it the kernel streams it; the solve
dispatch sends it the ranks above 128.

:func:`spd_solve_lanes_blocked` is the fused entry: the same factor
written over A, and x from both substitutions in the same kernel, while
L is still on chip (the reference leaves the substitutions to XLA).

A CUDA tensor goes to the kernel (or raises); only a CPU tensor takes
:func:`chol_lanes_blocked_plain` or :func:`chol_lanes_blocked_solve_plain`.
"""

from __future__ import annotations

import torch

from tpu_als_torch import _build
from tpu_als_torch.ops.cuda_lanes import factorize_plain, substitute_plain

# kernel launches in this process (either entry); a run reads it to show
# that its path went through the kernel
LAUNCHES = 0


def chol_lanes_blocked_plain(A):
    """The kernel's arithmetic in plain PyTorch, batched over N, written
    over A (which it returns): ``csrc/chol_tiled.cuh``'s tiled order
    (:func:`~tpu_als_torch.ops.cuda_lanes.factorize_plain`) with K6's
    rule, the rows below each diagonal tile divided by ``max(L_jj,
    1e-30)``."""
    return A.copy_(factorize_plain(A, divide=True))


def chol_lanes_blocked_solve_plain(A, b):
    """The fused entry's arithmetic: :func:`chol_lanes_blocked_plain`
    over A, then both substitutions in the kernel's order, dividing by
    ``max(L_jj, 1e-30)``; returns x."""
    return substitute_plain(chol_lanes_blocked_plain(A), b, divide=True)


def _check(A):
    if A.dtype != torch.float32:
        raise TypeError(f"chol_lanes_blocked takes float32, got {A.dtype}")
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"chol_lanes_blocked takes A [N, r, r], got "
                         f"{tuple(A.shape)}")


def _launch(name, *args):
    global LAUNCHES
    fn = _build.load(name)
    A = args[0]
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args), stream)
    _build.check(err, f"{name}_f32")
    LAUNCHES += 1


def _on_cuda(A, what):
    """True for a CPU tensor's plain route, False for the kernel's;
    raises on anything the kernel does not take."""
    if A.device.type == "cpu":
        return False
    if A.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {A.device}")
    if not A.is_contiguous():
        raise ValueError(f"{what} takes a contiguous A (it writes L over "
                         "it)")
    return True


def chol_lanes_blocked(A):
    """L with A = L Lᵀ, lower, zeros above the diagonal, **written over
    A** (which is returned): kernel K6 for a CUDA tensor, the plain
    version for a CPU tensor."""
    _check(A)
    if not _on_cuda(A, "chol_lanes_blocked"):
        return chol_lanes_blocked_plain(A)
    N, r = A.shape[0], A.shape[-1]
    if N and r:
        _launch("chol_lanes_blocked", A, N, r)
    return A


def spd_solve_lanes_blocked(A, b):
    """Batched x = A⁻¹ b, with L **written over A**: K6's fused entry for
    a CUDA tensor, :func:`chol_lanes_blocked_solve_plain` for a CPU
    tensor."""
    _check(A)
    if b.dtype != torch.float32:
        raise TypeError(f"spd_solve_lanes_blocked takes float32, got b "
                        f"{b.dtype}")
    if b.shape != A.shape[:2] or b.device != A.device:
        raise ValueError(f"spd_solve_lanes_blocked takes b [N, r] beside A "
                         f"{tuple(A.shape)} on {A.device}; got "
                         f"{tuple(b.shape)} on {b.device}")
    if not _on_cuda(A, "spd_solve_lanes_blocked"):
        return chol_lanes_blocked_solve_plain(A, b)
    if not b.is_contiguous():
        raise ValueError("spd_solve_lanes_blocked takes a contiguous b")
    N, r = b.shape
    x = torch.empty_like(b)
    if N and r:
        _launch("chol_lanes_blocked_solve", A, b, x, N, r)
    return x
