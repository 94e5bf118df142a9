"""Kernels K3 (gather + Gram) and K4 (gather + Gram + tail + solve).

Counterpart of ``tpu_als/ops/pallas_gather_ne.py``: ``gather_gram`` and
its wrappers ``gather_normal_eq_explicit`` / ``gather_normal_eq_implicit``
(K3, ``csrc/gather_gram.cu``), and ``gather_solve`` with its wrappers
``gather_fused_solve_explicit`` / ``gather_fused_solve_implicit`` (K4,
``csrc/gather_solve.cu``).  The factor rows ``V[cols]`` are gathered
inside the kernels and never materialized; the weights, the count and
the ridge/YᵀY tail are the reference builders' exact expressions.

Both kernels take the table in float32 or bfloat16, weights in the
table's type, and rank <= 256 (the Gram accumulates in register tiles,
and above rank 128 into a packed triangle in shared memory; above rank
256 a CUDA tensor raises, and the plain versions take any rank).  S is
symmetric: its
lower triangle ``S[i, c] = Σ (aw·v_i)·v_c`` (c <= i) is mirrored.

A CUDA tensor goes to a kernel (or raises); only CPU tensors take the
plain versions :func:`gather_gram_plain` and :func:`gather_solve_plain`.
"""

from __future__ import annotations

import torch

from tpu_als_torch import _build
from tpu_als_torch.ops.cuda_solve import chol_blocked_plain
from tpu_als_torch.ops.solve import DEFAULT_JITTER, implicit_weights

MAX_RANK = 256
_DTYPES = (torch.float32, torch.bfloat16)

# kernel launches in this process, per kernel; a run reads them to show
# that its path went through the kernels
GRAM_LAUNCHES = 0   # K3
SOLVE_LAUNCHES = 0  # K4


def _chunks(w, split_width):
    """Width chunks [(start, stop)] of ``split_width`` entries (one chunk
    when split_width is None or not below w)."""
    step = w if split_width is None else max(1, min(int(split_width), w))
    return [(s, min(s + step, w)) for s in range(0, w, step)]


def gather_gram_plain(V, cols, aw, bw, *, two_sided, split_width=None):
    """K3's function in plain PyTorch: ``V[cols]`` and ``torch.bmm`` per
    width chunk, the chunk sums added in order, the lower triangle
    mirrored.  ``aw·v`` is formed in float32, where the product of two
    bfloat16 values is exact."""
    n, w = cols.shape
    r = V.shape[1]
    S = torch.zeros(n, r, r, dtype=torch.float32, device=V.device)
    b = torch.zeros(n, r, dtype=torch.float32, device=V.device)
    for s, e in _chunks(w, split_width):
        Vg = V[cols[:, s:e].long()].float()
        Vw = Vg * aw[:, s:e, None].float()
        S = S + torch.bmm(Vw.transpose(1, 2), Vw if two_sided else Vg)
        b = b + torch.bmm(bw[:, None, s:e].float(), Vg)[:, 0]
    return torch.tril(S) + torch.tril(S, -1).transpose(1, 2), b


def _round(x, dtype):
    return x.to(dtype).float()


def gather_solve_plain(V, cols, aw, bw, cw, YtY=None, *, two_sided, reg,
                       jitter=DEFAULT_JITTER):
    """K4's function in plain PyTorch: K3's plain Gram, then the tail of
    ``gather_solve.cu`` (A += YᵀY; diag += ridge, then + jitter; rows
    with count <= 0 become (1 + jitter)·I), then K1's plain solve."""
    S, b = gather_gram_plain(V, cols, aw, bw, two_sided=two_sided)
    dt = V.dtype
    cnt = cw.float().sum(-1)
    ridge = _round(_round(cnt, dt) * _round(torch.tensor(reg), dt), dt)
    r = V.shape[1]
    eye = torch.eye(r, dtype=torch.float32, device=V.device)
    A = S if YtY is None else S + YtY.float()[None]
    A = A + torch.diag_embed(ridge[:, None].expand(-1, r))
    A = A + jitter * eye
    A = torch.where((cnt <= 0)[:, None, None], eye + jitter * eye, A)
    return chol_blocked_plain(A.contiguous(), b)


def _check(name, V, cols, *weights):
    if V.dim() != 2 or V.dtype not in _DTYPES:
        raise TypeError(f"{name} takes V [N, r] float32 or bfloat16, got "
                        f"{tuple(V.shape)} {V.dtype}")
    if cols.dim() != 2 or cols.dtype != torch.int32:
        raise TypeError(f"{name} takes cols [n, w] int32, got "
                        f"{tuple(cols.shape)} {cols.dtype}")
    for wt in weights:
        if wt.shape != cols.shape or wt.dtype != V.dtype:
            raise TypeError(f"{name}: weights must be {tuple(cols.shape)} "
                            f"{V.dtype} like the table, got "
                            f"{tuple(wt.shape)} {wt.dtype}")
    for t in (cols,) + weights:
        if t.device != V.device:
            raise ValueError(f"{name}: V on {V.device}, an input on "
                             f"{t.device}")


def _cuda_ready(name, V, *tensors):
    if V.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {V.device}")
    r = V.shape[1]
    if r > MAX_RANK:
        raise NotImplementedError(
            f"{name}: rank {r} > {MAX_RANK}: the Gram's register tiles and "
            "its packed triangle in shared memory hold at most rank 256; a "
            "Gram streamed through device memory (as K6 streams its blocks) "
            "is not written yet; solve_backend='unfused' is the explicit "
            "choice above it")
    if not all(t.is_contiguous() for t in (V,) + tensors):
        raise ValueError(f"{name} takes contiguous tensors")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def gather_gram(V, cols, aw, bw, *, two_sided, split_width=None):
    """``(S [n, r, r], b [n, r])``: kernel K3 for CUDA tensors, the plain
    version for CPU tensors.  ``split_width``: rows wider than this are
    cut into width chunks of that many entries, one block each, and the
    chunk sums added in order."""
    global GRAM_LAUNCHES
    _check("gather_gram", V, cols, aw, bw)
    if V.device.type == "cpu":
        return gather_gram_plain(V, cols, aw, bw, two_sided=two_sided,
                                 split_width=split_width)
    _cuda_ready("gather_gram", V, cols, aw, bw)
    n, w = cols.shape
    r = V.shape[1]
    S = torch.empty(n, r, r, dtype=torch.float32, device=V.device)
    b = torch.empty(n, r, dtype=torch.float32, device=V.device)
    if n == 0 or w == 0:
        return S.zero_(), b.zero_()
    chunks = _chunks(w, split_width)
    split = chunks[0][1]
    part_S = part_b = None
    if len(chunks) > 1:
        part_S = torch.empty(n, len(chunks), r, r, dtype=torch.float32,
                             device=V.device)
        part_b = torch.empty(n, len(chunks), r, dtype=torch.float32,
                             device=V.device)
    fn = _build.load("gather_gram")
    with torch.cuda.device(V.device):
        err = fn(V.data_ptr(), cols.data_ptr(), aw.data_ptr(), bw.data_ptr(),
                 S.data_ptr(), b.data_ptr(),
                 None if part_S is None else part_S.data_ptr(),
                 None if part_b is None else part_b.data_ptr(),
                 n, w, r, split, int(two_sided),
                 int(V.dtype == torch.bfloat16), _stream(V))
    _build.check(err, "gather_gram")
    GRAM_LAUNCHES += 1
    return S, b


def _ridge(reg, count):
    """``reg · count`` in the count's type, ``reg`` rounded to that type
    first, as JAX does for a Python scalar (torch would multiply by the
    unrounded scalar: 0.1 · 18 in bf16 lands one bf16 step apart)."""
    return torch.as_tensor(reg, dtype=count.dtype, device=count.device) \
        * count


def gather_normal_eq_explicit(V, cols, vals, mask, reg, *, split_width=None):
    """``normal_eq_explicit(V[cols], vals, mask, reg)`` without the
    gather: returns ``(A, b, count)``."""
    S, b = gather_gram(V, cols, mask, vals * mask, two_sided=True,
                       split_width=split_width)
    count = mask.sum(-1)
    eye = torch.eye(V.shape[1], dtype=S.dtype, device=S.device)
    A = S + _ridge(reg, count)[:, None, None] * eye
    return A, b, count


def gather_normal_eq_implicit(V, cols, vals, mask, reg, alpha, YtY, *,
                              split_width=None):
    """``normal_eq_implicit(V[cols], vals, mask, reg, alpha, YtY)`` without
    the gather: returns ``(A, b, count)``."""
    conf_m1, pref = implicit_weights(vals, mask, alpha)
    S, b = gather_gram(V, cols, conf_m1, (1.0 + conf_m1) * pref * mask,
                       two_sided=False, split_width=split_width)
    count = (pref * mask).sum(-1)
    eye = torch.eye(V.shape[1], dtype=S.dtype, device=S.device)
    A = S + YtY[None] + _ridge(reg, count)[:, None, None] * eye
    return A, b, count


def gather_solve(V, cols, aw, bw, cw, YtY=None, *, two_sided, reg,
                 jitter=DEFAULT_JITTER):
    """``x [n, r]`` f32: kernel K4 for CUDA tensors, the plain version for
    CPU tensors.  ``reg`` and ``jitter`` are the ridge coefficient and the
    jitter of the in-kernel tail; ``YtY`` [r, r] f32 or None (zero)."""
    global SOLVE_LAUNCHES
    _check("gather_solve", V, cols, aw, bw, cw)
    if V.device.type == "cpu":
        return gather_solve_plain(V, cols, aw, bw, cw, YtY,
                                  two_sided=two_sided, reg=reg,
                                  jitter=jitter)
    _cuda_ready("gather_solve", V, cols, aw, bw, cw)
    n, w = cols.shape
    r = V.shape[1]
    if YtY is not None:
        YtY = YtY.float().contiguous()
        if YtY.shape != (r, r) or YtY.device != V.device:
            raise ValueError(f"gather_solve: YtY must be [{r}, {r}] on "
                             f"{V.device}")
    x = torch.empty(n, r, dtype=torch.float32, device=V.device)
    if n == 0:
        return x
    if w == 0:
        return x.zero_()
    reg_w = float(torch.tensor(float(reg)).to(V.dtype).float())
    fn = _build.load("gather_solve")
    with torch.cuda.device(V.device):
        err = fn(V.data_ptr(), cols.data_ptr(), aw.data_ptr(), bw.data_ptr(),
                 cw.data_ptr(), None if YtY is None else YtY.data_ptr(),
                 x.data_ptr(), n, w, r, reg_w, float(jitter),
                 int(two_sided), int(V.dtype == torch.bfloat16), _stream(V))
    _build.check(err, "gather_solve")
    SOLVE_LAUNCHES += 1
    return x


def gather_fused_solve_explicit(V, cols, vals, mask, reg, *,
                                jitter=DEFAULT_JITTER):
    """``normal_eq_explicit(V[cols], ...)`` + ``solve_spd`` in one kernel:
    returns x only."""
    return gather_solve(V, cols, mask, vals * mask, mask, two_sided=True,
                        reg=reg, jitter=jitter)


def gather_fused_solve_implicit(V, cols, vals, mask, reg, alpha, YtY, *,
                                jitter=DEFAULT_JITTER):
    """``normal_eq_implicit(V[cols], ...)`` + ``solve_spd`` in one kernel:
    returns x only."""
    conf_m1, pref = implicit_weights(vals, mask, alpha)
    return gather_solve(V, cols, conf_m1, (1.0 + conf_m1) * pref * mask,
                        pref * mask, YtY, two_sided=False, reg=reg,
                        jitter=jitter)
