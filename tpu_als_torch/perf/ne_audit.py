"""Normal-equation traffic audit: the bytes a build gathers, and the bytes
its kernels declare, held against the roofline's closed forms.

Counterpart of ``tpu_als/perf/ne_audit.py``, which walks a jaxpr.  Here:

- :func:`gather_out_bytes` runs the function under a
  ``TorchDispatchMode`` that sees every torch operation and sums the
  output bytes of ``aten.index``, ``aten.index_select`` and
  ``aten.gather``.  The unfused route's ``V[cols]`` is its one large
  gather, so at a bucket's shape the total is the materialized ``[n, w,
  r]`` tensor exactly; a fused route on the card must count zero, since
  its kernels gather the factor rows inside themselves.  On the CPU the
  kernels' plain versions run, and they gather: there the fused routes'
  claim can be shown only on the card (``chip_smoke.py`` phase 11).
- :func:`kernel_cost_bytes` replaces ``pallas_cost_bytes``, which read
  the cost stamps of the Pallas calls.  The kernels are ``ctypes``
  calls, out of a dispatch mode's sight, so the wrappers of K3, K4 and
  K7 (``ops/cuda_gather_ne.py``) declare each call's bytes from the
  roofline's closed form at the call's shapes
  (:func:`~tpu_als_torch.perf.roofline.fused_ne_kernel_bytes`,
  :func:`~tpu_als_torch.perf.roofline.fused_solve_kernel_bytes`,
  :func:`~tpu_als_torch.perf.roofline.fused_ring_kernel_bytes`), on
  either device, while this audit is armed around a function and at no
  other time; this returns what the function declared.  The bytes are
  the model's at the shapes the wrappers were given, not a measurement
  of the kernels' traffic: they show which kernels a function called,
  how often and at which shapes.

Elementwise traffic is not audited: it has no single owner to count.
Gathers and kernel declarations are discrete facts.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from tpu_als_torch.ops import cuda_gather_ne

_GATHERS = (torch.ops.aten.index.Tensor, torch.ops.aten.index_select.default,
            torch.ops.aten.gather.default)


class _GatherBytes(TorchDispatchMode):
    """Sum the output bytes of every gather the block runs."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _GATHERS:
            self.total += sum(t.numel() * t.element_size()
                              for t in tree_leaves(out)
                              if isinstance(t, torch.Tensor))
            self.count += 1
        return out


def gather_out_bytes(fn, *args):
    """``(total_bytes, n_gathers)`` written by the gathers of one call of
    ``fn(*args)``."""
    with _GatherBytes() as mode:
        fn(*args)
    return int(mode.total), int(mode.count)


def kernel_cost_bytes(fn, *args):
    """``(total_bytes, n_calls)`` that the K3, K4 and K7 wrappers
    declared during one call of ``fn(*args)`` (an audit inside ``fn``
    keeps its own)."""
    prev, cuda_gather_ne.COST = cuda_gather_ne.COST, [0, 0]
    try:
        fn(*args)
        nbytes, calls = cuda_gather_ne.COST
    finally:
        cuda_gather_ne.COST = prev
    return int(nbytes), int(calls)
