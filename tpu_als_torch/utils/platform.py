"""Device resolution for the port's entry points.

Counterpart of ``tpu_als/utils/platform.py``, reduced to the one rule the
port needs: an entry point runs on the CUDA device unless its caller asks
for the CPU.  There is no probe machinery — a CUDA tensor always goes
through the hand-written kernel or raises, so there is nothing to probe.
"""

from __future__ import annotations

import torch


def pin_fp32():
    """Keep every float32 matrix product and convolution in full float32.

    TF32 keeps about three decimal digits; with it the plain versions
    drift ~1e-3 from the kernels and from the JAX reference on the card.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None):
    """``None`` -> the CUDA device; anything else -> ``torch.device(device)``.

    Never carries on quietly on the CPU: with no CUDA device visible,
    ``device=None`` raises and says how to ask for the CPU.
    """
    pin_fp32()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "port on the CPU (the kernels' plain PyTorch versions)")
        return torch.device("cuda")
    return torch.device(device)
