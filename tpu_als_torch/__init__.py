"""tpu_als_torch — the PyTorch / CUDA port of ``tpu_als`` for one NVIDIA H100.

The JAX package ``tpu_als`` stays the reference; this package is its
counterpart written in PyTorch, with the TPU's Pallas kernels replaced by
CUDA C++ kernels written by hand for Hopper (``sm_90a``, sources under
``csrc/``, built at first use by :mod:`tpu_als_torch._build`).

The slice ported so far is the serving path: fold-in of new ratings
(:class:`~tpu_als_torch.stream.microbatch.FoldInServer`), then top-k
recommendation (:class:`~tpu_als_torch.api.estimator.ALSModel`), plus the
shared checkpoint format and the ``recommend`` command
(``python -m tpu_als_torch.cli recommend``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; a CUDA tensor always goes through the hand-written
kernel (or raises), and only a CPU tensor takes a kernel's plain PyTorch
version.

Package map:
  ops/     normal equations, the SPD solve (kernel K2), top-k (kernel K5)
  core/    id maps, fold-in, pairwise predict
  stream/  the micro-batch fold-in server
  api/     ALSModel
  io/      checkpoint persistence (same on-disk format as tpu_als)
  utils/   device resolution, the columnar frame
"""

__version__ = "0.1.0"

from tpu_als_torch.api.estimator import ALSModel  # noqa: F401
from tpu_als_torch.convert import model_from_arrays  # noqa: F401
from tpu_als_torch.stream.microbatch import FoldInServer  # noqa: F401
from tpu_als_torch.utils.frame import ColumnarFrame  # noqa: F401
