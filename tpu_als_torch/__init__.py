"""tpu_als_torch — the PyTorch / CUDA port of ``tpu_als`` for one NVIDIA H100.

The JAX package ``tpu_als`` stays the reference; this package is its
counterpart written in PyTorch, with the TPU's Pallas kernels replaced by
CUDA C++ kernels written by hand for Hopper (``sm_90a``, sources under
``csrc/``, built at first use by :mod:`tpu_als_torch._build`).

The slices ported so far: single-device training
(:class:`~tpu_als_torch.api.estimator.ALS` ``.fit``, the ``train``
command) and the serving path — fold-in of new ratings
(:class:`~tpu_als_torch.stream.microbatch.FoldInServer`), then top-k
recommendation (:class:`~tpu_als_torch.api.estimator.ALSModel`) — the
sharded path over a mesh of logical shards on one device
(:mod:`tpu_als_torch.parallel`: ``ALS(mesh=...)``,
``recommendFor*(mesh=...)``), plus
the shared checkpoint format, the ``recommend`` command
(``python -m tpu_als_torch.cli train|recommend``) and
:class:`~tpu_als_torch.api.evaluation.RegressionEvaluator`.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; a CUDA tensor always goes through the hand-written
kernel (or raises), and only a CPU tensor takes a kernel's plain PyTorch
version.

Package map:
  ops/     normal equations, CG, the SPD solves (kernels K1 and K2, and
           K6's factorization above rank 128), the fused gather + Gram
           (K3) and gather + solve (K4) and its ring over shards (K7),
           top-k (K5) and the cross-shard top-k merge (K8)
  core/    id maps and bucketed CSR, the training loop, fold-in, predict
  stream/  the micro-batch fold-in server
  parallel/  the mesh, sharded layouts, the sharded trainer and server
  api/     ALS, ALSModel, the sharded fit, params, regression evaluators
  io/      checkpoint persistence (same on-disk format as tpu_als), the
           ratings CSV reader, synthetic MovieLens-shaped data
  utils/   device resolution, the columnar frame
"""

__version__ = "0.1.0"

from tpu_als_torch.api.estimator import ALS, ALSModel  # noqa: F401
from tpu_als_torch.api.evaluation import RegressionEvaluator  # noqa: F401
from tpu_als_torch.convert import model_from_arrays  # noqa: F401
from tpu_als_torch.stream.microbatch import FoldInServer  # noqa: F401
from tpu_als_torch.utils.frame import ColumnarFrame  # noqa: F401
