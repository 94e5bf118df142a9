"""tpu_als_torch — the PyTorch / CUDA port of ``tpu_als`` for one NVIDIA H100.

The JAX package ``tpu_als`` stays the reference; this package is its
counterpart written in PyTorch, with the TPU's Pallas kernels replaced by
CUDA C++ kernels written by hand for Hopper (``sm_90a``, sources under
``csrc/``, built at first use by :mod:`tpu_als_torch._build`).

The slices ported so far: single-device training
(:class:`~tpu_als_torch.api.estimator.ALS` ``.fit``, the ``train``
command) with its input path (the native bucketizer and CSV reader, the
MovieLens loaders) and numerical guardrails (``ALS(guardrails=)``, the
adaptive solve ladder), and the serving path — fold-in of new ratings
(:class:`~tpu_als_torch.stream.microbatch.FoldInServer`), then top-k
recommendation (:class:`~tpu_als_torch.api.estimator.ALSModel`) — the
sharded path over a mesh of logical shards on one device
(:mod:`tpu_als_torch.parallel`: ``ALS(mesh=...)``,
``recommendFor*(mesh=...)``), plus
the shared checkpoint format with its retried writes, ``.old``
fallback, ``.corrupt/`` quarantine and ``--resume auto``, preemption at
an iteration boundary, and the Spark ML surface around ``ALS``:
``Pipeline``, ``StringIndexer`` / ``IndexToString``,
``ParamGridBuilder`` with ``CrossValidator`` and
``TrainValidationSplit``, the regression and ranking evaluators, the
``mllib`` legacy API (:mod:`tpu_als_torch.api.legacy`), the online
serving engine (:mod:`tpu_als_torch.serving`: admission, micro-batching,
deadlines, the int8 candidate index, atomic and incremental publishes,
the exact, int8 and merge-ring routes), the byte-range string-id stream
reader behind the ``stream:`` data spec (:mod:`tpu_als_torch.io.stream`),
the live fold-in -> publish loop (:mod:`tpu_als_torch.live`), multi-tenant
serving with weighted fair share (:mod:`tpu_als_torch.tenancy`), the
two-tower retrieval model warm-started from ALS factors
(:mod:`tpu_als_torch.models.two_tower`), the fit's observability
(:mod:`tpu_als_torch.utils.observe`, :mod:`tpu_als_torch.utils.debug`)
and the commands ``python -m tpu_als_torch.cli train|recommend|evaluate|
tune|foldin-bench|serve-bench|tt-train|observe``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; a CUDA tensor always goes through the hand-written
kernel (or raises), and only a CPU tensor takes a kernel's plain PyTorch
version.

Package map:
  ops/     normal equations, CG, the SPD solves (kernels K1 and K2, and
           K6's factorization and fused solve above rank 128), the
           fused gather + Gram (K3) and gather + solve (K4) and its ring
           over shards (K7), top-k (K5) and the cross-shard top-k merge (K8)
  core/    id maps and bucketed CSR, the training loop, fold-in, predict
  stream/  the micro-batch fold-in server
  serving/ the online serving engine, its admission queue and the int8
           candidate index
  live/    the live updater: rating events -> fold-in -> incremental
           publish, freshness measured per event
  tenancy/ the tenant registry and the fair-share multi-tenant engine
  plan/    the execution planner and its persistent cache
           (``TPU_ALS_PLAN_CACHE``; ``off`` disarms)
  parallel/  the mesh, sharded layouts, the sharded trainer and server
  api/     ALS, ALSModel, the sharded fit, params, the evaluators, the
           pipeline stages, the tuners, the legacy API, and the table of
           class names that saves record
  io/      checkpoint persistence (same on-disk format as tpu_als), the
           MovieLens loaders, the native CSV reader, bucketizer and
           string-id stream interner (``native/*.cc``, built with g++
           into ``_build/``), the byte-range stream reader, the CSV
           reader's Python twin, synthetic MovieLens-shaped data
  obs/     the metrics registry, its vocabulary, the run manifest, causal
           tracing, the serving flight recorder, the fenced training
           stages, the run directory's readers (report, explain) and
           the bench regression gate (regress)
  perf/    the roofline at the H100's rates and the kernels' bounds,
           stage attribution, the normal-equation traffic audit, the
           autotuner of the kernel knobs
  models/  the two-tower retrieval model
  resilience/  fault injection, retry policies, the fit's guardrails,
           preemption
  utils/   device resolution, the columnar frame, the per-iteration
           logger and profiler trace, the numerical-safety tools
"""

__version__ = "0.1.0"

from tpu_als_torch.api.estimator import ALS, ALSModel  # noqa: F401
from tpu_als_torch.api.pipeline import (  # noqa: F401
    IndexToString,
    Pipeline,
    PipelineModel,
    StringIndexer,
    StringIndexerModel,
)
from tpu_als_torch.api.evaluation import (  # noqa: F401
    RankingEvaluator,
    RankingMetrics,
    RegressionMetrics,
    RegressionEvaluator,
)
from tpu_als_torch.api.tuning import (  # noqa: F401
    CrossValidator,
    CrossValidatorModel,
    ParamGridBuilder,
    TrainValidationSplit,
    TrainValidationSplitModel,
)
from tpu_als_torch.convert import model_from_arrays  # noqa: F401
from tpu_als_torch.stream.microbatch import FoldInServer  # noqa: F401
from tpu_als_torch.utils.frame import ColumnarFrame  # noqa: F401
