"""Online serving: the request path over ALS factors, on the card.

Counterpart of ``tpu_als/serving/``:

- :mod:`tpu_als_torch.serving.batcher` — the micro-batching admission
  queue: bucketed batches, per-request deadlines, typed
  :class:`Overloaded` load shedding;
- :mod:`tpu_als_torch.serving.index` — the int8 candidate index with its
  exact f32 rescore, its delta segment and its sharded form;
- :mod:`tpu_als_torch.serving.engine` — the loop from batcher to scorer
  to response, with atomic publishes, stale-index detection, the
  ``serving.publish`` / ``serving.score`` fault points, and the exact
  (K5), int8 and merge-ring (K8) routes.

``python -m tpu_als_torch.cli serve-bench`` drives an open-loop load
through the engine and reports p50/p99 against an SLO.
"""

from tpu_als_torch.serving.batcher import (
    DEFAULT_BUCKETS,
    DeadlineExceeded,
    MicroBatcher,
    Overloaded,
    Ticket,
    bucket_for,
)
from tpu_als_torch.serving.engine import NoModelPublished, ServingEngine
from tpu_als_torch.serving.index import Int8CandidateIndex, build_index

__all__ = [
    "DEFAULT_BUCKETS",
    "DeadlineExceeded",
    "Int8CandidateIndex",
    "build_index",
    "MicroBatcher",
    "NoModelPublished",
    "Overloaded",
    "ServingEngine",
    "Ticket",
    "bucket_for",
]
