"""The production-week soak, on the card.

Counterpart of ``tpu_als/soak/``, with its exports.  Four pieces,
composed by :func:`tpu_als_torch.soak.orchestrator.run_soak`:

- ``traffic``      — the fully seeded synthetic workload model (zipfian
  catalog with growth, diurnal load at compressed timescale, per-tenant
  mixes, poisoned rating arrivals), replayable byte-for-byte from
  ``(seed, schedule)``.
- ``chaos``        — the declarative chaos schedule: every existing
  fault point sequenced onto the soak timeline, armed per-window
  through ``faults.push_spec`` with LIFO restore.
- ``orchestrator`` — drives multi-tenant serve + per-tenant live
  fold-in + periodic refit concurrently under the traffic model, one
  ``soak_window`` / ``soak_injection`` event per window.
- ``verdict``      — stdlib-only SLO judge, re-derivable from
  events.jsonl alone (``python tpu_als_torch/soak/verdict.py RUN_DIR``).

The reference's docs/soak.md has the knobs, the chaos grammar and the
verdict semantics; each module's docstring says where the port differs.
"""

from tpu_als_torch.soak.traffic import TrafficConfig  # noqa: F401
from tpu_als_torch.soak.chaos import ChaosSchedule, ChaosWindow  # noqa: F401
from tpu_als_torch.soak.orchestrator import run_soak  # noqa: F401
