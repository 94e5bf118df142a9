"""Continuous fold-in -> publish: rating arrival to servable in seconds.

Counterpart of ``tpu_als/live/``.  :class:`~tpu_als_torch.live.updater.
LiveUpdater` closes the loop between the fold-in server
(``stream/microbatch.py``) and the serving engine (``serving/engine.py``):
a bounded admission queue of rating events (a full queue raises the
serving batcher's typed ``Overloaded``), micro-batches on the planner's
``max_batch``/``max_wait_ms`` cadence, poisoned events quarantined before
the factors see them, ``FoldInServer.update``/``update_items`` (kernel K2
at rank <= 128 on the card), and ``ServingEngine.publish_update``, the
O(touched rows) incremental publish.  Freshness, arrival to servable, is
measured per event into ``live.freshness_seconds``; an SLO breach dumps
the updater's flight ring.
"""

from tpu_als_torch.live.updater import LiveUpdater

__all__ = ["LiveUpdater"]
