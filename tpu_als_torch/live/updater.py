"""Background update loop: rating events -> fold-in -> incremental publish.

Counterpart of ``tpu_als/live/updater.py``.  One thread owns the whole
arrival-to-servable path, so its latency is one measurable quantity:

1. **Admit.**  ``submit(user, item, rating)`` appends to a bounded queue;
   at capacity it raises the serving batcher's typed
   :class:`~tpu_als_torch.serving.batcher.Overloaded` (``live.shed``
   counts it).
2. **Accumulate.**  The loop gathers up to ``max_batch`` events, or until
   the oldest has waited ``max_wait_ms`` (``plan.resolve_live_cadence``),
   whichever comes first.
3. **Quarantine.**  Events with a non-finite or out-of-range rating
   (``core.ratings.invalid_rating_mask``) are dropped before they reach
   the factors, with the stream reader's obs contract: one
   ``ingest_quarantined`` event and the ``ingest.quarantined_rows``
   counter.
4. **Fold.**  ``FoldInServer.update`` solves the touched user rows (K2 at
   rank <= 128 on the card), and ``update_items`` the touched item rows
   when ``fold_items`` is on.
5. **Publish.**  ``ServingEngine.publish_update`` swaps the new
   generation in: a retag for user-only batches, an O(touched) delta for
   item batches.  The fold-in server writes its factor tables in place,
   so the updater hands the engine a copy of each (the engine must own
   what it serves; the reference's arrays are immutable).

Freshness (``live.freshness_seconds``) is per event, arrival to
publish-visible.  A breach of ``slo_s`` emits ``live_freshness_breach``
and dumps the updater's flight ring (queue_wait / quarantine / foldin /
publish per batch).

A batch that raises is reported as a ``warning`` event with
``what="live.update"`` and the loop carries on, as the reference's does;
callers that must not miss a failure (``chip_smoke.py``) count those
events.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from tpu_als_torch import obs
from tpu_als_torch.core.ratings import invalid_rating_mask
from tpu_als_torch.obs import tracing
from tpu_als_torch.obs.trace import FlightRecorder
from tpu_als_torch.resilience import faults
from tpu_als_torch.serving.batcher import Overloaded
from tpu_als_torch.utils.platform import resolve_device

# the per-batch span breakdown of the updater's flight ring
LIVE_SPAN_KEYS = obs.schema.LIVE_SPAN_KEYS


def _same_device(a, b):
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (a.index if a.index is not None else cur) == \
        (b.index if b.index is not None else cur)


class LiveUpdater:
    """Continuous fold-in -> publish over a :class:`FoldInServer` and a
    :class:`ServingEngine`.

    ``foldin`` wraps the model whose factors are updated; every publish
    pushes a copy of that model's current U/V into ``engine``.
    ``fold_items`` also solves the ITEM side of each batch (new and
    updated items ride the index's delta segment).  ``slo_s`` is the
    arrival -> servable objective; None disables the breach trigger, but
    freshness is always measured.  ``tenant`` (default: the engine's)
    labels every ``live.*`` series and event this loop writes.
    ``device``: where the loop runs, None -> the card (raises without
    CUDA); the engine and the fold-in server must be on it.
    """

    def __init__(self, engine, foldin, *, max_queue=4096,
                 max_batch=None, max_wait_ms=None, slo_s=None,
                 fold_items=False, flight_capacity=64, tenant=None,
                 device=None):
        from tpu_als_torch import plan as _plan

        self.device = resolve_device(device)
        for what, d in (("engine", engine.device),
                        ("fold-in server", foldin.device)):
            if not _same_device(d, self.device):
                raise ValueError(f"the {what} runs on {d}, the updater on "
                                 f"{self.device}")
        cad = _plan.resolve_live_cadence()
        self.engine = engine
        self.foldin = foldin
        if tenant is None:
            tenant = getattr(engine, "tenant", None)
        self.tenant = str(tenant) if tenant is not None else None
        self._labels = {"tenant": self.tenant} if self.tenant else {}
        self.max_queue = int(max_queue)
        self.max_batch = int(max_batch if max_batch is not None
                             else cad["max_batch"])
        self.max_wait_s = float(max_wait_ms if max_wait_ms is not None
                                else cad["max_wait_ms"]) / 1e3
        self.slo_s = float(slo_s) if slo_s is not None else None
        self.fold_items = bool(fold_items)
        self.flight = FlightRecorder(flight_capacity,
                                     span_keys=LIVE_SPAN_KEYS,
                                     labels=self._labels)
        self._queue = []
        self._cond = threading.Condition()
        self._closed = False
        self._thread = None

    # -- producer side ------------------------------------------------
    def submit(self, user, item, rating):
        """Admit one rating event (original user/item ids).  Raises
        :class:`Overloaded` when the queue is at capacity.  Each admitted
        event carries a root causal-trace context (None disarmed) through
        fold-in, publish and visibility."""
        t_arrival = time.perf_counter()
        with self._cond:
            if self._closed:
                raise RuntimeError("LiveUpdater is stopped")
            if len(self._queue) >= self.max_queue:
                obs.counter("live.shed", **self._labels)
                tracing.start_trace("live.admit", tenant=self.tenant,
                                    status="shed")
                raise Overloaded(
                    f"live update queue at capacity ({self.max_queue})")
            ctx = tracing.start_trace("live.admit", tenant=self.tenant)
            self._queue.append((user, item, float(rating), t_arrival,
                                ctx))
            self._cond.notify()

    @property
    def queue_depth(self):
        with self._cond:
            return len(self._queue)

    # -- lifecycle ----------------------------------------------------
    def start(self):
        if self._thread is not None:
            raise RuntimeError("updater already started")
        self._thread = threading.Thread(
            target=self._run, name="tpu-als-torch-live", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain_timeout_s=10.0):
        """Close admission, drain the queue, join the loop."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(drain_timeout_s)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- update loop --------------------------------------------------
    def _next_batch(self):
        """Block for the first event, then accumulate until ``max_batch``
        or the oldest event has waited ``max_wait_s``.  None on an idle
        timeout; a closed, non-empty queue drains without waiting."""
        with self._cond:
            if not self._queue:
                if self._closed:
                    return None
                self._cond.wait(0.05)
                if not self._queue:
                    return None
            t_oldest = self._queue[0][3]
            while (len(self._queue) < self.max_batch
                   and not self._closed):
                left = self.max_wait_s - (time.perf_counter() - t_oldest)
                if left <= 0:
                    break
                self._cond.wait(left)
            batch = self._queue[:self.max_batch]
            del self._queue[:self.max_batch]
            obs.gauge("live.queue_depth", len(self._queue),
                      **self._labels)
            return batch

    def _run(self):
        while True:
            batch = self._next_batch()
            if batch is None:
                with self._cond:
                    if self._closed and not self._queue:
                        return
                continue
            try:
                self._process(batch)
            except BaseException as e:  # noqa: BLE001 — loop must survive
                if not isinstance(e, faults.InjectedFault):
                    obs.emit("warning", what="live.update",
                             reason=f"{type(e).__name__}: {e}")

    def _process(self, batch):
        """One micro-batch: quarantine, fold, publish, measure."""
        t0 = time.perf_counter()
        users = np.asarray([e[0] for e in batch])
        items = np.asarray([e[1] for e in batch])
        ratings = np.asarray([e[2] for e in batch], dtype=np.float32)
        arrivals = np.asarray([e[3] for e in batch])
        # each event's own queue hop, not the batch's
        ctxs = [tracing.record_span(e[4], "live.queue", seconds=t0 - e[3])
                if e[4] is not None else None
                for e in batch]
        queue_wait = t0 - float(arrivals.min())

        # quarantine BEFORE the factors can see a poisoned value
        bad = invalid_rating_mask(ratings)
        n_bad = int(bad.sum())
        if n_bad:
            nonfinite = int((~np.isfinite(ratings)).sum())
            obs.counter("ingest.quarantined_rows", n_bad)
            obs.emit("ingest_quarantined", path="live", rows=n_bad,
                     reasons={"nonfinite": nonfinite,
                              "out_of_range": n_bad - nonfinite},
                     **self._labels)
            keep = ~bad
            for c, dropped in zip(ctxs, bad):
                # a poisoned event's trail ends at quarantine
                if dropped and c is not None:
                    tracing.record_span(c, "live.quarantine",
                                        status="quarantined")
            users, items = users[keep], items[keep]
            ratings, arrivals = ratings[keep], arrivals[keep]
            ctxs = [c for c, k in zip(ctxs, keep) if k]
        quarantine_s = time.perf_counter() - t0
        obs.histogram("live.batch_rows", len(ratings), **self._labels)
        if len(ratings) == 0:
            self.flight.record(
                "quarantined",
                {"queue_wait": queue_wait, "quarantine": quarantine_s})
            return

        p = self.foldin.model._params
        frame = {p["userCol"]: users, p["itemCol"]: items,
                 p["ratingCol"]: ratings}
        tf = time.perf_counter()
        touched_users = self.foldin.update(frame)
        touched_item_rows = None
        if self.fold_items:
            t_items = self.foldin.update_items(frame)
            touched_item_rows = self.foldin.model._item_map.to_dense(
                np.asarray(t_items))
        foldin_s = time.perf_counter() - tf
        ctxs = [tracing.record_span(c, "live.foldin", seconds=foldin_s)
                if c is not None else None for c in ctxs]

        tp = time.perf_counter()
        m = self.foldin.model
        # copies: the fold-in server writes its tables in place
        seq, mode = self.engine.publish_update(
            m._U.clone(), m._V.clone(), touched_items=touched_item_rows,
            trace=ctxs)
        publish_s = time.perf_counter() - tp
        ctxs = [tracing.record_span(c, "live.publish", seconds=publish_s,
                                    seq=seq, mode=mode)
                if c is not None else None for c in ctxs]

        done = time.perf_counter()
        worst, worst_ctx = 0.0, None
        for a, c in zip(arrivals, ctxs):
            fr = done - float(a)
            obs.histogram("live.freshness_seconds", fr, **self._labels)
            # the terminal hop: this event's publish seq is visible to the
            # score path; its seconds are the freshness sample
            if c is not None:
                tracing.record_span(c, "live.visible", seconds=fr, seq=seq)
            if fr > worst:
                worst, worst_ctx = fr, c
        touched = len(touched_users) + (
            len(touched_item_rows) if touched_item_rows is not None else 0)
        obs.emit("live_update", seq=seq, events=len(ratings),
                 touched=touched, mode=mode, **self._labels)
        self.flight.record(
            "ok",
            {"queue_wait": queue_wait, "quarantine": quarantine_s,
             "foldin": foldin_s, "publish": publish_s},
            e2e_seconds=worst, seq=seq, mode=mode,
            trace_ids=sorted({c.trace_id for c in ctxs
                              if c is not None}) or None)
        if self.slo_s is not None and worst > self.slo_s:
            obs.emit("live_freshness_breach", seq=seq,
                     freshness_seconds=worst, slo_s=self.slo_s,
                     trace_id=(worst_ctx.trace_id
                               if worst_ctx is not None else None),
                     **self._labels)
            self.flight.dump("freshness_breach")
