"""Steady-state serving loop: batcher -> scorer -> response.

Counterpart of ``tpu_als/serving/engine.py``.  One background thread
drains the :class:`~tpu_als_torch.serving.batcher.MicroBatcher`, pads each
micro-batch to its bucket, scores it against the currently published
model and completes the tickets.  The routes, on the card:

- ``exact``: ``ops/cuda_topk.py::topk_scores``, kernel K5 for k <= 128
  (the counted scan above);
- ``int8`` (backend ``'local'``): the int8 candidate index
  (``serving/index.py``): a ``torch._int_mm`` shortlist, exact rescore;
- ``int8_sharded`` (backend ``'sharded'``): ``ShardedInt8Index`` over the
  mesh's logical shards;
- ``merge_ring`` (backend ``'merge_ring'``): kernel K8,
  ``cuda_topk.topk_merge_ring``, over a catalog placed once per publish
  as ``[S, ni_loc, r]`` with invalid padding rows (the layout of
  ``parallel/serve.py``); delta publishes refresh only the touched rows.

Pieces the rest of the stack plugs into, as the reference's:

- **Atomic publishes.**  :meth:`ServingEngine.publish` places the new
  tables on the device once and swaps one reference under a lock;
  in-flight batches finish against the old tables.  Callers hand their
  factors over and must not change them afterwards.
- **Stale-index detection.**  Each publish carries a sequence number; an
  index whose ``seq`` does not match the live model (a ``quantize=False``
  publish after a quantized one, or an injected ``serving.publish``
  corrupt) is never scored against: the batch takes the exact route and
  ``serving.fallback_exact`` counts it.
- **Incremental publishes.**  :meth:`ServingEngine.publish_update`
  re-tags the index for a user-only fold-in, re-quantizes only the
  touched or appended rows into the index's delta segment for an item
  fold-in, and compacts the segment past the cadence's threshold; every
  mode lands in ``serving.publish_seconds``.
- **Fault points.**  ``serving.publish`` fires inside publish (corrupt =
  the fresh index or placement is dropped before the swap);
  ``serving.score`` fires per batch (corrupt = treat the index as stale
  for this batch; raise = the error fails the batch's tickets).  These
  injected faults are the only reason a batch changes route: a kernel
  error on the card fails the batch's tickets, as any other error does.
- **Metrics, traces, flight recorder.**  Enqueue/score/e2e histograms,
  the queue-depth gauge, shed/expired/fallback counters, causal-trace
  spans (``obs/tracing.py``) and a bounded ring of per-request span
  breakdowns (``obs/trace.py``) dumped on an SLO breach, a shed or a
  degraded answer.
- **Host transfers.**  Each micro-batch is staged into one reusable
  ``[B, rank+2]`` float32 buffer (query rows | ids bitcast to int32 |
  row mask), in pinned host memory on the card, and uploaded as ONE
  transfer; the response comes back as ONE packed ``[B, 2k]`` float32
  transfer (scores | ids bitcast), and tickets complete with numpy views
  of it.

Where the port differs from the reference: the reference pins compiled
programs ahead of time in :meth:`~ServingEngine.warmup` and quietly
re-dispatches when a pin fails; PyTorch compiles nothing per shape, so
``warmup`` runs each (bucket, route) once (kernels built and loaded, the
allocator primed) and there is no re-dispatch.  The reference's
``'auto'`` backend probes the live TPU mesh for its merge kernel and is
``'sharded'`` elsewhere (on its CPU too); the port decides from the
shapes: ``'merge_ring'`` when ``k <= cuda_topk.MAX_K``, else
``'sharded'``.  Mesh backends keep the engine's own catalog handle on the
host, as the reference's, so the exact fallback uploads it per batch.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from tpu_als_torch import obs
from tpu_als_torch.obs import tracing
from tpu_als_torch.obs.trace import FlightRecorder
from tpu_als_torch.ops import cuda_topk
from tpu_als_torch.parallel.mesh import make_mesh
from tpu_als_torch.resilience import faults
from tpu_als_torch.serving.batcher import (
    DeadlineExceeded,
    MicroBatcher,
    Overloaded,
    bucket_for,
)
from tpu_als_torch.serving.index import Int8CandidateIndex, ShardedInt8Index
from tpu_als_torch.utils.platform import resolve_device

BACKENDS = ("auto", "local", "sharded", "merge_ring")


class NoModelPublished(RuntimeError):
    """A request arrived before the first :meth:`ServingEngine.publish`."""


class _Published:
    """One immutable model generation; the engine swaps whole instances.

    ``V``/``valid`` are device tensors on the local backend and host
    numpy on mesh backends; ``Vs``/``valids`` are the merge-ring
    backend's padded ``[S·ni_loc, ...]`` catalog on the device (``None``
    elsewhere, or after a torn merge-ring publish).
    """

    __slots__ = ("seq", "U", "V", "valid", "index", "n_users", "rank",
                 "Vs", "valids", "ni_loc")

    def __init__(self, seq, U, V, valid, index,
                 Vs=None, valids=None, ni_loc=0):
        self.seq = seq
        self.U = U
        self.V = V
        self.valid = valid
        self.index = index
        self.Vs = Vs
        self.valids = valids
        self.ni_loc = int(ni_loc)
        self.n_users = int(U.shape[0])
        self.rank = int(U.shape[1])


def _host_f32(X):
    if isinstance(X, torch.Tensor):
        return X.detach().to("cpu", torch.float32).numpy()
    return np.asarray(X, dtype=np.float32)


def _select_packed(U, packed):
    """Per-slot query rows from the staging layout: ``packed[:, :rank]``
    fold-in rows, ``packed[:, rank]`` int32 user ids (bitcast),
    ``packed[:, rank+1]`` the row mask."""
    rank = U.shape[1]
    ids = packed[:, rank].view(torch.int32).long()
    ids = ids.clamp(0, U.shape[0] - 1)   # pad slots point anywhere safe
    rowmask = packed[:, rank + 1] != 0.0
    return torch.where(rowmask[:, None], packed[:, :rank], U[ids])


def _pack_response(s, ix):
    """``(scores, ids)`` packed as ``[B, 2k]`` float32, ids bitcast, so
    the response comes back in one device-to-host transfer."""
    return torch.cat([s, ix.to(torch.int32).view(torch.float32)], dim=1)


def _scatter_catalog(Vs, valids, rows, vals, vmask):
    """Touched-rows refresh of the merge-ring catalog, out of place (in-
    flight batches keep reading the previous generation); only the
    touched payload crosses from the host."""
    dev = Vs.device
    ix = torch.from_numpy(rows).to(dev)
    return (Vs.index_put((ix,), torch.from_numpy(vals).to(dev)),
            valids.index_put((ix,), torch.from_numpy(vmask).to(dev)))


class ServingEngine:
    """Request-path serving over published ALS factors.

    ``k`` is the engine-wide top-k width; per-request ``k`` may be
    smaller and is trimmed at completion.  ``buckets`` are the padded
    batch shapes (default: ``plan.resolve_serving_buckets()``).
    ``slo_s``: end-to-end latency objective; a completed request slower
    than this dumps the flight recorder.  ``tenant`` labels every
    ``serving.*`` series and event this engine writes.  ``mesh`` with
    ``serve_backend`` in ``('auto', 'sharded', 'merge_ring')`` serves
    from the mesh's logical shards (module docstring).  ``device=None``
    is the card (the mesh's device with a mesh) and raises without CUDA;
    ``device='cpu'`` runs the kernels' plain versions.
    """

    def __init__(self, k=10, buckets=None, shortlist_k=64,
                 max_queue=1024, max_wait_s=0.002,
                 default_deadline_s=None, item_chunk=8192,
                 slo_s=None, flight_capacity=64, tenant=None,
                 mesh=None, serve_backend="auto", device=None):
        if serve_backend not in BACKENDS:
            raise ValueError(
                f"unknown serve_backend {serve_backend!r} (expected "
                "'auto', 'local', 'sharded' or 'merge_ring')")
        if mesh is None and serve_backend in ("sharded", "merge_ring"):
            raise ValueError(
                f"serve_backend={serve_backend!r} requires a mesh")
        if serve_backend == "merge_ring" and k > cuda_topk.MAX_K:
            raise ValueError(
                f"serve_backend='merge_ring' takes k <= {cuda_topk.MAX_K} "
                f"(K8's merged candidate sets), got k={k}; use 'sharded'")
        if mesh is not None:
            if device is not None and \
                    make_mesh(devices=[device]).device != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            self.device = mesh.device
        else:
            self.device = resolve_device(device)
        if buckets is None:
            from tpu_als_torch import plan

            buckets = plan.resolve_serving_buckets()
        self.k = int(k)
        self.shortlist_k = int(shortlist_k)
        self.item_chunk = int(item_chunk)
        self.slo_s = float(slo_s) if slo_s is not None else None
        self.tenant = str(tenant) if tenant is not None else None
        self._labels = {"tenant": self.tenant} if self.tenant else {}
        self.flight = FlightRecorder(flight_capacity, labels=self._labels)
        self.batcher = MicroBatcher(
            buckets=buckets, max_queue=max_queue, max_wait_s=max_wait_s,
            default_deadline_s=default_deadline_s, labels=self._labels)
        self._model = None              # _Published; swapped atomically
        self._publish_lock = threading.Lock()
        self._cadence = None            # resolved on first use
        self._seq = 0
        self._thread = None
        self._stopping = threading.Event()
        self.mesh = mesh
        self._backend_req = serve_backend
        # resolved at the first publish (where the reference emits its
        # serving_backend event); mesh-less engines are local
        self._backend = "local" if mesh is None else None
        self._stage = {}                # bucket -> reusable [B, rank+2]

    # -- backend resolution -------------------------------------------
    def _resolve_backend(self):
        """The scoring backend, chosen once per engine at the first
        publish: a request other than ``'auto'`` is taken as it is;
        ``'auto'`` on a mesh is ``'merge_ring'`` when K8 takes ``k``
        (``k <= cuda_topk.MAX_K``), else ``'sharded'``."""
        if self._backend is not None:
            return self._backend
        req = self._backend_req
        if req == "auto":
            req = "merge_ring" if self.k <= cuda_topk.MAX_K else "sharded"
        self._backend = req
        obs.emit("serving_backend", backend=req, n_shards=self.mesh.size,
                 **self._labels)
        return req

    def _build_index(self, V, valid, sk, seq):
        if self._backend == "sharded":
            return ShardedInt8Index(V, self.mesh, item_valid=valid,
                                    shortlist_k=sk, seq=seq)
        return Int8CandidateIndex(V, valid, shortlist_k=sk, seq=seq,
                                  device=self.device)

    def _place_sharded(self, Vh, validh):
        """The merge-ring catalog on the device: padded to ``S·ni_loc``
        rows, the padding rows invalid."""
        S = self.mesh.size
        Ni = int(Vh.shape[0])
        ni_loc = -(-Ni // S)
        cap = S * ni_loc
        Vs = torch.zeros((cap, Vh.shape[1]), dtype=torch.float32,
                         device=self.device)
        Vs[:Ni] = torch.from_numpy(Vh).to(self.device)
        valids = torch.zeros(cap, dtype=torch.bool, device=self.device)
        valids[:Ni] = torch.from_numpy(validh).to(self.device)
        return Vs, valids, ni_loc

    def _update_sharded(self, prev, Vh, valid_h, touched, Ni):
        """Incremental refresh of the merge-ring catalog: returns ``(Vs,
        valids, ni_loc, mode)``.  ``retag`` shares the previous placement,
        ``delta`` scatters only the touched/appended rows into it, and
        what the incremental path cannot express (first publish, torn
        predecessor, shrink, growth past the padded capacity, rows out
        of range) re-places the catalog whole (``full``)."""
        if prev is not None and prev.Vs is not None and prev.ni_loc > 0:
            cap = int(prev.Vs.shape[0])
            prev_ni = int(prev.V.shape[0])
            rows = np.union1d(touched, np.arange(prev_ni, Ni))
            if prev_ni <= Ni <= cap and (not rows.size
                                         or int(rows[-1]) < Ni):
                if not rows.size and Ni == prev_ni:
                    return prev.Vs, prev.valids, prev.ni_loc, "retag"
                Vs, valids = _scatter_catalog(
                    prev.Vs, prev.valids, rows,
                    np.ascontiguousarray(Vh[rows]),
                    np.ascontiguousarray(valid_h[rows]))
                return Vs, valids, prev.ni_loc, "delta"
            obs.emit("warning", what="serving.publish_update",
                     reason="sharded delta rejected (shrink, capacity "
                            "or out-of-range rows), full re-place")
        if Ni == 0:
            return None, None, 0, "none"
        Vs, valids, ni_loc = self._place_sharded(Vh, valid_h)
        return Vs, valids, ni_loc, "full"

    def _tables(self, U, V, item_valid):
        """``(U on the device, V host, valid host, V and valid as the
        backend keeps them)``."""
        U = torch.as_tensor(U).to(self.device, torch.float32).contiguous()
        Vh = _host_f32(V)
        Ni = int(Vh.shape[0])
        validh = (np.ones(Ni, dtype=bool) if item_valid is None
                  else np.asarray(item_valid, dtype=bool).ravel())
        if self._resolve_backend() == "local":
            V = torch.as_tensor(V).to(self.device, torch.float32) \
                .contiguous()
            return U, Vh, validh, V, torch.from_numpy(validh).to(
                self.device)
        return U, Vh, validh, Vh, validh

    # -- model lifecycle ----------------------------------------------
    def publish(self, U, V, item_valid=None, quantize=True):
        """Swap in a new model generation atomically.

        ``quantize=True`` builds the int8 candidate index for the new
        catalog (skipped when the catalog is smaller than ``k``);
        ``quantize=False`` serves exact until the next quantized publish
        (the old index, if any, is carried but stale and never used).
        Returns the publish sequence number.
        """
        t0 = time.perf_counter()
        mode = faults.check("serving.publish")
        U, Vh, validh, V, valid = self._tables(U, V, item_valid)
        Ni = int(Vh.shape[0])
        backend = self._backend
        with self._publish_lock:
            seq = self._seq + 1
            sk = min(max(self.shortlist_k, self.k), Ni)
            index, Vs, valids, ni_loc = None, None, None, 0
            if backend == "merge_ring":
                if mode != "corrupt" and Ni > 0:
                    Vs, valids, ni_loc = self._place_sharded(Vh, validh)
                # torn merge-ring publish: the fresh placement is
                # dropped, and the score path answers exact against the
                # fresh host catalog (counted as serving.fallback_exact)
            elif quantize and sk >= self.k and Ni > 0:
                index = self._build_index(V, valid, sk, seq)
                if mode == "corrupt":
                    # torn publish: the fresh index is never published;
                    # the previous generation's (stale by seq) is
                    # carried, or none on a first publish
                    index = (self._model.index
                             if self._model is not None else None)
            elif self._model is not None:
                index = self._model.index      # carried, now stale
            self._model = _Published(seq, U, V, valid, index,
                                     Vs=Vs, valids=valids, ni_loc=ni_loc)
            self._seq = seq
        fresh = bool((index is not None and index.seq == seq)
                     or Vs is not None)
        obs.counter("serving.publishes", **self._labels)
        obs.histogram("serving.publish_seconds", time.perf_counter() - t0,
                      mode="full" if fresh else "none", **self._labels)
        obs.emit("serving_publish", seq=seq, items=Ni, quantized=fresh,
                 mode="full" if fresh else "none", delta_rows=0,
                 **self._labels)
        return seq

    def publish_update(self, U, V, *, touched_items=None,
                       item_valid=None, trace=None):
        """Incremental publish after a fold-in: O(touched rows), not
        O(catalog).  Returns ``(seq, mode)``.

        ``touched_items``: logical catalog rows of ``V`` that changed
        since the live publish; rows beyond the previous catalog size
        are appended automatically.  The caller guarantees every other
        row of ``V`` is unchanged.  ``trace``: causal-trace contexts of
        the events this publish makes visible; their trace ids ride the
        ``serving_publish`` event.  Modes: ``retag`` (no catalog row
        changed: the index is carried fresh), ``delta`` (touched rows
        re-quantized into the delta segment), ``compact`` (the segment
        crossed the cadence's threshold and was folded back), ``full``
        (no usable live index, or an update the delta cannot express:
        rebuilt), ``none`` (catalog too small to index).
        """
        t0 = time.perf_counter()
        U, Vh, valid_h, V, valid = self._tables(U, V, item_valid)
        Ni = int(Vh.shape[0])
        backend = self._backend
        touched = (np.empty(0, dtype=np.int64) if touched_items is None
                   else np.unique(np.asarray(touched_items,
                                             dtype=np.int64).ravel()))
        cad = self._live_cadence()
        with self._publish_lock:
            seq = self._seq + 1
            prev = self._model
            cur = prev.index if prev is not None else None
            index, mode = None, "full"
            Vs, valids, ni_loc = None, None, 0
            if backend == "merge_ring":
                Vs, valids, ni_loc, mode = self._update_sharded(
                    prev, Vh, valid_h, touched, Ni)
            elif (cur is not None and cur.seq == prev.seq
                    and cur.n_items <= Ni):
                rows = np.union1d(touched, np.arange(cur.n_items, Ni))
                if touched.size == 0 and Ni == cur.n_items:
                    index, mode = cur.retag(seq), "retag"
                elif rows.size and (rows[0] < 0 or rows[-1] >= Ni):
                    obs.emit("warning", what="serving.publish_update",
                             reason="delta rejected, full rebuild: "
                                    f"touched rows outside the catalog "
                                    f"[0, {Ni})")
                else:
                    index = cur.with_updates(
                        rows, np.ascontiguousarray(Vh[rows]),
                        valid_rows=valid_h[rows], seq=seq)
                    mode = "delta"
                    if index.delta_count >= max(
                            cad["compact_min_rows"],
                            cad["compact_delta_frac"] * index.n_base):
                        index, mode = index.compact(seq), "compact"
            if index is None and backend != "merge_ring":
                sk = min(max(self.shortlist_k, self.k), Ni)
                if sk >= self.k and Ni > 0:
                    index = self._build_index(V, valid, sk, seq)
                else:
                    mode = "none"
            self._model = _Published(seq, U, V, valid, index,
                                     Vs=Vs, valids=valids, ni_loc=ni_loc)
            self._seq = seq
        obs.counter("serving.publishes", **self._labels)
        obs.histogram("serving.publish_seconds", time.perf_counter() - t0,
                      mode=mode, **self._labels)
        linked = ({"trace_ids": sorted({c.trace_id for c in trace
                                        if c is not None})}
                  if trace else {})
        obs.emit("serving_publish", seq=seq, items=Ni,
                 quantized=bool(index is not None), mode=mode,
                 delta_rows=(index.delta_count
                             if index is not None else 0),
                 **linked, **self._labels)
        return seq, mode

    def _live_cadence(self):
        if self._cadence is None:
            from tpu_als_torch import plan

            self._cadence = plan.resolve_live_cadence()
        return self._cadence

    @property
    def published_seq(self):
        m = self._model
        return m.seq if m is not None else 0

    @property
    def published_index(self):
        """The live generation's candidate index (None before the first
        publish or while serving exact)."""
        m = self._model
        return m.index if m is not None else None

    # -- scoring ------------------------------------------------------
    def _exact(self, m, Ub):
        # mesh backends keep V on the host: uploaded per batch, rare by
        # construction
        Vd = torch.as_tensor(m.V).to(self.device)
        validd = torch.as_tensor(m.valid).to(self.device)
        ic = min(self.item_chunk, max(int(Vd.shape[0]), 1))
        return cuda_topk.topk_scores(Ub, Vd, validd, self.k,
                                     item_chunk=ic)

    def _merge_ring(self, m, Ub):
        S = self.mesh.size
        k_eff = min(self.k, int(m.V.shape[0]))
        return cuda_topk.topk_merge_ring(
            Ub, m.Vs.view(S, m.ni_loc, m.rank),
            m.valids.view(S, m.ni_loc), k_eff)

    def _route(self, m, mode):
        """``(path, fell_back)`` for a batch against generation ``m``
        with the ``serving.score`` fault mode ``mode``."""
        if self._backend == "merge_ring":
            if m.Vs is not None and mode != "corrupt":
                return "merge_ring", False
            return "exact", True
        index = m.index
        use_index = (index is not None and index.seq == m.seq
                     and mode != "corrupt")
        if not use_index:
            return "exact", index is not None
        return ("int8_sharded" if isinstance(index, ShardedInt8Index)
                else "int8"), False

    def _score(self, m, packed, path):
        """The packed ``[B, 2k']`` response of one staged batch."""
        Ub = _select_packed(m.U, packed)
        if path == "merge_ring":
            s, ix = self._merge_ring(m, Ub)
        elif path == "exact":
            s, ix = self._exact(m, Ub)
        else:
            s, ix = m.index.topk(Ub, self.k)
        return _pack_response(s, ix)

    def warmup(self):
        """Run every (bucket, route) once against the published model,
        the exact route included (it backs every fallback), so the
        kernels are built and loaded and the allocator holds the
        shapes before the first request.  Records no metrics (a warmup
        sample in the latency histograms would poison the tail)."""
        m = self._model
        if m is None:
            raise NoModelPublished("publish(U, V) before warmup")
        path, _ = self._route(m, None)
        for B in self.batcher.buckets:
            proto = torch.zeros((B, m.rank + 2), dtype=torch.float32,
                                device=self.device)
            for p in {path, "exact"}:
                self._score(m, proto, p).cpu()

    def warmup_live(self, max_delta_rows=None):
        """Run the delta-segment route for every (bucket, delta size)
        incremental publishes can produce, powers of two up to
        ``max_delta_rows`` (default: the cadence's compaction threshold
        plus one ``max_batch``), before any live traffic.  A no-op when
        the model serves exact."""
        m = self._model
        if m is None:
            raise NoModelPublished("publish(U, V) before warmup")
        idx = m.index
        if idx is None or idx.seq != m.seq:
            return
        if max_delta_rows is None:
            cad = self._live_cadence()
            max_delta_rows = int(
                max(cad["compact_min_rows"],
                    cad["compact_delta_frac"] * idx.n_base)
                + cad["max_batch"])
        Vh = _host_f32(m.V)
        d = 1
        while d <= min(max_delta_rows * 2 - 1, idx.n_items):
            rows = np.arange(d, dtype=np.int64)
            dummy = idx.with_updates(
                rows, np.ascontiguousarray(Vh[rows]), seq=idx.seq)
            for B in self.batcher.buckets:
                proto = torch.zeros((B, m.rank + 2), dtype=torch.float32,
                                    device=self.device)
                s, ix = dummy.topk(_select_packed(m.U, proto), self.k)
                _pack_response(s, ix).cpu()
            d <<= 1

    # -- request path -------------------------------------------------
    def submit(self, payload, k=None, deadline_s=None):
        """Admit one request; returns its ticket (see ``Ticket.result``).

        ``payload``: int user index into the published user table, or a
        rank-length f32 vector (fold-in row).  Raises ``Overloaded``
        when shedding, ``NoModelPublished`` before the first publish,
        ``ValueError`` on a malformed payload.
        """
        t_enter = time.perf_counter()
        m = self._model
        if m is None:
            raise NoModelPublished("publish(U, V) before submitting")
        if k is not None and not 0 < k <= self.k:
            raise ValueError(f"per-request k={k} must be in 1..{self.k} "
                             "(the engine's top-k width)")
        if isinstance(payload, (int, np.integer)):
            if not 0 <= payload < m.n_users:
                raise ValueError(f"user index {payload} outside the "
                                 f"published table [0, {m.n_users})")
        else:
            payload = np.asarray(payload, dtype=np.float32)
            if payload.shape != (m.rank,):
                raise ValueError(
                    f"fold-in payload shape {payload.shape} != "
                    f"({m.rank},) (the published rank)")
        # root span BEFORE enqueue: the consumer thread may dequeue the
        # ticket the instant submit releases the lock (None when tracing
        # is disarmed: the whole chain no-ops off that None)
        ctx = tracing.start_trace(
            "serve.admit", tenant=self.tenant,
            seconds=time.perf_counter() - t_enter)
        try:
            t = self.batcher.submit(payload, k=k, deadline_s=deadline_s,
                                    trace=ctx)
        except Overloaded:
            # a shed never queues: its trace is the admission span plus
            # a queue hop with status="shed"
            tracing.record_span(ctx, "serve.queue", status="shed",
                                seconds=0.0)
            self.flight.record(
                "shed", {"admission": time.perf_counter() - t_enter},
                trace_id=(ctx.trace_id if ctx is not None else None))
            self.flight.dump("shed")
            raise
        t.t_admit = time.perf_counter() - t_enter
        obs.counter("serving.requests", **self._labels)
        return t

    def recommend(self, payload, k=None, deadline_s=None, timeout=None):
        """Submit + block: returns ``(scores, indices)`` for one request."""
        return self.submit(payload, k=k,
                           deadline_s=deadline_s).result(timeout)

    # -- engine loop --------------------------------------------------
    def start(self):
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._stopping.clear()
        self._thread = threading.Thread(
            target=self._run, name="tpu-als-torch-serving", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain_timeout_s=5.0):
        """Close admission, drain in-flight batches, join the loop."""
        self.batcher.close()
        self._stopping.set()
        if self._thread is not None:
            self._thread.join(drain_timeout_s)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _run(self):
        while True:
            batch = self.batcher.next_batch(timeout=0.1)
            if batch is None:
                if self._stopping.is_set():
                    return
                continue
            try:
                self.serve_batch(batch)
            except Exception as e:  # the loop must survive; tickets resolve
                for t in batch:
                    if not t.done():
                        t.fail(e)
                        if t.trace is not None:
                            t.trace = tracing.record_span(
                                t.trace, "serve.score", status="failed",
                                error=type(e).__name__)
                        self.flight.record(
                            "failed",
                            {"admission": t.t_admit,
                             "queue_wait": (t.t_dequeue - t.t_submit
                                            if t.t_dequeue else None)},
                            error=type(e).__name__,
                            trace_id=(t.trace.trace_id
                                      if t.trace is not None else None))
                if not isinstance(e, faults.InjectedFault):
                    obs.emit("warning", what="serving.batch",
                             reason=f"{type(e).__name__}: {e}")

    def _staging(self, B, rank):
        """The reusable ``[B, rank+2]`` staging buffer of bucket ``B``
        (pinned host memory on the card)."""
        st = self._stage.get(B)
        if st is None or st.shape[1] != rank + 2:
            st = torch.zeros((B, rank + 2), dtype=torch.float32,
                             pin_memory=self.device.type == "cuda")
            self._stage[B] = st
        return st

    def serve_batch(self, batch):
        """Score one dequeued micro-batch and complete its tickets.

        Public so tests and synchronous callers can drive the engine
        without the background thread.
        """
        now = time.perf_counter()
        live = []
        for t in batch:
            if t.deadline is not None and now > t.deadline:
                obs.counter("serving.expired", **self._labels)
                if t.trace is not None:
                    t.trace = tracing.record_span(
                        t.trace, "serve.expired", status="expired",
                        seconds=now - t.t_submit)
                self.flight.record(
                    "expired",
                    {"admission": t.t_admit,
                     "queue_wait": (t.t_dequeue - t.t_submit
                                    if t.t_dequeue else None)},
                    e2e_seconds=now - t.t_submit,
                    trace_id=(t.trace.trace_id
                              if t.trace is not None else None))
                t.fail(DeadlineExceeded(
                    "deadline passed while queued "
                    f"({now - t.t_submit:.4f}s since submit)"))
            else:
                live.append(t)
        if not live:
            return
        mode = faults.check("serving.score")   # raise-mode -> _run fails all
        m = self._model
        n = len(live)
        B = bucket_for(n, self.batcher.buckets)
        st = self._staging(B, m.rank)
        a = st.numpy()
        idcol = a[:, m.rank].view(np.int32)   # same-itemsize view
        for j, t in enumerate(live):
            if isinstance(t.payload, (int, np.integer)):
                idcol[j] = t.payload
                a[j, m.rank + 1] = 0.0
            else:
                a[j, :m.rank] = t.payload
                a[j, m.rank + 1] = 1.0
        # pad slots: stale ids/masks from the previous batch would change
        # which (unread) pad rows get scored — zero them
        idcol[n:] = 0
        a[n:, m.rank + 1] = 0.0
        obs.histogram("serving.batch_rows", n, **self._labels)

        t0 = time.perf_counter()
        # ONE host->device transfer; the response's blocking copy below
        # completes it before the buffer is staged again
        packed = st.to(self.device, non_blocking=True)
        path, fell_back = self._route(m, mode)
        if fell_back:
            obs.counter("serving.fallback_exact", n, **self._labels)
        # ONE device->host transfer; tickets complete with numpy views
        resp = self._score(m, packed, path).cpu().numpy()
        kw = resp.shape[1] // 2
        scores = resp[:, :kw]
        indices = resp[:, kw:].view(np.int32)  # same-itemsize view
        score_s = time.perf_counter() - t0
        obs.histogram("serving.score_seconds", score_s, path=path,
                      **self._labels)
        done = time.perf_counter()
        breached = False
        for j, t in enumerate(live):
            kk = min(t.k or self.k, kw)
            t.complete((scores[j, :kk], indices[j, :kk]))
            e2e = done - t.t_submit
            obs.histogram("serving.e2e_seconds", e2e, **self._labels)
            if t.trace is not None:
                t.trace = tracing.record_span(
                    t.trace, "serve.score", seconds=score_s, path=path)
            # the rescore runs inside index.topk with the shortlist and
            # is not timed apart from it: None records that
            self.flight.record(
                "ok",
                {"admission": t.t_admit,
                 "queue_wait": (t.t_dequeue - t.t_submit
                                if t.t_dequeue else None),
                 "score": score_s,
                 "respond": time.perf_counter() - done},
                e2e_seconds=e2e, path=path,
                trace_id=(t.trace.trace_id
                          if t.trace is not None else None))
            if self.slo_s is not None and e2e > self.slo_s:
                breached = True
        if breached:
            self.flight.dump("slo_breach")
        elif fell_back:
            self.flight.dump("degraded")
