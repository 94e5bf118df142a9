"""Int8 candidate index: a quantized shortlist, then an exact f32 rescore.

Counterpart of ``tpu_als/serving/index.py``.  At serving batch sizes the
exact top-k (K5, ``ops/cuda_topk.py``) reads the whole f32 item table per
request batch.  Symmetric per-row int8 quantization cuts the bytes of
that pass 4x: the shortlist GEMM runs int8 x int8 -> int32, and the top
``shortlist_k`` candidates are rescored in f32.

The shortlist GEMM is ``torch._int_mm``, a library call, as the
reference leaves its int8 einsum to XLA outside every Pallas kernel.  On
CUDA it takes more than 16 rows and inner and outer dimensions that are
multiples of 8, so :func:`_int8_mm` pads the query rows (to at least
:data:`MIN_GEMM_ROWS`), the rank and the catalog columns with zeros and
slices the result: zero rows and columns add nothing to an int32 sum, so
the result stays exact.

Contracts (held by ``tests/test_torch_serving_index.py``):

- ``_quantize_rows`` and the approximate scores ``acc.float() * su *
  sv`` (the reference's order) are bitwise the reference's on the CPU;
  the shortlist and the final k are selected by ``ops/topk.py::
  stable_topk``, ``lax.top_k``'s tie order, so the candidate sets match;
- the rescore keeps the reference's ``nr,cr->nc`` contraction at the
  ``[n, n·shortlist_k]`` shape (the full query batch against the
  gathered candidate columns), so delta-segment and compacted ``topk``
  are bitwise a full :func:`build_index` rebuild within the port;
- against the exact path there is no bitwise promise: on the card the
  exact path is K5's 3xTF32 scan and the rescore an fp32 cuBLAS product
  (TF32 off, ``utils/platform.py::pin_fp32``), and two contraction shapes
  may differ in the last place.  Scores agree within a few ulps, every
  id earns its score, and with ``shortlist_k >= n_items`` the score sets
  are the same.

Incremental re-quantization (the live fold-in -> publish loop):
:meth:`Int8CandidateIndex.with_updates` quantizes only the touched or
appended rows into a small delta segment layered over the untouched base
arrays, and :meth:`compact` folds the segment back (a scatter, nothing
re-quantized).  Per-row quantization has no cross-row state and the
int32 accumulation is exact, so both score bitwise as a rebuild would;
base rows the segment overrides are masked to ``NEG_INF`` in the base
GEMM, so a row is never scored twice or stale.

The index is immutable: every method returns a new index and shares the
arrays it did not change.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpu_als_torch.core.ratings import _next_pow2
from tpu_als_torch.ops.topk import NEG_INF, stable_topk
from tpu_als_torch.utils.platform import resolve_device

# torch._int_mm on CUDA takes more than 16 rows; query batches are
# padded to at least this many (a multiple of 8)
MIN_GEMM_ROWS = 24


# float32(1 / 127): the constant XLA's division by 127 multiplies by
_INV_127 = float(np.float32(1.0 / 127.0))


def _ceil8(n):
    return -(-n // 8) * 8


def _quantize_rows(X):
    """Symmetric per-row int8: scale = max|row| / 127 (zero rows get
    scale 1 so the division is safe and the row quantizes to zeros).

    The reference's XLA turns the division by the constant 127 into a
    product with its float32 reciprocal; the port multiplies by that same
    constant, so the scales are bitwise the reference's."""
    s = X.abs().amax(dim=1) * _INV_127
    s = torch.where(s == 0.0, 1.0, s).to(torch.float32)
    q = torch.clamp(torch.round(X / s[:, None]), -127, 127).to(torch.int8)
    return q, s


def _int8_mm(Uq, Vq):
    """``Uq [n, r] @ Vq[c, r].T`` in int8 -> int32, exact: both operands
    zero-padded to the shapes ``torch._int_mm`` takes on CUDA (see the
    module docstring), the result sliced back."""
    n, r = Uq.shape
    c = Vq.shape[0]
    m, rp, cp = max(MIN_GEMM_ROWS, _ceil8(n)), _ceil8(r), _ceil8(c)
    A = F.pad(Uq, (0, rp - r, 0, m - n))
    B = Vq if (cp, rp) == (c, r) else F.pad(Vq, (0, rp - r, 0, cp - c))
    return torch._int_mm(A, B.T)[:n, :c]


def _approx(acc, su, sv):
    # the reference's order: (acc * su) * sv, in f32
    return acc.float() * su[:, None] * sv[None, :]


def _rescore(U, Vc, n, sk):
    """The exact f32 scores of the ``n·sk`` candidate rows ``Vc``: the
    full query batch against every candidate column (``nr,cr->nc``, the
    reference's shape), then each row's own ``sk`` columns."""
    exact_all = U @ Vc.T                                  # [n, n*sk]
    rows = (torch.arange(n, device=U.device)[:, None] * sk
            + torch.arange(sk, device=U.device)[None, :])
    return torch.gather(exact_all, 1, rows)


def _int8_topk(U, Vq, sv, V, valid, k, shortlist_k):
    n = U.shape[0]
    Uq, su = _quantize_rows(U)
    approx = _approx(_int8_mm(Uq, Vq), su, sv)
    approx = torch.where(valid[None, :], approx, NEG_INF)
    _, cand = stable_topk(approx, shortlist_k)             # [n, sk]
    exact = _rescore(U, V[cand.reshape(-1)], n, shortlist_k)
    exact = torch.where(valid[cand], exact, NEG_INF)
    s, sel = stable_topk(exact, k)
    return s, torch.gather(cand, 1, sel)


def _int8_topk_delta(U, Vq, sv, V, valid, drows, dVq, dsv, dV, dvalid,
                     last_id, k, shortlist_k):
    """The base route with a delta segment: two int8 GEMMs (base +
    segment), overridden base columns masked, one shortlist over the
    concatenated approximate scores, and the same-shaped exact rescore.

    ``drows`` maps segment slots to logical catalog ids; padding slots
    carry ``n_base`` (out of the base's range, ``dvalid`` False).
    ``last_id`` clamps returned ids into the logical catalog."""
    n = U.shape[0]
    nb = Vq.shape[0]
    d = dVq.shape[0]
    Uq, su = _quantize_rows(U)
    # a base row the segment overrides (an appended id is out of the
    # base's range and dropped) never shortlists from its stale value
    over = torch.zeros(nb, dtype=torch.bool, device=U.device)
    over[drows[drows < nb]] = True
    base_ok = valid & ~over
    approx_b = torch.where(base_ok[None, :],
                           _approx(_int8_mm(Uq, Vq), su, sv), NEG_INF)
    approx_d = torch.where(dvalid[None, :],
                           _approx(_int8_mm(Uq, dVq), su, dsv), NEG_INF)
    _, cand = stable_topk(torch.cat([approx_b, approx_d], dim=1),
                          shortlist_k)                    # positions in nb+d
    flat = cand.reshape(-1)
    in_base = flat < nb
    base_ix = flat.clamp(max=nb - 1)
    delta_ix = (flat - nb).clamp(0, d - 1)
    Vc = torch.where(in_base[:, None], V[base_ix], dV[delta_ix])
    exact = _rescore(U, Vc, n, shortlist_k)
    cand_ok = torch.where(in_base, base_ok[base_ix], dvalid[delta_ix])
    exact = torch.where(cand_ok.view(n, shortlist_k), exact, NEG_INF)
    s, sel = stable_topk(exact, k)
    logical = torch.where(in_base, flat, drows[delta_ix])
    logical = logical.clamp(max=last_id).view(n, shortlist_k)
    return s, torch.gather(logical, 1, sel)


def _device_of(V, device):
    """``device`` when given; else a tensor's own device; else the card
    (``resolve_device``: raises without CUDA)."""
    if device is None and isinstance(V, torch.Tensor):
        return V.device
    return resolve_device(device)


def _check_k(k, sk):
    if k > sk:
        raise ValueError(
            f"k={k} exceeds shortlist_k={sk}; the shortlist must "
            "contain at least k candidates")


class Int8CandidateIndex:
    """Quantize-once-per-publish candidate index over the item factors.

    Built by :meth:`ServingEngine.publish` (or directly from ``V``);
    ``seq`` tags the model publish the index belongs to, so the engine
    can detect a stale index and answer exact instead.  ``device=None``
    takes ``V``'s device when ``V`` is a tensor, else the card.
    """

    def __init__(self, V, item_valid=None, shortlist_k=64, seq=0,
                 device=None):
        dev = _device_of(V, device)
        V = torch.as_tensor(V).to(device=dev, dtype=torch.float32)
        Ni = int(V.shape[0])
        if Ni == 0:
            raise ValueError("cannot index an empty catalog")
        self.V = V.contiguous()
        self.valid = (torch.ones(Ni, dtype=torch.bool, device=dev)
                      if item_valid is None else
                      torch.as_tensor(item_valid).to(dev, torch.bool))
        self.Vq, self.sv = _quantize_rows(self.V)
        self.n_items = Ni
        self.shortlist_k = min(int(shortlist_k), Ni)
        self.seq = seq
        self._clear_delta()

    @property
    def device(self):
        return self.V.device

    # -- delta segment (incremental re-quantization) -------------------

    def _clear_delta(self):
        # host-side merged delta state (O(delta rows)); the padded device
        # mirrors the scoring reads are built lazily
        r = int(self.V.shape[1])
        self.d_rows = np.empty(0, dtype=np.int64)
        self._dV = np.empty((0, r), dtype=np.float32)
        self._dVq = np.empty((0, r), dtype=np.int8)
        self._dsv = np.empty(0, dtype=np.float32)
        self._dvalid = np.empty(0, dtype=bool)
        self._dev_delta = None

    @property
    def n_base(self):
        """Rows held by the base (pre-delta) arrays."""
        return int(self.Vq.shape[0])

    @property
    def delta_count(self):
        """Rows currently carried by the delta segment."""
        return int(self.d_rows.size)

    def _copy_shell(self, seq):
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)   # every array shared
        new.seq = self.seq if seq is None else int(seq)
        return new

    def retag(self, seq):
        """A shallow copy sharing every array, tagged for a new publish
        (a user fold-in changes no catalog row)."""
        return self._copy_shell(seq)

    def with_updates(self, rows, V_rows, valid_rows=None, seq=None):
        """A new index with ``rows`` of the catalog re-quantized into
        the delta segment, the base arrays shared untouched.

        ``rows`` are logical catalog ids; ids ``>= n_items`` append and
        must leave no hole above the current catalog size.  A row already
        in the segment is replaced (newest wins)."""
        rows = np.asarray(rows, dtype=np.int64).ravel()
        r = int(self.V.shape[1])
        V_rows = np.asarray(V_rows, dtype=np.float32).reshape(len(rows), r)
        valid_rows = (np.ones(len(rows), dtype=bool) if valid_rows is None
                      else np.asarray(valid_rows, dtype=bool).ravel())
        if len(rows) == 0:
            return self._copy_shell(seq)
        if rows.min() < 0:
            raise ValueError("negative catalog row id in delta update")
        # newest-wins dedup inside the call: keep each id's LAST row
        uniq, first_rev = np.unique(rows[::-1], return_index=True)
        last = len(rows) - 1 - first_rev
        rows, V_rows, valid_rows = uniq, V_rows[last], valid_rows[last]
        n_new = int(max(self.n_items, int(rows.max()) + 1))
        appended = rows[rows >= self.n_items]
        if len(appended) != n_new - self.n_items:
            gap = sorted(set(range(self.n_items, n_new))
                         - set(appended.tolist()))
            raise ValueError(
                f"append gap: ids {gap} missing — appended rows must "
                "be contiguous above the current catalog")
        # quantize ONLY the touched rows (per-row: bitwise a rebuild's)
        q, s = _quantize_rows(torch.from_numpy(V_rows))
        q, s = q.numpy(), s.numpy()
        new = self._copy_shell(seq)
        new.n_items = n_new
        if self.d_rows.size:       # merge: older entries for the same
            keep = ~np.isin(self.d_rows, rows)   # id are superseded
            new.d_rows = np.concatenate([self.d_rows[keep], rows])
            new._dV = np.concatenate([self._dV[keep], V_rows])
            new._dVq = np.concatenate([self._dVq[keep], q])
            new._dsv = np.concatenate([self._dsv[keep], s])
            new._dvalid = np.concatenate([self._dvalid[keep], valid_rows])
        else:
            new.d_rows, new._dV, new._dVq = rows, V_rows, q
            new._dsv, new._dvalid = s, valid_rows
        new._dev_delta = None
        return new

    def _scatter_delta(self, V, Vq, sv, valid):
        """The base arrays with the segment's rows placed (out of place:
        the arrays this index shares stay as they are)."""
        dev = self.device
        ix = torch.from_numpy(self.d_rows).to(dev)
        return (V.index_put((ix,), torch.from_numpy(self._dV).to(dev)),
                Vq.index_put((ix,), torch.from_numpy(self._dVq).to(dev)),
                sv.index_put((ix,), torch.from_numpy(self._dsv).to(dev)),
                valid.index_put((ix,),
                                torch.from_numpy(self._dvalid).to(dev)))

    def compact(self, seq=None):
        """Fold the delta segment back into the base arrays: the
        segment's quantized rows are placed, nothing is re-quantized, and
        the arrays equal a :func:`build_index` of the updated catalog."""
        if not self.d_rows.size:
            return self._copy_shell(seq)
        r = int(self.V.shape[1])
        grow = self.n_items - self.n_base
        V, Vq, sv, valid = self.V, self.Vq, self.sv, self.valid
        if grow:
            V = torch.cat([V, V.new_zeros((grow, r))])
            Vq = torch.cat([Vq, Vq.new_zeros((grow, r))])
            sv = torch.cat([sv, sv.new_ones(grow)])
            valid = torch.cat([valid, valid.new_zeros(grow)])
        new = self._copy_shell(seq)
        new.V, new.Vq, new.sv, new.valid = self._scatter_delta(V, Vq, sv,
                                                               valid)
        new._clear_delta()
        return new

    def _device_delta(self):
        """Device mirrors of the segment, padded to a power of two as the
        reference's (padding slots carry id ``n_base``, out of the base's
        range, and ``valid=False``); built once per delta generation."""
        if self._dev_delta is None:
            d = self.delta_count
            d_pad = _next_pow2(d)
            r = int(self.V.shape[1])
            rows = np.full(d_pad, self.n_base, dtype=np.int64)
            rows[:d] = self.d_rows
            dV = np.zeros((d_pad, r), dtype=np.float32)
            dV[:d] = self._dV
            dVq = np.zeros((d_pad, r), dtype=np.int8)
            dVq[:d] = self._dVq
            dsv = np.ones(d_pad, dtype=np.float32)
            dsv[:d] = self._dsv
            dvalid = np.zeros(d_pad, dtype=bool)
            dvalid[:d] = self._dvalid
            dev = self.device
            self._dev_delta = tuple(torch.from_numpy(a).to(dev) for a in
                                    (rows, dVq, dsv, dV, dvalid))
        return self._dev_delta

    def block_until_ready(self):
        """Wait for the index's device (its tensors, the delta segment's
        mirrors included, are built on it): a CUDA index synchronizes its
        card, a CPU index has nothing to wait for.  Returns the index."""
        if self.delta_count:
            self._device_delta()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def nbytes_quantized(self):
        """Bytes the shortlist pass reads a batch (a quarter of the f32
        table's): the int8 rows and f32 scales of the base, and r + 4 a
        delta row."""
        base = self.Vq.numel() + 4 * self.n_base
        return base + self.delta_count * (int(self.V.shape[1]) + 4)

    def _shortlist(self, k, shortlist_k):
        sk = self.shortlist_k if shortlist_k is None else \
            min(int(shortlist_k), self.n_items)
        _check_k(k, sk)
        return sk

    def topk(self, U, k, shortlist_k=None):
        """Top-k of ``U @ V.T`` via the int8 shortlist and the exact f32
        rescore: ``(scores [n, k] f32, ids [n, k] int64)``.  ``k`` is
        capped by the shortlist, the shortlist by the catalog; with a
        delta segment live the shortlist runs over base + segment."""
        sk = self._shortlist(k, shortlist_k)
        U = torch.as_tensor(U).to(self.device, torch.float32)
        if not self.delta_count:
            return _int8_topk(U, self.Vq, self.sv, self.V, self.valid,
                              int(k), sk)
        drows, dVq, dsv, dV, dvalid = self._device_delta()
        return _int8_topk_delta(
            U, self.Vq, self.sv, self.V, self.valid,
            drows, dVq, dsv, dV, dvalid, self.n_items - 1, int(k), sk)


def build_index(V, item_valid=None, shortlist_k=64, seq=0, device=None):
    """Full rebuild: quantize the entire catalog from scratch (the
    reference :meth:`Int8CandidateIndex.with_updates` and :meth:`compact`
    are held against)."""
    return Int8CandidateIndex(V, item_valid=item_valid,
                              shortlist_k=shortlist_k, seq=seq,
                              device=device)


class ShardedInt8Index(Int8CandidateIndex):
    """:class:`Int8CandidateIndex` with the catalog cut over a mesh's S
    shards (``parallel/mesh.py``: logical shards on one device).

    The base arrays are padded to ``S·ni_loc`` rows (padding rows
    invalid); shard s holds rows ``[s·ni_loc, (s+1)·ni_loc)``.  Each
    shard runs the local route's shortlist and rescore over its own rows
    only; the replicated delta segment is scored by every shard but
    masked to the rows it owns (``row // ni_loc == s``), so each delta
    row is scored once.  Each shard's top ``k_loc`` is concatenated in
    shard order and reduced with one stable top-k, as the reference's
    merge.  Growth past ``S·ni_loc`` rebuilds (:meth:`with_updates`).
    """

    def __init__(self, V, mesh, item_valid=None, shortlist_k=64, seq=0):
        dev = mesh.device
        V = torch.as_tensor(V).to(device=dev, dtype=torch.float32)
        Ni = int(V.shape[0])
        if Ni == 0:
            raise ValueError("cannot index an empty catalog")
        D = mesh.size
        ni_loc = -(-Ni // D)
        cap = D * ni_loc
        valid = (torch.ones(Ni, dtype=torch.bool, device=dev)
                 if item_valid is None else
                 torch.as_tensor(item_valid).to(dev, torch.bool).ravel())
        self.mesh = mesh
        self.n_shards = D
        self.ni_loc = ni_loc
        self.V = F.pad(V, (0, 0, 0, cap - Ni)).contiguous()
        self.valid = F.pad(valid, (0, cap - Ni))
        self.Vq, self.sv = _quantize_rows(self.V)
        self.n_items = Ni
        self.shortlist_k = min(int(shortlist_k), Ni)
        self.seq = seq
        self._clear_delta()

    @property
    def capacity(self):
        """Catalog ids the sharded base can hold without re-striding."""
        return self.n_base

    def with_updates(self, rows, V_rows, valid_rows=None, seq=None):
        rows_a = np.asarray(rows, dtype=np.int64).ravel()
        if rows_a.size and int(rows_a.max()) >= self.capacity:
            return self._regrown(rows_a, V_rows, valid_rows, seq)
        return super().with_updates(rows, V_rows, valid_rows, seq)

    def _regrown(self, rows, V_rows, valid_rows, seq):
        """Growth past the shard stride moves every id's owning shard:
        rebuild the sharded base at the grown size."""
        if rows.min() < 0:
            raise ValueError("negative catalog row id in delta update")
        r = int(self.V.shape[1])
        V_rows = np.asarray(V_rows, dtype=np.float32).reshape(len(rows), r)
        valid_rows = (np.ones(len(rows), dtype=bool) if valid_rows is None
                      else np.asarray(valid_rows, dtype=bool).ravel())
        base = self.compact() if self.d_rows.size else self
        n_new = int(max(self.n_items, int(rows.max()) + 1))
        missing = sorted(set(range(self.n_items, n_new))
                         - set(rows[rows >= self.n_items].tolist()))
        if missing:
            raise ValueError(
                f"append gap: ids {missing} missing — appended rows "
                "must be contiguous above the current catalog")
        V_full = np.zeros((n_new, r), dtype=np.float32)
        V_full[:self.n_items] = base.V[:self.n_items].cpu().numpy()
        valid_full = np.zeros(n_new, dtype=bool)
        valid_full[:self.n_items] = base.valid[:self.n_items].cpu().numpy()
        # numpy fancy assignment keeps the LAST duplicate: newest wins
        V_full[rows] = V_rows
        valid_full[rows] = valid_rows
        return type(self)(V_full, self.mesh, item_valid=valid_full,
                          shortlist_k=self.shortlist_k,
                          seq=self.seq if seq is None else int(seq))

    def compact(self, seq=None):
        """Fold the delta into the sharded base (its capacity always
        covers ``n_items``: see :meth:`_regrown`)."""
        if not self.d_rows.size:
            return self._copy_shell(seq)
        new = self._copy_shell(seq)
        new.V, new.Vq, new.sv, new.valid = self._scatter_delta(
            self.V, self.Vq, self.sv, self.valid)
        new._clear_delta()
        return new

    def topk(self, U, k, shortlist_k=None):
        """Top-k of ``U @ V.T`` scored shard by shard, then merged."""
        sk = self._shortlist(k, shortlist_k)
        U = torch.as_tensor(U).to(self.device, torch.float32)
        n = U.shape[0]
        nl = self.ni_loc
        has_delta = bool(self.delta_count)
        d_pad = _next_pow2(self.delta_count) if has_delta else 0
        sk_loc = min(sk, nl + d_pad)
        k_loc = min(int(k), sk_loc)
        Uq, su = _quantize_rows(U)
        if has_delta:
            drows, dVq, dsv, dV, dvalid = self._device_delta()
            approx_dall = _approx(_int8_mm(Uq, dVq), su, dsv)
        out_s, out_i = [], []
        for me in range(self.n_shards):
            lo = me * nl
            sl = slice(lo, lo + nl)
            approx = _approx(_int8_mm(Uq, self.Vq[sl]), su, self.sv[sl])
            if has_delta:
                idx = drows - lo                  # local slot, if owned
                owned = (idx >= 0) & (idx < nl)
                # overridden base rows mask regardless of dvalid; nl is
                # the out-of-range sentinel
                over = torch.zeros(nl + 1, dtype=torch.bool,
                                   device=U.device)
                over[torch.where(owned, idx, nl)] = True
                base_ok = self.valid[sl] & ~over[:nl]
                dmask = dvalid & owned
                approx = torch.cat(
                    [torch.where(base_ok[None, :], approx, NEG_INF),
                     torch.where(dmask[None, :], approx_dall, NEG_INF)],
                    dim=1)
            else:
                base_ok = self.valid[sl]
                approx = torch.where(base_ok[None, :], approx, NEG_INF)
            _, cand = stable_topk(approx, sk_loc)
            flat = cand.reshape(-1)
            if has_delta:
                d = dVq.shape[0]
                in_base = flat < nl
                base_ix = flat.clamp(max=nl - 1)
                delta_ix = (flat - nl).clamp(0, d - 1)
                Vc = torch.where(in_base[:, None], self.V[lo + base_ix],
                                 dV[delta_ix])
                cand_ok = torch.where(in_base, base_ok[base_ix],
                                      dmask[delta_ix])
                gid = torch.where(in_base, flat + lo, drows[delta_ix])
            else:
                Vc = self.V[lo + flat]
                cand_ok = base_ok[flat]
                gid = flat + lo
            exact = _rescore(U, Vc, n, sk_loc)
            exact = torch.where(cand_ok.view(n, sk_loc), exact, NEG_INF)
            s, sel = stable_topk(exact, k_loc)
            out_s.append(s)
            out_i.append(torch.gather(gid.view(n, sk_loc), 1, sel))
        cat_s = torch.cat(out_s, dim=1)
        cat_i = torch.cat(out_i, dim=1)
        if cat_s.shape[1] < k:     # tiny shards: pad so the top-k is legal
            pad = int(k) - cat_s.shape[1]
            cat_s = F.pad(cat_s, (0, pad), value=NEG_INF)
            cat_i = F.pad(cat_i, (0, pad))
        bs, sel = stable_topk(cat_s, int(k))
        bi = torch.gather(cat_i, 1, sel)
        return bs, bi.clamp(max=self.n_items - 1)


def build_sharded_index(V, mesh, item_valid=None, shortlist_k=64, seq=0):
    """Full sharded rebuild: quantize the whole catalog, cut per shard."""
    return ShardedInt8Index(V, mesh, item_valid=item_valid,
                            shortlist_k=shortlist_k, seq=seq)
