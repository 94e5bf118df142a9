"""Chunked, byte-range, string-id ratings ingest: the ``stream:`` data spec.

Counterpart of ``tpu_als/io/stream.py``, on the port's own copy of the
native interner (``native/streamcsv.cc``, built with ``g++`` at first use
into ``tpu_als_torch/_build/``).  A ratings file whose user and item ids
are STRINGS is read host by host without ever holding the whole file:

- :func:`stream_ingest` is ONE host's view: its byte range of the file,
  read in bounded chunks through the interner, gives dense local int64
  ids and the local vocabularies in first-seen order.  Peak memory is
  one chunk buffer plus this host's output arrays.
- :func:`merge_vocabularies` unions per-host vocabularies into one
  global id space (lexicographic, a pure function of the label SET) and
  gives each host its ``local id -> global id`` gather.
- :func:`ingest_per_host` runs every host's stream in one process (the
  tests' and the benchmarks' harness).

Byte-range protocol: host ``k`` owns the lines whose first byte falls in
its range (:func:`host_byte_range`); a line straddling a boundary belongs
to the host where it starts, and the next host skips through the first
newline at or after its range start.  Chunk reads within a host re-stitch
the partial line left at each chunk's tail, so the native layer only
sees whole lines.  Each host appends its :func:`split_claim` to its user
vocabulary before the union; :func:`validate_split_claims` then proves
the hosts partitioned the file.

The reader is host code: its output is numpy, and it has no device.
"""

from __future__ import annotations

import ctypes
import os
import time

import numpy as np

from tpu_als_torch import obs
from tpu_als_torch.core.ratings import invalid_rating_mask
from tpu_als_torch.io._native_build import build_native
from tpu_als_torch.resilience import faults
from tpu_als_torch.resilience.retry import RetryPolicy, retry_call

_lib = None


def load():
    """The loaded interner library, built first if missing or stale."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_native("streamcsv"))
    lib.sc_create.restype = ctypes.c_void_p
    lib.sc_destroy.argtypes = [ctypes.c_void_p]
    lib.sc_count_lines.restype = ctypes.c_int64
    lib.sc_count_lines.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.sc_ingest.restype = ctypes.c_int64
    lib.sc_ingest.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_char,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float)]
    lib.sc_num_keys.restype = ctypes.c_int64
    lib.sc_num_keys.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sc_max_key_len.restype = ctypes.c_int64
    lib.sc_max_key_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sc_export_keys_padded.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_char_p]
    _lib = lib
    return lib


def host_byte_range(size, host_index, num_hosts):
    """Even byte split; the line-ownership protocol (module docstring)
    turns it into an exact, non-overlapping line split."""
    if not 0 <= host_index < num_hosts:
        raise ValueError(f"host_index {host_index} not in [0, {num_hosts})")
    per = size // num_hosts
    start = host_index * per
    end = size if host_index == num_hosts - 1 else (host_index + 1) * per
    return start, end


def _export_labels(lib, handle, which):
    """One intern table as a numpy ``S(width)`` array in dense-id order,
    with no Python object per key."""
    n = lib.sc_num_keys(handle, which)
    width = max(1, lib.sc_max_key_len(handle, which))
    out = np.empty(n, dtype=f"S{width}")
    if n:
        lib.sc_export_keys_padded(handle, which, width,
                                  out.ctypes.data_as(ctypes.c_char_p))
    return out


def decode_labels(labels):
    """Bytes vocabulary -> ``list[str]``, for consumers that need Python
    strings (the ``StringIndexerModel`` surface); lazy by design."""
    return [s.decode("utf-8") for s in labels.tolist()]


def _read_chunk(f, pos, want, policy):
    """One chunk read under the retry policy; each attempt seeks back to
    ``pos`` first.  Fault point ``ingest.read_chunk``: raise = a
    transient read error (retried); corrupt = a stray newline tears a
    line mid-chunk, which the strict parser rejects as malformed."""

    def _read():
        f.seek(pos)
        mode = faults.check("ingest.read_chunk")
        block = f.read(want)
        if mode == "corrupt" and block:
            buf = bytearray(block)
            buf[len(buf) // 2] = ord("\n")
            block = bytes(buf)
        return block

    return retry_call(_read, policy=policy, what="ingest.read_chunk")


class _Quarantine:
    """Poisoned-record sink for one :func:`stream_ingest` call: bad
    records are appended verbatim to a sink file (checkpoint's
    ``.corrupt/`` convention), with one ``ingest.quarantined_rows``
    counter bump and ONE ``ingest_quarantined`` event per call."""

    REASONS = ("malformed", "nonfinite", "out_of_range")

    def __init__(self, sink):
        self.sink = str(sink)
        self.counts = dict.fromkeys(self.REASONS, 0)
        self._fh = None

    @property
    def total(self):
        return sum(self.counts.values())

    def _handle(self):
        if self._fh is None:
            d = os.path.dirname(self.sink)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self.sink, "ab")
        return self._fh

    def line(self, raw, reason):
        """Quarantine one raw text line the parser rejected."""
        self.counts[reason] += 1
        self._handle().write(raw.rstrip(b"\n") + b"\n")

    def rows(self, u, i, r, reason):
        """Quarantine parsed rows whose rating the trainer must never
        see; the original line is gone, so the sink gets a synthesized
        record."""
        self.counts[reason] += int(len(r))
        fh = self._handle()
        for uu, ii, rr in zip(u.tolist(), i.tolist(), r.tolist()):
            fh.write((f"# post-parse {reason}: local_u={uu} "
                      f"local_i={ii} rating={rr}\n").encode())

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def _quarantine_sink(path, host_index, quarantine):
    """``True`` -> ``<path>.quarantine/host<k>.bad``; a path-like is used
    as it is."""
    if quarantine is True:
        return os.path.join(str(path) + ".quarantine",
                            f"host{int(host_index)}.bad")
    return os.fspath(quarantine)


def _poison_records(buf, delim):
    """Fault point ``ingest.record`` (walked only when armed): corrupt
    rewrites the scheduled record's rating column to ``nan`` before
    parsing, a malformed text record for the quarantine to catch."""
    d = delim.encode()[:1]
    out = []
    changed = False
    for line in buf.split(b"\n"):
        if line.strip() and faults.check("ingest.record") == "corrupt":
            cols = line.split(d)
            if len(cols) >= 3:
                cols[2] = b"nan"
                line = d.join(cols)
                changed = True
        out.append(line)
    return b"\n".join(out) if changed else buf


def stream_ingest(path, host_index=0, num_hosts=1, *, delim=",",
                  require_cols=3, skip_header=0, chunk_bytes=32 << 20,
                  retry_policy=None, quarantine=None):
    """Stream this host's byte range into ``(u_local, i_local, ratings,
    user_labels, item_labels)``: dense int64 ids into the label arrays
    (numpy ``S`` dtype, first-seen order within this host's stream) and
    float32 ratings.

    ``require_cols`` is the exact delimited column count per line; the
    first three are ``user,item,rating`` and the rest are skipped
    unparsed.  A malformed line raises ``ValueError``.  ``quarantine``:
    ``None`` keeps that strict contract; ``True`` (sink at
    ``<path>.quarantine/host<k>.bad``) or a sink path routes malformed
    lines and non-finite or out-of-range ratings to the sink instead of
    raising.  Bad lines re-run through the same native parser one line at
    a time, so a poisoned record never changes which good records parse.
    """
    lib = load()
    policy = retry_policy if retry_policy is not None \
        else RetryPolicy(max_attempts=3, base_delay=0.05, max_delay=1.0)
    q = None if quarantine is None else _Quarantine(
        _quarantine_sink(path, host_index, quarantine))
    size = os.path.getsize(path)
    start, end = host_byte_range(size, host_index, num_hosts)
    handle = lib.sc_create()
    out_u, out_i, out_r = [], [], []
    t_start = time.perf_counter()
    stall = 0.0          # seconds blocked in file reads
    nbytes = 0
    try:
        with open(path, "rb") as f:
            pos = start
            f.seek(pos)
            if start == end:
                pass  # more hosts than bytes: this range holds no line
            elif start == 0:
                # the header belongs to whichever host owns byte 0 (the
                # last host, when the split is degenerate)
                for _ in range(skip_header):
                    pos += len(f.readline())
            else:
                # a line straddling `start` belongs to the previous host
                pos += len(f.readline())
            carry = b""
            while pos < end:
                want = min(chunk_bytes, end - pos)
                t_io = time.perf_counter()
                block = _read_chunk(f, pos, want, policy)
                stall += time.perf_counter() - t_io
                if not block:
                    break
                pos += len(block)
                nbytes += len(block)
                buf = carry + block
                cut = buf.rfind(b"\n")
                if cut < 0:
                    carry = buf
                    continue
                carry, buf = buf[cut + 1:], buf[:cut + 1]
                _ingest_chunk(lib, handle, buf, delim, require_cols,
                              out_u, out_i, out_r, path, q)
            # finish the line straddling `end` (it starts in range), or,
            # when the range ends exactly at a line start, take the next
            # host's first line (it skips through its first newline)
            tail = f.readline() if (start != end and pos == end
                                    and pos < size) else b""
            last = carry + tail
            if last.strip():
                _ingest_chunk(lib, handle, last, delim, require_cols,
                              out_u, out_i, out_r, path, q)
        user_labels = _export_labels(lib, handle, 0)
        item_labels = _export_labels(lib, handle, 1)
    finally:
        lib.sc_destroy(handle)
        if q is not None:
            q.close()

    def cat(xs, dt):
        return np.concatenate(xs) if xs else np.empty(0, dtype=dt)

    u_out = cat(out_u, np.int64)
    rows = int(len(u_out))
    seconds = time.perf_counter() - t_start
    # one counter set and ONE event per call, never per chunk
    obs.counter("ingest.rows", rows)
    obs.counter("ingest.bytes", nbytes)
    obs.counter("ingest.stall_seconds", stall)
    obs.emit("ingest", path=str(path), host_index=int(host_index),
             num_hosts=int(num_hosts), rows=rows, bytes=nbytes,
             seconds=round(seconds, 6), stall_seconds=round(stall, 6))
    if q is not None and q.total:
        obs.counter("ingest.quarantined_rows", q.total)
        obs.emit("ingest_quarantined", path=str(path), rows=int(q.total),
                 reasons=dict(q.counts), sink=q.sink,
                 host_index=int(host_index))
    return (u_out, cat(out_i, np.int64), cat(out_r, np.float32),
            user_labels, item_labels)


def _ingest_chunk(lib, handle, buf, delim, require_cols,
                  out_u, out_i, out_r, path, q=None):
    if faults.armed("ingest.record"):
        buf = _poison_records(buf, delim)
    n = lib.sc_count_lines(buf, len(buf))
    if n == 0:
        return
    u = np.empty(n, dtype=np.int64)
    i = np.empty(n, dtype=np.int64)
    r = np.empty(n, dtype=np.float32)
    wrote = lib.sc_ingest(
        handle, buf, len(buf), delim.encode()[0], require_cols,
        u.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        i.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if wrote == -2:
        if q is None:
            raise ValueError(
                f"malformed ratings line in {path}: every data line must "
                f"be str{delim}str{delim}float with exactly "
                f"{require_cols} columns (no quotes; ids non-empty; "
                "rating finite)")
        u, i, r = _salvage_chunk(lib, handle, buf, delim, require_cols, q)
    elif wrote != n:
        raise IOError(f"streamcsv parsed {wrote} rows, expected {n}")
    if q is not None and len(r):
        # values the parser accepts as text but the trainer must never
        # see (huge magnitudes; non-finite if the parser lets one by)
        bad = invalid_rating_mask(r)
        if bad.any():
            nonfinite = ~np.isfinite(r)
            if (bad & nonfinite).any():
                q.rows(u[bad & nonfinite], i[bad & nonfinite],
                       r[bad & nonfinite], "nonfinite")
            oor = bad & ~nonfinite
            if oor.any():
                q.rows(u[oor], i[oor], r[oor], "out_of_range")
            keep = ~bad
            u, i, r = u[keep], i[keep], r[keep]
    out_u.append(u)
    out_i.append(i)
    out_r.append(r)


def _salvage_chunk(lib, handle, buf, delim, require_cols, q):
    """Per-line salvage of a chunk the batch parse rejected: each line
    re-runs through the same native parser, rejected lines go to the
    quarantine sink.  Runs only on chunks that hold a bad line."""
    us, is_, rs = [], [], []
    u1 = np.empty(1, dtype=np.int64)
    i1 = np.empty(1, dtype=np.int64)
    r1 = np.empty(1, dtype=np.float32)
    for line in buf.split(b"\n"):
        if not line.strip():
            continue
        lbuf = line + b"\n"
        wrote = lib.sc_ingest(
            handle, lbuf, len(lbuf), delim.encode()[0], require_cols,
            u1.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            i1.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            r1.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if wrote == 1:
            us.append(int(u1[0]))
            is_.append(int(i1[0]))
            rs.append(float(r1[0]))
        else:
            q.line(line, "malformed")
    return (np.array(us, dtype=np.int64), np.array(is_, dtype=np.int64),
            np.array(rs, dtype=np.float32))


def merge_vocabularies(per_host_labels):
    """Union per-host ``S``-dtype vocabularies into one global id space.

    Global order is LEXICOGRAPHIC (``np.unique`` over the stacked
    vocabularies), a pure function of the per-host vocabularies.  Returns
    ``(global_labels, remaps)``: ``global_labels`` an ``S``-dtype array,
    ``remaps[k][local_id] == global_id``.
    """
    arrays = [np.asarray(a, dtype="S") for a in per_host_labels]
    width = max([a.dtype.itemsize for a in arrays] + [1])
    stacked = np.concatenate([a.astype(f"S{width}") for a in arrays]) \
        if arrays else np.empty(0, dtype="S1")
    global_labels, inverse = np.unique(stacked, return_inverse=True)
    remaps, at = [], 0
    for a in arrays:
        remaps.append(inverse[at:at + len(a)].astype(np.int64))
        at += len(a)
    return global_labels, remaps


# The vocabulary entry that carries one host's byte-range claim through
# the vocabulary union: \x01 cannot appear in a parsed label and sorts
# before every printable id, and the entry survives np.unique.
SPLIT_CLAIM_PREFIX = b"\x01split="


def split_claim(host_index, num_hosts):
    """This host's byte-range claim, to append to its local user
    vocabulary before the union."""
    if not 0 <= int(host_index) < int(num_hosts):
        raise ValueError(f"host_index {host_index} not in [0, {num_hosts})")
    return SPLIT_CLAIM_PREFIX + b"%d/%d" % (int(host_index), int(num_hosts))


def _claim_mask(labels):
    """Boolean mask of the split claims in an ``S``-dtype array (the
    prefix bytes compared directly: ``S`` compares whole strings)."""
    width = max(labels.dtype.itemsize, 1)
    raw = labels.view(np.uint8).reshape(len(labels), width) \
        if len(labels) else np.zeros((0, width), np.uint8)
    npx = len(SPLIT_CLAIM_PREFIX)
    if width >= npx:
        return (raw[:, :npx] ==
                np.frombuffer(SPLIT_CLAIM_PREFIX, np.uint8)).all(axis=1)
    return np.zeros(len(labels), bool)


def strip_split_claims(labels):
    """Remove the split claims without enforcement, for a harness that
    byte-splits within one process (coverage is unverifiable there)."""
    labels = np.asarray(labels, dtype="S")
    return labels[~_claim_mask(labels)]


def validate_split_claims(labels):
    """Strip the split claims from a unioned vocabulary and verify that
    the hosts partitioned the file: every host used the same
    ``num_hosts`` and the indices cover ``0..num_hosts-1``.

    Returns ``(clean_labels, num_hosts)``; raises ``ValueError`` on
    disagreeing ``num_hosts``, missing byte ranges or a corrupt claim.
    """
    labels = np.asarray(labels, dtype="S")
    is_claim = _claim_mask(labels)
    npx = len(SPLIT_CLAIM_PREFIX)
    claims = []
    for c in labels[is_claim]:
        body = bytes(c)[npx:]
        try:
            h, hh = body.split(b"/")
            claims.append((int(h), int(hh)))
        except ValueError:
            raise ValueError(f"corrupt split claim in vocabulary: {c!r}")
    if not claims:
        raise ValueError(
            "no split claims in the unioned vocabulary — every host must "
            "append split_claim(host_index, num_hosts) before the union")
    counts = {hh for _, hh in claims}
    if len(counts) > 1:
        raise ValueError(
            f"hosts disagree on num_hosts: claims {sorted(claims)} — the "
            "byte ranges do not partition the file (stale --num-hosts on "
            "some host?)")
    (H,) = counts
    got = {h for h, _ in claims}
    missing = sorted(set(range(H)) - got)
    if missing:
        raise ValueError(
            f"byte ranges {missing} of {H} have no ingest claim — those "
            "ratings were never read (host down or mis-indexed)")
    bad = sorted(h for h in got if not 0 <= h < H)
    if bad:
        raise ValueError(f"split claims {bad} out of range for "
                         f"num_hosts={H}")
    return labels[~is_claim], H


def ingest_per_host(path, num_hosts, *, delim=",", require_cols=3,
                    skip_header=0, chunk_bytes=32 << 20):
    """Run every host's stream in one process; returns ``(splits,
    user_labels, item_labels)`` with ``splits[k] = (u_gid, i_gid,
    ratings)``, ids already in the global space."""
    per_host = [stream_ingest(path, k, num_hosts, delim=delim,
                              require_cols=require_cols,
                              skip_header=skip_header,
                              chunk_bytes=chunk_bytes)
                for k in range(num_hosts)]
    user_labels, u_remaps = merge_vocabularies([h[3] for h in per_host])
    item_labels, i_remaps = merge_vocabularies([h[4] for h in per_host])
    splits = [(u_remaps[k][per_host[k][0]],
               i_remaps[k][per_host[k][1]],
               per_host[k][2]) for k in range(num_hosts)]
    return splits, user_labels, item_labels
