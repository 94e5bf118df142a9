"""Parity of the port's byte-range string-id stream reader
(``tpu_als_torch.io.stream``) with ``tpu_als.io.stream``.

Both packages read the same files, each through its own copy of the
native interner (``io/native/streamcsv.cc``).  Tolerance: none.  The
outputs (dense ids, float32 ratings), the ``S``-dtype vocabularies, the
quarantine sink's bytes, the ``ingest``/``ingest_quarantined`` event
fields (times excluded) and the counters are held equal bit for bit, and
a malformed line raises the same exception type in both.
"""

import os
import shutil

import numpy as np
import pytest

from tpu_als import obs as jobs
from tpu_als.io import stream as jstream
from tpu_als.resilience import faults as jfaults
from tpu_als.resilience import retry as jretry
from tpu_als_torch import obs as tobs
from tpu_als_torch.io import stream as tstream
from tpu_als_torch.resilience import faults as tfaults
from tpu_als_torch.resilience import retry as tretry


@pytest.fixture(autouse=True)
def _fresh():
    for f in (jfaults, tfaults):
        f.clear()
    yield jobs.reset(), tobs.reset()
    for f in (jfaults, tfaults):
        f.clear()


def _write(tmp_path, n=1200, seed=0, header=False, cols=3, eol="\n",
           final_newline=True, unicode_ids=False, name="ratings.csv"):
    rng = np.random.default_rng(seed)
    users = [f"u{chr(97 + k % 7)}_{k % 211}" for k in range(n)]
    if unicode_ids:
        users = [f"ü{u}é" if k % 3 else f"用户{u}" for k, u in
                 enumerate(users)]
    items = [f"B{k % 83:07d}" for k in range(n)]
    rng.shuffle(users)
    lines = ["user_id,parent_asin,rating,timestamp"] if header else []
    tail = ",1609459200" if cols == 4 else ""
    lines += [f"{users[k]},{items[k]},{(k % 9) / 2 + 0.5}{tail}"
              for k in range(n)]
    text = eol.join(lines) + (eol if final_newline else "")
    path = tmp_path / name
    path.write_bytes(text.encode("utf-8"))
    return str(path)


def _same_arrays(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype, (x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y)


def _both(path, *args, **kw):
    got = tstream.stream_ingest(path, *args, **kw)
    ref = jstream.stream_ingest(path, *args, **kw)
    _same_arrays(got, ref)
    return got


def _events(o, etype, drop=("ts", "seconds", "stall_seconds", "sink")):
    return [{k: v for k, v in e.items() if k not in drop}
            for e in o.default_registry()._events if e["type"] == etype]


def test_native_library_is_the_ports_own(tmp_path):
    from tpu_als_torch import _build

    _both(_write(tmp_path, n=50))
    assert os.path.dirname(tstream.load()._name) == _build.BUILD_DIR


@pytest.mark.parametrize("num_hosts", [1, 2, 3, 5, 8])
def test_hosts_match_reference_bitwise(tmp_path, num_hosts):
    path = _write(tmp_path)
    for k in range(num_hosts):
        _both(path, k, num_hosts, chunk_bytes=257)
    got = tstream.ingest_per_host(path, num_hosts, chunk_bytes=257)
    ref = jstream.ingest_per_host(path, num_hosts, chunk_bytes=257)
    for (tu, ti, tr), (ju, ji, jr) in zip(got[0], ref[0]):
        _same_arrays((tu, ti, tr), (ju, ji, jr))
    _same_arrays(got[1:], ref[1:])
    assert sum(len(s[0]) for s in got[0]) == 1200
    assert _events(tobs, "ingest") == _events(jobs, "ingest")
    names = ("ingest.rows", "ingest.bytes")
    assert [tobs.counter_value(n) for n in names] == \
        [jobs.counter_value(n) for n in names]


def test_tiny_chunks_stitch_lines(tmp_path):
    path = _write(tmp_path, n=200)
    for k in range(3):
        _both(path, k, 3, chunk_bytes=7)


@pytest.mark.parametrize("kind", ["header_4cols", "crlf_no_final_newline",
                                  "unicode_ids"])
def test_file_shapes_match_reference(tmp_path, kind):
    if kind == "header_4cols":
        path = _write(tmp_path, header=True, cols=4)
        kw = dict(require_cols=4, skip_header=1)
    elif kind == "crlf_no_final_newline":
        path = _write(tmp_path, eol="\r\n", final_newline=False)
        kw = {}
    else:
        path = _write(tmp_path, unicode_ids=True)
        kw = {}
    for hosts in (1, 4):
        for k in range(hosts):
            _both(path, k, hosts, chunk_bytes=501, **kw)
    ul = _both(path, **kw)[3]
    assert tstream.decode_labels(ul) == jstream.decode_labels(ul)
    if kind == "unicode_ids":
        assert any("用户" in s for s in tstream.decode_labels(ul))


@pytest.mark.parametrize("bad", [
    '"quoted",B1,3.0', "u1,,3.0", "u1,B1,nan", "u1,B1,3.0,extra",
    "u1,B1", "u1,B1,abc"])
def test_malformed_line_raises_like_reference(tmp_path, bad):
    path = tmp_path / "bad.csv"
    path.write_text("u0,B0,1.0\n" + bad + "\nu2,B2,2.0\n")
    errs = []
    for mod in (jstream, tstream):
        with pytest.raises(Exception) as e:
            mod.stream_ingest(str(path))
        errs.append(type(e.value))
    assert errs[0] is errs[1] is ValueError


def _poisoned(tmp_path, name):
    """A file of 2,000 lines with malformed, NaN-text, 1e9 and -inf-text
    lines spread through it."""
    rng = np.random.default_rng(5)
    lines = []
    for k in range(2000):
        line = f"user{k % 97},item{k % 61},{(k % 9) / 2 + 0.5}"
        if k % 97 == 13:
            line = '"q",item1,3.0'
        elif k % 131 == 7:
            line = f"user{k},item{k},nan"
        elif k % 151 == 3:
            line = f"user{k},item{k},1e9"
        elif k % 173 == 11:
            line = f"user{k},item{k},{rng.uniform(-3e6, -2e6):.1f}"
        lines.append(line)
    path = tmp_path / name
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("hosts", [1, 3])
def test_quarantine_sink_matches_reference(tmp_path, hosts):
    path = _poisoned(tmp_path, "p.csv")
    for k in range(hosts):
        sinks = [str(tmp_path / f"{p}{k}.bad") for p in "jt"]
        ref = jstream.stream_ingest(path, k, hosts, chunk_bytes=997,
                                    quarantine=sinks[0])
        got = tstream.stream_ingest(path, k, hosts, chunk_bytes=997,
                                    quarantine=sinks[1])
        _same_arrays(got, ref)
        with open(sinks[0], "rb") as a, open(sinks[1], "rb") as b:
            assert a.read() == b.read()
    assert _events(tobs, "ingest_quarantined") == \
        _events(jobs, "ingest_quarantined")
    q = tobs.counter_value("ingest.quarantined_rows")
    assert q == jobs.counter_value(
        "ingest.quarantined_rows") and q > 0


def test_quarantine_true_derives_the_sink_beside_the_input(tmp_path):
    for pkg, mod in (("j", jstream), ("t", tstream)):
        d = tmp_path / pkg
        d.mkdir()
        path = _poisoned(d, "p.csv")
        mod.stream_ingest(path, quarantine=True)
    a = tmp_path / "j" / "p.csv.quarantine" / "host0.bad"
    b = tmp_path / "t" / "p.csv.quarantine" / "host0.bad"
    assert a.read_bytes() == b.read_bytes() and a.stat().st_size > 0


def _policies():
    return (jretry.RetryPolicy(max_attempts=3, base_delay=0.0),
            tretry.RetryPolicy(max_attempts=3, base_delay=0.0))


@pytest.mark.parametrize("spec", ["ingest.read_chunk=raise@nth=2",
                                  "ingest.read_chunk=corrupt@nth=1",
                                  "ingest.record=corrupt@every=40"])
def test_fault_points_match_reference(tmp_path, spec):
    path = _write(tmp_path, n=600)
    jp, tp = _policies()
    outs = []
    for mod, faults, pol, sink in ((jstream, jfaults, jp, "j.bad"),
                                   (tstream, tfaults, tp, "t.bad")):
        faults.install(spec)
        q = None if spec.endswith("raise@nth=2") else str(tmp_path / sink)
        outs.append(mod.stream_ingest(path, chunk_bytes=1024,
                                      retry_policy=pol, quarantine=q))
        faults.clear()
    _same_arrays(outs[1], outs[0])
    # the InjectedFault's message names its package: "reason" is left out
    drop = ("ts", "elapsed_seconds", "sink", "reason")
    for etype in ("fault_injected", "retry_attempt", "ingest_quarantined"):
        assert _events(tobs, etype, drop=drop) == \
            _events(jobs, etype, drop=drop)
    if "raise" in spec:
        assert len(outs[1][0]) == 600 and _events(tobs, "retry_attempt")
    else:
        assert (tmp_path / "t.bad").read_bytes() == \
            (tmp_path / "j.bad").read_bytes()


def test_corrupt_read_without_quarantine_raises_like_reference(tmp_path):
    path = _write(tmp_path, n=300)
    for mod, faults in ((jstream, jfaults), (tstream, tfaults)):
        faults.install("ingest.read_chunk=corrupt@nth=1")
        with pytest.raises(ValueError, match="malformed ratings line"):
            mod.stream_ingest(path, chunk_bytes=512)
        faults.clear()


def test_vocabulary_merge_and_byte_ranges_match_reference(tmp_path):
    rng = np.random.default_rng(3)
    per_host = [np.array(sorted({f"id{int(x)}".encode() for x in
                                 rng.integers(0, 400, n)}), dtype="S")
                for n in (50, 3, 120, 0)]
    per_host[3] = np.empty(0, dtype="S1")
    got = tstream.merge_vocabularies(per_host)
    ref = jstream.merge_vocabularies(per_host)
    _same_arrays((got[0],), (ref[0],))
    _same_arrays(got[1], ref[1])
    got, ref = tstream.merge_vocabularies([]), jstream.merge_vocabularies([])
    _same_arrays((got[0],), (ref[0],))
    assert got[1] == ref[1] == []
    for size in (0, 1, 7, 1000, 1001):
        for hosts in (1, 3, 8):
            assert [tstream.host_byte_range(size, k, hosts)
                    for k in range(hosts)] == \
                [jstream.host_byte_range(size, k, hosts)
                 for k in range(hosts)]
    for mod in (jstream, tstream):
        with pytest.raises(ValueError):
            mod.host_byte_range(10, 3, 3)


def test_split_claims_match_reference():
    labels = np.array([b"alice", b"bob"], dtype="S")
    assert tstream.SPLIT_CLAIM_PREFIX == jstream.SPLIT_CLAIM_PREFIX
    for k in range(3):
        assert tstream.split_claim(k, 3) == jstream.split_claim(k, 3)
    full = np.concatenate([labels.astype("S10"),
                           np.array([tstream.split_claim(k, 3)
                                     for k in range(3)], dtype="S10")])
    full = np.unique(full)
    got, ref = (tstream.validate_split_claims(full),
                jstream.validate_split_claims(full))
    _same_arrays((got[0],), (ref[0],))
    assert got[1] == ref[1] == 3
    _same_arrays((tstream.strip_split_claims(full),),
                 (jstream.strip_split_claims(full),))
    bad_sets = [
        full[1:],                     # range 0 missing (claims sort first)
        np.unique(np.concatenate([full, np.array(
            [tstream.split_claim(0, 2)], dtype="S10")])),  # H disagrees
        labels,                                      # no claims at all
        np.array([b"\x01split=x/y"], dtype="S"),     # corrupt claim
    ]
    for bad in bad_sets:
        msgs = []
        for mod in (jstream, tstream):
            with pytest.raises(ValueError) as e:
                mod.validate_split_claims(bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for mod in (jstream, tstream):
        with pytest.raises(ValueError):
            mod.split_claim(3, 3)


def test_degenerate_split_more_hosts_than_bytes(tmp_path):
    path = tmp_path / "tiny.csv"
    path.write_text("a,b,1\n")
    for k in range(8):
        _both(str(path), k, 8)
    shutil.copy(path, tmp_path / "tiny2.csv")
    got = tstream.ingest_per_host(str(tmp_path / "tiny2.csv"), 8)
    assert sum(len(s[0]) for s in got[0]) == 1
