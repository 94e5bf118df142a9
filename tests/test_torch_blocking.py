"""The port's native bucketizer against its numpy path and the reference.

``build_csr_buckets(native=True)`` (the threaded C++ of
``tpu_als_torch/io/native/bucketize.cc``, built with g++ into
``tpu_als_torch/_build/``), ``native=False`` (numpy) and the reference's
``build_csr_buckets(native=False)`` must give array-equal buckets: the
same bucket order, the same rows, and within each row the same entries
in input order, with the same dtypes.  The degree laws are the
adversarial ones of ``tests/test_blocking_property.py``, plus a case
large enough (2^18 entries and more) for the C++ to split both passes
over threads, with one row holding a fifth of the entries.
"""

import os
import subprocess

import numpy as np
import pytest

from test_blocking_property import CASES
from tpu_als.core import ratings as jr
from tpu_als_torch import _build
from tpu_als_torch.core import ratings as tr
from tpu_als_torch.io import _native_build, fastbucket


def _threaded(rng):
    # past the C++'s 2^18-entry threshold for threads, with one huge row,
    # duplicate pairs and a tail of empty rows
    n = 320_000
    u = np.minimum(rng.zipf(1.6, n), 5000) - 1
    u[rng.random(n) < 0.2] = 17
    i = rng.integers(0, 900, n)
    return u, i, rng.uniform(0.5, 5, n).astype(np.float32)


ALL = dict(CASES, threaded=(6000, _threaded))


def _assert_same(a, b):
    assert (a.num_rows, a.nnz, a.chunk_elems) == \
        (b.num_rows, b.nnz, b.chunk_elems)
    np.testing.assert_array_equal(a.counts, b.counts)
    assert a.counts.dtype == b.counts.dtype
    assert len(a.buckets) == len(b.buckets)
    for x, y in zip(a.buckets, b.buckets):
        for name in ("rows", "cols", "vals", "mask"):
            p, q = getattr(x, name), getattr(y, name)
            assert p.dtype == q.dtype, name
            np.testing.assert_array_equal(p, q, err_msg=name)


@pytest.mark.parametrize("growth", [2.0, 1.5])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("case", sorted(ALL))
def test_native_numpy_and_reference_array_equal(case, seed, growth):
    num_rows, gen = ALL[case]
    u, i, r = gen(np.random.default_rng(seed))
    num_items = int(i.max()) + 1
    for rows, cols, n, chunk in ((u, i, num_rows, 1 << 19),
                                 (i, u, num_items, 1 << 10)):
        kw = dict(min_width=4, chunk_elems=chunk, width_growth=growth)
        nat = tr.build_csr_buckets(rows, cols, r, n, native=True, **kw)
        _assert_same(nat, tr.build_csr_buckets(rows, cols, r, n,
                                               native=False, **kw))
        _assert_same(nat, jr.build_csr_buckets(rows, cols, r, n,
                                               native=False, **kw))


def test_native_thread_counts_agree():
    u, i, r = _threaded(np.random.default_rng(3))
    counts = fastbucket.counts(u, 6000, n_threads=1)
    np.testing.assert_array_equal(counts, fastbucket.counts(u, 6000,
                                                            n_threads=8))
    np.testing.assert_array_equal(counts, np.bincount(u, minlength=6000))
    # the library is the port's own, built beside its CUDA kernels
    assert os.path.exists(os.path.join(_build.BUILD_DIR, "libbucketize.so"))


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("bad", [-1, 40])
def test_out_of_range_rows_raise(native, bad):
    u = np.array([0, 3, bad, 5])
    with pytest.raises(ValueError, match=r"row indices must be in \[0, 40\)"):
        tr.build_csr_buckets(u, np.arange(4), np.ones(4, np.float32), 40,
                             native=native)


def test_native_choice_is_made_up_front(monkeypatch):
    """None takes C++ for float32 with g++ on the PATH and numpy otherwise;
    True without g++ or with another dtype raises; a failed build after
    the choice raises rather than falling back."""
    u, i, r = CASES["duplicate_pairs"][1](np.random.default_rng(1))
    calls = []
    real = tr._build_csr_buckets_native

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tr, "_build_csr_buckets_native", spy)
    ref = tr.build_csr_buckets(u, i, r, 40, native=False)
    _assert_same(tr.build_csr_buckets(u, i, r, 40), ref)
    assert calls == [1]
    tr.build_csr_buckets(u, i, r, 40, dtype=np.float64)
    assert calls == [1]
    with pytest.raises(RuntimeError, match="float32"):
        tr.build_csr_buckets(u, i, r, 40, dtype=np.float64, native=True)
    monkeypatch.setattr(_native_build.shutil, "which", lambda name: None)
    _assert_same(tr.build_csr_buckets(u, i, r, 40), ref)
    assert calls == [1]
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tr.build_csr_buckets(u, i, r, 40, native=True)


def test_failed_build_raises(monkeypatch, tmp_path):
    """g++ present but the source does not compile: the native route
    raises (no fallback to numpy) and leaves no temporary file."""
    bad = tmp_path / "native"
    bad.mkdir()
    (bad / "bucketize.cc").write_text("this is not C++\n")
    monkeypatch.setattr(_native_build, "NATIVE_DIR", str(bad))
    monkeypatch.setattr(_native_build, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(fastbucket, "_lib", None)
    u, i, r = CASES["duplicate_pairs"][1](np.random.default_rng(1))
    with pytest.raises(subprocess.CalledProcessError):
        tr.build_csr_buckets(u, i, r, 40)
    assert not os.listdir(tmp_path / "out")  # the temporary file is gone
