"""Parity of the port's host data plane with ``tpu_als``.

The bucketed CSR build, its chunk rules, the synthetic MovieLens
generator and the frame's split are all numpy on both sides, so the bar
is equality: the same input gives array-equal buckets (rows, cols, vals,
mask and their dtypes), equal chunks, the same frame and the same split.
The degree distributions are the adversarial ones of
``tests/test_blocking_property.py``.
"""

import numpy as np
import pytest

from test_blocking_property import CASES
from tpu_als.core import ratings as jr
from tpu_als.io.movielens import synthetic_movielens as j_synthetic
from tpu_als.utils.frame import ColumnarFrame as JFrame
from tpu_als_torch.core import ratings as tr
from tpu_als_torch.io.movielens import ML25M_SHAPE
from tpu_als_torch.io.movielens import synthetic_movielens as t_synthetic
from tpu_als_torch.utils.frame import ColumnarFrame as TFrame


def _assert_same_buckets(t, j):
    assert (t.num_rows, t.nnz, t.chunk_elems) == \
        (j.num_rows, j.nnz, j.chunk_elems)
    np.testing.assert_array_equal(t.counts, j.counts)
    assert len(t.buckets) == len(j.buckets)
    for tb, jb in zip(t.buckets, j.buckets):
        for name in ("rows", "cols", "vals", "mask"):
            a, b = getattr(tb, name), getattr(jb, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("growth", [2.0, 1.5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_build_csr_buckets_array_equal(case, growth):
    num_rows, gen = CASES[case]
    u, i, r = gen(np.random.default_rng(11))
    num_items = int(i.max()) + 1
    for rows, cols, n, chunk in ((u, i, num_rows, 1 << 19),
                                 (i, u, num_items, 1 << 19),
                                 (u, i, num_rows, 1 << 9)):
        t = tr.build_csr_buckets(rows, cols, r, n, chunk_elems=chunk,
                                 width_growth=growth)
        j = jr.build_csr_buckets(rows, cols, r, n, chunk_elems=chunk,
                                 native=False, width_growth=growth)
        _assert_same_buckets(t, j)
        assert t.padded_nnz == j.padded_nnz


def test_chunk_rules_equal():
    for nb in (1, 3, 64, 100, 1000, 4097, 50_000):
        for w in (8, 24, 256, 4096, 1 << 16, 1 << 22):
            for ce in (1 << 9, 1 << 19):
                assert tr.scan_chunk(nb, w, ce) == jr.scan_chunk(nb, w, ce)
                nbp = tr.padded_bucket_rows(nb, w, ce)
                assert nbp == jr.padded_bucket_rows(nb, w, ce)
                for rank in (10, 128, 256):
                    for fused in (False, True):
                        assert tr.trainer_chunk(
                            nbp, w, rank, ce, fused_gather=fused) == \
                            jr.trainer_chunk(nbp, w, rank, ce,
                                             fused_gather=fused)
    counts = np.random.default_rng(0).integers(0, 5000, 2000)
    for growth in (2.0, 1.5):
        np.testing.assert_array_equal(
            tr.entity_widths(counts, 8, growth),
            jr.entity_widths(counts, 8, growth))


def test_invalid_rating_mask_equal():
    r = np.array([1.0, np.nan, -np.inf, 2e6, -1e6, 0.0, 5.0], np.float32)
    np.testing.assert_array_equal(tr.invalid_rating_mask(r),
                                  jr.invalid_rating_mask(r))
    assert tr.RATING_ABS_MAX == jr.RATING_ABS_MAX


def test_synthetic_movielens_frame_equal():
    assert ML25M_SHAPE == (162_541, 59_047, 25_000_095)
    t, tU, tV = t_synthetic(300, 120, 6000, seed=5, return_factors=True)
    j, jU, jV = j_synthetic(300, 120, 6000, seed=5, return_factors=True)
    assert t.columns == j.columns
    for c in t.columns:
        assert t[c].dtype == j[c].dtype
        np.testing.assert_array_equal(t[c], j[c])
    np.testing.assert_array_equal(tU, jU)
    np.testing.assert_array_equal(tV, jV)


def test_frame_split_and_helpers_equal():
    rng = np.random.default_rng(2)
    data = {"user": rng.integers(0, 50, 400),
            "item": rng.integers(0, 30, 400),
            "rating": np.where(rng.random(400) < 0.1, np.nan,
                               rng.random(400)).astype(np.float32)}
    t, j = TFrame(data), JFrame(data)
    for tp, jp in zip(t.randomSplit([0.8, 0.2], seed=7),
                      j.randomSplit([0.8, 0.2], seed=7)):
        for c in data:
            np.testing.assert_array_equal(tp[c], jp[c])
    np.testing.assert_array_equal(t.dropna()["user"], j.dropna()["user"])
    assert t.select("item").columns == ["item"]
    assert "rating" in t and "timestamp" not in t
    assert sorted(t.to_dict()) == sorted(data)
