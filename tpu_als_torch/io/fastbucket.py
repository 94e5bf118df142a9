"""ctypes binding of the native bucketizer (``native/bucketize.cc``).

Counterpart of ``tpu_als/io/fastbucket.py``: the two O(nnz) passes of
:func:`tpu_als_torch.core.ratings.build_csr_buckets` — per-entity
counting and the padded-bucket fill — in threaded C++, array-equal to
the numpy path.  The library is built with ``g++`` at first use into
``tpu_als_torch/_build/`` (:mod:`tpu_als_torch.io._native_build`).

The reference's ``available()`` probe is not carried over: the caller
decides from ``g++`` on the PATH before it starts, and a build that then
fails raises.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from tpu_als_torch.io._native_build import build_native

_lib = None
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)


def load():
    """The loaded library, built first if missing or stale."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_native("bucketize"))
    lib.bucketize_count.restype = None
    lib.bucketize_count.argtypes = [
        _I64P, ctypes.c_int64, ctypes.c_int64, _I64P, ctypes.c_int]
    lib.bucketize_fill.restype = None
    lib.bucketize_fill.argtypes = [
        _I64P, _I64P, _F32P, ctypes.c_int64, ctypes.c_int64,
        _I64P,
        _I32P, ctypes.c_int32, _I64P,
        ctypes.POINTER(_I32P), ctypes.POINTER(_I32P),
        ctypes.POINTER(_F32P), ctypes.POINTER(_F32P),
        _I32P, _I32P, ctypes.c_int]
    _lib = lib
    return lib


def _threads(n_threads):
    return min(16, os.cpu_count() or 1) if n_threads is None else n_threads


def check_rows(row_idx, num_rows):
    """Raise ``ValueError`` unless every row index is in ``[0,
    num_rows)``: an out-of-range row (e.g. the -1 'missing' sentinel of
    ``IdMap.to_dense``) must never reach the C++ scatter."""
    if len(row_idx):
        lo, hi = int(row_idx.min()), int(row_idx.max())
        if lo < 0 or hi >= num_rows:
            raise ValueError(f"row indices must be in [0, {num_rows}); got "
                             f"range [{lo}, {hi}]")


def counts(row_idx, num_rows, n_threads=None):
    """Per-entity rating counts (``np.bincount``).  ``row_idx`` must
    already have passed :func:`check_rows`, as
    :func:`~tpu_als_torch.core.ratings.build_csr_buckets` does once at its
    entry."""
    lib = load()
    row_idx = np.ascontiguousarray(row_idx, dtype=np.int64)
    out = np.empty(num_rows, dtype=np.int64)
    lib.bucketize_count(
        row_idx.ctypes.data_as(_I64P), len(row_idx), num_rows,
        out.ctypes.data_as(_I64P), _threads(n_threads))
    return out


def fill_buckets(row_idx, col_idx, vals, num_rows, cnts, ebucket,
                 bucket_layout, n_threads=None):
    """Fill freshly allocated bucket arrays.

    ``ebucket``: [num_rows] int32 bucket index per entity, -1 for entities
    with no ratings (the caller computes it with the numpy path's width
    rule).  ``bucket_layout``: ``(width, nb, nb_pad)`` ascending by width,
    ``nb`` the rated entities of that width and ``nb_pad >= nb`` the
    padded row count.  Returns ``[(rows, cols, vals, mask)]`` numpy
    arrays, one tuple a bucket.  ``row_idx`` must already have passed
    :func:`check_rows`.
    """
    lib = load()
    row_idx = np.ascontiguousarray(row_idx, dtype=np.int64)
    col_idx = np.ascontiguousarray(col_idx, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    cnts = np.ascontiguousarray(cnts, dtype=np.int64)
    ebucket = np.ascontiguousarray(ebucket, dtype=np.int32)
    if not (len(col_idx) == len(vals) == len(row_idx)):
        raise ValueError(f"rows, cols and vals differ in length: "
                         f"{len(row_idx)}, {len(col_idx)}, {len(vals)}")
    if len(cnts) != num_rows or len(ebucket) != num_rows:
        raise ValueError("counts and ebucket must have num_rows entries")
    widths = np.array([w for w, _, _ in bucket_layout], dtype=np.int64)
    nbk = len(bucket_layout)
    out = []
    rows_ptrs, cols_ptrs = (_I32P * nbk)(), (_I32P * nbk)()
    vals_ptrs, mask_ptrs = (_F32P * nbk)(), (_F32P * nbk)()
    for b, (w, nb, nb_pad) in enumerate(bucket_layout):
        rows = np.full(nb_pad, num_rows, dtype=np.int32)
        cols = np.zeros((nb_pad, w), dtype=np.int32)
        v = np.zeros((nb_pad, w), dtype=np.float32)
        m = np.zeros((nb_pad, w), dtype=np.float32)
        out.append((rows, cols, v, m))
        rows_ptrs[b] = rows.ctypes.data_as(_I32P)
        cols_ptrs[b] = cols.ctypes.data_as(_I32P)
        vals_ptrs[b] = v.ctypes.data_as(_F32P)
        mask_ptrs[b] = m.ctypes.data_as(_F32P)
    elocal = np.empty(num_rows, dtype=np.int32)
    cursor = np.zeros(num_rows, dtype=np.int32)
    lib.bucketize_fill(
        row_idx.ctypes.data_as(_I64P), col_idx.ctypes.data_as(_I64P),
        vals.ctypes.data_as(_F32P), len(row_idx), num_rows,
        cnts.ctypes.data_as(_I64P),
        ebucket.ctypes.data_as(_I32P), nbk,
        widths.ctypes.data_as(_I64P),
        rows_ptrs, cols_ptrs, vals_ptrs, mask_ptrs,
        elocal.ctypes.data_as(_I32P),
        cursor.ctypes.data_as(_I32P), _threads(n_threads))
    return out
