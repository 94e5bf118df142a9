"""ctypes binding of the native ratings reader (``native/fastcsv.cc``).

Counterpart of ``tpu_als/io/fastcsv.py``: ``load_ratings_csv`` and
``load_u_data`` parse a MovieLens ratings file in threaded C++ straight
into numpy buffers.  The library is built with ``g++`` at first use into
``tpu_als_torch/_build/`` (:mod:`tpu_als_torch.io._native_build`); a
failed build raises.  :mod:`tpu_als_torch.io.ratings_csv` is its plain
Python twin, with the same strictness contract.
"""

from __future__ import annotations

import ctypes
import mmap
import os

import numpy as np

from tpu_als_torch.io._native_build import build_native

_lib = None


def load():
    """The loaded library, built first if missing or stale."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_native("fastcsv"))
    lib.fastcsv_count.restype = ctypes.c_int64
    lib.fastcsv_count.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.c_int]
    lib.fastcsv_parse.restype = ctypes.c_int64
    lib.fastcsv_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char, ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
    ]
    _lib = lib
    return lib


def load_ratings_csv(path, delim=",", skip_header=1, n_threads=None):
    """Parse a ratings file into ``(users, items, ratings, timestamps)``
    (int64, int64, float32, int64).

    Strict: a malformed data line (quoted fields, missing or extra
    columns, trailing junk, a non-finite rating, an id beyond int64)
    raises ``ValueError`` rather than letting a zero-filled row enter
    training.
    """
    lib = load()
    if n_threads is None:
        n_threads = min(16, os.cpu_count() or 1)
    size = os.path.getsize(path)
    if size == 0:
        return (np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, np.float32), np.empty(0, np.int64))
    use_mmap = size % mmap.PAGESIZE != 0
    buf = None
    with open(path, "rb") as f:
        # ACCESS_COPY: writable through the buffer protocol (ctypes'
        # from_buffer needs that) but copy-on-write, and never written, so
        # reads are zero-copy.  A file of exactly a page multiple with no
        # final newline would let strtoll read the unmapped next page (a
        # field is read up to its terminator): that shape gets a heap copy
        # with one byte of slack, a newline, instead.
        if use_mmap:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        else:  # one allocation, filled in place
            mm = bytearray(size + 1)
            f.readinto(memoryview(mm)[:size])
            mm[size] = 0x0A
        try:
            length = size if use_mmap else size + 1
            buf = (ctypes.c_char * length).from_buffer(mm)
            n = lib.fastcsv_count(buf, length, skip_header)
            users = np.empty(n, dtype=np.int64)
            items = np.empty(n, dtype=np.int64)
            ratings = np.empty(n, dtype=np.float32)
            ts = np.empty(n, dtype=np.int64)
            wrote = lib.fastcsv_parse(
                buf, length, delim.encode()[0], skip_header, n_threads,
                users.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                items.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ratings.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
        finally:
            del buf  # release the exported buffer before closing the mmap
            if use_mmap:
                mm.close()
    if wrote == -2:
        raise ValueError(
            f"malformed ratings line in {path}: every data line must be "
            f"int{delim}int{delim}float{delim}int (no quotes, no extra "
            "columns); empty lines are allowed")
    if wrote != n:
        raise IOError(f"fastcsv parsed {wrote} rows, expected {n} ({path})")
    return users, items, ratings, ts


def load_u_data(path, n_threads=None):
    """ml-100k ``u.data`` (tab-separated, no header)."""
    return load_ratings_csv(path, delim="\t", skip_header=0,
                            n_threads=n_threads)
