"""Strict reader for MovieLens-style ``ratings.csv`` and ``u.data`` files.

The plain Python twin of the native reader (:mod:`tpu_als_torch.io.
fastcsv`), with its strictness contract: after the header lines, every
non-empty line is exactly ``int,int,float,int`` (tab-separated in
``u.data``), with an optional trailing ``\\r`` or spaces.  Quoted
fields, missing or extra columns, trailing junk, ratings that are not
finite in float32 and ids beyond int64 raise ``ValueError("malformed
ratings line ...")`` instead of entering the model.  The fold-in batches
of the ``recommend`` command are small and go through it, and so do the
MovieLens loaders on a host without ``g++``; the tests hold the native
reader to it.
"""

from __future__ import annotations

import os
import re

import numpy as np

from tpu_als_torch.utils.frame import ColumnarFrame

_INT = r"\s*[+-]?\d+"
_FLOAT = r"\s*[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"
_INT64_MAX = (1 << 63) - 1
# the least magnitude that rounds to inf in float32 (FLT_MAX plus half
# its ulp): a rating at or past it is not finite once stored
_F32_OVERFLOW = 2.0 ** 128 - 2.0 ** 103


def load_ratings_csv(path, delim=",", skip_header=1):
    """Read ``path`` (or ``path/ratings.csv``) into a frame with columns
    user, item (int64), rating (float32) and timestamp (int64).
    ``delim`` and ``skip_header`` as in
    :func:`tpu_als_torch.io.fastcsv.load_ratings_csv`."""
    if os.path.isdir(path):
        path = os.path.join(path, "ratings.csv")
    d = re.escape(delim)
    pattern = re.compile(rf"({_INT}){d}({_INT}){d}({_FLOAT}){d}({_INT}) *")
    users, items, ratings, stamps = [], [], [], []
    with open(path, encoding="utf-8") as f:
        for _ in range(skip_header):  # userId,movieId,rating,timestamp
            next(f, None)
        for lineno, line in enumerate(f, start=skip_header + 1):
            line = line.rstrip("\n")
            if line.endswith("\r"):
                line = line[:-1]
            if not line:
                continue
            m = pattern.fullmatch(line)
            ok = m is not None
            if ok:
                u, i, r, t = (int(m[1]), int(m[2]), float(m[3]), int(m[4]))
                ok = (abs(r) < _F32_OVERFLOW
                      and all(-_INT64_MAX - 1 <= v <= _INT64_MAX
                              for v in (u, i, t)))
            if not ok:
                raise ValueError(
                    f"malformed ratings line in {path} (line {lineno}): "
                    f"every data line must be int{delim}int{delim}float"
                    f"{delim}int (no quotes, no extra columns); empty "
                    "lines are allowed")
            users.append(u)
            items.append(i)
            ratings.append(r)
            stamps.append(t)
    return ColumnarFrame({
        "user": np.asarray(users, dtype=np.int64),
        "item": np.asarray(items, dtype=np.int64),
        "rating": np.asarray(ratings, dtype=np.float32),
        "timestamp": np.asarray(stamps, dtype=np.int64),
    })


def load_u_data(path):
    """ml-100k ``u.data`` (tab-separated, no header) as a frame."""
    return load_ratings_csv(path, delim="\t", skip_header=0)
