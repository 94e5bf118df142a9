"""Strict reader for MovieLens-style ``ratings.csv`` files.

Counterpart of ``tpu_als/io/movielens.py::load_movielens_csv`` with the
strictness contract of ``tpu_als/io/native/fastcsv.cc``: after a one-line
header, every non-empty line is exactly ``int,int,float,int``, with an
optional trailing ``\\r`` or spaces.  Quoted fields, missing or extra
columns, trailing junk, non-finite ratings and ids beyond int64 raise
``ValueError("malformed ratings line ...")`` instead of entering the
model.  Fold-in batches are small, so this reader is plain Python.
"""

from __future__ import annotations

import math
import os
import re

import numpy as np

from tpu_als_torch.utils.frame import ColumnarFrame

_INT = r"\s*[+-]?\d+"
_FLOAT = r"\s*[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"
_LINE = re.compile(rf"({_INT}),({_INT}),({_FLOAT}),({_INT}) *")
_INT64_MAX = (1 << 63) - 1


def load_ratings_csv(path):
    """Read ``path`` (or ``path/ratings.csv``) into a frame with columns
    user, item (int64), rating (float32) and timestamp (int64)."""
    if os.path.isdir(path):
        path = os.path.join(path, "ratings.csv")
    users, items, ratings, stamps = [], [], [], []
    with open(path, encoding="utf-8") as f:
        next(f, None)  # header: userId,movieId,rating,timestamp
        for lineno, line in enumerate(f, start=2):
            line = line.rstrip("\n")
            if line.endswith("\r"):
                line = line[:-1]
            if not line:
                continue
            m = _LINE.fullmatch(line)
            ok = m is not None
            if ok:
                u, i, r, t = (int(m[1]), int(m[2]), float(m[3]), int(m[4]))
                ok = (math.isfinite(r)
                      and all(-_INT64_MAX - 1 <= v <= _INT64_MAX
                              for v in (u, i, t)))
            if not ok:
                raise ValueError(
                    f"malformed ratings line in {path} (line {lineno}): "
                    "every data line must be int,int,float,int (no quotes, "
                    "no extra columns); empty lines are allowed")
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
