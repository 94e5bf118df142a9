"""A minimal columnar frame — the data interchange type of the API layer.

Counterpart of ``tpu_als/utils/frame.py`` (an own copy: the port imports
nothing of the JAX package): construction from a dict, another frame or
a pandas DataFrame, column access and membership, ``count``, ``to_dict``,
``select``, ``withColumn``, ``filter``, ``dropna`` and the seeded
``randomSplit``.
"""

from __future__ import annotations

import numpy as np


class ColumnarFrame:
    """Immutable dict-of-columns with equal-length numpy arrays."""

    def __init__(self, data):
        if isinstance(data, ColumnarFrame):
            data = data._data
        if hasattr(data, "to_dict") and hasattr(data, "columns"):  # pandas
            data = {c: np.asarray(data[c]) for c in data.columns}
        self._data = {k: np.asarray(v) for k, v in dict(data).items()}
        lens = {len(v) for v in self._data.values()}
        if len(lens) > 1:
            raise ValueError(f"column lengths differ: "
                             f"{ {k: len(v) for k, v in self._data.items()} }")

    @property
    def columns(self):
        return list(self._data)

    def __len__(self):
        if not self._data:
            return 0
        return len(next(iter(self._data.values())))

    count = __len__  # Spark's df.count()

    def __contains__(self, col):
        return col in self._data

    def __getitem__(self, col):
        return self._data[col]

    def __repr__(self):
        return f"ColumnarFrame({len(self)} rows, columns={self.columns})"

    def to_dict(self):
        return dict(self._data)

    def select(self, *cols):
        return ColumnarFrame({c: self._data[c] for c in cols})

    def withColumn(self, name, values):
        d = dict(self._data)
        d[name] = np.asarray(values)
        return ColumnarFrame(d)

    def filter(self, mask):
        mask = np.asarray(mask, dtype=bool)
        return ColumnarFrame({k: v[mask] for k, v in self._data.items()})

    def dropna(self, cols=None):
        cols = cols or [c for c in self.columns
                        if np.issubdtype(self._data[c].dtype, np.floating)]
        keep = np.ones(len(self), dtype=bool)
        for c in cols:
            v = self._data[c]
            if np.issubdtype(v.dtype, np.floating):
                keep &= ~np.isnan(v)
        return self.filter(keep)

    def randomSplit(self, weights, seed=None):
        """Seeded proportional split, the reference's
        ``df.randomSplit([0.8, 0.2])``.  The draws come from their own seed
        domain (spawn key 0x5917), so a split never replays the stream of
        another generator seeded with the same integer; the same seed
        gives the reference's split."""
        w = np.asarray(weights, dtype=np.float64)
        w = w / w.sum()
        rng = np.random.default_rng(
            None if seed is None
            else np.random.SeedSequence(seed, spawn_key=(0x5917,)))
        draws = rng.random(len(self))
        edges = np.cumsum(w)[:-1]
        bucket = np.searchsorted(edges, draws, side="right")
        return [self.filter(bucket == k) for k in range(len(w))]


def as_frame(data):
    return data if isinstance(data, ColumnarFrame) else ColumnarFrame(data)
