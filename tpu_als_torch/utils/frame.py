"""A minimal columnar frame — the data interchange type of the API layer.

Counterpart of ``tpu_als/utils/frame.py`` (an own copy: the port imports
nothing of the JAX package).  It keeps what ``transform``,
``recommendFor*`` and ``FoldInServer`` use: construction from a dict,
another frame or a pandas DataFrame, column access, ``withColumn`` and
``filter``.
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

    def __getitem__(self, col):
        return self._data[col]

    def __repr__(self):
        return f"ColumnarFrame({len(self)} rows, columns={self.columns})"

    def withColumn(self, name, values):
        d = dict(self._data)
        d[name] = np.asarray(values)
        return ColumnarFrame(d)

    def filter(self, mask):
        mask = np.asarray(mask, dtype=bool)
        return ColumnarFrame({k: v[mask] for k, v in self._data.items()})


def as_frame(data):
    return data if isinstance(data, ColumnarFrame) else ColumnarFrame(data)
