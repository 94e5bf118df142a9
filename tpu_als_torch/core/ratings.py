"""Original-id <-> dense-index maps.

Counterpart of ``tpu_als/core/ratings.py``: ``IdMap`` and ``remap_ids``
(an own copy — the port imports nothing of the JAX package).  The
bucketed CSR build belongs to training and is not here; ``_next_pow2``
is not carried over, since it only bounded JAX's compile cache.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class IdMap:
    """Dense-index <-> original-id mapping, persisted with the model.
    ``ids[dense] == original``."""

    ids: np.ndarray  # [n] original ids, position = dense index

    def __post_init__(self):
        self._lookup = None

    def __len__(self):
        return len(self.ids)

    def to_dense(self, original, missing=-1):
        """Map original ids -> dense indices; unseen ids -> ``missing``."""
        original = np.asarray(original)
        if self._lookup is None:
            order = np.argsort(self.ids, kind="stable")
            self._lookup = (self.ids[order], order)
        sorted_ids, order = self._lookup
        if len(sorted_ids) == 0:
            return np.full(original.shape, missing, dtype=np.int64)
        pos = np.searchsorted(sorted_ids, original)
        pos = np.clip(pos, 0, len(sorted_ids) - 1)
        hit = sorted_ids[pos] == original
        return np.where(hit, order[pos], missing).astype(np.int64)


def remap_ids(raw):
    """Densify one id column.  Returns (dense_idx [n], IdMap)."""
    raw = np.asarray(raw)
    uniq, inv = np.unique(raw, return_inverse=True)
    return inv.astype(np.int64), IdMap(ids=uniq)

