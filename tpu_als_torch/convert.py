"""Carry a model's weights across from the JAX package.

``model_from_arrays`` takes exactly the numpy arrays a ``tpu_als``
``ALSModel`` holds — ``_user_map.ids``, ``_U``, ``_item_map.ids``,
``_V`` and ``_params`` — so a caller holding both packages moves a model
without touching disk.  The other road across is the shared checkpoint
format (:mod:`tpu_als_torch.io.checkpoint`).
"""

from __future__ import annotations

import numpy as np

from tpu_als_torch.api.estimator import ALSModel
from tpu_als_torch.core.ratings import IdMap


def model_from_arrays(rank, user_ids, U, item_ids, V, params, device=None):
    """An :class:`ALSModel` on ``device`` (None -> the CUDA device)."""
    U = np.asarray(U, dtype=np.float32)
    V = np.asarray(V, dtype=np.float32)
    if U.shape[1:] != (rank,) or V.shape[1:] != (rank,) \
            or len(user_ids) != len(U) or len(item_ids) != len(V):
        raise ValueError(
            f"rank {rank}: got U {U.shape} for {len(user_ids)} user ids and "
            f"V {V.shape} for {len(item_ids)} item ids")
    return ALSModel(rank, IdMap(ids=np.asarray(user_ids)),
                    IdMap(ids=np.asarray(item_ids)), U, V, params,
                    device=device)
