"""Carry a model's weights across from the JAX package, and factor rows
across the slot space of a sharded fit.

``model_from_arrays`` takes exactly the numpy arrays a ``tpu_als``
``ALSModel`` holds — ``_user_map.ids``, ``_U``, ``_item_map.ids``,
``_V`` and ``_params`` — so a caller holding both packages moves a model
without touching disk.  The other road across is the shared checkpoint
format (:mod:`tpu_als_torch.io.checkpoint`).

A sharded fit keeps factors in slot space: entity e's row is row
``part.slot[e]`` of a ``[part.padded_rows, r]`` table (``part`` a
``Partition`` of either package; both deal entities the same way).
:func:`slot_rows` and :func:`entity_rows` move rows between the two
spaces, numpy arrays or tensors alike, so a sharded result of either
package is compared row for row with the other's or with a
single-device fit.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_als_torch.core.ratings import IdMap


def model_from_arrays(rank, user_ids, U, item_ids, V, params, device=None):
    """An :class:`ALSModel` on ``device`` (None -> the CUDA device)."""
    from tpu_als_torch.api.estimator import ALSModel

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


def _slots(part, like):
    slot = np.asarray(part.slot)
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(slot).to(like.device)
    return slot


def slot_rows(part, rows):
    """Entity rows [n, ...] -> the slot-space table [padded_rows, ...],
    zeros in the padding slots."""
    if isinstance(rows, torch.Tensor):
        out = rows.new_zeros((part.padded_rows,) + tuple(rows.shape[1:]))
    else:
        rows = np.asarray(rows)
        out = np.zeros((part.padded_rows,) + rows.shape[1:], rows.dtype)
    out[_slots(part, rows)] = rows
    return out


def entity_rows(part, table):
    """The slot-space table [padded_rows, ...] -> entity rows [n, ...]."""
    if not isinstance(table, torch.Tensor):
        table = np.asarray(table)
    return table[_slots(part, table)]
