"""The 1-D mesh of shards the sharded trainer and server run over.

Counterpart of ``tpu_als/parallel/mesh.py``.  The reference's mesh is a
``jax.sharding.Mesh`` with one axis; its tests force 8 host devices on
one CPU and run every ring on them.  Here a :class:`Mesh` is S shards,
each with its ``torch.device``.  The shards may all sit on ONE device —
``make_mesh(devices=["cuda:0"] * S)``, or ``["cpu"] * S`` in the tests —
and are then S logical shards sharing that device's memory: what the
ring kernels compute (a row's normal equations summed over the S source
shards in ring order, S candidate sets merged in shard order) is the
same at any S, and only the transport between shards differs.

Each shard carries a logical id (``ids``, by default ``0 .. S-1``), the
counterpart of the reference's ``device.id``: on one card every shard
has the same ``torch.device``, so the id cannot come from the device.
The elastic fit re-forms a mesh on the surviving shards with their
original ids (:func:`tpu_als_torch.resilience.elastic.surviving_devices`),
so a second loss picks its victim by position as the reference's does.

A mesh whose shards sit on more than one device raises
``NotImplementedError``: the transport across cards (peer-mapped shard
pointers over NVLink, or NCCL) is not written yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch


class Shard(NamedTuple):
    """One shard of a mesh: its logical id and the device it sits on."""

    id: int
    device: torch.device


@dataclass(frozen=True)
class Mesh:
    """S shards in ring order; ``devices[s]`` holds shard s, whose
    logical id is ``ids[s]`` (default ``s``)."""

    devices: tuple
    ids: tuple = None

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        ids = (tuple(range(len(self.devices))) if self.ids is None
               else tuple(int(i) for i in self.ids))
        if len(ids) != len(self.devices) or len(set(ids)) != len(ids):
            raise ValueError(f"a mesh of {len(self.devices)} shards needs "
                             f"as many distinct logical ids, got {ids}")
        object.__setattr__(self, "ids", ids)
        devs = tuple(torch.device(d) for d in self.devices)
        if any(d.type == "cuda" and d.index is None for d in devs):
            devs = tuple(torch.device("cuda", torch.cuda.current_device())
                         if d.type == "cuda" and d.index is None else d
                         for d in devs)
        object.__setattr__(self, "devices", devs)
        if len(set(devs)) > 1:
            raise NotImplementedError(
                f"a mesh over {sorted(set(map(str, devs)))}: the port runs "
                "its shards as logical shards on one device; shards on "
                "several cards need peer-mapped shard pointers (or NCCL) "
                "for the transport between them, which is not written yet")

    @property
    def size(self):
        return len(self.devices)

    @property
    def device(self):
        """The one device every shard sits on."""
        return self.devices[0]

    @property
    def shards(self):
        """The shards in ring order, each ``Shard(id, device)``."""
        return tuple(Shard(i, d) for i, d in zip(self.ids, self.devices))


def make_mesh(n_devices=None, devices=None, ids=None):
    """A 1-D mesh.  Without ``devices``: one shard per visible CUDA card
    (``n_devices`` of them; more than are visible raises, as in the
    reference, rather than building a silently smaller mesh — and more
    than one card raises ``NotImplementedError``).  With ``devices``: one
    shard per entry, so ``["cuda:0"] * S`` is S logical shards on one
    card.  ``ids``: the shards' logical ids (default ``0 .. S-1``)."""
    if devices is None:
        visible = torch.cuda.device_count()
        n = visible if n_devices is None else int(n_devices)
        if n > visible or n < 1:
            raise ValueError(
                f"requested a {n}-device mesh but only {visible} CUDA "
                "devices are visible; refusing to build a silently smaller "
                "mesh (pass devices=['cuda:0'] * S for S logical shards on "
                "one card)")
        devices = [f"cuda:{j}" for j in range(n)]
    return Mesh(tuple(devices), ids)
