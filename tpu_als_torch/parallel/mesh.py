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

Across processes (:mod:`tpu_als_torch.parallel.multihost`): under an
initialized process group of P processes each process lists its own L
shards, and the mesh spans them all: ``global_size`` is P·L and this
process holds the ``positions`` p·L .. p·L + L - 1 (its shards' default
ids).  Building the mesh is collective: every process builds it, and a
shard count that differs across processes raises on every process.  The
one-device rule above holds for the shards of one process.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from tpu_als_torch.parallel import multihost


class Shard(NamedTuple):
    """One shard of a mesh: its logical id and the device it sits on."""

    id: int
    device: torch.device


@dataclass(frozen=True)
class Mesh:
    """S shards in ring order; ``devices[s]`` holds shard s, whose
    logical id is ``ids[s]`` (default: its mesh position).  Across P
    processes these are this process's shards, and ``process_count`` /
    ``process_index`` are the group's (module docstring)."""

    devices: tuple
    ids: tuple = None
    process_count: int = field(init=False, default=1)
    process_index: int = field(init=False, default=0)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        P, p = multihost.process_count(), multihost.process_index()
        if P > 1:
            counts = multihost.process_allgather(
                np.array([len(self.devices)], dtype=np.int64)).ravel()
            if not (counts == counts[0]).all():
                raise ValueError(
                    f"processes list different shard counts for one mesh "
                    f"({counts.tolist()}); every process must hold as many "
                    "shards")
        object.__setattr__(self, "process_count", P)
        object.__setattr__(self, "process_index", p)
        L = len(self.devices)
        ids = (tuple(range(p * L, p * L + L)) if self.ids is None
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
        """This process's shards (all of them in one process)."""
        return len(self.devices)

    @property
    def global_size(self):
        """The mesh's positions across every process, P·L."""
        return self.process_count * len(self.devices)

    @property
    def positions(self):
        """The mesh positions this process's shards hold, p·L .. p·L+L-1."""
        L = len(self.devices)
        return tuple(range(self.process_index * L,
                           (self.process_index + 1) * L))

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
