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

A mesh whose shards sit on more than one device raises
``NotImplementedError``: the transport across cards (peer-mapped shard
pointers over NVLink, or NCCL) is not written yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    """S shards in ring order; ``devices[s]`` holds shard s."""

    devices: tuple

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
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


def make_mesh(n_devices=None, devices=None):
    """A 1-D mesh.  Without ``devices``: one shard per visible CUDA card
    (``n_devices`` of them; more than are visible raises, as in the
    reference, rather than building a silently smaller mesh — and more
    than one card raises ``NotImplementedError``).  With ``devices``: one
    shard per entry, so ``["cuda:0"] * S`` is S logical shards on one
    card."""
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
    return Mesh(tuple(devices))
