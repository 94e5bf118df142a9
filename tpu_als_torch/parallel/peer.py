"""Device buffers that the processes of a group on one card map into
each other's address space: the transport of kernels K7 and K8 across
processes.

On the TPU, K7 (``gather_solve_ring``) moves the factor shards and K8
(``topk_merge_ring``) the candidate sets between chips by remote DMA
from inside the kernel.  Across the processes of a
:mod:`~tpu_als_torch.parallel.multihost` group on one card the port maps
instead: each process allocates one buffer (:class:`PeerBuffer`,
``csrc/peer_ipc.cu``, ``cudaMalloc`` outside PyTorch's caching
allocator), exports it once as a CUDA IPC handle, the handles are
exchanged once over the group (``multihost.process_allgather`` of the
handle bytes), and each process opens its peers' handles, never its
own.  A kernel is then handed one device array of base pointers, its own
buffer's and its peers' mapped ones in process order, and reads a peer's
rows as it reads its own: nothing goes through host memory.  NCCL
refuses two ranks on one card (``scripts/nccl_one_card.py``); legacy
CUDA IPC does not (``scripts/ipc_one_card.py`` on the card).

The discipline is the caller's, one barrier at a time
(``multihost.barrier`` after a stream sync): a buffer is written, then
synchronized and barriered, then read by the peers, then barriered again
before it is written once more.  :meth:`PeerBuffer.close` is collective:
barrier, each process closes the peers' mappings, barrier, each frees its
own buffer, so no buffer is freed while a peer still maps it.  A mapped
pointer is valid only in the process that opened it: nothing here is
pickled or sent anywhere but the handle bytes.

This module needs CUDA tensors and a process group of more than one
process; the CPU paths of K7 and K8 across processes move their data
with ``multihost.all_gather`` instead, and never reach it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpu_als_torch import _build
from tpu_als_torch.parallel import multihost

#: Peers' buffers this process has mapped and not yet closed, and its own
#: exported buffers not yet freed; a clean teardown leaves both at 0.
OPEN = {"mapped": 0, "exported": 0}


def _call(name, *args):
    _build.check(_build.load(name)(*args), name)


class _Raw:
    """A device buffer as ``__cuda_array_interface__`` (so
    ``torch.as_tensor`` views it without copying or owning it)."""

    def __init__(self, ptr, shape, dtype):
        typestr = {torch.float32: "<f4", torch.int64: "<i8",
                   torch.uint8: "|u1"}[dtype]
        self.__cuda_array_interface__ = {
            "data": (int(ptr), False), "shape": tuple(shape),
            "typestr": typestr, "version": 2}


def view(ptr, shape, dtype, device):
    """A tensor over ``shape`` elements of ``dtype`` at the device address
    ``ptr`` (this process's buffer, or a mapped peer's): no copy, no
    ownership."""
    if dtype == torch.bfloat16:  # the interface has no bfloat16: bytes
        n = int(np.prod(shape))
        raw = torch.as_tensor(_Raw(ptr, (2 * n,), torch.uint8),
                              device=device)
        return raw.view(torch.bfloat16).view(*shape)
    return torch.as_tensor(_Raw(ptr, shape, dtype), device=device)


class PeerBuffer:
    """One device buffer of ``nbytes`` per process, mapped by every peer
    (collective: every process of the group builds it, with the same
    ``nbytes``).  ``ptrs[q]``: process q's buffer as this process reaches
    it (its own address, or its mapping of a peer's)."""

    def __init__(self, nbytes, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a peer buffer lives on a CUDA device, not "
                             f"{device}")
        P, p = multihost.process_count(), multihost.process_index()
        if P < 2:
            raise ValueError("a peer buffer is shared between the "
                             "processes of a group of two or more")
        nbytes = int(nbytes)
        agreed = multihost.process_allgather(np.array([nbytes], np.int64))
        if not (agreed == nbytes).all():
            raise ValueError(f"processes disagree on a peer buffer's size: "
                             f"{agreed.ravel().tolist()}")
        self.nbytes, self.device, self.closed = nbytes, device, False
        with torch.cuda.device(device):
            own = ctypes.c_void_p()
            _call("peer_alloc", nbytes, ctypes.byref(own))
            OPEN["exported"] += 1
            hb = _build.load("peer_handle_bytes")()
            handle = (ctypes.c_ubyte * hb)()
            _call("peer_export", own, handle)
            handles = multihost.process_allgather(
                np.frombuffer(bytes(handle), dtype=np.uint8))
            self.ptrs = []
            for q in range(P):
                if q == p:
                    self.ptrs.append(own.value)
                    continue
                peer = ctypes.c_void_p()
                _call("peer_open", bytes(handles[q]), ctypes.byref(peer))
                OPEN["mapped"] += 1
                self.ptrs.append(peer.value)
        self.own = self.ptrs[p]

    def local(self, shape, dtype, offset=0):
        """This process's buffer (from byte ``offset``) as a tensor of
        ``shape`` and ``dtype``, written in place by the caller."""
        return view(self.own + int(offset), shape, dtype, self.device)

    def close(self):
        """Collective: barrier, close every peer's mapping, barrier, free
        this process's buffer."""
        if self.closed:
            return
        self.closed = True
        p = multihost.process_index()
        torch.cuda.synchronize(self.device)
        multihost.barrier()
        with torch.cuda.device(self.device):
            for q, ptr in enumerate(self.ptrs):
                if q != p:
                    _call("peer_close", ctypes.c_void_p(ptr))
                    OPEN["mapped"] -= 1
            multihost.barrier()
            _call("peer_free", ctypes.c_void_p(self.own))
            OPEN["exported"] -= 1


def publish():
    """After writing this process's buffers: wait for this process's
    stream, then for every process (the peers' writes are then complete
    and visible to the next kernel that reads them, and their reads of
    this process's buffers before the write are done)."""
    torch.cuda.synchronize()
    multihost.barrier()
