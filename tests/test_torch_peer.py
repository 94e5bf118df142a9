"""K7's and K8's halves across processes, simulated in one process, and
their transport's guards, against ``tpu_als``.

Across the processes of a group on one card K7 runs on each process's
owners over every source (the grid's source axis rolled to the process's
first position, ``parallel/comm.py::roll_sources``), and K8 runs in two
halves, scan-to-sets and merge-from-sets (``ops/cuda_topk.py``).  Their
plain versions, which the CPU runs, are driven here for every process of
a P-process mesh in turn, with the data the processes would exchange
passed by hand:

- K8's halves at P = 2 and 4 processes, 1 and 2 shards each, 1 and 2
  parts a shard, on the reference's integer tie corpus: every process's
  rows equal the one-process plain K8 AND the reference's
  ``chunked_topk_scores`` over the whole catalog, scores and ids, bit
  for bit;
- K7 on the rolled grid of each process: its owners' rows equal the
  one-process plain K7's over the full grid bit for bit;
- the guards: a CUDA tensor gets a kernel or an error (mapped shards or
  sets off the card raise), a peer buffer needs a group and a card, a
  ``file://`` rendezvous names a fresh store.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_als.ops.topk import chunked_topk_scores as j_chunked
from tpu_als_torch.core.ratings import Bucket
from tpu_als_torch.ops import cuda_gather_ne, cuda_topk
from tpu_als_torch.parallel import comm, multihost, peer

RANK = 16


def _tie_corpus(rng, nu, ni, r, pool=7):
    base = rng.integers(-3, 4, size=(pool, r)).astype(np.float32)
    V = base[rng.integers(0, pool, ni)]
    U = rng.integers(-3, 4, size=(nu, r)).astype(np.float32)
    return U, V


@pytest.mark.parametrize("P,L,parts", [(2, 2, 1), (2, 1, 2), (4, 1, 1),
                                       (2, 2, 2)])
def test_k8_halves_across_processes_are_the_one_process_k8(P, L, parts):
    rng = np.random.default_rng(P * 10 + L + parts)
    n, ni, r, k = 150, 389, 6, 12
    U, V = _tie_corpus(rng, n, ni, r)
    valid = rng.random(ni) > 0.1
    S = P * L
    ni_loc = -(-ni // S)
    Vp = np.zeros((S * ni_loc, r), np.float32)
    Vp[:ni] = V
    vp = np.zeros(S * ni_loc, bool)
    vp[:ni] = valid
    Ut = torch.from_numpy(U)
    Vs = torch.from_numpy(Vp).reshape(S, ni_loc, r)
    vs = torch.from_numpy(vp).reshape(S, ni_loc)
    tiles = -(-n // cuda_topk.TILE_U)
    shape = (tiles, L * parts, cuda_topk.TILE_U, k)
    sets = []
    for p in range(P):       # each process's scan-to-sets
        cs = torch.empty(shape, dtype=torch.float32)
        ci = torch.empty(shape, dtype=torch.int64)
        cuda_topk.topk_sets(Ut, Vs[p * L:(p + 1) * L],
                            vs[p * L:(p + 1) * L], k, parts=parts,
                            first=p * L, coll_s=cs, coll_i=ci, n_shards=S)
        sets.append((cs, ci))
    every = tuple(torch.cat([x[j] for x in sets], dim=1) for j in (0, 1))
    one = cuda_topk.topk_merge_ring_plain(Ut, Vs, vs, k, parts)
    ref_s, ref_i = j_chunked(jnp.asarray(U), jnp.asarray(V),
                             jnp.asarray(valid), k=k)
    nu_loc = -(-n // S)
    for p in range(P):       # each process's merge-from-sets of its rows
        lo, hi = min(n, p * L * nu_loc), min(n, (p + 1) * L * nu_loc)
        s, ix = cuda_topk.topk_merge_sets(every, k, lo, hi - lo)
        np.testing.assert_array_equal(s.numpy(), one[0][lo:hi].numpy())
        np.testing.assert_array_equal(ix.numpy(), one[1][lo:hi].numpy())
        np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s)[lo:hi])
        np.testing.assert_array_equal(ix.numpy(), np.asarray(ref_i)[lo:hi])


def test_k7_on_each_process_rolled_grid_is_the_one_process_k7():
    """One bucket of a 4-position ring, 2 processes of 2 owners: each
    process's owners over its grid and the shards rolled to its first
    position equal the one-process K7's rows bit for bit (the
    one-process rows are held to the reference's ring kernel by
    ``tests/test_torch_ring.py``, and the two-process fit to the
    reference's fit by ``tests/test_torch_multihost.py``)."""
    rng = np.random.default_rng(3)
    P, L, per, n, w, r = 2, 2, 10, 6, 4, RANK
    S = P * L
    V = (rng.normal(size=(S * per, r)) / np.sqrt(r)).astype(np.float32)
    cols = rng.integers(0, per, size=(S, S, n, w)).astype(np.int32)
    mask = (rng.random(size=(S, S, n, w)) < 0.7).astype(np.float32)
    vals = ((np.abs(rng.normal(size=(S, S, n, w))) * 4 + 0.1)
            * mask).astype(np.float32)
    YtY = V.T @ V
    V_sh = torch.from_numpy(V).reshape(S, per, r)
    c, v, m = (torch.from_numpy(a) for a in (cols, vals, mask))

    def k7(shards, b):
        return cuda_gather_ne.gather_fused_ring_implicit(
            shards, b.cols, b.vals, b.mask, 0.05, 40.0,
            torch.from_numpy(YtY))

    one = k7(V_sh, Bucket(rows=None, cols=c, vals=v, mask=m))
    for p in range(P):
        pos = slice(p * L, (p + 1) * L)
        mine = Bucket(rows=torch.zeros(L, n, dtype=torch.int32),
                      cols=c[pos], vals=v[pos], mask=m[pos])
        rolled = comm.roll_sources([mine], p * L)[0]
        got = k7(torch.roll(V_sh, -p * L, 0), rolled)
        np.testing.assert_array_equal(got.numpy(), one[pos].numpy())


def test_roll_sources_at_position_0_is_the_grid():
    b = Bucket(rows=torch.zeros(1, 2, dtype=torch.int32),
               cols=torch.arange(24, dtype=torch.int32).reshape(1, 3, 2, 4),
               vals=torch.ones(1, 3, 2, 4), mask=torch.ones(1, 3, 2, 4))
    assert comm.roll_sources([b], 0)[0] is b
    rolled = comm.roll_sources([b], 1)[0]
    np.testing.assert_array_equal(rolled.cols[0, 0].numpy(),
                                  b.cols[0, 1].numpy())
    np.testing.assert_array_equal(rolled.cols[0, 2].numpy(),
                                  b.cols[0, 0].numpy())


def test_mapped_shards_and_sets_off_the_card_raise():
    """A base-pointer array is the card's: off it, K7's mapped entry and
    K8's merge-from-sets raise, and gathered sets on a device other than
    the CPU never reach the plain merge."""
    bases = torch.zeros(4, dtype=torch.int64)
    mapped = cuda_gather_ne.MappedShards(bases, 5, 4, torch.float32)
    assert mapped.shape == (4, 5, 4)
    cols = torch.zeros(2, 4, 3, 2, dtype=torch.int32)
    w = torch.zeros(2, 4, 3, 2)
    with pytest.raises(ValueError, match="on the card"):
        cuda_gather_ne.gather_solve_ring(mapped, cols, w, w, w,
                                         two_sided=True, reg=0.1)
    with pytest.raises(ValueError, match="on the card"):
        cuda_topk.topk_merge_sets(
            cuda_topk.MappedSets(bases[:2], bases[:2], 3), 5, 0, 4)
    meta = torch.empty(1, 2, cuda_topk.TILE_U, 5, device="meta")
    with pytest.raises(ValueError, match="MappedSets on the card"):
        cuda_topk.topk_merge_sets((meta, meta.long()), 5, 0, 4)
    with pytest.raises(ValueError, match="1 <= k"):
        cuda_topk.topk_merge_sets((meta, meta.long()), 200, 0, 4)


def test_topk_sets_checks_its_scratch():
    U = torch.zeros(70, 4)
    V = torch.zeros(2, 10, 4)
    valid = torch.ones(2, 10, dtype=torch.bool)
    bad = torch.empty(1, 2, cuda_topk.TILE_U, 5)     # 70 rows: 2 tiles
    with pytest.raises(ValueError, match="writes f32 scores"):
        cuda_topk.topk_sets(U, V, valid, 5, parts=1, first=0, coll_s=bad,
                            coll_i=bad.long(), n_shards=4)
    with pytest.raises(ValueError, match="1 <= k"):
        cuda_topk.topk_sets(U, V, valid, 129, parts=1, first=0,
                            coll_s=bad, coll_i=bad.long(), n_shards=4)


def test_peer_buffer_needs_a_card_and_a_group():
    with pytest.raises(ValueError, match="CUDA device"):
        peer.PeerBuffer(64, "cpu")
    with pytest.raises(ValueError, match="group of two or more"):
        peer.PeerBuffer(64, "cuda:0")
    assert peer.OPEN == {"mapped": 0, "exported": 0}


def test_file_init_method_names_a_fresh_store(tmp_path):
    a = multihost.file_init_method(str(tmp_path))
    b = multihost.file_init_method(str(tmp_path))
    assert a != b
    for x in (a, b):
        assert x.startswith("file://")
        path = x[len("file://"):]
        assert os.path.dirname(path) == str(tmp_path)
        assert not os.path.exists(path)
