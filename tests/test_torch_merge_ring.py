"""Tie order and the sharded top-k: the port against ``tpu_als``.

The corpora are the reference's integer tie corpus
(``tests/test_serve_fabric.py``): integer factors, the catalog drawn from
a 7-row palette, so every float32 score is exact whatever the order of
its sums and ties are the common case.  The bar is then bitwise equality,
scores AND ids:

- the port's ``chunked_topk_scores`` (kernel K5's plain version) against
  the reference's, over seeds and item chunks — ``lax.top_k``'s order:
  score descending, the lower column first on a tie;
- kernel K8's plain version and ``topk_sharded(..., 'merge_ring')`` on S
  logical shards against the reference's ``topk_sharded(...,
  make_mesh(S), strategy='merge_ring')`` (its Pallas kernel in interpret
  mode), with an all-invalid shard and with k above a shard's size;
- ``'all_gather'`` and ``'ring'``, whose tie order neither package
  promises, on equal scores and on ids that earn them;
- ``recommendForAllUsers(..., mesh=...)`` against the reference's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpu_als
from tpu_als.ops.topk import chunked_topk_scores as j_chunked
from tpu_als.parallel.mesh import make_mesh as j_make_mesh
from tpu_als.parallel.serve import topk_sharded as j_topk_sharded
import tpu_als_torch
from tpu_als_torch.ops import cuda_topk
from tpu_als_torch.ops.topk import NEG_INF, chunked_topk_scores, merge_topk
from tpu_als_torch.parallel.mesh import make_mesh
from tpu_als_torch.parallel.serve import topk_sharded

NEG_INF32 = np.float32(NEG_INF)


def _tie_corpus(rng, nu, ni, r, pool=7):
    base = rng.integers(-3, 4, size=(pool, r)).astype(np.float32)
    V = base[rng.integers(0, pool, ni)]
    U = rng.integers(-3, 4, size=(nu, r)).astype(np.float32)
    return U, V


def _reference(U, V, valid, k, item_chunk=8192):
    s, i = j_chunked(jnp.asarray(U), jnp.asarray(V), jnp.asarray(valid),
                     k=k, item_chunk=item_chunk)
    return np.asarray(s), np.asarray(i)


def _equal(got, ref):
    s, ix = (np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)
             for t in got)
    np.testing.assert_array_equal(s, ref[0])
    np.testing.assert_array_equal(ix, ref[1])


def _mesh(S):
    return make_mesh(devices=["cpu"] * S)


@pytest.mark.parametrize("item_chunk", [8192, 32, 7])
def test_chunked_topk_tie_order_is_the_references(item_chunk):
    for seed in range(20):
        rng = np.random.default_rng(seed)
        U, V = _tie_corpus(rng, 23, 90, 16)
        valid = rng.random(90) < 0.85
        got = chunked_topk_scores(torch.from_numpy(U), torch.from_numpy(V),
                                  torch.from_numpy(valid), 6,
                                  item_chunk=item_chunk)
        _equal(got, _reference(U, V, valid, 6, item_chunk))


def test_chunked_topk_surplus_slots_hold_the_sentinel_and_id_zero():
    rng = np.random.default_rng(1)
    U, V = _tie_corpus(rng, 5, 12, 8)
    valid = np.zeros(12, bool)
    valid[[3, 9]] = True
    s, ix = chunked_topk_scores(torch.from_numpy(U), torch.from_numpy(V),
                                torch.from_numpy(valid), 5, item_chunk=4)
    assert (s[:, 2:] == NEG_INF32).all() and (ix[:, 2:] == 0).all()
    _equal((s, ix), _reference(U, V, valid, 5, 4))


def test_merge_topk_keeps_the_carried_set_first_on_ties():
    s1 = torch.tensor([[3.0, 2.0, NEG_INF]])
    i1 = torch.tensor([[4, 7, 0]])
    s2 = torch.tensor([[3.0, 2.0, 1.0]])
    i2 = torch.tensor([[1, 2, 5]])
    s, ix = merge_topk(s1, i1, s2, i2, 4)
    assert s.tolist() == [[3.0, 3.0, 2.0, 2.0]]
    assert ix.tolist() == [[4, 1, 7, 2]]


@pytest.mark.parametrize("S", [1, 3, 8])
def test_merge_ring_bitwise_equal_to_reference_merge_ring(S):
    rng = np.random.default_rng(40 + S)
    U, V = _tie_corpus(rng, 23, 90, 16)
    valid = rng.random(90) < 0.85
    ref = j_topk_sharded(U, V, 6, j_make_mesh(S), strategy="merge_ring",
                         item_valid=valid)
    _equal(topk_sharded(U, V, 6, _mesh(S), strategy="merge_ring",
                        item_valid=valid), ref)
    # the K8 wrapper on CPU tensors is its plain version: no launch
    ni_loc = -(-90 // S)
    Vp = np.zeros((S * ni_loc, 16), np.float32)
    Vp[:90] = V
    vp = np.zeros(S * ni_loc, bool)
    vp[:90] = valid
    before = cuda_topk.MERGE_LAUNCHES
    got = cuda_topk.topk_merge_ring(
        torch.from_numpy(U), torch.from_numpy(Vp).reshape(S, ni_loc, 16),
        torch.from_numpy(vp).reshape(S, ni_loc), 6)
    assert cuda_topk.MERGE_LAUNCHES == before
    _equal(got, ref)


def test_merge_ring_all_invalid_shard():
    rng = np.random.default_rng(11)
    U, V = _tie_corpus(rng, 11, 64, 8)
    valid = np.ones(64, bool)
    valid[16:24] = False  # shard 2 of 8 entirely masked
    s, ix = topk_sharded(U, V, 5, _mesh(8), strategy="merge_ring",
                         item_valid=valid)
    _equal((s, ix), j_topk_sharded(U, V, 5, j_make_mesh(8),
                                   strategy="merge_ring", item_valid=valid))
    assert not np.isin(ix.numpy(), np.arange(16, 24)).any()


def test_merge_ring_k_exceeds_shard():
    rng = np.random.default_rng(12)
    U, V = _tie_corpus(rng, 9, 16, 8)
    valid = rng.random(16) < 0.6  # with sentinel slots past the valid ones
    for k in (5, 14):
        _equal(topk_sharded(U, V, k, _mesh(8), strategy="merge_ring",
                            item_valid=valid),
               j_topk_sharded(U, V, k, j_make_mesh(8), strategy="merge_ring",
                              item_valid=valid))


@pytest.mark.parametrize("strategy", ["all_gather", "ring"])
@pytest.mark.parametrize("S", [3, 8])
def test_gather_and_ring_strategies_match_reference_scores(strategy, S):
    rng = np.random.default_rng(20 + S)
    U, V = _tie_corpus(rng, 30, 77, 16)
    valid = rng.random(77) < 0.8
    js, _ = j_topk_sharded(U, V, 6, j_make_mesh(S), strategy=strategy,
                           item_valid=valid)
    s, ix = topk_sharded(U, V, 6, _mesh(S), strategy=strategy,
                         item_valid=valid)
    s, ix = s.numpy(), ix.numpy()
    np.testing.assert_array_equal(s, js)
    real = s > NEG_INF32
    assert valid[ix[real]].all()
    own = np.einsum("nr,nkr->nk", U, V[ix])
    np.testing.assert_array_equal(own[real], s[real])  # each id earns it
    for row in range(len(s)):
        assert len(set(ix[row][real[row]].tolist())) == int(real[row].sum())


def test_k_above_128_takes_the_ring():
    rng = np.random.default_rng(3)
    U, V = _tie_corpus(rng, 4, 300, 8)
    s, ix = topk_sharded(U, V, 200, _mesh(3), strategy="merge_ring")
    np.testing.assert_array_equal(s.numpy(),
                                  _reference(U, V, np.ones(300, bool),
                                             200)[0])
    with pytest.raises(ValueError, match="k <= 128"):
        cuda_topk.topk_merge_ring(torch.from_numpy(U),
                                  torch.from_numpy(V).reshape(3, 100, 8),
                                  torch.ones(3, 100, dtype=torch.bool), 200)
    with pytest.raises(ValueError, match="serving strategy"):
        topk_sharded(U, V, 5, _mesh(3), strategy="bogus")


@pytest.mark.parametrize("strategy", ["merge_ring", "all_gather"])
def test_recommend_for_all_users_over_a_mesh_matches_reference(strategy):
    rng = np.random.default_rng(9)
    U, V = _tie_corpus(rng, 26, 40, 8)
    params = {"userCol": "user", "itemCol": "item", "ratingCol": "rating",
              "predictionCol": "prediction", "coldStartStrategy": "nan",
              "blockSize": 4096, "regParam": 0.1}
    uids, iids = 100 + np.arange(26), 7 + 2 * np.arange(40)
    tm = tpu_als_torch.model_from_arrays(8, uids, U, iids, V, params,
                                         device="cpu")
    jm = tpu_als.ALSModel(8, tpu_als.core.ratings.IdMap(ids=uids),
                          tpu_als.core.ratings.IdMap(ids=iids), U, V,
                          params)
    got = tm.recommendForAllUsers(5, mesh=_mesh(4),
                                  gatherStrategy=strategy)
    ref = jm.recommendForAllUsers(5, mesh=j_make_mesh(4),
                                  gatherStrategy=strategy)
    np.testing.assert_array_equal(got["user"], ref["user"])
    rg, rr = got["recommendations"], ref["recommendations"]
    np.testing.assert_array_equal(rg["rating"], rr["rating"])
    if strategy == "merge_ring":
        np.testing.assert_array_equal(rg["item"], rr["item"])
    q, ids, sc = tm.recommend_arrays(5, mesh=_mesh(4),
                                     gatherStrategy=strategy)
    np.testing.assert_array_equal(sc, rr["rating"])
    np.testing.assert_array_equal(q, uids)
