"""Parity of the port's top-k with ``tpu_als``.

The port's plain chunked top-k (kernel K5's plain version) is held
against the reference's chunked scan and against its Pallas top-k kernel
in interpret mode.  Neither side promises a tie order, so ids are checked
by the earns-its-score rule: each real slot's id is valid, distinct in
its row, and U·V[id] equals the slot's score.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_als.ops import pallas_topk
from tpu_als.ops import topk as jtopk
from tpu_als_torch.ops import cuda_topk
from tpu_als_torch.ops import topk as ttopk

TOL = 1e-5  # scores: float32 dot products summed in different orders
NEG_INF32 = np.float32(ttopk.NEG_INF)


def _factors(seed, n, Ni, r, frac_valid):
    rng = np.random.default_rng(seed)
    U = (rng.normal(size=(n, r)) / np.sqrt(r)).astype(np.float32)
    V = (rng.normal(size=(Ni, r)) / np.sqrt(r)).astype(np.float32)
    valid = rng.random(Ni) < frac_valid
    return U, V, valid


def _earns_scores(U, V, valid, s, ix):
    real = s > NEG_INF32
    assert valid[ix[real]].all()
    own = np.einsum("nr,nkr->nk", U, V[ix])
    np.testing.assert_allclose(own[real], s[real], rtol=TOL, atol=TOL)
    for row in range(len(s)):
        ids = ix[row][real[row]]
        assert len(set(ids.tolist())) == len(ids)
    assert (np.diff(s, axis=1) <= 0).all()


def _port(U, V, valid, k, **kw):
    s, ix = ttopk.chunked_topk_scores(torch.from_numpy(U),
                                      torch.from_numpy(V),
                                      torch.from_numpy(valid), k, **kw)
    assert s.dtype == torch.float32 and ix.dtype == torch.int64
    return s.numpy(), ix.numpy()


@pytest.mark.parametrize("k,chunk,frac", [(5, 64, 1.0), (7, 64, 0.3),
                                          (16, 1000, 0.9)])
def test_chunked_matches_reference_chunked(k, chunk, frac):
    U, V, valid = _factors(k, 37, 301, 8, frac)
    js, _ = jtopk.chunked_topk_scores(jnp.asarray(U), jnp.asarray(V),
                                      jnp.asarray(valid), k=k,
                                      item_chunk=chunk)
    s, ix = _port(U, V, valid, k, item_chunk=chunk)
    np.testing.assert_allclose(s, np.asarray(js), rtol=TOL, atol=TOL)
    _earns_scores(U, V, valid, s, ix)


@pytest.mark.parametrize("n,Ni,k,frac", [
    (40, 600, 10, 0.5),     # sparse validity
    (24, 20, 32, 0.6),      # catalog smaller than k: sentinel slots
    (24, 700, 128, 0.9),    # the largest k the kernel keeps
])
def test_k5_plain_matches_pallas_topk_interpret(n, Ni, k, frac):
    U, V, valid = _factors(n + Ni + k, n, Ni, 16, frac)
    js, ji = pallas_topk.topk_scores_pallas(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(valid), k, tile_u=16,
        tile_i=128, interpret=True)
    js = np.asarray(js)
    s, ix = _port(U, V, valid, k)
    np.testing.assert_allclose(s, js, rtol=TOL, atol=TOL)
    _earns_scores(U, V, valid, s, ix)
    n_valid = int(valid.sum())
    if n_valid < k:  # surplus slots hold exactly the sentinel on both
        np.testing.assert_array_equal(s[:, n_valid:], NEG_INF32)
        np.testing.assert_array_equal(js[:, n_valid:], NEG_INF32)
        assert (s[:, :n_valid] > NEG_INF32).all()


def test_topk_validity_marks_sentinels():
    U, V, _ = _factors(3, 6, 30, 4, 1.0)
    valid = np.zeros(30, bool)
    valid[[2, 11, 29]] = True
    s, ix = _port(U, V, valid, 5, item_chunk=8)
    mask = ttopk.topk_validity(torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(mask, np.tile([True] * 3 + [False] * 2,
                                                (6, 1)))
    assert np.isin(ix[mask], [2, 11, 29]).all()


def test_k5_wrapper_on_cpu_runs_plain_version():
    U, V, valid = _factors(4, 9, 50, 8, 0.8)
    before = cuda_topk.LAUNCHES
    s, ix = cuda_topk.topk_scores(torch.from_numpy(U), torch.from_numpy(V),
                                  torch.from_numpy(valid), 6)
    ps, pix = _port(U, V, valid, 6)
    np.testing.assert_array_equal(s.numpy(), ps)
    np.testing.assert_array_equal(ix.numpy(), pix)
    assert cuda_topk.LAUNCHES == before


def test_topk_scores_dispatch_matches_reference_on_cpu():
    """The dispatch (K5's wrapper) takes the plain version on CPU tensors,
    with the reference's ``item_chunk``, and agrees with the reference's
    ``topk_scores``."""
    U, V, valid = _factors(6, 11, 90, 8, 0.7)
    args = [torch.from_numpy(a) for a in (U, V, valid)]
    before = cuda_topk.LAUNCHES
    s, ix = cuda_topk.topk_scores(*args, 9, item_chunk=32)
    js, _ = jtopk.topk_scores(jnp.asarray(U), jnp.asarray(V),
                              jnp.asarray(valid), 9, item_chunk=32)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=TOL, atol=TOL)
    _earns_scores(U, V, valid, s.numpy(), ix.numpy())
    assert cuda_topk.LAUNCHES == before


def test_k5_wrapper_rejects_bad_inputs():
    U, V, valid = _factors(5, 4, 20, 8, 1.0)
    tU, tV, tvalid = (torch.from_numpy(a) for a in (U, V, valid))
    with pytest.raises(TypeError):
        cuda_topk.topk_scores(tU.double(), tV, tvalid, 3)
    with pytest.raises(TypeError):
        cuda_topk.topk_scores(tU, tV, tvalid.float(), 3)
    with pytest.raises(ValueError):
        cuda_topk.topk_scores(tU, tV[:, :4], tvalid, 3)


def test_topk_route_follows_k():
    """On the card ``topk_scores`` picks its route from k alone, as the
    reference's dispatch does: nothing at k = 0, K5 up to its 128
    candidates, the chunked scan above."""
    assert cuda_topk.topk_route(0) == "empty"
    assert cuda_topk.topk_route(1) == "kernel"
    assert cuda_topk.topk_route(cuda_topk.MAX_K) == "kernel"
    assert cuda_topk.topk_route(cuda_topk.MAX_K + 1) == "scan"
    assert cuda_topk.topk_route(200) == "scan"
    U, V, valid = _factors(8, 5, 40, 4, 1.0)
    s, ix = cuda_topk.topk_scores(torch.from_numpy(U), torch.from_numpy(V),
                                  torch.from_numpy(valid), 0)
    assert s.shape == ix.shape == (5, 0)
    assert s.dtype == torch.float32 and ix.dtype == torch.int64
    with pytest.raises(ValueError, match=">= 0"):
        cuda_topk.topk_scores(torch.from_numpy(U), torch.from_numpy(V),
                              torch.from_numpy(valid), -1)


def _k200_models():
    """One model in both packages: 37 users, a 301-item catalog, rank 8."""
    import tpu_als
    import tpu_als_torch
    from tpu_als.core.ratings import IdMap

    U, V, _ = _factors(200, 37, 301, 8, 1.0)
    params = {"userCol": "user", "itemCol": "item", "ratingCol": "rating",
              "predictionCol": "prediction", "coldStartStrategy": "nan",
              "blockSize": 16, "regParam": 0.1}
    uids, iids = 10 + np.arange(37), 3 + 2 * np.arange(301)
    tm = tpu_als_torch.model_from_arrays(8, uids, U, iids, V, params,
                                         device="cpu")
    jm = tpu_als.ALSModel(8, IdMap(ids=uids), IdMap(ids=iids), U, V, params)
    return tm, jm, U, V


def test_recommend_arrays_k200_matches_reference():
    """k = 200 (the scan route on the card): scores within TOL of the
    reference's, each id earning its score; the same for
    ``recommendForAllUsers`` (blocks of 16 users) and for the sharded
    strategies on 2 shards of 151 items (more than K5's 128 a shard)."""
    from tpu_als_torch.parallel.mesh import make_mesh

    tm, jm, U, V = _k200_models()
    valid = np.ones(301, bool)
    q, ids, sc = tm.recommend_arrays(200)
    jq, jids, jsc = jm.recommend_arrays(200)
    np.testing.assert_array_equal(q, jq)
    assert ids.shape == sc.shape == (37, 200) and ids.dtype == jids.dtype
    np.testing.assert_allclose(sc, jsc, rtol=TOL, atol=TOL)
    _earns_scores(U, V, valid, sc, tm._item_map.to_dense(ids))
    tr, jr = tm.recommendForAllUsers(200), jm.recommendForAllUsers(200)
    rg = tr["recommendations"]
    np.testing.assert_allclose(rg["rating"], jr["recommendations"]["rating"],
                               rtol=TOL, atol=TOL)
    _earns_scores(U, V, valid, rg["rating"],
                  tm._item_map.to_dense(rg["item"]))
    for strategy in ("merge_ring", "ring", "all_gather"):
        _, ids, sc = tm.recommend_arrays(200, mesh=make_mesh(
            devices=["cpu"] * 2), gatherStrategy=strategy)
        np.testing.assert_allclose(sc, jsc, rtol=TOL, atol=TOL)
        _earns_scores(U, V, valid, sc, tm._item_map.to_dense(ids))
