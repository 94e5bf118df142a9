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


def _tie_corpus(seed, n, Ni, r, pool=7):
    """The reference's integer tie corpus: every f32 score exact."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-3, 4, size=(pool, r)).astype(np.float32)
    V = base[rng.integers(0, pool, Ni)]
    U = rng.integers(-3, 4, size=(n, r)).astype(np.float32)
    return U, V, rng.random(Ni) < 0.8


@pytest.mark.parametrize("P", [1, 2, 3, 7])
def test_topk_parts_plain_bitwise_on_tie_corpus(P):
    """The catalog cut in P parts as the kernel cuts it (1,000 items: 8
    item tiles), each part's stable top-k merged in part order: bitwise
    the port's and the reference's chunked scan, scores and ids."""
    U, V, valid = _tie_corpus(30 + P, 29, 1000, 16)
    args = [torch.from_numpy(a) for a in (U, V, valid)]
    for k in (1, 10, 128):
        s, ix = cuda_topk.topk_parts_plain(*args, k, P)
        cs, ci = ttopk.chunked_topk_scores(*args, k)
        js, ji = jtopk.chunked_topk_scores(jnp.asarray(U), jnp.asarray(V),
                                           jnp.asarray(valid), k=k)
        for want in ((cs.numpy(), ci.numpy()),
                     (np.asarray(js), np.asarray(ji))):
            np.testing.assert_array_equal(s.numpy(), want[0])
            np.testing.assert_array_equal(ix.numpy(), want[1])
        # the wrapper on CPU tensors with parts= is this plain version
        ws, wi = cuda_topk.topk_scores(*args, k, parts=P)
        assert torch.equal(ws, s) and torch.equal(wi, ix)


@pytest.mark.parametrize("n,Ni,k,P", [(24, 700, 10, 3), (24, 700, 128, 6),
                                      (16, 60, 32, 2)])
def test_topk_parts_plain_matches_pallas_topk_interpret(n, Ni, k, P):
    U, V, valid = _factors(n + Ni + P, n, Ni, 16, 0.7)
    js, _ = pallas_topk.topk_scores_pallas(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(valid), k, tile_u=16,
        tile_i=128, interpret=True)
    s, ix = cuda_topk.topk_parts_plain(torch.from_numpy(U),
                                       torch.from_numpy(V),
                                       torch.from_numpy(valid), k, P)
    s, ix = s.numpy(), ix.numpy()
    np.testing.assert_allclose(s, np.asarray(js), rtol=TOL, atol=TOL)
    _earns_scores(U, V, valid, s, ix)


def test_topk_parts_properties():
    """S·P <= 32 (one merge lane per set); P = 1 when the (user tile,
    shard) blocks already give two waves; every part at least one item
    tile, the parts whole tiles in id order covering the shard."""
    T_U, T_I = cuda_topk.TILE_U, cuda_topk.TILE_I
    for sms in (1, 8, 132):
        for S in (1, 2, 3, 4, 8, 32):
            for n in (1, 63, 64, 4096, 8229, 172_781):
                for ni in (1, 50, 128, 129, 1000, 59_047):
                    P = cuda_topk.topk_parts(n, ni, S, sms)
                    assert 1 <= P and S * P <= cuda_topk.MERGE_LANES
                    blocks = -(-n // T_U) * S
                    if blocks >= 2 * sms:
                        assert P == 1
                    bounds = cuda_topk.part_bounds(ni, P)
                    assert bounds[0][0] == 0 and bounds[-1][1] == ni
                    for (lo, hi), nxt in zip(bounds, bounds[1:] + [None]):
                        assert hi - lo >= 1 and lo % T_I == 0
                        assert nxt is None or nxt[0] == hi
    # a small call on a large card is cut; a large one is not
    assert cuda_topk.topk_parts(4096, 59_047, 1, 132) == 4
    assert cuda_topk.topk_parts(172_781, 59_047, 1, 132) == 1
    assert cuda_topk.topk_parts(4096, 14_762, 4, 132) == 1
    assert cuda_topk.topk_parts(1024, 14_762, 4, 132) == 4
    assert cuda_topk.topk_parts(100, 59_047, 1, 132) == 32


def _split_tf32(x):
    """csrc/topk.cuh::split_trunc on a float32 tensor, as the tensor cores
    read it: big = x with its low 13 bits cleared, small = x - big read
    as TF32 (its low 13 bits cleared too)."""
    mask = torch.tensor(-8192, dtype=torch.int32)  # 0xffffe000
    big = (x.view(torch.int32) & mask).view(torch.float32)
    small = ((x - big).view(torch.int32) & mask).view(torch.float32)
    return big, small


def _scores_3xtf32(U, V):
    """The kernel's score in torch: the rank padded to a multiple of 8,
    each operand split in two TF32 values, per 32-rank chunk a zeroed
    partial of small·big + big·small + big·big (each TF32 product exact
    in f32), added to the running score by f32 adds."""
    r8 = -(-U.shape[1] // 8) * 8
    U = torch.nn.functional.pad(U, (0, r8 - U.shape[1]))
    V = torch.nn.functional.pad(V, (0, r8 - V.shape[1]))
    (ub, us), (vb, vs) = _split_tf32(U), _split_tf32(V)
    run = torch.zeros(U.shape[0], V.shape[0], dtype=torch.float32)
    for d in range(0, r8, 32):
        c = slice(d, d + 32)
        run += (us[:, c] @ vb[:, c].T + ub[:, c] @ vs[:, c].T) \
            + ub[:, c] @ vb[:, c].T
    return run


def test_3xtf32_score_exact_on_tie_corpus():
    U, V, _ = _tie_corpus(5, 40, 300, 40)
    s = _scores_3xtf32(torch.from_numpy(U), torch.from_numpy(V))
    np.testing.assert_array_equal(s.numpy(), U.astype(np.float64)
                                  @ V.astype(np.float64).T)


# |3xTF32 score - float64| on unit rows: each operand loses < 2^-20 of
# itself and the dropped small·small term is < 2^-20 of a product, so
# each product is off by < 3·2^-20 of itself and the score by < 3·2^-20
# of Σ|u_d v_d| <= 1, plus the f32 sums' rounding: held to 3e-6, below
# chip_smoke.py's K5_TOL (1e-5)
TF32_BOUND = 3e-6


@pytest.mark.parametrize("r", [128, 256])
def test_3xtf32_score_within_bound_of_float64(r):
    rng = np.random.default_rng(r)
    U = rng.standard_normal((64, r))
    V = rng.standard_normal((2048, r))
    U = (U / np.linalg.norm(U, axis=1, keepdims=True)).astype(np.float32)
    V = (V / np.linalg.norm(V, axis=1, keepdims=True)).astype(np.float32)
    s = _scores_3xtf32(torch.from_numpy(U), torch.from_numpy(V)).numpy()
    err = np.abs(s - U.astype(np.float64) @ V.astype(np.float64).T).max()
    assert err <= TF32_BOUND
