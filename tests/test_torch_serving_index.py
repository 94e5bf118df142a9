"""Parity of the port's int8 candidate index with ``tpu_als.serving.index``.

Inputs from a seeded numpy generator go through both packages in one
process (JAX on the CPU, torch with ``device="cpu"``).  Tolerances:

- ``_quantize_rows`` and the approximate scores (int32 shortlist GEMM,
  then ``acc * su * sv`` in f32): bitwise;
- ``topk`` against the reference: scores within SERVE_ULPS units in the
  last place (the two rescores contract in different libraries), ids
  equal on rows whose scores are unique, and every id earning its score
  (its float64 ``u·v`` within 1e-5, the reference suite's band);
- delta-segment and compacted ``topk`` against a rebuild of the updated
  catalog within the port: bitwise scores, equal ids on untied rows;
- the sharded index on 3 CPU logical shards against the local index:
  within SERVE_ULPS.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_als.serving import index as jidx
from tpu_als_torch.ops.topk import NEG_INF, chunked_topk_scores
from tpu_als_torch.parallel.mesh import make_mesh
from tpu_als_torch.serving import index as tidx

SERVE_ULPS = 4
EARN_TOL = 1e-5


def _both(V, valid=None, sk=64):
    return (jidx.Int8CandidateIndex(V, valid, shortlist_k=sk),
            tidx.Int8CandidateIndex(V, valid, shortlist_k=sk,
                                    device="cpu"))


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    real = b > NEG_INF
    assert np.array_equal(a > NEG_INF, real)   # sentinels exactly
    if not real.any():
        return 0.0
    return float((np.abs(a - b)[real] / np.spacing(np.abs(b[real]))).max())


def _earns(U, V, valid, s, ix):
    s, ix = np.asarray(s), np.asarray(ix)
    real = s > NEG_INF
    assert valid[ix[real]].all()
    own = np.einsum("nr,nkr->nk", U.astype(np.float64),
                    V.astype(np.float64)[ix])
    np.testing.assert_allclose(own[real], s[real], rtol=EARN_TOL,
                               atol=EARN_TOL)


def _same_as_reference(U, V, valid, j, t, k):
    js, jx = (np.asarray(a) for a in j.topk(U, k))
    ts, tx = (a.numpy() for a in t.topk(torch.from_numpy(U), k))
    assert _ulps(ts, js) <= SERVE_ULPS
    for row in range(ts.shape[0]):
        real = ts[row] > NEG_INF
        if len(np.unique(js[row][real])) == real.sum():
            np.testing.assert_array_equal(tx[row][real], jx[row][real])
    _earns(U, V, valid, ts, tx)
    return ts, tx


@pytest.mark.parametrize("shape", [(50, 4), (257, 24), (96, 8), (7, 3)])
def test_quantize_rows_bitwise(shape):
    rng = np.random.default_rng(shape[0])
    X = rng.normal(size=shape).astype(np.float32) * 3.0
    X[1] = 0.0                                   # a zero row: scale 1
    qj, sj = jidx._quantize_rows(jnp.asarray(X))
    qt, st = tidx._quantize_rows(torch.from_numpy(X))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert st[1] == 1.0 and not qt[1].any()


@pytest.mark.parametrize("n,Ni,r", [(5, 37, 3), (13, 257, 24),
                                    (33, 1000, 64)])
def test_int8_approx_scores_bitwise(n, Ni, r):
    """int32 accumulation is exact and the f32 order is the reference's,
    so the shortlist's scores are bitwise, padding for ``torch._int_mm``'s
    CUDA shapes included (none of these is a multiple of 8)."""
    rng = np.random.default_rng(n)
    U = rng.normal(size=(n, r)).astype(np.float32)
    V = rng.normal(size=(Ni, r)).astype(np.float32)
    Uq, su = jidx._quantize_rows(jnp.asarray(U))
    Vq, sv = jidx._quantize_rows(jnp.asarray(V))
    acc = jnp.einsum("nr,cr->nc", Uq, Vq, preferred_element_type=jnp.int32)
    ref = acc.astype(jnp.float32) * su[:, None] * sv[None, :]
    tUq, tsu = tidx._quantize_rows(torch.from_numpy(U))
    tVq, tsv = tidx._quantize_rows(torch.from_numpy(V))
    tacc = tidx._int8_mm(tUq, tVq)
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(acc))
    np.testing.assert_array_equal(tidx._approx(tacc, tsu, tsv).numpy(),
                                  np.asarray(ref))


@pytest.mark.parametrize("n,Ni,r,k,sk,seed", [
    (1, 50, 4, 5, 20, 0),
    (13, 257, 24, 10, 40, 1),
    (33, 1000, 64, 10, 64, 2),
    (8, 96, 8, 8, 96, 3),       # shortlist == catalog
    (5, 7, 3, 7, 7, 4),         # k == catalog size
])
def test_topk_matches_reference_random(n, Ni, r, k, sk, seed):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n, r)).astype(np.float32)
    V = rng.normal(size=(Ni, r)).astype(np.float32)
    valid = np.ones(Ni, bool)
    j, t = _both(V, valid, sk)
    ts, _ = _same_as_reference(U, V, valid, j, t, k)
    if sk >= Ni:       # the shortlist is the catalog: the exact top-k
        es, _ = chunked_topk_scores(torch.from_numpy(U),
                                    torch.from_numpy(V),
                                    torch.from_numpy(valid), k)
        assert _ulps(ts, es.numpy()) <= SERVE_ULPS


@pytest.mark.parametrize("seed", range(4))
def test_topk_duplicate_scores(seed):
    """Adversarial ties: the catalog is six rows repeated."""
    rng = np.random.default_rng(100 + seed)
    base = rng.normal(size=(6, 8)).astype(np.float32)
    V = base[rng.integers(0, 6, 120)]
    U = np.concatenate([rng.normal(size=(5, 8)), base[:3]]).astype(
        np.float32)
    valid = np.ones(120, bool)
    j, t = _both(V, valid, 60)
    _same_as_reference(U, V, valid, j, t, 12)


def test_topk_sparse_validity():
    rng = np.random.default_rng(7)
    U = rng.normal(size=(9, 16)).astype(np.float32)
    V = rng.normal(size=(200, 16)).astype(np.float32)
    valid = rng.random(200) < 0.3
    j, t = _both(V, valid, 48)
    _same_as_reference(U, V, valid, j, t, 8)


def test_fewer_valid_than_k_leaves_sentinels():
    rng = np.random.default_rng(8)
    U = rng.normal(size=(4, 8)).astype(np.float32)
    V = rng.normal(size=(50, 8)).astype(np.float32)
    valid = np.zeros(50, bool)
    valid[[7, 21, 40]] = True
    j, t = _both(V, valid, 10)
    ts, tx = _same_as_reference(U, V, valid, j, t, 5)
    np.testing.assert_array_equal(ts > NEG_INF,
                                  np.tile([True] * 3 + [False] * 2, (4, 1)))
    assert np.isin(tx[ts > NEG_INF], [7, 21, 40]).all()


def test_all_invalid_catalog():
    rng = np.random.default_rng(9)
    U = rng.normal(size=(3, 4)).astype(np.float32)
    V = rng.normal(size=(20, 4)).astype(np.float32)
    j, t = _both(V, np.zeros(20, bool), 8)
    js, _ = j.topk(U, 4)
    ts, _ = t.topk(torch.from_numpy(U), 4)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ts.numpy(),
                                  np.full((3, 4), NEG_INF, np.float32))


def test_index_guards():
    with pytest.raises(ValueError, match="empty catalog"):
        tidx.Int8CandidateIndex(np.zeros((0, 4), np.float32), device="cpu")
    idx = tidx.Int8CandidateIndex(np.ones((10, 4), np.float32),
                                  shortlist_k=4, device="cpu")
    with pytest.raises(ValueError, match="exceeds shortlist_k"):
        idx.topk(np.ones((2, 4), np.float32), 6)
    assert tidx.Int8CandidateIndex(np.ones((5, 4), np.float32),
                                   shortlist_k=64,
                                   device="cpu").shortlist_k == 5
    with pytest.raises(ValueError, match="append gap"):
        idx.with_updates([12], np.ones((1, 4), np.float32))
    with pytest.raises(ValueError, match="negative"):
        idx.with_updates([-1], np.ones((1, 4), np.float32))


def _catalog_updates(rng, V, touched, appended, r):
    V2 = np.concatenate([V, rng.normal(size=(appended, r))
                         .astype(np.float32)])
    V2[touched] = rng.normal(size=(len(touched), r))
    rows = np.concatenate([touched, len(V) + np.arange(appended)])
    return V2, rows


@pytest.mark.parametrize("touched,appended", [(6, 0), (0, 5), (9, 4)])
def test_delta_and_compact_bitwise_a_rebuild(touched, appended):
    rng = np.random.default_rng(touched * 10 + appended)
    n, Ni, r, k, sk = 11, 150, 12, 8, 40
    U = torch.from_numpy(rng.normal(size=(n, r)).astype(np.float32))
    V = rng.normal(size=(Ni, r)).astype(np.float32)
    base = tidx.build_index(V, shortlist_k=sk, device="cpu")
    V2, rows = _catalog_updates(rng, V, rng.choice(Ni, touched, False),
                                appended, r)
    valid2 = np.ones(len(V2), bool)
    valid2[rows[:2]] = False                       # a delta may invalidate
    delta = base.with_updates(rows, V2[rows], valid_rows=valid2[rows],
                              seq=1)
    assert delta.delta_count == len(rows) and delta.n_base == Ni
    assert base.delta_count == 0                  # immutable
    compact = delta.compact()
    rebuilt = tidx.build_index(V2, valid2, shortlist_k=sk, device="cpu")
    ref_s, ref_i = rebuilt.topk(U, k)
    tied = (ref_s[:, 1:] == ref_s[:, :-1]).any(1)
    for ix in (delta, compact):
        s, i = ix.topk(U, k)
        assert torch.equal(s, ref_s)
        assert torch.equal(i[~tied], ref_i[~tied])
    for a in ("V", "Vq", "sv", "valid"):
        assert torch.equal(getattr(compact, a), getattr(rebuilt, a))
    # and the reference's delta segment by the ulp rule
    jd = jidx.build_index(V, shortlist_k=sk).with_updates(
        rows, V2[rows], valid_rows=valid2[rows], seq=1)
    js, _ = jd.topk(U.numpy(), k)
    assert _ulps(ref_s.numpy(), js) <= SERVE_ULPS


def test_delta_merges_newest_wins():
    rng = np.random.default_rng(3)
    U = torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32))
    V = rng.normal(size=(60, 8)).astype(np.float32)
    base = tidx.build_index(V, shortlist_k=30, device="cpu")
    a = rng.normal(size=(3, 8)).astype(np.float32)
    b = rng.normal(size=(2, 8)).astype(np.float32)
    step = base.with_updates([4, 9, 60], a).with_updates([9, 61], b)
    V2 = np.concatenate([V, a[2:], b[1:]])
    V2[4], V2[9] = a[0], b[0]
    assert step.delta_count == 4 and step.n_items == 62
    ref = tidx.build_index(V2, shortlist_k=30, device="cpu").topk(U, 5)
    assert torch.equal(step.topk(U, 5)[0], ref[0])
    assert torch.equal(step.retag(7).topk(U, 5)[0], ref[0])
    assert step.retag(7).seq == 7 and step.seq == 0


@pytest.mark.parametrize("with_delta", [False, True])
def test_sharded_index_on_three_logical_shards(with_delta):
    rng = np.random.default_rng(11)
    n, Ni, r, k = 7, 101, 8, 6
    U = torch.from_numpy(rng.normal(size=(n, r)).astype(np.float32))
    V = rng.normal(size=(Ni, r)).astype(np.float32)
    valid = rng.random(Ni) < 0.9
    mesh = make_mesh(devices=["cpu"] * 3)
    sh = tidx.build_sharded_index(V, mesh, item_valid=valid,
                                  shortlist_k=Ni)
    loc = tidx.build_index(V, valid, shortlist_k=Ni, device="cpu")
    assert sh.ni_loc == 34 and sh.capacity == 102
    if with_delta:
        V2, rows = _catalog_updates(rng, V, np.array([0, 50, 100]), 1, r)
        valid = np.concatenate([valid, [True]])
        sh = sh.with_updates(rows, V2[rows])       # within capacity
        loc = loc.with_updates(rows, V2[rows])
        V = V2
    ss, si = sh.topk(U, k)
    ls, li = loc.topk(U, k)
    assert _ulps(ss.numpy(), ls.numpy()) <= SERVE_ULPS
    _earns(U.numpy(), V, valid, ss.numpy(), si.numpy())
    if with_delta:
        # growth past the shard stride rebuilds the sharded base
        grown = sh.with_updates([102, 103], rng.normal(size=(2, r)))
        assert grown.delta_count == 0 and grown.n_items == 104
        assert torch.equal(sh.compact().topk(U, k)[0], ss)


@pytest.mark.parametrize("touched", [(), (3, 17), (5, 40, 41)])
def test_block_until_ready_and_nbytes_quantized_as_the_reference(touched):
    """``block_until_ready()`` returns the index (a CPU index has nothing
    to wait for); ``nbytes_quantized()`` equals the reference's on the
    same index, base and delta segment: Vq's bytes + 4·n_base +
    delta_count·(r + 4)."""
    rng = np.random.default_rng(11)
    V = rng.normal(size=(40, 12)).astype(np.float32)
    j, t = _both(V, sk=16)
    rows = np.array(touched, dtype=np.int64)
    V2 = rng.normal(size=(len(rows), 12)).astype(np.float32)
    if len(rows):
        j, t = j.with_updates(rows, V2), t.with_updates(rows, V2)
    assert t.block_until_ready() is t
    assert j.block_until_ready() is j
    assert t.nbytes_quantized() == j.nbytes_quantized() == \
        40 * 12 + 4 * 40 + len(rows) * (12 + 4)
