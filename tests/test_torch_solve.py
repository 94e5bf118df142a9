"""Parity of the port's normal equations, SPD solves and CG with ``tpu_als``.

Inputs are made with numpy from a seed and handed to both packages.  The
port runs on the CPU, where the solve wrappers take kernels K2's and K1's
plain versions; the JAX side runs on the CPU backend, with the Pallas
lanes and blocked-Cholesky kernels in interpret mode where they are
named.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_als.ops import pallas_lanes
from tpu_als.ops import solve as jsolve
from tpu_als.ops.pallas_solve import spd_solve_pallas
from tpu_als_torch.ops import cuda_lanes, cuda_solve
from tpu_als_torch.ops import solve as tsolve

# float32 on both sides; the sums run in different orders
RTOL, ATOL = 1e-4, 1e-5


def _ne_inputs(seed, n=24, w=16, r=8, empty_rows=(3, 7)):
    rng = np.random.default_rng(seed)
    Vg = (rng.normal(size=(n, w, r)) / np.sqrt(r)).astype(np.float32)
    vals = (rng.integers(1, 11, (n, w)) * 0.5).astype(np.float32)
    mask = (rng.random((n, w)) < 0.7).astype(np.float32)
    mask[list(empty_rows)] = 0.0
    vals *= mask
    return Vg, vals, mask


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _spd(seed, n, r):
    """Random SPD batch M Mᵀ/r + 0.5·I, as the reference's lanes probe
    builds it."""
    rng = np.random.default_rng(seed)
    M = (rng.normal(size=(n, r, r)) / np.sqrt(r)).astype(np.float32)
    A = M @ np.swapaxes(M, 1, 2) + 0.5 * np.eye(r, dtype=np.float32)[None]
    b = rng.normal(size=(n, r)).astype(np.float32)
    return A.astype(np.float32), b


def _close_rowwise(x, ref, rel=RTOL, atol=ATOL):
    """|x - ref| <= rel·||ref||_row + atol, for systems whose solution
    scale varies by row."""
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    scale = np.linalg.norm(ref, axis=-1, keepdims=True)
    assert np.all(np.abs(x - ref) <= rel * scale + atol), \
        np.max(np.abs(x - ref) / (scale + atol))


def test_normal_eq_explicit_matches_reference():
    Vg, vals, mask = _ne_inputs(0)
    ja, jb, jc = jsolve.normal_eq_explicit(jnp.asarray(Vg), jnp.asarray(vals),
                                           jnp.asarray(mask), 0.05)
    ta, tb, tc = tsolve.normal_eq_explicit(*_t(Vg, vals, mask), 0.05)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("alpha", [1.0, 40.0])
def test_normal_eq_implicit_matches_reference(alpha):
    Vg, vals, mask = _ne_inputs(1)
    rng = np.random.default_rng(11)
    V = rng.normal(size=(50, 8)).astype(np.float32)
    jY = jsolve.compute_yty(jnp.asarray(V))
    tY = tsolve.compute_yty(torch.from_numpy(V))
    np.testing.assert_allclose(tY.numpy(), np.asarray(jY), rtol=1e-5,
                               atol=1e-4)
    ja, jb, jc = jsolve.normal_eq_implicit(
        jnp.asarray(Vg), jnp.asarray(vals), jnp.asarray(mask), 0.01, alpha,
        jY)
    ta, tb, tc = tsolve.normal_eq_implicit(*_t(Vg, vals, mask), 0.01, alpha,
                                           tY)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("w", [3, 8, 10])
def test_contract_sums_width_chunks_in_order(monkeypatch, w):
    """With WIDTH_CHUNK at 4, a width-10 contraction is two whole chunks
    and a ragged one of 2, a width-8 one two whole chunks, a width-3 one a
    single chunk: each equals the chunk products summed in float64."""
    monkeypatch.setattr(tsolve, "WIDTH_CHUNK", 4)
    rng = np.random.default_rng(w)
    L = torch.from_numpy(rng.normal(size=(3, w, 5)).astype(np.float32))
    R = torch.from_numpy(rng.normal(size=(3, w, 2)).astype(np.float32))
    ref = sum(torch.bmm(L[:, s:s + 4].double().transpose(1, 2),
                        R[:, s:s + 4].double()) for s in range(0, w, 4))
    got = tsolve._contract(L, R)
    assert got.shape == (3, 5, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("w", [2048, 1000])
def test_normal_eq_wide_rows_match_reference(implicit, w):
    """Rows wider than WIDTH_CHUNK are contracted in width chunks (2048
    divides into 4; 1000 is one whole chunk and a ragged one of 488).
    Same tolerances as the narrow builders above."""
    assert w > tsolve.WIDTH_CHUNK
    Vg, vals, mask = _ne_inputs(5, n=4, w=w, empty_rows=(3,))
    args = (0.01, 40.0) if implicit else (0.05,)
    jargs, targs = args, args
    if implicit:
        Y = np.random.default_rng(6).normal(size=(50, 8)).astype(np.float32)
        jargs = args + (jsolve.compute_yty(jnp.asarray(Y)),)
        targs = args + (tsolve.compute_yty(torch.from_numpy(Y)),)
    jfn, tfn = ((jsolve.normal_eq_implicit, tsolve.normal_eq_implicit)
                if implicit else
                (jsolve.normal_eq_explicit, tsolve.normal_eq_explicit))
    ja, jb, jc = jfn(jnp.asarray(Vg), jnp.asarray(vals), jnp.asarray(mask),
                     *jargs)
    ta, tb, tc = tfn(*_t(Vg, vals, mask), *targs)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("implicit", [False, True])
def test_solve_spd_matches_reference_with_empty_rows(implicit):
    Vg, vals, mask = _ne_inputs(2, n=40, r=12)
    if implicit:
        Y = np.random.default_rng(3).normal(size=(64, 12)).astype(np.float32)
        jY, tY = jsolve.compute_yty(jnp.asarray(Y)), tsolve.compute_yty(
            torch.from_numpy(Y))
        jA, jb, jc = jsolve.normal_eq_implicit(
            jnp.asarray(Vg), jnp.asarray(vals), jnp.asarray(mask), 0.01,
            40.0, jY)
        tA, tb, tc = tsolve.normal_eq_implicit(*_t(Vg, vals, mask), 0.01,
                                               40.0, tY)
    else:
        jA, jb, jc = jsolve.normal_eq_explicit(
            jnp.asarray(Vg), jnp.asarray(vals), jnp.asarray(mask), 0.05)
        tA, tb, tc = tsolve.normal_eq_explicit(*_t(Vg, vals, mask), 0.05)
    jx = np.asarray(jsolve.solve_spd(jA, jb, jc))
    tx = tsolve.solve_spd(tA, tb, tc).numpy()
    _close_rowwise(tx, jx)
    # empty rows: identity guard, b = 0 -> exactly 0
    np.testing.assert_array_equal(tx[[3, 7]], 0.0)


def test_solve_spd_bf16_upcasts_then_downcasts():
    A, b = _spd(4, 20, 8)
    count = np.ones(20, np.float32)
    jx = jsolve.solve_spd(jnp.asarray(A, jnp.bfloat16),
                          jnp.asarray(b, jnp.bfloat16), jnp.asarray(count))
    tx = tsolve.solve_spd(torch.from_numpy(A).to(torch.bfloat16),
                          torch.from_numpy(b).to(torch.bfloat16),
                          torch.from_numpy(count))
    assert tx.dtype == torch.bfloat16
    # the same bf16 inputs solved in f32: at most one bf16 ulp apart
    np.testing.assert_allclose(tx.float().numpy(),
                               np.asarray(jx, np.float32), rtol=1e-2,
                               atol=1e-2)


def test_solve_nnls_matches_reference():
    Vg, vals, mask = _ne_inputs(5, n=16, r=6)
    jA, jb, jc = jsolve.normal_eq_explicit(
        jnp.asarray(Vg), jnp.asarray(vals), jnp.asarray(mask), 0.05)
    tA, tb, tc = tsolve.normal_eq_explicit(*_t(Vg, vals, mask), 0.05)
    jx = np.asarray(jsolve.solve_nnls(jA, jb, jc, sweeps=16))
    tx = tsolve.solve_nnls(tA, tb, tc, sweeps=16).numpy()
    assert (tx >= 0).all()
    _close_rowwise(tx, jx)


@pytest.mark.parametrize("r", [10, 16])
def test_k2_plain_matches_pallas_lanes_interpret(r):
    """136 systems = two 128-lane groups plus batch padding on the TPU
    kernel's side; r = 10 also exercises its rank padding to 16."""
    A, b = _spd(6 + r, 136, r)
    A = A + jsolve.DEFAULT_JITTER * np.eye(r, dtype=np.float32)
    b[:4] = 0.0
    ref = np.asarray(pallas_lanes.spd_solve_lanes(
        jnp.asarray(A), jnp.asarray(b), interpret=True))
    x = cuda_lanes.chol_solve_plain(*_t(A, b)).numpy()
    np.testing.assert_allclose(x, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(x[:4], 0.0)


@pytest.mark.parametrize("r", [40, 128])
def test_k2_plain_across_tiles_matches_pallas_lanes_interpret(r):
    """The plain version's order walks block columns of 32: at r = 40 a
    full tile and a partial one (the kernel pads it with the identity),
    at r = 128 four full tiles, each with its panel and trailing
    update."""
    A, b = _spd(3 * r, 130, r)
    A = A + jsolve.DEFAULT_JITTER * np.eye(r, dtype=np.float32)
    b[:3] = 0.0
    ref = np.asarray(pallas_lanes.spd_solve_lanes(
        jnp.asarray(A), jnp.asarray(b), interpret=True))
    x = cuda_lanes.chol_solve_plain(*_t(A, b)).numpy()
    np.testing.assert_allclose(x, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(x[:3], 0.0)


@pytest.mark.parametrize("r", [1, 10, 64])
def test_k2_plain_matches_xla_backend(r):
    A, b = _spd(20 + r, 48, r)
    ref = np.asarray(jsolve.solve_spd(jnp.asarray(A), jnp.asarray(b),
                                      jnp.ones(48), jitter=0.0,
                                      backend="xla"))
    x = cuda_lanes.spd_solve_lanes(*_t(A, b)).numpy()
    np.testing.assert_allclose(x, ref, rtol=RTOL, atol=ATOL)


def test_k2_plain_jitter_only_system_stays_finite():
    """A rank-1 Gram held SPD only by the default jitter (an entity with
    one rating at regParam 0) solves to a finite answer."""
    for seed in range(4):
        v = np.random.default_rng(seed).normal(size=8).astype(np.float32)
        A = (np.outer(v, v) + jsolve.DEFAULT_JITTER * np.eye(8))[None]
        x = cuda_lanes.chol_solve_plain(*_t(A.astype(np.float32),
                                            v[None].copy()))
        assert torch.isfinite(x).all()


def test_k2_wrapper_rejects_bad_inputs():
    A, b = _spd(8, 4, 3)
    with pytest.raises(TypeError):
        cuda_lanes.spd_solve_lanes(torch.from_numpy(A).double(),
                                   torch.from_numpy(b))
    with pytest.raises(ValueError):
        cuda_lanes.spd_solve_lanes(torch.from_numpy(A),
                                   torch.from_numpy(b[:, :2]))


@pytest.mark.parametrize("r", [10, 24, 128])
def test_k1_plain_matches_pallas_solve_interpret(r):
    """K1's plain version (the tiled order of ``chol_tiled.cuh``, 32 x 32
    tiles) against the TPU kernel (panels of 16); r = 10 and 24 exercise
    a last panel narrower than 16 on the TPU side (padded with an
    identity block) and a single partial tile here."""
    A, b = _spd(30 + r, 9, r)
    A = A + jsolve.DEFAULT_JITTER * np.eye(r, dtype=np.float32)
    b[:2] = 0.0
    ref = np.asarray(spd_solve_pallas(jnp.asarray(A), jnp.asarray(b),
                                      interpret=True))
    x = cuda_solve.spd_solve_blocked(*_t(A, b)).numpy()
    _close_rowwise(x, ref)
    np.testing.assert_array_equal(x[:2], 0.0)


@pytest.mark.parametrize("r", [256, 320])
def test_k1_plain_matches_xla_backend_at_wide_ranks(r):
    """K1 takes any rank: on chip up to rank 288 (256), streamed above
    it (320), with one arithmetic, so one plain version; against the
    reference's XLA solve, with b = 0 rows solving to 0."""
    A, b = _spd(60 + r, 6, r)
    b[:2] = 0.0
    ref = np.asarray(jsolve.solve_spd(jnp.asarray(A), jnp.asarray(b),
                                      jnp.ones(6), jitter=0.0,
                                      backend="xla"))
    x = cuda_solve.spd_solve_blocked(*_t(A, b)).numpy()
    _close_rowwise(x, ref)
    np.testing.assert_array_equal(x[:2], 0.0)


def test_k1_wrapper_limits_and_checks():
    """K1's reach is any rank; the pins are the on-chip limit (9 tiles
    of 32 a side) and the shared memory of its layout: T(T+1)/2 tiles of
    32 x 36 floats and three vectors of 32·T floats."""
    assert cuda_solve.ONCHIP_MAX_RANK == 288
    assert cuda_solve.smem_bytes(256) == (36 * 32 * 36 + 3 * 32 * 8) * 4
    assert cuda_solve.smem_bytes(289) > cuda_solve.SMEM_BYTES
    A, b = _spd(8, 4, 3)
    with pytest.raises(TypeError):
        cuda_solve.spd_solve_blocked(torch.from_numpy(A).double(),
                                     torch.from_numpy(b))
    with pytest.raises(ValueError):
        cuda_solve.spd_solve_blocked(torch.from_numpy(A),
                                     torch.from_numpy(b[:, :2]))


@pytest.mark.parametrize("r", [16, 136])
def test_solve_spd_backends_agree(r):
    """'lanes' (K2), 'lanes_blocked' (K6's fused solve) and 'pallas' (K1)
    solve the same guarded systems; 'auto' is K2 up to rank 128 and K6
    above."""
    A, b = _spd(40 + r, 12, r)
    count = np.ones(12, np.float32)
    count[3] = 0.0
    b[3] = 0.0
    tA, tb, tc = _t(A, b, count)
    xk1 = tsolve.solve_spd(tA, tb, tc, backend="pallas")
    ref = np.asarray(jsolve.solve_spd(jnp.asarray(A), jnp.asarray(b),
                                      jnp.asarray(count), backend="xla"))
    _close_rowwise(xk1.numpy(), ref)
    xk6 = tsolve.solve_spd(tA, tb, tc, backend="lanes_blocked")
    _close_rowwise(xk6.numpy(), ref)
    assert torch.equal(tsolve.solve_spd(tA, tb, tc), xk6 if r > 128
                       else tsolve.solve_spd(tA, tb, tc, backend="lanes"))
    assert tsolve.auto_solve_backend(r) == ("lanes" if r <= 128
                                            else "lanes_blocked")
    np.testing.assert_array_equal(xk1.numpy()[3], 0.0)
    np.testing.assert_array_equal(xk6.numpy()[3], 0.0)
    with pytest.raises(ValueError):
        tsolve.solve_spd(tA, tb, tc, backend="xla")


@pytest.mark.parametrize("r,backend", [(128, "lanes"),
                                       (129, "lanes_blocked"),
                                       (256, "lanes_blocked")])
def test_auto_solve_backend_follows_the_reference_order(r, backend):
    """K2 up to rank 128, K6 above it — the reference's 'lanes' then
    'lanes_blocked' — and each name is a solve kernel; K1 stays
    reachable as 'pallas'."""
    assert tsolve.auto_solve_backend(r) == backend
    assert set(tsolve.SOLVERS) == {"lanes", "lanes_blocked", "pallas"}


@pytest.mark.parametrize("warm", [False, True])
def test_solve_cg_matches_reference(warm):
    Vg, vals, mask = _ne_inputs(7, n=20, r=8)
    jA, jb, jc = jsolve.normal_eq_explicit(
        jnp.asarray(Vg), jnp.asarray(vals), jnp.asarray(mask), 0.05)
    tA, tb, tc = tsolve.normal_eq_explicit(*_t(Vg, vals, mask), 0.05)
    x0 = (np.random.default_rng(1).normal(size=(20, 8)).astype(np.float32)
          if warm else None)
    jx = np.asarray(jsolve.solve_cg(
        jA, jb, jc, x0=None if x0 is None else jnp.asarray(x0), iters=4))
    tx = tsolve.solve_cg(tA, tb, tc, x0=None if x0 is None
                         else torch.from_numpy(x0), iters=4).numpy()
    _close_rowwise(tx, jx, rel=1e-4, atol=1e-5)
    # cold rows land exactly on 0, even from a warm start
    np.testing.assert_allclose(tx[[3, 7]], 0.0, atol=1e-6)


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_solve_cg_matfree_matches_reference(implicit, bf16):
    Vg, vals, mask = _ne_inputs(8, n=20, r=8)
    Y = np.random.default_rng(4).normal(size=(30, 8)).astype(np.float32)
    YtY = Y.T @ Y
    x0 = np.random.default_rng(5).normal(size=(20, 8)).astype(np.float32)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    jx = np.asarray(jsolve.solve_cg_matfree(
        jnp.asarray(Vg).astype(jdt), jnp.asarray(vals), jnp.asarray(mask),
        0.05, implicit=implicit, alpha=4.0, YtY=jnp.asarray(YtY),
        x0=jnp.asarray(x0), iters=3))
    tx = tsolve.solve_cg_matfree(
        torch.from_numpy(Vg).to(tdt), *_t(vals, mask), 0.05,
        implicit=implicit, alpha=4.0, YtY=torch.from_numpy(YtY),
        x0=torch.from_numpy(x0), iters=3).numpy()
    _close_rowwise(tx, jx, rel=1e-4, atol=1e-5)
    np.testing.assert_allclose(tx[[3, 7]], 0.0, atol=1e-6)
