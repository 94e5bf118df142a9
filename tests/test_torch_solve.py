"""Parity of the port's normal equations and SPD solve with ``tpu_als``.

Inputs are made with numpy from a seed and handed to both packages.  The
port runs on the CPU, where the solve wrapper takes kernel K2's plain
version; the JAX side runs on the CPU backend, with the Pallas lanes
kernel in interpret mode where it is named.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_als.ops import pallas_lanes
from tpu_als.ops import solve as jsolve
from tpu_als_torch.ops import cuda_lanes
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
