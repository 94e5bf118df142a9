"""Parity of kernel K6 (blocked Cholesky factor above rank 128, and its
fused solve) with ``tpu_als/ops/pallas_lanes_blocked.py``.

Inputs are made with numpy from a seed and handed to both packages.  The
port runs on the CPU, where the wrapper takes the kernel's plain version;
the JAX side runs the Pallas kernel in interpret mode exactly once (N = 3,
r = 256, in a module-scoped fixture: the interpret run takes about half
a minute on a CPU), and otherwise its XLA solve.

Tolerances: L and x on well-conditioned batches ``M Mᵀ/r + 0.5·I``
within rtol 1e-4, atol 1e-5 (float32 on both sides, sums in another
order), the bar of the K1/K2 parity tests; against float64 Cholesky the
same band.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_als.ops import solve as jsolve
from tpu_als.ops.pallas_lanes_blocked import chol_lanes_blocked as jchol
from tpu_als_torch.ops import cuda_lanes_blocked as k6
from tpu_als_torch.ops import solve as tsolve

RTOL, ATOL = 1e-4, 1e-5


def _spd(seed, n, r):
    rng = np.random.default_rng(seed)
    M = (rng.normal(size=(n, r, r)) / np.sqrt(r)).astype(np.float32)
    A = M @ np.swapaxes(M, 1, 2) + 0.5 * np.eye(r, dtype=np.float32)[None]
    b = rng.normal(size=(n, r)).astype(np.float32)
    return A.astype(np.float32), b


@pytest.fixture(scope="module")
def reference_256():
    """The TPU kernel's L for 3 rank-256 systems, in interpret mode (the
    one interpret call of this module)."""
    A, _ = _spd(256, 3, 256)
    A = A + jsolve.DEFAULT_JITTER * np.eye(256, dtype=np.float32)
    return A, np.asarray(jchol(jnp.asarray(A), interpret=True))


def test_plain_matches_pallas_kernel_interpret(reference_256):
    A, ref = reference_256
    L = k6.chol_lanes_blocked(torch.from_numpy(A.copy())).numpy()
    np.testing.assert_allclose(L, ref, rtol=RTOL, atol=ATOL)
    assert np.all(np.triu(L, 1) == 0) and np.all(np.triu(ref, 1) == 0)


@pytest.mark.parametrize("r", [136, 200, 256, 384])
def test_plain_matches_float64_cholesky(r):
    """Ranks that leave a last tile narrower than 32 (136, 200), the
    fold-in's rank (256) and one the kernel streams, past the 288 that
    one block's shared memory holds (384)."""
    A, _ = _spd(r, 4, r)
    L = k6.chol_lanes_blocked(torch.from_numpy(A.copy())).numpy()
    np.testing.assert_allclose(L, np.linalg.cholesky(A.astype(np.float64)),
                               rtol=RTOL, atol=ATOL)
    assert np.all(np.triu(L, 1) == 0)


def test_factor_is_written_over_the_input():
    A, b = _spd(3, 5, 136)
    tA = torch.from_numpy(A.copy())
    L = k6.chol_lanes_blocked(tA)
    assert L.data_ptr() == tA.data_ptr()
    np.testing.assert_allclose(L.numpy() @ np.swapaxes(L.numpy(), 1, 2), A,
                               rtol=RTOL, atol=ATOL)
    # the fused spd_solve_lanes_blocked leaves the same L in A's storage
    tA = torch.from_numpy(A.copy())
    x = k6.spd_solve_lanes_blocked(tA, torch.from_numpy(b)).numpy()
    assert torch.equal(tA, L)
    assert np.all(np.triu(tA.numpy(), 1) == 0)
    np.testing.assert_allclose(x, np.linalg.solve(
        A.astype(np.float64), b.astype(np.float64)[..., None])[..., 0],
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("r", [136, 256, 320])
def test_solve_spd_lanes_blocked_matches_reference(r):
    """``solve_spd(backend='lanes_blocked')`` (and 'auto', which is K6
    above rank 128) against the reference's XLA solve, with empty rows
    (x = 0 exactly) and jitter-only rows — one rating against a
    unit-norm factor row at regParam 0, a rank-1 Gram held SPD by the
    default jitter alone — that must stay finite."""
    A, b = _spd(40 + r, 10, r)
    count = np.ones(10, np.float32)
    count[[2, 5]] = 0.0
    b[[2, 5]] = 0.0
    for j, seed in ((7, 1), (8, 2)):
        v = np.random.default_rng(seed).normal(size=r)
        v = (v / np.linalg.norm(v)).astype(np.float32)
        A[j] = np.outer(v, v)
        b[j] = v
    tA, tb, tc = (torch.from_numpy(a.copy()) for a in (A, b, count))
    x = tsolve.solve_spd(tA, tb, tc, backend="lanes_blocked").numpy()
    ref = np.asarray(jsolve.solve_spd(jnp.asarray(A), jnp.asarray(b),
                                      jnp.asarray(count), backend="xla"))
    ok = [0, 1, 3, 4, 6, 9]
    scale = np.linalg.norm(ref[ok], axis=-1, keepdims=True)
    assert np.all(np.abs(x[ok] - ref[ok]) <= RTOL * scale + ATOL)
    np.testing.assert_array_equal(x[[2, 5]], 0.0)
    assert np.isfinite(x[[7, 8]]).all()
    assert torch.equal(tA, torch.from_numpy(A))  # the caller's A is intact
    np.testing.assert_array_equal(
        tsolve.solve_spd(tA, tb, tc).numpy(), x)


@pytest.mark.parametrize("r", [136, 384])
def test_fused_plain_matches_float64_solve(r):
    """The fused entry's plain version: x against a float64 solve, b = 0
    rows exactly 0, and L over A as :func:`chol_lanes_blocked_plain`
    writes it."""
    A, b = _spd(500 + r, 4, r)
    b[1] = 0.0
    tA = torch.from_numpy(A.copy())
    x = k6.chol_lanes_blocked_solve_plain(tA, torch.from_numpy(b)).numpy()
    ref = np.linalg.solve(A.astype(np.float64),
                          b.astype(np.float64)[..., None])[..., 0]
    np.testing.assert_allclose(x, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(x[1], 0.0)
    assert torch.equal(tA, k6.chol_lanes_blocked_plain(
        torch.from_numpy(A.copy())))


def test_wrapper_checks():
    A, b = _spd(5, 2, 4)
    with pytest.raises(TypeError):
        k6.chol_lanes_blocked(torch.from_numpy(A).double())
    with pytest.raises(ValueError):
        k6.chol_lanes_blocked(torch.from_numpy(A[:, :3]))
    with pytest.raises(ValueError, match="cuda or cpu"):
        k6.chol_lanes_blocked(torch.empty(2, 4, 4, device="meta"))
    with pytest.raises(TypeError):
        k6.spd_solve_lanes_blocked(torch.from_numpy(A),
                                   torch.from_numpy(b).double())
    with pytest.raises(ValueError):
        k6.spd_solve_lanes_blocked(torch.from_numpy(A),
                                   torch.from_numpy(b[:, :3]))
    empty = torch.empty(0, 4, 4)
    assert k6.chol_lanes_blocked(empty) is empty
