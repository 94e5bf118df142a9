"""The adaptive solve ladder of the port against the reference's.

``solve_spd(adaptive=True)`` and ``solve_spd_checked`` at ranks 8, 128
and 160 (above 128 'auto' is K6, whose plain version, like the kernel,
writes L over the tensor it is given), through every solve kernel's
plain version; the reference runs its einsum route (``backend='xla'``)
on the CPU, with its own ladder.  Inputs are numpy from a seed:

- healthy systems: the adaptive answer is the plain answer bit for bit
  (the ladder only checks it), and within the solve tests' tolerance of
  the reference (row-wise 1e-4 of ||x|| + 1e-5);
- hostile systems, jitter 0: rank-deficient Grams (rank r/4) and
  indefinite ones (eigenvalues down to -5e-3, within the last rung's
  1e-2): every row passes the residual rule, both packages settle each
  row at the same rung, and rows settled at the same rung agree within
  1e-2 of ||x|| — the rule's own tolerance; the rank-deficient rows,
  settled at 1e-4, have condition numbers near 1e5, which turn two
  factorizations' float32 rounding into ~1e-3 of ||x||;
- NaN systems: ``SolveUnstable`` with the reference's ``bad_rows``.

Last, an ``AlsConfig(adaptive_solve=True)`` fit against the reference's
from one injected init, and the armed route through K3 + the ladder.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_als.core.als import AlsConfig as JConfig
from tpu_als.core.als import train as jtrain
from tpu_als.core.ratings import build_csr_buckets as jbuild
from tpu_als.ops import solve as jsolve
from tpu_als_torch.core import als as tals
from tpu_als_torch.core.ratings import build_csr_buckets as tbuild
from tpu_als_torch.ops import cuda_gather_ne
from tpu_als_torch.ops import solve as tsolve

RTOL, ATOL = 1e-4, 1e-5          # healthy rows, as tests/test_torch_solve
HOSTILE_REL = 1e-2               # hostile rows settled at the same rung
RUNGS = (0.0,) + tsolve.ADAPTIVE_JITTER_RUNGS
CASES = [(8, "lanes"), (128, "lanes"), (128, "pallas"),
         (160, "lanes_blocked"), (160, "pallas")]


def _healthy(rng, n, r):
    M = rng.normal(size=(n, r, r)) / np.sqrt(r)
    return M @ np.swapaxes(M, 1, 2) + 0.5 * np.eye(r)


def _hostile(rng, n, r):
    """Rows alternate: healthy, rank-deficient (rank r/4), indefinite
    (a few eigenvalues in [-5e-3, -1e-3], the rest in [0.1, 2])."""
    A = _healthy(rng, n, r)
    q = max(1, r // 4)
    for k in range(1, n, 3):
        M = rng.normal(size=(r, q))
        A[k] = M @ M.T
    for k in range(2, n, 3):
        Q, _ = np.linalg.qr(rng.normal(size=(r, r)))
        ev = rng.uniform(0.1, 2.0, r)
        m = max(1, r // 8)
        ev[:m] = -rng.uniform(1e-3, 5e-3, m)
        A[k] = (Q * ev) @ Q.T
    return A


def _batch(seed, n, r, hostile):
    rng = np.random.default_rng(seed)
    A = (_hostile if hostile else _healthy)(rng, n, r).astype(np.float32)
    b = rng.normal(size=(n, r)).astype(np.float32)
    count = np.ones(n, np.float32)
    count[4] = 0.0   # an empty row: identity guard, x exactly 0
    b[4] = 0.0
    return A, b, count


def _port(A, b, count, **kw):
    return tsolve.solve_spd(*(torch.from_numpy(x) for x in (A, b, count)),
                            **kw).numpy()


def _ref(A, b, count, **kw):
    return np.asarray(jsolve.solve_spd(
        *(jnp.asarray(x) for x in (A, b, count)), backend="xla", **kw))


def _passes(A, b, x, rung):
    """The ladder's rule in float64: x finite, and the residual of
    (A + rung·I) x = b within 1e-2 of ||b|| + 1."""
    A64 = A.astype(np.float64) + rung * np.eye(A.shape[-1])
    res = np.einsum("nrs,ns->nr", A64, x.astype(np.float64)) - b
    return (np.isfinite(x).all(-1)
            & (np.linalg.norm(res, axis=-1)
               <= 1e-2 * (np.linalg.norm(b, axis=-1) + 1.0)))


def _settled_rung(solve, A, b, count):
    """Per row, the index in RUNGS of the first jitter whose plain solve
    passes the rule (len(RUNGS): the CG fallback)."""
    A0 = np.where((count <= 0)[:, None, None], np.eye(A.shape[-1]), A)
    out = np.full(len(A), len(RUNGS))
    for j in reversed(range(len(RUNGS))):
        out[_passes(A0, b, solve(A, b, count, jitter=RUNGS[j]), RUNGS[j])] \
            = j
    return out


def _close_rowwise(x, ref, rel, atol=0.0):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    scale = np.linalg.norm(ref, axis=-1, keepdims=True)
    err = np.abs(x - ref) / (rel * scale + atol + 1e-30)
    assert np.all(err <= 1.0), err.max()


@pytest.mark.parametrize("r,backend", CASES)
def test_healthy_systems_pass_untouched(r, backend, monkeypatch):
    A, b, count = _batch(r, 24, r, hostile=False)
    calls = []
    solver = tsolve.SOLVERS[backend]

    def spy(A_, b_):
        calls.append(A_.shape[0])
        return solver(A_, b_)

    monkeypatch.setitem(tsolve.SOLVERS, backend, spy)
    plain = _port(A, b, count, backend=backend)
    got = _port(A, b, count, backend=backend, adaptive=True)
    np.testing.assert_array_equal(got, plain)
    # one solve each: the residual is taken against A0, not against the
    # tensor K6 (or its plain version) wrote L over
    assert calls == [24, 24]
    np.testing.assert_array_equal(got[4], 0.0)
    _close_rowwise(got, _ref(A, b, count, adaptive=True), RTOL, ATOL)
    checked = tsolve.solve_spd_checked(
        *(torch.from_numpy(x) for x in (A, b, count)), backend=backend)
    np.testing.assert_array_equal(checked.numpy(), plain)


@pytest.mark.parametrize("r,backend", CASES)
def test_hostile_systems_settle_as_in_reference(r, backend):
    A, b, count = _batch(100 + r, 30, r, hostile=True)
    got = _port(A, b, count, jitter=0.0, backend=backend, adaptive=True)
    ref = _ref(A, b, count, jitter=0.0, adaptive=True)
    A0 = np.where((count <= 0)[:, None, None], np.eye(r), A)
    ok = np.zeros(len(A), bool)
    for rung in RUNGS:
        ok |= _passes(A0, b, got, rung)
    assert ok.all(), np.flatnonzero(~ok)
    rung_t = _settled_rung(
        lambda *a, **k: _port(*a, backend=backend, **k), A, b, count)
    rung_j = _settled_rung(_ref, A, b, count)
    np.testing.assert_array_equal(rung_t, rung_j)
    # the hostile rows need the ladder: some settle past the base jitter
    assert (rung_t > 0).any()
    same = rung_t < len(RUNGS)
    _close_rowwise(got[same], ref[same], HOSTILE_REL)
    healthy = np.arange(len(A)) % 3 == 0
    _close_rowwise(got[healthy], ref[healthy], RTOL, ATOL)
    x = tsolve.solve_spd_checked(
        *(torch.from_numpy(v) for v in (A, b, count)), jitter=0.0,
        backend=backend)
    np.testing.assert_array_equal(x.numpy(), got)


@pytest.mark.parametrize("r,backend", [(8, "lanes"), (160, "lanes_blocked")])
def test_nan_systems_raise_solve_unstable_as_reference(r, backend):
    A, b, count = _batch(7, 12, r, hostile=False)
    A[2, 0, 0] = np.nan
    A[9] = np.nan
    b[5, 1] = np.inf
    with pytest.raises(tsolve.SolveUnstable) as et:
        tsolve.solve_spd_checked(
            *(torch.from_numpy(x) for x in (A, b, count)), backend=backend)
    with pytest.raises(jsolve.SolveUnstable) as ej:
        jsolve.solve_spd_checked(*(jnp.asarray(x) for x in (A, b, count)),
                                 backend="xla")
    assert (et.value.bad_rows, et.value.total_rows) == \
        (ej.value.bad_rows, ej.value.total_rows) == (3, 12)
    # the unchecked ladder returns, the bad rows non-finite, the rest solved
    x = _port(A, b, count, backend=backend, adaptive=True)
    assert not np.isfinite(x[[2, 5, 9]]).all(-1).any()
    keep = np.setdiff1d(np.arange(12), [2, 5, 9])
    _close_rowwise(x[keep], _ref(A, b, count)[keep], RTOL, ATOL)


def test_bf16_adaptive_upcasts():
    A, b, count = _batch(3, 10, 8, hostile=False)
    tA, tb, tc = (torch.from_numpy(x) for x in (A, b, count))
    got = tsolve.solve_spd(tA.bfloat16(), tb.bfloat16(), tc, adaptive=True)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, tsolve.solve_spd(tA.bfloat16(), tb.bfloat16(),
                                             tc))


def _unit_rows(rng, n, r):
    x = rng.normal(size=(n, r)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("implicit", [False, True])
def test_adaptive_fit_matches_reference(implicit, monkeypatch):
    """Three iterations from one init: the port's 'auto' armed (K3's
    plain version + the laddered K2 plain solve on every bucket) against
    the reference's armed einsum route, within the training tests' band
    (atol 5e-4, rtol 5e-3)."""
    rng = np.random.default_rng(9)
    nu, ni, nnz, r = 40, 30, 500, 16
    u, i = rng.integers(0, nu, nnz), rng.integers(0, ni, nnz)
    v = (np.abs(rng.normal(size=nnz)) + 0.1).astype(np.float32)
    U0, V0 = _unit_rows(rng, nu, r), _unit_rows(rng, ni, r)
    kw = dict(implicit_prefs=True, alpha=4.0) if implicit else {}
    grams = []
    real = cuda_gather_ne.gather_gram

    def spy(*a, **k):
        grams.append(1)
        return real(*a, **k)

    monkeypatch.setattr(cuda_gather_ne, "gather_gram", spy)
    U, V = tals.train(tbuild(u, i, v, nu), tbuild(i, u, v, ni),
                      tals.AlsConfig(rank=r, max_iter=3, reg_param=0.1,
                                     adaptive_solve=True, **kw),
                      init=(U0, V0), device="cpu")
    jU, jV = jtrain(jbuild(u, i, v, nu, native=False),
                    jbuild(i, u, v, ni, native=False),
                    JConfig(rank=r, max_iter=3, reg_param=0.1,
                            adaptive_solve=True, **kw), init=(U0, V0))
    assert grams  # K3 built the systems the ladder checked
    np.testing.assert_allclose(U.numpy(), np.asarray(jU), atol=5e-4,
                               rtol=5e-3)
    np.testing.assert_allclose(V.numpy(), np.asarray(jV), atol=5e-4,
                               rtol=5e-3)
