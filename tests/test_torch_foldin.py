"""Parity of the port's fold-in with ``tpu_als.core.foldin.fold_in``.

Rank 16, power-of-two widths (the shapes the reference's stream server
hands its jitted fold-in), inputs from a seed.  Rows with no ratings
solve to exactly 0 in both.  Tolerance is relative to each row's norm:
with implicit alpha = 40 the Gram entries reach the thousands.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_als.core.foldin import fold_in as jfold_in
from tpu_als_torch.core.foldin import fold_in as tfold_in
from tpu_als_torch.ops.solve import compute_yty

REL, ATOL = 1e-4, 1e-5


def _batch(seed, n=32, w=16, Ni=200, r=16):
    rng = np.random.default_rng(seed)
    V = (rng.normal(size=(Ni, r)) / np.sqrt(r)).astype(np.float32)
    lens = rng.integers(0, w + 1, n)
    lens[:2] = 0  # entities with no ratings
    cols = rng.integers(0, Ni, (n, w)).astype(np.int32)
    mask = (np.arange(w)[None, :] < lens[:, None]).astype(np.float32)
    vals = (rng.integers(1, 11, (n, w)) * 0.5).astype(np.float32) * mask
    return V, cols, vals, mask


def _run_both(V, cols, vals, mask, **kw):
    jx = np.asarray(jfold_in(jnp.asarray(V), jnp.asarray(cols),
                             jnp.asarray(vals), jnp.asarray(mask), 0.05,
                             **kw))
    tkw = dict(kw)
    if tkw.get("YtY") is not None:
        tkw["YtY"] = torch.from_numpy(np.asarray(tkw["YtY"]))
    tx = tfold_in(torch.from_numpy(V), torch.from_numpy(cols).long(),
                  torch.from_numpy(vals), torch.from_numpy(mask), 0.05,
                  **tkw).numpy()
    return tx, jx


def _close(tx, jx):
    scale = np.linalg.norm(jx, axis=1, keepdims=True)
    assert np.all(np.abs(tx - jx) <= REL * scale + ATOL)
    np.testing.assert_array_equal(tx[:2], 0.0)


@pytest.mark.parametrize("w", [4, 16])
def test_fold_in_explicit_matches_reference(w):
    tx, jx = _run_both(*_batch(w, w=w))
    _close(tx, jx)


@pytest.mark.parametrize("alpha,pass_yty", [(1.0, False), (40.0, True)])
def test_fold_in_implicit_matches_reference(alpha, pass_yty):
    V, cols, vals, mask = _batch(int(alpha))
    YtY = compute_yty(torch.from_numpy(V)).numpy() if pass_yty else None
    tx, jx = _run_both(V, cols, vals, mask, implicit_prefs=True,
                       alpha=alpha, YtY=YtY)
    _close(tx, jx)


def test_fold_in_nonnegative_matches_reference():
    tx, jx = _run_both(*_batch(9), nonnegative=True, nnls_sweeps=16)
    assert (tx >= 0).all()
    _close(tx, jx)


@pytest.mark.parametrize("implicit", [False, True])
def test_fold_in_rank_256_matches_reference(implicit):
    """BASELINE config 3's width: the port's solve is K6's plain
    factorization and two triangular solves; the reference's its XLA
    Cholesky."""
    V, cols, vals, mask = _batch(256 + implicit, r=256)
    kw = {"implicit_prefs": True, "alpha": 40.0} if implicit else {}
    tx, jx = _run_both(V, cols, vals, mask, **kw)
    _close(tx, jx)
