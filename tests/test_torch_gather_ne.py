"""Parity of kernels K3 (gather + Gram) and K4 (gather + Gram + tail +
solve) with ``tpu_als/ops/pallas_gather_ne.py``.

The same numpy inputs go to the port (on the CPU, where the wrappers take
the kernels' plain versions) and to the JAX package (its Pallas kernels
in interpret mode).  Tolerances:

- K3, the normal equations: each entry within 5e-6 of the sum of the
  magnitudes of its terms — float32 sums of the same products in another
  order (at width 512 the reference adds two width chunks of 256).  The
  scale is the magnitude sum, not the entry, because the terms of b
  cancel; at bfloat16 the lower triangle, where both sides form the same
  f32 products (the reference's upper triangle is its own transposed
  rounding);
- K4, the solutions: atol 5e-5, rtol 5e-4, the reference's own band for
  fused vs unfused solves (another elimination order);
- the split path (rows cut into width chunks) against the unsplit one:
  1e-5 relative to the largest entry.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_als.ops import pallas_gather_ne as jg
from tpu_als_torch.ops import cuda_gather_ne as tg

SHAPES = [
    (5, 8, 4),
    (37, 24, 10),
    (33, 100, 128),
    (64, 512, 32),
]


def _problem(seed, n, w, r, N=200, implicit=False):
    """As tests/test_gather_solve.py builds it, plus an empty row, a row
    of one repeated column, and (implicit) a row with no positive
    rating."""
    rng = np.random.default_rng(seed)
    V = (rng.normal(size=(N, r)) / np.sqrt(r)).astype(np.float32)
    cols = rng.integers(0, N, (n, w)).astype(np.int32)
    vals = rng.normal(size=(n, w)).astype(np.float32)
    if implicit:
        vals = np.abs(vals) * 3
        vals[rng.random((n, w)) < 0.2] *= -1
    mask = (rng.random((n, w)) < 0.8).astype(np.float32)
    if n > 3:
        mask[0] = 0.0
        cols[1] = cols[1, 0]
        vals[2] = -np.abs(vals[2])
    vals = vals * mask
    YtY = (V.T @ V).astype(np.float32)
    return V, cols, vals, mask, YtY


def _both(arrays, dtype=np.float32):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    j = [jnp.asarray(a).astype(jdt) if a.dtype == np.float32
         else jnp.asarray(a) for a in arrays]
    t = [torch.from_numpy(a).to(tdt) if a.dtype == np.float32
         else torch.from_numpy(a) for a in arrays]
    return j, t


def _assert_within_scale(got, ref, tV, tc, tv, tm, implicit, YtY,
                         tol=5e-6, lower=False):
    """|got - ref| <= tol · (Σ |terms|) entry by entry, for (A, b, count)."""
    conf = 4.0 * tv.abs() * tm
    aw = conf if implicit else tm
    bw = (1.0 + conf) * tm if implicit else (tv * tm).abs()
    S_abs, b_abs = tg.gather_gram_plain(tV.abs(), tc, aw.abs(), bw,
                                        two_sided=not implicit)
    A_scale = S_abs + 1.0 + (torch.from_numpy(np.abs(YtY))[None]
                             if implicit else 0.0)
    for g, j, scale in zip(got, ref, (A_scale, b_abs + 1e-30, None)):
        g, j = g.float().numpy(), np.asarray(j).astype(np.float32)
        if scale is None:
            np.testing.assert_array_equal(g, j)
            continue
        if lower:
            g, j, scale = np.tril(g), np.tril(j), torch.tril(scale)
        assert np.all(np.abs(g - j) <= tol * scale.numpy()), \
            np.max(np.abs(g - j) / scale.numpy())


@pytest.mark.parametrize("n,w,r", SHAPES)
@pytest.mark.parametrize("implicit", [False, True])
def test_k3_normal_equations_match_reference(n, w, r, implicit):
    V, cols, vals, mask, YtY = _problem(n * w + r, n, w, r,
                                        implicit=implicit)
    (jV, jc, jv, jm), (tV, tc, tv, tm) = _both((V, cols, vals, mask))
    if implicit:
        ref = jg.gather_normal_eq_implicit(jV, jc, jv, jm, 0.1, 4.0,
                                           jnp.asarray(YtY), interpret=True)
        got = tg.gather_normal_eq_implicit(tV, tc, tv, tm, 0.1, 4.0,
                                           torch.from_numpy(YtY))
    else:
        ref = jg.gather_normal_eq_explicit(jV, jc, jv, jm, 0.05,
                                           interpret=True)
        got = tg.gather_normal_eq_explicit(tV, tc, tv, tm, 0.05)
    _assert_within_scale(got, ref, tV, tc, tv, tm, implicit, YtY)


def test_k3_bfloat16_table_matches_reference():
    n, w, r = 24, 32, 16
    V, cols, vals, mask, YtY = _problem(3, n, w, r, implicit=True)
    (jV, jc, jv, jm), (tV, tc, tv, tm) = _both((V, cols, vals, mask),
                                                "bf16")
    jA, jb, jn = jg.gather_normal_eq_implicit(jV, jc, jv, jm, 0.1, 4.0,
                                              jnp.asarray(YtY),
                                              interpret=True)
    tA, tb, tn = tg.gather_normal_eq_implicit(tV, tc, tv, tm, 0.1, 4.0,
                                              torch.from_numpy(YtY))
    _assert_within_scale((tA, tb, tn), (jA, jb, jn), tV.float(), tc,
                         tv.float(), tm.float(), True, YtY, lower=True)


@pytest.mark.parametrize("n,w,r", SHAPES)
@pytest.mark.parametrize("implicit", [False, True])
def test_k4_solutions_match_reference(n, w, r, implicit):
    V, cols, vals, mask, YtY = _problem(n + w + r, n, w, r,
                                        implicit=implicit)
    (jV, jc, jv, jm), (tV, tc, tv, tm) = _both((V, cols, vals, mask))
    if implicit:
        ref = jg.gather_fused_solve_implicit(jV, jc, jv, jm, 0.1, 4.0,
                                             jnp.asarray(YtY),
                                             interpret=True)
        got = tg.gather_fused_solve_implicit(tV, tc, tv, tm, 0.1, 4.0,
                                             torch.from_numpy(YtY))
    else:
        ref = jg.gather_fused_solve_explicit(jV, jc, jv, jm, 0.05,
                                             interpret=True)
        got = tg.gather_fused_solve_explicit(tV, tc, tv, tm, 0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5,
                               rtol=5e-4)
    if n > 3:
        # the empty row, and (implicit) the row with no positive rating,
        # solve to exactly 0 on both sides
        zero = [0, 2] if implicit else [0]
        assert np.all(got.numpy()[zero] == 0)
        assert np.all(np.asarray(ref)[zero] == 0)


@pytest.mark.parametrize("implicit", [False, True])
def test_k4_bfloat16_table_matches_reference(implicit):
    n, w, r = 24, 32, 16
    V, cols, vals, mask, YtY = _problem(5, n, w, r, implicit=implicit)
    (jV, jc, jv, jm), (tV, tc, tv, tm) = _both((V, cols, vals, mask),
                                                "bf16")
    if implicit:
        ref = jg.gather_fused_solve_implicit(jV, jc, jv, jm, 0.1, 4.0,
                                             jnp.asarray(YtY),
                                             interpret=True)
        got = tg.gather_fused_solve_implicit(tV, tc, tv, tm, 0.1, 4.0,
                                             torch.from_numpy(YtY))
    else:
        ref = jg.gather_fused_solve_explicit(jV, jc, jv, jm, 0.05,
                                             interpret=True)
        got = tg.gather_fused_solve_explicit(tV, tc, tv, tm, 0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5,
                               rtol=5e-4)


@pytest.mark.parametrize("two_sided", [True, False])
def test_k3_split_path_matches_unsplit(two_sided):
    n, w, r = 6, 100, 12
    V, cols, vals, mask, _ = _problem(9, n, w, r, implicit=not two_sided)
    t = [torch.from_numpy(a) for a in (V, cols, vals, mask)]
    tV, tc, tv, tm = t
    aw = tm if two_sided else 4.0 * tv.abs() * tm
    S1, b1 = tg.gather_gram(tV, tc, aw, tv * tm, two_sided=two_sided)
    S2, b2 = tg.gather_gram(tV, tc, aw, tv * tm, two_sided=two_sided,
                            split_width=16)
    for a, b in ((S2, S1), (b2, b1)):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    assert torch.equal(S2, S2.transpose(1, 2))


def test_k4_plain_is_k3_plain_then_tail_then_k1_plain():
    """K4's plain version is K3's plain Gram, the tail (``regularize``:
    jitter and the empty-row guard) and the plain solve of K4's solve
    pass, which is K2's tiled recurrence (K1's blocked one before K4
    shared K2's routines), exactly."""
    from tpu_als_torch.ops.cuda_lanes import chol_solve_plain
    from tpu_als_torch.ops.solve import regularize

    V, cols, vals, mask, YtY = _problem(13, 9, 16, 8, implicit=True)
    tV, tc, tv, tm = (torch.from_numpy(a) for a in (V, cols, vals, mask))
    A, b, count = tg.gather_normal_eq_implicit(tV, tc, tv, tm, 0.1, 4.0,
                                               torch.from_numpy(YtY))
    x = tg.gather_fused_solve_implicit(tV, tc, tv, tm, 0.1, 4.0,
                                       torch.from_numpy(YtY))
    torch.testing.assert_close(x, chol_solve_plain(regularize(A, count),
                                                   b), rtol=0, atol=0)


@pytest.mark.parametrize("r", [200, 256])
@pytest.mark.parametrize("implicit", [False, True])
def test_k3_k4_at_rank_256_match_reference_einsum_builders(r, implicit):
    """Above rank 128 (the kernels' shared-memory triangle instantiation)
    the plain versions against the reference's einsum builders on
    ``V[cols]`` (``normal_eq_*``, then ``solve_spd(backend='xla')``) —
    what the reference pins its own gather kernels against — with K3's
    and K4's tolerances above."""
    from tpu_als.ops import solve as jsolve

    V, cols, vals, mask, YtY = _problem(r + implicit, 6, 24, r, N=300,
                                        implicit=implicit)
    (jV, jc, jv, jm), (tV, tc, tv, tm) = _both((V, cols, vals, mask))
    Vg = jV[jc]
    if implicit:
        ref = jsolve.normal_eq_implicit(Vg, jv, jm, 0.1, 4.0,
                                        jnp.asarray(YtY))
        got = tg.gather_normal_eq_implicit(tV, tc, tv, tm, 0.1, 4.0,
                                           torch.from_numpy(YtY))
        x = tg.gather_fused_solve_implicit(tV, tc, tv, tm, 0.1, 4.0,
                                           torch.from_numpy(YtY))
    else:
        ref = jsolve.normal_eq_explicit(Vg, jv, jm, 0.05)
        got = tg.gather_normal_eq_explicit(tV, tc, tv, tm, 0.05)
        x = tg.gather_fused_solve_explicit(tV, tc, tv, tm, 0.05)
    _assert_within_scale(got, ref, tV, tc, tv, tm, implicit, YtY)
    xref = np.asarray(jsolve.solve_spd(*ref, backend="xla"))
    np.testing.assert_allclose(x.numpy(), xref, atol=5e-5, rtol=5e-4)
    zero = [0, 2] if implicit else [0]
    assert np.all(x.numpy()[zero] == 0)


def test_k4_plain_at_rank_320_matches_the_einsum_route():
    """Above the kernels' rank 256 the plain K4 takes any rank: at rank
    320 it raises nothing and agrees with the einsum route (``V[cols]``,
    the torch normal equations, ``solve_spd``: K6's plain factorization
    and two triangular solves), within K4's band."""
    from tpu_als_torch.ops.solve import normal_eq_implicit, solve_spd

    V, cols, vals, mask, YtY = _problem(320, 6, 24, 320, N=300,
                                        implicit=True)
    tV, tc, tv, tm = (torch.from_numpy(a) for a in (V, cols, vals, mask))
    x = tg.gather_fused_solve_implicit(tV, tc, tv, tm, 0.1, 4.0,
                                       torch.from_numpy(YtY))
    A, b, count = normal_eq_implicit(tV[tc.long()], tv, tm, 0.1, 4.0,
                                     torch.from_numpy(YtY))
    xe = solve_spd(A, b, count)
    assert x.shape == (6, 320) and torch.isfinite(x).all()
    np.testing.assert_allclose(x.numpy(), xe.numpy(), atol=5e-5, rtol=5e-4)
    assert np.all(x.numpy()[[0, 2]] == 0)


@pytest.mark.parametrize("r,implicit", [(320, False), (512, True),
                                        (289, True)])
def test_k4_plain_above_rank_256_matches_reference(r, implicit):
    """Above rank 256 (the kernels' strip-staged Gram; the solve pass on
    a thread-block cluster from rank 289, the first rank it takes) K4's
    plain version against the reference's
    fused solve in interpret mode, up to its own bound r_pad 512, with
    K4's tolerance (atol 5e-5, rtol 5e-4)."""
    n, w = 8, 24
    V, cols, vals, mask, YtY = _problem(r + implicit, n, w, r, N=100,
                                        implicit=implicit)
    (jV, jc, jv, jm), (tV, tc, tv, tm) = _both((V, cols, vals, mask))
    if implicit:
        ref = jg.gather_fused_solve_implicit(jV, jc, jv, jm, 0.1, 4.0,
                                             jnp.asarray(YtY),
                                             interpret=True)
        got = tg.gather_fused_solve_implicit(tV, tc, tv, tm, 0.1, 4.0,
                                             torch.from_numpy(YtY))
    else:
        ref = jg.gather_fused_solve_explicit(jV, jc, jv, jm, 0.05,
                                             interpret=True)
        got = tg.gather_fused_solve_explicit(tV, tc, tv, tm, 0.05)
    assert got.shape == (n, r)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5,
                               rtol=5e-4)
    zero = [0, 2] if implicit else [0]
    assert np.all(got.numpy()[zero] == 0)


def test_cluster_plan_holds_every_rank_289_to_512():
    """The solve pass's cluster plan (the mirror of
    ``gsolve::launch_tail_solve``'s ``ccl::cluster_size``) at every rank
    the cluster solve takes: C in {2, 4, 8}, the fewest whose largest share
    fits; every tile row owned by exactly one block of C, the blocks'
    tiles summing to the lower triangle's; the largest share within a
    block's 232,448 bytes."""
    for r in range(289, 513):
        plan = tg._cluster_plan(r)
        t = -(-r // 32)
        assert plan.size in (2, 4, 8), r
        assert len(plan.owners) == t and set(plan.owners) <= set(
            range(plan.size)), r
        assert sum(plan.tiles) == t * (t + 1) // 2, r
        assert plan.tiles == tuple(
            sum(i + 1 for i in range(t) if plan.owners[i] == c)
            for c in range(plan.size)), r
        assert plan.smem_bytes <= 232_448, r
        for c in (2, 4, 8):
            if c < plan.size:
                assert tg._cluster_share(t, c)[0] > 232_448, (r, c)
    for r in (288, 513):
        with pytest.raises(ValueError):
            tg._cluster_plan(r)


def test_cluster_plan_mirrors_the_header():
    """The Python plan equals what ``csrc/chol_cluster.cuh`` computes
    (``ccl::cluster_size``, ``smem_bytes``, ``owner``), compiled with g++
    under ``scripts/cluster_shim/``'s CUDA stand-in, at every rank 289 to
    512."""
    import importlib.util
    import os
    import shutil
    import tempfile

    if shutil.which("g++") is None:
        pytest.skip("g++ is not on the PATH")
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "chol_cluster_shim.py")
    spec = importlib.util.spec_from_file_location("chol_cluster_shim", path)
    shim = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(shim)
    with tempfile.TemporaryDirectory() as work:
        header = shim.plans(shim.build(work))
    assert sorted(header) == list(range(289, 513))
    for r, (c, nbytes, owners) in header.items():
        plan = tg._cluster_plan(r)
        assert (plan.size, plan.smem_bytes, plan.owners) == (c, nbytes,
                                                             owners), r


def test_k3_plain_at_rank_384_matches_reference():
    """K3's plain version against the reference's gather_gram in
    interpret mode at rank 384 (12 strips, 9 parts on the card), with
    K3's tolerance (5e-6 of each entry's Σ|terms|)."""
    n, w, r = 8, 24, 384
    V, cols, vals, mask, YtY = _problem(r, n, w, r, N=100, implicit=True)
    (jV, jc, jv, jm), (tV, tc, tv, tm) = _both((V, cols, vals, mask))
    ref = jg.gather_normal_eq_implicit(jV, jc, jv, jm, 0.1, 4.0,
                                       jnp.asarray(YtY), interpret=True)
    got = tg.gather_normal_eq_implicit(tV, tc, tv, tm, 0.1, 4.0,
                                       torch.from_numpy(YtY))
    _assert_within_scale(got, ref, tV, tc, tv, tm, True, YtY)


def test_fused_solve_bound_at_rank_640_is_the_reference_s():
    """At rank 640 (r_pad 640) the reference's fused solve raises
    TileBudgetError; the port's K4 and K7 wrappers raise ValueError (of
    which TileBudgetError is one) on any device, while K3 takes the rank
    (its plain version here, within 5e-6 of Σ|terms| of the reference's
    einsum builder)."""
    from tpu_als.ops import solve as jsolve

    n, w, r = 4, 8, 640
    V, cols, vals, mask, YtY = _problem(r, n, w, r, N=40)
    (jV, jc, jv, jm), (tV, tc, tv, tm) = _both((V, cols, vals, mask))
    assert issubclass(jg.TileBudgetError, ValueError)
    with pytest.raises(jg.TileBudgetError):
        jg.gather_fused_solve_explicit(jV, jc, jv, jm, 0.05, interpret=True)
    with pytest.raises(ValueError, match="TileBudgetError"):
        tg.gather_fused_solve_explicit(tV, tc, tv, tm, 0.05)
    with pytest.raises(ValueError, match="TileBudgetError"):
        tg.gather_fused_ring_explicit(tV[None], tc[None, None],
                                      tv[None, None], tm[None, None], 0.05)
    got = tg.gather_normal_eq_explicit(tV, tc, tv, tm, 0.05)
    ref = jsolve.normal_eq_explicit(jV[jc], jv, jm, 0.05)
    _assert_within_scale(got, ref, tV, tc, tv, tm, False, YtY)
