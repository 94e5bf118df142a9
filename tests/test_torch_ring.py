"""Parity of the port's sharded training with ``tpu_als``.

- The host layout (``partition_balanced``, ``shard_csr``,
  ``shard_csr_grid``, ``stacked_counts``) is numpy on both sides: the bar
  is array equality, on the adversarial degree laws of
  ``tests/test_blocking_property.py``.
- Kernel K7's plain version against the reference's
  ``gather_fused_ring_explicit``/``_implicit`` under ``shard_map`` on
  ``make_mesh(S)`` (its Pallas kernel in interpret mode), with the
  reference's own bands (``tests/test_ring_substrate.py``): atol 2e-5 and
  rtol 1e-5 explicit, 1e-4 both implicit (α = 40 makes the systems'
  entries large; both sides sum them in other orders); at S = 1 it is
  K4's plain version exactly (``torch.equal``).
- ``train_sharded`` on a mesh of S logical shards on the CPU, three
  iterations from one injected init, against the reference's
  ``train_sharded`` on ``make_mesh(S)`` and the port's single-device
  ``train``, at 2e-3 (the reference's band for its own ring against one
  device, ``tests/test_ring_substrate.py``).
- The estimator surface: ``ALS(mesh=...).fit``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from test_blocking_property import CASES
from tpu_als.core.als import AlsConfig as JConfig
from tpu_als.ops.pallas_gather_ne import (
    gather_fused_ring_explicit as j_ring_explicit,
    gather_fused_ring_implicit as j_ring_implicit,
)
from tpu_als.parallel import comm as jcomm
from tpu_als.parallel import data as jdata
from tpu_als.parallel import trainer as jtrainer
from tpu_als.parallel.mesh import make_mesh as j_make_mesh
from tpu_als.parallel.mesh import shard_map
import tpu_als_torch
from tpu_als_torch.convert import entity_rows, slot_rows
from tpu_als_torch.core import als as tals
from tpu_als_torch.core.ratings import build_csr_buckets as tbuild
from tpu_als_torch.ops import cuda_gather_ne as gne
from tpu_als_torch.parallel import comm as tcomm
from tpu_als_torch.parallel import data as tdata
from tpu_als_torch.parallel import trainer as ttrainer
from tpu_als_torch.parallel.mesh import make_mesh

# K7 plain vs the reference's kernel: (atol, rtol) by implicit
RING_TOL = {False: (2e-5, 1e-5), True: (1e-4, 1e-4)}
TRAIN_TOL = 2e-3                    # sharded vs reference / one device
RANK = 128                          # the reference kernel pads to 128


def _assert_same(t, j, names):
    for name in names:
        a, b = np.asarray(getattr(t, name)), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_layout_array_equal(case):
    num_rows, gen = CASES[case]
    u, i, r = gen(np.random.default_rng(7))
    n_cols = int(i.max()) + 1
    for S in (3, 4):
        tu = tdata.partition_balanced(np.bincount(u, minlength=num_rows), S)
        ju = jdata.partition_balanced(np.bincount(u, minlength=num_rows), S)
        ti = tdata.partition_balanced(np.bincount(i, minlength=n_cols), S)
        ji = jdata.partition_balanced(np.bincount(i, minlength=n_cols), S)
        for t, j in ((tu, ju), (ti, ji)):
            _assert_same(t, j, ("owner", "local", "slot"))
            assert (t.rows_per_shard, t.padded_rows) == \
                (j.rows_per_shard, j.padded_rows)
        for build_t, build_j in ((tdata.shard_csr, jdata.shard_csr),
                                 (tcomm.shard_csr_grid,
                                  jcomm.shard_csr_grid)):
            t, j = build_t(tu, ti, u, i, r), build_j(ju, ji, u, i, r)
            assert (t.rows_per_shard, t.chunk_elems, t.nnz) == \
                (j.rows_per_shard, j.chunk_elems, j.nnz)
            assert len(t.buckets) == len(j.buckets)
            for tb, jb in zip(t.buckets, j.buckets):
                _assert_same(tb, jb, ("rows", "cols", "vals", "mask"))
        for pos in (False, True):
            np.testing.assert_array_equal(
                ttrainer.stacked_counts(tu, u, r, positive_only=pos),
                jtrainer.stacked_counts(ju, u, r, positive_only=pos))


def _ring_problem(seed, S, per, n, w, implicit):
    rng = np.random.default_rng(seed)
    V = (rng.normal(size=(S * per, RANK)) / np.sqrt(RANK)).astype(np.float32)
    cols = rng.integers(0, per, size=(S, S, n, w)).astype(np.int32)
    vals = rng.normal(size=(S, S, n, w)).astype(np.float32)
    mask = (rng.random(size=(S, S, n, w)) < 0.7).astype(np.float32)
    mask[:, :, 0] = 0.0  # an empty row on every owner
    if implicit:
        vals = np.abs(vals) * 4 + 0.1
        vals[:, :, 1] *= -1  # a row with no positive rating
    vals *= mask
    return V, cols, vals, mask


def _reference_ring(V, cols, vals, mask, implicit, S):
    mesh = j_make_mesh(S)
    YtY = V.T @ V

    @jax.jit
    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P("d"), P("d"), P("d"), P("d"), P()),
                       out_specs=P("d"), check_vma=False)
    def run(V_shard, c, v, m, yty):
        if implicit:
            return j_ring_implicit(V_shard, c[0], v[0], m[0], 0.05, 40.0,
                                   yty, axis_name="d", interpret=True)[None]
        return j_ring_explicit(V_shard, c[0], v[0], m[0], 0.05,
                               axis_name="d", interpret=True)[None]

    return np.asarray(run(*(jnp.asarray(a) for a in
                            (V, cols, vals, mask, YtY))))


def _port_ring(V, cols, vals, mask, implicit, S):
    Vs = torch.from_numpy(V).reshape(S, -1, RANK)
    c, v, m = (torch.from_numpy(a) for a in (cols, vals, mask))
    if implicit:
        YtY = torch.from_numpy(V.T @ V)
        return gne.gather_fused_ring_implicit(Vs, c, v, m, 0.05, 40.0, YtY)
    return gne.gather_fused_ring_explicit(Vs, c, v, m, 0.05)


@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("implicit", [False, True])
def test_k7_plain_matches_reference_ring_kernel(S, implicit):
    V, cols, vals, mask = _ring_problem(S + 10 * implicit, S, 24, 12, 8,
                                        implicit)
    before = gne.RING_LAUNCHES
    x = _port_ring(V, cols, vals, mask, implicit, S).numpy()
    assert gne.RING_LAUNCHES == before  # CPU tensors: the plain version
    ref = _reference_ring(V, cols, vals, mask, implicit, S)
    atol, rtol = RING_TOL[implicit]
    np.testing.assert_allclose(x, ref, atol=atol, rtol=rtol)
    np.testing.assert_array_equal(x[:, 0], 0.0)  # the empty rows
    if implicit:
        np.testing.assert_array_equal(x[:, 1], 0.0)


@pytest.mark.parametrize("implicit", [False, True])
def test_k7_plain_at_one_shard_is_k4_plain(implicit):
    V, cols, vals, mask = _ring_problem(5, 1, 40, 16, 24, implicit)
    x = _port_ring(V, cols, vals, mask, implicit, 1)
    tV, c, v, m = (torch.from_numpy(a) for a in
                   (V, cols[0, 0], vals[0, 0], mask[0, 0]))
    if implicit:
        x4 = gne.gather_fused_solve_implicit(tV, c, v, m, 0.05, 40.0,
                                             torch.from_numpy(V.T @ V))
    else:
        x4 = gne.gather_fused_solve_explicit(tV, c, v, m, 0.05)
    assert torch.equal(x[0], x4)


NU, NI = 60, 45
STRATEGIES = [("all_gather", "auto"), ("ring", "auto"),
              ("ring", "gather_fused_ring")]


@functools.lru_cache(maxsize=None)
def _ratings(implicit):
    rng = np.random.default_rng(2)
    u = rng.integers(0, NU, 1100)
    i = rng.integers(0, NI, 1100)
    r = (rng.integers(1, 11, 1100) * 0.5).astype(np.float32)
    if implicit:
        r[rng.random(1100) < 0.1] *= -1
    g = np.random.default_rng(3)
    U0 = g.normal(size=(NU, 4)).astype(np.float32)
    V0 = g.normal(size=(NI, 4)).astype(np.float32)
    U0 /= np.linalg.norm(U0, axis=1, keepdims=True)
    V0 /= np.linalg.norm(V0, axis=1, keepdims=True)
    return u, i, r, U0, V0


def _containers(pkg_data, pkg_comm, pkg_trainer, strategy, parts, u, i, r,
                implicit):
    up, ip = parts
    if strategy == "ring":
        return ((pkg_comm.shard_csr_grid(up, ip, u, i, r, min_width=4),
                 pkg_comm.shard_csr_grid(ip, up, i, u, r, min_width=4)),
                (pkg_trainer.stacked_counts(up, u, r, positive_only=implicit),
                 pkg_trainer.stacked_counts(ip, i, r,
                                            positive_only=implicit)))
    return ((pkg_data.shard_csr(up, ip, u, i, r, min_width=4),
             pkg_data.shard_csr(ip, up, i, u, r, min_width=4)), None)


@functools.lru_cache(maxsize=None)
def _reference_sharded(strategy, backend, implicit, S):
    u, i, r, U0, V0 = _ratings(implicit)
    parts = (jdata.partition_balanced(np.bincount(u, minlength=NU), S),
             jdata.partition_balanced(np.bincount(i, minlength=NI), S))
    (us, is_), counts = _containers(jdata, jcomm, jtrainer, strategy, parts,
                                    u, i, r, implicit)
    cfg = JConfig(rank=4, max_iter=3, reg_param=0.05, implicit_prefs=implicit,
                  alpha=6.0, solve_backend=backend)
    U, V = jtrainer.train_sharded(j_make_mesh(S), *parts, us, is_, cfg,
                                  strategy=strategy, ring_counts=counts,
                                  init=(U0, V0))
    return np.asarray(U)[parts[0].slot], np.asarray(V)[parts[1].slot]


@pytest.mark.parametrize("strategy,backend", STRATEGIES)
@pytest.mark.parametrize("implicit", [False, True])
def test_train_sharded_matches_reference_and_one_device(strategy, backend,
                                                        implicit):
    S = 3
    u, i, r, U0, V0 = _ratings(implicit)
    parts = (tdata.partition_balanced(np.bincount(u, minlength=NU), S),
             tdata.partition_balanced(np.bincount(i, minlength=NI), S))
    (us, is_), counts = _containers(tdata, tcomm, ttrainer, strategy, parts,
                                    u, i, r, implicit)
    cfg = tals.AlsConfig(rank=4, max_iter=3, reg_param=0.05,
                         implicit_prefs=implicit, alpha=6.0,
                         solve_backend=backend)
    before = gne.RING_LAUNCHES
    U, V = ttrainer.train_sharded(make_mesh(devices=["cpu"] * S), *parts, us,
                                  is_, cfg, strategy=strategy,
                                  ring_counts=counts, init=(U0, V0))
    assert gne.RING_LAUNCHES == before
    got = (entity_rows(parts[0], U).numpy(), entity_rows(parts[1], V).numpy())
    one = tals.train(tbuild(u, i, r, NU, min_width=4),
                     tbuild(i, u, r, NI, min_width=4),
                     tals.AlsConfig(rank=4, max_iter=3, reg_param=0.05,
                                    implicit_prefs=implicit, alpha=6.0),
                     init=(U0, V0), device="cpu")
    ref = _reference_sharded(strategy, backend, implicit, S)
    for g, j, o in zip(got, ref, one):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, j, atol=TRAIN_TOL, rtol=TRAIN_TOL)
        np.testing.assert_allclose(g, o.numpy(), atol=TRAIN_TOL,
                                   rtol=TRAIN_TOL)


def test_slot_space_helpers_round_trip_both_packages():
    u, i, r, U0, _ = _ratings(False)
    tp = tdata.partition_balanced(np.bincount(u, minlength=NU), 4)
    jp = jdata.partition_balanced(np.bincount(u, minlength=NU), 4)
    table = slot_rows(tp, U0)
    assert table.shape == (tp.padded_rows, 4)
    np.testing.assert_array_equal(entity_rows(jp, table), U0)
    t = slot_rows(tp, torch.from_numpy(U0))
    np.testing.assert_array_equal(t.numpy(), table)
    assert torch.equal(entity_rows(tp, t), torch.from_numpy(U0))


@pytest.mark.parametrize("strategy", ["all_gather", "ring"])
def test_estimator_fits_over_a_mesh(strategy):
    """``ALS(mesh=...).fit`` on CPU logical shards lands on the
    single-device fit (same seed, so the same init), and the model it
    returns lives on the mesh's device."""
    u, i, r, _, _ = _ratings(True)
    frame = {"user": u * 3 + 1, "item": i * 2 + 5, "rating": r}
    kw = dict(rank=4, maxIter=3, regParam=0.05, implicitPrefs=True,
              alpha=6.0, seed=4)
    seen = []
    sharded = tpu_als_torch.ALS(
        mesh=make_mesh(devices=["cpu"] * 3), gatherStrategy=strategy,
        fitCallback=lambda it, U, V: seen.append((it, U.shape)),
        **kw).fit(frame)
    single = tpu_als_torch.ALS(device="cpu", **kw).fit(frame)
    assert sharded.device == torch.device("cpu")
    assert seen == [(it, (NU, 4)) for it in (1, 2, 3)]
    np.testing.assert_allclose(sharded._U.numpy(), single._U.numpy(),
                               atol=TRAIN_TOL, rtol=TRAIN_TOL)
    np.testing.assert_allclose(sharded._V.numpy(), single._V.numpy(),
                               atol=TRAIN_TOL, rtol=TRAIN_TOL)
