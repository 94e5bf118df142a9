"""The fault points of the sharded path against ``tpu_als``.

- ``faults.push_spec`` / ``pop_spec`` / ``push_depth`` / ``active``:
  the reference's behaviour on one spec sequence (overlay, LIFO, the
  unbalanced pop, ``clear`` dropping the stack).
- ``comm.ring_step`` (``parallel.trainer.make_ring_step``): disarmed
  ``make_ring_step`` returns the raw step itself; raise mode gives
  ``InjectedFault`` before the step, corrupt mode ``FactorsCorrupt``
  after it, on the unfused ring and on K7's (``gather_fused_ring``)
  plain version.
- ``serve.gather`` (``parallel.serve.topk_sharded``), the reference's
  cases (``tests/test_resilience.py``): a clean answer fills the
  last-good cache; raise and corrupt answer degraded (``info``, the
  ``serve.degraded`` counter, the ``serve_degraded`` event) with the
  clean scores within SERVE_TOL and the reference's degraded scores; no
  cache raises ``ServeShardLost``; the answer recovers when the fault
  clears; two meshes (other logical ids) never answer from each other's
  catalog; one entry per mesh, also under concurrent serves.  The
  stated divergence: a ``RuntimeError`` from the scorer propagates and
  nothing is degraded.
"""

import numpy as np
import pytest
import torch

from tpu_als import obs as jobs
from tpu_als.parallel import serve as jserve
from tpu_als.parallel.mesh import make_mesh as j_make_mesh
from tpu_als.resilience import faults as jfaults
from tpu_als_torch import obs
from tpu_als_torch.core import als as tals
from tpu_als_torch.ops import cuda_topk
from tpu_als_torch.parallel import comm, data, serve, trainer
from tpu_als_torch.parallel.mesh import make_mesh
from tpu_als_torch.resilience import faults

SERVE_TOL = 1e-5            # the reference's own band for degraded scores


@pytest.fixture(autouse=True)
def _clean():
    for pkg in (faults, jfaults):
        pkg.clear()
    serve.reset_last_good()
    jserve.reset_last_good()
    yield
    for pkg in (faults, jfaults):
        pkg.clear()
    serve.reset_last_good()
    jserve.reset_last_good()


def test_push_pop_spec_match_the_reference():
    seen = []
    for pkg in (faults, jfaults):
        trail = []
        pkg.install("solve.gram=corrupt@nth=2")
        trail.append((pkg.active(), pkg.push_depth()))
        pkg.check("solve.gram")               # hit 1 of the base rule
        pkg.push_spec("serving.publish=raise@once")
        trail.append((pkg.armed("serving.publish"), pkg.armed("solve.gram"),
                      pkg.push_depth()))
        # the overlay keeps the base rule's hit counter
        trail.append(pkg.check("solve.gram"))
        with pytest.raises(pkg.InjectedFault):
            pkg.check("serving.publish")
        pkg.push_spec("serving.publish=corrupt@once")
        trail.append((pkg.check("serving.publish"), pkg.push_depth()))
        pkg.pop_spec()
        pkg.pop_spec()
        trail.append((pkg.armed("serving.publish"), pkg.armed("solve.gram"),
                      pkg.push_depth(), pkg.hits("solve.gram")))
        with pytest.raises(RuntimeError, match="without a matching"):
            pkg.pop_spec()
        pkg.clear()
        pkg.push_spec("solve.gram=raise@once")
        trail.append((pkg.active(), pkg.push_depth()))
        pkg.pop_spec()
        trail.append((pkg.active(), pkg.push_depth()))
        pkg.push_spec("solve.gram=raise@once")
        pkg.clear()
        trail.append((pkg.active(), pkg.push_depth()))
        seen.append(trail)
    assert seen[0] == seen[1]
    assert seen[0][-1] == (False, 0)


def test_new_fault_points_are_declared():
    for point in ("comm.ring_step", "serve.gather", "mesh.device_lost"):
        assert point in faults.FAULT_POINTS
        assert point in jfaults.FAULT_POINTS
        faults.install(f"{point}=raise@once")


def _ring(rng, fused):
    D, rank = 4, 4
    u = rng.integers(0, 24, 300)
    i = rng.integers(0, 16, 300)
    r = np.abs(rng.normal(size=300)).astype(np.float32) + 0.1
    up = data.partition_balanced(np.bincount(u, minlength=24), D)
    ip = data.partition_balanced(np.bincount(i, minlength=16), D)
    cfg = tals.AlsConfig(rank=rank, max_iter=1, reg_param=0.1,
                         solve_backend="gather_fused_ring" if fused
                         else "auto")
    grids = (comm.shard_csr_grid(up, ip, u, i, r, min_width=4),
             comm.shard_csr_grid(ip, up, i, u, r, min_width=4))
    counts = (trainer.stacked_counts(up, u, r),
              trainer.stacked_counts(ip, i, r))
    mesh = make_mesh(devices=["cpu"] * D)
    U = torch.ones(up.padded_rows, rank)
    V = torch.ones(ip.padded_rows, rank)
    return (lambda: trainer.make_ring_step(mesh, *grids, cfg, counts)), U, V


@pytest.mark.parametrize("fused", [False, True])
def test_ring_step_fault_point(rng, fused):
    build, U, V = _ring(rng, fused)
    raw = build()
    assert raw.__name__ == "ring_step"        # disarmed: the raw step
    U1, V1 = raw(U, V)
    assert torch.isfinite(U1).all() and torch.isfinite(V1).all()

    faults.install("comm.ring_step=raise@nth=1")
    step = build()
    assert step.__name__ == "chaos_step"
    with pytest.raises(faults.InjectedFault):
        step(U, V)

    faults.install("comm.ring_step=corrupt@nth=2")
    step = build()
    U2, V2 = step(U, V)                       # hit 1: clean
    assert torch.equal(U2, U1) and torch.equal(V2, V1)
    with pytest.raises(trainer.FactorsCorrupt):
        step(U2, V2)                          # hit 2: poisoned


def _serve_setup(rng):
    U = rng.normal(size=(12, 4)).astype(np.float32)
    V = rng.normal(size=(20, 4)).astype(np.float32)
    return U, V, make_mesh(devices=["cpu"] * 4), j_make_mesh(4)


@pytest.mark.parametrize("mode", ["raise", "corrupt"])
def test_serve_degrades_to_the_last_good_catalog(rng, mode):
    U, V, mesh, jmesh = _serve_setup(rng)
    obs.reset()
    jreg = jobs.reset()
    s0, i0 = serve.topk_sharded(U, V, 5, mesh)      # fills the cache
    js0, _ = jserve.topk_sharded(U, V, 5, jmesh)
    faults.install(f"serve.gather={mode}@nth=1")
    jfaults.install(f"serve.gather={mode}@nth=1")
    s1, i1, info = serve.topk_sharded(U, V, 5, mesh, return_info=True)
    js1, _, jinfo = jserve.topk_sharded(U, V, 5, jmesh, return_info=True)
    assert info["degraded"] and jinfo["degraded"]
    assert info["reason"].split(":")[0] == jinfo["reason"].split(":")[0]
    np.testing.assert_allclose(s1.numpy(), s0.numpy(), atol=SERVE_TOL)
    np.testing.assert_allclose(s1.numpy(), js1, atol=SERVE_TOL)
    np.testing.assert_allclose(s0.numpy(), js0, atol=SERVE_TOL)
    assert obs.snapshot()["counters"]["serve.degraded"] == 1 == \
        jreg.snapshot()["counters"]["serve.degraded"]
    ev = obs.events("serve_degraded")
    assert len(ev) == 1 and ev[0]["strategy"] == "all_gather"


def test_serve_without_cache_raises_shard_lost(rng):
    U, V, mesh, _ = _serve_setup(rng)
    faults.install("serve.gather=raise@nth=1")
    with pytest.raises(serve.ServeShardLost):
        serve.topk_sharded(U, V, 5, mesh)


def test_serve_recovers_after_the_fault_clears(rng):
    U, V, mesh, _ = _serve_setup(rng)
    s0, _ = serve.topk_sharded(U, V, 5, mesh, strategy="merge_ring")
    faults.install("serve.gather=raise@nth=1")
    _, _, info = serve.topk_sharded(U, V, 5, mesh, return_info=True)
    assert info["degraded"]
    s2, _, info2 = serve.topk_sharded(U, V, 5, mesh, strategy="merge_ring",
                                      return_info=True)
    assert not info2["degraded"] and info2["reason"] is None
    assert torch.equal(s2, s0)


def test_last_good_cache_is_keyed_by_the_mesh_ids(rng):
    """Two meshes on one device with other logical ids never answer from
    each other's catalog; the cache holds one entry per mesh, the newest
    serve of any strategy, and it backs any strategy's failover."""
    U, V, mesh_a, _ = _serve_setup(rng)
    mesh_b = make_mesh(devices=["cpu"] * 4, ids=(4, 5, 6, 7))
    assert mesh_a.device == mesh_b.device and mesh_a != mesh_b
    s0, _ = serve.topk_sharded(U, V, 5, mesh_a, strategy="all_gather")
    serve.topk_sharded(U, V, 5, mesh_a, strategy="ring")
    with serve._last_good_lock:
        assert len(serve._last_good) == 1
    faults.install("serve.gather=raise@first=2")
    with pytest.raises(serve.ServeShardLost):
        serve.topk_sharded(U, V, 5, mesh_b)
    s1, _, info = serve.topk_sharded(U, V, 5, mesh_a, strategy="merge_ring",
                                     return_info=True)
    assert info["degraded"]
    np.testing.assert_allclose(s1.numpy(), s0.numpy(), atol=SERVE_TOL)


def test_runtime_error_from_the_scorer_propagates(rng, monkeypatch):
    """The stated divergence: the reference degrades on any
    ``RuntimeError``; the port raises it (a kernel failure is never
    hidden behind a degraded answer), with a last-good catalog cached."""
    U, V, mesh, _ = _serve_setup(rng)
    serve.topk_sharded(U, V, 5, mesh)
    obs.reset()

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(cuda_topk, "topk_scores", broken)
    with pytest.raises(RuntimeError, match="illegal memory"):
        serve.topk_sharded(U, V, 5, mesh)
    assert obs.counter_value("serve.degraded") == 0
    assert obs.events("serve_degraded") == []


def test_last_good_cache_under_concurrent_serves(rng):
    """More serving threads than cores, each on its own mesh (its own
    logical ids) and catalog, the interpreter switching threads as often
    as it can: every mesh ends with exactly its own catalog cached, and
    its degraded answer is its own clean one."""
    import sys
    import threading

    n = 16
    U = rng.normal(size=(6, 4)).astype(np.float32)
    cats = [rng.normal(size=(12, 4)).astype(np.float32) for _ in range(n)]
    meshes = [make_mesh(devices=["cpu"] * 2, ids=(2 * t, 2 * t + 1))
              for t in range(n)]
    clean, errors = [None] * n, []

    def work(t):
        try:
            for _ in range(5):
                clean[t] = serve.topk_sharded(U, cats[t], 3, meshes[t])
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(th.is_alive() for th in threads)
    with serve._last_good_lock:
        assert len(serve._last_good) == n
    faults.install(f"serve.gather=raise@first={n}")
    for t in range(n):
        s, ix, info = serve.topk_sharded(U, cats[t], 3, meshes[t],
                                         return_info=True)
        assert info["degraded"]
        assert torch.equal(s, clean[t][0]) and torch.equal(ix, clean[t][1])
