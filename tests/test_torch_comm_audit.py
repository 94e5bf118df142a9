"""The port's collective-traffic audit (``parallel/comm_audit.py``)
against ``trainer.comm_bytes_per_iter`` and the reference's jaxpr audit.

- One spawned gloo group of 4 CPU processes, one shard each, runs every
  strategy of the multi-process path once at the reference's tiny
  problem (``tests/test_comm_audit.py``: 60 x 40 x 900, chunk budget 512
  so several row tiles, 3 column blocks; the banded problem for
  'all_to_all'), explicit and implicit, from one init: the bytes
  ``collective_bytes`` counts equal the port's ``comm_bytes_per_iter``
  AND the reference's ``collective_bytes`` of the same problem traced on
  a 4-device mesh, primitive by primitive.
- ``remote_dma_bytes`` over K7's and K8's wrappers (their plain versions
  here) equals the closed forms ``ring_remote_bytes`` (through
  ``comm_bytes_per_iter('gather_fused_ring')``, the reference's too) and
  ``serve_merge_remote_bytes``.
- The eager divergence: a branch or a loop whose collectives depend on
  the data is counted as it ran, where the reference's ``cond`` and
  ``while`` rules raise.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from tpu_als.core.als import AlsConfig as JConfig
from tpu_als.parallel import trainer as jtrainer
from tpu_als.parallel.a2a import build_a2a as j_build_a2a
from tpu_als.parallel.comm import shard_csr_grid as j_grid
from tpu_als.parallel.comm_audit import collective_bytes as j_collective
from tpu_als.parallel.data import partition_balanced as j_partition
from tpu_als.parallel.data import shard_csr as j_shard_csr
from tpu_als.parallel.mesh import AXIS, make_mesh as j_make_mesh
from tpu_als_torch.core.als import AlsConfig
from tpu_als_torch.parallel import comm_audit, multihost
from tpu_als_torch.parallel.comm import shard_csr_grid
from tpu_als_torch.parallel.data import partition_balanced
from tpu_als_torch.parallel.mesh import make_mesh
from tpu_als_torch.parallel.trainer import (comm_bytes_per_iter,
                                            make_ring_step, stacked_counts)
from tpu_als_torch.perf.roofline import serve_merge_remote_bytes

D = 4
RANK = 8
CHUNK, BLOCKS = 512, 3
STRATEGIES = comm_audit.PROCESS_STRATEGIES


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem():
    rng = np.random.default_rng(0)
    nU, nI, nnz = 60, 40, 900
    u = rng.integers(0, nU, nnz)
    i = rng.integers(0, nI, nnz)
    r = (np.abs(rng.normal(size=nnz)) + 0.1).astype(np.float32)
    # banded-sparse, so the all_to_all plan is not degenerate
    g = np.random.default_rng(5)
    aU, aI = 24 * D, 48 * D
    au = g.integers(0, aU, 2 * aU)
    ai = g.integers(0, aI, 2 * aU)
    ar = (np.abs(g.normal(size=2 * aU)) + 0.1).astype(np.float32)
    return (u, i, r, nU, nI), (au, ai, ar, aU, aI)


@pytest.fixture(scope="module")
def audited(tmp_path_factory):
    """Every process's rows: one gloo group, one spawn."""
    (u, i, r, nU, nI), a2a = _problem()
    out = comm_audit.spawn(str(tmp_path_factory.mktemp("audit")), u, i, r,
                           nU, nI, RANK, nproc=D, chunk_elems=CHUNK,
                           gather_blocks=BLOCKS, a2a=a2a)
    return {(x["strategy"], x["implicit"]): [rows[k] for rows in out]
            for k, x in enumerate(out[0])}


def _reference_bytes(strategy, implicit):
    """The reference's jaxpr audit of the same problem on a 4-device
    mesh (zero factors: the bytes do not depend on the values)."""
    (u, i, r, nU, nI), a2a = _problem()
    uu, ii, rr, nu, ni = a2a if strategy == "all_to_all" \
        else (u, i, r, nU, nI)
    up = j_partition(np.bincount(uu, minlength=nu), D)
    ip = j_partition(np.bincount(ii, minlength=ni), D)
    mesh = j_make_mesh(D)
    lead = NamedSharding(mesh, P(AXIS))
    put = lambda x: jax.device_put(x, lead)  # noqa: E731
    U = put(jnp.zeros((up.padded_rows, RANK), jnp.float32))
    V = put(jnp.zeros((ip.padded_rows, RANK), jnp.float32))
    cfg = JConfig(rank=RANK, max_iter=1, reg_param=0.1,
                  implicit_prefs=implicit, alpha=4.0, seed=0)
    if strategy in ("ring", "ring_overlap"):
        uc = j_grid(up, ip, uu, ii, rr, min_width=4, chunk_elems=CHUNK)
        ic = j_grid(ip, up, ii, uu, rr, min_width=4, chunk_elems=CHUNK)
        step = jtrainer.make_ring_step(mesh, uc, ic, cfg,
                                       overlap=strategy == "ring_overlap")
        args = (U, V, put(uc.device_buckets()), put(ic.device_buckets()),
                put(jnp.asarray(jtrainer.stacked_counts(
                    up, uu, rr, positive_only=implicit))),
                put(jnp.asarray(jtrainer.stacked_counts(
                    ip, ii, rr, positive_only=implicit))))
    elif strategy == "all_to_all":
        uc = j_build_a2a(up, ip, uu, ii, rr, min_width=4)
        ic = j_build_a2a(ip, up, ii, uu, rr, min_width=4)
        assert not uc.degenerate and not ic.degenerate
        step = jtrainer.make_a2a_step(mesh, uc, ic, cfg)
        args = (U, V, put(uc.device_buckets()), put(ic.device_buckets()),
                put(jnp.asarray(uc.send_idx)), put(jnp.asarray(ic.send_idx)))
    else:
        uc = j_shard_csr(up, ip, uu, ii, rr, min_width=4, chunk_elems=CHUNK)
        ic = j_shard_csr(ip, up, ii, uu, rr, min_width=4, chunk_elems=CHUNK)
        step = (jtrainer.make_sharded_step(mesh, uc, ic, cfg)
                if strategy == "all_gather" else
                jtrainer.make_chunked_gather_step(mesh, uc, ic, cfg,
                                                  n_blocks=BLOCKS))
        args = (U, V, put(uc.device_buckets()), put(ic.device_buckets()))
    return j_collective(step, *args, axis_size=D)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("implicit", [False, True])
def test_audited_bytes_equal_the_model_and_the_reference(audited, strategy,
                                                         implicit):
    rows = audited[strategy, implicit]
    assert len(rows) == D
    ref_total, ref_breakdown = _reference_bytes(strategy, implicit)
    for row in rows:                      # every process, one shard each
        assert row["audited"] == row["model"] == ref_total, \
            (row, ref_total, ref_breakdown)
        assert row["breakdown"] == ref_breakdown
        # across processes 'ring_overlap' is the ring's own step: audited
        # once, with it
        assert row.get("same_step_as") == (
            "ring" if strategy == "ring_overlap" else None)
    assert ("psum" in ref_breakdown) == implicit


def test_gated_spawn_waits_for_its_release(tmp_path):
    """The processes import, join and block, then wait for the gate: no
    step runs before it is set."""
    import threading

    (u, i, r, nU, nI), _ = _problem()
    gate, out = threading.Event(), {}
    th = threading.Thread(target=lambda: out.update(rows=comm_audit.spawn(
        str(tmp_path), u, i, r, nU, nI, RANK, nproc=2, implicit=(True,),
        chunk_elems=CHUNK, gate=gate)))
    th.start()
    th.join(timeout=5)
    assert th.is_alive() and "rows" not in out      # held at the gate
    gate.set()
    th.join(timeout=120)
    rows = out["rows"]
    assert [x["strategy"] for x in rows[0]] == list(STRATEGIES)
    assert all(x["audited"] == x["model"] for p in rows for x in p)


def test_the_model_grows_with_the_row_tiles(audited):
    """The chunk budget cuts several row tiles, and the audit saw every
    one: the ring and the chunked gather move more than one tile's."""
    one = audited["all_gather", False][0]["audited"]
    assert audited["all_gather_chunked", False][0]["audited"] > one
    assert audited["ring", False][0]["audited"] > one


def test_remote_bytes_over_k7_equal_the_closed_form():
    (u, i, r, nU, nI), _ = _problem()
    rank = 128
    up = partition_balanced(np.bincount(u, minlength=nU), D)
    ip = partition_balanced(np.bincount(i, minlength=nI), D)
    ug = shard_csr_grid(up, ip, u, i, r, min_width=4)
    ig = shard_csr_grid(ip, up, i, u, r, min_width=4)
    cfg = AlsConfig(rank=rank, max_iter=1, reg_param=0.1,
                    implicit_prefs=True, alpha=4.0,
                    solve_backend="gather_fused_ring")
    step = make_ring_step(make_mesh(devices=["cpu"] * D), ug, ig, cfg,
                          (stacked_counts(up, u, r, positive_only=True),
                           stacked_counts(ip, i, r, positive_only=True)))
    g = torch.Generator().manual_seed(0)
    U = torch.randn(up.padded_rows, rank, generator=g)
    V = torch.randn(ip.padded_rows, rank, generator=g)
    total, per_call = comm_audit.remote_dma_bytes(step, U, V)
    model = comm_bytes_per_iter("gather_fused_ring", up, ip, rank,
                                user_container=ug, item_container=ig)
    jup = j_partition(np.bincount(u, minlength=nU), D)
    jip = j_partition(np.bincount(i, minlength=nI), D)
    ref = jtrainer.comm_bytes_per_iter(
        "gather_fused_ring", jup, jip, rank,
        user_container=j_grid(jup, jip, u, i, r, min_width=4),
        item_container=j_grid(jip, jup, i, u, r, min_width=4))
    assert total == model == ref > 0
    assert len(per_call) == len(ug.buckets) + len(ig.buckets)
    # nothing crossed processes: K7 reads every shard in one launch
    assert comm_audit.collective_bytes(step, U, V, axis_size=D) == (0, {})


@pytest.mark.parametrize("n", [40, 300])
def test_remote_bytes_over_k8_equal_the_closed_form(n):
    from tpu_als_torch.parallel.serve import topk_sharded

    g = torch.Generator().manual_seed(1)
    U = torch.randn(n, 16, generator=g)
    V = torch.randn(90, 16, generator=g)
    mesh = make_mesh(devices=["cpu"] * D)
    total, per_call = comm_audit.remote_dma_bytes(
        lambda: topk_sharded(U, V, 5, mesh, strategy="merge_ring"),
        fires=lambda grid: grid[0] * (D - 1))
    tile_u = min(256, -(-n // 8) * 8)
    want = serve_merge_remote_bytes(-(-n // tile_u), D, tile_u)
    assert total == want and len(per_call) == 1
    jrl = importlib.import_module("tpu_als.perf.roofline")
    assert want == jrl.serve_merge_remote_bytes(-(-n // tile_u), D, tile_u)


# -- the deliberate divergence: eager control flow is counted as it ran --------

class _FakeGroup:
    """A one-process stand-in for a gloo group of ``size``: every peer
    sends what this process sends, so the collectives run their real
    code (and recorder) paths here."""

    def __init__(self, size):
        self.size = size

    def get_world_size(self):
        return self.size

    def get_rank(self):
        return 0

    def all_gather(self, parts, h):
        for p in parts:
            p.copy_(h)

    def all_to_all_single(self, out, h):
        out.copy_(h)


def test_eager_branches_and_loops_count_what_ran(monkeypatch):
    """The reference raises on a ``cond`` whose branches move different
    bytes and on a collective inside a ``while``; eager torch runs one
    branch and one trip count, and the audit counts exactly those."""
    monkeypatch.setattr(multihost, "_dist", lambda: _FakeGroup(D))
    x = torch.ones(4, 8)

    def branchy(x):
        if bool(x.sum() > 0):
            return multihost.all_gather(x)              # (S-1)/S·|out|
        return multihost.all_reduce_sum(x[None])       # 2(S-1)/S·|x|

    def loop(x, trips):
        while trips:
            x = multihost.all_reduce_sum(x[None]) / D
            trips -= 1
        return x

    out = D * x.numel() * 4
    assert comm_audit.collective_bytes(branchy, x, axis_size=D) == \
        ((D - 1) * out // D, {"all_gather": (D - 1) * out // D})
    psum = 2 * (D - 1) * x.numel() * 4 // D
    assert comm_audit.collective_bytes(branchy, -x, axis_size=D) == \
        (psum, {"psum": psum})
    for trips in (0, 1, 3):
        assert comm_audit.collective_bytes(loop, x, trips, axis_size=D)[0] \
            == trips * psum
    # the shard-ordered psum: D copies of x, added in position order
    assert torch.equal(multihost.all_reduce_sum(x[None]), D * x)


def test_the_recorder_is_separate_from_comm(monkeypatch):
    monkeypatch.setattr(multihost, "_dist", lambda: _FakeGroup(D))
    multihost.reset_comm()
    x = torch.ones(4, 8)
    multihost.all_gather(x)
    before = dict(multihost.COMM)
    comm_audit.collective_bytes(multihost.all_gather, x, axis_size=D)
    after = dict(multihost.COMM)
    assert after["collectives"] == before["collectives"] + 1
    assert after["bytes"] - before["bytes"] == before["bytes"]
    assert multihost.RECORD is None
    multihost.reset_comm()


def test_all_to_all_takes_the_single_tensor_collective(monkeypatch):
    """gloo has no list all_to_all in every torch release (the card's
    2.11 raises "Backend gloo does not support alltoall"): the exchange
    goes through ``all_to_all_single``, which the fake group alone
    offers, and is priced as the reference's all_to_all."""
    monkeypatch.setattr(multihost, "_dist", lambda: _FakeGroup(D))
    blocks = [torch.full((2, 3), float(q)) for q in range(D)]
    total, breakdown = comm_audit.collective_bytes(
        lambda: multihost.all_to_all(blocks), axis_size=D)
    out = D * 2 * 3 * 4
    assert (total, breakdown) == (2 * (D - 1) * out // D,
                                  {"all_to_all": 2 * (D - 1) * out // D})
    got = multihost.all_to_all(blocks)
    assert [torch.equal(a, b) for a, b in zip(got, blocks)] == [True] * D
