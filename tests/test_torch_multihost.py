"""Multi-process training and serving (``tpu_als_torch/parallel/
multihost.py``) against ``tpu_als``.

In process, reference and port side by side:

- ``local_positions``, ``local_rating_mask``, ``_triples_digest``
  (order-independent) and ``_split_signatures_duplicated`` (pairwise)
  give the reference's answers;
- the ``positions=`` builds of ``shard_csr``, ``shard_csr_grid`` and
  ``build_a2a`` equal the full build's slice and the reference's
  positions build, array for array (exact: both are numpy);
- a sharded checkpoint loads both ways: the reference's
  ``save_checkpoint_sharded`` on a one-process 4-device CPU mesh into
  the port's ``load_factors``, and the port's into the reference's
  (exact);
- the one-process answers: ``init_distributed`` and ``rejoin`` are
  no-ops (the ``multihost.init`` fault point retried inside), the unions
  are ``np.unique``, ``ALS(dataMode='per_host')`` fits as 'replicated'.

Spawned: two port processes over gloo on the CPU, 2 logical CPU shards
each (``tests/_torch_multihost_worker.py``, run ONCE for every case
below by a module-scoped fixture and joined by a ``file://`` store in
its directory, and ``train --devices 0 --per-host-data`` twice through
env:// against a store this process serves, all with ``jax`` and
``tpu_als`` blocked; no port is picked and released, so no other group
on the host can take the rendezvous):

- ``train_multihost`` with 'all_gather', 'ring', 'all_to_all' (and
  'all_gather_chunked') on replicated and per-host data, from one
  injected init, against the reference's one-process 4-device mesh fit
  (``tpu_als.parallel.trainer.train_sharded``, JAX on the CPU) at MH_TOL;
  'all_gather' also bitwise against the port's one-process 4-shard fit
  on the triples in the exchanged order (YᵀY from the gathered table);
- ``ALS(mesh=, dataMode='per_host').fit`` against the one-process
  4-shard fit (bitwise for 'all_gather', MH_TOL for the others: they sum
  the processes' partial YᵀY);
- sharded and replicated checkpoint resume equal to the uninterrupted
  fit (exact), and the two-process sharded checkpoint read by both
  packages' ``load_factors``;
- multi-process serve ('all_gather', 'ring') against
  ``chunked_topk_scores`` (scores within SERVE_TOL, every id earning
  its score);
- K7 across processes (``solve_backend='gather_fused_ring'`` under
  'ring', its plain version: the peers' shards gathered) on replicated
  and per-host data, bitwise the port's one-process 4-shard fused-ring
  fit and within MH_TOL of the reference's 4-device one (interpret
  mode); K8 across processes (``'merge_ring'``: the candidate sets
  gathered, each process's rows merged) at k = 5 and k = 130 ('ring'
  above 128), bitwise the one-process plain K8 over the same shards;
  the payloads both declare to ``comm_audit.remote_dma_bytes``;
- the gate (a divergent kernel knob, a divergent strategy, 'auto'), NaN
  ratings, a duplicated split, disagreeing dims, replicated data that
  differ, shard counts that differ and the recommend surfaces each
  raise on BOTH processes, and the group stays usable; a degenerate
  all_to_all plan trains as 'all_gather';
- the CLI's per-host fit (``{proc}`` files, and one ``stream:`` file
  byte-split between the processes with its vocabularies and split
  claims agreed collectively) equals the one-process ``train --devices
  2`` model on the union of the splits (exact);
- only process 0 writes a shared run directory, whose manifest records
  ``process_count`` 2.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tpu_als.core.als import AlsConfig as JConfig
from tpu_als.core.ratings import IdMap as JIdMap
from tpu_als.io.checkpoint import load_factors as jload
from tpu_als.ops.topk import chunked_topk_scores as j_topk
from tpu_als.parallel import a2a as ja2a
from tpu_als.parallel import comm as jcomm
from tpu_als.parallel import data as jdata
from tpu_als.parallel import multihost as jmh
from tpu_als.parallel import trainer as jtrainer
from tpu_als.parallel.mesh import make_mesh as j_make_mesh
from tpu_als_torch.api.estimator import ALS, ALSModel
from tpu_als_torch.convert import entity_rows
from tpu_als_torch.core.ratings import IdMap
from tpu_als_torch.io.checkpoint import load_factors
from tpu_als_torch.ops import cuda_topk
from tpu_als_torch.ops.cuda_topk import topk_merge_ring_plain
from tpu_als_torch.ops.topk import chunked_topk_scores
from tpu_als_torch.parallel import a2a, comm, data, multihost, trainer
from tpu_als_torch.parallel.mesh import make_mesh
from tpu_als_torch.perf.roofline import serve_merge_remote_bytes
from tpu_als_torch.resilience import faults
from tpu_als_torch.resilience.retry import RetryPolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_multihost_worker.py")
# two f32 iterations, each side summing the same terms in its own order
# (observed: 1.2e-6 at most)
MH_TOL = 2e-5
# K5's plain version against the reference's scan: a few ulp of scores
SERVE_TOL = 2e-6
SPAWN_TIMEOUT_S = 240

_spec = importlib.util.spec_from_file_location("_torch_multihost_worker",
                                               WORKER)
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng_ratings(seed=0, nu=60, ni=40, nnz=900):
    rng = np.random.default_rng(seed)
    return (nu, ni, rng.integers(0, nu, nnz), rng.integers(0, ni, nnz),
            rng.normal(size=nnz).astype(np.float32))


def _parts(pkg, u, i, nu, ni, D):
    return (pkg.partition_balanced(np.bincount(u, minlength=nu), D),
            pkg.partition_balanced(np.bincount(i, minlength=ni), D))


def _same_buckets(a, b, positions=None):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in ("rows", "cols", "vals", "mask"):
            want = getattr(y, f)
            if positions is not None:
                want = want[positions]
            np.testing.assert_array_equal(getattr(x, f), want)


# -- in process -------------------------------------------------------------

def test_local_positions_and_rating_mask_match_the_reference():
    mesh = make_mesh(devices=["cpu"] * 8)
    assert multihost.local_positions(mesh) == list(range(8))
    assert mesh.global_size == 8 and mesh.process_count == 1
    nu, ni, u, i, r = _rng_ratings(1, nu=40, nnz=500)
    part = data.partition_balanced(np.bincount(u, minlength=nu), 8)
    jpart = jdata.partition_balanced(np.bincount(u, minlength=nu), 8)
    assert multihost.local_rating_mask(part, u, mesh).all()
    for positions in (range(0, 4), range(4, 8), [2, 5]):
        np.testing.assert_array_equal(
            multihost.local_rating_mask(part, u, positions=positions),
            jmh.local_rating_mask(jpart, u, positions=positions))
    a = multihost.local_rating_mask(part, u, positions=range(4))
    b = multihost.local_rating_mask(part, u, positions=range(4, 8))
    assert (a ^ b).all()
    with pytest.raises(ValueError, match="mesh or positions"):
        multihost.local_rating_mask(part, u)


@pytest.mark.parametrize("positions", [[0, 1, 2, 3], [4, 5, 6, 7], [2, 5]])
def test_shard_csr_positions_build(positions):
    nu, ni, u, i, r = _rng_ratings()
    up, ip = _parts(data, u, i, nu, ni, 8)
    jup, jip = _parts(jdata, u, i, nu, ni, 8)
    ucounts = np.bincount(u, minlength=nu)
    full = data.shard_csr(up, ip, u, i, r, min_width=4)
    msk = multihost.local_rating_mask(up, u, positions=positions)
    got = data.shard_csr(up, ip, u[msk], i[msk], r[msk], min_width=4,
                         positions=positions, row_counts=ucounts)
    ref = jdata.shard_csr(jup, jip, u[msk], i[msk], r[msk], min_width=4,
                          positions=positions, row_counts=ucounts)
    assert got.positions == tuple(positions) == ref.positions
    _same_buckets(got.buckets, full.buckets, positions)
    _same_buckets(got.buckets, ref.buckets)


def test_positions_without_counts_rejected():
    nu, ni, u, i, r = _rng_ratings(2, nu=10, ni=8, nnz=50)
    up, ip = _parts(data, u, i, nu, ni, 2)
    with pytest.raises(ValueError, match="row_counts"):
        data.shard_csr(up, ip, u, i, r, positions=[0])


@pytest.mark.parametrize("positions", [[0, 1], [2, 3], [1, 3]])
def test_shard_csr_grid_positions_build(positions):
    nu, ni, u, i, r = _rng_ratings(3)
    up, ip = _parts(data, u, i, nu, ni, 4)
    jup, jip = _parts(jdata, u, i, nu, ni, 4)
    full = comm.shard_csr_grid(up, ip, u, i, r, min_width=4)
    got = comm.shard_csr_grid(up, ip, u, i, r, min_width=4,
                              positions=positions)
    ref = jcomm.shard_csr_grid(jup, jip, u, i, r, min_width=4,
                               positions=positions)
    assert got.positions == tuple(positions) == ref.positions
    _same_buckets(got.buckets, full.buckets, positions)
    _same_buckets(got.buckets, ref.buckets)


@pytest.mark.parametrize("positions", [[0, 1], [2, 3], [3, 0]])
def test_build_a2a_positions_build(positions):
    u, i, r = W.ratings()
    up, ip = _parts(data, u, i, W.NU, W.NI, 4)
    jup, jip = _parts(jdata, u, i, W.NU, W.NI, 4)
    full = a2a.build_a2a(up, ip, u, i, r, min_width=4)
    got = a2a.build_a2a(up, ip, u, i, r, min_width=4, positions=positions)
    ref = ja2a.build_a2a(jup, jip, u, i, r, min_width=4,
                         positions=positions)
    assert not got.degenerate
    assert got.positions == tuple(positions) == ref.positions
    assert got.request_budget == ref.request_budget == full.request_budget
    np.testing.assert_array_equal(got.send_idx, full.send_idx[positions])
    np.testing.assert_array_equal(got.send_idx, ref.send_idx)
    _same_buckets(got.buckets, full.buckets, positions)
    _same_buckets(got.buckets, ref.buckets)


def test_split_signatures_duplicated_is_pairwise():
    for sig in ([[10, 1], [10, 2], [10, 3]], [[10, 1], [12, 2], [10, 1]],
                [[0, 7], [0, 7], [5, 1]], [[3, 9], [3, 9]],
                [[3, 9], [0, 0], [0, 0]]):
        assert multihost._split_signatures_duplicated(np.array(sig)) \
            == jmh._split_signatures_duplicated(np.array(sig))
    assert multihost._split_signatures_duplicated(
        np.array([[10, 1], [12, 2], [10, 1]]))
    assert not multihost._split_signatures_duplicated(
        np.array([[0, 7], [0, 7], [5, 1]]))


def test_triples_digest_is_order_independent():
    u, i, r = W.ratings()
    d = multihost._triples_digest(u, i, r)
    assert d == jmh._triples_digest(u, i, r)
    perm = np.random.default_rng(0).permutation(len(u))
    assert multihost._triples_digest(u[perm], i[perm], r[perm]) == d
    r2 = r.copy()
    r2[3] += 1
    assert multihost._triples_digest(u, i, r2) != d


def _slot_tables(seed, up, ip, rank=5):
    rng = np.random.default_rng(seed)
    Us = rng.normal(size=(up.padded_rows, rank)).astype(np.float32)
    Vs = rng.normal(size=(ip.padded_rows, rank)).astype(np.float32)
    return Us, Vs


def test_sharded_checkpoint_from_the_reference_loads_in_the_port(tmp_path):
    nu, ni, u, i, r = _rng_ratings(4)
    jup, jip = _parts(jdata, u, i, nu, ni, 4)
    Us, Vs = _slot_tables(5, jup, jip)
    jmesh = j_make_mesh(4)
    sh = NamedSharding(jmesh, P("d"))
    uids, iids = np.arange(nu) * 3 + 1, np.arange(ni) * 7 + 2
    path = str(tmp_path / "ck")
    jmh.save_checkpoint_sharded(
        path, jax.device_put(Us, sh), jax.device_put(Vs, sh), jup, jip,
        JIdMap(ids=uids), JIdMap(ids=iids), jmesh,
        params={"rank": 5}, iteration=3)
    got = load_factors(path)
    ref = jload(path)
    assert got[0]["sharded"] and got[0]["format_version"] == 2
    assert got[0]["iteration"] == 3
    for g, j in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(g, j)
    np.testing.assert_array_equal(got[2], Us[jup.slot])
    np.testing.assert_array_equal(got[4], Vs[jip.slot])


def test_sharded_checkpoint_from_the_port_loads_in_the_reference(tmp_path):
    nu, ni, u, i, r = _rng_ratings(6)
    up, ip = _parts(data, u, i, nu, ni, 4)
    Us, Vs = _slot_tables(7, up, ip)
    uids, iids = np.arange(nu) + 100, np.arange(ni) + 5
    path = str(tmp_path / "ck")
    os.makedirs(path + ".tmp")  # a crashed attempt's leftovers go first
    multihost.save_checkpoint_sharded(
        path, torch.from_numpy(Us), torch.from_numpy(Vs), up, ip,
        IdMap(ids=uids), IdMap(ids=iids), make_mesh(devices=["cpu"] * 4),
        params={"rank": 5}, iteration=2)
    assert not os.path.exists(path + ".tmp")
    ref = jload(path)
    got = load_factors(path)
    assert ref[0]["sharded"] and ref[0]["iteration"] == 2
    np.testing.assert_array_equal(ref[1], uids)
    np.testing.assert_array_equal(ref[2], Us[up.slot])
    np.testing.assert_array_equal(ref[4], Vs[ip.slot])
    for g, j in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(g, j)


def test_one_process_answers(monkeypatch):
    # the reference's launcher variables are not read (torch's are)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.init_distributed() == (0, 1)
    assert multihost.rejoin() == (0, 1)
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert not torch.distributed.is_initialized()
    ids = np.array([5, 3, 5, 9, 1])
    np.testing.assert_array_equal(multihost.global_id_union(ids),
                                  jmh.global_id_union(ids))
    labels = np.array([b"b", b"a", b"cc", b"a"])
    np.testing.assert_array_equal(multihost.global_vocab_union(labels),
                                  jmh.global_vocab_union(labels))
    x = torch.arange(6.0).reshape(3, 2)
    assert multihost.all_gather(x) is x
    assert multihost.process_allgather(np.array([4])).tolist() == [[4]]
    # the fault point fires inside the retried rendezvous
    faults.install("multihost.init=raise@once")
    try:
        assert multihost.init_distributed(retry_policy=RetryPolicy(
            max_attempts=3, base_delay=0.0, retry_on=(OSError,))) == (0, 1)
        assert faults.hits("multihost.init") == (2, 1)  # (hits, fired)
    finally:
        faults.clear()


def test_per_host_and_sharded_checkpoint_knobs_fit_in_one_process(tmp_path):
    """Once refused (``NotImplementedError``): in one process
    'per_host' is the one split's fit, and a sharded checkpoint of a
    one-process mesh loads as the fit's factors."""
    u, i, r = W.ratings()
    fr = W.frame(u, i, r)
    mesh = make_mesh(devices=["cpu"] * 4)
    a = W.als(mesh, dataMode="per_host").fit(fr)
    b = W.als(mesh).fit(fr)
    np.testing.assert_array_equal(a._U.numpy(), b._U.numpy())
    d = str(tmp_path / "ck")
    c = W.als(mesh, checkpointDir=d, checkpointInterval=2,
              checkpointSharded=True).fit(fr)
    m, cu, cU, ci, cV = load_factors(os.path.join(d, "als_checkpoint"))
    assert m["iteration"] == 2
    np.testing.assert_array_equal(cU, c._U.numpy())
    np.testing.assert_array_equal(cV, c._V.numpy())
    with pytest.raises(ValueError, match="dataMode"):
        ALS(dataMode="sharded")


def test_multiprocess_knobs_read_the_bank_and_never_tune(monkeypatch):
    """With the autotune gate off nothing is read (the module constants);
    on, the bank is read under the fit's own shape class and the mesh's
    global size, with ``tune=False``."""
    from tpu_als_torch import plan
    from tpu_als_torch.api import fitting

    u, i, r = W.ratings()
    est = W.als(make_mesh(devices=["cpu"] * 4))
    cfg = W.cfg()
    monkeypatch.delenv(plan.AUTOTUNE_ENV, raising=False)
    assert fitting.multiprocess_knobs(est, cfg, u, i) is None
    seen = {}

    def banked(**kw):
        seen.update(kw)
        return {"split_width": 2048, "scratch_elems": 1 << 24}

    monkeypatch.setenv(plan.AUTOTUNE_ENV, "1")
    monkeypatch.setattr(plan, "resolve_kernel_config", banked)
    assert fitting.multiprocess_knobs(est, cfg, u, i) == {
        "split_width": 2048, "scratch_elems": 1 << 24}
    assert seen["tune"] is False and seen["mesh_shape"] == (4,)
    assert seen["shape_class"] == plan.shape_class(
        len(np.unique(u)), len(np.unique(i)), len(u))


# -- spawned: two port processes over gloo ---------------------------------

def _spawn(argv, env_extra=None, timeout=SPAWN_TIMEOUT_S, store=None):
    """Two processes of ``argv`` with torch's launcher variables
    ``WORLD_SIZE`` and ``RANK``; their outputs.  Both are killed on any
    failure or timeout.

    The rendezvous cannot collide with another group's on the host:
    ``argv`` carries a ``file://`` init method in the test's own
    directory (``multihost.file_init_method``), or, with ``store`` (a
    ``torch.distributed.TCPStore`` this process serves, bound and held
    on a port of its own), the children join through env:// as
    ``torchrun`` starts them: ``MASTER_ADDR``/``MASTER_PORT`` name that
    store and ``TORCHELASTIC_USE_AGENT_STORE`` makes every rank its
    client."""
    procs = []
    for pid in range(2):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(WORLD_SIZE="2", RANK=str(pid), LOCAL_RANK=str(pid),
                   OMP_NUM_THREADS="1", **(env_extra or {}))
        if store is not None:
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(store.port),
                       TORCHELASTIC_USE_AGENT_STORE="True")
        procs.append(subprocess.Popen(
            argv, env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=timeout)
            outs.append(text)
            assert p.returncode == 0, text[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _agent_store():
    """A fresh rendezvous store served here, on a port bound by the
    store itself and held until the group is done (torchrun's agent
    store)."""
    return torch.distributed.TCPStore("127.0.0.1", 0, is_master=True,
                                      wait_for_workers=False)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mh"))
    logs = _spawn([sys.executable, WORKER, out,
                   multihost.file_init_method(out)])
    assert all("ok" in t for t in logs)
    with open(os.path.join(out, "result.json")) as f:
        meta = json.load(f)
    return {"dir": out, "res": dict(np.load(os.path.join(out,
                                                         "result.npz"))),
            "errors": meta["errors"], "comm": meta["comm"]}


_REF = {}


def _reference_fit(strategy):
    """The reference's one-process 4-device mesh fit from the injected
    init (entity space), once per strategy ('gather_fused_ring': the
    ring with its fused kernel, in interpret mode)."""
    if strategy not in _REF:
        u, i, r = W.ratings()
        up, ip = _parts(jdata, u, i, W.NU, W.NI, 4)
        rc = None
        backend = "auto"
        if strategy == "gather_fused_ring":
            strategy, backend = "ring", strategy
        if strategy == "ring":
            us = jcomm.shard_csr_grid(up, ip, u, i, r, min_width=4)
            is_ = jcomm.shard_csr_grid(ip, up, i, u, r, min_width=4)
            rc = (jtrainer.stacked_counts(up, u, r, positive_only=True),
                  jtrainer.stacked_counts(ip, i, r, positive_only=True))
        elif strategy == "all_to_all":
            us = ja2a.build_a2a(up, ip, u, i, r, min_width=4)
            is_ = ja2a.build_a2a(ip, up, i, u, r, min_width=4)
        else:
            us = jdata.shard_csr(up, ip, u, i, r, min_width=4)
            is_ = jdata.shard_csr(ip, up, i, u, r, min_width=4)
        U, V = jtrainer.train_sharded(
            j_make_mesh(4), up, ip, us, is_, JConfig(
                rank=W.RANK, max_iter=2, reg_param=0.05,
                implicit_prefs=True, alpha=3.0, seed=0,
                solve_backend=backend),
            strategy=strategy, ring_counts=rc, init=W.init())
        key = strategy if backend == "auto" else backend
        _REF[key] = (np.asarray(U)[up.slot], np.asarray(V)[ip.slot])
        strategy = key
    return _REF[strategy]


def _exchanged_frame():
    """The triples in the order the per-host exchange leaves them:
    process 0's split, then process 1's."""
    u, i, r = W.ratings()
    order = np.concatenate([np.flatnonzero(np.arange(W.NNZ) % 2 == p)
                            for p in range(2)])
    return u[order], i[order], r[order]


@pytest.mark.parametrize("strategy,mode", [
    ("all_gather", "replicated"), ("all_gather", "per_host"),
    ("ring", "replicated"), ("ring", "per_host"),
    ("all_to_all", "replicated"), ("all_to_all", "per_host"),
    ("all_gather_chunked", "replicated")])
def test_two_process_fit_matches_the_reference(run, strategy, mode):
    U, V = (run["res"][f"{strategy}_{mode}_{s}"] for s in "UV")
    JU, JV = _reference_fit(strategy)
    assert np.isfinite(U).all() and np.isfinite(V).all()
    np.testing.assert_allclose(U, JU, atol=MH_TOL, rtol=MH_TOL)
    np.testing.assert_allclose(V, JV, atol=MH_TOL, rtol=MH_TOL)


@pytest.mark.parametrize("mode", ["replicated", "per_host"])
def test_two_process_all_gather_is_the_one_process_fit_bitwise(run, mode):
    u, i, r = W.ratings() if mode == "replicated" else _exchanged_frame()
    up, ip = _parts(data, u, i, W.NU, W.NI, 4)
    cfg = W.cfg()
    Us, Vs = trainer.train_sharded(
        make_mesh(devices=["cpu"] * 4), up, ip,
        data.shard_csr(up, ip, u, i, r, min_width=4),
        data.shard_csr(ip, up, i, u, r, min_width=4), cfg, init=W.init())
    np.testing.assert_array_equal(run["res"][f"all_gather_{mode}_U"],
                                  entity_rows(up, Us).numpy())
    np.testing.assert_array_equal(run["res"][f"all_gather_{mode}_V"],
                                  entity_rows(ip, Vs).numpy())


def _ring_grids(u, i, r, S=4):
    up, ip = _parts(data, u, i, W.NU, W.NI, S)
    return (up, ip, comm.shard_csr_grid(up, ip, u, i, r, min_width=4),
            comm.shard_csr_grid(ip, up, i, u, r, min_width=4))


@pytest.mark.parametrize("mode", ["replicated", "per_host"])
def test_two_process_fused_ring_is_the_one_process_fit_bitwise(run, mode):
    """K7 across processes (its plain version on the CPU, the peers'
    shards gathered; each process's grid rolled to its first position)
    gives the port's one-process 4-shard fused-ring fit bit for bit, on
    the triples in the order the processes hold them."""
    u, i, r = W.ratings() if mode == "replicated" else _exchanged_frame()
    up, ip, ug, ig = _ring_grids(u, i, r)
    rc = (trainer.stacked_counts(up, u, r, positive_only=True),
          trainer.stacked_counts(ip, i, r, positive_only=True))
    Us, Vs = trainer.train_sharded(
        make_mesh(devices=["cpu"] * 4), up, ip, ug, ig,
        W.cfg(solve_backend="gather_fused_ring"), strategy="ring",
        ring_counts=rc, init=W.init())
    np.testing.assert_array_equal(run["res"][f"fused_ring_{mode}_U"],
                                  entity_rows(up, Us).numpy())
    np.testing.assert_array_equal(run["res"][f"fused_ring_{mode}_V"],
                                  entity_rows(ip, Vs).numpy())


@pytest.mark.parametrize("mode", ["replicated", "per_host"])
def test_two_process_fused_ring_matches_the_reference(run, mode):
    """Against the reference's one-process 4-device ``gather_fused_ring``
    fit (its Pallas kernel in interpret mode), from the same init."""
    U, V = (run["res"][f"fused_ring_{mode}_{s}"] for s in "UV")
    JU, JV = _reference_fit("gather_fused_ring")
    assert np.isfinite(U).all() and np.isfinite(V).all()
    np.testing.assert_allclose(U, JU, atol=MH_TOL, rtol=MH_TOL)
    np.testing.assert_allclose(V, JV, atol=MH_TOL, rtol=MH_TOL)


def test_two_process_fused_ring_declares_the_ring_payload(run):
    """Each process's K7 calls declare, for ``comm_audit.
    remote_dma_bytes``, the reference schedule's payload: the two
    iterations' ``comm_bytes_per_iter('gather_fused_ring')`` without
    the YᵀY reduction, which is a collective."""
    u, i, r = W.ratings()
    up, ip, ug, ig = _ring_grids(u, i, r)
    model = trainer.comm_bytes_per_iter(
        "gather_fused_ring", up, ip, W.RANK, user_container=ug,
        item_container=ig, implicit=False)
    assert model > 0
    for mode in ("replicated", "per_host"):
        assert run["res"][f"fused_ring_{mode}_declared"] == 2 * model


@pytest.mark.parametrize("k", [5, 130])
def test_two_process_merge_ring_serve(run, k):
    """K8 across processes (its plain halves on the CPU: each process's
    sets gathered, its rows merged): each process's rows are the
    one-process plain K8's over the same 4 shards bit for bit, and every
    id earns its score against the reference's scan.  Above k = 128 it
    runs 'ring' and labels the latency so, as in one process."""
    res = run["res"]
    U = res["serve_U"]
    V = res["serve_V"] if k == 5 else res["serve_k130_V"]
    rows = res[f"merge_ring_k{k}_rows"]
    assert rows[0].tolist() == [0, rows[0][1]]
    assert rows[1][0] == rows[0][1] and rows[1].sum() == len(U)
    s, ix = res[f"merge_ring_k{k}_scores"], res[f"merge_ring_k{k}_ids"]
    S, r = 4, U.shape[1]
    ni_loc = -(-len(V) // S)
    Vp = np.zeros((S * ni_loc, r), np.float32)
    Vp[:len(V)] = V
    valid = np.arange(S * ni_loc) < len(V)
    want_s, want_i = topk_merge_ring_plain(
        torch.from_numpy(U), torch.from_numpy(Vp).reshape(S, ni_loc, r),
        torch.from_numpy(valid).reshape(S, ni_loc), k, 1)
    np.testing.assert_array_equal(s, want_s.numpy())
    np.testing.assert_array_equal(ix, want_i.numpy())
    js, _ = j_topk(U, V, np.ones(len(V), bool), k)
    np.testing.assert_allclose(s, np.asarray(js), atol=SERVE_TOL, rtol=0)
    earned = np.einsum("nr,nkr->nk", U, V[ix])
    np.testing.assert_allclose(earned, s, atol=SERVE_TOL, rtol=0)
    assert res[f"merge_ring_k{k}_as_ring"] == (k > 128)


def test_two_process_merge_ring_declares_the_candidate_sets(run):
    """K8's scan-to-sets declares the reference merge ring's payload, one
    packed candidate set a hop per user tile
    (``serve_merge_remote_bytes``); above k = 128 'ring' runs and no K8
    declares anything."""
    n = len(run["res"]["serve_U"])
    tile_u = min(cuda_topk.RING_TILE_U, -(-n // 8) * 8)
    want = serve_merge_remote_bytes(-(-n // tile_u), 4, tile_u)
    assert want > 0
    assert run["res"]["merge_ring_k5_declared"] == want
    assert run["res"]["merge_ring_k130_declared"] == 0


@pytest.mark.parametrize("strategy", ["all_gather", "ring", "all_to_all"])
def test_two_process_per_host_estimator(run, strategy):
    m = W.als(make_mesh(devices=["cpu"] * 4), gatherStrategy=strategy) \
        .fit(W.frame(*_exchanged_frame()))
    res = run["res"]
    np.testing.assert_array_equal(res[f"est_{strategy}_uids"],
                                  m._user_map.ids)
    for got, want in ((res[f"est_{strategy}_U"], m._U.numpy()),
                      (res[f"est_{strategy}_V"], m._V.numpy())):
        if strategy == "all_gather":
            np.testing.assert_array_equal(got, want)
        else:  # the processes' partial YᵀY summed
            np.testing.assert_allclose(got, want, atol=MH_TOL, rtol=MH_TOL)


@pytest.mark.parametrize("kind", ["sharded", "replicated"])
def test_two_process_resume_reproduces_the_uninterrupted_fit(run, kind):
    res = run["res"]
    np.testing.assert_array_equal(res[f"resume_{kind}_U"],
                                  res["resume_full_U"])
    np.testing.assert_array_equal(res[f"resume_{kind}_V"],
                                  res["resume_full_V"])


def test_two_process_sharded_checkpoint_loads_in_both_packages(run):
    path = os.path.join(run["dir"], "ckpt_sharded", "als_checkpoint")
    got, ref = load_factors(path), jload(path)
    assert got[0]["sharded"] and got[0]["n_shards"] == 4
    assert got[0]["iteration"] == 2
    for g, j in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(g, j)
    assert os.path.exists(os.path.join(path, "item_shard_00003.npz"))


@pytest.mark.parametrize("strategy", ["all_gather", "ring"])
def test_two_process_serve(run, strategy):
    res = run["res"]
    U, V = res["serve_U"], res["serve_V"]
    rows = res[f"serve_{strategy}_rows"]
    # the processes' rows tile the queries in order
    assert rows[0].tolist() == [0, rows[0][1]]
    assert rows[1][0] == rows[0][1] and rows[1].sum() == len(U)
    s, ix = res[f"serve_{strategy}_scores"], res[f"serve_{strategy}_ids"]
    want_s, _ = chunked_topk_scores(torch.from_numpy(U), torch.from_numpy(V),
                                    torch.ones(len(V), dtype=torch.bool), 5)
    js, _ = j_topk(U, V, np.ones(len(V), bool), 5)
    np.testing.assert_allclose(s, want_s.numpy(), atol=SERVE_TOL, rtol=0)
    np.testing.assert_allclose(s, np.asarray(js), atol=SERVE_TOL, rtol=0)
    earned = np.einsum("nr,nkr->nk", U, V[ix])
    np.testing.assert_allclose(earned, s, atol=SERVE_TOL, rtol=0)


@pytest.mark.parametrize("strategy", ["all_gather", "ring"])
def test_two_process_serve_above_k_128_keeps_the_strategy(run, strategy):
    """k = 130 across processes: the strategy asked runs and labels the
    latency (only 'merge_ring' is swapped for 'ring', as the reference's
    ``topk_sharded`` does), and the answer is the scan's."""
    res = run["res"]
    U, V = res["serve_U"], res["serve_k130_V"]
    assert res[f"serve_k130_{strategy}_recorded"] == 1
    s, ix = (res[f"serve_k130_{strategy}_{x}"] for x in ("scores", "ids"))
    want_s, _ = chunked_topk_scores(torch.from_numpy(U), torch.from_numpy(V),
                                    torch.ones(len(V), dtype=torch.bool), 130)
    np.testing.assert_allclose(s, want_s.numpy(), atol=SERVE_TOL, rtol=0)
    earned = np.einsum("nr,nkr->nk", U, V[ix])
    np.testing.assert_allclose(earned, s, atol=SERVE_TOL, rtol=0)


@pytest.mark.parametrize("case,kind,match", [
    ("gate_knob", "ValueError", "processes disagree"),
    ("gate_strategy", "ValueError", "processes disagree"),
    ("gate_auto", "ValueError", "not supported in multi-process"),
    ("nan", "ValueError", "non-finite"),
    ("duplicated", "ValueError", "IDENTICAL"),
    ("recommend", "ValueError", "single-process meshes"),
    ("mesh_counts", "ValueError", "different shard counts"),
    ("dims", "ValueError", "disagree on (num_users"),
    ("replicated_differ", "ValueError", "rating data differ")])
def test_two_process_refusals_raise_on_every_process(run, case, kind, match):
    for per_process in run["errors"]:
        msg = per_process[case]
        assert msg is not None and msg.startswith(kind + ":"), msg
        assert match in msg, msg


def test_two_process_degenerate_all_to_all_falls_back(run):
    """A degenerate plan (dense data) trains as 'all_gather', as the
    reference's ``train_multihost`` does (``replicated=True`` on the
    exchanged triples)."""
    np.testing.assert_array_equal(run["res"]["dense_all_to_all_U"],
                                  run["res"]["dense_all_gather_U"])


def test_two_process_run_directory_is_written_by_process_0(run):
    assert [e["_obs_wrote"] for e in run["errors"]] == [True, False]
    with open(os.path.join(run["dir"], "obs", "run_manifest.json")) as f:
        assert json.load(f)["process_count"] == 2


def test_two_process_collectives_are_counted(run):
    for name, c in run["comm"].items():
        assert c["collectives"] > 0 and c["bytes"] > 0, name
        assert c["staged_bytes"] == 0, name  # CPU tensors go to gloo as is
    # the per-host exchange adds the gathered splits to what moves
    assert run["comm"]["all_gather_per_host"]["bytes"] \
        > run["comm"]["all_gather_replicated"]["bytes"]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("mhcli")
    u, i, r = W.ratings()
    r = np.round(r * 2, 1).astype(np.float32)  # exact in the CSV
    for pid in range(2):
        mine = np.arange(W.NNZ) % 2 == pid
        with open(d / f"part-{pid}.csv", "w") as f:
            f.write("userId,movieId,rating,timestamp\n")
            for a, b, c in zip(u[mine], i[mine], r[mine]):
                f.write(f"{a},{b},{c},0\n")
    with open(d / "all.csv", "w") as f:
        f.write("userId,movieId,rating,timestamp\n")
        for pid in range(2):
            f.writelines(open(d / f"part-{pid}.csv").readlines()[1:])
    args = ["train", "--rank", "4", "--max-iter", "3", "--reg-param",
            "0.05", "--holdout", "0", "--seed", "0", "--device", "cpu"]
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['tpu_als'] = None; "
            "from tpu_als_torch.cli import main; main(sys.argv[1:]); "
            "bad = [m for m, v in sys.modules.items() if v is not None and "
            "(m == 'jax' or m.startswith(('jax.', 'tpu_als.')))]; "
            "assert not bad, bad; print('cli ok')")
    logs = _spawn([sys.executable, "-c", code, *args, "--data",
                   f"csv:{d}/part-{{proc}}.csv", "--per-host-data",
                   "--devices", "0", "--output", str(d / "mp")],
                  store=_agent_store())
    # one shared string-id stream file, byte-split between the processes
    with open(d / "all.stream.csv", "w") as f:
        f.write("user_id,item_id,rating,timestamp\n")
        for a, b, c in zip(u, i, r):
            f.write(f"u{a},i{b},{c},0\n")
    logs += _spawn([sys.executable, "-c", code, *args, "--data",
                    f"stream:{d}/all.stream.csv", "--per-host-data",
                    "--devices", "0", "--output", str(d / "mps")],
                   store=_agent_store())
    return d, args, logs


def test_cli_per_host_data_equals_the_one_process_fit(cli_run):
    from tpu_als_torch.cli import main

    d, args, logs = cli_run
    assert all("cli ok" in t for t in logs)
    assert "per-host load" in logs[0] and "over 2 positions" in logs[0]
    main(args + ["--data", f"csv:{d}/all.csv", "--devices", "2",
                 "--output", str(d / "one")])
    mp = ALSModel.load(str(d / "mp"), device="cpu")
    one = ALSModel.load(str(d / "one"), device="cpu")
    np.testing.assert_array_equal(mp._user_map.ids, one._user_map.ids)
    np.testing.assert_array_equal(mp._U.numpy(), one._U.numpy())
    np.testing.assert_array_equal(mp._V.numpy(), one._V.numpy())


def test_cli_stream_split_between_processes(cli_run):
    """``stream:`` with ``--per-host-data``: each process reads its byte
    range, the vocabularies and the split claims agreed through
    ``global_vocab_union``; the model equals the one-process fit of the
    whole file (the exchange leaves the rows in file order)."""
    from tpu_als_torch.cli import main

    d, args, logs = cli_run
    assert all("cli ok" in t for t in logs[2:])
    main(args + ["--data", f"stream:{d}/all.stream.csv", "--devices", "2",
                 "--output", str(d / "ones")])
    mp = ALSModel.load(str(d / "mps"), device="cpu")
    one = ALSModel.load(str(d / "ones"), device="cpu")
    for side in ("users", "items"):
        np.testing.assert_array_equal(
            np.load(d / "mps" / "stream_labels.npz")[side],
            np.load(d / "ones" / "stream_labels.npz")[side])
    np.testing.assert_array_equal(mp._U.numpy(), one._U.numpy())
    np.testing.assert_array_equal(mp._V.numpy(), one._V.numpy())


def test_cli_per_host_data_is_multi_process_only(tmp_path):
    from tpu_als_torch.cli import main

    with pytest.raises(SystemExit, match="multi-process only"):
        main(["train", "--data", "synthetic:30x20x200", "--per-host-data",
              "--devices", "0", "--device", "cpu"])
