"""Worker of ``tests/test_torch_multihost.py``: one of two port processes
joined over gloo on the CPU (``torch.distributed``), each holding 2
logical CPU shards of a 4-position mesh.

Run as ``python tests/_torch_multihost_worker.py OUT INIT`` with torch's
launcher variables ``WORLD_SIZE=2`` and ``RANK`` set by the parent and
INIT a ``file://`` rendezvous in the parent's directory
(``multihost.file_init_method``).  Every case of the group runs here in
turn, in both processes, and process 0 writes what the parent compares:
``OUT/result.npz`` (factors, top-k rows) and ``OUT/result.json`` (the
errors each expected failure raised, per process).  ``jax`` and
``tpu_als`` are blocked: the port must run without them.
"""

import json
import os
import sys
import warnings

import numpy as np

# the fit data: sparse enough that the 4-position all_to_all plan is not
# degenerate (each (destination, source) pair references fewer rows than
# a shard holds)
NU, NI, NNZ = 400, 300, 1600
RANK = 6


def ratings():
    rng = np.random.default_rng(7)
    u = rng.integers(0, NU, NNZ)
    i = rng.integers(0, NI, NNZ)
    r = (np.abs(rng.normal(size=NNZ)) + 0.1).astype(np.float32)
    return u, i, r


def init():
    g = np.random.default_rng(3)
    U0 = g.normal(size=(NU, RANK)).astype(np.float32)
    V0 = g.normal(size=(NI, RANK)).astype(np.float32)
    return U0 / np.linalg.norm(U0, axis=1, keepdims=True), \
        V0 / np.linalg.norm(V0, axis=1, keepdims=True)


def cfg(**kw):
    from tpu_als_torch.core.als import AlsConfig

    base = dict(rank=RANK, max_iter=2, reg_param=0.05, implicit_prefs=True,
                alpha=3.0, seed=0)
    base.update(kw)
    return AlsConfig(**base)


def frame(u, i, r):
    from tpu_als_torch.utils.frame import ColumnarFrame

    return ColumnarFrame({"user": np.asarray(u, np.int64),
                          "item": np.asarray(i, np.int64),
                          "rating": np.asarray(r, np.float32)})


def als(mesh, **kw):
    from tpu_als_torch.api.estimator import ALS

    base = dict(rank=RANK, maxIter=2, regParam=0.05, implicitPrefs=True,
                alpha=3.0, seed=0, userCol="user", itemCol="item",
                ratingCol="rating", mesh=mesh)
    base.update(kw)
    return ALS(**base)


def expect_raise(errors, name, fn):
    """Run ``fn``; record the message of the exception it must raise."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the parent checks the type
        errors[name] = f"{type(e).__name__}: {e}"
    else:
        errors[name] = None


def main(out, init_method):
    import torch

    from tpu_als_torch.api import fitting
    from tpu_als_torch.parallel import multihost, serve
    from tpu_als_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    pid, pcount = multihost.init_distributed(init_method=init_method)
    assert pcount == 2, pcount
    mesh = make_mesh(devices=["cpu"] * 2)
    assert mesh.global_size == 4 and mesh.positions == (2 * pid, 2 * pid + 1)
    u, i, r = ratings()
    mine = np.arange(NNZ) % 2 == pid
    U0, V0 = init()
    res, errors, comm = {}, {}, {}

    # train_multihost: three strategies (and the chunked gather) with
    # replicated and per-host data, from one injected init
    for strategy in ("all_gather", "ring", "all_to_all",
                     "all_gather_chunked"):
        for mode in ("replicated", "per_host"):
            if strategy == "all_gather_chunked" and mode == "per_host":
                continue
            sel = slice(None) if mode == "replicated" else mine
            multihost.reset_comm()
            U, V, up, ip = multihost.train_multihost(
                u[sel], i[sel], r[sel], NU, NI, cfg(), mesh=mesh,
                min_width=4, replicated=mode == "replicated",
                strategy=strategy, init=(U0, V0))
            comm[f"{strategy}_{mode}"] = dict(multihost.COMM)
            res[f"{strategy}_{mode}_U"] = multihost.gather_entity_factors(
                U, up, mesh).numpy()
            res[f"{strategy}_{mode}_V"] = multihost.gather_entity_factors(
                V, ip, mesh).numpy()

    # the fused ring (K7's plain version on the CPU: the peers' shards
    # gathered), both data modes; its declared cross-shard payload
    from tpu_als_torch.parallel import comm_audit

    for mode in ("replicated", "per_host"):
        sel = slice(None) if mode == "replicated" else mine
        fitted = {}

        def fused_fit():
            fitted["fit"] = multihost.train_multihost(
                u[sel], i[sel], r[sel], NU, NI,
                cfg(solve_backend="gather_fused_ring"), mesh=mesh,
                min_width=4, replicated=mode == "replicated",
                strategy="ring", init=(U0, V0))

        declared, _ = comm_audit.remote_dma_bytes(fused_fit)
        U, V, up, ip = fitted["fit"]
        res[f"fused_ring_{mode}_U"] = multihost.gather_entity_factors(
            U, up, mesh).numpy()
        res[f"fused_ring_{mode}_V"] = multihost.gather_entity_factors(
            V, ip, mesh).numpy()
        res[f"fused_ring_{mode}_declared"] = np.int64(declared)

    # the estimator: per-host frames, the seeded init drawn alike
    fr = frame(u, i, r)
    local = frame(u[mine], i[mine], r[mine])
    for strategy in ("all_gather", "ring", "all_to_all"):
        m = als(mesh, dataMode="per_host",
                gatherStrategy=strategy).fit(local)
        res[f"est_{strategy}_U"] = m._U.numpy()
        res[f"est_{strategy}_V"] = m._V.numpy()
        res[f"est_{strategy}_uids"] = m._user_map.ids

    # checkpoints: an uninterrupted 4-iteration fit, then 2 iterations
    # checkpointed (sharded and replicated) and resumed to 4
    full = als(mesh, maxIter=4).fit(fr)
    res["resume_full_U"], res["resume_full_V"] = full._U.numpy(), \
        full._V.numpy()
    for sharded in (True, False):
        d = os.path.join(out, "ckpt_sharded" if sharded else "ckpt_repl")
        als(mesh, maxIter=2, checkpointDir=d, checkpointInterval=1,
            checkpointSharded=sharded).fit(fr)
        m = als(mesh, maxIter=4, resumeFrom=os.path.join(
            d, "als_checkpoint")).fit(fr)
        tag = "sharded" if sharded else "replicated"
        res[f"resume_{tag}_U"], res[f"resume_{tag}_V"] = m._U.numpy(), \
            m._V.numpy()

    # serving: each process's rows with their offset
    rng = np.random.default_rng(11)
    Uq = rng.normal(size=(26, 8)).astype(np.float32)
    Vc = rng.normal(size=(37, 8)).astype(np.float32)
    for strategy in ("all_gather", "ring"):
        s, ix, off = serve.topk_sharded(Uq, Vc, 5, mesh, strategy=strategy)
        rows = multihost.process_allgather(np.array(
            [off, s.shape[0]], dtype=np.int64))
        got_s = multihost._ragged_allgather(s.numpy().ravel())
        got_i = multihost._ragged_allgather(ix.numpy().ravel())
        res[f"serve_{strategy}_rows"] = rows
        res[f"serve_{strategy}_scores"] = got_s.reshape(-1, 5)
        res[f"serve_{strategy}_ids"] = got_i.reshape(-1, 5)
    res["serve_U"], res["serve_V"] = Uq, Vc
    # above k = 128 'all_gather' and 'ring' keep their name, 'merge_ring'
    # runs 'ring' (as in one process)
    from tpu_als_torch import obs

    Vw = rng.normal(size=(150, 8)).astype(np.float32)
    # K8 across processes (its plain halves: the sets gathered), at k = 5
    # and above 128, with its declared payload
    for k, Vm in ((5, Vc), (130, Vw)):
        got = {}

        def merge_serve():
            got["out"] = serve.topk_sharded(Uq, Vm, k, mesh,
                                            strategy="merge_ring")

        n0 = obs.histogram_count("serve.request_seconds", strategy="ring")
        declared, _ = comm_audit.remote_dma_bytes(
            merge_serve, fires=lambda g: g[0] * (g[1] - 1))
        s, ix, off = got["out"]
        res[f"merge_ring_k{k}_rows"] = multihost.process_allgather(np.array(
            [off, s.shape[0]], dtype=np.int64))
        res[f"merge_ring_k{k}_scores"] = multihost._ragged_allgather(
            s.numpy().ravel()).reshape(-1, k)
        res[f"merge_ring_k{k}_ids"] = multihost._ragged_allgather(
            ix.numpy().ravel()).reshape(-1, k)
        res[f"merge_ring_k{k}_declared"] = np.int64(declared)
        res[f"merge_ring_k{k}_as_ring"] = np.int64(obs.histogram_count(
            "serve.request_seconds", strategy="ring") - n0)
    for strategy in ("all_gather", "ring"):
        n0 = obs.histogram_count("serve.request_seconds", strategy=strategy)
        s, ix, off = serve.topk_sharded(Uq, Vw, 130, mesh, strategy=strategy)
        res[f"serve_k130_{strategy}_recorded"] = np.int64(obs.histogram_count(
            "serve.request_seconds", strategy=strategy) - n0)
        res[f"serve_k130_{strategy}_scores"] = multihost._ragged_allgather(
            s.numpy().ravel()).reshape(-1, 130)
        res[f"serve_k130_{strategy}_ids"] = multihost._ragged_allgather(
            ix.numpy().ravel()).reshape(-1, 130)
    res["serve_k130_V"] = Vw

    # what must raise, on every process and with no hang
    knobs = fitting.multiprocess_knobs
    if pid == 1:
        fitting.multiprocess_knobs = lambda *a: {"split_width": 1 << 11,
                                                 "scratch_elems": 1 << 28}
    import tpu_als_torch.api.estimator as estimator
    estimator.multiprocess_knobs = fitting.multiprocess_knobs
    expect_raise(errors, "gate_knob", lambda: als(mesh).fit(fr))
    fitting.multiprocess_knobs = estimator.multiprocess_knobs = knobs
    expect_raise(errors, "gate_strategy", lambda: als(
        mesh, gatherStrategy="all_gather" if pid == 0 else "ring").fit(fr))
    expect_raise(errors, "gate_auto", lambda: als(
        mesh, gatherStrategy="auto").fit(fr))
    bad = r.copy()
    if pid == 1:
        bad[5] = np.nan
    expect_raise(errors, "nan", lambda: als(mesh).fit(frame(u, i, bad)))
    expect_raise(errors, "duplicated", lambda: multihost.train_multihost(
        u, i, r, NU, NI, cfg(), mesh=mesh, min_width=4, replicated=False,
        init=(U0, V0)))
    expect_raise(errors, "recommend", lambda: full.recommend_arrays(
        3, mesh=mesh))
    expect_raise(errors, "mesh_counts", lambda: make_mesh(
        devices=["cpu"] * (2 + pid)))
    expect_raise(errors, "dims", lambda: multihost.train_multihost(
        u, i, r, NU + pid, NI, cfg(), mesh=mesh, replicated=True,
        init=(U0, V0)))
    expect_raise(errors, "replicated_differ", lambda: multihost.
                 train_multihost(u[mine], i[mine], r[mine], NU, NI, cfg(),
                                 mesh=mesh, replicated=True, init=(U0, V0)))
    # a degenerate all_to_all plan (dense data) falls back to all_gather
    rng = np.random.default_rng(5)
    du, di = rng.integers(0, 60, 1100), rng.integers(0, 45, 1100)
    dr = (rng.integers(1, 11, 1100) * 0.5).astype(np.float32)
    g = np.random.default_rng(6)
    dU0 = g.normal(size=(60, RANK)).astype(np.float32)
    dV0 = g.normal(size=(45, RANK)).astype(np.float32)
    dsel = np.arange(1100) % 2 == pid
    for strategy in ("all_to_all", "all_gather"):
        U, V, up, ip = multihost.train_multihost(
            du[dsel], di[dsel], dr[dsel], 60, 45, cfg(), mesh=mesh,
            min_width=4, strategy=strategy, init=(dU0, dV0))
        res[f"dense_{strategy}_U"] = multihost.gather_entity_factors(
            U, up, mesh).numpy()
    # the group is still usable after every raise above
    multihost.barrier()
    # a shared run directory: only process 0 writes it
    obs.configure(os.path.join(out, "obs"), config={}, argv=[])
    errors["_obs_wrote"] = obs.finalize() is not None
    obs.deconfigure()

    errs = multihost.process_allgather(np.frombuffer(
        json.dumps(errors, sort_keys=True).ljust(8192).encode(),
        dtype=np.uint8))
    if pid == 0:
        np.savez(os.path.join(out, "result.npz"), **res)
        with open(os.path.join(out, "result.json"), "w") as f:
            json.dump({"errors": [json.loads(bytes(e).decode())
                                  for e in errs],
                       "comm": comm}, f)
    print(f"worker {pid} ok", flush=True)


if __name__ == "__main__":
    # the port runs without the reference and without jax
    sys.modules["jax"] = None
    sys.modules["tpu_als"] = None
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        main(sys.argv[1], sys.argv[2])
