#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to account.

Run from the repository root:  python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero before the final line):

1. print the card (``nvidia-smi`` name and power limit) and build every
   CUDA kernel of the serving path from ``tpu_als_torch/csrc``;
2. K2 (batched SPD solve) against its plain version on random SPD
   batches ``M Mᵀ/r + 0.5·I`` at ranks 10, 64 and 128, with b = 0 rows
   and a near-singular row;
3. K5 (fused score GEMM + top-k) against its plain version over the full
   59,047-item catalog with ~10 % of items invalid, at k = 10 and 128,
   and on a catalog smaller than k;
4. the serving slice at the ML-25M shape (162,541 users x 59,047 items,
   rank 128, implicit, alpha 40, regParam 0.01) from seeded random
   factors: save/load, ``FoldInServer.update`` on hourly-style batches
   of 4,096 users (half new), ``update_items`` on 512 items, then
   ``recommendForUserSubset``, ``recommend_arrays`` for all users and
   ``transform`` on 100k pairs; launch counts are read around this run;
5. timings at the slice's shapes (CUDA events);
6. where the time goes: one more fold-in batch and one all-users
   recommend under ``torch.profiler`` (wall, device busy, idle share,
   host packing, top kernels); then one JSON line with every kernel's
   numbers, and the final ``{"ok": true, ...}`` line.

Bounds use NVIDIA's H100 SXM data sheet: 3.35 TB/s of HBM and 67 TFLOP/s
in float32 outside the tensor cores.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time

import numpy as np
import torch

from tpu_als_torch import _build
from tpu_als_torch.api.estimator import ALSModel
from tpu_als_torch.convert import model_from_arrays
from tpu_als_torch.core.foldin import normal_eqs
from tpu_als_torch.ops import cuda_lanes, cuda_topk
from tpu_als_torch.ops.solve import compute_yty, regularize
from tpu_als_torch.ops.topk import NEG_INF, chunked_topk_scores
from tpu_als_torch.stream.microbatch import FoldInServer, pack_rows
from tpu_als_torch.utils.platform import pin_fp32

N_USERS, N_ITEMS, RANK = 162_541, 59_047, 128   # ML-25M serving shape
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12                         # H100 SXM, non-tensor f32
NEG_INF32 = float(torch.tensor(NEG_INF, dtype=torch.float32))

# stated tolerances
K2_RTOL, K2_ATOL = 1e-4, 1e-5       # well-conditioned batches
K5_TOL = 1e-5                       # scores and each id's own U·V
FOLDIN_REL = 1e-3                   # per row, relative to ||x||


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds per call over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound(nbytes, flops):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def unit_rows(rng, n, r):
    x = rng.standard_normal((n, r), dtype=np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


# -- phase 2 ---------------------------------------------------------------
def check_k2(rng, dev):
    worst = 0.0
    for r in (10, 64, 128):
        N = 4096
        M = torch.from_numpy(
            rng.standard_normal((N, r, r), dtype=np.float32)).to(dev)
        A = M @ M.transpose(1, 2) / r + 0.5 * torch.eye(r, device=dev)
        b = torch.from_numpy(
            rng.standard_normal((N, r), dtype=np.float32)).to(dev)
        b[:8] = 0.0                                  # rows with b = 0
        v = torch.from_numpy(rng.standard_normal(r, dtype=np.float32))
        # a near-singular row: rank-1 plus a small ridge
        A[8] = (torch.outer(v, v) + 1e-4 * torch.eye(r)).to(dev)
        A = A.contiguous()
        xk = cuda_lanes.spd_solve_lanes(A, b)
        xp = cuda_lanes.chol_solve_plain(A, b)
        torch.cuda.synchronize()
        if not (torch.all(xk[:8] == 0) and torch.all(xp[:8] == 0)):
            fail(f"K2 r={r}: b = 0 rows did not solve to 0")
        if not torch.isfinite(xk[8]).all():
            fail(f"K2 r={r}: near-singular row is not finite")
        ok = slice(9, None)
        err = (xk[ok] - xp[ok]).abs().max().item()
        if not torch.allclose(xk[ok], xp[ok], rtol=K2_RTOL, atol=K2_ATOL):
            fail(f"K2 r={r}: kernel vs plain max |diff| {err:.3e}")
        log(f"k2 r={r} N={N}: max |kernel - plain| {err:.3e} "
            f"(rtol {K2_RTOL}, atol {K2_ATOL})")
        if r == RANK:
            worst = err
    return worst


# -- phase 3 ---------------------------------------------------------------
def earns_scores(U, V, valid, s, ix, where):
    """Each real slot's id is valid, distinct in its row, and U·V[id]
    equals its score within K5_TOL."""
    real = s > NEG_INF32
    if not bool(valid[ix[real]].all()):
        fail(f"{where}: an invalid item was returned")
    own = (U[:, None, :] * V[ix]).sum(-1)
    diff = (own - s)[real].abs().max().item() if real.any() else 0.0
    if diff > K5_TOL:
        fail(f"{where}: an id does not earn its score ({diff:.3e})")
    srt = torch.sort(torch.where(real, ix, -1 - torch.arange(
        ix.shape[1], device=ix.device)), dim=1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        fail(f"{where}: an id repeats within a row")
    if bool((s[:, 1:] > s[:, :-1]).any()):
        fail(f"{where}: scores are not sorted descending")
    return diff


def check_k5(rng, dev):
    U = torch.from_numpy(unit_rows(rng, 8192, RANK)).to(dev)
    V = torch.from_numpy(unit_rows(rng, N_ITEMS, RANK)).to(dev)
    valid = torch.from_numpy(rng.random(N_ITEMS) >= 0.1).to(dev)
    worst = 0.0
    for k in (10, 128):
        sk, ik = cuda_topk.topk_scores(U, V, valid, k)
        sp, _ = chunked_topk_scores(U, V, valid, k)
        torch.cuda.synchronize()
        err = (sk - sp).abs().max().item()
        if not torch.allclose(sk, sp, rtol=K5_TOL, atol=K5_TOL):
            fail(f"K5 k={k}: kernel vs plain scores max |diff| {err:.3e}")
        earns_scores(U, V, valid, sk, ik, f"K5 k={k}")
        log(f"k5 n=8192 Ni={N_ITEMS} k={k}: max |kernel - plain| "
            f"{err:.3e} (tol {K5_TOL})")
        if k == 10:
            worst = err
    # a catalog smaller than k: exactly n_valid real slots, then NEG_INF
    Vs, vs = V[:50].contiguous(), valid[:50].contiguous()
    n_valid = int(vs.sum())
    sk, ik = cuda_topk.topk_scores(U[:256].contiguous(), Vs, vs, 128)
    if not bool((sk[:, n_valid:] == NEG_INF32).all()):
        fail("K5 small catalog: surplus slots are not exactly NEG_INF")
    if not bool((sk[:, :n_valid] > NEG_INF32).all()):
        fail("K5 small catalog: a valid item is missing")
    earns_scores(U[:256], Vs, vs, sk, ik, "K5 small catalog")
    log(f"k5 small catalog Ni=50 ({n_valid} valid) k=128: sentinel slots "
        "exact")
    return worst


# -- phase 4 ---------------------------------------------------------------
def foldin_batch(rng, n_users, existing, first_new, n_fixed):
    """Hourly-style batch: ``n_users`` distinct ids, half of them new,
    power-law rating counts capped at 256, half-star ratings."""
    half = n_users // 2
    users = np.concatenate([
        rng.choice(existing, half, replace=False),
        first_new + np.arange(n_users - half)])
    counts = np.minimum(256, 1 + (rng.pareto(0.8, n_users) * 4)
                        .astype(np.int64))
    u = np.repeat(users, counts)
    i = rng.integers(0, n_fixed, len(u))
    r = (rng.integers(1, 11, len(u)) * 0.5).astype(np.float32)
    return {"user": u, "item": i, "rating": r}, users


def run_slice(rng, dev):
    U0 = unit_rows(rng, N_USERS, RANK)
    V0 = unit_rows(rng, N_ITEMS, RANK)
    params = {"rank": RANK, "implicitPrefs": True, "alpha": 40.0,
              "regParam": 0.01, "nonnegative": False, "userCol": "user",
              "itemCol": "item", "ratingCol": "rating",
              "predictionCol": "prediction", "coldStartStrategy": "nan",
              "blockSize": 4096}
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/model"
        model_from_arrays(RANK, np.arange(N_USERS), U0, np.arange(N_ITEMS),
                          V0, params, device=dev).save(path)
        model = ALSModel.load(path)            # device=None -> cuda
    if model.device.type != dev.type or not torch.equal(
            model._U.cpu(), torch.from_numpy(U0)):
        fail("save/load did not round-trip the user factors onto the card")

    batch1, users1 = foldin_batch(rng, 4096, np.arange(N_USERS), N_USERS,
                                  N_ITEMS)
    # the plain reference for batch 1, before any fold-in moves the model
    touched_ref, cols, vals, mask = pack_rows(
        batch1["user"], batch1["item"], batch1["rating"])
    A, b, count = normal_eqs(
        model._V, torch.from_numpy(cols).to(dev),
        torch.from_numpy(vals).to(dev), torch.from_numpy(mask).to(dev),
        0.01, implicit_prefs=True, alpha=40.0, YtY=compute_yty(model._V))
    A_slice, b_slice = regularize(A, count), b.contiguous()
    x_ref = cuda_lanes.chol_solve_plain(A_slice, b_slice)
    del A, b

    srv = FoldInServer(model)
    srv.prewarm(rows=(4096,), widths=(256,))
    later = [foldin_batch(rng, 4096, np.arange(N_USERS),
                          N_USERS + 4096 * (j + 1), N_ITEMS)[0]
             for j in range(4)]
    ib = {"user": rng.integers(0, N_USERS, 8192),
          "item": np.repeat(np.concatenate([
              rng.choice(N_ITEMS, 256, replace=False),
              N_ITEMS + np.arange(256)]), 16),
          "rating": (rng.integers(1, 11, 8192) * 0.5).astype(np.float32)}
    pairs = {"user": rng.integers(0, N_USERS + 8192, 100_000),
             "item": rng.integers(0, N_ITEMS + 512, 100_000)}

    cuda_lanes.LAUNCHES = 0
    cuda_topk.LAUNCHES = 0
    touched = srv.update(batch1)
    x1 = model._U[torch.from_numpy(
        model._user_map.to_dense(touched)).to(dev)].clone()
    for bt in later:
        srv.update(bt)
    # before update_items, whose batch also lands in srv.stats
    n_user_batches, p50 = len(srv.stats), srv.latency(0.5)
    items_touched = srv.update_items(ib)
    recs = model.recommendForUserSubset({"user": users1}, 10)
    t0 = time.perf_counter()
    _, rec_ids, rec_scores = model.recommend_arrays(10)
    rec_wall = time.perf_counter() - t0
    preds = model.transform(pairs)["prediction"]
    launches = {"k2": cuda_lanes.LAUNCHES, "k5": cuda_topk.LAUNCHES}
    log(f"slice launches: K2 {launches['k2']}, K5 {launches['k5']}")
    if launches["k2"] == 0 or launches["k5"] == 0:
        fail(f"a kernel of the serving path never launched: {launches}")

    # checks on what came out
    if not np.array_equal(touched, touched_ref):
        fail("fold-in touched set differs from the packed batch")
    rel = ((x1 - x_ref).norm(dim=1) / x_ref.norm(dim=1).clamp(min=1e-30))
    rel_max = rel.max().item()
    if not torch.isfinite(x1).all() or rel_max > FOLDIN_REL:
        fail(f"fold-in vs plain on the card: max rel err {rel_max:.3e}")
    log(f"fold-in batch 1 ({len(touched)} users, "
        f"{len(batch1['user'])} ratings): max |x - x_plain|/|x_plain| "
        f"{rel_max:.3e} (tol {FOLDIN_REL})")
    if len(items_touched) != 512 or len(model._item_map) != N_ITEMS + 256:
        fail("update_items did not fold in 512 items (256 new)")
    new_users = set(users1[users1 >= N_USERS].tolist())
    rows = [j for j, u in enumerate(recs["user"]) if int(u) in new_users]
    if len(rows) != len(new_users):
        fail("a new user is missing from recommendForUserSubset")
    sc = recs["recommendations"]["rating"][rows]
    if not (np.isfinite(sc).all() and (np.diff(sc, axis=1) <= 0).all()):
        fail("new users' scores are not finite and sorted")
    n_all = model._U.shape[0]
    if rec_ids.shape != (n_all, 10) or not np.isfinite(rec_scores).all():
        fail(f"recommend_arrays shape {rec_ids.shape} for {n_all} users")
    sample = torch.from_numpy(rng.choice(n_all, 2048, replace=False)).to(dev)
    Us = model._U[sample]
    valid_all = torch.ones(model._V.shape[0], dtype=torch.bool, device=dev)
    sp, _ = chunked_topk_scores(Us, model._V, valid_all, 10)
    dense_ids = torch.from_numpy(
        model._item_map.to_dense(rec_ids[sample.cpu().numpy()])).to(dev)
    got = torch.from_numpy(rec_scores[sample.cpu().numpy()]).to(dev)
    if not torch.allclose(got, sp, rtol=K5_TOL, atol=K5_TOL):
        fail("recommend_arrays scores differ from the plain top-k")
    earns_scores(Us, model._V, valid_all, got, dense_ids, "recommend_arrays")
    known = ((model._user_map.to_dense(pairs["user"]) >= 0)
             & (model._item_map.to_dense(pairs["item"]) >= 0))
    if not (np.isfinite(preds[known]).all() and np.isnan(preds[~known]).all()):
        fail("transform: NaN exactly where an id is unknown was violated")
    log(f"recommend_arrays: {n_all} users x k=10 in {rec_wall * 1e3:.1f} ms "
        "(host clock, results on the host)")
    log(f"fold-in p50 latency: {p50 * 1e3:.1f} ms over "
        f"{n_user_batches} user batches of 4096 users")
    return model, launches, A_slice, b_slice


# -- phase 5 ---------------------------------------------------------------
def timings(model, launches, A, b, errs, dev):
    out = []
    N, r = b.shape
    k_ms = cuda_ms(lambda: cuda_lanes.spd_solve_lanes(A, b), 20)
    p_ms = cuda_ms(lambda: cuda_lanes.chol_solve_plain(A, b), 2)
    l_ms = cuda_ms(lambda: torch.cholesky_solve(
        b[..., None], torch.linalg.cholesky(A)), 20)
    # the kernel reads only A's lower triangle, then b, and writes x
    b_ms, by = bound((N * r * (r + 1) // 2 + 2 * N * r) * 4,
                     N * (r ** 3 / 3 + 2 * r * r))
    out.append({"name": "spd_solve_lanes (K2)", "route": "cuda",
                "source": "tpu_als_torch/csrc/chol_solve.cu",
                "replaces": "tpu_als/ops/pallas_lanes.py:199",
                "launches": launches["k2"], "max_abs_err": errs["k2"],
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": by, "library_ms": l_ms})

    U, V = model._U, model._V
    n, Ni, k = U.shape[0], V.shape[0], 10
    valid = torch.ones(Ni, dtype=torch.bool, device=dev)

    def library():
        for s in range(0, n, 16384):
            torch.topk(U[s:s + 16384] @ V.T, k, dim=1)

    k_ms5 = cuda_ms(lambda: cuda_topk.topk_scores(U, V, valid, k), 3)
    p_ms5 = cuda_ms(lambda: chunked_topk_scores(U, V, valid, k), 1)
    l_ms5 = cuda_ms(library, 1)
    b_ms5, by5 = bound((n * r + Ni * r) * 4 + Ni + n * k * (4 + 8),
                       2 * n * Ni * r)
    out.append({"name": "topk_scores_pallas (K5)", "route": "cuda",
                "source": "tpu_als_torch/csrc/topk.cu",
                "replaces": "tpu_als/ops/pallas_topk.py:119",
                "launches": launches["k5"], "max_abs_err": errs["k5"],
                "ms": k_ms5, "plain_ms": p_ms5, "bound_ms": b_ms5,
                "bound_by": by5, "library_ms": l_ms5})
    log(f"timing K2 N={N} r={r}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
        f"library_ms={l_ms:.4f} bound_ms={b_ms:.4f} ({by}) "
        f"launches={launches['k2']}")
    log(f"timing K5 n={n} Ni={Ni} r={r} k={k}: kernel_ms={k_ms5:.4f} "
        f"plain_ms={p_ms5:.4f} library_ms={l_ms5:.4f} bound_ms={b_ms5:.4f} "
        f"({by5}) launches={launches['k5']}")
    return out


def where_time_goes(model, rng, dev):
    """One more fold-in batch and one all-users recommend under the
    profiler: wall time, device busy time (sum of kernel times), the
    device's idle share, the host's packing time, and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch, _ = foldin_batch(rng, 4096, np.arange(N_USERS),
                            int(model._user_map.ids.max()) + 1, N_ITEMS)
    t0 = time.perf_counter()
    fixed = model._item_map.to_dense(batch["item"])
    pack_rows(batch["user"], fixed, batch["rating"])
    pack_ms = (time.perf_counter() - t0) * 1e3
    srv = FoldInServer(model)
    for what, fn in (("fold-in update", lambda: srv.update(batch)),
                     ("recommend_arrays", lambda: model.recommend_arrays(10))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        # device-side events only (kernels, copies): a CPU op's self
        # device time repeats its kernels' time
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0
              and not e.key.startswith("Activity Buffer")]
        busy = sum(e.self_device_time_total for e in ev) / 1e3
        top = sorted(ev, key=lambda e: -e.self_device_time_total)[:5]
        log(f"profile {what}: wall_ms={wall:.3f} device_busy_ms={busy:.3f} "
            f"device_idle_share={1 - busy / wall:.3f}"
            + (f" host_pack_ms={pack_ms:.3f}" if what.startswith("fold")
               else ""))
        for e in top:
            log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d}"
                f" {e.key[:90]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device is visible")
    pin_fp32()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {smi}")
    t0 = time.perf_counter()
    libs = _build.load_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    errs = {"k2": check_k2(rng, dev), "k5": check_k5(rng, dev)}
    model, launches, A, b = run_slice(rng, dev)
    kernels = timings(model, launches, A, b, errs, dev)
    where_time_goes(model, rng, dev)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
