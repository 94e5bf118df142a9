#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to account.

Run from the repository root:  python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero before the final line):

1. print the card (``nvidia-smi`` name and power limit) and build every
   CUDA kernel of the port from ``tpu_als_torch/csrc`` (one nvcc per
   source, all started together);
2. K2 (batched SPD solve, rank <= 128), K1 (blocked SPD solve) and K6
   (blocked factorization above rank 128, written over its input)
   against their plain versions on random SPD batches ``M Mᵀ/r + 0.5·I``
   (K2 at ranks 10, 64, 128; K1 at 10, 128, 256; K6's L entry by entry
   at 136, 256 and 384, past K1's 323, its storage holding L afterwards,
   and x through ``spd_solve_lanes_blocked`` against a float64 solve),
   with b = 0 rows and a near-singular row;
3. K5 (fused score GEMM + top-k) against its plain version over the full
   59,047-item catalog with ~10 % of items invalid, at k = 10 and 128,
   and on a catalog smaller than k;
4. K3 (gather + Gram) and K4 (gather + Gram + tail + solve) against
   their plain versions (``V[cols]`` + ``torch.bmm``, K1's plain solve)
   at rank 128, then at ranks 200 and 256: two- and one-sided, f32 and
   bf16 tables, widths 24, 100 (rank 128), 512 and a row wider than the
   trainer's split width (K3's split path; K4 at ranks 200 and 256 too);
   empty rows, duplicate columns and an implicit row with no positive
   rating (K4: exactly 0); K7 (K4 over S shards in ring order) against
   its plain version at ranks 128, 200 and 256, S = 1, 3 and 4 shards,
   explicit and implicit, f32 and bf16, and at S = 1 against K4 bit for
   bit; K8 (the cross-shard top-k merge) against its plain version and
   the whole-catalog plain top-k, bitwise, on the integer tie corpus at
   4,096 users x 59,047 items, S = 1, 3, 4 and 8, k = 10 and 128, with a
   sparse validity mask and an all-invalid shard;
5. the training slice at the full ML-25M shape (162,541 users x 59,047
   items x 25,000,095 ratings, ``synthetic_movielens``): the bucketed
   layout both ways (host seconds), each bucket's route, then
   ``ALS(rank=128, implicitPrefs=True, alpha=40.0, regParam=0.01,
   maxIter=3).fit`` on the card with K1/K3/K4 launch counts read around
   it, per-iteration wall time, finite factors, and one iteration from
   one init through 'auto' (K4 + K3/K1) against 'unfused' (torch gather
   + bmm + K2), row by row, with each route's distance from a float64
   solve of the heaviest rows; then the same at rank 256 (BASELINE
   config 3's width) on the same data and layout: K3/K4/K6 launch
   counts, and 'auto' (K4 + K3/K6) against 'unfused' (torch + K6); then
   sharded training on 4 logical shards on the card: the ring's owner x
   source grid (host seconds, padded entries), ``train_sharded(...,
   strategy='ring')`` with ``solve_backend='gather_fused_ring'`` (K7) for
   2 iterations from the init of a 2-iteration single-device fit, row by
   row against it, and one iteration of the unfused ring (K2);
6. the serving slice at the ML-25M shape (rank 128, implicit, alpha 40,
   regParam 0.01) from seeded random factors: save/load,
   ``FoldInServer.update`` on hourly-style batches of 4,096 users (half
   new), ``update_items`` on 512 items, then ``recommendForUserSubset``,
   ``recommend_arrays`` for all users and ``transform`` on 100k pairs;
   K2/K5 launch counts are read around this run; then at rank 256 the
   fitted factors through ``model_from_arrays``, save/load, two fold-in
   batches of 4,096 users (K6) and recommend-all (K5 at r = 256); then
   ``recommend_arrays(10, mesh=4 logical shards,
   gatherStrategy='merge_ring')`` (K8) for every user of the rank-128
   fit, against the single-device K5 sweep;
7. timings at the slices' shapes (CUDA events), each kernel beside its
   plain version, its library yardstick and its bound; K4 and K3 held
   against their plain versions once more on the item half-step's
   buckets (widths up to 2^13, and the wide rows split), at ranks 128
   and 256; K6 on the rank-256 fold-in systems and on the fit's wide
   rows, beside K1 on the same systems and the two substitutions; K7 over
   the sharded item half-step's ring grid (each bucket's time) beside
   its plain version and the unfused ring half-step, after K7 == K4
   bitwise at one shard on the single-device item half-step's K4
   buckets; K8 at the sharded serving shape beside its plain version and
   a matmul + stable sort; each
   bucket's time in both half-steps, and one iteration beside its bound;
8. where the time goes: one training iteration, one more fold-in batch
   and one all-users recommend, and one rank-256 iteration and fold-in
   batch, under ``torch.profiler`` (wall, device busy, idle share, top
   kernels); then one JSON line with every kernel's numbers (K3, K4 and
   K6 at rank 256 named so), and the final ``{"ok": true, ...}`` line.

Bounds use NVIDIA's H100 SXM data sheet: 3.35 TB/s of HBM and 67 TFLOP/s
in float32 outside the tensor cores.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import tempfile
import time

import numpy as np
import torch

from tpu_als_torch import _build
from tpu_als_torch.api.estimator import ALS, ALSModel
from tpu_als_torch.convert import entity_rows, model_from_arrays, slot_rows
from tpu_als_torch.core import als as core_als
from tpu_als_torch.core.foldin import normal_eqs
from tpu_als_torch.core.ratings import build_csr_buckets, remap_ids
from tpu_als_torch.io.movielens import ML25M_SHAPE, synthetic_movielens
from tpu_als_torch.ops import cuda_gather_ne, cuda_lanes, cuda_solve
from tpu_als_torch.ops import cuda_lanes_blocked, cuda_topk
from tpu_als_torch.ops.solve import compute_yty, implicit_weights, regularize
from tpu_als_torch.ops.topk import NEG_INF, chunked_topk_scores
from tpu_als_torch.parallel.comm import ring_half_step, shard_csr_grid
from tpu_als_torch.parallel.data import partition_balanced
from tpu_als_torch.parallel.mesh import make_mesh
from tpu_als_torch.parallel.trainer import stacked_counts, train_sharded
from tpu_als_torch.stream.microbatch import FoldInServer, pack_rows
from tpu_als_torch.utils.platform import pin_fp32

N_USERS, N_ITEMS, RANK = 162_541, 59_047, 128   # ML-25M serving shape
RANK256 = 256                                   # BASELINE config 3's width
SHARDS = 4                                      # logical shards on the card
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12                         # H100 SXM, non-tensor f32
NEG_INF32 = float(torch.tensor(NEG_INF, dtype=torch.float32))

# stated tolerances
K2_RTOL, K2_ATOL = 1e-4, 1e-5       # well-conditioned batches (K1, K2,
                                    # K6's L, and x against float64)
# K6 on the fold-in's own systems (implicit, alpha 40: L reaches ~1e2):
# max |L - L_plain| relative to max |L_plain|
K6_REL = 1e-5
K5_TOL = 1e-5                       # scores and each id's own U·V
# K3: |S - S_plain| and |b - b_plain| entry by entry, relative to the sum
# of the magnitudes of the entry's terms (b's terms cancel, so its own
# size is no scale).  The plain side's cuBLAS sums each width chunk (up
# to the trainer's split width of same-sign terms) in sequence, which
# drifts ~eps·sqrt(w/3) of their size; the kernel sums in two levels
K3_REL = 5e-5
# K4: the reference's own band for fused vs unfused solves
K4_RTOL, K4_ATOL = 5e-4, 5e-5
TRAIN_REL = 1e-3                    # 'auto' vs 'unfused', per row / ||x||
                                    # (and sharded vs one device)
# K7 vs its plain version: K4's band (the same Gram and tail over S·w
# entries); at one shard K7 must equal K4 bitwise.  K8 vs its plain
# version: bitwise on the integer tie corpus (every score exact).
# Sharded vs single-device recommend-all scores: within SERVE_ULPS units
# in the last place (K8 and K5 compute each score the same way)
SERVE_ULPS = 4
REG, ALPHA = 0.01, 40.0             # the slice's implicit configuration
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


def timed(fn):
    """``(fn(), milliseconds)`` of one call by CUDA events: a plain
    version is timed on the pass that is also checked, not run again."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def bound(nbytes, flops):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def gram_work(bks, num_rows):
    """``(padded, real, rows)`` of the buckets ``bks``: padded entries,
    real entries (mask 1) and real rows (``rows < num_rows``).  A bound
    reads cols and weights for every padded entry, but gathers a factor
    row and does the Gram's and b's operations only for a real entry, and
    solves (and writes x for) only a real row: padded entries carry mask
    0, and the scatter drops padding rows."""
    padded = sum(b.cols.numel() for b in bks)
    real = sum(int(b.mask.count_nonzero()) for b in bks)
    rows = sum(int((b.rows < num_rows).sum()) for b in bks)
    return padded, real, rows


def gram_flops(real, rows, r):
    """The Gram on its lower triangle and b per real entry, r(r+1) + 2r,
    plus a Cholesky factorization and two substitutions, r³/3 + 2r², per
    solved row."""
    return real * (r * (r + 1) + 2 * r) + rows * (r ** 3 / 3 + 2 * r * r)


def unit_rows(rng, n, r):
    x = rng.standard_normal((n, r), dtype=np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


# -- phase 2 ---------------------------------------------------------------
def spd_batch(rng, N, r, dev):
    """Random SPD ``M Mᵀ/r + 0.5·I`` with rows 0..7 of b zero and row 8 a
    near-singular rank-1-plus-small-ridge system."""
    M = torch.from_numpy(
        rng.standard_normal((N, r, r), dtype=np.float32)).to(dev)
    A = M @ M.transpose(1, 2) / r + 0.5 * torch.eye(r, device=dev)
    b = torch.from_numpy(
        rng.standard_normal((N, r), dtype=np.float32)).to(dev)
    b[:8] = 0.0
    v = torch.from_numpy(rng.standard_normal(r, dtype=np.float32))
    A[8] = (torch.outer(v, v) + 1e-4 * torch.eye(r)).to(dev)
    return A.contiguous(), b


def check_spd(name, solve, plain, shapes, rng, dev):
    """Kernel vs plain on ``spd_batch``; returns the error at RANK."""
    worst = 0.0
    for r, N in shapes:
        A, b = spd_batch(rng, N, r, dev)
        xk = solve(A, b)
        xp = plain(A, b)
        torch.cuda.synchronize()
        if not (torch.all(xk[:8] == 0) and torch.all(xp[:8] == 0)):
            fail(f"{name} r={r}: b = 0 rows did not solve to 0")
        if not torch.isfinite(xk[8]).all():
            fail(f"{name} r={r}: near-singular row is not finite")
        ok = slice(9, None)
        err = (xk[ok] - xp[ok]).abs().max().item()
        if not torch.allclose(xk[ok], xp[ok], rtol=K2_RTOL, atol=K2_ATOL):
            fail(f"{name} r={r}: kernel vs plain max |diff| {err:.3e}")
        log(f"{name.lower()} r={r} N={N}: max |kernel - plain| {err:.3e} "
            f"(rtol {K2_RTOL}, atol {K2_ATOL})")
        if r == RANK:
            worst = err
    return worst


def check_k2(rng, dev):
    return check_spd("K2", cuda_lanes.spd_solve_lanes,
                     cuda_lanes.chol_solve_plain,
                     ((10, 4096), (64, 4096), (128, 4096)), rng, dev)


def check_k1(rng, dev):
    return check_spd("K1", cuda_solve.spd_solve_blocked,
                     cuda_solve.chol_blocked_plain,
                     ((10, 4096), (128, 4096), (256, 512)), rng, dev)


def check_k6(rng, dev):
    """K6 vs plain on ``spd_batch``, L entry by entry (it is written over
    A, so A's storage must hold L afterwards), then x through
    ``spd_solve_lanes_blocked`` against a float64 solve; returns the
    error of L at rank 256."""
    worst = 0.0
    for r, N in ((136, 512), (256, 4096), (384, 256)):
        A, b = spd_batch(rng, N, r, dev)
        Ak = A.clone()
        ptr = Ak.untyped_storage().data_ptr()
        L = cuda_lanes_blocked.chol_lanes_blocked(Ak)
        Lp = cuda_lanes_blocked.chol_lanes_blocked_plain(A.clone())
        torch.cuda.synchronize()
        if L.untyped_storage().data_ptr() != ptr or not torch.equal(L, Ak):
            fail(f"K6 r={r}: L is not in A's storage")
        if not bool((torch.triu(Ak, 1) == 0).all()):
            fail(f"K6 r={r}: A's storage holds non-zeros above the diagonal")
        if not torch.isfinite(Ak[8]).all():
            fail(f"K6 r={r}: near-singular row is not finite")
        ok = slice(9, None)
        err = (Ak[ok] - Lp[ok]).abs().max().item()
        if not torch.allclose(Ak[ok], Lp[ok], rtol=K2_RTOL, atol=K2_ATOL):
            fail(f"K6 r={r}: kernel vs plain max |diff| of L {err:.3e}")
        x = cuda_lanes_blocked.spd_solve_lanes_blocked(A.clone(), b)
        x64 = torch.linalg.solve(A.double(), b.double()[..., None])[..., 0]
        torch.cuda.synchronize()
        if not torch.all(x[:8] == 0) or not torch.isfinite(x[8]).all():
            fail(f"K6 r={r}: b = 0 rows not 0, or the near-singular row "
                 "not finite")
        e64 = (x[ok].double() - x64[ok]).abs().max().item()
        if not torch.allclose(x[ok].double(), x64[ok], rtol=K2_RTOL,
                              atol=K2_ATOL):
            fail(f"K6 r={r}: x vs float64 max |diff| {e64:.3e}")
        log(f"k6 r={r} N={N}: max |L - L_plain| {err:.3e}; x max |x - x64| "
            f"{e64:.3e} (rtol {K2_RTOL}, atol {K2_ATOL}); L in A's storage")
        if r == RANK256:
            worst = err
        del A, Ak, L, Lp, x, x64
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
def gather_problem(rng, dev, n, w, dtype, N=N_ITEMS, dup=True, r=RANK):
    """Unit factor rows, half-star ratings with ~20 % padding; row 0 is
    empty, row 1 (with ``dup``) repeats one column in every other slot,
    row 2 has only non-positive ratings."""
    V = torch.from_numpy(unit_rows(rng, N, r)).to(dev).to(dtype)
    cols = rng.integers(0, N, (n, w)).astype(np.int32)
    if dup:
        cols[1, 1::2] = cols[1, 0]
    vals = (rng.integers(1, 11, (n, w)) * 0.5).astype(np.float32)
    mask = (rng.random((n, w)) < 0.8).astype(np.float32)
    mask[0] = 0.0
    vals[2] = -vals[2]
    vals *= mask
    return (V, torch.from_numpy(cols).to(dev),
            torch.from_numpy(vals).to(dev).to(dtype),
            torch.from_numpy(mask).to(dev).to(dtype))


def rel_err(x, ref, scale):
    """max |x - ref| / scale over the entries where scale > 0."""
    ok = scale > 0
    return ((x - ref).abs()[ok] / scale[ok]).max().item()


def check_k3(rng, dev, r=RANK, widths=(24, 100, 512)):
    """K3 vs V[cols] + bmm at rank r, 64 rows of each width and 3 rows
    wider than the split width: returns the largest |S - S_plain| at f32.
    The row wider than the split width has no repeated column: a long
    sum of equal terms drifts in float32 far more than one of varied
    terms in cuBLAS's sequential order, which would be the plain side's
    error, not the kernel's."""
    worst = 0.0
    split = core_als.SPLIT_WIDTH
    for dtype in (torch.float32, torch.bfloat16):
        for n, w in [(64, w) for w in widths] + [(3, 3 * split)]:
            V, cols, vals, mask = gather_problem(rng, dev, n, w, dtype,
                                                 dup=w <= split, r=r)
            conf, pref = implicit_weights(vals, mask, ALPHA)
            for two_sided, aw, bw in ((True, mask, vals * mask),
                                      (False, conf,
                                       (1.0 + conf) * pref * mask)):
                S, b = cuda_gather_ne.gather_gram(
                    V, cols, aw, bw, two_sided=two_sided, split_width=split)
                Sp, bp = cuda_gather_ne.gather_gram_plain(
                    V, cols, aw, bw, two_sided=two_sided, split_width=split)
                Sa, ba = cuda_gather_ne.gather_gram_plain(
                    V.abs(), cols, aw.abs(), bw.abs(), two_sided=two_sided,
                    split_width=split)
                torch.cuda.synchronize()
                es, eb = rel_err(S, Sp, Sa), rel_err(b, bp, ba)
                if not (es <= K3_REL and eb <= K3_REL):
                    fail(f"K3 {dtype} n={n} w={w} two_sided={two_sided}: "
                         f"relative |diff| S {es:.3e}, b {eb:.3e}")
                if dtype == torch.float32:
                    worst = max(worst, (S - Sp).abs().max().item())
            log(f"k3 r={r} {str(dtype)[6:]} n={n} w={w}"
                f"{' (split)' if w > split else ''}: max |kernel - plain| / "
                f"Σ|terms| S {es:.3e}, b {eb:.3e} (tol {K3_REL})")
    return worst


def check_k4(rng, dev, r=RANK, shapes=((256, 24), (256, 100), (64, 512))):
    """K4 vs K3's plain Gram + tail + K1's plain solve at rank r, on
    (rows, width) ``shapes``: returns the largest |x - x_plain| at f32.
    A row wider than the split width has no repeated column (see
    :func:`check_k3`)."""
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for n, w in shapes:
            V, cols, vals, mask = gather_problem(
                rng, dev, n, w, dtype, dup=w <= core_als.SPLIT_WIDTH, r=r)
            YtY = compute_yty(V.float())
            conf, pref = implicit_weights(vals, mask, ALPHA)
            for name, xk, xp in (
                    ("implicit",
                     cuda_gather_ne.gather_fused_solve_implicit(
                         V, cols, vals, mask, REG, ALPHA, YtY),
                     cuda_gather_ne.gather_solve_plain(
                         V, cols, conf, (1.0 + conf) * pref * mask,
                         pref * mask, YtY, two_sided=False, reg=REG)),
                    ("explicit",
                     cuda_gather_ne.gather_fused_solve_explicit(
                         V, cols, vals, mask, REG),
                     cuda_gather_ne.gather_solve_plain(
                         V, cols, mask, vals * mask, mask, two_sided=True,
                         reg=REG))):
                torch.cuda.synchronize()
                zero = (0, 2) if name == "implicit" else (0,)
                if not all(bool((xk[j] == 0).all()) for j in zero):
                    fail(f"K4 {name} {dtype}: rows {zero} (empty, or no "
                         "positive rating) did not solve to exactly 0")
                err = (xk - xp).abs().max().item()
                if not (torch.isfinite(xk).all() and torch.allclose(
                        xk, xp, rtol=K4_RTOL, atol=K4_ATOL)):
                    fail(f"K4 {name} {dtype} n={n} w={w}: kernel vs plain "
                         f"max |diff| {err:.3e}")
                if dtype == torch.float32:
                    worst = max(worst, err)
                log(f"k4 r={r} {name} {str(dtype)[6:]} n={n} w={w}: max "
                    f"|kernel - plain| {err:.3e} (rtol {K4_RTOL}, atol "
                    f"{K4_ATOL})")
    return worst


def ring_problem(rng, dev, S, per, n, w, dtype, r):
    """``gather_problem`` per (owner, source shard): V_shards [S, per, r]
    unit rows, cols/vals/mask [S, S, n, w] shard-local; on every owner row
    0 is empty, row 1 repeats a column, row 2 has no positive rating."""
    V = torch.from_numpy(unit_rows(rng, S * per, r)).to(dev).to(dtype)
    cols = rng.integers(0, per, (S, S, n, w)).astype(np.int32)
    cols[:, :, 1, 1::2] = cols[:, :, 1, :1]
    vals = (rng.integers(1, 11, (S, S, n, w)) * 0.5).astype(np.float32)
    mask = (rng.random((S, S, n, w)) < 0.8).astype(np.float32)
    mask[:, :, 0] = 0.0
    vals[:, :, 2] = -vals[:, :, 2]
    vals *= mask
    return (V.reshape(S, per, r), torch.from_numpy(cols).to(dev),
            torch.from_numpy(vals).to(dev).to(dtype),
            torch.from_numpy(mask).to(dev).to(dtype))


def check_k7(rng, dev):
    """K7 vs its plain version (K4's plain Gram, tail and solve over each
    owner's ring-ordered stream) at ranks 128, 200 and 256, S = 1, 3 and
    4 shards, explicit and implicit, f32 and bf16, within K4's band; and
    at S = 1, K7 == K4 bit for bit.  Returns the largest |x - x_plain| at
    f32 by rank class (128, 256)."""
    worst = {RANK: 0.0, RANK256: 0.0}
    for r in (RANK, 200, RANK256):
        for S in (1, 3, SHARDS):
            for dtype in (torch.float32, torch.bfloat16):
                for n, w in ((64, 24), (16, 100)):
                    V, cols, vals, mask = ring_problem(rng, dev, S, 2048, n,
                                                       w, dtype, r)
                    YtY = compute_yty(V.reshape(-1, r).float())
                    conf, pref = implicit_weights(vals, mask, ALPHA)
                    for name, xk, xp in (
                            ("implicit",
                             cuda_gather_ne.gather_fused_ring_implicit(
                                 V, cols, vals, mask, REG, ALPHA, YtY),
                             cuda_gather_ne.gather_solve_ring_plain(
                                 V, cols, conf, (1.0 + conf) * pref * mask,
                                 pref * mask, YtY, two_sided=False,
                                 reg=REG)),
                            ("explicit",
                             cuda_gather_ne.gather_fused_ring_explicit(
                                 V, cols, vals, mask, REG),
                             cuda_gather_ne.gather_solve_ring_plain(
                                 V, cols, mask, vals * mask, mask,
                                 two_sided=True, reg=REG))):
                        torch.cuda.synchronize()
                        zero = (0, 2) if name == "implicit" else (0,)
                        if not all(bool((xk[:, j] == 0).all())
                                   for j in zero):
                            fail(f"K7 {name} r={r} S={S}: rows {zero} did "
                                 "not solve to exactly 0")
                        err = (xk - xp).abs().max().item()
                        if not (torch.isfinite(xk).all() and torch.allclose(
                                xk, xp, rtol=K4_RTOL, atol=K4_ATOL)):
                            fail(f"K7 {name} {dtype} r={r} S={S} n={n} "
                                 f"w={w}: kernel vs plain max |diff| "
                                 f"{err:.3e}")
                        if dtype == torch.float32:
                            key = RANK if r <= RANK else RANK256
                            worst[key] = max(worst[key], err)
                        if S == 1:
                            fused = (cuda_gather_ne.gather_fused_solve_implicit
                                     if name == "implicit" else
                                     cuda_gather_ne.gather_fused_solve_explicit)
                            args = ((V[0], cols[0, 0], vals[0, 0], mask[0, 0],
                                     REG) + ((ALPHA, YtY)
                                             if name == "implicit" else ()))
                            if not torch.equal(xk[0], fused(*args)):
                                fail(f"K7 {name} {dtype} r={r} at one shard "
                                     "is not K4 bit for bit")
            log(f"k7 r={r} S={S}: explicit and implicit, f32 and bf16, "
                f"w 24 and 100: within rtol {K4_RTOL}, atol {K4_ATOL} of "
                "plain" + ("; == K4 bitwise" if S == 1 else ""))
    return worst


def tie_corpus(rng, n, ni, r, pool=7):
    """The reference's integer tie corpus: integer factors, the catalog
    from a ``pool``-row palette: every f32 score is exact, ties abound."""
    base = rng.integers(-3, 4, size=(pool, r)).astype(np.float32)
    V = base[rng.integers(0, pool, ni)]
    U = rng.integers(-3, 4, size=(n, r)).astype(np.float32)
    return U, V


def check_k8(rng, dev):
    """K8 vs its plain version, bitwise (scores and ids), and both vs the
    plain top-k over the whole concatenated catalog, on the integer tie
    corpus at 4,096 users x the 59,047-item catalog, r = 16, S = 1, 3, 4
    and 8 shards, k = 10 and 128, ~30 % of items valid and (S > 1) shard 1
    all invalid.  Returns the largest |score - score_plain| (0.0)."""
    U, V = tie_corpus(rng, 4096, N_ITEMS, 16)
    U, V = torch.from_numpy(U).to(dev), torch.from_numpy(V).to(dev)
    for S in (1, 3, SHARDS, 8):
        ni_loc = -(-N_ITEMS // S)
        Vp = torch.zeros(S * ni_loc, 16, device=dev)
        Vp[:N_ITEMS] = V
        validp = torch.zeros(S * ni_loc, dtype=torch.bool, device=dev)
        validp[:N_ITEMS] = torch.from_numpy(rng.random(N_ITEMS) < 0.3)
        if S > 1:
            validp[ni_loc:2 * ni_loc] = False
        Vs, vs = Vp.reshape(S, ni_loc, 16), validp.reshape(S, ni_loc)
        for k in (10, 128):
            sk, ik = cuda_topk.topk_merge_ring(U, Vs, vs, k)
            sp, ip = cuda_topk.topk_merge_ring_plain(U, Vs, vs, k)
            sc, ic = chunked_topk_scores(U, Vp, validp, k)
            torch.cuda.synchronize()
            for what, (s, i) in (("plain", (sp, ip)),
                                 ("the whole-catalog top-k", (sc, ic))):
                if not (torch.equal(sk, s) and torch.equal(ik, i)):
                    bad = int((ik != i).any(dim=1).sum())
                    fail(f"K8 S={S} k={k}: not bitwise {what} (scores max "
                         f"|diff| {(sk - s).abs().max().item():.3e}, "
                         f"{bad} rows with other ids)")
            if S > 1 and bool(((ik >= ni_loc) & (ik < 2 * ni_loc)
                               & (sk > NEG_INF32)).any()):
                fail(f"K8 S={S}: an item of the all-invalid shard came back")
        log(f"k8 S={S} n=4096 Ni={N_ITEMS} r=16 k=10 and 128: bitwise plain "
            "and the whole-catalog top-k (tie corpus)")
    return 0.0


# -- phase 5 ---------------------------------------------------------------
def layout(csr, side):
    widths = [(b.width, int((b.rows < csr.num_rows).sum()))
              for b in csr.buckets]
    log(f"{side}: {csr.num_rows} rows, padded nnz {csr.padded_nnz}, "
        f"{len(csr.buckets)} buckets, widest (width, rows) {widths[-4:]}, "
        f"max degree {int(csr.counts.max())}")
    for r in (RANK, RANK256):
        cfg = core_als.AlsConfig(rank=r, implicit_prefs=True)
        routes = {}
        for w, _ in widths:
            routes.setdefault(core_als.resolve_solve_path(cfg, r, w),
                              []).append(w)
        for label, ws in routes.items():
            log(f"  rank {r} route {label}: widths {ws}")


def row_rel(x, ref):
    return ((x - ref).norm(dim=1)
            / ref.norm(dim=1).clamp(min=1e-30)).max().item()


def f64_rel(x, V, csr):
    """max |x[row] - x64| / |x64| over the heaviest row of every bucket of
    width >= 8192, where x64 solves the same implicit normal equations
    against the same V in float64: the error of a route, not a
    difference between two routes."""
    dev = V.device
    V64 = V.double()
    Y64 = V64.T @ V64
    eye = torch.eye(V.shape[1], dtype=torch.float64, device=dev)
    worst = 0.0
    for b in csr.buckets:
        pos = np.flatnonzero(b.rows < csr.num_rows)
        if b.width < 8192 or not len(pos):
            continue
        k = pos[np.argmax(csr.counts[b.rows[pos]])]
        Vg = V64[torch.from_numpy(b.cols[k].astype(np.int64)).to(dev)]
        vals = torch.from_numpy(b.vals[k]).to(dev).double()
        mask = torch.from_numpy(b.mask[k]).to(dev).double()
        conf, pref = ALPHA * vals.abs() * mask, (vals > 0).double()
        A = (Vg * conf[:, None]).T @ Vg + Y64 \
            + (REG * (pref * mask).sum() + 1e-6) * eye
        x64 = torch.linalg.solve(A, ((1.0 + conf) * pref * mask) @ Vg)
        worst = max(worst, ((x[int(b.rows[k])].double() - x64).norm()
                            / x64.norm()).item())
    return worst


def prepare(seed, dev):
    """The ML-25M-shaped ratings and their bucketed layout both ways,
    made once for the training slices at both ranks."""
    t0 = time.perf_counter()
    frame = synthetic_movielens(*ML25M_SHAPE, seed=seed)
    log(f"synthetic_movielens{ML25M_SHAPE}: "
        f"{time.perf_counter() - t0:.1f} s (host)")
    u_idx, umap = remap_ids(frame["user"])
    i_idx, imap = remap_ids(frame["item"])
    r = frame["rating"]
    t0 = time.perf_counter()
    ucsr = build_csr_buckets(u_idx, i_idx, r, len(umap))
    t1 = time.perf_counter()
    icsr = build_csr_buckets(i_idx, u_idx, r, len(imap))
    t2 = time.perf_counter()
    log(f"host blocking: users {t1 - t0:.2f} s, items {t2 - t1:.2f} s")
    layout(ucsr, "users")
    layout(icsr, "items")
    return {"frame": frame, "ucsr": ucsr, "icsr": icsr,
            "ub": ucsr.to(dev), "ib": icsr.to(dev),
            "n_users": len(umap), "n_items": len(imap),
            "u_idx": u_idx, "i_idx": i_idx, "r": r}


def _launch_counts():
    return {"k1": cuda_solve.LAUNCHES, "k2": cuda_lanes.LAUNCHES,
            "k3": cuda_gather_ne.GRAM_LAUNCHES,
            "k4": cuda_gather_ne.SOLVE_LAUNCHES,
            "k6": cuda_lanes_blocked.LAUNCHES, "k5": cuda_topk.LAUNCHES,
            "k7": cuda_gather_ne.RING_LAUNCHES,
            "k8": cuda_topk.MERGE_LAUNCHES}


def _zero_launches():
    cuda_solve.LAUNCHES = cuda_lanes.LAUNCHES = 0
    cuda_gather_ne.GRAM_LAUNCHES = cuda_gather_ne.SOLVE_LAUNCHES = 0
    cuda_lanes_blocked.LAUNCHES = cuda_topk.LAUNCHES = 0
    cuda_gather_ne.RING_LAUNCHES = cuda_topk.MERGE_LAUNCHES = 0


def train_slice(data, r, seed, dev):
    """The training slice at the full ML-25M shape and rank r (the
    kernels of the path: K4, K3 and K1 at rank 128; K4, K3 and K6 above);
    returns what the timings and the profile reuse."""
    path = ("k1", "k3", "k4") if r <= 128 else ("k3", "k4", "k6")
    n_users, n_items = data["n_users"], data["n_items"]
    ticks = []

    def tick(it, U, V):
        torch.cuda.synchronize()
        ticks.append(time.perf_counter())

    est = ALS(rank=r, implicitPrefs=True, alpha=ALPHA, regParam=REG,
              maxIter=3, fitCallback=tick)
    _zero_launches()
    t0 = time.perf_counter()
    model = est.fit(data["frame"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = _launch_counts()
    launches = {k: counts[k] for k in path}
    log(f"rank {r} fit launches: " + ", ".join(
        f"{k.upper()} {v}" for k, v in counts.items() if v))
    if min(launches.values()) == 0:
        fail(f"a kernel of the rank-{r} training path never launched: "
             f"{launches}")
    iter_s = [b - a for a, b in zip(ticks, ticks[1:])]
    log(f"rank {r} fit: {fit_s:.2f} s wall (host remap and blocking "
        f"included); iterations 2-3 wall "
        f"{', '.join(f'{x * 1e3:.1f}' for x in iter_s)} ms")
    if not (torch.isfinite(model._U).all() and torch.isfinite(model._V).all()):
        fail(f"the rank-{r} fitted factors are not finite")
    if model._U.shape != (n_users, r) or model._V.shape != (n_items, r):
        fail(f"factor shapes {tuple(model._U.shape)}, {tuple(model._V.shape)}")

    # one iteration from one init: 'auto' (K4 + K3/K1 or K3/K6) vs
    # 'unfused' (torch normal equations + K2 or K6)
    ub, ib = data["ub"], data["ib"]
    g = torch.Generator().manual_seed(seed)
    U0 = core_als.init_factors(n_users, r, g).to(dev)
    V0 = core_als.init_factors(n_items, r, g).to(dev)
    cfg = core_als.AlsConfig(rank=r, implicit_prefs=True, alpha=ALPHA,
                             reg_param=REG)
    out = {}
    for backend in ("auto", "unfused"):
        out[backend] = core_als.als_step(
            U0, V0, ub, ib, n_users, n_items,
            dataclasses.replace(cfg, solve_backend=backend))
    torch.cuda.synchronize()
    (Ua, Va), (Uu, Vu) = out["auto"], out["unfused"]
    eu, ev = row_rel(Ua, Uu), row_rel(Va, Vu)
    log(f"rank {r}: one iteration 'auto' vs 'unfused': max per-row "
        f"|diff|/|x| users {eu:.3e}, items {ev:.3e} (tol {TRAIN_REL})")
    icsr, ucsr = data["icsr"], data["ucsr"]
    e64 = {"items auto": f64_rel(Va, U0, icsr),
           "items unfused": f64_rel(Vu, U0, icsr),
           "users auto": f64_rel(Ua, Va, ucsr),
           "users unfused": f64_rel(Uu, Vu, ucsr)}
    log(f"rank {r}: heaviest rows of the buckets of width >= 8192 vs "
        "float64: " + ", ".join(f"{k} {v:.3e}" for k, v in e64.items())
        + f" (tol {TRAIN_REL})")
    if not (eu <= TRAIN_REL and ev <= TRAIN_REL):
        fail(f"rank {r}: 'auto' and 'unfused' disagree: users {eu:.3e}, "
             f"items {ev:.3e}")
    if max(e64.values()) > TRAIN_REL:
        fail(f"rank {r}: a route is off the float64 solution: {e64}")
    return {"launches": launches, "iter_s": iter_s, "ub": ub, "ib": ib,
            "U0": U0, "V0": V0, "cfg": cfg, "n_items": n_items,
            "n_users": n_users, "model": model}


def sharded_train_slice(data, seed, dev):
    """Sharded training at the ML-25M shape, rank 128, implicit: SHARDS
    logical shards on the card, the ring's owner x source grid (host
    seconds, padded entries), then ``train_sharded(strategy='ring')`` with
    ``solve_backend='gather_fused_ring'`` (K7) for 2 iterations from the
    injected init of a 2-iteration single-device fit, row by row within
    TRAIN_REL of it (and both against float64 on the heaviest users), and
    one iteration of the unfused ring (torch normal equations + K2) on the
    same grid against the fused ring's first.  Returns what the timings
    reuse."""
    mesh = make_mesh(devices=[dev] * SHARDS)
    u_idx, i_idx, r = data["u_idx"], data["i_idx"], data["r"]
    n_users, n_items = data["n_users"], data["n_items"]
    upart = partition_balanced(np.bincount(u_idx, minlength=n_users), SHARDS)
    ipart = partition_balanced(np.bincount(i_idx, minlength=n_items), SHARDS)
    t0 = time.perf_counter()
    ush = shard_csr_grid(upart, ipart, u_idx, i_idx, r)
    t1 = time.perf_counter()
    ish = shard_csr_grid(ipart, upart, i_idx, u_idx, r)
    t2 = time.perf_counter()
    counts = (stacked_counts(upart, u_idx, r, positive_only=True),
              stacked_counts(ipart, i_idx, r, positive_only=True))
    for side, g, sd in (("users", ush, t1 - t0), ("items", ish, t2 - t1)):
        widest = g.buckets[-1]
        log(f"ring grid {side} ({SHARDS} shards): shard_csr_grid {sd:.2f} s "
            f"(host), {g.padded_nnz} padded entries for {g.nnz} ratings in "
            f"{len(g.buckets)} buckets, widest {SHARDS} x "
            f"{widest.cols.shape[-1]} entries per row")
    g = torch.Generator().manual_seed(seed)
    U0 = core_als.init_factors(n_users, RANK, g)
    V0 = core_als.init_factors(n_items, RANK, g)
    cfg = core_als.AlsConfig(rank=RANK, max_iter=2, implicit_prefs=True,
                             alpha=ALPHA, reg_param=REG,
                             solve_backend="gather_fused_ring")
    ticks, first = [time.perf_counter()], {}

    def tick(it, U, V):
        torch.cuda.synchronize()
        ticks.append(time.perf_counter())
        if it == 1:
            first["U"], first["V"] = U.clone(), V.clone()

    _zero_launches()
    ticks[0] = time.perf_counter()
    Us, Vs = train_sharded(mesh, upart, ipart, ush, ish, cfg, callback=tick,
                           strategy="ring", ring_counts=counts,
                           init=(U0, V0))
    torch.cuda.synchronize()
    launches = _launch_counts()
    log("sharded fit launches: " + ", ".join(
        f"{k.upper()} {v}" for k, v in launches.items() if v))
    if launches["k7"] == 0:
        fail(f"K7 never launched on the sharded training path: {launches}")
    iter_s = [b - a for a, b in zip(ticks, ticks[1:])]
    log(f"sharded fit ({SHARDS} logical shards, ring, gather_fused_ring): "
        f"iterations 1-2 wall {', '.join(f'{x * 1e3:.1f}' for x in iter_s)}"
        " ms (iteration 1 includes moving the grid to the card)")
    U, V = entity_rows(upart, Us), entity_rows(ipart, Vs)
    if not (torch.isfinite(U).all() and torch.isfinite(V).all()):
        fail("the sharded fit's factors are not finite")
    # the single-device fit from the same init
    one = dataclasses.replace(cfg, solve_backend="auto")
    U1, V1 = U0.to(dev), V0.to(dev)
    for _ in range(2):
        U1, V1 = core_als.als_step(U1, V1, data["ub"], data["ib"], n_users,
                                   n_items, one)
    eu, ev = row_rel(U, U1), row_rel(V, V1)
    e64 = {"sharded": f64_rel(U, V, data["ucsr"]),
           "single-device": f64_rel(U1, V1, data["ucsr"])}
    log(f"sharded vs single-device fit, 2 iterations: max per-row "
        f"|diff|/|x| users {eu:.3e}, items {ev:.3e} (tol {TRAIN_REL}); "
        "heaviest users vs float64: " + ", ".join(
            f"{k} {v:.3e}" for k, v in e64.items()))
    if not (eu <= TRAIN_REL and ev <= TRAIN_REL):
        fail(f"the sharded fit is off the single-device fit: users "
             f"{eu:.3e}, items {ev:.3e}; float64: {e64}")
    # the unfused ring, one iteration on the same grid
    unfused = dataclasses.replace(cfg, max_iter=1, solve_backend="auto")
    _zero_launches()
    Uu, Vu = train_sharded(mesh, upart, ipart, ush, ish, unfused,
                           strategy="ring", ring_counts=counts,
                           init=(U0, V0))
    torch.cuda.synchronize()
    unf = _launch_counts()
    if unf["k2"] == 0 or unf["k7"] != 0:
        fail(f"the unfused ring's launches: {unf}")
    eu1, ev1 = row_rel(Uu, first["U"]), row_rel(Vu, first["V"])
    log(f"unfused ring (K2 {unf['k2']} launches) vs the fused ring, one "
        f"iteration: max per-row |diff|/|x| users {eu1:.3e}, items "
        f"{ev1:.3e} (tol {TRAIN_REL})")
    if not (eu1 <= TRAIN_REL and ev1 <= TRAIN_REL):
        fail(f"the unfused and fused rings disagree: {eu1:.3e}, {ev1:.3e}")
    return {"launches": launches, "iter_s": iter_s, "ish": ish,
            "icounts": counts[1], "U0": slot_rows(upart, U0.to(dev)),
            "mesh": mesh}


# -- phase 6 ---------------------------------------------------------------
def foldin_batch(rng, n_users, existing, first_new, items):
    """Hourly-style batch: ``n_users`` distinct ids, half of them new,
    power-law rating counts capped at 256, half-star ratings of ids drawn
    from ``items``."""
    half = n_users // 2
    users = np.concatenate([
        rng.choice(existing, half, replace=False),
        first_new + np.arange(n_users - half)])
    counts = np.minimum(256, 1 + (rng.pareto(0.8, n_users) * 4)
                        .astype(np.int64))
    u = np.repeat(users, counts)
    i = rng.choice(items, len(u))
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
                                  np.arange(N_ITEMS))
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
                          N_USERS + 4096 * (j + 1), np.arange(N_ITEMS))[0]
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
    check_recommend_all(model, rec_ids, rec_scores, rng, dev,
                        "recommend_arrays")
    known = ((model._user_map.to_dense(pairs["user"]) >= 0)
             & (model._item_map.to_dense(pairs["item"]) >= 0))
    if not (np.isfinite(preds[known]).all() and np.isnan(preds[~known]).all()):
        fail("transform: NaN exactly where an id is unknown was violated")
    log(f"recommend_arrays: {n_all} users x k=10 in {rec_wall * 1e3:.1f} ms "
        "(host clock, results on the host)")
    log(f"fold-in p50 latency: {p50 * 1e3:.1f} ms over "
        f"{n_user_batches} user batches of 4096 users")
    return model, launches, A_slice, b_slice


def check_recommend_all(model, rec_ids, rec_scores, rng, dev, where):
    """recommend_arrays' scores against the plain top-k on 2,048 sampled
    users, and each id earning its score."""
    n_all = model._U.shape[0]
    if rec_ids.shape != (n_all, 10) or not np.isfinite(rec_scores).all():
        fail(f"{where}: recommend_arrays shape {rec_ids.shape} for {n_all} "
             "users")
    sample = torch.from_numpy(rng.choice(n_all, 2048, replace=False)).to(dev)
    Us = model._U[sample]
    valid_all = torch.ones(model._V.shape[0], dtype=torch.bool, device=dev)
    sp, _ = chunked_topk_scores(Us, model._V, valid_all, 10)
    dense_ids = torch.from_numpy(
        model._item_map.to_dense(rec_ids[sample.cpu().numpy()])).to(dev)
    got = torch.from_numpy(rec_scores[sample.cpu().numpy()]).to(dev)
    if not torch.allclose(got, sp, rtol=K5_TOL, atol=K5_TOL):
        fail(f"{where}: recommend_arrays scores differ from the plain top-k")
    earns_scores(Us, model._V, valid_all, got, dense_ids, where)


def serve_slice_256(fitted, rng, dev):
    """Serving at rank 256: the rank-256 fit's factors carried by
    ``model_from_arrays`` through save/load, ``FoldInServer.update`` on
    two hourly-style batches of 4,096 users, half new (K6), then
    ``recommendForUserSubset`` and ``recommend_arrays`` for all users (K5
    at r = 256), with K6/K5 launch counts read around the run.  Returns
    the model, the launches and batch 1's regularized systems."""
    r = RANK256
    uids, iids = fitted._user_map.ids, fitted._item_map.ids
    U0, V0 = fitted._U.cpu().numpy(), fitted._V.cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/model"
        model_from_arrays(r, uids, U0, iids, V0, fitted._params,
                          device=dev).save(path)
        model = ALSModel.load(path)            # device=None -> cuda
    if model.rank != r or not torch.equal(model._U.cpu(),
                                          torch.from_numpy(U0)):
        fail("rank 256: save/load did not round-trip the user factors")
    first_new = int(uids.max()) + 1
    batches = [foldin_batch(rng, 4096, uids, first_new + 4096 * j, iids)
               for j in range(2)]
    batch1, users1 = batches[0]
    touched_ref, cols, vals, mask = pack_rows(
        batch1["user"], model._item_map.to_dense(batch1["item"]),
        batch1["rating"])
    A, b, count = normal_eqs(
        model._V, torch.from_numpy(cols).to(dev),
        torch.from_numpy(vals).to(dev), torch.from_numpy(mask).to(dev),
        REG, implicit_prefs=True, alpha=ALPHA, YtY=compute_yty(model._V))
    A_slice, b_slice = regularize(A, count), b.contiguous()
    del A, b
    x_ref = cuda_lanes_blocked.substitute(
        cuda_lanes_blocked.chol_lanes_blocked_plain(A_slice.clone()),
        b_slice)

    srv = FoldInServer(model)
    _zero_launches()
    touched = srv.update(batch1)
    x1 = model._U[torch.from_numpy(
        model._user_map.to_dense(touched)).to(dev)].clone()
    srv.update(batches[1][0])
    p50 = srv.latency(0.5)
    recs = model.recommendForUserSubset({"user": users1}, 10)
    t0 = time.perf_counter()
    _, rec_ids, rec_scores = model.recommend_arrays(10)
    rec_wall = time.perf_counter() - t0
    launches = {"k6": cuda_lanes_blocked.LAUNCHES, "k5": cuda_topk.LAUNCHES}
    log(f"rank 256 serving launches: K6 {launches['k6']}, K5 "
        f"{launches['k5']} (K2 {cuda_lanes.LAUNCHES}, K1 "
        f"{cuda_solve.LAUNCHES})")
    if launches["k6"] == 0 or launches["k5"] == 0:
        fail(f"a kernel of the rank-256 serving path never launched: "
             f"{launches}")

    if not np.array_equal(touched, touched_ref):
        fail("rank 256: fold-in touched set differs from the packed batch")
    rel = ((x1 - x_ref).norm(dim=1) / x_ref.norm(dim=1).clamp(min=1e-30))
    rel_max = rel.max().item()
    if not torch.isfinite(x1).all() or rel_max > FOLDIN_REL:
        fail(f"rank 256 fold-in vs plain on the card: max rel err "
             f"{rel_max:.3e}")
    log(f"rank 256 fold-in batch 1 ({len(touched)} users, "
        f"{len(batch1['user'])} ratings): max |x - x_plain|/|x_plain| "
        f"{rel_max:.3e} (tol {FOLDIN_REL})")
    new_users = set(users1[users1 >= first_new].tolist())
    rows = [j for j, u in enumerate(recs["user"]) if int(u) in new_users]
    sc = recs["recommendations"]["rating"][rows]
    if len(rows) != len(new_users) or not (
            np.isfinite(sc).all() and (np.diff(sc, axis=1) <= 0).all()):
        fail("rank 256: new users' recommendations missing, not finite or "
             "not sorted")
    check_recommend_all(model, rec_ids, rec_scores, rng, dev,
                        "rank 256 recommend_arrays")
    log(f"rank 256 recommend_arrays: {model._U.shape[0]} users x k=10 in "
        f"{rec_wall * 1e3:.1f} ms (host clock, results on the host)")
    log(f"rank 256 fold-in p50 latency: {p50 * 1e3:.1f} ms over "
        f"{len(srv.stats)} user batches of 4096 users")
    return model, launches, A_slice, b_slice


def sharded_serve_slice(model, mesh, dev):
    """recommend-all through ``recommend_arrays(10, mesh=...,
    gatherStrategy='merge_ring')`` (K8) for every user of ``model``, with
    K8's launches read around it, its wall and device time, then its
    scores against the single-device K5 sweep (within SERVE_ULPS ulp),
    each id earning its score, and the ids that differ from K5's
    counted."""
    _zero_launches()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    _, ids, scores = model.recommend_arrays(10, mesh=mesh,
                                            gatherStrategy="merge_ring")
    e1.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = _launch_counts()
    log(f"sharded serving launches: K8 {launches['k8']} (K5 "
        f"{launches['k5']})")
    if launches["k8"] == 0:
        fail(f"K8 never launched on the sharded serving path: {launches}")
    n = model._U.shape[0]
    _, ids1, sc1 = model.recommend_arrays(10)  # single device: K5
    if ids.shape != (n, 10) or not np.isfinite(scores).all():
        fail(f"sharded recommend_arrays: shape {ids.shape} for {n} users")
    ulps = np.abs(scores - sc1) / np.spacing(np.abs(sc1))
    if ulps.max() > SERVE_ULPS:
        fail(f"sharded scores {ulps.max():.1f} ulp off the K5 sweep")
    dense = torch.from_numpy(model._item_map.to_dense(ids)).to(dev)
    valid = torch.ones(model._V.shape[0], dtype=torch.bool, device=dev)
    err = earns_scores(model._U, model._V, valid,
                       torch.from_numpy(scores).to(dev), dense,
                       "sharded recommend_arrays")
    log(f"sharded recommend_arrays ({SHARDS} logical shards, merge_ring): "
        f"{n} users x k=10 in {wall:.1f} ms wall, {e0.elapsed_time(e1):.1f} "
        f"ms by CUDA events (results on the host); scores vs the K5 sweep "
        f"max {ulps.max():.1f} ulp (tol {SERVE_ULPS}), each id earns its "
        f"score ({err:.3e}); rows whose ids differ from K5's: "
        f"{int((ids != ids1).any(axis=1).sum())}")
    return launches


# -- phase 7 ---------------------------------------------------------------
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
    log(f"timing K1 on the same systems: kernel_ms="
        f"{cuda_ms(lambda: cuda_solve.spd_solve_blocked(A, b), 20):.4f}")
    log(f"timing K5 n={n} Ni={Ni} r={r} k={k}: kernel_ms={k_ms5:.4f} "
        f"plain_ms={p_ms5:.4f} library_ms={l_ms5:.4f} bound_ms={b_ms5:.4f} "
        f"({by5}) launches={launches['k5']}")
    return out


def train_timings(tr, errs, dev):
    """K3, K4 and the wide rows' solve kernel (K1 at rank 128, K6 at
    rank 256) at the training slice's shapes: every bucket of the item
    half-step (from the seeded init) that each kernel takes.  One pass of
    K4 and of K3 over those buckets is also held against its plain
    version (K4_RTOL/K4_ATOL, K3_REL), and the larger of that error and
    phase 4's is the kernel's ``max_abs_err``."""
    out = []
    ib, U0, cfg = tr["ib"], tr["U0"], tr["cfg"]
    r = U0.shape[1]
    tag = "" if r == RANK else f", rank {r}"
    sfx = "" if r == RANK else f"_{r}"
    n_items = tr["n_items"]
    YtY = compute_yty(U0)
    split = core_als.SPLIT_WIDTH

    def route(b):
        return core_als.resolve_solve_path(cfg, r, b.width)

    k4_b = [b for b in ib if route(b) == "gatherfused_solve"]
    k3_b = [b for b in ib if route(b).startswith("gatherfused+")]

    # K4: one launch per K4 bucket; yardstick: the 'unfused' half-step
    # over the same buckets (V[cols], torch normal equations, K2)
    def k4():
        return [cuda_gather_ne.gather_fused_solve_implicit(
            U0, b.cols, b.vals, b.mask, REG, ALPHA, YtY) for b in k4_b]

    def k4_plain():
        xs = []
        for b in k4_b:
            conf, pref = implicit_weights(b.vals, b.mask, ALPHA)
            bw, cw = (1.0 + conf) * pref * b.mask, pref * b.mask
            step = max(1, min(4096, (1 << 28) // (b.width * r)))
            for s in range(0, b.cols.shape[0], step):
                sl = slice(s, s + step)
                xs.append(cuda_gather_ne.gather_solve_plain(
                    U0, b.cols[sl], conf[sl], bw[sl], cw[sl], YtY,
                    two_sided=False, reg=REG))
        return xs

    unfused = dataclasses.replace(cfg, solve_backend="unfused")

    def k4_lib():
        core_als.local_half_step(U0, k4_b, n_items, unfused, YtY)

    xp, p4 = timed(lambda: torch.cat(k4_plain()))
    xk = torch.cat(k4())
    torch.cuda.synchronize()
    e4 = (xk - xp).abs().max().item()
    if not (torch.isfinite(xk).all() and torch.allclose(
            xk, xp, rtol=K4_RTOL, atol=K4_ATOL)):
        fail(f"K4 on the item half-step's buckets: kernel vs plain max "
             f"|diff| {e4:.3e}")
    log(f"k4 r={r} item half-step ({len(k4_b)} buckets, widths up to "
        f"{k4_b[-1].width}): max |kernel - plain| {e4:.3e} (rtol "
        f"{K4_RTOL}, atol {K4_ATOL})")
    del xk, xp

    P, E, n = gram_work(k4_b, n_items)
    ms4 = cuda_ms(k4, 3)
    b4, by4 = bound(P * 16 + E * r * 4 + n * r * 4, gram_flops(E, n, r))
    l4 = cuda_ms(k4_lib, 1)
    out.append({"name": f"gather_solve (K4{tag})", "route": "cuda",
                "source": "tpu_als_torch/csrc/gather_solve.cu",
                "replaces": "tpu_als/ops/pallas_gather_ne.py:396",
                "launches": tr["launches"]["k4"],
                "max_abs_err": max(errs["k4" + sfx], e4),
                "ms": ms4, "plain_ms": p4, "bound_ms": b4, "bound_by": by4,
                "library_ms": l4})
    log(f"timing K4 r={r} item half-step, {len(k4_b)} buckets, {n} real "
        f"rows, {E} real of {P} padded entries: kernel_ms={ms4:.4f} "
        f"plain_ms={p4:.4f} library_ms={l4:.4f} (unfused half-step) "
        f"bound_ms={b4:.4f} ({by4}) launches/fit={tr['launches']['k4']}")

    # K3: the wide buckets, width split over blocks; yardstick V[cols] +
    # bmm
    pre = []
    for b in k3_b:
        conf, pref = implicit_weights(b.vals, b.mask, ALPHA)
        pre.append((b.cols, conf, (1.0 + conf) * pref * b.mask))

    def k3():
        return [cuda_gather_ne.gather_gram(U0, c, aw, bw, two_sided=False,
                                           split_width=split)
                for c, aw, bw in pre]

    def k3_plain(V=U0):
        return [cuda_gather_ne.gather_gram_plain(
            V, c, aw, bw, two_sided=False, split_width=split)
            for c, aw, bw in pre]

    def k3_lib():
        for c, aw, bw in pre:
            Vg = U0[c.long()]
            torch.bmm((Vg * aw[..., None]).transpose(1, 2), Vg)
            torch.bmm(bw[:, None, :], Vg)

    # the weights are >= 0, so |V| alone gives each entry's Σ|terms|
    e3 = {"S": 0.0, "b": 0.0}
    worst3 = 0.0
    plain3, p3 = timed(k3_plain)
    for (S, b), (Sp, bp), (Sa, ba) in zip(k3(), plain3, k3_plain(
            U0.abs())):
        e3["S"] = max(e3["S"], rel_err(S, Sp, Sa))
        e3["b"] = max(e3["b"], rel_err(b, bp, ba))
        worst3 = max(worst3, (S - Sp).abs().max().item())
    del plain3
    if not max(e3.values()) <= K3_REL:
        fail(f"K3 on the item half-step's wide buckets: relative |diff| "
             f"S {e3['S']:.3e}, b {e3['b']:.3e}")
    log(f"k3 r={r} item half-step ({len(k3_b)} wide buckets, widths up to "
        f"{k3_b[-1].width}): max |kernel - plain| / Σ|terms| S "
        f"{e3['S']:.3e}, b {e3['b']:.3e} (tol {K3_REL}); max |kernel - "
        f"plain| {worst3:.3e}")

    P3, E3, n3 = gram_work(k3_b, n_items)
    ms3 = cuda_ms(k3, 3)
    l3 = cuda_ms(k3_lib, 1)
    b3, by3 = bound(P3 * 12 + E3 * r * 4 + n3 * (r * r + r) * 4,
                    gram_flops(E3, 0, r))
    out.append({"name": f"gather_gram (K3{tag})", "route": "cuda",
                "source": "tpu_als_torch/csrc/gather_gram.cu",
                "replaces": "tpu_als/ops/pallas_gather_ne.py:167",
                "launches": tr["launches"]["k3"],
                "max_abs_err": max(errs["k3" + sfx], worst3),
                "ms": ms3, "plain_ms": p3, "bound_ms": b3, "bound_by": by3,
                "library_ms": l3})
    log(f"timing K3 r={r} item half-step, {len(k3_b)} wide buckets, {n3} real "
        f"rows, {E3} real of {P3} padded entries: kernel_ms={ms3:.4f} "
        f"plain_ms={p3:.4f} library_ms={l3:.4f} bound_ms={b3:.4f} ({by3}) "
        f"launches/fit={tr['launches']['k3']}")

    # the regularized systems of those wide rows (real rows only): K1 at
    # rank 128; K6 (with K1 beside it) at rank 256
    As, bs = [], []
    for b in k3_b:
        A, rhs, count = cuda_gather_ne.gather_normal_eq_implicit(
            U0, b.cols, b.vals, b.mask, REG, ALPHA, YtY, split_width=split)
        real = b.rows < n_items
        As.append(regularize(A, count)[real])
        bs.append(rhs[real])
    A1, b1 = torch.cat(As).contiguous(), torch.cat(bs).contiguous()
    if r > RANK:
        out.append(k6_timings(A1, b1, tr["launches"]["k6"], errs["k6"],
                              "the fit's wide rows"))
        return out
    N1 = A1.shape[0]
    ms1 = cuda_ms(lambda: cuda_solve.spd_solve_blocked(A1, b1), 20)
    p1 = cuda_ms(lambda: cuda_solve.chol_blocked_plain(A1, b1), 2)
    l1 = cuda_ms(lambda: torch.cholesky_solve(
        b1[..., None], torch.linalg.cholesky(A1)), 20)
    b1_ms, by1 = bound((N1 * r * (r + 1) // 2 + 2 * N1 * r) * 4,
                       N1 * (r ** 3 / 3 + 2 * r * r))
    out.append({"name": "spd_solve_pallas (K1)", "route": "cuda",
                "source": "tpu_als_torch/csrc/chol_blocked.cu",
                "replaces": "tpu_als/ops/pallas_solve.py:199",
                "launches": tr["launches"]["k1"], "max_abs_err": errs["k1"],
                "ms": ms1, "plain_ms": p1, "bound_ms": b1_ms,
                "bound_by": by1, "library_ms": l1})
    log(f"timing K1 N={N1} r={r} (the wide buckets' real rows): "
        f"kernel_ms={ms1:.4f} "
        f"plain_ms={p1:.4f} library_ms={l1:.4f} bound_ms={b1_ms:.4f} "
        f"({by1}) launches/fit={tr['launches']['k1']}")
    return out


def kernel_ms_each(setup, fn, reps):
    """Mean milliseconds of ``fn`` alone over ``reps`` calls, each after
    an untimed ``setup()`` (K6 writes over its input, which is restored
    before every call), after one warm-up."""
    setup()
    fn()
    total = 0.0
    for _ in range(reps):
        setup()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        total += t0.elapsed_time(t1)
    return total / reps


def k6_timings(A, b, launches, err, what):
    """K6 on the systems A [N, r, r] (regularized), b [N, r]: its time
    beside its plain version's, ``torch.linalg.cholesky``'s and its bound
    (reading the lower triangle once, writing the whole square: L with
    zeros above the diagonal goes over A's symmetric input), the two
    substitutions beside theirs, and K1 on the same systems; K6 is held
    against its plain version here too (K6_REL).  Returns K6's row."""
    N, r = b.shape
    Aw = torch.empty_like(A)

    def restore():
        Aw.copy_(A)

    L = cuda_lanes_blocked.chol_lanes_blocked(A.clone())
    Lp = cuda_lanes_blocked.chol_lanes_blocked_plain(A.clone())
    torch.cuda.synchronize()
    e6 = (L - Lp).abs().max().item()
    rel = e6 / Lp.abs().max().item()
    if not (torch.isfinite(L).all() and rel <= K6_REL):
        fail(f"K6 on {what}: max |L - L_plain| {e6:.3e}, {rel:.3e} of "
             "max |L|")
    del Lp
    ms6 = kernel_ms_each(
        restore, lambda: cuda_lanes_blocked.chol_lanes_blocked(Aw), 10)
    p6 = cuda_ms(lambda: cuda_lanes_blocked.chol_lanes_blocked_plain(
        A.clone()), 1)
    l6 = cuda_ms(lambda: torch.linalg.cholesky(A), 10)
    b6, by6 = bound(N * (r * (r + 1) // 2 + r * r) * 4, N * r ** 3 / 3)
    ms_s = cuda_ms(lambda: cuda_lanes_blocked.substitute(L, b), 10)
    bs_, bys = bound(N * (r * (r + 1) // 2 + 2 * r) * 4, N * 2 * r * r)
    ms1 = cuda_ms(lambda: cuda_solve.spd_solve_blocked(A, b), 10)
    b1, by1 = bound((N * r * (r + 1) // 2 + 2 * N * r) * 4,
                    N * (r ** 3 / 3 + 2 * r * r))
    log(f"timing K6 N={N} r={r} ({what}): kernel_ms={ms6:.4f} "
        f"plain_ms={p6:.4f} library_ms={l6:.4f} (linalg.cholesky) "
        f"bound_ms={b6:.4f} ({by6}) launches={launches}; max |L - L_plain| "
        f"{e6:.3e} ({rel:.3e} of max |L|)")
    log(f"timing substitutions N={N} r={r} ({what}, two solve_triangular): "
        f"ms={ms_s:.4f} bound_ms={bs_:.4f} ({bys}); K6 + substitutions "
        f"{ms6 + ms_s:.4f} ms")
    log(f"timing K1 on the same systems N={N} r={r} ({what}): "
        f"kernel_ms={ms1:.4f} bound_ms={b1:.4f} ({by1})")
    return {"name": "chol_lanes_blocked (K6, rank 256)", "route": "cuda",
            "source": "tpu_als_torch/csrc/chol_lanes_blocked.cu",
            "replaces": "tpu_als/ops/pallas_lanes_blocked.py:181",
            "launches": launches, "max_abs_err": max(err, e6),
            "ms": ms6, "plain_ms": p6, "bound_ms": b6, "bound_by": by6,
            "library_ms": l6}


def ring_timings(sh, tr, errs, dev):
    """K7 at the sharded slice's shapes: every bucket of the item
    half-step's ring grid (the ring routes every width through K7) from
    the seeded init, with each bucket's time and the widest bucket's
    share; its plain version on the same pass, held to K4's band on the
    buckets up to the split width (past it the plain version's long bmm
    chains drift); the unfused ring half-step as the yardstick; the
    bound in K4's closed form on the real entries and rows.  First, K7 at
    one shard against K4 bit for bit on the single-device item
    half-step's K4 buckets."""
    U1, r = tr["U0"], RANK
    Y1 = compute_yty(U1)
    k4_b = [b for b in tr["ib"]
            if core_als.resolve_solve_path(tr["cfg"], r, b.width)
            == "gatherfused_solve"]
    for b in k4_b:
        x4 = cuda_gather_ne.gather_fused_solve_implicit(
            U1, b.cols, b.vals, b.mask, REG, ALPHA, Y1)
        x7 = cuda_gather_ne.gather_fused_ring_implicit(
            U1[None], b.cols[None, None], b.vals[None, None],
            b.mask[None, None], REG, ALPHA, Y1)
        if not torch.equal(x7[0], x4):
            fail(f"K7 at one shard is not K4 bit for bit on the item "
                 f"half-step's bucket of width {b.width}")
    log(f"k7 at one shard == K4 bitwise on the item half-step's "
        f"{len(k4_b)} K4 buckets")

    ib, Us0 = sh["ish"].to(dev), sh["U0"]
    S = SHARDS
    Vsh = Us0.reshape(S, -1, r)
    YtY = compute_yty(Us0)
    split = core_als.SPLIT_WIDTH
    pre = []
    for b in ib:
        conf, pref = implicit_weights(b.vals, b.mask, ALPHA)
        pre.append((b, conf, (1.0 + conf) * pref * b.mask, pref * b.mask))

    def k7_one(b, aw, bw, cw):
        return cuda_gather_ne.gather_solve_ring(Vsh, b.cols, aw, bw, cw, YtY,
                                                two_sided=False, reg=REG)

    def k7():
        return [k7_one(*p) for p in pre]

    def k7_plain():
        xs = []
        for b, aw, bw, cw in pre:
            step = max(1, (1 << 28) // (S * b.width * r))
            xs.append(torch.cat([cuda_gather_ne.gather_solve_ring_plain(
                Vsh, b.cols[:, :, sl], aw[:, :, sl], bw[:, :, sl],
                cw[:, :, sl], YtY, two_sided=False, reg=REG)
                for sl in (slice(s0, s0 + step)
                           for s0 in range(0, b.cols.shape[2], step))],
                dim=1))
        return xs

    xp, p7 = timed(k7_plain)
    xk = k7()
    torch.cuda.synchronize()
    e7, wide = 0.0, 0.0
    for (b, *_), x, y in zip(pre, xk, xp):
        if S * b.width <= split:
            e7 = max(e7, (x - y).abs().max().item())
            if not (torch.isfinite(x).all() and torch.allclose(
                    x, y, rtol=K4_RTOL, atol=K4_ATOL)):
                fail(f"K7 on the ring grid's bucket of width {b.width}: "
                     f"kernel vs plain max |diff| {(x - y).abs().max():.3e}")
        else:
            wide = max(wide, row_rel(x.reshape(-1, r), y.reshape(-1, r)))
    log(f"k7 r={r} item half-step ring grid ({len(ib)} buckets): max "
        f"|kernel - plain| {e7:.3e} on the buckets of S x width <= {split} "
        f"(rtol {K4_RTOL}, atol {K4_ATOL}); wider buckets max per-row "
        f"|diff|/|x| {wide:.3e} (not gated: the plain sums run in one chain)")
    del xk, xp

    per = [(p[0].width, cuda_ms(lambda p=p: k7_one(*p), 1)) for p in pre]
    total = sum(t for _, t in per)
    ms7 = cuda_ms(k7, 3)
    unfused = core_als.AlsConfig(rank=r, implicit_prefs=True, alpha=ALPHA,
                                 reg_param=REG)
    ic = torch.from_numpy(sh["icounts"]).to(dev)
    l7 = cuda_ms(lambda: ring_half_step(
        Us0, ib, ic, sh["ish"].rows_per_shard, S, unfused,
        sh["ish"].chunk_elems, YtY), 1)
    P = sum(b.cols.numel() for b in ib)
    E = sum(int(b.mask.count_nonzero()) for b in ib)
    n = sum(int((b.rows < sh["ish"].rows_per_shard).sum()) for b in ib)
    b7, by7 = bound(P * 16 + E * r * 4 + n * r * 4, gram_flops(E, n, r))
    log(f"k7 item half-step by bucket (S x width: ms): " + ", ".join(
        f"{S}x{w}: {t:.2f}" for w, t in per) + f"; widest bucket's share "
        f"{per[-1][1] / total:.3f}")
    log(f"timing K7 r={r} item half-step, {S} shards, {len(ib)} buckets, "
        f"{n} real rows, {E} real of {P} padded entries: kernel_ms="
        f"{ms7:.4f} plain_ms={p7:.4f} library_ms={l7:.4f} (unfused ring "
        f"half-step) bound_ms={b7:.4f} ({by7}) launches/fit="
        f"{sh['launches']['k7']}")
    return {"name": "gather_solve_ring (K7)", "route": "cuda",
            "source": "tpu_als_torch/csrc/gather_solve_ring.cu",
            "replaces": "tpu_als/ops/pallas_gather_ne.py:708",
            "launches": sh["launches"]["k7"],
            "max_abs_err": max(errs["k7"], e7),
            "ms": ms7, "plain_ms": p7, "bound_ms": b7, "bound_by": by7,
            "library_ms": l7}


def merge_timings(model, launches, dev):
    """K8 at the sharded serving shape (every user, the catalog in SHARDS
    shards, k = 10) beside its plain version (held to K5_TOL on the
    scores: real factors, so no bitwise bar), the bound in K5's closed
    form, and a blocked ``matmul`` + stable ``sort`` over the whole
    catalog as the yardstick."""
    U, V = model._U, model._V
    (n, r), Ni, k = U.shape, V.shape[0], 10
    ni_loc = -(-Ni // SHARDS)
    Vp = torch.zeros(SHARDS * ni_loc, r, device=dev)
    Vp[:Ni] = V
    vp = torch.zeros(SHARDS * ni_loc, dtype=torch.bool, device=dev)
    vp[:Ni] = True
    Vs, vs = Vp.reshape(SHARDS, ni_loc, r), vp.reshape(SHARDS, ni_loc)
    sk, _ = cuda_topk.topk_merge_ring(U, Vs, vs, k)
    (sp, _), p8 = timed(lambda: cuda_topk.topk_merge_ring_plain(U, Vs, vs,
                                                                 k))
    e8 = (sk - sp).abs().max().item()
    if not torch.allclose(sk, sp, rtol=K5_TOL, atol=K5_TOL):
        fail(f"K8 at the serving shape: kernel vs plain scores max |diff| "
             f"{e8:.3e}")
    del sk, sp
    ms8 = cuda_ms(lambda: cuda_topk.topk_merge_ring(U, Vs, vs, k), 3)

    def library():
        for s in range(0, n, 8192):
            torch.sort(U[s:s + 8192] @ V.T, dim=1, descending=True,
                       stable=True)

    l8 = cuda_ms(library, 1)
    b8, by8 = bound((n * r + Ni * r) * 4 + Ni + n * k * (4 + 8),
                    2 * n * Ni * r)
    log(f"timing K8 n={n} Ni={Ni} ({SHARDS} shards) r={r} k={k}: "
        f"kernel_ms={ms8:.4f} plain_ms={p8:.4f} library_ms={l8:.4f} "
        f"(matmul + stable sort) bound_ms={b8:.4f} ({by8}) "
        f"launches={launches['k8']}; max |kernel - plain| {e8:.3e}")
    return {"name": "topk_merge_ring (K8)", "route": "cuda",
            "source": "tpu_als_torch/csrc/topk_merge_ring.cu",
            "replaces": "tpu_als/ops/pallas_topk.py:346",
            "launches": launches["k8"], "max_abs_err": e8,
            "ms": ms8, "plain_ms": p8, "bound_ms": b8, "bound_by": by8,
            "library_ms": l8}


def bucket_times(tr):
    """Each bucket's share of the two half-steps from the seeded init
    (CUDA events), and one iteration beside its bound."""
    cfg, U0, r = tr["cfg"], tr["U0"], RANK
    yU = compute_yty(U0)
    V1 = core_als.local_half_step(U0, tr["ib"], tr["n_items"], cfg, yU)
    iter_bound = 0.0
    for side, Y, bks, n, yty in (
            ("items", U0, tr["ib"], tr["n_items"], yU),
            ("users", V1, tr["ub"], tr["n_users"], compute_yty(V1))):
        per = [(b.width, cuda_ms(lambda b=b: core_als.local_half_step(
            Y, [b], n, cfg, yty), 1), b.cols.shape[0]) for b in bks]
        total = sum(t for _, t, _ in per)
        # the half-step's bound: cols and weights read per padded entry, a
        # gathered row, the lower-triangle Gram and b per real entry, a
        # solve and x written per real row
        P, E, rows = gram_work(bks, n)
        b_ms, by = bound(P * 16 + E * r * 4 + rows * r * 4,
                         gram_flops(E, rows, r))
        iter_bound += b_ms
        log(f"{side} half-step by bucket (width: ms, rows): "
            + ", ".join(f"{w}: {t:.2f}, {n_b}" for w, t, n_b in per)
            + f"; sum {total:.1f} ms, widest bucket's share "
            f"{per[-1][1] / total:.3f}; {E} real of {P} padded entries, "
            f"{rows} real rows; bound {b_ms:.2f} ms ({by})")

    def iteration():
        core_als.als_step(U0, tr["V0"], tr["ub"], tr["ib"], tr["n_users"],
                          tr["n_items"], cfg)

    ms = cuda_ms(iteration, 2)
    log(f"one iteration at SPLIT_WIDTH {core_als.SPLIT_WIDTH}: {ms:.1f} ms "
        f"({ms / iter_bound:.1f}x its bound {iter_bound:.2f} ms)")


def where_time_goes(model, rng, tr, users, items):
    """One training iteration, one more fold-in batch (of ``users`` and
    new ones, rating ``items``) and one all-users recommend under the
    profiler, at the rank of ``tr`` and ``model``: wall time, device
    busy time (sum of kernel times), the device's idle share, the host's
    packing time, and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    r = model.rank
    batch, _ = foldin_batch(rng, 4096, users,
                            int(model._user_map.ids.max()) + 1, items)
    t0 = time.perf_counter()
    fixed = model._item_map.to_dense(batch["item"])
    pack_rows(batch["user"], fixed, batch["rating"])
    pack_ms = (time.perf_counter() - t0) * 1e3
    srv = FoldInServer(model)
    def iteration():
        core_als.als_step(tr["U0"], tr["V0"], tr["ub"], tr["ib"],
                          tr["n_users"], tr["n_items"], tr["cfg"])

    for what, fn in (("training iteration", iteration),
                     ("fold-in update", lambda: srv.update(batch)),
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
        log(f"profile rank {r} {what}: wall_ms={wall:.3f} "
            f"device_busy_ms={busy:.3f} "
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
    split = core_als.SPLIT_WIDTH
    errs = {"k2": check_k2(rng, dev), "k1": check_k1(rng, dev),
            "k6": check_k6(rng, dev), "k5": check_k5(rng, dev),
            "k3": check_k3(rng, dev), "k4": check_k4(rng, dev)}
    for r in (200, RANK256):   # the larger error of the two ranks
        for k, e in (("k3", check_k3(rng, dev, r, (24, 512))),
                     ("k4", check_k4(rng, dev, r, ((256, 24), (64, 512),
                                                  (3, 2 * split))))):
            errs[f"{k}_256"] = max(errs.get(f"{k}_256", 0.0), e)
    errs["k7"] = check_k7(rng, dev)[RANK]
    errs["k8"] = check_k8(rng, dev)
    data = prepare(args.seed, dev)
    tr = train_slice(data, RANK, args.seed, dev)
    tr256 = train_slice(data, RANK256, args.seed, dev)
    sh = sharded_train_slice(data, args.seed, dev)
    del data
    model, launches, A, b = run_slice(rng, dev)
    model256, launches256, A256, b256 = serve_slice_256(tr256["model"], rng,
                                                        dev)
    launches8 = sharded_serve_slice(tr["model"], sh["mesh"], dev)
    kernels = timings(model, launches, A, b, errs, dev)
    kernels += train_timings(tr, errs, dev)
    kernels += train_timings(tr256, errs, dev)
    kernels.append(ring_timings(sh, tr, errs, dev))
    del sh
    kernels.append(merge_timings(tr["model"], launches8, dev))
    k6_timings(A256, b256, launches256["k6"], errs["k6"],
               "the rank-256 fold-in batch")
    del A256, b256
    kernels.sort(key=lambda k: k["name"].split("(K")[1])
    bucket_times(tr)
    where_time_goes(model, rng, tr, np.arange(N_USERS), np.arange(N_ITEMS))
    where_time_goes(model256, rng, tr256, tr256["model"]._user_map.ids,
                    model256._item_map.ids)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
