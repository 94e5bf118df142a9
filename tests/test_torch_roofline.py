"""The port's roofline (``tpu_als_torch/perf/roofline.py``) against
``tpu_als.perf.roofline``.

- Every closed form equals the reference's on the same arguments,
  exactly (they return ints).
- ``roofline()``: every stage's name, ``bytes`` and ``flops`` equal the
  reference's over ``ne_path`` × ``strategy`` × ``devices`` ∈ {1, 4} ×
  implicit/explicit × f32/bf16, with the padding waste explicit and
  derived from degree arrays, the comm stage also from built partitions;
  the totals exactly, the padding waste at rel 1e-12.
- The seconds are the H100's own: bytes over 3.35 TB/s (NVLink 900 GB/s
  for the collective), the Gram on the tensor cores (3xTF32 at 495/3
  TFLOP/s in f32, bf16 at 989), the rest at 67 TFLOP/s; no measured
  point unless one is given.
- The port's ``ne_path='auto'`` splits the iteration at SPLIT_WIDTH by
  the bucketizer's own widths, equal to the built buckets, each width
  routed by ``core.als.resolve_solve_path`` under the given config.
- The kernel bounds count real work.
"""

import importlib
import itertools
import math

import numpy as np
import pytest

from tpu_als.parallel import data as jdata
from tpu_als.parallel.trainer import comm_bytes_per_iter as j_comm
from tpu_als_torch.core import als as tals
from tpu_als_torch.core.ratings import build_csr_buckets
from tpu_als_torch.parallel import data as tdata
from tpu_als_torch.parallel.trainer import comm_bytes_per_iter as t_comm

# the packages export roofline() under the module's name
jrl = importlib.import_module("tpu_als.perf.roofline")
trl = importlib.import_module("tpu_als_torch.perf.roofline")
REL = 1e-12


def _coo(seed=0, nU=2000, nI=800, nnz=60_000):
    """Power-law ratings: a few rows far wider than the rest, and some
    rows with none."""
    rng = np.random.default_rng(seed)
    u = np.minimum(rng.zipf(1.3, nnz), nU) - 1
    i = np.minimum(rng.zipf(1.2, nnz), nI) - 1
    return nU, nI, u, i


def _counts(seed=0):
    nU, nI, u, i = _coo(seed)
    return np.bincount(u, minlength=nU), np.bincount(i, minlength=nI)


@pytest.mark.parametrize("args", [(0, 0, 8, 4), (1000, 37, 16, 4),
                                  (75_700_000.5, 221_588, 128, 4),
                                  (4096, 64, 512, 2)])
def test_closed_forms_equal_the_reference(args):
    P, n, r, db = args
    assert trl.fused_ne_kernel_bytes(P, n, r, db) == \
        jrl.fused_ne_kernel_bytes(P, n, r, db)
    assert trl.fused_solve_kernel_bytes(P, n, r, db) == \
        jrl.fused_solve_kernel_bytes(P, n, r, db)
    assert trl.einsum_ne_build_bytes(P, n, r, db, 2.5) == \
        jrl.einsum_ne_build_bytes(P, n, r, db, 2.5)
    for S in (1, 4, 9):
        ring = trl.ring_remote_bytes(n, S, 1000, r, db)
        assert ring == jrl.ring_remote_bytes(n, S, 1000, r, db)
        assert trl.fused_ring_kernel_bytes(P, n, r, db, ring) == \
            jrl.fused_ring_kernel_bytes(P, n, r, db, ring)
        assert trl.serve_merge_remote_bytes(n, S, 256) == \
            jrl.serve_merge_remote_bytes(n, S, 256)
        assert trl.serve_query_bytes(4096, S, 59_047, r, db=db) == \
            jrl.serve_query_bytes(4096, S, 59_047, r, db=db)


@pytest.mark.parametrize("growth", [2.0, 1.5])
def test_modeled_padding_waste_equals_the_reference_and_the_build(growth):
    uc, ic = _counts()
    for c in (uc, ic, np.zeros(5, np.int64)):
        assert trl.modeled_padding_waste(c, 8, 1 << 12, growth) == \
            jrl.modeled_padding_waste(c, 8, 1 << 12, growth)
    rows = np.repeat(np.arange(len(ic)), ic)
    cols = np.arange(len(rows)) % 97
    csr = build_csr_buckets(rows, cols, np.ones(len(rows), np.float32),
                            len(ic), width_growth=growth)
    assert trl.modeled_padding_waste(ic, growth=growth) == \
        pytest.approx(csr.padded_nnz / csr.nnz, rel=REL)


def _same_stages(a, b):
    assert [s["name"] for s in a["stages"]] == \
        [s["name"] for s in b["stages"]]
    for s, t in zip(a["stages"], b["stages"]):
        assert (s["bytes"], s["flops"]) == (t["bytes"], t["flops"]), s["name"]
    for k in ("hbm_bytes_per_iter", "comm_bytes_per_iter", "flops_per_iter"):
        assert a[k] == b[k], k
    assert a["config"]["padding_waste"] == pytest.approx(
        b["config"]["padding_waste"], rel=REL)
    assert a["config"]["padding_waste_source"] == \
        b["config"]["padding_waste_source"]


GRID = list(itertools.product(
    ["einsum", "gather_fused", "gather_fused_solve"],
    [None, "all_gather", "ring", "ring_overlap", "all_gather_chunked"],
    [1, 4], [True, False], ["float32", "bfloat16"]))


@pytest.mark.parametrize("waste", ["explicit", "derived"])
def test_stage_bytes_and_flops_equal_the_reference(waste):
    uc, ic = _counts(1)
    nnz = int(uc.sum())
    for ne, st, D, imp, dt in GRID:
        kw = dict(dtype=dt, implicit=imp, devices=D, strategy=st,
                  tiles_user=3, tiles_item=2, ne_path=ne)
        if waste == "explicit":
            kw["padding_waste"] = 1.514
        else:
            kw.update(user_counts=uc, item_counts=ic)
        _same_stages(trl.roofline(len(uc), len(ic), nnz, 16, **kw),
                     jrl.roofline(len(uc), len(ic), nnz, 16, **kw))


@pytest.mark.parametrize("strategy", ["all_gather", "all_gather_chunked",
                                      "ring"])
def test_collective_stage_from_built_partitions(strategy):
    rng = np.random.default_rng(3)
    nU, nI, nnz, D = 60, 40, 900, 4
    u, i = rng.integers(0, nU, nnz), rng.integers(0, nI, nnz)
    r = np.abs(rng.normal(size=nnz)).astype(np.float32) + 0.1
    out = {}
    for name, pkg, comm in (("port", tdata, t_comm),
                            ("ref", jdata, j_comm)):
        up = pkg.partition_balanced(np.bincount(u, minlength=nU), D)
        ip = pkg.partition_balanced(np.bincount(i, minlength=nI), D)
        ush = pkg.shard_csr(up, ip, u, i, r, min_width=4, chunk_elems=512)
        ish = pkg.shard_csr(ip, up, i, u, r, min_width=4, chunk_elems=512)
        mod = trl if name == "port" else jrl
        out[name] = mod.roofline(nU, nI, nnz, 8, devices=D,
                                 strategy=strategy, user_part=up,
                                 item_part=ip, user_container=ush,
                                 item_container=ish)
        assert out[name]["comm_bytes_per_iter"] == comm(
            strategy, up, ip, 8, user_container=ush, item_container=ish,
            implicit=True)
    _same_stages(out["port"], out["ref"])


@pytest.mark.parametrize("dtype,tc", [("float32", 495e12 / 3),
                                      ("bfloat16", 989e12)])
def test_seconds_are_the_h100s(dtype, tc):
    rep = trl.roofline(162_541, 59_047, 25_000_095, 128, dtype=dtype,
                       padding_waste=1.5, devices=4, strategy="all_gather",
                       ne_path="einsum")
    r, P = 128, 2 * 1.5 * 25_000_095 / 4
    for s in rep["stages"]:
        bw = 900e9 if s["name"] == "collective" else 3.35e12
        assert s["byte_seconds"] == pytest.approx(s["bytes"] / bw, rel=1e-6)
    ne = next(s for s in rep["stages"] if s["name"] == "normal_eq")
    want = 2 * P * r * r / tc + 2 * P * r / 67e12
    assert ne["flop_seconds"] == pytest.approx(want, rel=1e-9)
    solve = next(s for s in rep["stages"] if s["name"] == "solve")
    assert solve["flop_seconds"] == pytest.approx(solve["flops"] / 67e12,
                                                  rel=1e-6)
    assert rep["config"]["hbm_gbps"] == 3350.0
    assert rep["config"]["link_gbps"] == 900.0
    assert rep["roofline_floor_s_per_iter"] == pytest.approx(
        sum(s["floor_seconds"] for s in rep["stages"]), rel=1e-12)
    assert "measured_s_per_iter" not in rep


def test_headline_has_no_measured_point_unless_given():
    rep = trl.headline_roofline(ne_path="gather_fused_solve")
    assert "measured_s_per_iter" not in rep
    text = trl.render(rep)
    assert "H100" in text and "measured" not in text and "v5e" not in text
    rep = trl.headline_roofline(measured_s_per_iter=0.09)
    assert rep["measured_over_roofline_floor"] == pytest.approx(
        0.09 / rep["roofline_floor_s_per_iter"])
    assert "measured:" in trl.render(rep)
    # the fused build moves >= 40 % fewer NE bytes than the einsum build
    ein = trl.headline_roofline(ne_path="einsum")
    fus = trl.headline_roofline(ne_path="gather_fused")
    ne = {n: sum(s["bytes"] for s in rep["stages"] if s["name"] in names)
          for n, rep, names in (("ein", ein, ("gather_stream", "normal_eq")),
                                ("fus", fus, ("gather_fused_ne",)))}
    assert 1 - ne["fus"] / ne["ein"] >= 0.40


@pytest.mark.parametrize("rank,split", [(16, 64), (16, 8192), (640, 64)])
def test_auto_splits_at_split_width_as_the_buckets(rank, split,
                                                   monkeypatch):
    monkeypatch.setattr(tals, "SPLIT_WIDTH", split)
    nU, nI, u, i = _coo(2)
    uc, ic = np.bincount(u, minlength=nU), np.bincount(i, minlength=nI)
    cfg = tals.AlsConfig(rank=rank)
    P_wide = n_wide = 0
    for c, rows, cols in ((uc, u, i), (ic, i, u)):
        csr = build_csr_buckets(rows, cols, np.ones(len(rows), np.float32),
                                len(c))
        for b in csr.buckets:
            if tals.resolve_solve_path(cfg, rank, b.width).startswith(
                    "gatherfused+"):
                P_wide += b.cols.size
                n_wide += int((b.rows < len(c)).sum())
        assert trl.route_split(c, rank) == (
            sum(b.cols.size for b in csr.buckets
                if tals.resolve_solve_path(cfg, rank, b.width)
                .startswith("gatherfused+")),
            sum(int((b.rows < len(c)).sum()) for b in csr.buckets
                if tals.resolve_solve_path(cfg, rank, b.width)
                .startswith("gatherfused+")))
    nnz = int(uc.sum())
    rep = trl.roofline(len(uc), len(ic), nnz, rank, ne_path="auto",
                       user_counts=uc, item_counts=ic)
    st = {s["name"]: s for s in rep["stages"]}
    P = 2 * rep["config"]["padding_waste"] * nnz
    n = len(uc) + len(ic)
    assert st["gather_fused_ne"]["bytes"] == trl.fused_ne_kernel_bytes(
        P_wide, n_wide, rank, 4)
    assert st["gather_fused_solve"]["bytes"] == trl.fused_solve_kernel_bytes(
        P - P_wide, n - n_wide, rank, 4)
    assert st["solve"]["flops"] == int(n_wide * (2 * rank ** 3 / 3
                                                 + 4 * rank * rank))
    if P_wide == 0:      # every bucket on K4: the K4 roofline's bytes
        k4 = trl.roofline(len(uc), len(ic), nnz, rank,
                          ne_path="gather_fused_solve", user_counts=uc,
                          item_counts=ic)
        assert st["gather_fused_solve"]["bytes"] == k4["stages"][0]["bytes"]
    with pytest.raises(ValueError, match="user_counts"):
        trl.roofline(10, 10, 100, 4, ne_path="auto")



@pytest.mark.parametrize("knob,wide", [
    (dict(adaptive_solve=True), "all"), (dict(solve_backend="gather_fused"),
                                         "all"),
    (dict(solve_backend="gather_fused_solve"), "none"),
    (dict(nonnegative=True), "raises")])
def test_route_split_takes_the_configs_routes(knob, wide):
    # the routing rule lives in core.als.resolve_solve_path alone: a knob
    # that moves the narrow buckets off K4 moves the priced split with it
    nU, nI, u, i = _coo(3)
    uc = np.bincount(u, minlength=nU)
    cfg = tals.AlsConfig(rank=16, **knob)
    if wide == "raises":
        with pytest.raises(ValueError, match="neither K4 nor K3"):
            trl.route_split(uc, 16, cfg)
        return
    padded = round(trl.modeled_padding_waste(uc) * int(uc.sum()))
    want = {"all": (padded, int((uc > 0).sum())), "none": (0, 0)}[wide]
    assert trl.route_split(uc, 16, cfg) == want
    assert trl.route_split(uc, 16) == trl.route_split(
        uc, 16, tals.AlsConfig(rank=16))

def test_kernel_bounds_count_real_work():
    # K2/K1's bound: A's lower triangle and b read, x written
    N, r = 4096, 128
    assert trl.solve_bound(N, r) == trl.bound(
        (N * r * (r + 1) // 2 + 2 * N * r) * 4, N * (r ** 3 / 3 + 2 * r * r))
    t_b, t_f = trl.bound_ms(3.35e9, 67e9, 495e9 / 3)
    assert (t_b, t_f) == pytest.approx((1.0, 2.0), rel=1e-12)
    assert trl.bound(3.35e9, 0.0) == (pytest.approx(1.0), "bytes")
    assert trl.bound(0.0, 67e9)[1] == "operations"
    P, E, rows = 1000, 600, 37
    assert trl.fused_solve_bound(P, E, rows, r) == trl.bound(
        P * 16 + E * r * 4 + rows * r * 4, E * 2 * r
        + rows * (r ** 3 / 3 + 2 * r * r), E * r * (r + 1))
    assert trl.gram_bound(P, E, rows, r) == trl.bound(
        P * 12 + E * r * 4 + rows * (r * r + r) * 4, E * 2 * r,
        E * r * (r + 1))
    (ms, by), note = trl.topk_bound(4096, 59_047, 128, 10)
    assert by == "operations" and math.isfinite(ms) and "3xTF32" in note
