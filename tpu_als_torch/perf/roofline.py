"""Per-stage bytes/FLOPs roofline of one ALS iteration, priced on one
NVIDIA H100, and the kernels' bounds.

Counterpart of ``tpu_als/perf/roofline.py``.  Two kinds of accounting
live here, and they count different work:

- **The stage model** (:func:`roofline` and the closed forms it is built
  from: :func:`fused_ne_kernel_bytes`, :func:`fused_solve_kernel_bytes`,
  :func:`ring_remote_bytes` over :func:`ring_row_tile`'s tiles,
  :func:`fused_ring_kernel_bytes`,
  :func:`serve_merge_remote_bytes`, :func:`serve_query_bytes`,
  :func:`einsum_ne_build_bytes`, :func:`modeled_padding_waste`) counts
  PADDED work: ``P = 2·padding_waste·nnz`` entries an iteration, every
  one of them gathered and multiplied, and every row of both sides
  solved.  Its bytes and FLOPs are the reference's, stage by stage; only
  the rates that turn them into seconds are the card's.  It is what
  ``observe roofline`` prints and what ``observe attribution`` joins the
  measured stages against.
- **The kernel bounds** (:func:`bound`, :func:`bound_ms`,
  :func:`bound_note`, :func:`gram_work`, :func:`gram_flops`,
  :func:`fused_solve_bound`, :func:`gram_bound`, :func:`solve_bound`,
  :func:`topk_bound`) count REAL work, what one run's inputs need: the
  cols and weights of every padded entry are read, but a factor row is
  gathered, and the Gram's and b's operations done, only for a real
  entry (mask 1), and only a real row is solved and written.  They are
  the ``bound_ms`` of ``chip_smoke.py``'s kernel lines.

Rates (NVIDIA H100 SXM data sheet, dense, at the 700 W limit):
HBM 3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s; TF32 495
TFLOP/s, where the Gram and the score GEMM run in the 3xTF32 form
(three TF32 products per float32 product, so 165 TFLOP/s of float32
work); bfloat16 989 TFLOP/s; int8 1,979 TOP/s.  The collective stage of
a mesh over ``devices > 1`` cards is priced at NVLink's 900 GB/s, a
model for a box with more than one card: the port's S logical shards on
one card share its memory, nothing crosses a link, and such a fit is
priced with ``devices=1``.

Stage model (one full iteration = the item half-step, then the user
half-step; ``P`` padded entries, ``n`` solved rows, rank ``r``, table
width ``db`` bytes):

- **gather_stream**: each padded entry reads its opposite factor row and
  writes it into the gathered ``[n, w, r]`` tensor (``2·P·r·db``), plus
  the cols/vals/mask stream (``12·P``);
- **normal_eq**: re-reads the gathered rows (``P·r·db``), writes the
  ``[n, r, r]`` normal equations (``n·r²·4``); ``2·P·r² + 2·P·r``
  FLOPs, the Gram's ``2·P·r²`` on the tensor cores;
- **gather_fused_ne** (kernel K3): the factor rows read once, A and b
  written (:func:`fused_ne_kernel_bytes`);
- **gather_fused_solve** (kernel K4): the factor rows read once, only x
  written (:func:`fused_solve_kernel_bytes`), the solve's FLOPs fused in;
- **solve**: reads A and b, writes x; ``n·(2r³/3 + 4r²)`` FLOPs at the
  float32 FMA rate (a Cholesky's recurrences do not run on the tensor
  cores);
- **scatter**: the solved rows written back (``n·r·4``);
- **yty** (implicit): each table read once, ``2·N·r²`` FLOPs a
  half-step on the tensor cores;
- **collective** (``devices > 1``): the strategy's bytes
  (:func:`tpu_als_torch.parallel.trainer.comm_bytes_per_iter`) over
  NVLink.

``ne_path='auto'`` is the port's own: 'auto' sends a bucket of width
<= ``SPLIT_WIDTH`` (at rank <= K4's 512) to K4 and a wider one to K3 and
a solve (K1 up to rank 128, K6 above), so the iteration is priced as
``gather_fused_solve`` over the K4 buckets' entries and rows plus
``gather_fused_ne`` and ``solve`` over the K3 ones', each bucket width
of the bucketizer's own assignment routed by
``core.als.resolve_solve_path`` (:func:`route_split`).

Floor = Σ over stages of ``max(bytes/BW, FLOPs/peak)``; the HBM floor
(Σ bytes over the HBM rate) is reported beside it.
"""

from __future__ import annotations

from dataclasses import dataclass

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12         # float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12       # dense TF32 (a 3xTF32 product is 3 of them)
BF16_FLOPS_PER_S = 989e12       # dense bfloat16
INT8_OPS_PER_S = 1979e12        # dense int8
NVLINK_BYTES_PER_S = 900e9      # per card, a box of several cards

# the headline configuration: ML-25M, rank 128, implicit alpha 40, f32, one
# device; padding_waste is the padded/real entry ratio of the bucketed
# layout of ML-25M's degree distribution (a property of the data and the
# bucketing, not of any device)
HEADLINE = dict(n_users=162_541, n_items=59_047, nnz=25_000_095,
                rank=128, dtype="float32", implicit=True,
                padding_waste=1.514, devices=1)


def fused_ne_kernel_bytes(P, n, r, db):
    """HBM bytes of the gather + Gram kernel (K3) for ``P`` padded
    entries and ``n`` rows: each entry's factor row read once (never
    written back as a gathered tensor), the cols (int32) and the two
    weight streams, and the A/b outputs.  The K3 wrapper declares it at
    its shapes (:func:`tpu_als_torch.perf.ne_audit.kernel_cost_bytes`)."""
    return int(P * r * db + P * (4 + 2 * db) + n * r * r * 4 + n * r * 4)


def fused_solve_kernel_bytes(P, n, r, db):
    """HBM bytes of the gather + Gram + tail + solve kernel (K4): each
    entry's factor row read once, the cols and three weight streams, and
    x written; the ``[n, r, r]`` normal equations never reach HBM."""
    return int(P * r * db + P * (4 + 3 * db) + n * r * 4)


def ring_r_pad(r):
    """The rank the fused ring's schedule carries: padded to the TPU
    kernel's 128-wide lanes, as the reference prices it."""
    return max(128, -(-int(r) // 128) * 128)


def ring_row_tile(r_pad, w8, panel=16, max_wc=256, vmem_budget=1 << 17):
    """TN, the fused ring kernel's row tile in the reference's schedule (a
    copy of ``tpu_als/ops/pallas_gather_ne.py::_tiles`` and
    ``_tiles_solve``): each row tile makes its own ring pass, so the
    tiles of a bucket of ``nb`` rows, ``ceil(nb / TN)``, multiply
    :func:`ring_remote_bytes`.  ``w8``: the bucket's width rounded up to
    8."""
    if w8 <= max_wc:
        wc = w8
    else:
        w_pad = -(-w8 // 128) * 128
        wc = max_wc - (max_wc % 128)
        while wc > 128 and w_pad % wc:
            wc -= 128
    tn = 256
    while tn > 8 and tn * (r_pad * r_pad + 3 * wc * r_pad) > (1 << 21):
        tn //= 2
    while tn > 8 and tn * wc > (1 << 13):
        tn //= 2
    while tn > 8 and tn * (2 * r_pad * r_pad + 3 * wc * r_pad) > (1 << 21):
        tn //= 2
    cap = int(vmem_budget) // (max(panel, 32) * r_pad)
    if cap < 8:
        raise ValueError(
            f"vmem_budget {vmem_budget} caps the fused-solve row tile at "
            f"{cap} rows for r_pad={r_pad} panel={panel} (the reference's "
            "TileBudgetError)")
    return max(8, (min(tn, cap) // 8) * 8)


def ring_remote_bytes(n_row_tiles, n_shards, per, r, db):
    """Bytes a ring over ``n_shards`` cards forwards in one call of the
    fused ring kernel (K7): each row tile's pass forwards the held ``[per,
    r]`` shard ``S - 1`` times, with no homecoming rotation.  Logical
    shards on one card forward nothing."""
    return int(n_row_tiles * max(0, n_shards - 1) * per * r * db)


def fused_ring_kernel_bytes(P, n, r, db, ring_bytes):
    """HBM bytes of the fused ring kernel (K7): :func:`fused_solve_kernel_
    bytes` plus the ring's payload, counted once per transfer (its read
    on the sending card)."""
    return fused_solve_kernel_bytes(P, n, r, db) + int(ring_bytes)


def serve_merge_remote_bytes(n_user_tiles, n_shards, tile_u, lanes=128):
    """Bytes a ring over ``n_shards`` cards forwards in one call of the
    top-k merge (K8): each user tile's pass forwards one packed ``[tile_u,
    2·lanes]`` f32 candidate set ``S - 1`` times.  The catalog never
    moves, so the wire bytes of a query do not grow with the catalog."""
    return int(n_user_tiles * max(0, n_shards - 1)
               * tile_u * 2 * lanes * 4)


def serve_query_bytes(n_queries, n_shards, ni, r, *, tile_u=256,
                      lanes=128, db=4):
    """The bytes of one sharded serving call, by channel: ``hbm``, each
    card streaming its own catalog shard once (``ceil(Ni/S)·r·db``) plus
    the query rows and the ``[n, lanes]`` result pair; ``ici``, the
    merge's link bytes (:func:`serve_merge_remote_bytes` over
    ``ceil(n/tile_u)`` user tiles).  ``*_per_query`` divide by
    ``n_queries``."""
    S = max(1, int(n_shards))
    ni_loc = -(-int(ni) // S)
    n_ut = -(-int(n_queries) // int(tile_u))
    hbm = int(n_queries * r * db + ni_loc * r * db
              + 2 * n_queries * lanes * 4)
    ici = serve_merge_remote_bytes(n_ut, S, tile_u, lanes)
    return {"hbm_bytes": hbm, "ici_bytes": ici,
            "hbm_per_query": hbm / max(1, n_queries),
            "ici_per_query": ici / max(1, n_queries)}


def einsum_ne_build_bytes(P, n, r, db, restream=1.0):
    """The unfused route's NE-build bytes (the gather_stream and
    normal_eq stages summed): the gather reads a factor row per padded
    entry and writes the ``[n, w, r]`` tensor, the cols/vals/mask stream
    rides along, and the Gram re-reads the gathered rows and writes A."""
    return int(restream * (2.0 * P * r * db) + 12.0 * P
               + P * r * db + n * r * r * 4.0)


def _widths(counts, min_width, growth):
    import numpy as np

    from tpu_als_torch.core.ratings import entity_widths

    counts = np.asarray(counts, dtype=np.int64)
    rated = counts[counts > 0]
    return int(counts.sum()), rated, (entity_widths(rated, min_width, growth)
                                      if len(rated) else rated)


def modeled_padding_waste(counts, min_width=8, chunk_elems=1 << 19,
                          growth=2.0):
    """padded_nnz / nnz of a degree distribution, by the bucketizer's own
    width assignment and row padding (``core.ratings.entity_widths`` /
    ``padded_bucket_rows``); no bucket is built."""
    from tpu_als_torch.core.ratings import padded_bucket_rows

    nnz, rated, w = _widths(counts, min_width, growth)
    if not nnz or not len(rated):
        return 1.0
    padded = 0
    for wv in sorted(set(w.tolist())):
        nb = int((w == wv).sum())
        padded += padded_bucket_rows(nb, int(wv), chunk_elems) * int(wv)
    return padded / nnz


def route_split(counts, rank, cfg=None, *, min_width=8,
                chunk_elems=1 << 19, growth=2.0):
    """``(padded entries, rows)`` of one side's buckets that ``cfg``
    sends to K3 and a solve (a 'gatherfused+' route) rather than K4, each
    bucket width's route taken from ``core.als.resolve_solve_path`` (the
    one place that decides it; ``cfg`` None: ``AlsConfig(rank=rank)``,
    whose 'auto' backend sends a bucket wider than ``SPLIT_WIDTH``, or
    every bucket above K4's rank, to K3).  Rows are real (rated) rows,
    entries padded ones, as the bucketizer lays them out.  A route that
    is neither K4 nor K3 raises ``ValueError``: ``ne_path='auto'``
    prices only those two."""
    from tpu_als_torch.core import als
    from tpu_als_torch.core.ratings import padded_bucket_rows

    cfg = als.AlsConfig(rank=int(rank)) if cfg is None else cfg
    _, rated, w = _widths(counts, min_width, growth)
    padded = rows = 0
    for wv in sorted(set(w.tolist())):
        path = als.resolve_solve_path(cfg, rank, int(wv))
        if path in als._K4_PATHS:
            continue
        if not path.startswith("gatherfused+"):
            raise ValueError(f"route {path!r} of width {wv} is neither K4 "
                             "nor K3: ne_path='auto' prices only those")
        nb = int((w == wv).sum())
        padded += padded_bucket_rows(nb, int(wv), chunk_elems) * int(wv)
        rows += nb
    return padded, rows


@dataclass
class Stage:
    name: str
    bytes: float          # bytes moved through `bw` per iteration
    flops: float          # FLOPs per iteration
    bw: float             # bytes/sec of the stage's channel
    peak: float           # FLOP/s of the FLOPs not on the tensor cores
    note: str = ""
    tc_flops: float = 0.0  # the share of `flops` done on the tensor cores
    tc_peak: float = 0.0   # their FLOP/s

    @property
    def byte_seconds(self):
        return self.bytes / self.bw if self.bw else 0.0

    @property
    def flop_seconds(self):
        fma = self.flops - self.tc_flops
        return ((fma / self.peak if self.peak else 0.0)
                + (self.tc_flops / self.tc_peak if self.tc_peak else 0.0))

    @property
    def floor_seconds(self):
        return max(self.byte_seconds, self.flop_seconds)

    @property
    def bound(self):
        if not self.bytes and not self.flops:
            return "-"
        return "bytes" if self.byte_seconds >= self.flop_seconds \
            else "flops"


def _dtype_bytes(dtype):
    return {"float32": 4, "bfloat16": 2, "float16": 2}[str(dtype)]


NE_PATHS = ("einsum", "gather_fused", "gather_fused_solve", "auto")


def roofline(n_users, n_items, nnz, rank, *, dtype="float32",
             implicit=True, padding_waste=None, devices=1,
             strategy=None, tiles_user=1, tiles_item=1,
             comm_bytes=None, user_part=None, item_part=None,
             user_container=None, item_container=None,
             user_counts=None, item_counts=None,
             min_width=8, chunk_elems=1 << 19, width_growth=2.0,
             ne_path="einsum", cfg=None,
             hbm_gbps=HBM_BYTES_PER_S / 1e9,
             link_gbps=NVLINK_BYTES_PER_S / 1e9,
             measured_s_per_iter=None):
    """The per-stage roofline of one full ALS iteration on ``devices``
    cards (the module docstring has the stages).

    ``ne_path``: 'einsum' prices the unfused build (gather_stream +
    normal_eq + solve), 'gather_fused' K3 + solve, 'gather_fused_solve'
    K4 (the solve folded in), 'auto' the port's per-bucket split by the
    routes of ``cfg`` (an ``AlsConfig``; None: the default at ``rank``),
    :func:`route_split` (needs ``user_counts`` and ``item_counts``).
    ``padding_waste``: explicit, or derived
    from ``user_counts``/``item_counts`` (:func:`modeled_padding_waste`),
    else 1.0.  ``strategy`` with ``tiles_user``/``tiles_item``: the ring
    and chunked strategies re-stream the opposite factors once per row
    tile.  Collective bytes: ``comm_bytes``, or the partitions and
    containers priced by ``parallel.trainer.comm_bytes_per_iter``, or the
    balanced closed form.

    Returns a JSON-ready dict: per-stage accounting, the HBM floor, the
    per-stage floor and, when ``measured_s_per_iter`` is given, the
    measured-over-floor ratios.
    """
    D = max(1, int(devices))
    r = int(rank)
    db = _dtype_bytes(dtype)
    fma_peak = F32_FLOPS_PER_S
    # a float32 product on the tensor cores is three TF32 products
    tc_peak = TF32_FLOPS_PER_S / 3.0 if db == 4 else BF16_FLOPS_PER_S
    hbm = hbm_gbps * 1e9
    link = link_gbps * 1e9
    if ne_path not in NE_PATHS:
        raise ValueError(f"unknown ne_path {ne_path!r} (expected one of "
                         f"{NE_PATHS})")
    if ne_path == "auto" and (user_counts is None or item_counts is None):
        raise ValueError("ne_path='auto' prices each bucket by its route: "
                         "pass user_counts and item_counts")
    padding_waste_source = "explicit"
    if padding_waste is None:
        if user_counts is not None or item_counts is not None:
            sides = [c for c in (user_counts, item_counts) if c is not None]
            padding_waste = sum(
                modeled_padding_waste(c, min_width, chunk_elems,
                                      width_growth)
                for c in sides) / len(sides)
            padding_waste_source = "derived"
        else:
            padding_waste = 1.0
            padding_waste_source = "default"

    # per-device padded entries over BOTH half-steps; solved rows
    P = 2.0 * float(padding_waste) * float(nnz) / D
    n = float(n_users + n_items) / D
    restream = 1.0
    if strategy in ("ring", "ring_overlap", "all_gather_chunked"):
        restream = (float(tiles_user) + float(tiles_item)) / 2.0

    def stage(name, nbytes, flops, tc_flops, note):
        return Stage(name, bytes=nbytes, flops=flops, bw=hbm,
                     peak=fma_peak, note=note, tc_flops=tc_flops,
                     tc_peak=tc_peak)

    def fused_solve(P_, n_):
        return stage(
            "gather_fused_solve",
            fused_solve_kernel_bytes(P_, n_, r, db)
            + (restream - 1.0) * P_ * r * db,
            2.0 * P_ * r * r + 2.0 * P_ * r
            + n_ * (2.0 * r ** 3 / 3.0 + 4.0 * r * r), 2.0 * P_ * r * r,
            "K4: factor rows read once, Gram + tail + solve in the "
            "kernel, only x written (csrc/gather_solve.cu)")

    def fused_ne(P_, n_):
        return stage(
            "gather_fused_ne",
            fused_ne_kernel_bytes(P_, n_, r, db)
            + (restream - 1.0) * P_ * r * db,
            2.0 * P_ * r * r + 2.0 * P_ * r, 2.0 * P_ * r * r,
            "K3: factor rows read once, A/b written "
            "(csrc/gather_gram.cu)")

    def solve(n_):
        return stage(
            "solve", n_ * (r * r + 2.0 * r) * 4.0,
            n_ * (2.0 * r ** 3 / 3.0 + 4.0 * r * r), 0.0,
            "reads A + b, writes x; a Cholesky's recurrences at the f32 "
            "FMA rate (K1/K2 up to rank 128, K6 above)")

    if ne_path == "auto":
        split = [route_split(c, r, cfg, min_width=min_width,
                             chunk_elems=chunk_elems, growth=width_growth)
                 for c in (user_counts, item_counts)]
        P_wide = min(P, sum(p for p, _ in split) / D)
        n_wide = min(n, sum(k for _, k in split) / D)
        stages = [fused_solve(P - P_wide, n - n_wide),
                  fused_ne(P_wide, n_wide), solve(n_wide)]
    elif ne_path == "gather_fused_solve":
        stages = [fused_solve(P, n)]
    elif ne_path == "gather_fused":
        stages = [fused_ne(P, n), solve(n)]
    else:
        stages = [
            stage("gather_stream", restream * (2.0 * P * r * db) + 12.0 * P,
                  0.0, 0.0, "opposite factor rows read + written per "
                  "padded entry, + the cols/vals/mask stream"),
            stage("normal_eq", P * r * db + n * r * r * 4.0,
                  2.0 * P * r * r + 2.0 * P * r, 2.0 * P * r * r,
                  "re-reads the gathered rows, writes [n, r, r] A"),
            solve(n)]
    stages.append(stage("scatter", n * r * 4.0, 0.0, 0.0,
                        "solved rows written back"))
    if implicit:
        yty = 2.0 * 2.0 * (float(n_users + n_items) / D) * r * r
        stages.append(stage(
            "yty", 2.0 * (float(n_users + n_items) / D) * r * 4.0, yty, yty,
            "YtY per half-step"))
    if comm_bytes is None and strategy is not None and D > 1:
        if user_part is not None and item_part is not None:
            from tpu_als_torch.parallel.trainer import comm_bytes_per_iter

            comm_bytes = comm_bytes_per_iter(
                strategy, user_part, item_part, r,
                user_container=user_container,
                item_container=item_container, implicit=implicit)
        else:
            # balanced rows_per_shard = ceil(n/D): the closed forms of
            # trainer.comm_bytes_per_iter (all_to_all needs the built
            # request budgets, so it has no estimate here)
            per_u = -(-int(n_users) // D)
            per_i = -(-int(n_items) // D)
            fb = 4 * r
            if strategy == "all_gather":
                comm_bytes = (D - 1) * (per_i + per_u) * fb
            elif strategy in ("ring", "ring_overlap"):
                comm_bytes = D * fb * (per_i * int(tiles_user)
                                       + per_u * int(tiles_item))
            elif strategy == "all_gather_chunked":
                comm_bytes = (D - 1) * fb * (per_i * int(tiles_user)
                                             + per_u * int(tiles_item))
            if comm_bytes is not None and implicit:
                comm_bytes += 2 * 2 * (D - 1) * r * r * 4 // D
    if comm_bytes:
        stages.append(Stage(
            "collective", bytes=float(comm_bytes), flops=0.0, bw=link,
            peak=fma_peak,
            note=f"{strategy} traffic (= trainer.comm_bytes_per_iter) over "
                 "NVLink, modelled for a box of several cards"))

    hbm_bytes = sum(s.bytes for s in stages if s.bw == hbm)
    total_flops = sum(s.flops for s in stages)
    hbm_floor = hbm_bytes / hbm
    floor = sum(s.floor_seconds for s in stages)
    report = {
        "config": {
            "n_users": int(n_users), "n_items": int(n_items),
            "nnz": int(nnz), "rank": r, "dtype": str(dtype),
            "implicit": bool(implicit),
            "padding_waste": float(padding_waste),
            "padding_waste_source": padding_waste_source,
            "width_growth": float(width_growth),
            "ne_path": ne_path, "devices": D,
            "strategy": strategy,
            "tiles_user": int(tiles_user), "tiles_item": int(tiles_item),
            "hbm_gbps": float(hbm_gbps), "link_gbps": float(link_gbps),
            "fma_tflops": fma_peak / 1e12, "tc_tflops": tc_peak / 1e12,
        },
        "stages": [
            {"name": s.name, "bytes": int(s.bytes), "flops": int(s.flops),
             "byte_seconds": s.byte_seconds,
             "flop_seconds": s.flop_seconds,
             "floor_seconds": s.floor_seconds,
             "bound": s.bound, "note": s.note}
            for s in stages
        ],
        "hbm_bytes_per_iter": int(hbm_bytes),
        "comm_bytes_per_iter": int(comm_bytes or 0),
        "flops_per_iter": int(total_flops),
        "hbm_floor_s_per_iter": hbm_floor,
        "roofline_floor_s_per_iter": floor,
    }
    if measured_s_per_iter:
        report["measured_s_per_iter"] = float(measured_s_per_iter)
        report["measured_over_hbm_floor"] = (
            float(measured_s_per_iter) / hbm_floor if hbm_floor else None)
        report["measured_over_roofline_floor"] = (
            float(measured_s_per_iter) / floor if floor else None)
    return report


def headline_roofline(**overrides):
    """The roofline of the headline configuration (:data:`HEADLINE`),
    with ``overrides``; no measured point unless one is passed
    (``measured_s_per_iter=``)."""
    return roofline(**{**HEADLINE, **overrides})


def render(report):
    """Human-readable table for ``observe roofline``."""
    c = report["config"]
    lines = [
        ("ALS iteration roofline — "
         f"{c['n_users']}x{c['n_items']} nnz={c['nnz']} rank={c['rank']} "
         f"{c['dtype']} {'implicit' if c['implicit'] else 'explicit'} "
         f"waste={c['padding_waste']:.3f}"
         f" ({c.get('padding_waste_source', 'explicit')})"
         f" ne={c.get('ne_path', 'einsum')} D={c['devices']}"
         + (f" strategy={c['strategy']}" if c["strategy"] else "")),
        f"(HBM {c['hbm_gbps']} GB/s, NVLink {c['link_gbps']} GB/s, "
        f"f32 FMA {c['fma_tflops']:g} TFLOP/s, tensor cores "
        f"{c['tc_tflops']:g} TFLOP/s; NVIDIA H100 SXM data sheet)",
        "",
        f"{'stage':<20}{'MB moved':>12}{'GFLOP':>10}"
        f"{'bytes ms':>10}{'flops ms':>10}{'bound':>7}",
    ]
    for s in report["stages"]:
        lines.append(
            f"{s['name']:<20}{s['bytes'] / 1e6:>12.1f}"
            f"{s['flops'] / 1e9:>10.1f}"
            f"{s['byte_seconds'] * 1e3:>10.3f}"
            f"{s['flop_seconds'] * 1e3:>10.3f}{s['bound']:>7}")
    lines += [
        "",
        f"HBM floor (all bytes / BW):     "
        f"{report['hbm_floor_s_per_iter'] * 1e3:.3f} ms/iter",
        f"roofline floor (per-stage max): "
        f"{report['roofline_floor_s_per_iter'] * 1e3:.3f} ms/iter",
    ]
    if "measured_s_per_iter" in report:
        lines.append(
            f"measured:                       "
            f"{report['measured_s_per_iter'] * 1e3:.3f} ms/iter  "
            f"({report['measured_over_hbm_floor']:.1f}x HBM floor, "
            f"{report['measured_over_roofline_floor']:.1f}x roofline)")
    return "\n".join(lines)


# -- the kernel bounds: real work ------------------------------------------
def bound_ms(nbytes, flops, tc_flops):
    """``(bytes ms, operations ms)``: ``nbytes`` over the HBM rate, and
    ``flops`` at the f32 FMA rate plus ``tc_flops`` done in the 3xTF32
    form on the tensor cores (three TF32 products each, at the dense TF32
    rate)."""
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            (flops / F32_FLOPS_PER_S + 3 * tc_flops / TF32_FLOPS_PER_S) * 1e3)


def bound(nbytes, flops, tc_flops=0.0):
    """``(ms, "bytes" or "operations")``: the larger of
    :func:`bound_ms`'s two times."""
    t_b, t_f = bound_ms(nbytes, flops, tc_flops)
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def bound_note(nbytes, flops, tc_flops=0.0):
    """Both sides of :func:`bound` for a log line, and the f32-FMA time
    of the same work (the bound were the Gram off the tensor cores)."""
    t_b, t_f = bound_ms(nbytes, flops, tc_flops)
    fma = (flops + tc_flops) / F32_FLOPS_PER_S * 1e3
    return (f"bytes {t_b:.4f} ms, operations {t_f:.4f} ms (3xTF32 at "
            f"{TF32_FLOPS_PER_S / 1e12:.0f} TFLOP/s), all-FMA {fma:.4f} ms")


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
    """``(flops at the f32 FMA rate, flops on the tensor cores)`` of a
    fused half-step: the Gram on its lower triangle, r(r+1) per real
    entry, runs on the tensor cores in 3xTF32 (K3, K4 and K7 share that
    Gram); b, 2r per real entry, and a Cholesky factorization and two
    substitutions, r³/3 + 2r², per solved row, at the FMA rate."""
    return (real * 2 * r + rows * (r ** 3 / 3 + 2 * r * r),
            real * r * (r + 1))


def fused_solve_bytes(padded, real, rows, r, db=4):
    """K4's and K7's bytes: cols and three weights (16 B in float32) per
    padded entry, a factor row per real entry, x per real row; ``db`` is
    the table's (and the weights') bytes an element."""
    return padded * (4 + 3 * db) + real * r * db + rows * r * 4


def fused_solve_bound(padded, real, rows, r, db=4):
    """``(ms, by)`` of K4 or K7 over ``padded`` entries, ``real`` of them
    real, and ``rows`` real rows at rank r (:func:`fused_solve_bytes`,
    :func:`gram_flops`)."""
    return bound(fused_solve_bytes(padded, real, rows, r, db),
                 *gram_flops(real, rows, r))


def gram_bytes(padded, real, rows, r, db=4):
    """K3's bytes: cols and two weights (12 B in float32) per padded
    entry, a factor row per real entry, S and b per real row."""
    return padded * (4 + 2 * db) + real * r * db + rows * (r * r + r) * 4


def gram_bound(padded, real, rows, r, db=4):
    """``(ms, by)`` of K3: :func:`gram_bytes`, the Gram on the tensor
    cores (3xTF32) and b at the FMA rate, r(r+1) and 2r per real entry."""
    return bound(gram_bytes(padded, real, rows, r, db), real * 2 * r,
                 real * r * (r + 1))


def solve_bound(rows, r, store_l=False):
    """``(ms, by)`` of solving ``rows`` systems of rank r: reading A's
    lower triangle and b, writing x (and, with ``store_l``, L's whole
    square over A); r³/3 + 2r² flops each at the f32 FMA rate."""
    nbytes = rows * (r * (r + 1) // 2 + 2 * r + (r * r if store_l else 0))
    return bound(nbytes * 4, rows * (r ** 3 / 3 + 2 * r * r))


def topk_bound(n, Ni, r, k):
    """K5's and K8's bound: the factor tables, the validity mask and the
    ``[n, k]`` result against the score GEMM as three TF32 products each
    on the tensor cores; and its note with the f32-FMA time beside."""
    nbytes = (n * r + Ni * r) * 4 + Ni + n * k * (4 + 8)
    return bound(nbytes, 0.0, 2 * n * Ni * r), bound_note(nbytes, 0.0,
                                                          2 * n * Ni * r)
