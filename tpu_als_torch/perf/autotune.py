"""The measured autotuner for the training path's kernel knobs.

Counterpart of ``tpu_als/perf/autotune.py``, with its discipline: a small
discrete space searched one knob at a time from the defaults (trial 0),
each trial timed min-of-k on the real path, the winner the strict
measured minimum with ties going to the earlier trial (so a tuned config
never loses its own A/B to the defaults), a ``budget_s`` stop, a
``tune_trial`` event a trial, and the verdict banked by the planner
(``plan.resolve_kernel_config``) beside the roofline's prediction.

The reference's space is Pallas tiling (``panel``, ``vmem_budget``,
``max_wc``, the DMA ``depth``) plus the table's type.  The Hopper
kernels' tiles are template constants, so the port's space is the
run-time knobs that decide the training path's launches today, each
defaulting to the constant it replaces (an untuned run is the untuned
path, bit for bit):

- ``split_width`` (2^11, 2^12, 2^13, 2^14, 2^16; default
  ``core.als.SPLIT_WIDTH``, 2^13): the width at which 'auto' leaves K4
  (one block a row) for K3 (the row cut over blocks in chunks of this
  many entries) + K1/K6, and K3's chunk width.  2^13 was picked by hand
  at one rank; the values span a factor 4 below it and 8 above.
- ``scratch_elems`` (2^22, 2^24, 2^26, 2^28; default
  ``cuda_gather_ne._SCRATCH_ELEMS``, 2^28): K4's row tile in floats.  K4
  writes each row's Gram, b and count to scratch in one pass and reads
  them back to solve in the next.  2^28 floats (1 GiB) goes through HBM;
  2^22 (16 MiB, 254 rows at rank 128) stays in the H100's 50 MB L2, at
  the price of more launches.
The table's type, the reference's own fifth knob, is left out: on the
card bfloat16 never won a trial (0.96x of the defaults at rank 128,
PERF.md), because the Gram is bound by operations, not by the table's
bytes, and a tuner that lowers a float32 fit to bfloat16 buys speed
with precision the user did not choose.  ``AlsConfig.compute_dtype``
stays the user's choice; the timer runs at it, and the bank keys on it.

Two timers, one protocol (one warm call, then the least of ``k``
calls, each fenced with ``torch.cuda.synchronize`` on the card):

- a fit tunes on its own traffic.  ``core.als.train`` (and
  ``parallel.trainer.train_sharded``) pass :func:`make_step_timer` over
  one iteration of the fit itself, from its initial factors, on its own
  buckets, and key the verdict on the problem's ``plan.shape_class``;
  ``plan tune --data`` tunes the same way, under the same key, ahead of
  the fit.
- :func:`make_timer` is a synthetic sweep for ``plan tune`` without
  data: one ``core.als.local_half_step`` under 'auto' on an implicit
  side whose bucket widths double from ``w`` to ``max_w``, ``max(8, n
  >> j)`` rows each, so buckets lie on both sides of every
  ``split_width`` value and K4, K3 and K1 (K6 above rank 128) launch in
  every trial.  It is a test of the kernels across the split, not a
  workload's degree distribution: its verdict is banked under the
  ``"generic"`` shape class, which no fit reads.

On the CPU either timer runs the plain versions and the verdict's
``source`` is ``"plain"`` (never banked over a ``"device"`` one).
:func:`model_seconds` is the least time of the timed work under the
config's split: ``perf/roofline.py``'s kernel bounds summed over the
timed buckets.

The re-plan loop: :func:`drifted` compares a banked measured/modeled
ratio with a fresh one; outside the band (``TPU_ALS_TUNE_BAND``) the
planner's entry is invalidated and the next armed resolve re-tunes.
"""

from __future__ import annotations

import importlib
import os
import time

import numpy as np

from tpu_als_torch import obs
from tpu_als_torch.core import als as core_als
from tpu_als_torch.ops import cuda_gather_ne as gne

SPACE = {
    "split_width": (1 << 11, 1 << 12, 1 << 13, 1 << 14, 1 << 16),
    "scratch_elems": (1 << 22, 1 << 24, 1 << 26, 1 << 28),
}

# K4 gives a row one block: past about 2^18 entries one block holds
# more than 1/132 of an ML-25M half-step's Gram work (core/als.py's
# SPLIT_WIDTH note), and the launch lasts as long as that block
MAX_SPLIT_WIDTH = 1 << 18

TUNE_BAND_ENV = "TPU_ALS_TUNE_BAND"
DEFAULT_TUNE_BAND = 2.0

# the timer's implicit configuration (chip_smoke.py's training slice)
_REG, _ALPHA = 0.01, 40.0


def tune_band(default=DEFAULT_TUNE_BAND):
    """The measured/modeled drift band (a factor > 1);
    ``TPU_ALS_TUNE_BAND`` overrides."""
    raw = os.environ.get(TUNE_BAND_ENV, "")
    try:
        band = float(raw) if raw else float(default)
    except ValueError:
        band = float(default)
    return max(1.0 + 1e-9, band)


def drifted(banked_ratio, current_ratio, band=None):
    """True when a fresh measured/modeled ratio has left the banked
    ratio's band: the re-plan trigger."""
    band = tune_band() if band is None else float(band)
    if not banked_ratio or not current_ratio:
        return False
    rel = float(current_ratio) / float(banked_ratio)
    return rel > band or rel < 1.0 / band


def default_config():
    """Trial 0: the constants the knobs replace, read when called
    (``core.als.SPLIT_WIDTH``, ``cuda_gather_ne._SCRATCH_ELEMS``), so a
    patched constant is still the untuned path."""
    return {"split_width": core_als.SPLIT_WIDTH,
            "scratch_elems": gne._SCRATCH_ELEMS}


def enumerate_configs(space=None, defaults=None):
    """The one-at-a-time trial list: ``defaults`` (None:
    :func:`default_config`) first, then each knob's alternatives with the
    others held at their defaults.  A default missing from a restricted
    space is replaced by that space's first value; an unknown knob is a
    ``ValueError``."""
    space = dict(SPACE if space is None else space)
    base = dict(default_config() if defaults is None else defaults)
    unknown = sorted(k for k in space if k not in base)
    if unknown:
        raise ValueError(f"unknown autotune knob {unknown[0]!r}; "
                         f"knobs: {sorted(SPACE)}")
    base.update({k: v[0] for k, v in space.items() if base[k] not in v})
    trials = [dict(base)]
    for knob, values in space.items():
        for v in values:
            if v == base[knob]:
                continue
            cfg = dict(base)
            cfg[knob] = v
            trials.append(cfg)
    return trials


def feasible(config, rank):
    """Whether the kernels take ``config`` at ``rank``: a split width of
    at least 1 and at most
    :data:`MAX_SPLIT_WIDTH` (K4's one-block-a-row ceiling); and, where K4
    runs (rank <= 512), a scratch tile of at least one row's Gram, b and
    count (``cuda_gather_ne._row_floats``) and within the trainer's
    per-launch budget (2^28 floats)."""
    try:
        split = int(config["split_width"])
        scratch = int(config["scratch_elems"])
    except (KeyError, TypeError, ValueError):
        return False
    r = int(rank)
    if not 1 <= r <= gne.GRAM_MAX_RANK:
        return False
    if not 1 <= split <= MAX_SPLIT_WIDTH:
        return False
    if r <= gne.SOLVE_MAX_RANK and not (
            gne._row_floats(r) <= scratch <= core_als._MEM_ELEMS):
        return False
    return True


def bucket_shapes(n, w, max_w):
    """The synthetic timer's buckets, ``[(width, rows)]``: widths w·2^j
    up to ``max_w``, ``max(8, n >> j)`` rows each."""
    out = []
    j = 0
    while (int(w) << j) <= int(max_w):
        out.append((int(w) << j, max(8, int(n) >> j)))
        j += 1
    return out


def _real_entries(width):
    """Real entries a synthetic row of ``width`` holds: entry j is real
    unless j % 5 == 4 (the mask 80 % full)."""
    return width - width // 5


def synthetic_shapes(n, w, max_w):
    """``[(width, rows, real entries)]`` of the synthetic timer's
    buckets, what :func:`model_seconds` prices."""
    return [(width, rows, rows * _real_entries(width))
            for width, rows in bucket_shapes(n, w, max_w)]


def data_shapes(*containers):
    """``[(width, rows, real entries)]`` of host bucket containers
    (``CsrBuckets``, the sharded ones): each bucket's leading axes
    (shards, sources, rows) count as its rows."""
    out = []
    for c in containers:
        for b in c.buckets:
            width = int(b.cols.shape[-1])
            out.append((width, int(b.cols.size) // max(1, width),
                        int(np.count_nonzero(b.mask))))
    return out


def _table_rows(n):
    # the opposite table the half-step gathers from: 40 rows a bucket row
    # of the narrowest bucket, 163,840 at n = 4,096 (about ML-25M's
    # 162,541 users, the table its item half-step gathers)
    return max(64, 40 * int(n))


def _instance(rank, n, w, max_w, seed):
    """The synthetic side, host numpy from ``seed``: the opposite table
    [N, r] f32 and the buckets (rows, cols, vals, mask), implicit ratings
    1..5, entry j of a row real unless j % 5 == 4."""
    from tpu_als_torch.core.ratings import Bucket

    rng = np.random.default_rng(int(seed))
    N = _table_rows(n)
    V = (rng.normal(size=(N, rank)) / np.sqrt(rank)).astype(np.float32)
    buckets, row0 = [], 0
    for width, rows in bucket_shapes(n, w, max_w):
        mask = np.broadcast_to((np.arange(width) % 5 != 4),
                               (rows, width)).astype(np.float32)
        cols = (rng.integers(0, N, size=(rows, width)) * mask).astype(
            np.int32)
        vals = (rng.integers(1, 6, size=(rows, width)) * mask).astype(
            np.float32)
        buckets.append(Bucket(rows=np.arange(row0, row0 + rows),
                              cols=cols, vals=vals, mask=mask))
        row0 += rows
    return V, buckets, row0


def make_step_timer(prepare, device, *, shapes, shape, k=3):
    """``timer(config) -> seconds``: ``prepare(knobs)`` returns the
    zero-argument call to time with the config's knobs; one warm call,
    then the least of ``k`` calls, each fenced (``torch.cuda.
    synchronize`` on the card).  ``timer.source`` is ``"device"`` on the
    card and ``"plain"`` on the CPU (the plain versions);
    ``timer.shapes`` (``[(width, rows, real entries)]``) is what the
    call solves, for :func:`model_seconds`; ``timer.shape`` is the
    instance banked as provenance."""
    import torch

    dev = torch.device(device)

    def fence():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timer(config):
        run = prepare({"split_width": int(config["split_width"]),
                       "scratch_elems": int(config["scratch_elems"])})
        run()
        fence()
        best = None
        for _ in range(max(1, int(k))):
            t0 = time.perf_counter()
            run()
            fence()
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        return best

    timer.source = "device" if dev.type == "cuda" else "plain"
    timer.shapes = list(shapes)
    timer.shape = dict(shape, k=int(k))
    return timer


def make_timer(rank, compute_dtype, *, n=4096, w=64, max_w=1 << 17, k=3,
               seed=0, device=None):
    """The synthetic timer: one ``core.als.local_half_step`` under
    'auto', at ``compute_dtype``, with the config's knobs on the
    :func:`bucket_shapes` side made from ``seed`` (:func:`make_step_timer`'s
    protocol).  ``device`` None: the card.  The default widths reach
    2^17, past every ``split_width`` value, so every trial runs both K4
    and K3."""
    import torch

    from tpu_als_torch.core.ratings import buckets_to
    from tpu_als_torch.ops.solve import compute_yty
    from tpu_als_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    V_np, host, num_rows = _instance(int(rank), n, w, max_w, seed)
    V = torch.from_numpy(V_np).to(dev)
    buckets = buckets_to(host, dev)
    YtY = compute_yty(V)
    cfg = core_als.AlsConfig(rank=int(rank), implicit_prefs=True,
                             alpha=_ALPHA, reg_param=_REG,
                             compute_dtype=str(compute_dtype))

    def prepare(knobs):
        return lambda: core_als.local_half_step(V, buckets, num_rows, cfg,
                                                YtY, knobs=knobs)

    return make_step_timer(
        prepare, dev, shapes=synthetic_shapes(n, w, max_w), k=k,
        shape={"rank": int(rank), "n": int(n), "w": int(w),
               "max_w": int(max_w), "seed": int(seed)})


def model_seconds(config, rank, shapes, compute_dtype="float32"):
    """The least time of the timed work under ``config``: over
    ``shapes`` (``[(width, rows, real entries)]``),
    ``fused_solve_bound`` for each bucket the config's split sends to
    K4, ``gram_bound`` + ``solve_bound`` (K1; K6 writing L above rank
    128) for each it sends to K3, with the table's bytes at
    ``compute_dtype`` (``perf/roofline.py``, the bounds ``chip_smoke.py``
    reports)."""
    rl = importlib.import_module("tpu_als_torch.perf.roofline")

    r = int(rank)
    db = 2 if "bfloat16" in str(compute_dtype) else 4
    cfg = core_als.AlsConfig(rank=r, implicit_prefs=True)
    ms = 0.0
    for width, rows, real in shapes:
        padded = rows * width
        path = core_als.resolve_solve_path(cfg, r, width,
                                           int(config["split_width"]))
        if path in core_als._K4_PATHS:
            ms += rl.fused_solve_bound(padded, real, rows, r, db)[0]
        else:
            ms += (rl.gram_bound(padded, real, rows, r, db)[0]
                   + rl.solve_bound(rows, r, store_l=r > 128)[0])
    return ms / 1e3


def tune(*, rank=128, compute_dtype="float32", space=None, budget_s=120.0,
         k=3, n=4096, w=64, max_w=1 << 17, seed=0, timer=None,
         device=None, kernel="local_half_step"):
    """The one-at-a-time search; returns the verdict the planner banks::

        {"config", "measured_seconds", "default_seconds",
         "model_seconds", "source", "trials", "tune_seconds", "shape"}

    ``timer(config) -> seconds`` is injectable (``timer.source`` says
    where it measured, without it ``"plain"``; ``timer.shapes`` and
    ``timer.shape`` what it solved, without them the synthetic side of
    ``n``, ``w``, ``max_w``); the default is :func:`make_timer` on
    ``device``.  Infeasible configs are skipped and never banked.  The
    search stops once ``budget_s`` is spent; the defaults are always
    trial 0.  A trial that raises fails the search, naming its config."""
    if timer is None:
        timer = make_timer(rank, compute_dtype, n=n, w=w, max_w=max_w, k=k,
                           seed=seed, device=device)
    source = getattr(timer, "source", "plain")
    shapes = getattr(timer, "shapes", None) or synthetic_shapes(n, w, max_w)
    shape = getattr(timer, "shape", None) or {
        "rank": int(rank), "n": int(n), "w": int(w), "max_w": int(max_w),
        "k": int(k), "seed": int(seed)}
    trials = []
    best_cfg, best_s = None, None
    t_start = time.perf_counter()
    for config in enumerate_configs(space):
        if trials and budget_s is not None \
                and time.perf_counter() - t_start > float(budget_s):
            break
        if not feasible(config, rank):
            continue
        try:
            seconds = float(timer(config))
        except Exception as e:
            raise RuntimeError(f"autotune trial {config} at rank {rank} "
                               f"failed: {e}") from e
        obs.emit("tune_trial", kernel=kernel, config=dict(config),
                 seconds=seconds)
        trials.append({"config": dict(config), "seconds": seconds,
                       "model_seconds": model_seconds(config, rank, shapes,
                                                      compute_dtype)})
        if best_s is None or seconds < best_s:   # strict: a tie keeps the
            best_cfg, best_s = dict(config), seconds  # earlier trial
    if best_cfg is None:
        raise ValueError(f"no feasible config at rank {rank} in the "
                         f"given space")
    return {
        "config": best_cfg,
        "measured_seconds": best_s,
        "default_seconds": trials[0]["seconds"],
        "model_seconds": model_seconds(best_cfg, rank, shapes,
                                       compute_dtype),
        "source": source,
        "trials": trials,
        "tune_seconds": time.perf_counter() - t_start,
        "shape": shape,
    }
