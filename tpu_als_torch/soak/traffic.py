"""Seeded synthetic workload model: the soak's "millions of users".

Counterpart of ``tpu_als/soak/traffic.py``, a copy of it in numpy (no
torch): :func:`stream_bytes` of a config is byte-identical to the
reference's, so either package replays the other's workload.

One deterministic generator emits BOTH sides of the production load —
serve queries and rating-arrival events — window by window:

- **zipfian item popularity**: item ranks are drawn with weight
  ``1/(rank+1)^s`` over a catalog that GROWS per window
  (``catalog_growth`` items join every window, so late windows rate
  items the trained model has never seen — the fold-in path's catalog-
  growth contract under sustained load);
- **diurnal load**: the per-window rate is the base rate scaled by
  ``1 + amp * sin(2π·w / day_windows)`` — a compressed day, so a soak
  of a few minutes sweeps a peak and a trough;
- **per-tenant request mixes**: each tenant's share of both streams is
  its declared weight over the weight total (the fairness verdict
  judges answered-per-offered across tenants, so the mix is the
  fairness test's ground truth);
- **poison**: each rating event is independently poisoned with
  probability ``poison_frac`` (its rating arrives as ``None`` — the
  orchestrator materializes ``nan`` at submit time, exercising the
  quarantine path; ``None`` rather than ``nan`` keeps the canonical
  byte stream strict JSON).

Determinism contract: every draw comes from ``np.random.default_rng(
[seed, window])`` in a FIXED order (serve counts/times/users per tenant
in declared order, then rating counts/times/users/items/values/poison),
so ``generate_window(cfg, w)`` is a pure function of ``(config, w)``
and :func:`stream_bytes` is byte-identical across processes and
platforms (numpy's PCG64 is specified).  The determinism test pins
exactly that, cross-process.

TAL003 note: no wall-clock RNG anywhere in this module — seeds are
config, never ``time``.
"""

from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass

import numpy as np


@dataclass(frozen=True)
class TrafficConfig:
    """The whole workload model, one frozen value.  ``(seed, schedule)``
    — where schedule is every other field — replays byte-for-byte."""

    seed: int = 17
    # (name, weight) per tenant, declared order = draw order
    tenants: tuple = (("a", 3.0), ("b", 1.0))
    windows: int = 8
    window_s: float = 3.0        # compressed wall seconds per window
    day_windows: int = 4         # diurnal period, in windows
    base_qps: float = 40.0       # serve queries/sec at the diurnal mean
    diurnal_amp: float = 0.5     # 0..1 swing around the mean
    update_qps: float = 25.0     # rating events/sec at the diurnal mean
    zipf_s: float = 1.1          # popularity exponent
    catalog0: int = 48           # items in the catalog at window 0
    catalog_growth: int = 6      # items joining per window
    n_users: int = 64
    poison_frac: float = 0.02
    k: int = 5                   # top-k per serve query

    def __post_init__(self):
        if self.windows < 1 or self.window_s <= 0:
            raise ValueError("windows >= 1 and window_s > 0 required")
        if not self.tenants:
            raise ValueError("at least one tenant required")
        if not 0.0 <= self.poison_frac <= 1.0:
            raise ValueError("poison_frac must be in [0, 1]")
        if self.day_windows < 1:
            raise ValueError("day_windows >= 1 required")

    def to_dict(self):
        d = asdict(self)
        d["tenants"] = [list(t) for t in self.tenants]
        return d

    @classmethod
    def from_dict(cls, d):
        d = dict(d)
        d["tenants"] = tuple((str(n), float(w)) for n, w in d["tenants"])
        return cls(**d)


def load_multiplier(cfg, w):
    """The diurnal curve at window ``w``: 1 ± amp over a compressed day
    of ``day_windows`` windows (clamped non-negative)."""
    phase = 2.0 * math.pi * (w % cfg.day_windows) / cfg.day_windows
    return max(0.0, 1.0 + cfg.diurnal_amp * math.sin(phase))


def catalog_size(cfg, w):
    """Items sampleable at window ``w`` — the growing catalog."""
    return cfg.catalog0 + cfg.catalog_growth * w


def max_catalog(cfg):
    return catalog_size(cfg, cfg.windows - 1)


def zipf_weights(n, s):
    """Normalized ``1/(rank+1)^s`` over ``n`` items (rank 0 is the
    most popular)."""
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), s)
    return w / w.sum()


def generate_window(cfg, w):
    """Every op of window ``w``, time-ordered.  Serve ops::

        {"op": "serve", "t": <offset s>, "tenant": str, "user": int,
         "k": int}

    Rating ops::

        {"op": "rate", "t": <offset s>, "tenant": str, "user": int,
         "item": int, "rating": float | None, "poison": bool}

    ``item`` indexes the zipf-ranked catalog of THIS window (late
    windows reach items earlier windows could not).  ``rating`` is
    ``None`` iff ``poison`` — the submitter turns it into ``nan``.
    """
    if not 0 <= w < cfg.windows:
        raise ValueError(f"window {w} outside 0..{cfg.windows - 1}")
    rng = np.random.default_rng([int(cfg.seed), int(w)])
    mult = load_multiplier(cfg, w)
    total_weight = sum(wt for _, wt in cfg.tenants)
    n_items = catalog_size(cfg, w)
    zw = zipf_weights(n_items, cfg.zipf_s)
    ops = []
    # draw order is the determinism contract — serve side first,
    # tenants in declared order, then the rating side the same way
    for name, weight in cfg.tenants:
        lam = cfg.base_qps * mult * cfg.window_s * weight / total_weight
        n = int(rng.poisson(lam))
        times = np.sort(rng.uniform(0.0, cfg.window_s, n))
        users = rng.integers(0, cfg.n_users, n)
        for j in range(n):
            ops.append({"op": "serve", "t": round(float(times[j]), 6),
                        "tenant": name, "user": int(users[j]),
                        "k": cfg.k})
    for name, weight in cfg.tenants:
        lam = cfg.update_qps * mult * cfg.window_s * weight / total_weight
        n = int(rng.poisson(lam))
        times = np.sort(rng.uniform(0.0, cfg.window_s, n))
        users = rng.integers(0, cfg.n_users, n)
        items = rng.choice(n_items, size=n, p=zw)
        ratings = np.round(rng.uniform(1.0, 5.0, n), 3)
        poison = rng.random(n) < cfg.poison_frac
        for j in range(n):
            p = bool(poison[j])
            ops.append({"op": "rate", "t": round(float(times[j]), 6),
                        "tenant": name, "user": int(users[j]),
                        "item": int(items[j]),
                        "rating": None if p else float(ratings[j]),
                        "poison": p})
    # stable total order: time, then kind, then tenant (ties are rare
    # but the byte-replay contract cannot tolerate ambiguity)
    ops.sort(key=lambda o: (o["t"], o["op"], o["tenant"],
                            o.get("user", -1), o.get("item", -1)))
    return ops


def stream(cfg):
    """Yield ``(window, ops)`` for every window in order."""
    for w in range(cfg.windows):
        yield w, generate_window(cfg, w)


def stream_bytes(cfg):
    """The whole workload as canonical JSON-lines bytes — the object the
    byte-for-byte replay pin compares across processes.  Strict JSON
    (``allow_nan=False``): poisoned ratings are ``null``."""
    out = []
    for w, ops in stream(cfg):
        for op in ops:
            rec = {"window": w, **op}
            out.append(json.dumps(rec, sort_keys=True,
                                  separators=(",", ":"),
                                  allow_nan=False))
    return ("\n".join(out) + "\n").encode()


def window_counts(cfg, w):
    """Offered-load summary of one window without materializing ops:
    {tenant: {"serve": n, "rate": n}} — convenience for tests/docs."""
    ops = generate_window(cfg, w)
    out = {name: {"serve": 0, "rate": 0} for name, _ in cfg.tenants}
    for op in ops:
        out[op["tenant"]]["serve" if op["op"] == "serve" else "rate"] += 1
    return out
