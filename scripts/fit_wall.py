#!/usr/bin/env python3
"""Log-to-model time of ``tpu_als_torch.ALS.fit`` on one CUDA card, for
one or more checkouts of the repository, side by side.

Run from the repository root on a machine with the card:

    python3 scripts/fit_wall.py [--order A,B,B,A] CHECKOUT_A CHECKOUT_B ...

Each run is a fresh process whose working directory is the checkout
named (the port is imported from there, its kernels built there), in the
order given (default: each checkout once, then again in reverse).  A run
builds the kernels and warms the card with a small fit, makes the
ML-25M-shaped ratings (``synthetic_movielens(162541, 59047, 25000095,
seed=0)``, not timed) and times ``ALS(rank=128,
implicitPrefs=True, alpha=40, regParam=0.01, maxIter=3).fit`` by the
host clock, ending in a device sync: id remapping, host blocking of both
sides, the move to the card and three iterations.  The first
``fitCallback`` splits the fit into what comes before the first
iteration ends (host set-up and iteration 1) and iterations 2-3.  Prints
one line a run, tagged ``FITWALL``, with the card's name and power
limit; exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = r"""
import json, os, sys, time
sys.path.insert(0, os.getcwd())
import torch
from tpu_als_torch import ALS, _build
from tpu_als_torch.io.movielens import ML25M_SHAPE, synthetic_movielens
if not torch.cuda.is_available():
    raise SystemExit("fit_wall: no CUDA device is visible")
_build.load_all()
ticks = []
def tick(it, U, V):
    torch.cuda.synchronize()
    ticks.append(time.perf_counter())
est = ALS(rank=128, implicitPrefs=True, alpha=40.0, regParam=0.01,
          maxIter=3, fitCallback=tick)
est.fit(synthetic_movielens(2000, 800, 40000, seed=1))  # warm the card
frame = synthetic_movielens(*ML25M_SHAPE, seed=0)
frame = {k: frame[k] for k in ("user", "item", "rating")}
ticks.clear()
t0 = time.perf_counter()
model = est.fit(frame)
torch.cuda.synchronize()
t1 = time.perf_counter()
print(json.dumps({"fit_s": t1 - t0, "to_first_iteration_end_s":
                  ticks[0] - t0, "iterations_2_3_s": ticks[-1] - ticks[0],
                  "finite": bool(torch.isfinite(model._U).all())}))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--order", default=None,
                    help="comma-separated indices or labels A, B, ... "
                         "(default: forward, then reverse)")
    args = ap.parse_args()
    paths = [os.path.abspath(p) for p in args.checkouts]
    labels = [chr(ord("A") + k) for k in range(len(paths))]
    order = (args.order.split(",") if args.order
             else labels + labels[::-1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    for lab in order:
        path = paths[labels.index(lab)]
        out = subprocess.run([sys.executable, "-c", _CHILD], cwd=path,
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            sys.stderr.write(out.stderr[-4000:])
            raise SystemExit(f"fit_wall: the run in {path} failed")
        res = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"FITWALL {lab} {path}: " + json.dumps(res)
              + f" ({smi.splitlines()[0]})", flush=True)


if __name__ == "__main__":
    main()
