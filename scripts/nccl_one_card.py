#!/usr/bin/env python3
"""Whether NCCL takes two ranks on one CUDA card, the transport question
behind ``tpu_als_torch/parallel/multihost.py``.

Run from the repository root on a machine with the card:

    python3 scripts/nccl_one_card.py

Starts two processes (``torch.distributed`` over ``tcp://localhost``),
each on ``cuda:0``, that try ``init_process_group("nccl")`` and one
``all_reduce`` of a small tensor.  NCCL is expected to refuse the pair
("Duplicate GPU detected"), which is why the port's collectives go
through gloo with CUDA tensors staged through host memory.  Prints each
process's outcome and, last, one JSON line ``{"nccl_two_ranks_one_card":
"refused" | "worked" | "hung", ...}``; exits non-zero without a card.
A process still running after 90 s is killed and counted as hung.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

_CHILD = r"""
import datetime, os, sys, torch, torch.distributed as dist
rank = int(sys.argv[1])
torch.cuda.set_device(0)
try:
    dist.init_process_group("nccl", init_method=sys.argv[2], world_size=2,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    x = torch.ones(4, device="cuda:0") * (rank + 1)
    dist.all_reduce(x)
    torch.cuda.synchronize()
    print("RESULT ok", x.tolist(), flush=True)
except Exception as e:
    print("RESULT error", type(e).__name__, str(e).splitlines()[0][:300],
          flush=True)
"""


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device is visible")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "NCCL_DEBUG": "WARN"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(r), f"tcp://127.0.0.1:{port}"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(2)]
    outcomes = []
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=90)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out = (p.communicate()[0] or "") + "\nRESULT hung"
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
        print(f"process {r} (exit {p.returncode}): "
              f"{lines[-1] if lines else out[-500:]}")
        tail = [ln for ln in out.splitlines() if "uplicate" in ln]
        outcomes.append((lines[-1] if lines else "RESULT none", tail[:1]))
    kinds = {o.split()[1] for o, _ in outcomes}
    verdict = ("worked" if kinds == {"ok"} else
               "hung" if "hung" in kinds else "refused")
    print(json.dumps({"nccl_two_ranks_one_card": verdict,
                      "nccl": ".".join(map(str, torch.cuda.nccl.version())),
                      "device": torch.cuda.get_device_name(0),
                      "messages": [o for o, _ in outcomes]
                      + [t[0] for _, t in outcomes if t]}))


if __name__ == "__main__":
    main()
