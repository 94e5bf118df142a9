#!/usr/bin/env python3
"""Whether two processes on one CUDA card can map each other's device
buffers through legacy CUDA IPC, the transport of kernels K7 and K8
across processes (``tpu_als_torch/parallel/peer.py``).  The twin of
``scripts/nccl_one_card.py``.

Run from the repository root on a machine with the card:

    python3 scripts/ipc_one_card.py

Starts two processes on ``cuda:0``, joined over gloo by a ``file://``
rendezvous in a temporary directory.  Each builds one
``peer.PeerBuffer`` (``csrc/peer_ipc.cu``: ``cudaMalloc``,
``cudaIpcGetMemHandle``, the handles exchanged over gloo,
``cudaIpcOpenMemHandle`` of the peer's).  Process 0 fills its buffer;
after a barrier process 1 reads it through its mapping, checks it, and
writes into it; after another barrier process 0 reads process 1's write
back.  Then process 1 times copies of 1 GiB out of the peer's buffer and
out of its own (CUDA events, 5 copies each after one to warm up), and
both close (barrier, close, barrier, free).  Prints each process's
outcome and, last, one JSON line ``{"ipc_one_card": "worked" |
"refused" | "hung", ...}``; exits non-zero without a card.  A process
still running after 120 s is killed and counted as hung.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIB = 1 << 30


def child(rank, init_method):
    sys.path.insert(0, ROOT)
    import time

    import torch

    from tpu_als_torch.parallel import multihost, peer

    out = {"rank": rank}
    try:
        torch.cuda.set_device(0)
        multihost.init_distributed(init_method=init_method, world_size=2,
                                   rank=rank)
        n = GIB // 4
        t0 = time.perf_counter()
        buf = peer.PeerBuffer(GIB, "cuda:0")
        out["open_ms"] = (time.perf_counter() - t0) * 1e3
        want = torch.arange(n, device="cuda:0", dtype=torch.float32)
        if rank == 0:
            buf.local((n,), torch.float32).copy_(want)
        peer.publish()
        if rank == 1:
            theirs = peer.view(buf.ptrs[0], (n,), torch.float32, "cuda:0")
            out["read_ok"] = bool(torch.equal(theirs, want))
            theirs.mul_(2.0)
        peer.publish()
        if rank == 0:
            out["write_back_ok"] = bool(torch.equal(
                buf.local((n,), torch.float32), 2.0 * want))
        if rank == 1:
            dst = torch.empty(n, device="cuda:0")
            mine = buf.local((n,), torch.float32)
            for name, src in (("peer", theirs), ("own", mine)):
                dst.copy_(src)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(5):
                    dst.copy_(src)
                b.record()
                b.synchronize()
                ms = a.elapsed_time(b) / 5
                # a copy reads and writes GiB each
                out[f"copy_from_{name}_ms"] = ms
                out[f"copy_from_{name}_GBps"] = 2 * GIB / ms / 1e6
            del theirs, mine, dst
        buf.close()
        out["open_after_close"] = dict(peer.OPEN)
        print("RESULT ok " + json.dumps(out), flush=True)
    except Exception as e:  # noqa: BLE001 - the outcome is the finding
        print("RESULT error " + json.dumps(
            {**out, "error": f"{type(e).__name__}: "
                             f"{str(e).splitlines()[0][:300]}"}),
              flush=True)


def main():
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device is visible")
    from tpu_als_torch import _build

    for name in ("peer_alloc",):
        _build.load(name)  # built once here, before the children load it
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    with tempfile.TemporaryDirectory(prefix="ipc_one_card_") as td:
        from tpu_als_torch.parallel import multihost

        init = multihost.file_init_method(td)
        env = {**os.environ, "PYTHONPATH": ROOT}
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", str(r),
             init], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=ROOT) for r in range(2)]
        results = []
        for r, p in enumerate(procs):
            try:
                text, _ = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                text = (p.communicate()[0] or "") + "\nRESULT hung {}"
            lines = [ln for ln in text.splitlines()
                     if ln.startswith("RESULT")]
            print(f"process {r} (exit {p.returncode}): "
                  f"{lines[-1] if lines else text[-800:]}")
            results.append(lines[-1] if lines else "RESULT none {}")
    kinds = {x.split()[1] for x in results}
    rows = [json.loads(x.split(" ", 2)[2]) for x in results]
    ok = (kinds == {"ok"} and rows[1].get("read_ok")
          and rows[0].get("write_back_ok"))
    verdict = "worked" if ok else "hung" if "hung" in kinds else "refused"
    print(f"card: {smi}")
    print(json.dumps({
        "ipc_one_card": verdict,
        "route": "legacy CUDA IPC: cudaMalloc, cudaIpcGetMemHandle, "
                 "cudaIpcOpenMemHandle (cudaIpcMemLazyEnablePeerAccess)",
        "device": torch.cuda.get_device_name(0), "card": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "processes": rows}))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child(int(sys.argv[2]), sys.argv[3])
    else:
        main()
