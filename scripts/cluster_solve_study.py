"""Where K4's solve pass above rank 288 spends its time on the card.

    python3 scripts/cluster_solve_study.py [--parent DIR]

On one H100, at the ML-25M shape and rank 512 (the item half-step's K4
buckets from the seeded init):

1. ``scripts/cluster_probe.cu``: the cycles of one cluster barrier and of
   a panel's push into the peers' shared memory;
2. the phases of ``csrc/chol_cluster.cuh::solve``: a copy of ``csrc/``
   with clock64 probes inserted by text substitution around each phase
   (its anchors must match the header: edit both together), its
   ``gather_solve.cu`` built and swapped in for K4 for one pass over the
   buckets; the first block's thread 0 of cluster 101 of each launch
   prints its cycles by phase, averaged here by block;
3. ``chip_smoke.k4_split`` (K3's Gram, K1's ``stream_solve``, K4 and its
   pass: K4 less the Gram) and one iteration under the profiler, on this
   checkout and, with ``--parent``, on another checkout's package (a
   process of its own, which imports that package and this checkout's
   ``chip_smoke.py``).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("load", "wait", "hand_out", "panel", "push", "barrier2", "trail",
          "backward", "pulls")
# (anchor, text put before it, text put after it) in chol_cluster.cuh:
# each PROF(i) adds the cycles since the last probe to phase i
PROBES = (
    ("  cl.sync();\n\n  // float4 copies", "  PROF(0)\n", ""),
    ("    cl.sync();  // D_k, inv and rcp in every block\n", "    PROF(2)\n",
     "    PROF(1)\n"),
    ("    __syncthreads();\n    for (int e = tid; e < (C - 1) * m * kTile4",
     "    PROF(3)\n", ""),
    ("    cl.sync();  // the panel tiles and y_k in every block\n",
     "    PROF(4)\n", "    PROF(5)\n"),
    ("    __syncthreads();\n  }\n\n  // the backward", "    PROF(6)\n", ""),
    ("    cl.sync();  // x_k in every block\n", "    PROF(7)\n",
     "    PROF(1)\n"),
    ("    __syncthreads();\n  }\n  cl.sync();  // no block leaves",
     "    PROF(8)\n", ""),
)


def log(msg):
    print(msg, flush=True)


def load_chip_smoke():
    sys.path.append(ROOT)  # after a --tree checkout, whose package wins
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def instrumented(work):
    """A copy of csrc/ with the phase probes; returns its directory."""
    dst = os.path.join(work, "csrc")
    shutil.copytree(os.path.join(ROOT, "tpu_als_torch", "csrc"), dst)
    path = os.path.join(dst, "chol_cluster.cuh")
    s = open(path).read()
    head = "  cg::cluster_group cl = cg::this_cluster();\n"
    s = s.replace(head, "  long long pt[9] = {};\n  long long tp = clock64();\n"
                  "#define PROF(i) { const long long t_ = clock64(); "
                  "pt[i] += t_ - tp; tp = t_; }\n" + head, 1)
    for anchor, before, after in PROBES:
        if s.count(anchor) != 1:
            raise RuntimeError(f"chol_cluster.cuh: anchor {anchor!r} moved")
        s = s.replace(anchor, before + anchor + after)
    s = s.replace("  cl.sync();  // no block leaves while a peer may read "
                  "its tiles\n", "  cl.sync();  // no block leaves while a "
                  "peer may read its tiles\n  PROF(1)\n  if (tid == 0 && "
                  "blockIdx.x / C == 101)\n    printf(\"phases %d %lld %lld "
                  "%lld %lld %lld %lld %lld %lld %lld\\n\", me, pt[0], pt[1], "
                  "pt[2], pt[3], pt[4], pt[5], pt[6], pt[7], pt[8]);\n")
    s = s.replace("#include <stdint.h>\n", "#include <stdint.h>\n#include "
                  "<cstdio>\n", 1)
    open(path, "w").write(s)
    return dst


def rank512(cs, dev):
    """The rank-512 item half-step's K4 buckets from the seeded init."""
    frame = cs.ml25m_frame(0)
    u_idx, umap = cs.remap_ids(frame["user"])
    i_idx, imap = cs.remap_ids(frame["item"])
    rat = frame["rating"]
    ucsr = cs.build_csr_buckets(u_idx, i_idx, rat, len(umap), native=True)
    icsr = cs.build_csr_buckets(i_idx, u_idx, rat, len(imap), native=True)
    r = cs.RANK512
    cfg = cs.core_als.AlsConfig(rank=r, implicit_prefs=True, alpha=cs.ALPHA,
                                reg_param=cs.REG)
    g = cs.torch.Generator().manual_seed(0)
    tr = {"ub": ucsr.to(dev), "ib": icsr.to(dev), "n_users": len(umap),
          "n_items": len(imap), "cfg": cfg}
    tr["U0"] = cs.core_als.init_factors(len(umap), r, g).to(dev)
    tr["V0"] = cs.core_als.init_factors(len(imap), r, g).to(dev)
    return tr


def split_and_profile(cs, tr, smi):
    cs.k4_split(tr, smi)
    it = cs.training_iteration(tr)
    log(f"rank 512 iteration: {cs.cuda_ms(it, 2):.1f} ms (CUDA events, 2 "
        f"reps; {smi})")
    cs.profiled(cs.RANK512, "training iteration", it)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="another checkout: its split and profile too")
    ap.add_argument("--tree", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree:  # the parent's process: its package first on the path
        sys.path.insert(0, os.path.abspath(args.tree))
    cs = load_chip_smoke()
    torch = cs.torch
    if not torch.cuda.is_available():
        sys.exit("cluster_solve_study: no CUDA device is visible")
    cs.pin_fp32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"{cs.cuda_gather_ne.__file__}; {smi}")
    cs._build.load_all()
    cs.fastbucket.load()
    dev = torch.device("cuda")
    if args.tree:
        split_and_profile(cs, rank512(cs, dev), smi)
        return
    nvcc = cs._build._nvcc()
    with tempfile.TemporaryDirectory(prefix="cluster_study_") as work:
        probe = os.path.join(work, "probe")
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-O3", "-o", probe,
                        os.path.join(ROOT, "scripts", "cluster_probe.cu")],
                       check=True)
        log(subprocess.run([probe], capture_output=True, text=True,
                           check=True).stdout.strip())
        lib = os.path.join(work, "libphases.so")
        subprocess.run([nvcc, *cs._build.NVCC_FLAGS, "-o", lib, os.path.join(
            instrumented(work), "gather_solve.cu")], check=True)
        fn = ctypes.CDLL(lib).gather_solve
        fn.argtypes = cs._build.SIGNATURES["gather_solve"][1]
        fn.restype = ctypes.c_int
        tr = rank512(cs, dev)
        U0, cfg = tr["U0"], tr["cfg"]
        YtY = cs.compute_yty(U0)
        kept = cs._build._LIBS["gather_solve"]
        cs._build._LIBS["gather_solve"] = fn
        out = os.path.join(work, "phases.txt")
        # the device's printf goes to this process's stdout: catch it in a
        # file for the pass
        sys.stdout.flush()
        saved = os.dup(1)
        with open(out, "w") as f:
            os.dup2(f.fileno(), 1)
            try:
                for b in tr["ib"]:
                    if cs.core_als.resolve_solve_path(cfg, cs.RANK512,
                                                      b.width) == \
                            "gatherfused_solve":
                        cs.cuda_gather_ne.gather_fused_solve_implicit(
                            U0, b.cols, b.vals, b.mask, cs.REG, cs.ALPHA, YtY)
                torch.cuda.synchronize()
            finally:
                sys.stdout.flush()
                os.dup2(saved, 1)
        cs._build._LIBS["gather_solve"] = kept
        rows = {}
        for line in open(out):
            m = re.match(r"phases (\d+) (.*)", line)
            if m:
                rows.setdefault(int(m.group(1)), []).append(
                    [int(v) for v in m.group(2).split()])
        for block, vals in sorted(rows.items()):
            avg = [sum(c) / len(vals) for c in zip(*vals)]
            log(f"phases, block {block} of the cluster ({len(vals)} rows; "
                f"thousands of cycles): " + ", ".join(
                    f"{n} {a / 1e3:.1f}" for n, a in zip(PHASES, avg))
                + f"; total {sum(avg) / 1e3:.1f}")
    split_and_profile(cs, tr, smi)
    del tr
    torch.cuda.empty_cache()
    if args.parent:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--tree",
                        os.path.abspath(args.parent)], check=True)


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    log(f"{time.perf_counter() - t0:.1f} s")
