"""Time builds of K4's solve pass side by side on the card.

    python3 scripts/cluster_variants.py NAME=CSRC_DIR[:NVCC_DEFINES] ...

Each argument names a copy of ``tpu_als_torch/csrc`` (a variant of
``chol_cluster.cuh``, say) and, after a colon, comma-separated ``-D``
flags for it.  Each copy's ``gather_solve.cu`` is built with the port's
nvcc flags and loaded with ctypes; this checkout's own build is ``this``.
Each build is then swapped in for K4 (``_build._LIBS['gather_solve']``)
and checked against K1's streamed solve bit for bit
(``chip_smoke.check_cluster_solve``; a build that is not is reported and
still timed), and the rank-512 item half-step's K4 buckets at the ML-25M
shape and one iteration are timed with CUDA events, in the order given
and then reversed (A, B, B, A).  Prints ``nvcc -Xptxas -v``'s registers
and spills of each build's cluster kernel.
"""

from __future__ import annotations

import ctypes
import importlib.util
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch, _build = cs.torch, cs._build
    if not torch.cuda.is_available():
        sys.exit("cluster_variants: no CUDA device is visible")
    cs.pin_fp32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    work = tempfile.mkdtemp(prefix="cluster_variants_")
    builds = []
    for arg in sys.argv[1:]:
        name, _, rest = arg.partition("=")
        src, _, defs = rest.partition(":")
        out = os.path.join(work, f"{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               *(f"-D{d}" for d in defs.split(",") if d), "-o", out,
               os.path.join(os.path.abspath(src), "gather_solve.cu")]
        builds.append((name, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    _build.load_all()
    cs.fastbucket.load()
    libs = {"this": _build.load("gather_solve")}
    for name, out, proc in builds:
        text, _ = proc.communicate()
        lines = text.splitlines()
        for i, line in enumerate(lines):
            if "tail_cluster_kernelIf" in line and "Function properties" in line:
                print(f"{name}: " + " ".join(lines[i:i + 3]), flush=True)
        if proc.returncode != 0:
            print(f"{name}: build failed\n{text[-2000:]}", flush=True)
            continue
        fn = ctypes.CDLL(out).gather_solve
        fn.argtypes = _build.SIGNATURES["gather_solve"][1]
        fn.restype = ctypes.c_int
        libs[name] = fn
    dev = torch.device("cuda")
    rng = cs.np.random.default_rng(0)
    for name, fn in libs.items():
        _build._LIBS["gather_solve"] = fn
        try:
            cs.check_cluster_solve(rng, dev)
            print(f"{name}: bit for bit K1's streamed solve", flush=True)
        except SystemExit as e:
            print(f"{name}: {e}", flush=True)
    frame = cs.ml25m_frame(0)
    u_idx, umap = cs.remap_ids(frame["user"])
    i_idx, imap = cs.remap_ids(frame["item"])
    rat = frame["rating"]
    ub = cs.build_csr_buckets(u_idx, i_idx, rat, len(umap), native=True)
    ib = cs.build_csr_buckets(i_idx, u_idx, rat, len(imap), native=True)
    r = cs.RANK512
    cfg = cs.core_als.AlsConfig(rank=r, implicit_prefs=True, alpha=cs.ALPHA,
                                reg_param=cs.REG)
    g = torch.Generator().manual_seed(0)
    tr = {"ub": ub.to(dev), "ib": ib.to(dev), "n_users": len(umap),
          "n_items": len(imap), "cfg": cfg,
          "U0": cs.core_als.init_factors(len(umap), r, g).to(dev),
          "V0": cs.core_als.init_factors(len(imap), r, g).to(dev)}
    YtY = cs.compute_yty(tr["U0"])
    k4_b = [b for b in tr["ib"] if cs.core_als.resolve_solve_path(
        cfg, r, b.width) == "gatherfused_solve"]

    def k4():
        return [cs.cuda_gather_ne.gather_fused_solve_implicit(
            tr["U0"], b.cols, b.vals, b.mask, cs.REG, cs.ALPHA, YtY)
            for b in k4_b]

    it = cs.training_iteration(tr)
    order = list(libs) + list(libs)[::-1]
    for name in order:
        _build._LIBS["gather_solve"] = libs[name]
        print(f"{name}: K4 rank 512, the item half-step's {len(k4_b)} K4 "
              f"buckets {cs.cuda_ms(k4, 2):.2f} ms, an iteration "
              f"{cs.cuda_ms(it, 1):.1f} ms ({smi})", flush=True)


if __name__ == "__main__":
    main()
