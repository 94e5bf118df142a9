"""Run K4's and K7's cluster solve (``tpu_als_torch/csrc/chol_cluster.cuh``)
on the CPU, under a thread stand-in for CUDA, against float64 and against
``chol_tiled.cuh``'s ``stream_solve`` (bit for bit).

The headers are copied into a temporary directory with what g++ cannot
take replaced (the ``rsqrt.approx`` inline PTX by ``1/sqrtf``, each
``cp.async`` by a plain copy and its group wait by nothing, the named
barrier of warps 0 and 1 by a 64-thread barrier, the ``<<<...>>>``
launches stripped) and compiled with
``scripts/cluster_shim/``'s ``cuda_runtime.h`` and ``cooperative_groups.h``:
every CUDA thread is a ``std::thread``, a block's barrier, each warp's and
the cluster's are ``std::barrier``s, a shuffle goes through a per-warp
buffer, ``map_shared_rank`` maps into the peer block's buffer.  The stand-in
rounds like the card except where it replaces PTX, and both routines go
through it, so their bitwise agreement checks the order of operations.

    python3 scripts/chol_cluster_shim.py [--ranks 289 320] [--seed 0]

Exits 1 on a mismatch.  Needs ``g++`` (C++20); a rank takes seconds (C
blocks of 512 threads, 2 at ranks up to 384, 4 above).
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "tpu_als_torch", "csrc")
SHIM = os.path.join(ROOT, "scripts", "cluster_shim")
HEADERS = ("chol_tiled.cuh", "chol_cluster.cuh", "tf32.cuh")
# (pattern, replacement, the header that must hold it): the PTX g++
# cannot take, and the launches
SUBS = (
    (r'asm\("rsqrt\.approx\.ftz\.f32 %0, %1;" : "=f"\(y\) : "f"\(d\)\);',
     "y = 1.0f / std::sqrt(d);", "chol_tiled.cuh"),
    (r'asm volatile\("cp\.async\.cg\.shared\.global.*?\);',
     "*reinterpret_cast<float4*>(dst) = "
     "*reinterpret_cast<const float4*>(src);", "chol_cluster.cuh"),
    (r'asm volatile\("cp\.async\.ca\.shared\.global.*?\);', "*dst = *src;",
     "chol_cluster.cuh"),
    (r'asm volatile\("cp\.async\.(commit|wait)_group.*?\);', ";", "tf32.cuh"),
    (r'asm\("mma\.sync.*?\);', ";", "tf32.cuh"),
    (r"<<<[^>]*>>>", "", "chol_tiled.cuh"),
    (r'asm volatile\("bar\.sync 1, 64;" ::: "memory"\);', "shim_pair_sync();",
     "chol_cluster.cuh"),
)
# x against the float64 solution of the same f32 system, relative to |x|
F64_REL = 1e-4


def build(work):
    """Compile the runner against copies of the headers in ``work``;
    returns the executable's path."""
    for name in HEADERS:
        with open(os.path.join(CSRC, name)) as f:
            text = f.read()
        for pattern, repl, where in SUBS:
            text, n = re.subn(pattern, repl, text, flags=re.S)
            if name == where and n == 0:
                raise RuntimeError(f"{name}: {pattern!r} not found")
        with open(os.path.join(work, name), "w") as f:
            f.write(text)
    exe = os.path.join(work, "runner")
    subprocess.run(["g++", "-std=c++20", "-O2", "-pthread", f"-I{SHIM}",
                    f"-I{work}", os.path.join(SHIM, "runner.cpp"), "-o", exe],
                   check=True, capture_output=True, text=True)
    return exe


def plans(exe):
    """{r: (cluster size, shared bytes a block, owners)} for r = 289 ..
    512, as the header computes them (the runner's --plan)."""
    out = subprocess.run([exe, "--plan"], check=True, capture_output=True,
                         text=True, timeout=60).stdout
    rows = (list(map(int, line.split())) for line in out.splitlines())
    return {r: (c, nbytes, tuple(own)) for r, c, nbytes, *own in rows}


def problem(r, seed, empty=False, with_add=True):
    """A row as K4's solve pass finds it: S = GᵀG (exactly symmetric f32,
    G [2r, r]), YᵀY (a PSD f32 matrix, lower triangle read), b, the
    count, the ridge and the jitter; ``empty``: count 0, b 0."""
    g = np.random.default_rng(seed)
    G = g.standard_normal((2 * r, r)).astype(np.float32)
    S = (G.T @ G).astype(np.float32)
    S = np.tril(S) + np.tril(S, -1).T
    Y = g.standard_normal((r // 2, r)).astype(np.float32)
    add = (Y.T @ Y / np.float32(r)).astype(np.float32) if with_add else \
        np.zeros((r, r), np.float32)
    b = g.standard_normal(r).astype(np.float32)
    cnt = np.float32(0 if empty else 2 * r)
    if empty:
        b[:] = 0
    return S, add, b, cnt, np.float32(0.01) * cnt, np.float32(1e-6)


def run(exe, work, r, S, add, b, cnt, ridge, jitter, with_add=True):
    """(x of the cluster solve, x of stream_solve, cluster size, shared
    bytes a block)."""
    src, dst = os.path.join(work, "in.bin"), os.path.join(work, "out.bin")
    with open(src, "wb") as f:
        f.write(np.array([r, int(with_add)], np.int32).tobytes())
        for a in (S, add, b, np.array([cnt, ridge, jitter], np.float32)):
            f.write(np.ascontiguousarray(a, np.float32).tobytes())
    subprocess.run([exe, src, dst], check=True, timeout=600)
    raw = open(dst, "rb").read()
    xc = np.frombuffer(raw[:4 * r], np.float32)
    xs = np.frombuffer(raw[4 * r:8 * r], np.float32)
    C = int(np.frombuffer(raw[8 * r:8 * r + 4], np.int32)[0])
    nbytes = int(np.frombuffer(raw[8 * r + 4:8 * r + 12], np.int64)[0])
    return xc, xs, C, nbytes


def system64(S, add, cnt, ridge, jitter):
    """The f32 system the tail forms, in float64 (lower triangle mirrored)."""
    r = S.shape[0]
    A = (S + add).astype(np.float32)
    d = np.arange(r)
    A[d, d] = (A[d, d] + ridge) + jitter
    if cnt <= 0:
        A = np.eye(r, dtype=np.float32) * np.float32(1 + jitter)
    L = np.tril(A).astype(np.float64)
    return L + np.tril(L, -1).T


def check(exe, work, r, seed):
    """Returns the list of failures at rank r (empty: passed)."""
    bad = []
    for empty, with_add in ((False, True), (False, False), (True, True)):
        S, add, b, cnt, ridge, jitter = problem(r, seed, empty, with_add)
        xc, xs, C, nbytes = run(exe, work, r, S, add, b, cnt, ridge, jitter,
                                with_add)
        tag = (f"r={r} C={C} {nbytes} B a block "
               f"{'empty' if empty else 'add' if with_add else 'no add'}")
        if not np.array_equal(xc.view(np.uint32), xs.view(np.uint32)):
            bad.append(f"{tag}: cluster x != stream_solve x "
                       f"(max |diff| {np.abs(xc - xs).max():.3e})")
        if empty:
            if not np.all(xc == 0):
                bad.append(f"{tag}: an empty row did not solve to 0")
            print(f"{tag}: x == 0, bitwise stream_solve", flush=True)
            continue
        x64 = np.linalg.solve(system64(S, add, cnt, ridge, jitter),
                              b.astype(np.float64))
        rel = np.abs(xc - x64).max() / np.abs(x64).max()
        if not rel <= F64_REL:
            bad.append(f"{tag}: max |x - x64| / max |x64| {rel:.3e}")
        print(f"{tag}: bitwise stream_solve, max |x - x64| / max |x64| "
              f"{rel:.3e} (tol {F64_REL})", flush=True)
    return bad


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=[289, 320])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if shutil.which("g++") is None:
        sys.exit("g++ is not on the PATH")
    with tempfile.TemporaryDirectory(prefix="chol_cluster_shim_") as work:
        exe = build(work)
        bad = [m for r in args.ranks for m in check(exe, work, r, args.seed)]
    for m in bad:
        print("FAIL:", m)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
