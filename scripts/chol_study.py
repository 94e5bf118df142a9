#!/usr/bin/env python3
"""Where kernels K1 and K6 spend their time on one CUDA card, before and
after their redesign.

Run from the repository root on a machine with the card:

    python3 scripts/chol_study.py

The first port's K1 and K6 (and K2) are kept, as they were, under
``scripts/chol_study_parent/``.  Every kernel here is built by ``nvcc``
into a temporary directory and loaded with ``ctypes``.  Two shapes:
"fold-in" (4,096 random SPD systems ``M Mᵀ/r + 0.5·I``) and "fit" (the
item half-step's wide buckets at the ML-25M shape from a seeded init,
one launch a bucket, as ``core.als.local_half_step`` issues them).

1. the first port's K1 and K6 with ``clock64()`` probes, inserted by
   text into copies: cycles a block (one system) split into phases,
   thread 0's clock, the mean over blocks;
2. the same split of the current on-chip body (``csrc/chol_tiled.cuh``)
   that K1 and K6 run;
3. the first port's K1, K6 + two ``solve_triangular`` and K2 against
   the current K1, K6's fused entry and K2, side by side in the order
   first port, current, current, first port (ms, CUDA events; a launch
   of the fit timed alone on a primed card, as ``chip_smoke.py`` does).

Prints one line a measurement, each tagged ``STUDY``; exits non-zero
without a card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

# the repository root (the working directory) holds chip_smoke.py
import chip_smoke as cs  # noqa: E402
from tpu_als_torch import _build  # noqa: E402
from tpu_als_torch.core import als as core_als  # noqa: E402
from tpu_als_torch.core.ratings import (  # noqa: E402
    build_csr_buckets, remap_ids)
from tpu_als_torch.io.movielens import (  # noqa: E402
    ML25M_SHAPE, synthetic_movielens)
from tpu_als_torch.ops import (  # noqa: E402
    cuda_lanes, cuda_lanes_blocked, cuda_solve)
from tpu_als_torch.ops import solve as tsolve  # noqa: E402
from tpu_als_torch.utils.platform import pin_fp32  # noqa: E402

PARENT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "chol_study_parent")
P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
ARGS7 = [P, P, P, LL, I, P, P]


def edit(text, pairs):
    """``text`` with each (old, new) replaced; each old must occur once."""
    for old, new in pairs:
        if text.count(old) != 1:
            raise SystemExit(f"chol_study: probe anchor not found once: "
                             f"{old[:60]!r}")
        text = text.replace(old, new)
    return text


MARK = ("{ long long now_ = clock64(); pacc[%d] += now_ - last; "
        "last = now_; }")
SYNC_MARK = "{ __syncthreads(); " + MARK[2:]
PROBE_OUT = ("  if (threadIdx.x == 0) {\n"
             "    for (int i = 0; i < 4; ++i) prof[5 * blockIdx.x + i] = "
             "pacc[i];\n    prof[5 * blockIdx.x + 4] = clock64() - t0;\n"
             "  }\n")
PROBE_IN = ("  long long pacc[4] = {0, 0, 0, 0}, last = clock64(), "
            "t0 = last;\n")

# the first port's K1 (chol_blocked.cu + chol_blocked.cuh): fill, panel
# recurrence, trailing update, substitutions
PARENT_K1 = [
    ("chol_blocked.cuh", [
        ("__device__ __forceinline__ void factorize(float* S, float* Lp, "
         "int r) {",
         "__device__ __forceinline__ void factorize(float* S, float* Lp, "
         "int r, long long& last, long long* pacc) {"),
        ("    __syncthreads();  // the previous trailing update has landed\n",
         "    __syncthreads();  // the previous trailing update has landed\n"
         + MARK % 2 + "\n"),
        ("    // ... and update the trailing block (columns >= p+pw): one "
         "warp per\n",
         MARK % 1 + "\n    // ... and update the trailing block (columns "
         ">= p+pw): one warp per\n"),
        ("  }\n  __syncthreads();\n}\n\n// Solve L",
         "  }\n  __syncthreads();\n" + MARK % 2 + "\n}\n\n// Solve L"),
    ]),
    ("chol_blocked.cu", [
        ("float* __restrict__ x, int r) {",
         "float* __restrict__ x, int r, long long* prof) {\n" + PROBE_IN),
        ("  cholb::factorize(S, Lp, r);  // opens and closes with a "
         "barrier\n  cholb::substitute(S, r, res, b + sys * r, x + sys * "
         "r);",
         "  __syncthreads();\n" + MARK % 0 + "\n"
         "  cholb::factorize(S, Lp, r, last, pacc);\n"
         "  cholb::substitute(S, r, res, b + sys * r, x + sys * r);\n"
         + MARK % 3 + "\n" + PROBE_OUT),
        ("long long n, int r, void* stream) {",
         "long long n, int r, void* stream, long long* prof) {"),
        ("(A, b, x, r);", "(A, b, x, r, prof);"),
    ]),
]
PARENT_K1_PHASES = ["fill", "panel recurrence", "trailing update",
                    "substitutions"]

# the first port's K6 (chol_lanes_blocked.cu): staging and corrections,
# the diagonal factorization, the rows below, the write-back
PARENT_K6 = [
    ("chol_lanes_blocked.cu", [
        ("chol_lanes_blocked_kernel(float* A, int r) {",
         "chol_lanes_blocked_kernel(float* A, int r, long long* prof) {\n"
         + PROBE_IN),
        ("    tile_update(A, r, c0, c0, acc, Pi, Pk);\n",
         "    tile_update(A, r, c0, c0, acc, Pi, Pk);\n" + SYNC_MARK % 0
         + "\n"),
        ("    cholb::factorize(Lkk, Lp, bk);  // opens and closes with a "
         "barrier\n",
         "    cholb::factorize(Lkk, Lp, bk);\n" + SYNC_MARK % 1 + "\n"),
        ("      A[i * r + c0 + c] = 0.f;\n    }\n",
         "      A[i * r + c0 + c] = 0.f;\n    }\n" + SYNC_MARK % 3 + "\n"),
        ("            C[(t0 + ty * 4 + x) * kStride + tx * 4 + y] = "
         "acc[x][y];\n      }\n      __syncthreads();",
         "            C[(t0 + ty * 4 + x) * kStride + tx * 4 + y] = "
         "acc[x][y];\n      }\n" + SYNC_MARK % 0),
        ("          w[j] = s / fmaxf(Lj[j], kPivotFloor);\n        }\n"
         "      }\n      __syncthreads();",
         "          w[j] = s / fmaxf(Lj[j], kPivotFloor);\n        }\n"
         "      }\n" + SYNC_MARK % 2),
        ("        A[(ch0 + i) * r + c0 + c] = C[i * kStride + c];\n      }",
         "        A[(ch0 + i) * r + c0 + c] = C[i * kStride + c];\n      }\n"
         + SYNC_MARK % 3),
        ("      // the next chunk's first tile_update opens with a barrier\n"
         "    }\n  }\n}",
         "    }\n  }\n" + PROBE_OUT + "}"),
        ("extern \"C\" int chol_lanes_blocked_f32(float* A, long long n, "
         "int r,\n                                      void* stream) {",
         "extern \"C\" int chol_lanes_blocked_f32(float* A, long long n, "
         "int r,\n                                      void* stream, "
         "long long* prof) {"),
        ("(A, r);\n  return", "(A, r, prof);\n  return"),
    ]),
]
PARENT_K6_PHASES = ["staging + corrections", "diagonal factorization",
                    "rows below", "write-back"]

# the current on-chip body (K1: kSolve, no store; K6: kSolve and store):
# the load, the diagonal tiles, the panels (with the last warp's forward
# solve of the tile), the trailing updates (with its residual rows), the
# backward substitution (warp 0) and, for K6, the store (thread 32)
CURRENT = [
    ("chol_tiled.cuh", [
        ("namespace cholt {\n",
         "namespace cholt {\n__device__ long long* g_prof;\n"),
        ("template <bool kDiv = false, bool kFwd = false>\n"
         "__device__ __forceinline__ void factorize(float* S, int T, "
         "int r = 0,\n                                          "
         "const float* b = nullptr) {",
         "template <bool kDiv = false, bool kFwd = false>\n"
         "__device__ __forceinline__ void factorize(float* S, int T, "
         "int r = 0,\n                                          "
         "const float* b = nullptr, long long* pacc = nullptr, "
         "long long last = 0) {"),
        ("  float y[kNB];\n  __syncthreads();\n  for (int k = 0; k < T; "
         "++k) {",
         "  float y[kNB];\n  __syncthreads();\n  if (pacc) " + MARK % 0
         + "\n  for (int k = 0; k < T; ++k) {"),
        ("      diagonal_tile<kDiv>(Dk, inv + k * kNB, rcp + k * kNB);\n"
         "    __syncthreads();\n    if (solver) {",
         "      diagonal_tile<kDiv>(Dk, inv + k * kNB, rcp + k * kNB);\n"
         "    __syncthreads();\n    if (pacc) " + MARK % 1
         + "\n    if (solver) {"),
        ("                  inv + k * kNB, rcp + k * kNB, m, nt);\n"
         "    __syncthreads();\n",
         "                  inv + k * kNB, rcp + k * kNB, m, nt);\n"
         "    __syncthreads();\n    if (pacc) " + MARK % 2 + "\n"),
        ("      trailing(S, k, m, nt);\n    __syncthreads();\n  }\n"
         "  if (kFwd) __syncthreads();\n}",
         "      trailing(S, k, m, nt);\n    __syncthreads();\n"
         "    if (pacc) " + MARK % 3 + "\n  }\n  if (kFwd) __syncthreads();"
         "\n  if (pacc) " + MARK % 2 + "\n}"),
        ("  load_lower(smem, r, Ag, vec);\n  const int T = tiles(r);\n"
         "  // opens and closes with a barrier\n"
         "  factorize<kDiv, kSolve>(smem, T, r, kSolve ? b + sys * r : "
         "nullptr);\n"
         "  if (kSolve && threadIdx.x < 32)\n"
         "    substitute<kDiv, true>(smem, T, r, nullptr, x + sys * r);\n"
         "  else if (kStore)\n"
         "    store_lower(smem, r, Ag, vec, kSolve ? 1 : 0);\n}",
         "  long long pacc[7] = {0, 0, 0, 0, 0, 0, 0}, last = clock64(), "
         "t0 = last;\n"
         "  load_lower(smem, r, Ag, vec);\n  const int T = tiles(r);\n"
         "  factorize<kDiv, kSolve>(smem, T, r, kSolve ? b + sys * r : "
         "nullptr, pacc, last);\n  last = clock64();\n"
         "  if (kSolve && threadIdx.x < 32) {\n"
         "    substitute<kDiv, true>(smem, T, r, nullptr, x + sys * r);\n"
         "    " + MARK % 4 + "\n  } else if (kStore) {\n"
         "    store_lower(smem, r, Ag, vec, kSolve ? 1 : 0);\n"
         "    " + MARK % 5 + "\n  }\n  __syncthreads();\n"
         "  if (threadIdx.x == 0 || threadIdx.x == 32) {\n"
         "    long long* p = g_prof + 7 * blockIdx.x;\n"
         "    for (int i = 0; i < 6; ++i) if (pacc[i]) p[i] = pacc[i];\n"
         "    if (threadIdx.x == 0) p[6] = clock64() - t0;\n  }\n}"),
    ]),
]
CURRENT_PHASES = ["load", "diagonal tiles", "panels (+ forward tile)",
                  "trailing (+ forward rest)", "backward substitution",
                  "store (warps 1-15)"]
CURRENT_ENTRY = r'''
#include "chol_tiled.cuh"
template <bool kDiv, bool kStore>
static int go(float* A, const float* b, float* x, long long n, int r,
              void* stream, long long* prof) {
  cudaMemcpyToSymbol(cholt::g_prof, &prof, sizeof(prof));
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int smem = cholt::smem_floats(r) * 4, vec = r % 4 == 0;
  const unsigned blocks = static_cast<unsigned>(n);
  auto s = static_cast<cudaStream_t>(stream);
  if (cholt::tiles(r) <= 4 && n > sms) {
    auto k = cholt::onchip_kernel<kDiv, true, kStore, 256>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    k<<<blocks, 256, smem, s>>>(A, b, x, r, vec);
  } else {
    auto k = cholt::onchip_kernel<kDiv, true, kStore, 512>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    k<<<blocks, 512, smem, s>>>(A, b, x, r, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
extern "C" int study_k1(float* A, const float* b, float* x, long long n,
                        int r, void* s, long long* p) {
  return go<false, false>(A, b, x, n, r, s, p);
}
extern "C" int study_k6(float* A, const float* b, float* x, long long n,
                        int r, void* s, long long* p) {
  return go<true, true>(A, b, x, n, r, s, p);
}
'''


def build(tmp, name, sources, edits, main):
    """Copy ``sources`` (dir -> file names) into ``tmp/name``, apply
    ``edits``, compile ``main`` there; returns the loaded library."""
    d = os.path.join(tmp, name)
    os.makedirs(d)
    for src_dir, files in sources:
        for fn in files:
            with open(os.path.join(src_dir, fn)) as f:
                text = f.read()
            for target, pairs in edits:
                if target == fn:
                    text = edit(text, pairs)
            with open(os.path.join(d, fn), "w") as f:
                f.write(text)
    so = os.path.join(d, f"lib{name}.so")
    p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", d, "-o",
                        so, os.path.join(d, main)], capture_output=True,
                       text=True)
    if p.returncode:
        raise SystemExit(f"chol_study: nvcc failed for {name}:\n"
                         f"{p.stdout}{p.stderr}")
    return ctypes.CDLL(so)


def split(tag, launches, call, phases, width):
    """Run ``call(A, b, x, prof)`` on each launch; print the mean cycles a
    block and each phase's share."""
    rows = []
    for A, b in launches:
        prof = torch.zeros(b.shape[0], width, dtype=torch.int64,
                           device="cuda")
        err = call(A.clone(), b, torch.empty_like(b), prof)
        torch.cuda.synchronize()
        if err:
            raise SystemExit(f"chol_study: {tag}: CUDA error {err}")
        rows.append(prof.double().cpu())
    m = torch.cat(rows).mean(0)
    total = m[width - 1].item()
    print(f"STUDY split {tag}: {total:.0f} cycles a block; "
          + ", ".join(f"{n} {m[i].item():.0f} ({m[i].item() / total:.2f})"
                      for i, n in enumerate(phases)), flush=True)


def fit_launches(ib, n_users, n_items, r):
    """The regularized systems of each wide-bucket solve of the item
    half-step from the seeded init, as ``local_half_step`` issues them."""
    U0 = core_als.init_factors(n_users, r,
                               torch.Generator().manual_seed(0)).cuda()
    cfg = core_als.AlsConfig(rank=r, implicit_prefs=True, alpha=cs.ALPHA,
                             reg_param=cs.REG)
    calls, real = [], core_als.solve_spd

    def record(A, rhs, count, jitter=tsolve.DEFAULT_JITTER,
               backend="auto"):
        calls.append((tsolve.regularize(A, count, jitter),
                      rhs.contiguous()))
        return real(A, rhs, count, jitter=jitter, backend=backend)

    core_als.solve_spd = record
    try:
        core_als.local_half_step(U0, ib, n_items, cfg,
                                 tsolve.compute_yty(U0))
    finally:
        core_als.solve_spd = real
    return calls


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chol_study: no CUDA device is visible")
    pin_fp32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"STUDY device: {smi}", flush=True)
    _build.load_all()
    tmp = tempfile.mkdtemp(prefix="chol_study_")
    pk1 = build(tmp, "pk1", [(PARENT, ["chol_blocked.cu",
                                       "chol_blocked.cuh"])],
                PARENT_K1, "chol_blocked.cu").chol_blocked_f32
    pk6 = build(tmp, "pk6", [(PARENT, ["chol_lanes_blocked.cu",
                                       "chol_blocked.cuh"])],
                PARENT_K6, "chol_lanes_blocked.cu").chol_lanes_blocked_f32
    pk2 = build(tmp, "pk2", [(PARENT, ["chol_solve.cu", "chol_tiled.cuh"])],
                [], "chol_solve.cu").chol_solve_f32
    # the first port's K1 and K6 without probes, for the times
    tk1 = build(tmp, "tk1", [(PARENT, ["chol_blocked.cu",
                                       "chol_blocked.cuh"])],
                [], "chol_blocked.cu").chol_blocked_f32
    tk6 = build(tmp, "tk6", [(PARENT, ["chol_lanes_blocked.cu",
                                       "chol_blocked.cuh"])],
                [], "chol_lanes_blocked.cu").chol_lanes_blocked_f32
    with open(os.path.join(tmp, "current.cu"), "w") as f:
        f.write(CURRENT_ENTRY)
    cur = build(tmp, "cur", [(_build.CSRC, ["chol_tiled.cuh"]),
                             (tmp, ["current.cu"])], CURRENT, "current.cu")
    pk1.argtypes = ARGS7
    pk6.argtypes = [P, LL, I, P, P]
    pk2.argtypes = tk1.argtypes = [P, P, P, LL, I, P]
    tk6.argtypes = [P, LL, I, P]
    cur.study_k1.argtypes = cur.study_k6.argtypes = ARGS7

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def first_k1(A, b, x, prof):
        return pk1(A.data_ptr(), b.data_ptr(), x.data_ptr(), b.shape[0],
                   b.shape[1], stream(), prof.data_ptr())

    def first_k6(A, b, x, prof):
        return pk6(A.data_ptr(), b.shape[0], b.shape[1], stream(),
                   prof.data_ptr())

    def current(fn):
        return lambda A, b, x, prof: fn(
            A.data_ptr(), b.data_ptr(), x.data_ptr(), b.shape[0],
            b.shape[1], stream(), prof.data_ptr())

    def first_k6_route(A, b):
        assert tk6(A.data_ptr(), b.shape[0], b.shape[1], stream()) == 0
        return cs.triangular(A, b)

    def first_k2(A, b):
        x = torch.empty_like(b)
        assert pk2(A.data_ptr(), b.data_ptr(), x.data_ptr(), b.shape[0],
                   b.shape[1], stream()) == 0
        return x

    def first_k1_solve(A, b):
        x = torch.empty_like(b)
        assert tk1(A.data_ptr(), b.data_ptr(), x.data_ptr(), b.shape[0],
                   b.shape[1], stream()) == 0
        return x

    def compare(tag, launches, first, now, writes_a):
        """first port, current, current, first port: ms summed over the
        launches, each on a primed card."""
        res = {"first port": [], "current": []}
        for who in ("first port", "current", "current", "first port"):
            fn = first if who == "first port" else now
            tot = 0.0
            for A, b in launches:
                Aw = torch.empty_like(A)
                tot += cs.kernel_ms_each(
                    (lambda: Aw.copy_(A)) if writes_a else (lambda: None),
                    lambda: fn(Aw if writes_a else A, b), 10)
            res[who].append(tot)
        print(f"STUDY time {tag} ({len(launches)} launches): first port "
              + " / ".join(f"{t:.4f}" for t in res["first port"])
              + " ms, current " + " / ".join(f"{t:.4f}"
                                              for t in res["current"])
              + " ms", flush=True)

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    shapes = {}
    for r in (128, 256):
        A, b = cs.spd_batch(rng, 4096, r, dev)
        shapes[("fold-in", r)] = [(A, b)]
    frame = synthetic_movielens(*ML25M_SHAPE, seed=0)
    u_idx, umap = remap_ids(frame["user"])
    i_idx, imap = remap_ids(frame["item"])
    ib = build_csr_buckets(i_idx, u_idx, frame["rating"],
                           len(imap)).to(dev)
    for r in (128, 256):
        shapes[("fit", r)] = fit_launches(ib, len(umap), len(imap), r)
    print("STUDY fit: systems a launch "
          + str([b.shape[0] for _, b in shapes[("fit", 128)]]), flush=True)
    for what in ("fold-in", "fit"):
        k1, k6 = shapes[(what, 128)], shapes[(what, 256)]
        split(f"first port K1 {what} r=128", k1, first_k1,
              PARENT_K1_PHASES, 5)
        split(f"first port K6 {what} r=256", k6, first_k6,
              PARENT_K6_PHASES, 5)
        split(f"current K1 {what} r=128", k1, current(cur.study_k1),
              CURRENT_PHASES, 7)
        split(f"current K6 fused {what} r=256", k6, current(cur.study_k6),
              CURRENT_PHASES, 7)
        compare(f"K1 {what} r=128", k1, first_k1_solve,
                cuda_solve.spd_solve_blocked, False)
        compare(f"K2 {what} r=128", k1, first_k2,
                cuda_lanes.spd_solve_lanes, False)
        compare(f"K6 + two solve_triangular vs K6 fused {what} r=256", k6,
                first_k6_route, cuda_lanes_blocked.spd_solve_lanes_blocked,
                True)
    shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
