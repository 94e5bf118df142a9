"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` is compiled by one ``nvcc`` command into a shared
library with a plain C interface, and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/lib<name>-<digest>.so csrc/<name>.cu

The library name carries a digest of the sources, so an edited source is
rebuilt and a stale library is never loaded.  Outputs go under
``tpu_als_torch/_build/`` (listed in ``.gitignore``).  Nothing is built
or imported when this module is imported.

Every kernel's C entry point takes raw device pointers and the CUDA
stream as ``void*`` and returns ``cudaGetLastError()`` after its launch;
the host entries of ``csrc/peer_ipc.cu`` return their call's
``cudaError_t``; the wrappers raise when that is non-zero.  An entry point is named after its
source unless :data:`SIGNATURES` names the source beside it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float

# per entry point: its C name, its argument types and, where the source
# is not ``csrc/<name>.cu``, the source's name
SIGNATURES = {
    # chol_solve_f32(A, b, x, n, r, stream)
    "chol_solve": ("chol_solve_f32", [_P, _P, _P, _LL, _I, _P]),
    # topk_f32(U, V, valid, coll_s, coll_i, tickets, out_s, out_i, n, ni,
    #          r, k, P, stream)
    "topk": ("topk_f32", [_P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I,
                          _I, _P]),
    # chol_blocked_f32(A, b, x, n, r, stream)
    "chol_blocked": ("chol_blocked_f32", [_P, _P, _P, _LL, _I, _P]),
    # gather_gram(V, cols, aw, bw, S, b, part_S, part_b, n, w, r, split,
    #             two_sided, bf16, stream)
    "gather_gram": ("gather_gram", [_P, _P, _P, _P, _P, _P, _P, _P, _LL,
                                    _LL, _I, _LL, _I, _I, _P]),
    # gather_solve(V, cols, aw, bw, cw, YtY, x, sums, n, w, r, reg_w,
    #              jitter, two_sided, bf16, row0, nrows, stream)
    "gather_solve": ("gather_solve", [_P, _P, _P, _P, _P, _P, _P, _P, _LL,
                                      _LL, _I, _F, _F, _I, _I, _LL, _LL,
                                      _P]),
    # gather_solve_cluster_info(r, bf16, out [5]): the cluster launch of
    # K4's and K7's solve pass above rank 288 as the card takes it
    "gather_solve_cluster_info": ("gather_solve_cluster_info", [_I, _I, _P],
                                  "gather_solve"),
    # chol_lanes_blocked_f32(A, n, r, stream): L written over A
    "chol_lanes_blocked": ("chol_lanes_blocked_f32", [_P, _LL, _I, _P]),
    # chol_lanes_blocked_solve_f32(A, b, x, n, r, stream): L written over
    # A, and x
    "chol_lanes_blocked_solve": ("chol_lanes_blocked_solve_f32",
                                 [_P, _P, _P, _LL, _I, _P],
                                 "chol_lanes_blocked"),
    # gather_solve_ring(bases, per, cols, aw, bw, cw, YtY, x, D, S, n, w, r,
    #                   reg_w, jitter, two_sided, bf16, split, row0, nrows,
    #                   part, sums, stream)
    "gather_solve_ring": ("gather_solve_ring", [_P, _I, _P, _P, _P, _P, _P,
                                                _P, _LL, _I, _LL, _LL, _I,
                                                _F, _F, _I, _I, _LL, _LL,
                                                _LL, _P, _P, _P]),
    # topk_merge_ring_f32(U, V, valid, coll_s, coll_i, tickets, out_s,
    #                     out_i, n, ni_loc, S, r, k, P, stream)
    "topk_merge_ring": ("topk_merge_ring_f32", [_P, _P, _P, _P, _P, _P, _P,
                                                _P, _LL, _LL, _I, _I, _I, _I,
                                                _P]),
    # K8 across processes: topk_sets_f32(U, V, valid, coll_s, coll_i, n,
    # ni_loc, L, r, k, P, id0, stream) and topk_merge_sets_f32(bases_s,
    # bases_i, nbase, spb, q0, nq, k, out_s, out_i, stream)
    "topk_sets": ("topk_sets_f32", [_P, _P, _P, _P, _P, _LL, _LL, _I, _I,
                                    _I, _I, _LL, _P], "topk_merge_ring"),
    "topk_merge_sets": ("topk_merge_sets_f32", [_P, _P, _I, _I, _LL, _LL,
                                                _I, _P, _P, _P],
                        "topk_merge_ring"),
    # the buffers K7 and K8 share across processes (host code):
    # peer_handle_bytes(), peer_alloc(bytes, &ptr), peer_free(ptr),
    # peer_export(ptr, handle), peer_open(handle, &ptr), peer_close(ptr)
    "peer_handle_bytes": ("peer_handle_bytes", [], "peer_ipc"),
    "peer_alloc": ("peer_alloc", [_LL, _P], "peer_ipc"),
    "peer_free": ("peer_free", [_P], "peer_ipc"),
    "peer_export": ("peer_export", [_P, _P], "peer_ipc"),
    "peer_open": ("peer_open", [_P, _P], "peer_ipc"),
    "peer_close": ("peer_close", [_P], "peer_ipc"),
}

_LIBS = {}  # name -> loaded ctypes function


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of tpu_als_torch "
                       "are built at first use and need the CUDA toolkit")


def _lib_path(name):
    h = hashlib.blake2b(digest_size=8)
    h.update(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()}.so")


def _source(name):
    """The source an entry point is built from."""
    return SIGNATURES[name][2] if len(SIGNATURES[name]) > 2 else name


def _start(name):
    """Start the nvcc build of one source; None when already built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, cmd


def _finish(started):
    if started is None:
        return
    proc, tmp, out, cmd = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def load_all():
    """:func:`load` every source, with all the nvcc builds started
    together, so a cold build takes as long as its slowest source rather
    than their sum; returns the C entry points by name."""
    sources = dict.fromkeys(_source(name) for name in SIGNATURES)
    for started in [_start(src) for src in sources]:
        _finish(started)
    return {name: load(name) for name in SIGNATURES}


def load(name):
    """The C entry point ``name`` (of ``csrc/<name>.cu`` unless
    :data:`SIGNATURES` names another source), built if needed."""
    fn = _LIBS.get(name)
    if fn is not None:
        return fn
    src = _source(name)
    _finish(_start(src))
    sym, argtypes = SIGNATURES[name][:2]
    fn = getattr(ctypes.CDLL(_lib_path(src)), sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _LIBS[name] = fn
    return fn


def check(err, what):
    """Raise when a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
