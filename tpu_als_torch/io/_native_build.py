"""Build the host C++ sources under ``io/native/`` with ``g++`` at first use.

Counterpart of ``tpu_als/io/_native_build.py``: one build-if-stale rule
for the native IO libraries (the bucketizer, the CSV reader and the
stream reader's interner).  A
library is compiled to a private temporary file and renamed into place,
so two processes racing to build on a clean checkout can never load a
half-written ``.so``: the rename is atomic within a directory, and the
loser's rename replaces the winner's identical library.

Outputs go under ``tpu_als_torch/_build/`` (listed in ``.gitignore``),
beside the CUDA kernels of :mod:`tpu_als_torch._build`.  Nothing is
built when this module is imported.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

from tpu_als_torch._build import BUILD_DIR

NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "native")


def have_compiler():
    """True when ``g++`` is on the PATH: what the native routes need."""
    return shutil.which("g++") is not None


def build_native(name, extra_flags=("-pthread",)):
    """Build ``io/native/<name>.cc`` into ``_build/lib<name>.so`` with g++
    if the library is missing or older than its source; returns its path.
    A failed build raises ``subprocess.CalledProcessError`` (with g++'s
    output), and a missing compiler ``FileNotFoundError``."""
    src = os.path.join(NATIVE_DIR, f"{name}.cc")
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    if (os.path.exists(lib)
            and os.path.getmtime(lib) >= os.path.getmtime(src)):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", prefix=f"lib{name}.so.",
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", *extra_flags, src,
                        "-o", tmp], check=True, capture_output=True)
        os.rename(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib
