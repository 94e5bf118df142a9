"""Run manifest: what produced a run directory — config, versions, git.

Counterpart of ``tpu_als/obs/manifest.py`` (stdlib only): captured at
``obs.configure`` with the cheap fields, completed at ``finalize`` with
the device facts — torch's version and the CUDA device's name, read only
when torch is already imported (the manifest never initializes CUDA on
its own).
"""

from __future__ import annotations

import os
import platform
import subprocess
import sys
import time


def _git_describe():
    """``git describe --always --dirty --tags`` of the source tree, or
    None; never raises (an installed copy has no .git)."""
    try:
        p = subprocess.run(
            ["git", "describe", "--always", "--dirty", "--tags"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5)
    except (OSError, subprocess.SubprocessError):
        return None
    return p.stdout.strip() if p.returncode == 0 else None


def build_manifest(config=None, argv=None):
    import numpy as np

    import tpu_als_torch

    return {
        "started_at": round(time.time(), 6),
        "argv": list(argv) if argv is not None else sys.argv[1:],
        "config": dict(config or {}),
        "tpu_als_torch_version": tpu_als_torch.__version__,
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "numpy": np.__version__,
        "git": _git_describe(),
        "pid": os.getpid(),
    }


def late_device_info():
    """torch's version, the process count (``parallel.multihost``'s, 1
    when it is not loaded) and, when CUDA is already initialized, the
    device count and the first device's name; gathered at finalize."""
    torch = sys.modules.get("torch")
    if torch is None:
        return {}
    info = {"torch": torch.__version__, "cuda": torch.version.cuda}
    mh = sys.modules.get("tpu_als_torch.parallel.multihost")
    info["process_count"] = mh.process_count() if mh is not None else 1
    if torch.cuda.is_initialized():
        info["device_count"] = torch.cuda.device_count()
        info["device_name"] = torch.cuda.get_device_name(0)
    return info
