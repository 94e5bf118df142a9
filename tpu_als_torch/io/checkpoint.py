"""Factor persistence in the same on-disk format as ``tpu_als``.

Counterpart of ``tpu_als/io/checkpoint.py`` (``save_factors`` /
``load_factors``).  A model directory holds ``user_factors.npz`` and
``item_factors.npz`` (arrays ``ids`` and ``factors``) and a JSON
``manifest.json`` that records the blake2b digest of each data file, so a
model saved by either package loads in the other.  ``load_factors``
verifies every listed digest and raises :class:`CheckpointCorrupt` on a
missing or altered file.

The install is atomic (tmp dir -> ``.old`` swap), as in the reference; a
crash between the two renames leaves a complete ``.old`` generation,
which ``load_factors`` reads.  Retry, fault points and quarantine are not
ported.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np

# the replicated layout; the sharded layout (format 2) is not read here
REPLICATED_FORMAT = 1
_DATA_FILES = ("user_factors.npz", "item_factors.npz")


class CheckpointCorrupt(ValueError):
    """A model directory failed validation: missing or unreadable
    manifest, missing data file, or digest mismatch."""

    def __init__(self, path, reason):
        super().__init__(f"corrupt checkpoint at {path}: {reason}")
        self.path = str(path)
        self.reason = reason


def _file_digest(path):
    h = hashlib.blake2b(digest_size=16)
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def save_factors(path, user_ids, user_factors, item_ids, item_factors,
                 params=None, iteration=None):
    """Write a model or checkpoint directory (numpy arrays in, atomic
    tmp+rename).  ``iteration``: the ALS iterations the factors have seen
    (a resumable checkpoint); the manifest's ``extra`` is written empty."""
    user_factors = np.asarray(user_factors)
    item_factors = np.asarray(item_factors)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "user_factors.npz"),
             ids=np.asarray(user_ids), factors=user_factors)
    np.savez(os.path.join(tmp, "item_factors.npz"),
             ids=np.asarray(item_ids), factors=item_factors)
    manifest = {
        "format_version": REPLICATED_FORMAT,
        "rank": int(user_factors.shape[1]),
        "num_users": int(user_factors.shape[0]),
        "num_items": int(item_factors.shape[0]),
        "iteration": iteration,
        "params": params or {},
        "extra": {},
        "files": {name: _file_digest(os.path.join(tmp, name))
                  for name in _DATA_FILES},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    old = path + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    if os.path.exists(old):
        shutil.rmtree(old)


def validate_dir(path):
    """Manifest + digest check of one generation; returns the manifest
    or raises :class:`CheckpointCorrupt`."""
    mpath = os.path.join(path, "manifest.json")
    if not os.path.exists(mpath):
        raise CheckpointCorrupt(path, "missing manifest.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointCorrupt(path, f"unreadable manifest.json: {e}")
    for name, digest in (manifest.get("files") or {}).items():
        fpath = os.path.join(path, name)
        if not os.path.exists(fpath):
            raise CheckpointCorrupt(path, f"missing data file {name}")
        actual = _file_digest(fpath)
        if actual != digest:
            raise CheckpointCorrupt(
                path, f"digest mismatch for {name} "
                      f"(manifest {digest}, file {actual})")
    return manifest


def load_factors(path):
    """Read a model directory.

    Returns (manifest, user_ids, user_factors, item_ids, item_factors) as
    numpy arrays, after validating every manifest-listed digest.
    """
    if not os.path.exists(os.path.join(path, "manifest.json")) and \
            os.path.exists(os.path.join(path + ".old", "manifest.json")):
        path = path + ".old"  # a crash hit the install swap window
    manifest = validate_dir(path)
    if manifest["format_version"] != REPLICATED_FORMAT \
            or manifest.get("sharded"):
        raise ValueError(
            f"checkpoint format {manifest['format_version']} at {path} is "
            "not the replicated layout this package reads")
    try:
        u = np.load(os.path.join(path, "user_factors.npz"),
                    allow_pickle=False)
        i = np.load(os.path.join(path, "item_factors.npz"),
                    allow_pickle=False)
        return manifest, u["ids"], u["factors"], i["ids"], i["factors"]
    except FileNotFoundError as e:
        raise CheckpointCorrupt(path, f"missing data file: {e}")
    except (ValueError, OSError, KeyError) as e:
        raise CheckpointCorrupt(path, f"unreadable data file: {e}")
