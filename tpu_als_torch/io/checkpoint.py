"""Factor checkpoints and model persistence, in ``tpu_als``'s format.

Counterpart of ``tpu_als/io/checkpoint.py``.  A model or checkpoint
directory holds ``user_factors.npz`` and ``item_factors.npz`` (arrays
``ids`` and ``factors``) and a JSON ``manifest.json`` that records the
blake2b digest of each data file, so a save of either package loads in
the other.

The integrity contract:

- ``save_factors`` installs atomically (tmp -> ``.old`` swap,
  :func:`atomic_install`), so a complete generation exists at ``path``
  or ``path + '.old'`` at every instant.
- ``load_factors`` verifies every manifest-listed digest.  A torn or
  altered generation raises :class:`CheckpointCorrupt`, is moved aside
  to a ``.corrupt/`` sibling (:func:`quarantine`, kept for forensics),
  and the ``.old`` generation is loaded instead when it validates.
- :func:`discover_resume` is ``train --resume auto``: the newest valid
  generation under a checkpoint directory, quarantining the invalid ones
  it meets.

Transient I/O errors in a save or a load are retried under
:func:`~tpu_als_torch.resilience.retry.retry_call` (a corrupt checkpoint
is a fact about bytes and is never retried).  The fault points
``checkpoint.write`` and ``checkpoint.rename`` drive each branch on
demand.  The sharded layout (format 2, ``SHARDED_FORMAT``: one npz per
mesh position, ``slots.npz`` and a manifest without digests, written by
``parallel.multihost.save_checkpoint_sharded`` of either package) loads
through the same :func:`load_factors`, reassembled into entity space.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time

import numpy as np

from tpu_als_torch import obs
from tpu_als_torch.resilience import faults
from tpu_als_torch.resilience.retry import RetryPolicy, retry_call

# the replicated layout, and the shard-per-position one
REPLICATED_FORMAT = 1
SHARDED_FORMAT = 2
_DATA_FILES = ("user_factors.npz", "item_factors.npz")

# transient-I/O budget for a save or a load; tests pass a fast policy
# through the retry_policy= parameters
_DEFAULT_RETRY = dict(max_attempts=3, base_delay=0.05, max_delay=1.0)


class CheckpointCorrupt(ValueError):
    """A checkpoint directory failed validation: missing or unreadable
    manifest, missing data file, or digest mismatch.  ``path`` is the
    offending generation."""

    def __init__(self, path, reason):
        super().__init__(f"corrupt checkpoint at {path}: {reason}")
        self.path = str(path)
        self.reason = reason


def _retry_policy(override):
    return override if override is not None \
        else RetryPolicy(**_DEFAULT_RETRY)


def _tree_bytes(path):
    total = 0
    for root, _, files in os.walk(path):
        for name in files:
            try:
                total += os.path.getsize(os.path.join(root, name))
            except OSError:
                pass
    return total


def _file_digest(path):
    h = hashlib.blake2b(digest_size=16)
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def atomic_install(tmp, path):
    """Install the fully written directory ``tmp`` at ``path``: move any
    old save aside to ``path + '.old'``, install, delete the old one.  A
    crash between the two renames leaves only ``.old``, which
    :func:`load_factors` then reads."""
    old = path + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(path):
        os.rename(path, old)
    # fault point: a crash in the swap window leaves only .old on disk
    faults.check("checkpoint.rename")
    os.rename(tmp, path)
    if os.path.exists(old):
        shutil.rmtree(old)


def save_factors(path, user_ids, user_factors, item_ids, item_factors,
                 params=None, iteration=None, extra=None,
                 retry_policy=None):
    """Write a model or checkpoint directory (numpy arrays in).

    ``iteration``: the ALS iterations the factors have seen (a resumable
    checkpoint); ``extra``: a JSON-ready dict written as the manifest's
    ``extra`` (empty when None).  The whole write is retried on
    transient I/O errors; it is idempotent across
    attempts (a stale tmp directory is removed, the install tolerates an
    existing ``.old``).
    """
    t0 = time.perf_counter()
    user_factors = np.asarray(user_factors)
    item_factors = np.asarray(item_factors)
    tmp = path + ".tmp"
    nbytes_box = {}

    def _write():
        if os.path.exists(tmp):  # leftovers of a failed attempt
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
            "extra": extra or {},
            "files": {name: _file_digest(os.path.join(tmp, name))
                      for name in _DATA_FILES},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        # fault point: raise = a transient write error (retried);
        # corrupt = a torn npz the writer lets through, caught at load
        if faults.check("checkpoint.write") == "corrupt":
            target = os.path.join(tmp, "user_factors.npz")
            with open(target, "r+b") as f:
                f.truncate(max(0, os.path.getsize(target) // 2))
        nbytes_box["n"] = _tree_bytes(tmp)  # before the install renames
        atomic_install(tmp, path)

    retry_call(_write, policy=_retry_policy(retry_policy),
               what="checkpoint.save")
    dt = time.perf_counter() - t0
    nbytes = nbytes_box["n"]
    obs.histogram("checkpoint.save_seconds", dt)
    obs.counter("checkpoint.save_bytes", nbytes)
    obs.emit("checkpoint_save", path=str(path), seconds=round(dt, 6),
             bytes=nbytes, iteration=iteration)


def load_factors(path, retry_policy=None):
    """Read a model or checkpoint directory.

    Returns (manifest, user_ids, user_factors, item_ids, item_factors) as
    numpy arrays, after validating every manifest-listed digest.  A
    corrupt primary is quarantined to ``.corrupt/`` and the ``.old``
    generation loaded when it validates; else :class:`CheckpointCorrupt`
    propagates.
    """
    t0 = time.perf_counter()
    out = retry_call(_load_validated, path,
                     policy=_retry_policy(retry_policy),
                     what="checkpoint.load")
    dt = time.perf_counter() - t0
    nbytes = _tree_bytes(path)
    obs.histogram("checkpoint.load_seconds", dt)
    obs.counter("checkpoint.load_bytes", nbytes)
    obs.emit("checkpoint_load", path=str(path), seconds=round(dt, 6),
             bytes=nbytes)
    return out


def _read_manifest(path):
    mpath = os.path.join(path, "manifest.json")
    if not os.path.exists(mpath):
        raise CheckpointCorrupt(path, "missing manifest.json")
    try:
        with open(mpath) as f:
            return json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointCorrupt(path, f"unreadable manifest.json: {e}")


def validate_dir(path):
    """Manifest + digest check of one generation; returns the manifest
    or raises :class:`CheckpointCorrupt`.  A manifest without ``files``
    (a sharded save) gets a presence check only."""
    manifest = _read_manifest(path)
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


def quarantine(path, reason):
    """Move a corrupt generation into a ``.corrupt/`` sibling directory
    (kept for forensics, out of the next save's way).  Returns where it
    went, or None if the move itself failed."""
    parent = os.path.dirname(os.path.abspath(path)) or "."
    qdir = os.path.join(parent, ".corrupt")
    base = os.path.basename(path.rstrip(os.sep))
    try:
        os.makedirs(qdir, exist_ok=True)
        dest = os.path.join(qdir, f"{base}.{int(time.time())}")
        n = 0
        while os.path.exists(dest):
            n += 1
            dest = os.path.join(qdir, f"{base}.{int(time.time())}.{n}")
        os.rename(path, dest)
    except OSError:
        return None
    obs.emit("checkpoint_quarantined", path=str(path), reason=reason,
             quarantined_to=dest)
    return dest


def _load_validated(path):
    primary, old = path, path + ".old"
    if not os.path.exists(os.path.join(primary, "manifest.json")) and \
            os.path.exists(os.path.join(old, "manifest.json")):
        # a crash hit the install swap window: only .old is complete
        return _load_dir(old, validate_dir(old))
    try:
        return _load_dir(primary, validate_dir(primary))
    except CheckpointCorrupt as e:
        # quarantine only a directory that is a checkpoint with torn
        # contents: the writer never installs one without its manifest,
        # so a directory without one is something else (an estimator
        # save passed by mistake), and moving it would destroy it
        if os.path.exists(os.path.join(primary, "manifest.json")):
            quarantine(primary, e.reason)
        if os.path.exists(os.path.join(old, "manifest.json")):
            return _load_dir(old, validate_dir(old))
        raise


def _load_sharded(path, manifest):
    """The sharded layout in entity space: each side's slot space
    reassembled from its per-position files, then indexed by the saved
    slot arrays (the reference's ``_load_dir`` arithmetic)."""
    slots = np.load(os.path.join(path, "slots.npz"), allow_pickle=False)
    rank = int(manifest["rank"])
    D = int(manifest["n_shards"])

    def side(name, rps, slot):
        full = np.zeros((D * rps, rank), dtype=np.float32)
        for pos in range(D):
            f = np.load(os.path.join(path, f"{name}_shard_{pos:05d}.npz"),
                        allow_pickle=False)
            full[pos * rps:(pos + 1) * rps] = f["factors"]
        return full[slot]

    U = side("user", int(manifest["rows_per_shard_user"]),
             slots["user_slot"])
    V = side("item", int(manifest["rows_per_shard_item"]),
             slots["item_slot"])
    return manifest, slots["user_ids"], U, slots["item_ids"], V


def _load_dir(path, manifest):
    if manifest["format_version"] > SHARDED_FORMAT:
        raise ValueError(
            f"checkpoint format {manifest['format_version']} at {path} is "
            f"newer than this package reads ({SHARDED_FORMAT})")
    if manifest.get("sharded"):
        return _load_sharded(path, manifest)
    try:
        u = np.load(os.path.join(path, "user_factors.npz"),
                    allow_pickle=False)
        i = np.load(os.path.join(path, "item_factors.npz"),
                    allow_pickle=False)
        return manifest, u["ids"], u["factors"], i["ids"], i["factors"]
    except FileNotFoundError as e:
        raise CheckpointCorrupt(path, f"missing data file: {e}")
    except (ValueError, OSError, KeyError) as e:
        # a torn npz surfaces from numpy as ValueError / zipfile errors
        raise CheckpointCorrupt(path, f"unreadable data file: {e}")


def discover_resume(checkpoint_dir):
    """``--resume auto``: the newest valid checkpoint generation under
    ``checkpoint_dir``.

    Accepts a directory that is a checkpoint (has ``manifest.json``) or a
    fit's ``checkpointDir`` holding the estimator's ``als_checkpoint``
    (and ``.old``) generations.  Invalid generations met on the way are
    quarantined.  Returns the path to load, or None when nothing valid
    exists.
    """
    candidates = []
    if os.path.exists(os.path.join(checkpoint_dir, "manifest.json")):
        candidates.append(checkpoint_dir)
    else:
        for name in ("als_checkpoint", "als_checkpoint.old"):
            p = os.path.join(checkpoint_dir, name)
            if os.path.isdir(p):
                candidates.append(p)
    best, best_iter = None, None
    for p in candidates:
        try:
            manifest = validate_dir(p)
        except CheckpointCorrupt as e:
            if os.path.exists(os.path.join(p, "manifest.json")):
                quarantine(p, e.reason)  # a torn checkpoint, not junk
            continue
        it = manifest.get("iteration")
        it = -1 if it is None else int(it)
        if best_iter is None or it > best_iter:
            best, best_iter = p, it
    return best
