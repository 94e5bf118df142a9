"""MovieLens loaders and MovieLens-shaped synthetic ratings at any scale.

Counterpart of ``tpu_als/io/movielens.py`` (an own copy): ml-100k
``u.data`` (tab-separated user/item/rating/ts), ml-1m/ml-10m
``ratings.dat`` (``'::'``-separated), ml-latest/ml-25m ``ratings.csv``
(header ``userId,movieId,rating,timestamp``), the movie-title tables of
all three formats, and :func:`synthetic_movielens` (pure numpy, so the
same seed gives the same frame as the reference's).  ``u.data`` and
``ratings.csv`` are read by the native reader
(:mod:`tpu_als_torch.io.fastcsv`) when ``g++`` is on the PATH, and by its
Python twin (:mod:`tpu_als_torch.io.ratings_csv`, the same output and the
same ``ValueError`` on a malformed line) otherwise; the choice is made
before reading, and a native build that then fails raises.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from tpu_als_torch.io import fastcsv, ratings_csv
from tpu_als_torch.io._native_build import have_compiler
from tpu_als_torch.utils.frame import ColumnarFrame

# MovieLens' published shapes (users, items, ratings)
ML25M_SHAPE = (162_541, 59_047, 25_000_095)
ML100K_SHAPE = (943, 1_682, 100_000)


def _frame(u, i, r, t):
    return ColumnarFrame({"user": u, "item": i, "rating": r,
                          "timestamp": t})


def load_movielens_100k(path):
    """Read ml-100k ``u.data`` (or a directory containing it)."""
    if os.path.isdir(path):
        path = os.path.join(path, "u.data")
    if have_compiler():
        return _frame(*fastcsv.load_u_data(path))
    return ratings_csv.load_u_data(path)


def load_movielens_dat(path):
    """Read ml-1m / ml-10m ``ratings.dat`` (or a directory containing it):
    ``UserID::MovieID::Rating::Timestamp``, no header; ml-10m ratings come
    in half-star steps, so the rating column is parsed as float.

    Splitting ``a::b::c::d`` on single ``':'`` yields empty fields at odd
    positions, so ``usecols=(0, 2, 4, 6)`` reads the format exactly (its
    fields are bare numbers, never quoted) and stays in numpy."""
    if os.path.isdir(path):
        path = os.path.join(path, "ratings.dat")
    try:
        raw = np.loadtxt(path, dtype=np.float64, delimiter=":",
                         usecols=(0, 2, 4, 6), ndmin=2)
    except (ValueError, IndexError) as e:
        raise ValueError(f"{path}: malformed ratings line ({e})") from None
    return _frame(raw[:, 0].astype(np.int64), raw[:, 1].astype(np.int64),
                  raw[:, 2].astype(np.float32), raw[:, 3].astype(np.int64))


def load_movielens_csv(path):
    """Read a ``ratings.csv`` (ml-latest / ml-25m style, with header, or
    a directory containing it); a malformed line raises ``ValueError``."""
    if os.path.isdir(path):
        path = os.path.join(path, "ratings.csv")
    if have_compiler():
        return _frame(*fastcsv.load_ratings_csv(path))
    return ratings_csv.load_ratings_csv(path)


def load_movielens_movies(path):
    """Read the id -> title table: ml-100k ``u.item`` (``|``-separated,
    latin-1), ml-1m/ml-10m ``movies.dat`` (``'::'``-separated) or
    ml-latest/ml-25m ``movies.csv`` (quoted CSV with header), told apart
    by the file name; a directory resolves to whichever of the three it
    holds.  Returns a frame with ``item`` (int64) and ``title`` (object)
    columns."""
    if os.path.isdir(path):
        for name in ("movies.csv", "movies.dat", "u.item"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(
                f"{path} contains none of movies.csv / movies.dat / u.item")
    base = os.path.basename(path)
    ids, titles = [], []
    if base.endswith(".csv"):
        with open(path, newline="", encoding="utf-8") as f:
            reader = csv.reader(f)
            next(reader, None)  # header: movieId,title,genres
            for row in reader:
                if len(row) >= 2:
                    ids.append(int(row[0]))
                    titles.append(row[1])
    elif base.endswith(".dat"):
        # ml-10m ships movies.dat in UTF-8, ml-1m in latin-1: strict UTF-8
        # first (every byte string is valid latin-1, so latin-1 first would
        # garble UTF-8 titles), latin-1 for ml-1m
        try:
            with open(path, encoding="utf-8") as f:
                text = f.read()
        except UnicodeDecodeError:
            with open(path, encoding="latin-1") as f:
                text = f.read()
        for line in text.splitlines():
            parts = line.split("::")
            if len(parts) >= 2:
                ids.append(int(parts[0]))
                titles.append(parts[1])
    else:  # u.item
        with open(path, encoding="latin-1") as f:
            for line in f:
                parts = line.rstrip("\n").split("|")
                if len(parts) >= 2:
                    ids.append(int(parts[0]))
                    titles.append(parts[1])
    return ColumnarFrame({"item": np.asarray(ids, dtype=np.int64),
                          "title": np.asarray(titles, dtype=object)})


def synthetic_movielens(num_users, num_items, num_ratings, seed=0,
                        rank=16, noise=0.3, user_power=0.9, item_power=1.1,
                        return_factors=False):
    """MovieLens-shaped synthetic ratings, deterministic per seed.

    ``return_factors=True`` also returns the planted ``(Ustar, Vstar)``.
    """
    rng = np.random.default_rng(seed)

    def power_law_ids(n_entities, n_draws, a):
        w = (np.arange(1, n_entities + 1, dtype=np.float64)) ** (-a)
        w /= w.sum()
        ids = rng.choice(n_entities, size=n_draws, p=w)
        # random relabeling so popularity is not correlated with id order
        perm = rng.permutation(n_entities)
        return perm[ids]

    u = power_law_ids(num_users, num_ratings, user_power)
    i = power_law_ids(num_items, num_ratings, item_power)
    Ustar = rng.normal(0, 1.0, (num_users, rank)).astype(np.float32)
    Vstar = rng.normal(0, 1.0 / np.sqrt(rank),
                       (num_items, rank)).astype(np.float32)
    raw = np.einsum("nr,nr->n", Ustar[u], Vstar[i])
    raw = raw + noise * rng.normal(size=num_ratings).astype(np.float32)
    # squash to the 0.5..5.0 half-star grid with a MovieLens-like mean
    stars = np.clip(np.round((3.5 + 1.1 * raw) * 2) / 2, 0.5, 5.0)
    frame = ColumnarFrame({
        "user": u.astype(np.int64),
        "item": i.astype(np.int64),
        "rating": stars.astype(np.float32),
        "timestamp": rng.integers(1_000_000_000, 1_600_000_000,
                                  num_ratings),
    })
    if return_factors:
        return frame, Ustar, Vstar
    return frame
