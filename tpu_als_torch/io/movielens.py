"""MovieLens-shaped synthetic ratings at any scale.

Counterpart of ``tpu_als/io/movielens.py``: ``ML25M_SHAPE`` and
``synthetic_movielens`` (an own copy; pure numpy, so the same seed gives
the same frame as the reference's).  Degrees follow truncated zipf-like
power laws (users shallower than items), and ratings are a planted
low-rank structure on the 0.5..5.0 half-star grid.  The file loaders of
the reference are not ported; the port's CSV reader is
:mod:`tpu_als_torch.io.ratings_csv`.
"""

from __future__ import annotations

import numpy as np

from tpu_als_torch.utils.frame import ColumnarFrame

# MovieLens-25M's published shape (users, items, ratings)
ML25M_SHAPE = (162_541, 59_047, 25_000_095)


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
