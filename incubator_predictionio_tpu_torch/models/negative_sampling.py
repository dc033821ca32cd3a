"""Negative sampling for implicit-feedback MF.

Copy of ``incubator_predictionio_tpu/models/negative_sampling.py`` (the port
imports nothing of the JAX package): the same numpy calls in the same
order, so the output is bitwise the reference's for the same ``rng``.

The reference delegates implicit feedback to MLlib ``ALS.trainImplicit``
(confidence-weighted ALS). Our SGD twin needs explicit negatives; sampling
uniformly produces ~|positives|/|catalog| false negatives, which flattens the
learned structure on small catalogs. ``sample_negatives`` rejection-samples
against the observed (user, item) set.
"""

from __future__ import annotations

import numpy as np


def sample_negatives(
    pos_u: np.ndarray,
    pos_i: np.ndarray,
    n_items: int,
    k: int,
    rng: np.random.Generator,
    max_rounds: int = 8,
) -> tuple[np.ndarray, np.ndarray]:
    """k negatives per positive, avoiding observed pairs (best effort).

    Returns (neg_u, neg_i) of length len(pos_u) * k. After ``max_rounds`` of
    rejection any remaining collisions are kept (dense users on tiny
    catalogs may have no true negatives).
    """
    observed = set((int(u) * n_items + int(i)) for u, i in zip(pos_u, pos_i))
    neg_u = np.repeat(pos_u, k)
    neg_i = rng.integers(0, n_items, len(neg_u)).astype(np.int32)
    keys = neg_u.astype(np.int64) * n_items + neg_i
    bad = np.fromiter((kk in observed for kk in keys), bool, len(keys))
    for _ in range(max_rounds):
        n_bad = int(bad.sum())
        if not n_bad:
            break
        neg_i[bad] = rng.integers(0, n_items, n_bad).astype(np.int32)
        keys = neg_u.astype(np.int64) * n_items + neg_i
        bad = np.fromiter((kk in observed for kk in keys), bool, len(keys))
    return neg_u, neg_i
