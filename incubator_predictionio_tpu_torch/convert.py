"""Carry a recommendation model's weights across from the JAX package.

The port cannot unpickle the JAX package's model blobs (they name its
classes), and it imports nothing of that package. So weights cross as plain
numpy: the reference ``RecModel``'s towers (``mf.user_emb``, ``item_emb``,
``user_bias``, ``item_bias``, ``mean``, ``config.rank``) and the id lists of
its two BiMaps in index order. :func:`rec_model_from_arrays` builds the
port's ``RecModel`` from them, so both packages serve the same model.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from incubator_predictionio_tpu_torch.data.bimap import BiMap
from incubator_predictionio_tpu_torch.models.two_tower import (
    TwoTowerConfig,
    TwoTowerModel,
)
from incubator_predictionio_tpu_torch.templates.recommendation import RecModel


def rec_model_from_arrays(
    user_emb: np.ndarray,
    item_emb: np.ndarray,
    user_bias: np.ndarray,
    item_bias: np.ndarray,
    mean: float,
    rank: int,
    user_ids: Sequence[str],
    item_ids: Sequence[str],
) -> RecModel:
    """The port's RecModel over the given towers; ``user_ids[i]`` names row
    ``i`` of ``user_emb`` (likewise items)."""
    user_emb = np.ascontiguousarray(user_emb, np.float32)
    item_emb = np.ascontiguousarray(item_emb, np.float32)
    user_bias = np.ascontiguousarray(user_bias, np.float32)
    item_bias = np.ascontiguousarray(item_bias, np.float32)
    if user_emb.shape != (len(user_ids), rank) or \
            item_emb.shape != (len(item_ids), rank):
        raise ValueError(
            f"tower shapes {user_emb.shape}, {item_emb.shape} do not match "
            f"{len(user_ids)} users / {len(item_ids)} items at rank {rank}")
    if user_bias.shape != (len(user_ids),) or item_bias.shape != (len(item_ids),):
        raise ValueError("bias lengths do not match the id lists")
    mf = TwoTowerModel(
        user_emb=user_emb, item_emb=item_emb,
        user_bias=user_bias, item_bias=item_bias,
        mean=float(mean), config=TwoTowerConfig(rank=int(rank)),
    )
    return RecModel(
        mf,
        BiMap({u: i for i, u in enumerate(user_ids)}),
        BiMap({t: i for i, t in enumerate(item_ids)}),
    )
