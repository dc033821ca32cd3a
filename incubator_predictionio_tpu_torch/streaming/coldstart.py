"""Hash-bucket cold-start rows for unseen users/items.

Counterpart of ``incubator_predictionio_tpu/streaming/coldstart.py``, whole.
The reference template answers an unknown user with an EMPTY result. With
``PIO_COLDSTART_MODE=hash`` an unknown entity maps to one of
``PIO_COLDSTART_BUCKETS`` deterministic hash-bucket embedding rows:

- **serving**: an unknown user's query scores the catalog with its
  bucket's row;
- **streaming**: events naming unknown entities train the bucket rows (the
  delta trainer gathers/scatters them exactly like table rows), and the
  rows ship to replicas inside the same delta artifacts.

Determinism is the contract: bucket assignment is ``crc32`` of the entity
id and the initial rows are seeded per (bucket, rank, seed), so every
process derives bit-identical state — the JAX package's too. Known
entities are untouched in every mode.
"""

from __future__ import annotations

import dataclasses
import os
import zlib

import numpy as np

VALID_MODES = ("off", "hash")


def coldstart_mode() -> str:
    """``PIO_COLDSTART_MODE``: ``off`` (reference empty-result fallback,
    the default) or ``hash`` (bucketed cold-start rows)."""
    mode = os.environ.get("PIO_COLDSTART_MODE", "off").strip().lower()
    if mode not in VALID_MODES:
        raise ValueError(
            f"PIO_COLDSTART_MODE={mode!r} (want one of {VALID_MODES})")
    return mode


def n_buckets() -> int:
    return max(1, int(os.environ.get("PIO_COLDSTART_BUCKETS", "64")))


def bucket_of(kind: str, entity_id: str, buckets: int) -> int:
    """Deterministic bucket for an entity id; ``kind`` ("user"/"item")
    salts the hash so the same id string on both sides doesn't collide."""
    return zlib.crc32(f"{kind}|{entity_id}".encode()) % buckets


@dataclasses.dataclass
class ColdStartBuckets:
    """``[B, rank+1]`` bucket rows per side (last column = bias, the same
    fused layout as the embedding tables). Pickles with deltas/models."""

    user_rows: np.ndarray
    item_rows: np.ndarray
    seed: int = 0

    @classmethod
    def build(cls, rank: int, buckets: int | None = None,
              seed: int = 0) -> "ColdStartBuckets":
        """Deterministic init: each bucket row is seeded independently from
        (seed, side, bucket) so any process reproduces any row without
        building the others. Scaled like the table init (~N(0, 1/rank)) but
        shrunk 10×: a cold bucket should whisper until events teach it."""
        b = n_buckets() if buckets is None else buckets
        scale = 0.1 / np.sqrt(rank)

        def side(tag: int) -> np.ndarray:
            rows = np.zeros((b, rank + 1), np.float32)
            for i in range(b):
                rng = np.random.default_rng((seed, tag, i))
                rows[i, :rank] = rng.standard_normal(rank).astype(
                    np.float32) * scale
            return rows

        return cls(user_rows=side(0), item_rows=side(1), seed=seed)

    @property
    def buckets(self) -> int:
        return self.user_rows.shape[0]

    @property
    def rank(self) -> int:
        return self.user_rows.shape[1] - 1

    def user_bucket(self, entity_id: str) -> int:
        return bucket_of("user", entity_id, self.buckets)

    def item_bucket(self, entity_id: str) -> int:
        return bucket_of("item", entity_id, self.buckets)

    def copy(self) -> "ColdStartBuckets":
        return ColdStartBuckets(self.user_rows.copy(), self.item_rows.copy(),
                                self.seed)
