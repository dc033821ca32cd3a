"""Versioned delta artifacts: the unit the updater ships to replicas.

Counterpart of ``incubator_predictionio_tpu/streaming/delta.py``, whole. A
delta carries the **absolute post-update values** of every row a batch
touched (never increments): applying deltas ``chain_base..N`` in order
reproduces the updater's state bit for bit, re-applying one is a no-op the
replica's range check turns into a counted dedup, and a replica restarted
from the base model resyncs by replaying the archived chain. Each artifact
records the ``[from_seq, to_seq)`` event range it covers and the engine
instance id it applies to.

Artifacts persist through the atomic-write discipline (tmp + rename +
fsync) with a CRC over the payload, so a crash mid-archive leaves either no
file or a whole verifiable one.
"""

from __future__ import annotations

import dataclasses
import io
import os
import pickle
import re
import zlib
from typing import Optional

import numpy as np

from incubator_predictionio_tpu_torch.utils.fs import atomic_write_bytes

_DELTA_MAGIC = b"PIODELT1"
_NAME_RE = re.compile(r"^delta-(\d{16})-(\d{16})\.pkl$")


@dataclasses.dataclass
class ModelDelta:
    """Per-row embedding updates for one event batch.

    ``user_rows``/``item_rows`` map table row index → the full ``[rank+1]``
    fused row (embedding + bias) AFTER the batch's adam steps;
    ``cold_user_rows``/``cold_item_rows`` are the same for hash-bucket
    cold-start rows (streaming/coldstart.py). ``max_event_time_us`` feeds
    the staleness gauge on the replica."""

    base_instance: str          # engine instance id the chain applies to
    chain_base: int             # seq where this delta chain started
    from_seq: int               # first event byte offset covered (inclusive)
    to_seq: int                 # one past the last byte offset covered
    user_rows: dict[int, np.ndarray]
    item_rows: dict[int, np.ndarray]
    cold_user_rows: dict[int, np.ndarray] = dataclasses.field(
        default_factory=dict)
    cold_item_rows: dict[int, np.ndarray] = dataclasses.field(
        default_factory=dict)
    max_event_time_us: int = 0
    n_events: int = 0

    @property
    def n_rows(self) -> int:
        return (len(self.user_rows) + len(self.item_rows)
                + len(self.cold_user_rows) + len(self.cold_item_rows))

    def finite(self) -> bool:
        """Every shipped row is finite — the replica-side sanity gate (a
        NaN row must never reach a serving table)."""
        for rows in (self.user_rows, self.item_rows,
                     self.cold_user_rows, self.cold_item_rows):
            for v in rows.values():
                if not np.all(np.isfinite(v)):
                    return False
        return True


def restrict_to_item_rows(delta: ModelDelta, lo: int, hi: int) -> ModelDelta:
    """The delta a shard owner for item rows ``[lo, hi)`` actually applies.

    Only ``item_rows`` are owner-partitioned — user rows and cold-start
    hash buckets are replicated on every owner (cold buckets live in a
    separate index space and back unknown-user answers on every shard).
    Seq bookkeeping is untouched: owners apply the SAME chain positions as
    the full table would, so the exactly-once range checks keep working."""
    return dataclasses.replace(
        delta,
        item_rows={r: v for r, v in delta.item_rows.items()
                   if lo <= r < hi})


def encode_delta(delta: ModelDelta) -> bytes:
    """Self-verifying wire/file form: magic + crc32 + pickle."""
    payload = pickle.dumps(delta, protocol=pickle.HIGHEST_PROTOCOL)
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return _DELTA_MAGIC + crc.to_bytes(4, "little") + payload


def decode_delta(data: bytes) -> ModelDelta:
    if data[:8] != _DELTA_MAGIC:
        raise ValueError("not a delta artifact (bad magic)")
    crc = int.from_bytes(data[8:12], "little")
    payload = data[12:]
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise ValueError("delta artifact CRC mismatch")
    delta = pickle.load(io.BytesIO(payload))
    if not isinstance(delta, ModelDelta):
        raise ValueError(f"not a ModelDelta: {type(delta).__name__}")
    return delta


def delta_filename(from_seq: int, to_seq: int) -> str:
    return f"delta-{from_seq:016d}-{to_seq:016d}.pkl"


def archive_dir(state_dir: str) -> str:
    return os.path.join(state_dir, "deltas")


def save_delta(state_dir: str, delta: ModelDelta) -> str:
    """Archive a delta atomically + durably; returns the path. Re-archiving
    the same range (crash replay) overwrites with identical bytes."""
    d = archive_dir(state_dir)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, delta_filename(delta.from_seq, delta.to_seq))
    atomic_write_bytes(path, encode_delta(delta), durable=True)
    return path


def load_delta(path: str) -> ModelDelta:
    with open(path, "rb") as f:
        return decode_delta(f.read())


def list_archived(state_dir: str) -> list[tuple[int, int, str]]:
    """Archived ``(from_seq, to_seq, path)`` triples in chain order."""
    d = archive_dir(state_dir)
    out = []
    try:
        names = os.listdir(d)
    except FileNotFoundError:
        return []
    for name in names:
        m = _NAME_RE.match(name)
        if m:
            out.append((int(m.group(1)), int(m.group(2)),
                        os.path.join(d, name)))
    return sorted(out)


def chain_from(state_dir: str, after_seq: Optional[int]) -> list[str]:
    """Archive paths forming the contiguous chain a replica needs:
    everything with ``from_seq >= after_seq`` (or the whole chain when the
    replica has nothing applied yet)."""
    rows = list_archived(state_dir)
    if after_seq is None:
        return [p for _, _, p in rows]
    return [p for f, _, p in rows if f >= after_seq]
