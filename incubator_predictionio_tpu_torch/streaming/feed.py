"""Durable ordered change feed over a PIOLOG01 event log.

Counterpart of ``incubator_predictionio_tpu/streaming/feed.py``:
``read_cursor``, ``write_cursor``, ``FeedBatch`` and ``EventLogFeed``. The
event log is an append-only single-writer file, so the byte offset of a
record IS its stable, monotonic sequence number. The feed tails the file
from a **crash-safe persisted cursor** (atomic tmp + rename + fsync) and
hands the updater batches of decoded events tagged ``[from_seq, to_seq)``
— the range every delta artifact carries and every replica dedupes on.

Torn-tail semantics: a record the writer has only half-appended is "wait
and re-poll", never corruption and never a skip — the poll stops at the
last complete record and the next poll resumes from exactly there.
:func:`resolve_feed_path` (reference :198-225) finds the file behind an app
in a storage configuration whose EVENTDATA is the ``eventlog`` backend.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

from incubator_predictionio_tpu_torch.data.event import Event
from incubator_predictionio_tpu_torch.native import format as fmt
from incubator_predictionio_tpu_torch.utils.fs import atomic_write_bytes

CURSOR_FILE = "stream.cursor"


# -- crash-safe cursor -------------------------------------------------------

def read_cursor(state_dir: str) -> Optional[dict]:
    """The persisted feed position, or None before the first commit. The
    cursor carries ``seq`` (resume byte offset), ``chain_base`` (where this
    delta chain started) and ``base_instance`` (the engine instance the
    chain applies to — a full retrain changes it and resets the chain)."""
    try:
        with open(os.path.join(state_dir, CURSOR_FILE)) as f:
            return json.load(f)
    except (FileNotFoundError, ValueError):
        return None


def write_cursor(state_dir: str, cursor: dict) -> None:
    """Atomic + fsync'd cursor commit: a SIGKILL between any two statements
    of the updater leaves either the old complete cursor or the new one —
    replaying from the old cursor re-folds deterministically and the
    replicas dedupe the re-shipped range."""
    os.makedirs(state_dir, exist_ok=True)
    atomic_write_bytes(
        os.path.join(state_dir, CURSOR_FILE),
        json.dumps(cursor, sort_keys=True).encode(), durable=True)


# -- the feed ----------------------------------------------------------------

@dataclasses.dataclass
class FeedBatch:
    """One poll's worth of events. ``from_seq``/``to_seq`` bound the byte
    range consumed (``[from_seq, to_seq)``); ``waiting`` is True when the
    scan stopped at a partial record a live writer is still appending."""

    events: list[Event]
    from_seq: int
    to_seq: int
    waiting: bool = False


class EventLogFeed:
    """Tail a ``PIOLOG01`` event log from a byte offset.

    String-table handling: intern records may precede the cursor, so
    opening the feed bootstraps the interner with ONE pass over the prefix
    (intern records only — no event decode); after that every poll parses
    just the appended suffix. Tombstones are ignored — a delete after the
    fact does not un-train a fold, exactly like a full retrain reading a
    later snapshot would still have seen the event's effect window.
    """

    def __init__(self, path: str, from_seq: int = 0):
        self.path = path
        self._strings: dict[int, str] = {}
        self._next = len(fmt.MAGIC)
        if from_seq > len(fmt.MAGIC):
            self._bootstrap(from_seq)
            self._next = from_seq

    @property
    def position(self) -> int:
        return self._next

    def _bootstrap(self, upto: int) -> None:
        """One pass over the prefix ``[0, upto)``: intern records feed the
        string table, and the walk doubles as the FAILOVER RESUME GUARD —
        the cursor must land exactly on a record boundary of THIS file.
        Replication keeps replica logs byte-identical (offsets preserved),
        so a cursor committed against the old primary resumes cleanly on
        the promoted one; a cursor pointed at the wrong file (or a
        diverged, un-scrubbed copy) fails loudly here instead of decoding
        garbage from mid-record."""
        with open(self.path, "rb") as f:
            buf = f.read(upto)
        for _, kind, payload in fmt.iter_records(buf):
            if kind == fmt.KIND_INTERN:
                sid, slen = fmt.struct.unpack_from("<IH", payload, 1)
                self._strings[sid] = payload[7:7 + slen].decode()
        end = fmt.valid_extent(buf)
        if end != upto:
            raise ValueError(
                f"feed cursor {upto} does not land on a record boundary "
                f"of {self.path} (last boundary at {end}): the cursor "
                "belongs to a different log — after a failover, point the "
                "feed at the promoted primary's byte-identical copy "
                "(docs/replication.md)")

    #: per-poll read bound: a multi-GB backlog is consumed in bounded
    #: chunks instead of re-reading the whole unconsumed tail every poll
    #: (which would be O(backlog²) bytes and unbounded RAM)
    MAX_POLL_BYTES = 8 << 20

    def poll(self, max_events: int = 1024,
             max_bytes: Optional[int] = None) -> FeedBatch:
        """Decode up to ``max_events`` events appended past the cursor,
        reading at most ~``max_bytes`` from disk.

        A partial record at the *file's* tail ends the scan with
        ``waiting=True`` and leaves ``to_seq`` at the last complete record
        — the re-poll contract. A record merely cut by the READ BOUND is
        not "waiting": the poll returns what it decoded and the next poll
        continues (a single record larger than the bound grows the read
        until it fits). An empty file (or no new bytes) is
        ``waiting=False`` with an empty batch."""
        if max_bytes is None:
            max_bytes = self.MAX_POLL_BYTES
        from_seq = self._next
        try:
            size = os.path.getsize(self.path)
        except FileNotFoundError:
            return FeedBatch([], from_seq, from_seq)
        if size <= self._next:
            return FeedBatch([], from_seq, from_seq)
        while True:
            with open(self.path, "rb") as f:
                if self._next <= len(fmt.MAGIC):
                    magic = f.read(len(fmt.MAGIC))
                    if len(magic) < len(fmt.MAGIC):
                        return FeedBatch([], from_seq, from_seq,
                                         waiting=True)
                    if magic != fmt.MAGIC:
                        raise ValueError(
                            f"{self.path} is not a PIOLOG01 file")
                    self._next = len(fmt.MAGIC)
                    from_seq = max(from_seq, self._next)
                f.seek(self._next)
                chunk = f.read(max_bytes)
            bounded = self._next + len(chunk) < size
            events: list[Event] = []
            pos = 0
            n = len(chunk)
            tail_partial = False
            while pos + 4 <= n and len(events) < max_events:
                (plen,) = fmt.struct.unpack_from("<I", chunk, pos)
                if plen == 0 or pos + 4 + plen > n:
                    # partial record: either the writer is mid-append
                    # (wait and re-poll from this exact offset — never
                    # skip, never declare torn) or our read bound cut it
                    tail_partial = True
                    break
                payload = chunk[pos + 4:pos + 4 + plen]
                kind = payload[0]
                if kind == fmt.KIND_INTERN:
                    sid, slen = fmt.struct.unpack_from("<IH", payload, 1)
                    self._strings[sid] = payload[7:7 + slen].decode()
                elif kind == fmt.KIND_EVENT:
                    _, event = fmt.decode_event_payload(
                        payload, self._strings)
                    events.append(event)
                # tombstones: position advances, nothing to fold
                pos += 4 + plen
            if pos + 4 > n and not tail_partial \
                    and len(events) < max_events and pos < n:
                tail_partial = True  # 1-3 trailing bytes of a header
            if pos == 0 and not events and tail_partial and bounded:
                # one record larger than the read bound: grow and retry
                # (never a torn tail — the bytes exist on disk)
                max_bytes *= 4
                continue
            self._next += pos
            # "waiting" means the WRITER must act before progress is
            # possible; a bound-cut record just means "poll again"
            waiting = tail_partial and not bounded
            return FeedBatch(events, from_seq, self._next, waiting=waiting)



def resolve_feed_path(storage, app_name: str,
                      channel_name: Optional[str] = None) -> str:
    """The eventlog file behind ``app_name`` in this storage config.
    Raises if EVENTDATA is not an eventlog backend: only the append-only
    log gives the byte-offset ordering the exactly-once contract needs."""
    from incubator_predictionio_tpu_torch.data.storage.eventlog_backend import (
        EventLogEvents,
    )

    events = storage.get_events()
    if not isinstance(events, EventLogEvents):
        raise ValueError(
            "streaming requires the 'eventlog' EVENTDATA backend (the "
            "append-only log IS the change feed); got "
            f"{type(events).__name__}")
    app = storage.get_meta_data_apps().get_by_name(app_name)
    if app is None:
        raise ValueError(f"app {app_name!r} not found")
    channel_id = None
    if channel_name:
        for ch in storage.get_meta_data_channels().get_by_app_id(app.id):
            if ch.name == channel_name:
                channel_id = ch.id
                break
        else:
            raise ValueError(f"channel {channel_name!r} not found")
    return events.log_path(app.id, channel_id)
