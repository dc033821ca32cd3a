"""`eventlog` storage backend: an append-only binary log for EVENTDATA.

Counterpart of ``incubator_predictionio_tpu/data/storage/eventlog_backend.py``
(:54-249 ``_Log``, ``_pread``, :257-622 ``EventLogEvents``, :654
``EventLogStorageClient``). Events append to one ``PIOLOG01`` file per
app/channel (``native/format.py``), byte for byte the reference's records,
so either package reads a log the other wrote. Every read takes the
reference's pure-Python path (its mirrors of the C++ scanner, assembler and
fold, whose results the reference's tests hold equal to the C++ ones): a
full read and decode of the log per scan. The C++ scanner and the event
server's native ingest (``ingest_raw``) come with ROADMAP.md Queue 1 item 7.

Config (``PIO_STORAGE_SOURCES_<NAME>_...``):

- ``TYPE=eventlog``
- ``PATH=<directory>``: where the per-app log files live (default
  ``$PIO_FS_BASEDIR/eventlog``).

It serves EVENTDATA only; combine it with ``sqlite`` for METADATA and
MODELDATA in ``PIO_STORAGE_REPOSITORIES_*``. The append-only file is also
the streaming updater's change feed (``streaming/feed.py``
``resolve_feed_path``).
"""

from __future__ import annotations

import datetime as _dt
import fcntl
import os
import threading
from typing import Any, Optional, Sequence

from incubator_predictionio_tpu_torch.data.event import Event
from incubator_predictionio_tpu_torch.data.storage.base import (
    UNSET,
    EventStore,
    StorageClient,
    StorageError,
)
from incubator_predictionio_tpu_torch.native import format as fmt

#: what raises for the reference's native ingest
NATIVE_INGEST = ("the event server's native ingest (ingest_raw) comes with "
                 "the C++ event-log scanner (ROADMAP.md Queue 1, item 7)")


class ReadOnlyLogError(StorageError):
    """A write hit a log opened read-only (another process holds the
    writer flock). Transient cluster-wise, unlike a plain
    :class:`StorageError`: routing the write to the writer resolves it."""


class _Log:
    """One open log file: append handle + in-memory id index + string table.

    Single-writer: an exclusive advisory lock (flock) is held on the append
    handle for its lifetime, so a second writer fails fast instead of
    corrupting the intern table (writers assign intern ids from their own
    in-memory count). Readers never take the lock: a ``read_only`` log
    keeps no append handle and refreshes its in-memory index whenever the
    file changes on disk, so a trainer reads while the one writer stays
    live.
    """

    def __init__(self, path: str, read_only: bool = False):
        self.path = path
        self.lock = threading.RLock()
        self.interner = fmt.Interner()
        self.strings: dict[int, str] = {}
        self.index: dict[str, int] = {}  # live event_id -> record offset
        if read_only:
            self.f = None
            self._ro_end = 0  # absolute offset of the next unparsed byte
            self._ro_tail = b""  # last bytes ending at _ro_end (regrow detector)
            self._ro_stat = None  # (st_size, st_mtime_ns) at last refresh
            self.refresh()
            return
        existed = os.path.exists(path)
        self.f = open(path, "ab")
        try:
            fcntl.flock(self.f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            self.f.close()
            raise StorageError(
                f"event log {path} is locked by another writer "
                "(eventlog is single-writer; route writes through one "
                "event server / store instance)"
            )
        if existed:
            with open(path, "rb") as rf:
                buf = rf.read()
            if len(buf) == 0:
                existed = False  # crash before the magic was written
        if existed:
            self.strings, self.index, _ = fmt.read_log(buf)
            self.interner.ids = {s: i for i, s in self.strings.items()}
            # a crash can leave a torn/zeroed tail; new appends after it
            # would be unreachable, so truncate back to the last valid record
            valid_end = fmt.valid_extent(buf)
            if valid_end < len(buf):
                self.f.truncate(valid_end)
                self.f.seek(valid_end)
        if self.f.tell() == 0:
            self.f.write(fmt.MAGIC)
            self.f.flush()

    def refresh(self) -> None:
        """Writer: flush appends to disk. Read-only: fold newly appended
        records into the in-memory index/string table. Only the suffix past
        the last complete record is parsed; a torn tail is retried from the
        same offset once the writer completes it."""
        with self.lock:
            if self.f is not None:
                self.f.flush()
                return
            try:
                st = os.stat(self.path)
            except FileNotFoundError:
                return
            size = st.st_size
            sig = (st.st_size, st.st_mtime_ns)
            if sig == self._ro_stat and size <= self._ro_end:
                # same stat signature: still verify the tail bytes, since a
                # truncate-then-regrow within one mtime granule keeps it
                if self._ro_tail and _pread(
                    self.path, self._ro_end - len(self._ro_tail),
                    len(self._ro_tail),
                ) == self._ro_tail:
                    return
                self._ro_stat = None
            if size < self._ro_end:
                # the file shrank (a recovering writer truncated a torn
                # tail): rebuild the view from scratch
                self._reset_ro_view()
            if self._ro_end == 0 and size < len(fmt.MAGIC):
                return
            with open(self.path, "rb") as rf:
                magic = rf.read(len(fmt.MAGIC))
                if magic != fmt.MAGIC:
                    raise StorageError(f"{self.path} is not a PIOLOG01 file")
                if self._ro_end == 0:
                    self._ro_end = len(fmt.MAGIC)
                    self._ro_tail = fmt.MAGIC
                elif self._ro_tail:
                    # truncate-then-regrow: the bytes under our offset
                    # changed although the size did not shrink
                    rf.seek(self._ro_end - len(self._ro_tail))
                    if rf.read(len(self._ro_tail)) != self._ro_tail:
                        self._reset_ro_view()
                        self._ro_end = len(fmt.MAGIC)
                        self._ro_tail = fmt.MAGIC
                if size <= self._ro_end:
                    self._ro_stat = sig
                    return
                rf.seek(self._ro_end)
                chunk = rf.read()
            old_end = self._ro_end
            self._ro_end = fmt.apply_records(
                chunk, old_end, self.strings, self.index
            )
            consumed = self._ro_end - old_end
            self._ro_tail = (self._ro_tail + chunk[:consumed])[-32:]
            self._ro_stat = sig

    def _reset_ro_view(self) -> None:
        self._ro_end = 0
        self._ro_tail = b""
        self._ro_stat = None
        self.strings = {}
        self.index = {}

    def _require_writer(self) -> None:
        if self.f is None:
            raise ReadOnlyLogError(
                f"event log {self.path} opened read-only (another process "
                "holds the writer lock); route writes through the writer"
            )

    def append_event(self, event: Event, event_id: str) -> None:
        self.append_events([(event, event_id)])

    def append_events(self, pairs: Sequence[tuple[Event, str]]) -> None:
        """Group commit: every record encoded, ONE write + ONE flush for
        the whole batch."""
        self._require_writer()
        with self.lock:
            off_base = self.f.tell()
            chunks: list[bytes] = []
            offsets: list[tuple[str, int]] = []  # event_id -> record offset
            pos = 0
            for event, event_id in pairs:
                blob = fmt.encode_event(event, event_id, self.interner)
                # the EVENT record is the blob's last (INTERN records may
                # precede it): find its offset by replaying the lengths
                p, last = 0, 0
                while p < len(blob):
                    (plen,) = fmt.struct.unpack_from("<I", blob, p)
                    last = p
                    p += 4 + plen
                chunks.append(blob)
                offsets.append((event_id, off_base + pos + last))
                pos += len(blob)
            self.f.write(b"".join(chunks))
            self.f.flush()
            for event_id, off in offsets:
                self.index[event_id] = off
            for s, i in self.interner.ids.items():
                self.strings.setdefault(i, s)

    def append_tombstone(self, event_id: str) -> None:
        self._require_writer()
        with self.lock:
            self.f.write(fmt.encode_tombstone(event_id))
            self.f.flush()
            self.index.pop(event_id, None)

    def read_at(self, offset: int) -> Event:
        with self.lock:
            self.refresh()
            with open(self.path, "rb") as f:
                f.seek(offset)
                (plen,) = fmt.struct.unpack_from("<I", f.read(4), 0)
                payload = f.read(plen)
            _, event = fmt.decode_event_payload(payload, self.strings)
            return event

    def close(self) -> None:
        with self.lock:
            if self.f is not None:
                self.f.close()


def _pread(path: str, offset: int, n: int) -> bytes:
    with open(path, "rb") as f:
        f.seek(max(offset, 0))
        return f.read(n)


class EventLogEvents(EventStore):
    def __init__(self, base_dir: str):
        self.base_dir = base_dir
        os.makedirs(base_dir, exist_ok=True)
        self._logs: dict[tuple[int, Optional[int]], _Log] = {}
        self._lock = threading.RLock()

    def _path(self, app_id: int, channel_id: Optional[int]) -> str:
        name = f"app_{app_id}" + (f"_{channel_id}" if channel_id is not None else "")
        return os.path.join(self.base_dir, name + ".piolog")

    def log_path(self, app_id: int, channel_id: Optional[int] = None) -> str:
        """Path of the append-only log file of one app/channel: the ordered
        change feed the streaming updater tails (``streaming/feed.py``)."""
        return self._path(app_id, channel_id)

    def _log(self, app_id: int, channel_id: Optional[int], create: bool = False) -> _Log:
        key = (app_id, channel_id)
        with self._lock:
            log = self._logs.get(key)
            if log is None:
                path = self._path(app_id, channel_id)
                if not create and not os.path.exists(path):
                    raise StorageError(
                        f"event log for app {app_id} channel {channel_id} not initialized"
                    )
                try:
                    log = _Log(path)
                except StorageError:
                    # another process holds the writer lock: serve reads
                    # from a lock-free read-only view
                    log = _Log(path, read_only=True)
                self._logs[key] = log
            return log

    # -- lifecycle --------------------------------------------------------
    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        self._log(app_id, channel_id, create=True)
        return True

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self._lock:
            log = self._logs.pop((app_id, channel_id), None)
            if log is not None:
                log.close()
            path = self._path(app_id, channel_id)
            if os.path.exists(path):
                os.remove(path)
                return True
            return False

    def close(self) -> None:
        with self._lock:
            for log in self._logs.values():
                log.close()
            self._logs.clear()

    # -- CRUD -------------------------------------------------------------
    def ingest_raw(self, body: bytes, single: bool, max_items: int,
                   whitelist: Sequence[str], app_id: int,
                   channel_id: Optional[int] = None):
        """The reference's C ingest fast path (:345-393)."""
        raise NotImplementedError(NATIVE_INGEST)

    def insert(self, event: Event, app_id: int, channel_id: Optional[int] = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: Optional[int] = None
    ) -> list[str]:
        log = self._log(app_id, channel_id, create=True)
        pairs = []
        for event in events:
            event_id = event.event_id or os.urandom(16).hex()
            pairs.append((event.with_id(event_id), event_id))
        log.append_events(pairs)
        return [event_id for _, event_id in pairs]

    def get(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> Optional[Event]:
        try:
            log = self._log(app_id, channel_id)
        except StorageError:
            return None
        log.refresh()  # read-only views pick up the writer's appends
        off = log.index.get(event_id)
        if off is None:
            return None
        return log.read_at(off)

    def delete(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> bool:
        try:
            log = self._log(app_id, channel_id)
        except StorageError:
            return False
        log._require_writer()  # a stale read-only index must not answer False
        if event_id not in log.index:
            return False
        log.append_tombstone(event_id)
        return True

    # -- queries ----------------------------------------------------------
    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Any = UNSET,
        target_entity_id: Any = UNSET,
        limit: Optional[int] = None,
        reversed: bool = False,
    ):
        """The reference's pure-Python scan (:459-498): one full read and
        decode of the log, live events filtered, ordered by (event time,
        record offset), descending when ``reversed``."""
        log = self._log(app_id, channel_id)
        with log.lock:
            log.refresh()
            with open(log.path, "rb") as f:
                buf = f.read()
        strings, live, _ = fmt.read_log(buf)
        live_offsets = set(live.values())
        start_us = fmt.time_to_us(start_time) if start_time else None
        until_us = fmt.time_to_us(until_time) if until_time else None
        names = set(event_names) if event_names else None
        out: list[tuple[int, int, Event]] = []
        for off, kind, payload in fmt.iter_records(buf):
            if kind != fmt.KIND_EVENT or off not in live_offsets:
                continue
            _, e = fmt.decode_event_payload(payload, strings)
            t_us = fmt.time_to_us(e.event_time)
            if start_us is not None and t_us < start_us:
                continue
            if until_us is not None and t_us >= until_us:
                continue
            if entity_type is not None and e.entity_type != entity_type:
                continue
            if entity_id is not None and e.entity_id != entity_id:
                continue
            if names is not None and e.event not in names:
                continue
            if target_entity_type is not UNSET and e.target_entity_type != target_entity_type:
                continue
            if target_entity_id is not UNSET and e.target_entity_id != target_entity_id:
                continue
            out.append((t_us, off, e))
        out.sort(key=lambda h: (h[0], h[1]), reverse=reversed)
        if limit is not None and limit >= 0:
            out = out[:limit]
        return (e for _, _, e in out)

    def find_by_entities(
        self,
        app_id: int,
        entity_type: str,
        entity_ids: Sequence[str],
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Any = UNSET,
        target_entity_id: Any = UNSET,
        limit_per_entity: Optional[int] = None,
        reversed: bool = False,
    ) -> dict[str, list[Event]]:
        """ONE log scan for the whole entity batch, grouped in the (time,
        offset) order a per-entity :meth:`find` yields."""
        ids = list(dict.fromkeys(entity_ids))
        if not ids:
            return {}
        wanted = set(ids)
        events = (e for e in self.find(
            app_id, channel_id, start_time, until_time, entity_type, None,
            event_names, target_entity_type, target_entity_id,
            None, reversed=reversed,
        ) if e.entity_id in wanted)
        return self.group_events_by_entity(events, ids, limit_per_entity)

    # assemble_triples and aggregate_properties are the base class's: the
    # reference's Python paths when its C++ assembler and fold are absent
    # (:573-578, :612-615)


class EventLogStorageClient(StorageClient):
    """EVENTDATA-only backend over append-only logs."""

    def __init__(self, config: dict[str, str]):
        super().__init__(config)
        path = config.get("PATH")
        if not path:
            from incubator_predictionio_tpu_torch.utils.fs import base_dir

            path = os.path.join(base_dir(), "eventlog")
        self._events = EventLogEvents(path)

    def events(self) -> EventStore:
        return self._events

    def close(self) -> None:
        self._events.close()
