"""The PIOLOG01 binary event-log codec.

Counterpart of ``incubator_predictionio_tpu/native/format.py`` (:56-405):
the record framing, the TLV property codec, the writer-side string table,
the event/tombstone records and the one-pass index fold (:func:`read_log`,
:func:`apply_records`). The ``eventlog`` storage backend
(``data/storage/eventlog_backend.py``) writes and scans such a log, and the
streaming feed (``streaming/feed.py``) tails it; the bytes are the
reference's. The reference's C++ scanner is not part of the port: every
read here is the reference's pure-Python path.

Layout (all integers little-endian)::

    file      := magic "PIOLOG01" record*
    record    := u32 payload_len, payload
    payload   := kind:u8 body
    kind      := 1 INTERN | 2 EVENT | 3 TOMBSTONE

    INTERN    := id:u32 len:u16 utf8
    TOMBSTONE := event_id:str16
    EVENT     := event_id:str16
                 event_time_us:i64  event_tz_min:i16
                 creation_time_us:i64 creation_tz_min:i16
                 name_id:u32 entity_type_id:u32 target_type_id:u32 (NONE_ID = absent)
                 entity_id:str16
                 target_entity_id:optstr16
                 pr_id:optstr16
                 n_tags:u16 str16*
                 props_len:u32 TLV             # root is always an OBJECT

    str16     := len:u16 utf8
    optstr16  := 0xFFFF | str16

TLV values: 0 null | 1 false | 2 true | 3 int:i64 | 4 double:f64 |
5 string len:u32 utf8 | 6 array n:u32 value* | 7 object n:u32 (key:str16
value)* | 8 bigint len:u32 decimal-ascii.
"""

from __future__ import annotations

import datetime as _dt
import struct
from collections.abc import Mapping
from typing import Any, Iterator, Optional

from incubator_predictionio_tpu_torch.data.event import DataMap, Event

MAGIC = b"PIOLOG01"
KIND_INTERN = 1
KIND_EVENT = 2
KIND_TOMBSTONE = 3
NONE_ID = 0xFFFFFFFF
_ABSENT16 = 0xFFFF
_I64_MIN, _I64_MAX = -(2**63), 2**63 - 1

UTC = _dt.timezone.utc
_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=UTC)


# -- TLV codec ----------------------------------------------------------------

def encode_tlv(value: Any, out: bytearray) -> None:
    if value is None:
        out.append(0)
    elif value is True:
        out.append(2)
    elif value is False:
        out.append(1)
    elif isinstance(value, int):
        if _I64_MIN <= value <= _I64_MAX:
            out.append(3)
            out += struct.pack("<q", value)
        else:
            raw = str(value).encode()
            out.append(8)
            out += struct.pack("<I", len(raw))
            out += raw
    elif isinstance(value, float):
        out.append(4)
        out += struct.pack("<d", value)
    elif isinstance(value, str):
        raw = value.encode()
        out.append(5)
        out += struct.pack("<I", len(raw))
        out += raw
    elif isinstance(value, (list, tuple)):
        out.append(6)
        out += struct.pack("<I", len(value))
        for v in value:
            encode_tlv(v, out)
    elif isinstance(value, Mapping):
        out.append(7)
        out += struct.pack("<I", len(value))
        for k, v in value.items():
            kraw = str(k).encode()
            out += struct.pack("<H", len(kraw))
            out += kraw
            encode_tlv(v, out)
    else:
        raise TypeError(f"value not JSON-encodable into TLV: {value!r}")


def decode_tlv(buf: bytes, pos: int = 0) -> tuple[Any, int]:
    t = buf[pos]
    pos += 1
    if t == 0:
        return None, pos
    if t == 1:
        return False, pos
    if t == 2:
        return True, pos
    if t == 3:
        return struct.unpack_from("<q", buf, pos)[0], pos + 8
    if t == 4:
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if t == 5:
        (n,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        return buf[pos:pos + n].decode(), pos + n
    if t == 6:
        (n,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        items = []
        for _ in range(n):
            v, pos = decode_tlv(buf, pos)
            items.append(v)
        return items, pos
    if t == 7:
        (n,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        obj: dict[str, Any] = {}
        for _ in range(n):
            (klen,) = struct.unpack_from("<H", buf, pos)
            pos += 2
            k = buf[pos:pos + klen].decode()
            pos += klen
            obj[k], pos = decode_tlv(buf, pos)
        return obj, pos
    if t == 8:
        (n,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        return int(buf[pos:pos + n].decode()), pos + n
    raise ValueError(f"bad TLV type byte {t} at {pos - 1}")


# -- time helpers ---------------------------------------------------------------

def _to_us_tz(t: _dt.datetime) -> tuple[int, int]:
    """(microseconds since epoch UTC, original tz offset in minutes)."""
    if t.tzinfo is None:
        t = t.replace(tzinfo=UTC)
    off = t.utcoffset()
    off_min = int(off.total_seconds() // 60) if off is not None else 0
    us = int((t - _EPOCH) / _dt.timedelta(microseconds=1))
    return us, off_min


def _from_us_tz(us: int, tz_min: int) -> _dt.datetime:
    tz = UTC if tz_min == 0 else _dt.timezone(_dt.timedelta(minutes=tz_min))
    return (_EPOCH + _dt.timedelta(microseconds=us)).astimezone(tz)


def time_to_us(t: _dt.datetime) -> int:
    return _to_us_tz(t)[0]


# -- record encoding ------------------------------------------------------------

def _str16(s: str, out: bytearray) -> None:
    raw = s.encode()
    if len(raw) >= _ABSENT16:
        raise ValueError(f"string too long for str16: {len(raw)} bytes")
    out += struct.pack("<H", len(raw))
    out += raw


def _optstr16(s: Optional[str], out: bytearray) -> None:
    if s is None:
        out += struct.pack("<H", _ABSENT16)
    else:
        _str16(s, out)


class Interner:
    """Writer-side string table; ids are per-file and append-ordered."""

    def __init__(self) -> None:
        self.ids: dict[str, int] = {}

    def intern(self, s: str, out: bytearray) -> int:
        """Return the id for ``s``, appending an INTERN record to ``out`` if new."""
        i = self.ids.get(s)
        if i is None:
            i = len(self.ids)
            self.ids[s] = i
            raw = s.encode()
            payload = struct.pack("<BIH", KIND_INTERN, i, len(raw)) + raw
            out += struct.pack("<I", len(payload))
            out += payload
        return i


def encode_event(event: Event, event_id: str, interner: Interner) -> bytes:
    """Encode one event (preceded by any new INTERN records) ready to append."""
    out = bytearray()
    name_id = interner.intern(event.event, out)
    etype_id = interner.intern(event.entity_type, out)
    ttype_id = (
        NONE_ID
        if event.target_entity_type is None
        else interner.intern(event.target_entity_type, out)
    )
    body = bytearray()
    body.append(KIND_EVENT)
    _str16(event_id, body)
    ev_us, ev_tz = _to_us_tz(event.event_time)
    cr_us, cr_tz = _to_us_tz(event.creation_time)
    body += struct.pack("<qhqh", ev_us, ev_tz, cr_us, cr_tz)
    body += struct.pack("<III", name_id, etype_id, ttype_id)
    _str16(event.entity_id, body)
    _optstr16(event.target_entity_id, body)
    _optstr16(event.pr_id, body)
    body += struct.pack("<H", len(event.tags))
    for tag in event.tags:
        _str16(tag, body)
    props = bytearray()
    encode_tlv(event.properties.to_dict(), props)
    body += struct.pack("<I", len(props))
    body += props
    out += struct.pack("<I", len(body))
    out += body
    return bytes(out)


def encode_tombstone(event_id: str) -> bytes:
    out = bytearray()
    out.append(KIND_TOMBSTONE)
    _str16(event_id, out)
    return struct.pack("<I", len(out)) + bytes(out)


# -- record decoding --------------------------------------------------------------

def _read_str16(buf: bytes, pos: int) -> tuple[str, int]:
    (n,) = struct.unpack_from("<H", buf, pos)
    pos += 2
    return buf[pos:pos + n].decode(), pos + n


def _read_optstr16(buf: bytes, pos: int) -> tuple[Optional[str], int]:
    (n,) = struct.unpack_from("<H", buf, pos)
    pos += 2
    if n == _ABSENT16:
        return None, pos
    return buf[pos:pos + n].decode(), pos + n


def decode_event_payload(
    payload: bytes, strings: dict[int, str]
) -> tuple[str, Event]:
    """Decode an EVENT payload (kind byte included). Returns (event_id,
    Event)."""
    pos = 1  # kind byte
    eid, pos = _read_str16(payload, pos)
    ev_us, ev_tz, cr_us, cr_tz = struct.unpack_from("<qhqh", payload, pos)
    pos += 20
    name_id, etype_id, ttype_id = struct.unpack_from("<III", payload, pos)
    pos += 12
    entity_id, pos = _read_str16(payload, pos)
    target_id, pos = _read_optstr16(payload, pos)
    pr_id, pos = _read_optstr16(payload, pos)
    (n_tags,) = struct.unpack_from("<H", payload, pos)
    pos += 2
    tags = []
    for _ in range(n_tags):
        tag, pos = _read_str16(payload, pos)
        tags.append(tag)
    pos += 4  # props_len: the TLV is self-delimiting
    props, _ = decode_tlv(payload, pos)
    event = Event(
        event=strings[name_id],
        entity_type=strings[etype_id],
        entity_id=entity_id,
        target_entity_type=None if ttype_id == NONE_ID else strings[ttype_id],
        target_entity_id=target_id,
        properties=DataMap(props),
        event_time=_from_us_tz(ev_us, ev_tz),
        tags=tuple(tags),
        pr_id=pr_id,
        event_id=eid,
        creation_time=_from_us_tz(cr_us, cr_tz),
    )
    return eid, event


def iter_records(buf: bytes) -> Iterator[tuple[int, int, bytes]]:
    """Yield (offset, kind, payload) for every complete record in a log
    buffer; a torn or zeroed tail ends the walk."""
    if buf[:8] != MAGIC:
        raise ValueError("not a PIOLOG01 file")
    pos = 8
    n = len(buf)
    while pos + 4 <= n:
        (plen,) = struct.unpack_from("<I", buf, pos)
        if pos + 4 + plen > n or plen == 0:
            break
        payload = buf[pos + 4:pos + 4 + plen]
        yield pos, payload[0], payload
        pos += 4 + plen


def read_log(
    buf: bytes,
) -> tuple[dict[int, str], dict[str, int], set[str]]:
    """One pass: (string table, event_id→offset of live events, tombstoned
    ids). Tombstones apply in file order: a TOMBSTONE kills only *prior*
    events with that id, so an id re-inserted after a delete is live
    again."""
    if buf[:8] != MAGIC:
        raise ValueError("not a PIOLOG01 file")
    strings: dict[int, str] = {}
    offsets: dict[str, int] = {}
    dead: set[str] = set()
    apply_records(buf[8:], 8, strings, offsets, dead)
    return strings, offsets, dead


def valid_extent(buf: bytes) -> int:
    """Byte offset just past the last complete record (where a torn or
    zeroed tail begins; == len(buf) when the log is clean)."""
    if buf[:8] != MAGIC:
        raise ValueError("not a PIOLOG01 file")
    return record_run_end(buf, 8)


def record_run_end(buf: bytes, pos: int) -> int:
    """Offset just past the last complete ``[u32 len][payload]`` record of
    the run starting at ``pos``; stops at a zeroed length or a truncated
    record."""
    n = len(buf)
    while pos + 4 <= n:
        (plen,) = struct.unpack_from("<I", buf, pos)
        if pos + 4 + plen > n or plen == 0:
            break
        pos += 4 + plen
    return pos


def apply_records(
    chunk: bytes,
    base_off: int,
    strings: dict[int, str],
    index: dict[str, int],
    dead: Optional[set] = None,
) -> int:
    """Fold a raw record run (no magic header) starting at absolute file
    offset ``base_off`` into ``strings``/``index`` in place: :func:`read_log`
    feeds it a whole file, a read-only log view just the suffix the writer
    appended since its last refresh. Returns the absolute offset just past
    the last complete record (the next tail position)."""
    pos = 0
    n = len(chunk)
    while pos + 4 <= n:
        (plen,) = struct.unpack_from("<I", chunk, pos)
        if pos + 4 + plen > n or plen == 0:
            break  # torn tail: retry from here next refresh
        payload = chunk[pos + 4:pos + 4 + plen]
        kind = payload[0]
        if kind == KIND_INTERN:
            sid, slen = struct.unpack_from("<IH", payload, 1)
            strings[sid] = payload[7:7 + slen].decode()
        elif kind == KIND_EVENT:
            eid, _ = _read_str16(payload, 1)
            index[eid] = base_off + pos
        elif kind == KIND_TOMBSTONE:
            eid, _ = _read_str16(payload, 1)
            index.pop(eid, None)
            if dead is not None:
                dead.add(eid)
        pos += 4 + plen
    return base_off + pos
