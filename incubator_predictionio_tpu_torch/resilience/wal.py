"""WAL frame format, as the streaming dead letters use it.

Counterpart of ``incubator_predictionio_tpu/resilience/wal.py`` (:52, :87,
:131), cut to what dead letters need: the segment magic, the frame writer
and the tail-follow reader. A file is ``MAGIC`` then frames of ``[u32
length][u32 crc32(payload)][payload]``, each payload one JSON record. The
spill WAL of the event server comes with the event-server slice.
"""

from __future__ import annotations

import json
import struct
import zlib

MAGIC = b"PIOWAL1\n"
_FRAME = struct.Struct("<II")  # payload length, crc32(payload)


def _crc(payload: bytes) -> int:
    return zlib.crc32(payload) & 0xFFFFFFFF


def write_frame(f, payload: bytes) -> None:
    f.write(_FRAME.pack(len(payload), _crc(payload)))
    f.write(payload)


def tail_frames(
    path: str, from_offset: int = 0,
) -> tuple[list[tuple[int, dict]], int, str]:
    """Tail-follow read of a frame-format file another process may be
    appending to. Returns ``(records, next_offset, status)``: ``records``
    holds ``(offset, record)`` for every complete valid frame at or past
    ``from_offset``; ``status`` is ``"ok"`` (clean end of file),
    ``"waiting"`` (the file ends mid-frame: re-poll from ``next_offset``)
    or ``"corrupt"`` (a complete frame failed its CRC or JSON decode, or
    the magic is wrong)."""
    out: list[tuple[int, dict]] = []
    with open(path, "rb") as f:
        if from_offset < len(MAGIC):
            head = f.read(len(MAGIC))
            if len(head) < len(MAGIC):
                return out, 0, "waiting"
            if head != MAGIC:
                return out, 0, "corrupt"
            off = len(MAGIC)
        else:
            off = from_offset
            f.seek(off)
        while True:
            hdr = f.read(_FRAME.size)
            if not hdr:
                return out, off, "ok"
            if len(hdr) < _FRAME.size:
                return out, off, "waiting"
            length, crc = _FRAME.unpack(hdr)
            payload = f.read(length)
            if len(payload) < length:
                return out, off, "waiting"
            if _crc(payload) != crc:
                return out, off, "corrupt"
            try:
                rec = json.loads(payload)
            except ValueError:
                return out, off, "corrupt"
            out.append((off, rec))
            off += _FRAME.size + length
