"""The event model: ``Event``, ``DataMap``, ``epoch_micros``.

Counterpart of ``incubator_predictionio_tpu/data/event.py`` (:27, :91,
:216), cut to what the streaming feed and the fold read: the immutable
event, its property bag, the exact epoch-microseconds
conversion and the JSON form dead letters are written in. Validation and
JSON parsing come with the event server.
"""

from __future__ import annotations

import datetime as _dt
import json
from collections.abc import Iterator, Mapping
from dataclasses import dataclass, field
from typing import Any

UTC = _dt.timezone.utc

EPOCH = _dt.datetime(1970, 1, 1, tzinfo=UTC)
_US_TD = _dt.timedelta(microseconds=1)


def epoch_micros(t: _dt.datetime) -> int:
    """Exact integer microseconds since the epoch (integer arithmetic only;
    naive datetimes are treated as UTC)."""
    if t.tzinfo is None:
        t = t.replace(tzinfo=UTC)
    return (t - EPOCH) // _US_TD


class DataMap(Mapping[str, Any]):
    """Immutable JSON property bag (reference DataMap.scala:45-245); the
    typed getters and combinators come with the event server."""

    __slots__ = ("_fields",)

    def __init__(self, fields: Mapping[str, Any] | None = None):
        object.__setattr__(self, "_fields", dict(fields or {}))

    def __getitem__(self, key: str) -> Any:
        return self._fields[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"DataMap({self._fields!r})"

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DataMap):
            return self._fields == other._fields
        if isinstance(other, Mapping):
            return self._fields == dict(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(json.dumps(self._fields, sort_keys=True, default=str))

    def get(self, name: str, default: Any = None) -> Any:
        return self._fields.get(name, default)

    def to_dict(self) -> dict[str, Any]:
        return dict(self._fields)


@dataclass(frozen=True)
class Event:
    """One immutable event (reference Event.scala:42-66). ``event_time`` is
    when it happened in the world, ``creation_time`` when the event server
    received it; both timezone-aware (UTC default)."""

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: str | None = None
    target_entity_id: str | None = None
    properties: DataMap = field(default_factory=DataMap)
    event_time: _dt.datetime = field(default_factory=lambda: _dt.datetime.now(UTC))
    tags: tuple[str, ...] = ()
    pr_id: str | None = None
    event_id: str | None = None
    creation_time: _dt.datetime = field(default_factory=lambda: _dt.datetime.now(UTC))

    def to_json_dict(self) -> dict[str, Any]:
        """The reference's camelCase JSON form, absent fields dropped."""
        d: dict[str, Any] = {
            "eventId": self.event_id,
            "event": self.event,
            "entityType": self.entity_type,
            "entityId": self.entity_id,
            "properties": self.properties.to_dict(),
            "eventTime": self.event_time.isoformat(),
            "tags": list(self.tags),
            "prId": self.pr_id,
            "creationTime": self.creation_time.isoformat(),
            "targetEntityType": self.target_entity_type,
            "targetEntityId": self.target_entity_id,
        }
        return {k: v for k, v in d.items() if v is not None}
