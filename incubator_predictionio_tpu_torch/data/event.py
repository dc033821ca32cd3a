"""The event model: ``Event``, ``DataMap``, ``epoch_micros``, validation.

Counterpart of ``incubator_predictionio_tpu/data/event.py`` (:27, :91,
:179, :216, :268, :318), cut to what the streaming feed, the fold, the
event stores and ``import`` read: the immutable event, its property bag,
the aggregation snapshot :class:`PropertyMap`, the exact
epoch-microseconds conversion, the time-prefixed event id, the JSON forms
(``to_json_dict``, ``from_json``), ``with_id`` and
:func:`validate_event`. The typed getters of ``DataMap`` come with the
event server.
"""

from __future__ import annotations

import datetime as _dt
import json
import os
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


def time_prefixed_event_id(creation_time: _dt.datetime) -> str:
    """Server-generated event id: 15 hex chars of creation micros + 16
    random hex + '0' (ids append at the btree's right edge)."""
    return f"{epoch_micros(creation_time):015x}" + os.urandom(8).hex() + "0"


# Reserved name prefixes (Event.scala:77-78).
_RESERVED_PREFIXES = ("$", "pio_")

#: Special single-entity event names (Event.scala:83).
SPECIAL_EVENTS = frozenset({"$set", "$unset", "$delete"})

#: Built-in entity types permitted despite the reserved prefix (Event.scala:146).
BUILTIN_ENTITY_TYPES = frozenset({"pio_pr"})

#: Built-in property names permitted despite the reserved prefix (Event.scala:149).
BUILTIN_PROPERTIES: frozenset[str] = frozenset()


class EventValidationError(ValueError):
    """Raised when an event violates the validation contract."""


def is_reserved_prefix(name: str) -> bool:
    return name.startswith(_RESERVED_PREFIXES)


def is_special_event(name: str) -> bool:
    return name in SPECIAL_EVENTS


def _parse_time(value: Any) -> _dt.datetime:
    """Parse an ISO-8601 timestamp (or pass through a datetime), defaulting
    to UTC."""
    if value is None:
        return _dt.datetime.now(UTC)
    if isinstance(value, _dt.datetime):
        return value if value.tzinfo else value.replace(tzinfo=UTC)
    if isinstance(value, (int, float)):
        return _dt.datetime.fromtimestamp(value, UTC)
    if isinstance(value, str):
        s = value.replace("Z", "+00:00")
        try:
            t = _dt.datetime.fromisoformat(s)
        except ValueError as e:
            raise EventValidationError(f"Cannot convert {value!r} to a timestamp") from e
        return t if t.tzinfo else t.replace(tzinfo=UTC)
    raise EventValidationError(f"Cannot convert {value!r} to a timestamp")


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

    def is_empty(self) -> bool:
        return not self._fields

    def to_dict(self) -> dict[str, Any]:
        return dict(self._fields)


class PropertyMap(DataMap):
    """Aggregation result: a DataMap plus first/last update times
    (reference PropertyMap.scala:36-99)."""

    __slots__ = ("first_updated", "last_updated")

    def __init__(
        self,
        fields: Mapping[str, Any] | None,
        first_updated: _dt.datetime,
        last_updated: _dt.datetime,
    ):
        super().__init__(fields)
        object.__setattr__(self, "first_updated", first_updated)
        object.__setattr__(self, "last_updated", last_updated)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"PropertyMap({self.to_dict()!r}, first_updated={self.first_updated}, "
            f"last_updated={self.last_updated})"
        )

    def __eq__(self, other: object) -> bool:
        if isinstance(other, PropertyMap):
            return (
                self.to_dict() == other.to_dict()
                and self.first_updated == other.first_updated
                and self.last_updated == other.last_updated
            )
        return super().__eq__(other)

    __hash__ = DataMap.__hash__


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

    def with_id(self, event_id: str) -> "Event":
        """A copy with ``event_id`` set (a dict copy: ``dataclasses.replace``
        re-runs the frozen ``__init__`` on the ingestion path)."""
        e = object.__new__(Event)
        e.__dict__.update(self.__dict__)
        e.__dict__["event_id"] = event_id
        return e

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

    @staticmethod
    def from_json_dict(
        d: Mapping[str, Any],
        creation_time: _dt.datetime | None = None,
    ) -> "Event":
        """The camelCase JSON form → an Event. Trusts ``creationTime`` when
        present (the storage round trip); ``creation_time`` wins over it."""
        def _req_str(key: str) -> str:
            v = d.get(key)
            if v is None or not isinstance(v, str):
                raise EventValidationError(f"field {key} is required and must be a string")
            return v

        tags = d.get("tags", [])
        if not isinstance(tags, list):
            raise EventValidationError("tags must be a list of strings")
        props = d.get("properties", {})
        if props is None:
            props = {}
        if not isinstance(props, Mapping):
            raise EventValidationError("properties must be a JSON object")
        return Event(
            event=_req_str("event"),
            entity_type=_req_str("entityType"),
            entity_id=_req_str("entityId"),
            target_entity_type=d.get("targetEntityType"),
            target_entity_id=d.get("targetEntityId"),
            properties=DataMap(props),
            event_time=_parse_time(d.get("eventTime")),
            tags=tuple(str(t) for t in tags),
            pr_id=d.get("prId"),
            event_id=d.get("eventId"),
            creation_time=(creation_time if creation_time is not None
                           else _parse_time(d.get("creationTime"))),
        )

    @staticmethod
    def from_json(s: str | bytes) -> "Event":
        try:
            d = json.loads(s)
        except json.JSONDecodeError as e:
            raise EventValidationError(f"invalid JSON: {e}") from e
        if not isinstance(d, dict):
            raise EventValidationError("event JSON must be an object")
        return Event.from_json_dict(d)


def validate_event(e: Event) -> Event:
    """Validate an event, raising :class:`EventValidationError` on a
    violation — the reference validator's rules (Event.scala:112-167)."""
    def req(cond: bool, msg: str) -> None:
        if not cond:
            raise EventValidationError(msg)

    req(bool(e.event), "event must not be empty.")
    req(bool(e.entity_type), "entityType must not be empty string.")
    req(bool(e.entity_id), "entityId must not be empty string.")
    req(e.target_entity_type != "", "targetEntityType must not be empty string")
    req(e.target_entity_id != "", "targetEntityId must not be empty string.")
    req(
        (e.target_entity_type is None) == (e.target_entity_id is None),
        "targetEntityType and targetEntityId must be specified together.",
    )
    req(
        not (e.event == "$unset" and e.properties.is_empty()),
        "properties cannot be empty for $unset event",
    )
    req(
        not is_reserved_prefix(e.event) or is_special_event(e.event),
        f"{e.event} is not a supported reserved event name.",
    )
    req(
        not is_special_event(e.event)
        or (e.target_entity_type is None and e.target_entity_id is None),
        f"Reserved event {e.event} cannot have targetEntity",
    )
    req(
        not is_reserved_prefix(e.entity_type) or e.entity_type in BUILTIN_ENTITY_TYPES,
        f"The entityType {e.entity_type} is not allowed. 'pio_' is a reserved name prefix.",
    )
    req(
        e.target_entity_type is None
        or not is_reserved_prefix(e.target_entity_type)
        or e.target_entity_type in BUILTIN_ENTITY_TYPES,
        f"The targetEntityType {e.target_entity_type} is not allowed. "
        "'pio_' is a reserved name prefix.",
    )
    for k in e.properties:
        req(
            not is_reserved_prefix(k) or k in BUILTIN_PROPERTIES,
            f"The property {k} is not allowed. 'pio_' is a reserved name prefix.",
        )
    return e
