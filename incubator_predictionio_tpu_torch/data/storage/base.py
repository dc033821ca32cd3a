"""Storage contracts: the event store, the metadata DAOs, the model store.

Counterpart of ``incubator_predictionio_tpu/data/storage/base.py``, cut to
what training, deploy and serving read: :class:`EventStore` with the
reference's defaults of :meth:`~EventStore.find_by_entities` (:113) and its
shared grouping loop :meth:`~EventStore.group_events_by_entity` (:156),
:meth:`~EventStore.aggregate_properties` (:201) and
:meth:`~EventStore.assemble_triples` (:241-368), ``_coerce_value`` and
:func:`filter_events` (:879); the records :class:`App`, :class:`AccessKey`,
:class:`Channel`, :class:`EngineInstance`, :class:`EvaluationInstance`,
:class:`Model`; the stores' contracts (:class:`AppsStore`,
:class:`AccessKeysStore`, :class:`ChannelsStore`,
:class:`EngineInstancesStore`, :class:`EvaluationInstancesStore`,
:class:`ModelsStore`) and :class:`StorageClient`. Sharded reads
(``find_sharded``, the ``n_shards`` options) come with the sharding slice
(ROADMAP.md Queue 1, item 4); jobs and the dump/load contract with item 7.
"""

from __future__ import annotations

import abc
import datetime as _dt
import re
import secrets
from collections.abc import Iterable, Iterator, Sequence
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from incubator_predictionio_tpu_torch.data.aggregator import (
    AGGREGATOR_EVENT_NAMES,
    aggregate_properties as _aggregate,
)
from incubator_predictionio_tpu_torch.data.event import Event, PropertyMap


class StorageError(Exception):
    """Raised on backend failures (reference StorageException)."""


#: Sentinel distinguishing "no filter" from "filter for None" in target-entity
#: filters (the reference models this as Option[Option[String]] —
#: PEvents.scala:56-60).
UNSET: Any = object()


# ---------------------------------------------------------------------------
# Event store
# ---------------------------------------------------------------------------

class EventStore(abc.ABC):
    """Behavioral contract for EVENTDATA backends (LEvents.scala:40,
    PEvents.scala:38). All methods are synchronous."""

    @abc.abstractmethod
    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        """Initialize the store for an app/channel; idempotent."""

    @abc.abstractmethod
    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        """Remove all data for an app/channel."""

    def close(self) -> None:
        """Release backend resources."""

    @abc.abstractmethod
    def insert(self, event: Event, app_id: int, channel_id: Optional[int] = None) -> str:
        """Insert one event; returns the assigned event id."""

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: Optional[int] = None
    ) -> list[str]:
        """Insert many events; default loops, backends may override."""
        return [self.insert(e, app_id, channel_id) for e in events]

    @abc.abstractmethod
    def get(
        self, event_id: str, app_id: int, channel_id: Optional[int] = None
    ) -> Optional[Event]: ...

    @abc.abstractmethod
    def delete(
        self, event_id: str, app_id: int, channel_id: Optional[int] = None
    ) -> bool: ...

    @abc.abstractmethod
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
    ) -> Iterator[Event]:
        """Iterate events in event-time order (descending when ``reversed``).

        ``limit=None`` or a negative limit returns everything. Target-entity
        filters accept :data:`UNSET` (no filter), ``None`` (must be absent),
        or a string (must equal).
        """

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
        """Batched per-entity read: one storage round trip for many
        entities. Returns ``{entity_id: [events]}`` with every requested id
        present (eventless ids map to ``[]``); each list is ordered and
        truncated exactly as ``find(entity_id=..., limit=limit_per_entity,
        reversed=reversed)`` would. The default loops :meth:`find` per
        entity; backends with a bulk path override it."""
        return {
            eid: list(self.find(
                app_id, channel_id, start_time, until_time, entity_type,
                eid, event_names, target_entity_type, target_entity_id,
                limit_per_entity, reversed=reversed,
            ))
            for eid in dict.fromkeys(entity_ids)
        }

    @staticmethod
    def group_events_by_entity(
        events: Iterable[Event],
        entity_ids: Sequence[str],
        limit_per_entity: Optional[int],
    ) -> dict[str, list[Event]]:
        """The shared grouping/cap loop of :meth:`find_by_entities`
        overrides: bucket an (already ordered) event stream per entity,
        keeping at most ``limit_per_entity`` each; events of entities
        outside ``entity_ids`` are dropped, every requested id is
        present."""
        out: dict[str, list[Event]] = {eid: [] for eid in entity_ids}
        limit = (limit_per_entity if limit_per_entity is not None
                 and limit_per_entity >= 0 else None)
        for e in events:
            bucket = out.get(e.entity_id)
            if bucket is None:
                continue
            if limit is None or len(bucket) < limit:
                bucket.append(e)
        return out

    def aggregate_properties(
        self,
        app_id: int,
        entity_type: str,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        required: Optional[Sequence[str]] = None,
    ) -> dict[str, PropertyMap]:
        """Fold ``$set/$unset/$delete`` into per-entity snapshots
        (LEvents.scala:264-296); with ``required``, only entities whose
        snapshot holds every required key."""
        agg = _aggregate(self.find(
            app_id, channel_id, start_time, until_time, entity_type, None,
            AGGREGATOR_EVENT_NAMES,
        ))
        if required:
            req = set(required)
            agg = {k: v for k, v in agg.items() if req <= set(v.keys())}
        return agg

    def assemble_triples(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Any = UNSET,
        value_property: Optional[str] = None,
        default_values: Optional[dict] = None,
        missing_value: float = 0.0,
        dedup: bool = False,
        chunk_rows: int = 262_144,
    ):
        """Matching events → columnar (entity, target, value) training triples.

        Returns ``(entity_vocab, target_vocab, entity_idx, target_idx,
        values)``: two object arrays of distinct ids in first-emitted order,
        two int32 index arrays into them, and a float32 value array.

        Per event the value is ``default_values[event_name]`` when present,
        else the numeric coercion of ``value_property`` (numbers, bools, and
        fully-numeric strings), else ``missing_value``. Events without a
        target entity are skipped. ``dedup=True`` keeps one row per
        (entity, target) pair — the latest event wins, rows in pair-first-seen
        order; ``dedup=False`` emits one row per event in time order. Rows
        accumulate into fixed-size numpy chunks (``chunk_rows``).
        """
        defaults = dict(default_values or {})
        evocab: dict[str, int] = {}
        tvocab: dict[str, int] = {}
        pair_row: dict[tuple[int, int], int] = {}
        chunks: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        ce = np.empty(chunk_rows, np.int32)
        ct = np.empty(chunk_rows, np.int32)
        cv = np.empty(chunk_rows, np.float32)
        fill = 0
        n_rows = 0

        def flush():
            nonlocal fill
            if fill:
                chunks.append((ce[:fill].copy(), ct[:fill].copy(), cv[:fill].copy()))
                fill = 0

        def set_row(row: int, v: float) -> None:
            # dedup overwrite: the row may live in a flushed chunk
            chunk, off = divmod(row, chunk_rows)
            if chunk < len(chunks):
                chunks[chunk][2][off] = v
            else:
                cv[off] = v

        events = self.find(
            app_id, channel_id, start_time, until_time, entity_type, None,
            event_names, target_entity_type,
        )
        for e in events:
            if e.target_entity_id is None:
                continue
            if e.event in defaults:
                v = float(defaults[e.event])
            else:
                raw = (
                    e.properties.get(value_property)
                    if value_property is not None else None
                )
                v = _coerce_value(raw, missing_value)
            ui = evocab.setdefault(e.entity_id, len(evocab))
            ti = tvocab.setdefault(e.target_entity_id, len(tvocab))
            if dedup:
                row = pair_row.get((ui, ti))
                if row is not None:
                    set_row(row, v)
                    continue
                pair_row[(ui, ti)] = n_rows
            ce[fill], ct[fill], cv[fill] = ui, ti, v
            fill += 1
            n_rows += 1
            if fill == chunk_rows:
                flush()
        flush()
        if not chunks:
            e_idx = np.empty(0, np.int32)
            t_idx = np.empty(0, np.int32)
            vals = np.empty(0, np.float32)
        else:
            e_idx = np.concatenate([c[0] for c in chunks])
            t_idx = np.concatenate([c[1] for c in chunks])
            vals = np.concatenate([c[2] for c in chunks])
        return (
            np.asarray(list(evocab), object),
            np.asarray(list(tvocab), object),
            e_idx,
            t_idx,
            vals,
        )


# Strict decimal grammar of the reference (shared there with its native
# scanner): digits with optional '.'/exponent, or inf/infinity/nan.
_DECIMAL_RE = re.compile(
    r"[+-]?((\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?|inf(inity)?|nan)",
    re.ASCII | re.IGNORECASE,
)


def _coerce_value(raw: Any, missing_value: float) -> float:
    """Numeric coercion for assemble_triples property values."""
    if raw is None:
        return missing_value
    if isinstance(raw, str):
        s = raw.strip(" \t\n\r\v\f")
        return float(s) if _DECIMAL_RE.fullmatch(s) else missing_value
    try:
        return float(raw)
    except (TypeError, ValueError):
        return missing_value


def filter_events(
    events: Iterable[Event],
    start_time: Optional[_dt.datetime] = None,
    until_time: Optional[_dt.datetime] = None,
    entity_type: Optional[str] = None,
    entity_id: Optional[str] = None,
    event_names: Optional[Sequence[str]] = None,
    target_entity_type: Any = UNSET,
    target_entity_id: Any = UNSET,
) -> Iterator[Event]:
    """The in-memory predicate filter of backends without indexes."""
    names = set(event_names) if event_names is not None else None
    for e in events:
        if start_time is not None and e.event_time < start_time:
            continue
        if until_time is not None and e.event_time >= until_time:
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
        yield e


def entity_shard(entity_id: str, n_shards: int) -> int:
    """Stable entity→shard assignment (zlib.crc32; hash() is salted per-process)."""
    import zlib

    return zlib.crc32(entity_id.encode()) % n_shards


# ---------------------------------------------------------------------------
# Meta-data records
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class App:
    """(Apps.scala:28-34)"""
    id: int
    name: str
    description: Optional[str] = None


@dataclass(frozen=True)
class AccessKey:
    """(AccessKeys.scala:29-37); empty ``events`` whitelist = all events allowed."""
    key: str
    app_id: int
    events: tuple[str, ...] = ()


@dataclass(frozen=True)
class Channel:
    """(Channels.scala:28-42)"""
    id: int
    name: str
    app_id: int

    NAME_RE = re.compile(r"^[a-zA-Z0-9-]{1,16}$")

    @staticmethod
    def is_valid_name(name: str) -> bool:
        return bool(Channel.NAME_RE.match(name))


@dataclass(frozen=True)
class EngineInstance:
    """One train run's metadata (EngineInstances.scala:35-50)."""
    id: str
    status: str  # INIT | TRAINING | COMPLETED | FAILED
    start_time: _dt.datetime
    end_time: Optional[_dt.datetime]
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str
    batch: str = ""
    env: dict[str, str] = field(default_factory=dict)
    mesh_conf: dict[str, Any] = field(default_factory=dict)
    data_source_params: str = "{}"
    preparator_params: str = "{}"
    algorithms_params: str = "[]"
    serving_params: str = "{}"


@dataclass(frozen=True)
class EvaluationInstance:
    """One evaluation run's metadata (EvaluationInstances.scala:35-60)."""
    id: str
    status: str  # INIT | EVALCOMPLETED | EVALFAILED
    start_time: _dt.datetime
    end_time: Optional[_dt.datetime]
    evaluation_class: str = ""
    engine_params_generator_class: str = ""
    batch: str = ""
    env: dict[str, str] = field(default_factory=dict)
    evaluator_results: str = ""
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""


@dataclass(frozen=True)
class Model:
    """Opaque serialized model blob (Models.scala:33)."""
    id: str
    models: bytes


# ---------------------------------------------------------------------------
# Meta-data DAO contracts
# ---------------------------------------------------------------------------

class AppsStore(abc.ABC):
    """(Apps.scala:40-75)"""

    @abc.abstractmethod
    def insert(self, app: App) -> Optional[int]:
        """Insert; id 0 means auto-assign. Returns the assigned id."""

    @abc.abstractmethod
    def get(self, app_id: int) -> Optional[App]: ...

    @abc.abstractmethod
    def get_by_name(self, name: str) -> Optional[App]: ...

    @abc.abstractmethod
    def get_all(self) -> list[App]: ...

    @abc.abstractmethod
    def update(self, app: App) -> bool: ...

    @abc.abstractmethod
    def delete(self, app_id: int) -> bool: ...


class AccessKeysStore(abc.ABC):
    """(AccessKeys.scala:42-77)"""

    @abc.abstractmethod
    def insert(self, access_key: AccessKey) -> Optional[str]:
        """Insert; empty key → auto-generate. Returns the key."""

    @abc.abstractmethod
    def get(self, key: str) -> Optional[AccessKey]: ...

    @abc.abstractmethod
    def get_all(self) -> list[AccessKey]: ...

    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> list[AccessKey]: ...

    @abc.abstractmethod
    def update(self, access_key: AccessKey) -> bool: ...

    @abc.abstractmethod
    def delete(self, key: str) -> bool: ...

    @staticmethod
    def generate_key() -> str:
        """64 url-safe chars (reference: Random.alphanumeric, AccessKeys.scala:55)."""
        return secrets.token_urlsafe(48)[:64]


class ChannelsStore(abc.ABC):
    """(Channels.scala:47-80)"""

    @abc.abstractmethod
    def insert(self, channel: Channel) -> Optional[int]: ...

    @abc.abstractmethod
    def get(self, channel_id: int) -> Optional[Channel]: ...

    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> list[Channel]: ...

    @abc.abstractmethod
    def delete(self, channel_id: int) -> bool: ...


class EngineInstancesStore(abc.ABC):
    """(EngineInstances.scala:55-95)"""

    @abc.abstractmethod
    def insert(self, instance: EngineInstance) -> str:
        """Insert; empty id → auto-generate. Returns the id."""

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EngineInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> list[EngineInstance]: ...

    @abc.abstractmethod
    def update(self, instance: EngineInstance) -> bool: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...

    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> Optional[EngineInstance]:
        """Most recent COMPLETED instance for the (id, version, variant) triple
        (EngineInstances.scala:82)."""
        cands = [
            i
            for i in self.get_all()
            if i.status == "COMPLETED"
            and i.engine_id == engine_id
            and i.engine_version == engine_version
            and i.engine_variant == engine_variant
        ]
        return max(cands, key=lambda i: i.start_time, default=None)


class EvaluationInstancesStore(abc.ABC):
    """(EvaluationInstances.scala:65-100)"""

    @abc.abstractmethod
    def insert(self, instance: EvaluationInstance) -> str:
        """Insert; empty id → auto-generate. Returns the id."""

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> list[EvaluationInstance]: ...

    @abc.abstractmethod
    def update(self, instance: EvaluationInstance) -> bool: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...

    def get_completed(self) -> list[EvaluationInstance]:
        """EVALCOMPLETED instances, newest first."""
        out = [i for i in self.get_all() if i.status == "EVALCOMPLETED"]
        out.sort(key=lambda i: i.start_time, reverse=True)
        return out


class ModelsStore(abc.ABC):
    """(Models.scala:43-60)"""

    @abc.abstractmethod
    def insert(self, model: Model) -> None: ...

    @abc.abstractmethod
    def get(self, model_id: str) -> Optional[Model]: ...

    @abc.abstractmethod
    def delete(self, model_id: str) -> bool: ...


# ---------------------------------------------------------------------------
# Backend client
# ---------------------------------------------------------------------------

class StorageClient(abc.ABC):
    """One configured backend instance; provides whichever DAOs it supports
    and raises :class:`NotImplementedError` for the rest."""

    def __init__(self, config: dict[str, str]):
        self.config = config

    def apps(self) -> AppsStore:
        raise NotImplementedError(f"{type(self).__name__} does not serve METADATA")

    def access_keys(self) -> AccessKeysStore:
        raise NotImplementedError(f"{type(self).__name__} does not serve METADATA")

    def channels(self) -> ChannelsStore:
        raise NotImplementedError(f"{type(self).__name__} does not serve METADATA")

    def engine_instances(self) -> EngineInstancesStore:
        raise NotImplementedError(f"{type(self).__name__} does not serve METADATA")

    def evaluation_instances(self) -> EvaluationInstancesStore:
        raise NotImplementedError(f"{type(self).__name__} does not serve METADATA")

    def events(self) -> EventStore:
        raise NotImplementedError(f"{type(self).__name__} does not serve EVENTDATA")

    def models(self) -> ModelsStore:
        raise NotImplementedError(f"{type(self).__name__} does not serve MODELDATA")

    def close(self) -> None:
        pass
