"""In-memory storage backend.

Counterpart of ``incubator_predictionio_tpu/data/storage/memory.py``, cut to
the event store (``MemEvents``, :40-139), the engine-instance and model
repositories (``MemEngineInstances``, ``MemModels``) that deploy reads, and
the evaluation instances (``MemEvaluationInstances``, :270-299) that
``pio eval`` writes.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import threading
import uuid
from typing import Any, Optional, Sequence

from incubator_predictionio_tpu_torch.data.event import Event
from incubator_predictionio_tpu_torch.data.storage.base import (
    UNSET,
    EngineInstance,
    EngineInstancesStore,
    EvaluationInstance,
    EvaluationInstancesStore,
    EventStore,
    Model,
    ModelsStore,
    StorageClient,
    StorageError,
    filter_events,
)


class MemEvents(EventStore):
    def __init__(self) -> None:
        self._lock = threading.RLock()
        # (app_id, channel_id) -> {event_id: Event}
        self._tables: dict[tuple[int, Optional[int]], dict[str, Event]] = {}

    def _table(self, app_id: int, channel_id: Optional[int]) -> dict[str, Event]:
        t = self._tables.get((app_id, channel_id))
        if t is None:
            raise StorageError(
                f"event table for app {app_id} channel {channel_id} not initialized"
            )
        return t

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self._lock:
            self._tables.setdefault((app_id, channel_id), {})
        return True

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self._lock:
            return self._tables.pop((app_id, channel_id), None) is not None

    def insert(self, event: Event, app_id: int, channel_id: Optional[int] = None) -> str:
        event_id = event.event_id or uuid.uuid4().hex
        with self._lock:
            self._tables.setdefault((app_id, channel_id), {})[event_id] = event.with_id(event_id)
        return event_id

    def get(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> Optional[Event]:
        with self._lock:
            return self._tables.get((app_id, channel_id), {}).get(event_id)

    def delete(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self._lock:
            return self._tables.get((app_id, channel_id), {}).pop(event_id, None) is not None

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
        with self._lock:
            events = list(self._table(app_id, channel_id).values())
        # filter before the (stable) sort: an entity's handful of events
        # never pays a sort of the whole table
        matched = list(filter_events(
            events, start_time, until_time, entity_type, entity_id,
            event_names, target_entity_type, target_entity_id,
        ))
        matched.sort(key=lambda e: e.event_time, reverse=reversed)
        if limit is not None and limit >= 0:
            return iter(matched[:limit])
        return iter(matched)

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
        """One scan for the whole entity batch, in :meth:`find`'s stable
        time order, so each entity's list matches the per-entity read."""
        wanted = set(entity_ids)
        with self._lock:
            events = list(self._table(app_id, channel_id).values())
        matched = [
            e for e in filter_events(
                events, start_time, until_time, entity_type, None,
                event_names, target_entity_type, target_entity_id,
            )
            if e.entity_id in wanted
        ]
        matched.sort(key=lambda e: e.event_time, reverse=reversed)
        return self.group_events_by_entity(matched, list(entity_ids),
                                           limit_per_entity)


class MemEngineInstances(EngineInstancesStore):
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._instances: dict[str, EngineInstance] = {}

    def insert(self, instance: EngineInstance) -> str:
        instance_id = instance.id or uuid.uuid4().hex
        with self._lock:
            self._instances[instance_id] = dataclasses.replace(
                instance, id=instance_id)
        return instance_id

    def get(self, instance_id: str) -> Optional[EngineInstance]:
        return self._instances.get(instance_id)

    def get_all(self) -> list[EngineInstance]:
        return list(self._instances.values())

    def update(self, instance: EngineInstance) -> bool:
        with self._lock:
            if instance.id not in self._instances:
                return False
            self._instances[instance.id] = instance
            return True

    def delete(self, instance_id: str) -> bool:
        with self._lock:
            return self._instances.pop(instance_id, None) is not None


class MemEvaluationInstances(EvaluationInstancesStore):
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._instances: dict[str, EvaluationInstance] = {}

    def insert(self, instance: EvaluationInstance) -> str:
        instance_id = instance.id or uuid.uuid4().hex
        with self._lock:
            self._instances[instance_id] = dataclasses.replace(
                instance, id=instance_id)
        return instance_id

    def get(self, instance_id: str) -> Optional[EvaluationInstance]:
        return self._instances.get(instance_id)

    def get_all(self) -> list[EvaluationInstance]:
        return list(self._instances.values())

    def update(self, instance: EvaluationInstance) -> bool:
        with self._lock:
            if instance.id not in self._instances:
                return False
            self._instances[instance.id] = instance
            return True

    def delete(self, instance_id: str) -> bool:
        with self._lock:
            return self._instances.pop(instance_id, None) is not None


class MemModels(ModelsStore):
    def __init__(self) -> None:
        self._models: dict[str, Model] = {}

    def insert(self, model: Model) -> None:
        self._models[model.id] = model

    def get(self, model_id: str) -> Optional[Model]:
        return self._models.get(model_id)

    def delete(self, model_id: str) -> bool:
        return self._models.pop(model_id, None) is not None


class MemoryStorageClient(StorageClient):
    """Serves the engine and evaluation instances, the events and the
    models from process memory."""

    def __init__(self, config: dict[str, str]):
        super().__init__(config)
        self._engine_instances = MemEngineInstances()
        self._evaluation_instances = MemEvaluationInstances()
        self._events = MemEvents()
        self._models = MemModels()

    def events(self) -> EventStore:
        return self._events

    def engine_instances(self) -> EngineInstancesStore:
        return self._engine_instances

    def evaluation_instances(self) -> EvaluationInstancesStore:
        return self._evaluation_instances

    def models(self) -> ModelsStore:
        return self._models
