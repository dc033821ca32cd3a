"""Developer-facing event stores — what engine templates call.

Counterpart of ``incubator_predictionio_tpu/data/store.py``:
:class:`LEventStore`, the serving-time reads (:44-122: ``find_by_entity``,
``find_by_entities``, ``find``), and :class:`PEventStore`'s bulk reads for
training (``find``, ``assemble_triples``; reference
PEventStore.scala:35-121). Sharded reads and property snapshots of
``PEventStore`` come with the sharding slice (ROADMAP.md Queue 1, item 4).
"""

from __future__ import annotations

import datetime as _dt
from typing import Any, Iterator, Optional, Sequence

from incubator_predictionio_tpu_torch.data.event import Event
from incubator_predictionio_tpu_torch.data.storage.base import UNSET
from incubator_predictionio_tpu_torch.data.storage.registry import (
    Storage,
    get_storage,
)


class _BaseStore:
    def __init__(self, storage: Optional[Storage] = None):
        self._storage = storage

    @property
    def storage(self) -> Storage:
        return self._storage if self._storage is not None else get_storage()

    def _resolve(self, app_name: str, channel_name: Optional[str]) -> tuple[int, Optional[int]]:
        """app name (+ optional channel name) → ids (LEventStore.scala:48-68)."""
        app = self.storage.get_meta_data_apps().get_by_name(app_name)
        if app is None:
            raise ValueError(f"Invalid app name {app_name}")
        if channel_name is None:
            return app.id, None
        channels = self.storage.get_meta_data_channels().get_by_app_id(app.id)
        for c in channels:
            if c.name == channel_name:
                return app.id, c.id
        raise ValueError(f"Invalid channel name {channel_name} for app {app_name}")


class LEventStore(_BaseStore):
    """Low-latency single-entity reads for serving-time business rules."""

    def find_by_entity(
        self,
        app_name: str,
        entity_type: str,
        entity_id: str,
        channel_name: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Any = UNSET,
        target_entity_id: Any = UNSET,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        limit: Optional[int] = None,
        latest: bool = True,
    ) -> Iterator[Event]:
        """(LEventStore.scala:74-118): newest first when ``latest``."""
        app_id, channel_id = self._resolve(app_name, channel_name)
        return self.storage.get_events().find(
            app_id, channel_id, start_time, until_time, entity_type,
            entity_id, event_names, target_entity_type, target_entity_id,
            limit, reversed=latest,
        )

    def find_by_entities(
        self,
        app_name: str,
        entity_type: str,
        entity_ids: Sequence[str],
        channel_name: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Any = UNSET,
        target_entity_id: Any = UNSET,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        limit_per_entity: Optional[int] = None,
        latest: bool = True,
    ) -> dict[str, list[Event]]:
        """Batched :meth:`find_by_entity`: many entities' histories in one
        storage round trip, each ordered and capped as the single read
        (:meth:`EventStore.find_by_entities
        <incubator_predictionio_tpu_torch.data.storage.base.EventStore.find_by_entities>`)."""
        app_id, channel_id = self._resolve(app_name, channel_name)
        return self.storage.get_events().find_by_entities(
            app_id, entity_type, entity_ids, channel_id, start_time,
            until_time, event_names, target_entity_type, target_entity_id,
            limit_per_entity, reversed=latest,
        )

    def find(
        self,
        app_name: str,
        channel_name: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Any = UNSET,
        target_entity_id: Any = UNSET,
        limit: Optional[int] = None,
    ) -> Iterator[Event]:
        """(LEventStore.scala:120-145)"""
        app_id, channel_id = self._resolve(app_name, channel_name)
        return self.storage.get_events().find(
            app_id, channel_id, start_time, until_time, entity_type, entity_id,
            event_names, target_entity_type, target_entity_id, limit,
        )


class PEventStore(_BaseStore):
    """Bulk reads for training: full scans and columnar triples."""

    def find(
        self,
        app_name: str,
        channel_name: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Any = UNSET,
        target_entity_id: Any = UNSET,
    ) -> Iterator[Event]:
        """(PEventStore.scala:41-76)"""
        app_id, channel_id = self._resolve(app_name, channel_name)
        return self.storage.get_events().find(
            app_id, channel_id, start_time, until_time, entity_type, entity_id,
            event_names, target_entity_type, target_entity_id,
        )

    def assemble_triples(
        self,
        app_name: str,
        channel_name: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Any = UNSET,
        value_property: Optional[str] = None,
        default_values: Optional[dict] = None,
        missing_value: float = 0.0,
        dedup: bool = False,
    ):
        """Columnar (entity, target, value) triples — the bulk training read;
        see :meth:`EventStore.assemble_triples
        <incubator_predictionio_tpu_torch.data.storage.base.EventStore.assemble_triples>`."""
        app_id, channel_id = self._resolve(app_name, channel_name)
        return self.storage.get_events().assemble_triples(
            app_id, channel_id, start_time, until_time, entity_type,
            event_names, target_entity_type, value_property, default_values,
            missing_value, dedup,
        )
