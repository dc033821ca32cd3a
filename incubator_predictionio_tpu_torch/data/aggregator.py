"""Property aggregation: fold ``$set``/``$unset``/``$delete`` events into
per-entity snapshots.

Counterpart of ``incubator_predictionio_tpu/data/aggregator.py`` (:27-80,
``AGGREGATOR_EVENT_NAMES`` and ``aggregate_properties``): events are sorted
by event time per entity and folded left; ``$set`` merges properties
(right-biased), ``$unset`` removes keys, ``$delete`` drops the snapshot
(its first/last update times survive); other events are ignored. Entities
whose final snapshot is deleted are absent from the result.
"""

from __future__ import annotations

import datetime as _dt
from collections.abc import Iterable
from typing import Optional

from incubator_predictionio_tpu_torch.data.event import Event, PropertyMap

#: Event names that control aggregation (LEventAggregator.scala:93).
AGGREGATOR_EVENT_NAMES = ("$set", "$unset", "$delete")


class _Prop:
    __slots__ = ("fields", "defined", "first_updated", "last_updated")

    def __init__(self) -> None:
        self.fields: dict = {}
        self.defined = False
        self.first_updated: Optional[_dt.datetime] = None
        self.last_updated: Optional[_dt.datetime] = None

    def apply(self, e: Event) -> None:
        if e.event == "$set":
            if not self.defined:
                self.fields = e.properties.to_dict()
                self.defined = True
            else:
                self.fields.update(e.properties.to_dict())
        elif e.event == "$unset":
            if self.defined:
                for k in e.properties:
                    self.fields.pop(k, None)
        elif e.event == "$delete":
            self.fields = {}
            self.defined = False
        else:
            return  # non-special events do not touch aggregation state
        t = e.event_time
        self.first_updated = t if self.first_updated is None else min(self.first_updated, t)
        self.last_updated = t if self.last_updated is None else max(self.last_updated, t)

    def to_property_map(self) -> Optional[PropertyMap]:
        if not self.defined:
            return None
        return PropertyMap(self.fields, self.first_updated, self.last_updated)


def aggregate_properties(events: Iterable[Event]) -> dict[str, PropertyMap]:
    """Aggregate properties grouped by entity id (LEventAggregator.scala:42-61)."""
    by_entity: dict[str, list[Event]] = {}
    for e in events:
        by_entity.setdefault(e.entity_id, []).append(e)
    out: dict[str, PropertyMap] = {}
    for entity_id, evs in by_entity.items():
        evs.sort(key=lambda e: e.event_time)
        prop = _Prop()
        for e in evs:
            prop.apply(e)
        pm = prop.to_property_map()
        if pm is not None:
            out[entity_id] = pm
    return out
