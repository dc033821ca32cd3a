"""``pio import``: a JSON-lines file of events → the event store.

Counterpart of ``incubator_predictionio_tpu/tools/export_import.py``
``import_events`` (reference tools/imprt/FileToEvents.scala:36-112); the
export comes with the rest of the tools (ROADMAP.md Queue 1, item 7).
"""

from __future__ import annotations

import logging
from typing import Optional

from incubator_predictionio_tpu_torch.data.event import Event, validate_event
from incubator_predictionio_tpu_torch.data.storage.registry import (
    Storage,
    get_storage,
)

logger = logging.getLogger(__name__)


def import_events(
    app_id: int,
    input_path: str,
    channel_id: Optional[int] = None,
    storage: Optional[Storage] = None,
    batch_size: int = 1000,
) -> int:
    """Validate and insert every event of ``input_path`` (one JSON object a
    line, blank lines skipped) in batches of ``batch_size``; returns the
    count."""
    storage = storage or get_storage()
    events_store = storage.get_events()
    events_store.init(app_id, channel_id)
    n = 0
    batch: list[Event] = []
    with open(input_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            event = validate_event(Event.from_json(line))
            batch.append(event)
            if len(batch) >= batch_size:
                events_store.insert_batch(batch, app_id, channel_id)
                n += len(batch)
                batch = []
    if batch:
        events_store.insert_batch(batch, app_id, channel_id)
        n += len(batch)
    logger.info("imported %d events into app %s", n, app_id)
    return n
