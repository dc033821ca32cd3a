"""Streaming-pipeline counters.

Counterpart of ``incubator_predictionio_tpu/streaming/stream_metrics.py``,
cut to the updater's four counters as plain thread-safe integers with
``.inc()``. The metrics registry and ``/metrics`` exposition come with the
tooling slice (ROADMAP.md Queue 1 item 6).
"""

from __future__ import annotations

import threading


class Counter:
    """A named monotonic counter."""

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


#: Updater side: events folded into deltas (post-dedup, post-dead-letter).
FOLDED = Counter(
    "pio_stream_folded_total",
    "Events folded into embedding-row deltas by the streaming updater")

#: Updater side: micro-batches stepped through the fused adam path
#: (ops/sparse_update.py) instead of the per-row reference loop.
FUSED_STEPS = Counter(
    "pio_stream_fused_steps_total",
    "Touched-row micro-batches updated through the fused "
    "gather→adam→scatter path (PIO_STREAM_FUSED)")

#: Updater side: poison events diverted to the stream's dead-letter file.
DEAD_LETTER = Counter(
    "pio_stream_dead_letter_total",
    "Events the incremental fold rejected non-transiently, dead-lettered "
    "to the stream state dir instead of wedging the updater loop")

#: Updater side: guard trips that quarantined the stream.
QUARANTINED = Counter(
    "pio_stream_quarantined_total",
    "Divergence-guard trips: the stream is quarantined and a full retrain "
    "is required before incremental updates resume")
