"""Streaming-pipeline telemetry.

Counterpart of ``incubator_predictionio_tpu/streaming/stream_metrics.py``:
the same families on the process-wide registry. One module so the updater
process and the serving replicas register the same family names:
whichever process does the work increments its own counter, and
``metrics <url>`` reads each process's slice.
"""

from __future__ import annotations

from incubator_predictionio_tpu_torch.obs.metrics import REGISTRY

#: Replica side: deltas applied to the live model (each is one atomic
#: hot-swap through the smoke-gate + probation path).
APPLIED = REGISTRY.counter(
    "pio_stream_applied_total",
    "Streaming deltas applied to the serving model (exactly-once: an "
    "already-applied [from_seq, to_seq) range lands on the deduped counter "
    "instead; docs/streaming.md)")

#: Replica side: deltas rejected as already-applied (the exactly-once
#: dedup — a crashed updater re-ships its last batch and this counts it).
DEDUPED = REGISTRY.counter(
    "pio_stream_deduped_total",
    "Streaming deltas acknowledged as duplicates (their event range was "
    "already applied — the crash-replay dedup working as designed)")

#: Updater side: poison events diverted to the stream's dead-letter file
#: (same frame format as the WAL dead-letter segment) instead of wedging
#: the fold loop.
DEAD_LETTER = REGISTRY.counter(
    "pio_stream_dead_letter_total",
    "Events the incremental fold rejected non-transiently, dead-lettered "
    "to the stream state dir instead of wedging the updater loop")

#: Replica side: now − max event_time applied to the serving model. The
#: freshness SLO gauge — the fleet balancer and ``pio-tpu health`` read it
#: off /health.deployment.streaming.
STALENESS = REGISTRY.gauge(
    "pio_model_staleness_seconds",
    "Age of the newest event reflected in the serving model (now − max "
    "applied event time); 0 until a streaming delta has been applied")

#: Updater side: events folded into deltas (post-dedup, post-dead-letter).
FOLDED = REGISTRY.counter(
    "pio_stream_folded_total",
    "Events folded into embedding-row deltas by the streaming updater")

#: Updater side: micro-batches stepped through the fused
#: gather→adam→scatter path (ops/sparse_update.py) instead of the
#: three-pass per-row reference loop.
FUSED_STEPS = REGISTRY.counter(
    "pio_stream_fused_steps_total",
    "Touched-row micro-batches updated through the fused "
    "gather→adam→scatter path (PIO_STREAM_FUSED; bitwise-identical "
    "to the per-row reference loop)")

#: Updater side: guard trips that quarantined the stream.
QUARANTINED = REGISTRY.counter(
    "pio_stream_quarantined_total",
    "Divergence-guard trips: the stream is quarantined and a full retrain "
    "+ index rebuild is required before incremental updates resume")
