"""``pio_shard_*`` series of sharded serving.

Counterpart of ``incubator_predictionio_tpu/sharding/shard_metrics.py``:
the same seven names and help texts, as plain thread-safe counters
(``.inc()``) and histograms (``.observe()``), in the idiom of
``streaming/stream_metrics.py``. The metrics registry and ``/metrics``
exposition come with the tooling slice (ROADMAP.md Queue 1, item 6).
"""

from __future__ import annotations

import bisect
import threading

from incubator_predictionio_tpu_torch.streaming.stream_metrics import Counter

#: the reference registry's default latency buckets (seconds)
DEFAULT_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class Histogram:
    """A named distribution: per-bucket counts (upper bounds, +Inf last),
    the observation count and their sum."""

    def __init__(self, name: str, help_text: str,
                 buckets=DEFAULT_LATENCY_BUCKETS):
        self.name = name
        self.help = help_text
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += float(value)


SHARD_BATCHES = Counter(
    "pio_shard_batches_total",
    "Query batches served through the sharded per-shard-top-k + merge path")
SHARD_FALLBACKS = Counter(
    "pio_shard_fallback_total",
    "Sharded-IVF batches that fell back to the sharded-exact path (a "
    "shard's probe under-covered the requested top-k or the rule filters)")
FULL_GATHERS = Counter(
    "pio_shard_full_gather_total",
    "Full-table device→host gathers (the transfer sharded serving exists "
    "to avoid — stays 0 on the sharded deploy/serve path)")
DELTA_ROUTED = Counter(
    "pio_shard_delta_rows_total",
    "Streaming delta rows routed to their owning shard")
TOPK_SEC = Histogram(
    "pio_shard_topk_seconds",
    "Per-shard scoring + local top-k time per batch (all shards)")
MERGE_SEC = Histogram(
    "pio_shard_merge_seconds",
    "Cross-shard merge time per batch")
MERGE_FANIN = Histogram(
    "pio_shard_merge_fanin",
    "Candidates entering the cross-shard merge per query "
    "(n_shards × per-shard k)",
    buckets=(8, 32, 128, 512, 2048, 8192, 32768))

#: every series above, for callers that snapshot them all
ALL = (SHARD_BATCHES, SHARD_FALLBACKS, FULL_GATHERS, DELTA_ROUTED,
       TOPK_SEC, MERGE_SEC, MERGE_FANIN)
