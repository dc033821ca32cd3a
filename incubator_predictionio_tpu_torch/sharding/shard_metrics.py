"""``pio_shard_*`` metrics for the sharded embedding subsystem.

Counterpart of ``incubator_predictionio_tpu/sharding/shard_metrics.py``:
the same seven families on the process-wide registry."""

from __future__ import annotations

from incubator_predictionio_tpu_torch.obs.metrics import REGISTRY

SHARD_BATCHES = REGISTRY.counter(
    "pio_shard_batches_total",
    "Query batches served through the sharded per-shard-top-k + merge path")
SHARD_FALLBACKS = REGISTRY.counter(
    "pio_shard_fallback_total",
    "Sharded-IVF batches that fell back to the sharded-exact path (a "
    "shard's probe under-covered the requested top-k or the rule filters)")
FULL_GATHERS = REGISTRY.counter(
    "pio_shard_full_gather_total",
    "Full-table device→host gathers (the transfer sharded serving exists "
    "to avoid — stays 0 on the sharded deploy/serve path)")
DELTA_ROUTED = REGISTRY.counter(
    "pio_shard_delta_rows_total",
    "Streaming delta rows routed to their owning shard")
TOPK_SEC = REGISTRY.histogram(
    "pio_shard_topk_seconds",
    "Per-shard scoring + local top-k time per batch (all shards)")
MERGE_SEC = REGISTRY.histogram(
    "pio_shard_merge_seconds",
    "Cross-shard merge time per batch")
MERGE_FANIN = REGISTRY.histogram(
    "pio_shard_merge_fanin",
    "Candidates entering the cross-shard merge per query "
    "(n_shards × per-shard k)",
    buckets=(8, 32, 128, 512, 2048, 8192, 32768))
