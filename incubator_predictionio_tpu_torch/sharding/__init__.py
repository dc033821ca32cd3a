"""Sharded embedding tables: serving (ROADMAP.md Queue 1, item 4.4) and
model-axis training (item 4.5).

Counterpart of ``incubator_predictionio_tpu/sharding/``:

- :mod:`table <incubator_predictionio_tpu_torch.sharding.table>` — the
  :class:`~incubator_predictionio_tpu_torch.sharding.table.ShardSpec`
  row layout and the simulated per-card HBM budget
  (``PIO_SHARD_HBM_BUDGET``);
- :mod:`serve <incubator_predictionio_tpu_torch.sharding.serve>` — serving
  from per-shard row blocks, one shard a local card in one process:
  per-shard exact top-k and a merge on the first card, per-shard IVF
  (kernel K2 on each shard's card), deltas routed to the owning shard;
- :mod:`degrade <incubator_predictionio_tpu_torch.sharding.degrade>` — the
  once-per-key axis-degradation registry;
- :mod:`shard_metrics <incubator_predictionio_tpu_torch.sharding.shard_metrics>`
  — the ``pio_shard_*`` counters and histograms.

``ShardedTable.init_train`` builds the row block a process owns on a
``model`` mesh axis (model-axis training, ``models/two_tower.py``).
"""

from incubator_predictionio_tpu_torch.sharding.table import (
    HBMBudgetExceeded,
    ShardSpec,
    ShardedTable,
    hbm_budget,
    parse_bytes,
    requires_sharding,
)

__all__ = [
    "HBMBudgetExceeded",
    "ShardSpec",
    "ShardedTable",
    "hbm_budget",
    "parse_bytes",
    "requires_sharding",
]
