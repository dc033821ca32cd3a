"""Streaming incremental updates.

Counterpart of ``incubator_predictionio_tpu/streaming``: a crash-safe,
exactly-once delta pipeline from the event log into live serving — tail
the PIOLOG01 change feed, fold events into per-row embedding deltas
(gather → adam on kernel K3 → scatter, on just the touched rows), ship
each delta to the serving replicas' ``POST /delta``, with a divergence
guard that quarantines the stream when incremental state drifts.
"""

from incubator_predictionio_tpu_torch.streaming.coldstart import (  # noqa: F401
    ColdStartBuckets,
    coldstart_mode,
)
from incubator_predictionio_tpu_torch.streaming.delta import (  # noqa: F401
    ModelDelta,
    decode_delta,
    encode_delta,
    load_delta,
    save_delta,
)
from incubator_predictionio_tpu_torch.streaming.feed import (  # noqa: F401
    EventLogFeed,
    FeedBatch,
    read_cursor,
    write_cursor,
)
from incubator_predictionio_tpu_torch.streaming.guard import (  # noqa: F401
    DivergenceGuard,
    GuardConfig,
    compare_to_reference,
)
from incubator_predictionio_tpu_torch.streaming.trainer import (  # noqa: F401
    DeltaTrainer,
    PoisonEvent,
)
from incubator_predictionio_tpu_torch.streaming.updater import (  # noqa: F401
    HttpTransport,
    StreamUpdater,
    UpdaterConfig,
)
