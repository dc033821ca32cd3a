"""The workflow's seam for fault-tolerant multi-process training.

Counterpart of ``incubator_predictionio_tpu/distributed/context.py``
(``maybe_wrap_distributed``, :79). The reference wraps the context in a
member of a supervised mesh (heartbeat leases, generations, member-slice
checkpoints) when ``PIO_DIST_STATE_DIR`` names a coordination directory,
and returns it untouched otherwise. The port has the untouched path; the
supervised mesh comes with ROADMAP.md Queue 1, item 4, so a set
``PIO_DIST_STATE_DIR`` raises rather than running unsupervised.
"""

from __future__ import annotations

import os


def maybe_wrap_distributed(ctx):
    """``ctx`` itself unless ``PIO_DIST_STATE_DIR`` is set, which raises."""
    state_dir = os.environ.get("PIO_DIST_STATE_DIR", "")
    if not state_dir:
        return ctx
    raise NotImplementedError(
        f"PIO_DIST_STATE_DIR={state_dir!r}: the fault-tolerant mesh "
        "(distributed/: heartbeats, generations, member-slice checkpoints) "
        "comes with the sharding slice of the PyTorch port (ROADMAP.md "
        "Queue 1, item 4)")
