"""``pio_dist_*`` metrics for the fault-tolerant multi-process training tier.

Counterpart of ``incubator_predictionio_tpu/distributed/dist_metrics.py``:
the same five families on the process-wide registry."""

from __future__ import annotations

from incubator_predictionio_tpu_torch.obs.metrics import REGISTRY

DIST_MEMBERS = REGISTRY.gauge(
    "pio_dist_members",
    "Live members of the current training mesh generation (supervisor / "
    "heartbeat view; drops below the expected count while a loss is being "
    "recovered)")
DIST_GENERATION = REGISTRY.gauge(
    "pio_dist_generation",
    "Current mesh generation — the monotonic fencing token; every bump is "
    "one mesh re-formation after a member loss")
DIST_STEP_ABORTS = REGISTRY.counter(
    "pio_dist_step_aborts_total",
    "Training steps aborted because a member was lost mid-collective "
    "(heartbeat lease expired or the collective itself failed)")
DIST_FENCED = REGISTRY.counter(
    "pio_dist_fenced_total",
    "Actions refused because the actor's generation was stale — a zombie "
    "from a torn-down mesh tried to commit a checkpoint or join a collective")
DIST_COMMITS = REGISTRY.counter(
    "pio_dist_checkpoint_commits_total",
    "Coordinated checkpoint commits (marker written only after every "
    "member's slice is durable)")
