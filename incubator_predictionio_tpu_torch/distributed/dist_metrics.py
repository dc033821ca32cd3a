"""``pio_dist_*`` series of the fault-tolerant training tier.

Counterpart of ``incubator_predictionio_tpu/distributed/dist_metrics.py``:
the same five names and help texts, as plain thread-safe counters
(``.inc()``) and gauges (``.set()``), in the idiom of
``streaming/stream_metrics.py``. The metrics registry and ``/metrics``
exposition come with the tooling slice (ROADMAP.md Queue 1, item 6).
"""

from __future__ import annotations

import threading

from incubator_predictionio_tpu_torch.streaming.stream_metrics import Counter


class Gauge:
    """A named value that is set, not accumulated."""

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)


DIST_MEMBERS = Gauge(
    "pio_dist_members",
    "Live members of the current training mesh generation (supervisor / "
    "heartbeat view; drops below the expected count while a loss is being "
    "recovered)")
DIST_GENERATION = Gauge(
    "pio_dist_generation",
    "Current mesh generation — the monotonic fencing token; every bump is "
    "one mesh re-formation after a member loss")
DIST_STEP_ABORTS = Counter(
    "pio_dist_step_aborts_total",
    "Training steps aborted because a member was lost mid-collective "
    "(heartbeat lease expired or the collective itself failed)")
DIST_FENCED = Counter(
    "pio_dist_fenced_total",
    "Actions refused because the actor's generation was stale — a zombie "
    "from a torn-down mesh tried to commit a checkpoint or join a collective")
DIST_COMMITS = Counter(
    "pio_dist_checkpoint_commits_total",
    "Coordinated checkpoint commits (marker written only after every "
    "member's slice is durable)")
