"""Graceful-drain plumbing shared by the three servers (docs/resilience.md).

Counterpart of ``incubator_predictionio_tpu/server/lifecycle.py``, whole
(:class:`DrainState`, :func:`install_signal_drain`, :func:`wait_for`,
:func:`drained_exit_deadline`). The port's query server is its only user
so far; the event and storage servers come with ROADMAP.md item 7.

SIGTERM on any server must mean "stop taking new work, finish what you
have, flush durable state, exit within a deadline" — never "drop in-flight
requests on the floor". The pieces every server shares live here:

- :class:`DrainState` — the draining flag plus its observable surface
  (``pio_server_draining`` gauge per server, the 503 + ``Retry-After``
  response new work receives, the ``/health`` status flip);
- :func:`install_signal_drain` — SIGTERM/SIGINT → one-shot asyncio event
  on the server's loop (second signal forces immediate exit, the standard
  escalation contract so a wedged drain can't make the process unkillable).

Each server owns its *drain semantics* (what "finish what you have" means:
the event server flushes the spill WAL, the query server waits out the
micro-batcher, the storage server just stops accepting); this module only
standardizes the shell around them.
"""

from __future__ import annotations

import asyncio
import logging
import signal
from typing import Optional

from aiohttp import web

from incubator_predictionio_tpu_torch.obs.metrics import REGISTRY

logger = logging.getLogger(__name__)

_DRAINING = REGISTRY.gauge(
    "pio_server_draining",
    "1 while the server is draining (rejecting new work ahead of a "
    "graceful exit), 0 otherwise", labels=("server",))


class DrainState:
    """One server's draining flag + the shared rejection/health surface."""

    def __init__(self, server_name: str, retry_after_sec: int = 5):
        self.server_name = server_name
        self.retry_after_sec = retry_after_sec
        self._draining = False
        _DRAINING.labels(server=server_name).set(0)

    @property
    def draining(self) -> bool:
        return self._draining

    def begin(self) -> None:
        if not self._draining:
            self._draining = True
            _DRAINING.labels(server=self.server_name).set(1)
            logger.info("%s: draining — new work answers 503",
                        self.server_name)

    def reject_response(self) -> web.Response:
        """The 503 new work gets while draining. ``Retry-After`` points
        clients at the replacement process a rolling restart brings up."""
        return web.json_response(
            {"message": f"{self.server_name} is draining"}, status=503,
            headers={"Retry-After": str(self.retry_after_sec)})

    def health_status(self, degraded: bool) -> str:
        """``/health`` status string: draining wins over degraded/ok so
        load balancers pull the instance before its listener goes away."""
        if self._draining:
            return "draining"
        return "degraded" if degraded else "ok"


def install_signal_drain(loop: asyncio.AbstractEventLoop,
                         stop_event: asyncio.Event,
                         server_name: str) -> None:
    """SIGTERM/SIGINT set ``stop_event`` (the serve_forever loop then runs
    the server's drain); a second signal exits immediately — a drain stuck
    on a dead backend must never make the process unkillable."""
    fired = {"n": 0}

    def on_signal(signum: int) -> None:
        fired["n"] += 1
        if fired["n"] > 1:
            logger.warning("%s: second signal (%s) — exiting immediately",
                           server_name, signal.Signals(signum).name)
            raise SystemExit(1)
        logger.info("%s: received %s — beginning graceful drain",
                    server_name, signal.Signals(signum).name)
        stop_event.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, on_signal, sig)
        except (NotImplementedError, RuntimeError):  # pragma: no cover
            # non-main thread / platforms without loop signal support:
            # fall back to the default handler (immediate exit)
            pass


async def wait_for(predicate, deadline_sec: float,
                   poll_sec: float = 0.02) -> bool:
    """Poll ``predicate()`` until true or the deadline passes. The drain
    loops use this for 'in-flight work finished' conditions that have no
    native awaitable."""
    import time

    deadline = time.monotonic() + deadline_sec
    while time.monotonic() < deadline:
        if predicate():
            return True
        await asyncio.sleep(poll_sec)
    return bool(predicate())


def drained_exit_deadline(default: float = 20.0) -> float:
    """`PIO_DRAIN_DEADLINE` (seconds) — the cap every server's drain honors
    before force-exiting (systemd's TimeoutStopSec counterpart)."""
    import os

    try:
        return float(os.environ.get("PIO_DRAIN_DEADLINE", default))
    except ValueError:
        return default


__all__ = ["DrainState", "install_signal_drain", "wait_for",
           "drained_exit_deadline"]
