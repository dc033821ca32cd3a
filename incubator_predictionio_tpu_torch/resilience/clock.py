"""Injectable time source.

Counterpart of ``incubator_predictionio_tpu/resilience/clock.py``
(:class:`Clock`, :class:`SystemClock`, :data:`SYSTEM_CLOCK`,
:class:`FakeClock`). Every component that waits (the distributed tier's
collective guard, commit poll, heartbeat and watchdog loops, the
supervisor's poll) takes a :class:`Clock`, so tests script failure and
recovery timelines with no wall-clock sleeps: :class:`FakeClock` advances
virtual time instead of blocking.
"""

from __future__ import annotations

import threading
import time
from typing import Protocol, runtime_checkable


@runtime_checkable
class Clock(Protocol):
    def monotonic(self) -> float: ...

    def sleep(self, seconds: float) -> None: ...


class SystemClock:
    """The real thing (``time.monotonic`` / ``time.sleep``)."""

    def monotonic(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


#: Shared default: the clock is stateless, one instance serves everyone.
SYSTEM_CLOCK = SystemClock()


class FakeClock:
    """Deterministic virtual clock: ``sleep`` advances time instantly.

    ``slept`` records every sleep request, so a test can assert the exact
    sequence of waits without ever blocking.
    """

    def __init__(self, start: float = 0.0):
        self._now = start
        self._lock = threading.Lock()
        self.slept: list[float] = []

    def monotonic(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, seconds: float) -> None:
        with self._lock:
            self.slept.append(seconds)
            if seconds > 0:
                self._now += seconds

    def advance(self, seconds: float) -> None:
        """Move time forward without recording a sleep (time that passes
        outside the code under test)."""
        with self._lock:
            self._now += seconds
