"""Per-backend circuit breaker with half-open probing.

Counterpart of ``incubator_predictionio_tpu/resilience/breaker.py``, whole
(:class:`CircuitBreaker`, :class:`CircuitOpenError`,
:class:`BreakerRegistry`, :data:`BREAKERS`, :func:`publish_breaker_metrics`).

State machine (the classic three states):

- ``closed``    — calls flow; consecutive transient failures are counted.
- ``open``      — ``failure_threshold`` consecutive failures tripped it;
                  every call is rejected instantly (``allow() -> False``)
                  until ``reset_timeout`` has elapsed.
- ``half_open`` — the reset window elapsed; up to ``half_open_max`` probe
                  calls are let through. One success closes the breaker,
                  one failure re-opens it (and restarts the window).

The breaker never raises by itself — callers check :meth:`allow` (the
policy engine in ``policy.py`` does, raising :class:`CircuitOpenError`), so
the class stays usable from sync and async code alike. All transitions are
lock-protected; the clock is injected for deterministic tests.
"""

from __future__ import annotations

import threading
from typing import Optional

from incubator_predictionio_tpu_torch.data.storage.base import StorageError
from incubator_predictionio_tpu_torch.obs.metrics import REGISTRY
from incubator_predictionio_tpu_torch.resilience.clock import SYSTEM_CLOCK, Clock

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

#: numeric encoding for the state gauge (alerts key off > 0)
STATE_VALUES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

_TRANSITIONS = REGISTRY.counter(
    "pio_breaker_transitions_total",
    "Circuit breaker state transitions by breaker name and target state",
    labels=("breaker", "to"))
_STATE = REGISTRY.gauge(
    "pio_breaker_state",
    "Circuit breaker state (0=closed, 1=half_open, 2=open)",
    labels=("breaker",))
_REJECTED = REGISTRY.gauge(
    "pio_breaker_rejected_calls",
    "Calls rejected while the breaker was open",
    labels=("breaker",))


def publish_breaker_metrics(snapshots: dict[str, dict]) -> None:
    """Fold ``{name: breaker.snapshot()}`` into the state/rejected gauges —
    shared by the registry collector below and the servers' collectors for
    their standalone (non-registry) breakers."""
    for name, snap in snapshots.items():
        _STATE.labels(breaker=name).set(STATE_VALUES.get(snap["state"], -1))
        _REJECTED.labels(breaker=name).set(snap["rejectedCalls"])


class CircuitOpenError(StorageError):
    """Call rejected because the backend's breaker is open.

    Subclasses :class:`StorageError` so every existing storage error handler
    treats a tripped breaker like any other backend failure — just a much
    faster one.
    """

    def __init__(self, name: str, retry_after: float):
        super().__init__(
            f"circuit breaker {name!r} is open (retry in {retry_after:.2f}s)")
        self.breaker_name = name
        self.retry_after = retry_after


class CircuitBreaker:
    def __init__(self, name: str, failure_threshold: int = 5,
                 reset_timeout: float = 30.0, half_open_max: int = 1,
                 clock: Clock = SYSTEM_CLOCK):
        if failure_threshold < 1:
            # "0 disables" across the whole config surface: a breaker that
            # can never open is how disabling looks to direct constructors
            # (policy_from_config skips the breaker entirely instead)
            failure_threshold = 2 ** 31
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self.half_open_max = max(1, half_open_max)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self._probes = 0  # probes admitted while half-open
        self.rejected_count = 0
        self.opened_count = 0

    # -- queries ----------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def retry_after(self) -> float:
        """Seconds until the next probe would be admitted (0 when closed or
        already half-open)."""
        with self._lock:
            if self._state != OPEN or self._opened_at is None:
                return 0.0
            return max(0.0, self._opened_at + self.reset_timeout
                       - self._clock.monotonic())

    def allow(self) -> bool:
        """True if a call may proceed now. An ``open -> half_open``
        transition happens here when the reset window has elapsed; in
        half-open, only ``half_open_max`` concurrent probes are admitted."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and self._probes < self.half_open_max:
                self._probes += 1
                return True
            self.rejected_count += 1
            return False

    def _maybe_half_open(self) -> None:
        if (self._state == OPEN and self._opened_at is not None
                and self._clock.monotonic() - self._opened_at
                >= self.reset_timeout):
            self._state = HALF_OPEN
            self._probes = 0
            _TRANSITIONS.labels(breaker=self.name, to=HALF_OPEN).inc()

    def release_probe(self) -> None:
        """Return an admitted half-open probe slot without recording an
        outcome — for calls that never reached the backend (e.g. the
        deadline expired before the first attempt). Without this, an
        outcome-less probe would wedge the breaker half-open forever."""
        with self._lock:
            if self._state == HALF_OPEN and self._probes > 0:
                self._probes -= 1

    # -- outcomes ---------------------------------------------------------
    def record_success(self) -> None:
        with self._lock:
            if self._state != CLOSED:
                _TRANSITIONS.labels(breaker=self.name, to=CLOSED).inc()
            self._state = CLOSED
            self._consecutive_failures = 0
            self._opened_at = None
            self._probes = 0

    def record_failure(self) -> None:
        with self._lock:
            self._maybe_half_open()
            self._consecutive_failures += 1
            if (self._state == HALF_OPEN
                    or self._consecutive_failures >= self.failure_threshold):
                if self._state != OPEN:
                    self.opened_count += 1
                    _TRANSITIONS.labels(breaker=self.name, to=OPEN).inc()
                self._state = OPEN
                self._opened_at = self._clock.monotonic()
                self._probes = 0

    def snapshot(self) -> dict:
        """State for health endpoints — everything an operator needs to see
        why a backend is being skipped."""
        with self._lock:
            self._maybe_half_open()
            snap = {
                "state": self._state,
                "consecutiveFailures": self._consecutive_failures,
                "failureThreshold": self.failure_threshold,
                "timesOpened": self.opened_count,
                "rejectedCalls": self.rejected_count,
            }
            if self._state == OPEN and self._opened_at is not None:
                snap["retryAfterSec"] = round(max(
                    0.0, self._opened_at + self.reset_timeout
                    - self._clock.monotonic()), 3)
            return snap


class BreakerRegistry:
    """Process-wide name -> breaker map so health endpoints can report every
    backend's state without each surface keeping its own list."""

    def __init__(self):
        self._lock = threading.Lock()
        self._breakers: dict[str, CircuitBreaker] = {}

    def get_or_create(self, name: str, **kwargs) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(name)
            if b is None:
                b = self._breakers[name] = CircuitBreaker(name, **kwargs)
            return b

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            items = list(self._breakers.items())
        return {name: b.snapshot() for name, b in items}

    def reset(self) -> None:
        """Drop all breakers (test isolation)."""
        with self._lock:
            self._breakers.clear()


#: The default registry: storage backends register here at construction so
#: serving-layer ``/health`` endpoints see per-backend breaker state.
BREAKERS = BreakerRegistry()

# every registry-backed breaker's state lands on /metrics at scrape time;
# standalone breakers (per-algorithm, serving, event-store) are folded in by
# their owning server's collector through publish_breaker_metrics
REGISTRY.add_collector(
    "resilience.breakers", lambda: publish_breaker_metrics(BREAKERS.snapshot()))
