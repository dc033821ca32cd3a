"""TTL + single-flight cache for serving-time live event-store reads.

The reference reads the ``unavailableItems`` constraint from the event store
on EVERY query (ECommAlgorithm.scala:150-180) — correct, but it turns the
serving hot path into a storage benchmark. This cache bounds that to one
read per TTL window per process, with single-flight coalescing so a thundering
herd of coalesced queries behind an expired entry triggers exactly one
storage read (followers block on the leader's result instead of stampeding
the backend).

Determinism contract (the resilience-layer pattern, resilience/clock.py):
the cache takes an injectable :class:`Clock`, so tests script expiry by
advancing a ``FakeClock`` — zero wall sleeps.

Staleness is explicit and bounded: a constraint write becomes visible at
most ``ttl`` seconds later. ``PIO_SERVING_CONSTRAINT_TTL_MS=0`` disables
caching entirely and restores the reference's read-per-query semantics
(every ``get`` invokes the loader and counts a miss). See docs/serving.md.

Copy of ``incubator_predictionio_tpu/serving/cache.py``: the hit and miss
counts on the process-wide registry, and a follower of a cold key bounded
by its caller's ambient deadline (``resilience/policy.py``).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, TypeVar

from incubator_predictionio_tpu_torch.obs.metrics import REGISTRY
from incubator_predictionio_tpu_torch.resilience.clock import (
    SYSTEM_CLOCK,
    Clock,
)

T = TypeVar("T")

_HITS = REGISTRY.counter(
    "pio_serving_store_read_cache_hits_total",
    "Serving-time store reads answered from the TTL constraint cache "
    "(single-flight followers count as hits — they performed no read)")
_MISSES = REGISTRY.counter(
    "pio_serving_store_read_cache_misses_total",
    "Serving-time store reads that went to the backend (TTL expired, first "
    "read, or caching disabled via PIO_SERVING_CONSTRAINT_TTL_MS=0)")

#: Default constraint-read TTL when ``PIO_SERVING_CONSTRAINT_TTL_MS`` is
#: unset: 1s bounds constraint staleness to human-imperceptible while
#: capping the read rate at 1/s/process regardless of query load.
DEFAULT_CONSTRAINT_TTL_MS = 1000.0


def constraint_ttl_sec() -> float:
    """The serving constraint-read TTL in seconds, from
    ``PIO_SERVING_CONSTRAINT_TTL_MS`` (``0`` → read per query)."""
    raw = os.environ.get("PIO_SERVING_CONSTRAINT_TTL_MS")
    try:
        ms = float(raw) if raw is not None else DEFAULT_CONSTRAINT_TTL_MS
    except ValueError:
        ms = DEFAULT_CONSTRAINT_TTL_MS
    return max(0.0, ms) / 1000.0


class _Load:
    """One in-flight loader call: followers wait on the event, the leader
    resolves with a value or an exception. ``started`` lets the cache
    detect an abandoned (hung) leader and elect a new one."""

    __slots__ = ("_event", "value", "error", "started")

    def __init__(self, started: float = 0.0) -> None:
        self._event = threading.Event()
        self.value: Any = None
        self.error: BaseException | None = None
        self.started = started

    def resolve(self, value: Any) -> None:
        self.value = value
        self._event.set()

    def fail(self, error: BaseException) -> None:
        self.error = error
        self._event.set()

    def wait(self, timeout: float | None = None) -> Any:
        """Returns the leader's result; raises TimeoutError if it does not
        arrive within ``timeout`` seconds."""
        if not self._event.wait(timeout):
            raise TimeoutError("single-flight leader did not resolve in time")
        if self.error is not None:
            raise self.error
        return self.value


class TTLCache:
    """Keyed TTL cache with single-flight loading.

    ``get(key, loader)`` returns the cached value while it is fresh; on
    expiry exactly one caller (the leader) runs ``loader``. Concurrent
    callers serve the STALE value while the refresh is in flight
    (stale-while-revalidate — nobody queues behind a slow backend read);
    only a cold key with no previous value blocks followers on the
    leader's result. A failed load caches nothing — the stale value
    survives and the next caller becomes the new leader.

    ``ttl_sec <= 0`` disables caching: every ``get`` calls ``loader``
    directly (reference read-per-query semantics), counted as misses so the
    /metrics counters still describe the true read rate.
    """

    def __init__(self, ttl_sec: float, clock: Clock = SYSTEM_CLOCK):
        self.ttl_sec = ttl_sec
        self.clock = clock
        # a refresh leader whose read has been in flight this long is
        # presumed hung (black-holed connection with no deadline scope):
        # the next caller elects itself the new leader, so staleness can
        # never freeze at one snapshot for the process lifetime
        self.leader_timeout_sec = max(5.0, ttl_sec)
        self._lock = threading.Lock()
        self._entries: dict[Any, tuple[Any, float]] = {}  # key -> (value, expires)
        self._loads: dict[Any, _Load] = {}

    def get(self, key: Any, loader: Callable[[], T]) -> T:
        if self.ttl_sec <= 0:
            _MISSES.inc()
            return loader()
        now = self.clock.monotonic()
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry[1] > now:
                _HITS.inc()
                return entry[0]
            load = self._loads.get(key)
            if load is not None and \
                    now - load.started > self.leader_timeout_sec:
                load = None  # abandoned leader — take over the slot
            if load is None:
                load = self._loads[key] = _Load(started=now)
                leader = True
            else:
                leader = False
                if entry is not None:
                    # stale-while-revalidate: a refresh is already in
                    # flight — serve the expired value instead of queueing
                    # behind it (a slow/faulted leader read must not
                    # head-of-line-block every concurrent query past its
                    # own deadline; the leader runs under ITS caller's
                    # deadline scope and staleness is bounded by that)
                    _HITS.inc()
                    return entry[0]
        if not leader:
            # cold key (no previous value): join the in-flight read — but
            # only for as long as THIS caller's ambient deadline allows. A
            # slow leader must not hold a tighter-budgeted follower past
            # its own budget; on timeout the follower falls through to its
            # own read, which fails fast under its own deadline_scope.
            from incubator_predictionio_tpu_torch.resilience.policy import (
                current_deadline,
            )

            ambient = current_deadline()
            budget = ambient.remaining() if ambient is not None else None
            if budget is None:
                # no ambient deadline: still never park forever on a hung
                # leader's Event (takeover replaces the slot for LATER
                # callers only — already-parked waiters must time out on
                # their own and fall through to a direct read)
                budget = self.leader_timeout_sec
            try:
                value = load.wait(budget)
            except TimeoutError:
                _MISSES.inc()
                return loader()
            _HITS.inc()  # no storage call happened on this caller's behalf
            return value
        _MISSES.inc()
        try:
            value = loader()
        except BaseException as e:
            with self._lock:
                # identity check: a taken-over slot belongs to the NEW
                # leader — an old hung leader waking up must not evict it
                if self._loads.get(key) is load:
                    self._loads.pop(key)
            load.fail(e)
            raise
        with self._lock:
            # expiry is measured from load COMPLETION — a slow storage read
            # must not eat into the freshness window
            self._entries[key] = (value, self.clock.monotonic() + self.ttl_sec)
            if self._loads.get(key) is load:
                self._loads.pop(key)
        load.resolve(value)
        return value

    def invalidate(self, key: Any = None) -> None:
        """Drop one key (or everything when ``key`` is None)."""
        with self._lock:
            if key is None:
                self._entries.clear()
            else:
                self._entries.pop(key, None)
