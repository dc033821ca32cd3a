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

Copy of ``incubator_predictionio_tpu/serving/cache.py``. The port has no
metrics registry and no ambient deadline scope yet (the tooling slice,
ROADMAP.md Queue 1 item 6): the hit and miss counts are plain counters
(:data:`HITS`, :data:`MISSES`), and a follower of a cold key waits for its
leader at most ``leader_timeout_sec`` before it reads on its own (the
reference waits for the lesser of that and its caller's deadline).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Protocol, TypeVar

T = TypeVar("T")


class Clock(Protocol):
    """The time source the cache reads (tests pass a fake one)."""

    def monotonic(self) -> float: ...


class _SystemClock:
    def monotonic(self) -> float:
        return time.monotonic()


SYSTEM_CLOCK = _SystemClock()


class _Counter:
    """A named monotonic counter (``value``, ``inc()``), thread-safe."""

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


HITS = _Counter(
    "pio_serving_store_read_cache_hits_total",
    "Serving-time store reads answered from the TTL constraint cache "
    "(single-flight followers count as hits — they performed no read)")
MISSES = _Counter(
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
            MISSES.inc()
            return loader()
        now = self.clock.monotonic()
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry[1] > now:
                HITS.inc()
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
                    HITS.inc()
                    return entry[0]
        if not leader:
            # cold key (no previous value): join the in-flight read, but
            # never park forever on a hung leader's Event (takeover
            # replaces the slot for LATER callers only — already-parked
            # waiters time out on their own and fall through to a direct
            # read)
            try:
                value = load.wait(self.leader_timeout_sec)
            except TimeoutError:
                MISSES.inc()
                return loader()
            HITS.inc()  # no storage call happened on this caller's behalf
            return value
        MISSES.inc()
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
