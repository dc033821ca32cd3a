"""Adaptive overload protection: admission control, deadline-aware
shedding, and fair backpressure (docs/resilience.md "Overload & admission
control").

Counterpart of ``incubator_predictionio_tpu/resilience/admission.py``,
whole. The query server uses the limiter, the controller and
:class:`ShedExpired`; the event-server and storage-server users of
:class:`TokenBucket`, :class:`FairnessGate` and :class:`InflightGate` are
not ported yet (ROADMAP.md item 7).

A serving stack that can score a 128-query batch in one dispatch still
falls over under *sustained* overload unless something bounds the queues:
every queued request inflates every other request's tail, expired requests
waste device dispatches, and one hot client can starve the rest. This
module is the ONE vocabulary all three servers use to say no early and
cheaply instead of late and expensively:

- :class:`AdaptiveConcurrencyLimiter` — AIMD on observed latency vs. a
  target (gradient-style when no explicit target is configured: the target
  tracks a rolling minimum "no-queue" baseline), used by the query server
  to live-resize the micro-batcher's dispatch slots;
- :class:`AdmissionController` — the query server's door policy: a bounded
  admission queue with deadline-feasibility rejection (429 + pressure-
  derived ``Retry-After`` when ``queue depth ÷ observed service rate``
  can no longer meet the deadline) and a **brownout** mode that serves the
  degraded last-good/serving-default path under sustained saturation
  *before* any shedding starts;
- :class:`ShedExpired` — the marker the micro-batcher resolves futures
  with when a request's deadline already expired at batch-assembly time
  (fail fast with 504 instead of dispatching dead work);
- :class:`TokenBucket` / :class:`FairnessGate` — per-client rate fairness
  for the event server's ingest (a misbehaving access key degrades alone);
- :class:`InflightGate` — per-client concurrent in-flight caps for the
  storage server's RPC loop;
- :func:`derive_retry_after` — the shared pressure→``Retry-After`` helper
  (spill depth ÷ drain rate on the event server, queue depth ÷ service
  rate on the query server).

Every component takes an injectable :class:`Clock`, so every decision —
limit change, shed, brownout enter/exit, ``Retry-After`` value — is
deterministic under :class:`FakeClock` (tests/test_overload.py).

Priority classes: health probes, ``/metrics``, ``/traces.json``, and
``/reload`` are separate always-admitted routes on every server — only
sheddable work (query traffic, ingest, storage RPCs) passes these gates.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import math
import threading
from typing import Optional

from incubator_predictionio_tpu_torch.obs.metrics import REGISTRY
from incubator_predictionio_tpu_torch.resilience.clock import SYSTEM_CLOCK, Clock

logger = logging.getLogger(__name__)

# -- decisions --------------------------------------------------------------
ADMIT = "admit"
BROWNOUT = "brownout"
REJECT = "reject"

# -- telemetry (obs/, docs/observability.md) --------------------------------
_DECISIONS = REGISTRY.counter(
    "pio_admission_decisions_total",
    "Admission decisions for sheddable requests (admit / brownout / "
    "reject)", labels=("server", "decision"))
_QUEUE_DEPTH = REGISTRY.gauge(
    "pio_admission_queue_depth",
    "Requests waiting in the bounded admission queue at scrape time",
    labels=("server",))
_LIMIT = REGISTRY.gauge(
    "pio_admission_limit",
    "Current adaptive concurrency limit (dispatch slots)",
    labels=("server",))
_LIMIT_CHANGES = REGISTRY.counter(
    "pio_admission_limit_changes_total",
    "Adaptive concurrency limit adjustments by direction",
    labels=("server", "direction"))
_THROTTLED = REGISTRY.counter(
    "pio_admission_throttled_total",
    "Requests rejected by per-client fairness (token bucket or in-flight "
    "cap) — one hot client degrades alone", labels=("server",))
SHED_EXPIRED_TOTAL = REGISTRY.counter(
    "pio_shed_expired_total",
    "Requests evicted at batch-assembly time because their deadline had "
    "already expired (answered 504 instead of wasting a dispatch)",
    labels=("server",))
_BROWNOUT_ACTIVE = REGISTRY.gauge(
    "pio_brownout_active",
    "1 while sustained saturation routes sheddable traffic to the "
    "degraded last-good/serving-default path", labels=("server",))
_BROWNOUT_TRANSITIONS = REGISTRY.counter(
    "pio_brownout_transitions_total",
    "Brownout mode transitions", labels=("server", "to"))


class ShedExpired(Exception):
    """A queued request's deadline expired before it reached a dispatch —
    the micro-batcher evicts it at batch-assembly time and the handler
    answers 504 (the caller already gave up; dispatching it would only
    inflate everyone else's tail)."""


def derive_retry_after(depth: int, rate_per_sec: float, fallback: int,
                       lo: int = 1, hi: int = 60) -> int:
    """Pressure-derived ``Retry-After`` (seconds): the time to drain
    ``depth`` queued items at the observed ``rate_per_sec``, clamped to
    ``[lo, hi]``; ``fallback`` when no rate signal exists yet. Shared by
    the event server's 503s (spill depth ÷ drain rate) and the query
    server's 429s (queue depth ÷ service rate)."""
    if depth <= 0:
        return lo
    if rate_per_sec <= 0.0:
        return int(fallback)
    return int(min(hi, max(lo, math.ceil(depth / rate_per_sec))))


class RateEstimator:
    """Events per second over a sliding window on an injectable clock.

    The tally is divided by the span actually observed (oldest retained
    event → now, capped at the window), not the full window — a server
    ten requests into its life must read as its real throughput, not as
    one ten-window-ths of it (the full-window denominator made an idle
    server look saturated and 429 its second request)."""

    def __init__(self, window_sec: float = 10.0,
                 clock: Clock = SYSTEM_CLOCK):
        self.window_sec = window_sec
        self._clock = clock
        self._lock = threading.Lock()
        self._events: collections.deque[tuple[float, int]] = (
            collections.deque())
        self._total = 0

    def record(self, n: int = 1) -> None:
        now = self._clock.monotonic()
        with self._lock:
            self._events.append((now, n))
            self._total += n
            self._prune(now)

    def _prune(self, now: float) -> None:
        cutoff = now - self.window_sec
        while self._events and self._events[0][0] <= cutoff:
            _, n = self._events.popleft()
            self._total -= n

    def rate(self) -> float:
        """Events/sec over the observed span of the trailing window; 0.0
        with no signal. A single retained event is "no signal" — right
        after an idle gap its elapsed span is ~0, and a floored division
        would report a rate overestimated by orders of magnitude (the
        feasibility gate would then admit a burst of doomed requests)."""
        with self._lock:
            now = self._clock.monotonic()
            self._prune(now)
            if len(self._events) < 2:
                return 0.0
            elapsed = max(0.05, min(self.window_sec,
                                    now - self._events[0][0]))
            return self._total / elapsed


class TokenBucket:
    """Classic lazy-refill token bucket on an injectable clock."""

    __slots__ = ("rate", "burst", "_clock", "_tokens", "_stamp", "_lock")

    def __init__(self, rate: float, burst: float,
                 clock: Clock = SYSTEM_CLOCK):
        self.rate = rate
        self.burst = burst
        self._clock = clock
        self._tokens = burst
        self._stamp = clock.monotonic()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        self._tokens = min(
            self.burst, self._tokens + (now - self._stamp) * self.rate)
        self._stamp = now

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill(self._clock.monotonic())
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def try_charge(self, needed: float, charge: float) -> bool:
        """Admit when ``needed`` tokens are available but pay ``charge``,
        which may drive the balance negative: a one-shot cost above the
        bucket capacity is admitted once ``needed`` has accumulated, yet
        its FULL cost is still refilled at ``rate`` before the next
        admission — the long-run rate holds even for oversized requests."""
        with self._lock:
            self._refill(self._clock.monotonic())
            if self._tokens >= needed:
                self._tokens -= charge
                return True
            return False

    def retry_after(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens will be available (0 when they
        already are)."""
        with self._lock:
            self._refill(self._clock.monotonic())
            if self._tokens >= n:
                return 0.0
            return (min(n, self.burst) - self._tokens) / self.rate

    @property
    def idle(self) -> bool:
        with self._lock:
            self._refill(self._clock.monotonic())
            return self._tokens >= self.burst

    def fill(self) -> float:
        """Current token balance as a fraction of burst capacity. Negative
        when ``try_charge`` drove the bucket into debt (an oversized batch
        still being paid off) — callers render it as "over quota"."""
        with self._lock:
            self._refill(self._clock.monotonic())
            return self._tokens / self.burst if self.burst > 0 else 0.0


class FairnessGate:
    """Per-client token buckets (event-server ingest fairness).

    ``rate`` is events/sec *per client key* (the access key: the billing
    identity, not the TCP peer — one tenant behind a NAT is still one
    tenant); ``rate <= 0`` disables the gate entirely. The map is bounded:
    when it overflows, idle (full-bucket) clients are evicted first."""

    def __init__(self, rate: float, burst: float = 0.0,
                 clock: Clock = SYSTEM_CLOCK, server: str = "event_server",
                 max_clients: int = 4096):
        self.rate = rate
        self.burst = burst if burst > 0 else max(1.0, 2.0 * rate)
        self._clock = clock
        self._server = server
        self._max_clients = max_clients
        self._lock = threading.Lock()
        self._buckets: dict[str, TokenBucket] = {}
        self._throttled_by: dict[str, int] = {}
        self.throttled_count = 0

    @property
    def enabled(self) -> bool:
        return self.rate > 0

    def admit(self, key: str, cost: float = 1.0) -> Optional[int]:
        """``None`` when admitted; otherwise the ``Retry-After`` seconds
        to send with the 429."""
        if not self.enabled:
            return None
        # a cost above the bucket capacity could NEVER be pre-paid in full
        # (a legal 50-event batch against a small burst would 429 forever):
        # admit once the burst has accumulated, but charge the FULL cost
        # into debt — the next admission waits out batch_size/rate seconds,
        # so the configured events/sec holds even for oversized batches
        needed = min(cost, self.burst)
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is None:
                if len(self._buckets) >= self._max_clients:
                    self._evict_idle()
                bucket = self._buckets[key] = TokenBucket(
                    self.rate, self.burst, self._clock)
        if bucket.try_charge(needed, cost):
            return None
        with self._lock:
            self.throttled_count += 1
            self._throttled_by[key] = self._throttled_by.get(key, 0) + 1
        _THROTTLED.labels(server=self._server).inc()
        return max(1, math.ceil(bucket.retry_after(needed)))

    def _evict_idle(self) -> None:
        # full buckets belong to clients that haven't sent in ≥ burst/rate
        # seconds — dropping them loses no throttle debt (the throttle
        # TALLY survives eviction: forensics outlive the bucket)
        for k in [k for k, b in self._buckets.items() if b.idle]:
            del self._buckets[k]
        if len(self._buckets) >= self._max_clients:
            # every tracked client is active: reset rather than grow
            # unboundedly (a brief throttle-debt amnesty, documented)
            self._buckets.clear()
        # the tally map is bounded too — keep only the loudest offenders
        if len(self._throttled_by) > self._max_clients:
            keep = sorted(self._throttled_by.items(),
                          key=lambda kv: -kv[1])[: self._max_clients // 2]
            self._throttled_by = dict(keep)

    @staticmethod
    def _mask(key: str) -> str:
        """Access keys are credentials; show enough to NAME the tenant on
        a dashboard without republishing the secret."""
        return key if len(key) <= 8 else key[:8] + "…"

    def per_client(self, top: int = 8) -> list[dict]:
        """The ``top`` noisiest clients by throttle count, then the lowest
        bucket fill — bounded output regardless of tracked-client count,
        so /health stays O(top) under a million-key flood."""
        with self._lock:
            buckets = list(self._buckets.items())
            tallies = dict(self._throttled_by)
        rows = []
        for key, bucket in buckets:
            rows.append({"key": self._mask(key),
                         "fill": round(bucket.fill(), 4),
                         "throttled": tallies.pop(key, 0)})
        # throttled clients whose bucket was evicted still get named
        for key, count in tallies.items():
            rows.append({"key": self._mask(key), "fill": None,
                         "throttled": count})
        rows.sort(key=lambda r: (-r["throttled"],
                                 r["fill"] if r["fill"] is not None else 1.0))
        return rows[:top]

    def snapshot(self) -> dict:
        with self._lock:
            tracked = len(self._buckets)
        return {"enabled": self.enabled, "ratePerSec": self.rate,
                "burst": self.burst, "trackedClients": tracked,
                "throttled": self.throttled_count,
                "perClient": self.per_client() if self.enabled else []}


class InflightGate:
    """Per-client concurrent in-flight cap (storage-server RPC loop): a
    client that floods the RPC surface queues behind itself, not behind
    everyone else. ``max_in_flight <= 0`` disables."""

    def __init__(self, max_in_flight: int, server: str = "storage_server"):
        self.max_in_flight = max_in_flight
        self._server = server
        self._lock = threading.Lock()
        self._inflight: dict[str, int] = {}
        self.throttled_count = 0

    @property
    def enabled(self) -> bool:
        return self.max_in_flight > 0

    def acquire(self, key: str) -> bool:
        if not self.enabled:
            return True
        with self._lock:
            n = self._inflight.get(key, 0)
            if n >= self.max_in_flight:
                self.throttled_count += 1
                _THROTTLED.labels(server=self._server).inc()
                return False
            self._inflight[key] = n + 1
            return True

    def release(self, key: str) -> None:
        if not self.enabled:
            return
        with self._lock:
            n = self._inflight.get(key, 0)
            if n <= 1:
                self._inflight.pop(key, None)
            else:
                self._inflight[key] = n - 1

    def snapshot(self) -> dict:
        with self._lock:
            active = dict(self._inflight)
        return {"enabled": self.enabled,
                "maxInFlightPerClient": self.max_in_flight,
                "activeClients": len(active),
                "inFlight": sum(active.values()),
                "throttled": self.throttled_count}


class AdaptiveConcurrencyLimiter:
    """AIMD concurrency limit driven by observed latency vs. a target.

    Additive increase / multiplicative decrease on a per-window median:
    every ``window`` completions (rate-limited by ``cooldown_sec``), a
    median above the target shrinks the limit by ``backoff``; a median
    comfortably below it (< ``headroom`` × target) grows it by one slot.

    Gradient mode: with no explicit ``target_sec``, the target is
    ``tolerance ×`` a rolling-minimum latency baseline — the window
    minimum is adopted immediately when it improves and drifts up slowly
    otherwise, so the "no-queue" latency the engine is capable of becomes
    the yardstick the limit is judged against.
    """

    def __init__(self, min_limit: int = 1, max_limit: int = 2,
                 target_sec: Optional[float] = None, tolerance: float = 2.0,
                 window: int = 32, backoff: float = 0.7,
                 headroom: float = 0.8, cooldown_sec: float = 1.0,
                 clock: Clock = SYSTEM_CLOCK,
                 server: str = "query_server"):
        self.min_limit = max(1, min_limit)
        self.max_limit = max(self.min_limit, max_limit)
        self.target_sec = target_sec
        self.tolerance = tolerance
        self.window = max(1, window)
        self.backoff = backoff
        self.headroom = headroom
        self.cooldown_sec = cooldown_sec
        self._clock = clock
        self._server = server
        self._lock = threading.Lock()
        self._limit = self.max_limit  # start optimistic; shed load shrinks
        self._samples: list[float] = []
        self._baseline: Optional[float] = None
        self._next_adjust = clock.monotonic()
        self.changes = 0
        _LIMIT.labels(server=server).set(self._limit)

    @property
    def limit(self) -> int:
        with self._lock:
            return self._limit

    def current_target(self) -> Optional[float]:
        with self._lock:
            return self._target_locked()

    def _target_locked(self) -> Optional[float]:
        if self.target_sec is not None:
            return self.target_sec
        if self._baseline is None:
            return None
        return self.tolerance * self._baseline

    def observe(self, latency_sec: float) -> Optional[int]:
        """Record one completion; returns the NEW limit iff it changed."""
        with self._lock:
            self._samples.append(latency_sec)
            if len(self._samples) < self.window:
                return None
            now = self._clock.monotonic()
            wmin = min(self._samples)
            med = sorted(self._samples)[len(self._samples) // 2]
            self._samples.clear()
            # rolling-min baseline: adopt improvements immediately, drift
            # up slowly so a genuinely slower engine (bigger model after
            # /reload) doesn't read as permanent congestion
            if self._baseline is None or wmin < self._baseline:
                self._baseline = wmin
            else:
                self._baseline += 0.05 * (wmin - self._baseline)
            if now < self._next_adjust:
                return None
            target = self._target_locked()
            if target is None:
                return None
            old = self._limit
            if med > target:
                self._limit = max(self.min_limit,
                                  min(self._limit - 1,
                                      int(self._limit * self.backoff)))
            elif med < self.headroom * target:
                self._limit = min(self.max_limit, self._limit + 1)
            if self._limit == old:
                return None
            self._next_adjust = now + self.cooldown_sec
            self.changes += 1
            direction = "down" if self._limit < old else "up"
        _LIMIT.labels(server=self._server).set(self._limit)
        _LIMIT_CHANGES.labels(server=self._server, direction=direction).inc()
        logger.info("admission[%s]: concurrency limit %d -> %d "
                    "(window median %.4fs vs target %.4fs)",
                    self._server, old, self._limit, med, target)
        return self._limit

    def set_bounds(self, min_limit: int, max_limit: int) -> int:
        """Re-bound the limit (a /reload can swap in an engine with a
        different thread-safety posture); returns the clamped current
        limit."""
        with self._lock:
            self.min_limit = max(1, min_limit)
            self.max_limit = max(self.min_limit, max_limit)
            self._limit = min(self.max_limit,
                              max(self.min_limit, self._limit))
            self._baseline = None  # new engine, new latency floor
            self._samples.clear()
            limit = self._limit
        _LIMIT.labels(server=self._server).set(limit)
        return limit


@dataclasses.dataclass
class AdmissionConfig:
    """Knobs for :class:`AdmissionController`. Env resolution
    (``PIO_ADMISSION_*`` / ``PIO_BROWNOUT_*``, docs/configuration.md)
    lives with the owning server's config — ONE parsing path — which
    passes the resolved values in here."""

    # bounded admission queue: requests beyond this depth are rejected at
    # the door with 429 regardless of deadline math
    max_queue: int = 256
    # per-request budget used for deadline-feasibility rejection and for
    # assembly-time eviction tagging. None disables the deadline terms
    # (the depth bound still holds).
    deadline_sec: Optional[float] = None
    # predicted-wait / deadline fraction (or depth/max_queue fraction when
    # no deadline signal exists) that counts as "saturated" for brownout
    brownout_enter_frac: float = 0.5
    brownout_enter_sec: float = 1.0   # sustained saturation before entering
    brownout_exit_sec: float = 2.0    # sustained clear air before exiting
    rate_window_sec: float = 10.0     # service-rate estimation window
    retry_after_fallback: int = 5     # Retry-After with no rate signal
    # adaptive concurrency limiter
    adaptive: bool = True
    min_inflight: int = 1
    max_inflight: int = 2
    target_latency_sec: Optional[float] = None  # None = gradient mode


class AdmissionController:
    """The query server's door policy, with the shedding order documented
    in docs/resilience.md: **brownout → 429-reject → 504-evict**.

    1. *Brownout*: sustained moderate saturation (predicted queue wait a
       configurable fraction of the deadline, with dwell-time hysteresis)
       flips the server to the degraded last-good/serving-default path —
       every caller still gets a valid 200, the device queue stops
       growing.
    2. *Reject (429)*: the queue is at its depth bound, or
       ``(depth + 1) ÷ observed service rate`` already exceeds the
       deadline — an admitted request would be dead on dispatch, so it is
       refused at the door with a pressure-derived ``Retry-After``.
    3. *Evict (504)*: requests that were admitted but whose deadline
       expired while queued are shed at batch-assembly time
       (:class:`ShedExpired`) — the micro-batcher owns that step; this
       controller only does the bookkeeping.

    All time flows through the injected clock; a test on
    :class:`FakeClock` can script saturation and recovery without a
    single wall-clock sleep.
    """

    def __init__(self, cfg: AdmissionConfig, clock: Clock = SYSTEM_CLOCK,
                 server: str = "query_server"):
        self.cfg = cfg
        self._clock = clock
        self.server = server
        self._completions = RateEstimator(cfg.rate_window_sec, clock)
        self.limiter: Optional[AdaptiveConcurrencyLimiter] = None
        if cfg.adaptive:
            self.limiter = AdaptiveConcurrencyLimiter(
                min_limit=cfg.min_inflight, max_limit=cfg.max_inflight,
                target_sec=cfg.target_latency_sec, clock=clock,
                server=server)
        self._brownout = False
        self._saturated_since: Optional[float] = None
        self._clear_since: Optional[float] = None
        # plain-int tallies for the /health surface (metrics carry the
        # same signals for scrapes)
        self.admitted = 0
        self.rejected = 0
        self.brownout_served = 0
        self.shed_expired = 0
        _BROWNOUT_ACTIVE.labels(server=server).set(0)

    # -- the door ---------------------------------------------------------
    def decide(self, queue_depth: int) -> tuple[str, Optional[int]]:
        """One admission decision for a sheddable request:
        ``(ADMIT|BROWNOUT|REJECT, retry_after_sec_or_None)``."""
        pressure = self._pressure(queue_depth)
        self._update_brownout(pressure)
        if queue_depth >= self.cfg.max_queue or pressure > 1.0:
            self.rejected += 1
            _DECISIONS.labels(server=self.server, decision=REJECT).inc()
            return REJECT, self.retry_after(queue_depth)
        if self._brownout:
            self.brownout_served += 1
            _DECISIONS.labels(server=self.server, decision=BROWNOUT).inc()
            return BROWNOUT, None
        self.admitted += 1
        _DECISIONS.labels(server=self.server, decision=ADMIT).inc()
        return ADMIT, None

    def _pressure(self, depth: int) -> float:
        """Saturation in [0, ∞): the predicted queue wait of the next
        request as a fraction of the deadline (>1 = dead on dispatch).
        An empty queue waits ~0 whatever the rate — below capacity this
        is always 0, which is what makes "zero sheds below capacity"
        structural rather than tuned. Without a deadline or service-rate
        signal, plain queue fill fraction."""
        if depth <= 0:
            return 0.0
        rate = self._completions.rate()
        if self.cfg.deadline_sec and rate > 0.0:
            return depth / rate / self.cfg.deadline_sec
        return depth / max(1, self.cfg.max_queue)

    def _update_brownout(self, pressure: float) -> None:
        now = self._clock.monotonic()
        if pressure >= self.cfg.brownout_enter_frac:
            self._clear_since = None
            if self._saturated_since is None:
                self._saturated_since = now
            if (not self._brownout and now - self._saturated_since
                    >= self.cfg.brownout_enter_sec):
                self._brownout = True
                _BROWNOUT_ACTIVE.labels(server=self.server).set(1)
                _BROWNOUT_TRANSITIONS.labels(
                    server=self.server, to="active").inc()
                logger.warning(
                    "admission[%s]: BROWNOUT — sustained saturation "
                    "(pressure %.2f); serving the degraded path",
                    self.server, pressure)
        else:
            self._saturated_since = None
            if self._brownout:
                if self._clear_since is None:
                    self._clear_since = now
                elif now - self._clear_since >= self.cfg.brownout_exit_sec:
                    self._brownout = False
                    self._clear_since = None
                    _BROWNOUT_ACTIVE.labels(server=self.server).set(0)
                    _BROWNOUT_TRANSITIONS.labels(
                        server=self.server, to="inactive").inc()
                    logger.info("admission[%s]: brownout cleared",
                                self.server)

    @property
    def brownout_active(self) -> bool:
        return self._brownout

    # -- feedback ---------------------------------------------------------
    def on_complete(self, latency_sec: float,
                    observe_latency: bool = True) -> Optional[int]:
        """Record a served request (feeds the service-rate estimate and
        the adaptive limiter); returns the new concurrency limit iff it
        changed. ``observe_latency=False`` feeds ONLY the rate estimate —
        non-predict completions (binding 400s, degraded answers) drain
        the queue like any other, but their near-instant latencies would
        poison the limiter's gradient-mode rolling-min baseline (a ~1 ms
        400 adopted as the "no-queue" floor makes every real prediction
        read as congestion and pins the limit at its minimum)."""
        self._completions.record(1)
        if observe_latency and self.limiter is not None:
            return self.limiter.observe(latency_sec)
        return None

    def on_shed_expired(self, n: int = 1) -> None:
        self.shed_expired += n
        SHED_EXPIRED_TOTAL.labels(server=self.server).inc(n)
        # expired entries left the queue too — that is drain progress the
        # feasibility math must see, or a burst of dead requests reads as
        # a stalled server and 429s everything forever
        self._completions.record(n)

    def service_rate(self) -> float:
        return self._completions.rate()

    def retry_after(self, queue_depth: int) -> int:
        return derive_retry_after(queue_depth, self._completions.rate(),
                                  self.cfg.retry_after_fallback)

    def current_limit(self) -> Optional[int]:
        return self.limiter.limit if self.limiter is not None else None

    def set_max_inflight(self, max_inflight: int) -> Optional[int]:
        """Re-bound the adaptive limiter (reload re-resolves the engine's
        thread-safety posture); returns the clamped limit."""
        self.cfg.max_inflight = max_inflight
        if self.limiter is None:
            return None
        return self.limiter.set_bounds(self.cfg.min_inflight, max_inflight)

    # -- surfaces ---------------------------------------------------------
    def publish(self, queue_depth: int) -> None:
        """Scrape-time gauge fold (the owning server's collector). Also
        runs the brownout hysteresis: state otherwise only advances in
        :meth:`decide`, and a server whose traffic stopped entirely (LB
        pulled it, storm ended) would stay latched in brownout forever —
        scrapes and health probes keep the clock moving on an idle
        server."""
        self._update_brownout(self._pressure(queue_depth))
        _QUEUE_DEPTH.labels(server=self.server).set(queue_depth)
        _BROWNOUT_ACTIVE.labels(server=self.server).set(
            1 if self._brownout else 0)
        if self.limiter is not None:
            _LIMIT.labels(server=self.server).set(self.limiter.limit)

    def snapshot(self, queue_depth: int) -> dict:
        """The /health surface (pio-tpu health renders this); advances the
        brownout hysteresis like :meth:`publish` so an idle server's
        health probe reports (and causes) the exit."""
        self._update_brownout(self._pressure(queue_depth))
        return {
            "queueDepth": queue_depth,
            "queueMax": self.cfg.max_queue,
            "deadlineSec": self.cfg.deadline_sec,
            "serviceRatePerSec": round(self._completions.rate(), 3),
            "brownoutActive": self._brownout,
            "inflightLimit": self.current_limit(),
            "admitted": self.admitted,
            "rejected": self.rejected,
            "brownoutServed": self.brownout_served,
            "shedExpired": self.shed_expired,
        }


__all__ = [
    "ADMIT", "BROWNOUT", "REJECT",
    "AdaptiveConcurrencyLimiter", "AdmissionConfig", "AdmissionController",
    "FairnessGate", "InflightGate", "RateEstimator", "ShedExpired",
    "TokenBucket", "derive_retry_after",
]
