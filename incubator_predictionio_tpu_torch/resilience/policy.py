"""The deadline half of the reference's retry/deadline policy engine.

Counterpart of ``incubator_predictionio_tpu/resilience/policy.py``
(:55-175): the failure vocabulary (:class:`TransientError`,
:class:`DeadlineExceeded`, :class:`ServingUnavailable`) and deadlines
(:class:`Deadline`, :func:`current_deadline`, :func:`deadline_scope`,
:func:`run_with_deadline`). The serving layer propagates its per-query
budget into the executor thread that runs ``predict_batch`` through
:func:`run_with_deadline`. ``RetryPolicy``, ``ResiliencePolicy`` and
``policy_from_config``, which wrap the network storage backends, come with
those backends (ROADMAP.md item 7).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, Optional

from incubator_predictionio_tpu_torch.data.storage.base import StorageError
from incubator_predictionio_tpu_torch.resilience.clock import (
    SYSTEM_CLOCK,
    Clock,
)


class TransientError(StorageError):
    """A failure worth retrying (connection reset, timeout, 5xx): transports
    wrap their raw socket/HTTP errors in this so the policy engine never has
    to know each library's exception taxonomy.

    ``no_retry = True`` on a subclass marks a condition that is transient
    *cluster-wise* but can never improve by retrying THIS endpoint (an
    epoch-fenced write on a deposed replica): the policy fails it fast so
    a higher layer — the multi-endpoint transport's failover, the event
    server's spill — can act instead of burning the retry budget in
    place."""

    no_retry = False


#: HTTP statuses that signal a transient service condition (throttle or
#: gateway/overload) for EVERY HTTP-speaking backend. Backends whose 500s
#: are usually infrastructure (S3 InternalError, HDFS standby failover) use
#: :data:`TRANSIENT_HTTP_CODES_WITH_500`; Elasticsearch deliberately does
#: not (its 500s are usually real request bugs).
TRANSIENT_HTTP_CODES = frozenset({429, 502, 503, 504})
TRANSIENT_HTTP_CODES_WITH_500 = TRANSIENT_HTTP_CODES | {500}


class DeadlineExceeded(StorageError):
    """The call's time budget ran out (before, between, or instead of
    further attempts)."""


class ServingUnavailable(StorageError):
    """Every algorithm of a deployed engine is unavailable (breaker-open or
    failed) — the serving layer should degrade, not 500."""


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------

class Deadline:
    """An absolute expiry on an injected clock. ``expires_at=None`` means
    unbounded (the common no-deadline case costs one comparison)."""

    __slots__ = ("expires_at", "clock")

    def __init__(self, expires_at: Optional[float],
                 clock: Clock = SYSTEM_CLOCK):
        self.expires_at = expires_at
        self.clock = clock

    @classmethod
    def after(cls, seconds: Optional[float],
              clock: Clock = SYSTEM_CLOCK) -> "Deadline":
        if seconds is None:
            return cls(None, clock)
        return cls(clock.monotonic() + seconds, clock)

    def remaining(self) -> Optional[float]:
        if self.expires_at is None:
            return None
        return max(0.0, self.expires_at - self.clock.monotonic())

    def expired(self) -> bool:
        return self.expires_at is not None and \
            self.clock.monotonic() >= self.expires_at

    def attempt_timeout(self, default: float) -> float:
        """Per-attempt socket timeout: the configured default, capped by
        what's left of the budget (never zero — sockets treat 0 as
        non-blocking)."""
        rem = self.remaining()
        if rem is None:
            return default
        return max(0.001, min(default, rem))

    def tightened(self, seconds: Optional[float]) -> "Deadline":
        """The earlier of this deadline and ``now + seconds``."""
        if seconds is None:
            return self
        candidate = self.clock.monotonic() + seconds
        if self.expires_at is None or candidate < self.expires_at:
            return Deadline(candidate, self.clock)
        return self


_AMBIENT: contextvars.ContextVar[Optional[Deadline]] = contextvars.ContextVar(
    "pio_resilience_deadline", default=None)


def current_deadline() -> Optional[Deadline]:
    """The ambient deadline set by an enclosing :func:`deadline_scope`."""
    return _AMBIENT.get()


@contextlib.contextmanager
def deadline_scope(seconds: Optional[float], clock: Clock = SYSTEM_CLOCK):
    """Bound every policy-routed call in this context by ``seconds``. Nested
    scopes tighten (the effective deadline is the earliest)."""
    outer = _AMBIENT.get()
    if outer is not None:
        scoped = outer.tightened(seconds)
    else:
        scoped = Deadline.after(seconds, clock)
    token = _AMBIENT.set(scoped)
    try:
        yield scoped
    finally:
        _AMBIENT.reset(token)


def run_with_deadline(seconds: Optional[float], fn: Callable[..., Any],
                      *args: Any) -> Any:
    """Run ``fn(*args)`` under a deadline scope — the executor-thread form
    (``loop.run_in_executor`` does not copy contextvars, so the serving
    layer wraps its worker calls in this to propagate the budget)."""
    with deadline_scope(seconds):
        return fn(*args)


__all__ = [
    "TRANSIENT_HTTP_CODES", "TRANSIENT_HTTP_CODES_WITH_500",
    "Deadline", "DeadlineExceeded", "ServingUnavailable", "TransientError",
    "current_deadline", "deadline_scope", "run_with_deadline",
]
