"""Counterpart of ``incubator_predictionio_tpu/resilience``, with the
reference's exports for what is ported:

- :mod:`.breaker` — per-backend circuit breakers (:data:`BREAKERS`);
- :mod:`.policy`, the deadline half — :func:`deadline_scope`,
  :func:`run_with_deadline` and the serving layer's failure vocabulary;
- :mod:`.admission` — adaptive concurrency, bounded queues with
  deadline-aware shedding, brownout, per-client fairness;
- :mod:`.clock` — the injectable clock every component waits on;
- :mod:`.wal` — the WAL frame format the streaming dead letters use.

``RetryPolicy``, ``ResiliencePolicy``, ``policy_from_config`` and the
fault-injection harness (``faults.py``) come with the network storage
backends they wrap (ROADMAP.md item 7), and so does the event server's
``SpillWal``.
"""

from incubator_predictionio_tpu_torch.resilience.admission import (
    AdaptiveConcurrencyLimiter,
    AdmissionConfig,
    AdmissionController,
    FairnessGate,
    InflightGate,
    RateEstimator,
    ShedExpired,
    TokenBucket,
    derive_retry_after,
)
from incubator_predictionio_tpu_torch.resilience.breaker import (
    BREAKERS,
    BreakerRegistry,
    CircuitBreaker,
    CircuitOpenError,
)
from incubator_predictionio_tpu_torch.resilience.clock import (
    SYSTEM_CLOCK,
    Clock,
    FakeClock,
    SystemClock,
)
from incubator_predictionio_tpu_torch.resilience.policy import (
    Deadline,
    DeadlineExceeded,
    ServingUnavailable,
    TransientError,
    current_deadline,
    deadline_scope,
    run_with_deadline,
)

__all__ = [
    "AdaptiveConcurrencyLimiter", "AdmissionConfig", "AdmissionController",
    "FairnessGate", "InflightGate", "RateEstimator", "ShedExpired",
    "TokenBucket", "derive_retry_after",
    "BREAKERS", "BreakerRegistry", "CircuitBreaker", "CircuitOpenError",
    "SYSTEM_CLOCK", "Clock", "FakeClock", "SystemClock",
    "Deadline", "DeadlineExceeded", "ServingUnavailable", "TransientError",
    "current_deadline", "deadline_scope", "run_with_deadline",
]
