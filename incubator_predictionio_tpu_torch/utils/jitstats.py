"""First-dispatch accounting for the serving hot path, and the build clock
of the port's kernels.

Counterpart of ``incubator_predictionio_tpu/utils/jitstats.py``, same API:
:func:`record`, :func:`count`, :func:`recent_count`, :func:`snapshot`,
:func:`first_seen`, :func:`executable_name`, :func:`observe_compile`,
:func:`dispatch_timer`, :func:`top_compiles`,
:func:`compile_seconds_total`, :func:`reset`, and the ``/metrics`` fold
(``pio_jit_compile_keys``, ``pio_jit_compiles_recent``,
``pio_jit_compile_seconds_total``).

The reference counts the distinct jit cache keys its scorers dispatch
with, since each new key is an XLA compile. The port compiles nothing at
dispatch: its kernels are built once, by ``nvcc``, into shared libraries
(``ops/_build.py``), and that build books its wall time here through
:func:`observe_compile` under the library's name (``retrieval``,
``sparse_update``, …). The dispatch timers keep the reference's keys
(``two_tower_topk_int8``, ``ivf_coarse_int8``, …), so the key count still
says how many distinct dispatch shapes serving has seen, and a count that
grows under load still means unbounded shapes. What a first dispatch costs
on the card is a launch plus, the first time a library is used in the
process, its load (and its build when it is not built yet); a warm
dispatch pays two clock reads here and nothing else.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Hashable, Iterator, Optional

from incubator_predictionio_tpu_torch.obs.metrics import REGISTRY

_lock = threading.Lock()
_first_seen: dict[Hashable, float] = {}  # key -> monotonic first-dispatch
#: executable name -> [cumulative first-dispatch wall seconds, compiles] —
#: compile-time attribution, not just counts (a recompile storm shows up
#: as SECONDS on one name, which is what makes it diagnosable)
_compile: dict[str, list] = {}


def record(key: Hashable, now: Optional[float] = None) -> bool:
    """Register a jit dispatch key; returns True when it is new (a compile).
    ``now`` (monotonic seconds) is injectable for tests."""
    ts = time.monotonic() if now is None else now
    with _lock:
        if key in _first_seen:
            return False
        _first_seen[key] = ts
        return True


def count() -> int:
    """Number of distinct serving executables built so far in this process."""
    with _lock:
        return len(_first_seen)


def recent_count(window_sec: float = 60.0, now: Optional[float] = None) -> int:
    """Keys first seen within the last ``window_sec`` — the growing-under-
    load alert gauge (non-zero after warmup means the round-2 bug is live)."""
    cutoff = (time.monotonic() if now is None else now) - window_sec
    with _lock:
        return sum(1 for ts in _first_seen.values() if ts >= cutoff)


def snapshot() -> list:
    """The keys themselves (sorted repr order) — for debugging/status pages."""
    with _lock:
        return sorted(_first_seen, key=repr)


def first_seen() -> dict:
    """key -> first-seen monotonic timestamp (copy)."""
    with _lock:
        return dict(_first_seen)


def executable_name(key: Hashable) -> str:
    """The executable-name component of a jit cache key — by convention the
    first tuple element (``"two_tower_topk"``, …); non-tuple keys name
    themselves. Bounded cardinality: names are code-chosen literals."""
    if isinstance(key, tuple) and key and isinstance(key[0], str):
        return key[0]
    return str(key)


def observe_compile(key: Hashable, seconds: float) -> None:
    """Attribute one first-dispatch (or one kernel build's) wall time to
    ``key``'s executable name: the port's compile clock."""
    name = executable_name(key)
    seconds = max(0.0, seconds)
    with _lock:
        ent = _compile.setdefault(name, [0.0, 0])
        ent[0] += seconds
        ent[1] += 1
    _C_COMPILE_SEC.labels(executable=name).inc(seconds)


@contextlib.contextmanager
def dispatch_timer(key: Hashable) -> Iterator[None]:
    """``record(key)`` + time the enclosed (dispatch + block) region; a
    FRESH key books the wall time as compile via :func:`observe_compile`.
    Warm dispatches pay two perf_counter reads and nothing else."""
    fresh = record(key)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if fresh:
            observe_compile(key, time.perf_counter() - t0)


def top_compiles(n: int = 10) -> list[tuple[str, float, int]]:
    """``(executable, cumulative_seconds, compiles)`` sorted by seconds —
    the ``pio-tpu status`` recompile-storm triage table."""
    with _lock:
        rows = [(name, ent[0], ent[1]) for name, ent in _compile.items()]
    return sorted(rows, key=lambda r: -r[1])[:n]


def compile_seconds_total() -> float:
    with _lock:
        return sum(ent[0] for ent in _compile.values())


def reset() -> None:
    """Test hook."""
    with _lock:
        _first_seen.clear()
        _compile.clear()


# -- /metrics fold ----------------------------------------------------------
_G_TOTAL = REGISTRY.gauge(
    "pio_jit_compile_keys",
    "Distinct serving executables built in this process (flat after warmup)")
_G_RECENT = REGISTRY.gauge(
    "pio_jit_compiles_recent",
    "Jit keys first seen within the trailing window (alert when non-zero "
    "after warmup)", labels=("window_seconds",))
_C_COMPILE_SEC = REGISTRY.counter(
    "pio_jit_compile_seconds_total",
    "Cumulative first-dispatch (compile-dominated) wall time per serving "
    "executable name — a recompile storm is SECONDS here, not just a "
    "growing key count", labels=("executable",))


def _collect() -> None:
    _G_TOTAL.set(count())
    _G_RECENT.labels(window_seconds="60").set(recent_count(60.0))


REGISTRY.add_collector("jitstats", _collect)
