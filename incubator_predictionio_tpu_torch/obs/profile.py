"""Always-on, low-overhead profiler: phase timers, a sampling wall-stack
profiler, MFU, and device-memory watermarks.

Counterpart of ``incubator_predictionio_tpu/obs/profile.py``: the same
names and metric families. What the card changes:

- **Phase timers.** ``step_scope(scope)`` times an enclosing unit of work
  (one ``fit``, one micro-batch dispatch, one per-shard search) and
  ``phase_scope(scope, phase)`` attributes slices of it to named buckets
  (``"gather"``/``"compute"``/``"h2d"``/…); :func:`record_phases` folds in
  phases a caller timed itself. Both scopes take an injectable
  :class:`~incubator_predictionio_tpu_torch.resilience.clock.Clock`, so the
  timer logic is testable on a ``FakeClock``. Callers put a :func:`fence`
  at phase edges so that queued device work is billed to the phase that
  launched it, not to whichever phase happens to wait next. On the card a
  fence synchronizes the current CUDA stream of each fenced tensor's own
  device, and nothing wider: never ``torch.cuda.synchronize()``, which
  would serialize every card of a sharded search. The conservation
  contract (tested): the sum of a scope's phase buckets stays within ~10%
  of the enclosing wall time.
- **Wall-stack sampler.** A daemon thread samples every Python thread's
  stack at ``PIO_PROFILE_HZ`` (default 0 = off) and aggregates collapsed
  stacks; the top-N lands in ``GET /profile.json`` and ``profile <url>``.
- **MFU per training step** (:func:`record_training_step`): the analytic
  flops over wall time over the card's peak, on ``pio_training_mfu``. The
  peak comes from :data:`GPU_PEAK_FLOPS`, keyed on the card's name
  (dense bf16, NVIDIA's H100 data sheet); any other card and the CPU give
  no peak, so no MFU is set (a guessed peak would make it a lie).
- **Device-memory watermark**: the high-water mark of
  :func:`~incubator_predictionio_tpu_torch.utils.tracing.device_memory_report`
  on ``pio_device_bytes_peak``, sampled at exposition time and from the
  sampler thread.

Nothing here starts CUDA: where ``torch.cuda.is_initialized()`` is False
(the port's form of the reference's ``"jax" in sys.modules`` guard) the
fence, the peak and the watermark do nothing, and the memory report covers
only the cards this process already uses.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import threading
from typing import Any, Iterator, Optional

import torch

from incubator_predictionio_tpu_torch.obs.metrics import REGISTRY
from incubator_predictionio_tpu_torch.resilience.clock import (
    SYSTEM_CLOCK,
    Clock,
)

logger = logging.getLogger(__name__)

#: env knobs (docs/configuration.md "Continuous profiler")
ENV_HZ = "PIO_PROFILE_HZ"
ENV_TOPN = "PIO_PROFILE_TOPN"
DEFAULT_TOPN = 30
#: stack frames kept per sample (leaf-first) — enough to tell call sites
#: apart without unbounded key cardinality
STACK_DEPTH = 8

#: dense bf16 peak FLOPs/s a card, keyed on a substring of
#: ``torch.cuda.get_device_name()`` (NVIDIA's H100 data sheet): the SXM card
#: reports "NVIDIA H100 80GB HBM3", the PCIe card "NVIDIA H100 PCIe".
GPU_PEAK_FLOPS = [
    ("H100 80GB HBM3", 989e12),
    ("H100 PCIe", 756e12),
]

PHASE_SECONDS = REGISTRY.counter(
    "pio_profile_phase_seconds_total",
    "Wall seconds attributed to each profiler phase bucket within a scope "
    "(gather/compute/collective/h2d/…; docs/observability.md Profiling)",
    labels=("scope", "phase"))
PHASES_TOTAL = REGISTRY.counter(
    "pio_profile_phases_total",
    "Completed profiler phase intervals per scope and phase",
    labels=("scope", "phase"))
SCOPE_SECONDS = REGISTRY.counter(
    "pio_profile_scope_seconds_total",
    "Wall seconds of enclosing profiler scopes (the denominator the phase "
    "buckets must conserve against)", labels=("scope",))
SCOPES_TOTAL = REGISTRY.counter(
    "pio_profile_scopes_total",
    "Completed enclosing profiler scopes (steps/requests/folds)",
    labels=("scope",))
SAMPLES_TOTAL = REGISTRY.counter(
    "pio_profile_samples_total",
    "Stack samples taken by the wall-stack profiler thread "
    "(PIO_PROFILE_HZ)")
MFU_GAUGE = REGISTRY.gauge(
    "pio_training_mfu",
    "Model FLOPs utilization of the most recent training step/run "
    "(analytic flops / wall / chip peak; 0 when no TPU peak is known)")
STEP_SECONDS = REGISTRY.histogram(
    "pio_training_step_seconds",
    "Wall time of training steps/runs reported to the profiler",
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
             10.0, 30.0, 60.0, 120.0))
DEVICE_PEAK = REGISTRY.gauge(
    "pio_device_bytes_peak",
    "High-water mark of accelerator memory in use per device (watermark "
    "over device_memory_report point reads)", labels=("device",))


# ---------------------------------------------------------------------------
# phase timers
# ---------------------------------------------------------------------------

_AGG_LOCK = threading.Lock()
#: scope -> {"wall_seconds", "count", "phases": {phase: {"seconds","count"}}}
_AGG: dict[str, dict[str, Any]] = {}


def _scope_entry(scope: str) -> dict[str, Any]:
    entry = _AGG.get(scope)
    if entry is None:
        entry = _AGG[scope] = {"wall_seconds": 0.0, "count": 0, "phases": {}}
    return entry


@contextlib.contextmanager
def step_scope(scope: str, clock: Clock = SYSTEM_CLOCK) -> Iterator[None]:
    """Time one enclosing unit of work (a fit, a dispatch, a fold) under
    ``scope``. Phases recorded inside via :func:`phase_scope` with the same
    scope name must sum to ~this wall time (the conservation contract)."""
    t0 = clock.monotonic()
    try:
        yield
    finally:
        dt = max(0.0, clock.monotonic() - t0)
        with _AGG_LOCK:
            entry = _scope_entry(scope)
            entry["wall_seconds"] += dt
            entry["count"] += 1
        SCOPE_SECONDS.labels(scope=scope).inc(dt)
        SCOPES_TOTAL.labels(scope=scope).inc()


@contextlib.contextmanager
def phase_scope(scope: str, phase: str,
                clock: Clock = SYSTEM_CLOCK) -> Iterator[None]:
    """Attribute the enclosed block's wall time to ``phase`` within
    ``scope``. Put a :func:`fence` on the phase's outputs before leaving
    the block so launched-but-unfinished device work bills here."""
    t0 = clock.monotonic()
    try:
        yield
    finally:
        dt = max(0.0, clock.monotonic() - t0)
        with _AGG_LOCK:
            phases = _scope_entry(scope)["phases"]
            ph = phases.get(phase)
            if ph is None:
                ph = phases[phase] = {"seconds": 0.0, "count": 0}
            ph["seconds"] += dt
            ph["count"] += 1
        PHASE_SECONDS.labels(scope=scope, phase=phase).inc(dt)
        PHASES_TOTAL.labels(scope=scope, phase=phase).inc()


def record_phases(scope: str, phases: dict[str, float],
                  wall_seconds: Optional[float] = None) -> None:
    """Fold externally measured phase durations into the same aggregates
    :func:`phase_scope` feeds — for linear pipelines that already keep
    precise per-phase timers (``TwoTowerMF.fit``'s ``model.timings``),
    where re-wrapping every block would duplicate the clock reads.
    ``wall_seconds`` defaults to the phase sum (a fully attributed step)."""
    wall = sum(phases.values()) if wall_seconds is None else wall_seconds
    with _AGG_LOCK:
        entry = _scope_entry(scope)
        entry["wall_seconds"] += max(0.0, wall)
        entry["count"] += 1
        bucket = entry["phases"]
        for phase, dt in phases.items():
            ph = bucket.get(phase)
            if ph is None:
                ph = bucket[phase] = {"seconds": 0.0, "count": 0}
            ph["seconds"] += max(0.0, dt)
            ph["count"] += 1
    SCOPE_SECONDS.labels(scope=scope).inc(max(0.0, wall))
    SCOPES_TOTAL.labels(scope=scope).inc()
    for phase, dt in phases.items():
        PHASE_SECONDS.labels(scope=scope, phase=phase).inc(max(0.0, dt))
        PHASES_TOTAL.labels(scope=scope, phase=phase).inc()


def fence(*values: Any) -> None:
    """Wait for the device work that produced each value: for a CUDA
    tensor (or a list or tuple of them), a synchronize of the current
    stream of that tensor's device, once a device. Host values and None
    pass through. Never the whole device or every device: the phase edge
    waits only for the streams that hold its outputs."""
    if not torch.cuda.is_initialized():
        return
    seen: set = set()
    stack = list(values)
    while stack:
        v = stack.pop()
        if isinstance(v, (list, tuple)):
            stack.extend(v)
        elif isinstance(v, torch.Tensor) and v.is_cuda:
            if v.device not in seen:
                seen.add(v.device)
                torch.cuda.current_stream(v.device).synchronize()


def phase_snapshot() -> dict[str, dict[str, Any]]:
    """Deep copy of the per-scope phase aggregates (``/profile.json``,
    conservation tests)."""
    with _AGG_LOCK:
        return {
            scope: {
                "wall_seconds": e["wall_seconds"],
                "count": e["count"],
                "phases": {p: dict(ph) for p, ph in e["phases"].items()},
            }
            for scope, e in _AGG.items()
        }


def reset_phases() -> None:
    """Test hook: drop the in-process aggregates (registry families are
    reset separately via ``REGISTRY.reset()``)."""
    with _AGG_LOCK:
        _AGG.clear()


# ---------------------------------------------------------------------------
# MFU + device-memory watermark
# ---------------------------------------------------------------------------

_peak_cache: list = []  # [float | None] once detected


def detected_peak_flops() -> Optional[float]:
    """Peak bf16 FLOPs/s of the current card, from :data:`GPU_PEAK_FLOPS`
    by its name. ``None`` on any card the table does not name, on the CPU
    (a CPU 'MFU' would be a lie) and where CUDA was never initialized in
    this process. Cached after the first read on an initialized card."""
    if _peak_cache:
        return _peak_cache[0]
    if not torch.cuda.is_initialized():
        return None
    try:
        name = torch.cuda.get_device_name(torch.cuda.current_device())
    except Exception:  # noqa: BLE001 - device probe must never raise here
        return None
    peak = next((f for key, f in GPU_PEAK_FLOPS if key in name), None)
    _peak_cache.append(peak)
    return peak


def record_training_step(flops: float, seconds: float,
                         peak_flops: Optional[float] = None,
                         ) -> Optional[float]:
    """Report one training step/run: observes the step-time histogram and,
    when a chip peak is known (or injected), sets ``pio_training_mfu``.
    Returns the MFU or None."""
    if seconds <= 0:
        return None
    STEP_SECONDS.observe(seconds)
    peak = peak_flops if peak_flops is not None else detected_peak_flops()
    if not peak:
        return None
    mfu = flops / seconds / peak
    MFU_GAUGE.set(mfu)
    return mfu


def update_device_watermark() -> None:
    """Fold each initialized card's current/peak bytes-in-use into the
    ``pio_device_bytes_peak`` watermark gauges. Does nothing where CUDA
    was never initialized in this process; never raises (runs as a
    collector and inside the sampler thread)."""
    if not torch.cuda.is_initialized():
        return
    try:
        from incubator_predictionio_tpu_torch.utils.tracing import (
            device_memory_report,
        )

        for row in device_memory_report():
            seen = row.get("peak_bytes_in_use")
            if seen is None:
                seen = row.get("bytes_in_use")
            if seen is None:
                continue
            g = DEVICE_PEAK.labels(device=row["device"])
            if seen > g.value:
                g.set(seen)
    except Exception:  # noqa: BLE001 - diagnostics must not break /metrics
        logger.debug("device watermark sample failed", exc_info=True)


REGISTRY.add_collector("profile_watermark", update_device_watermark)


# ---------------------------------------------------------------------------
# sampling wall-stack profiler
# ---------------------------------------------------------------------------

def _short_path(path: str) -> str:
    parts = path.replace("\\", "/").split("/")
    return "/".join(parts[-2:]) if len(parts) > 2 else path


def _collapse(frame, depth: int = STACK_DEPTH) -> tuple[str, ...]:
    """Leaf-first collapsed stack for one thread's current frame."""
    out: list[str] = []
    f = frame
    while f is not None and len(out) < depth:
        code = f.f_code
        out.append(f"{code.co_name} ({_short_path(code.co_filename)}:"
                   f"{f.f_lineno})")
        f = f.f_back
    return tuple(out)


class StackSampler:
    """Daemon thread sampling every Python thread's stack at ``hz``.

    Aggregation is in-process (collapsed stack -> count), so the profiler
    has no output files and no post-processing step: :meth:`top` is the
    deliverable. ``sample_once`` is callable directly with a fake
    ``frames`` mapping so tests exercise collapse/aggregation without
    timing."""

    def __init__(self, hz: float, topn: int = DEFAULT_TOPN,
                 depth: int = STACK_DEPTH):
        self.hz = float(hz)
        self.topn = topn
        self.depth = depth
        self.interval = 1.0 / max(0.001, self.hz)
        self.samples = 0
        self._counts: dict[tuple[str, ...], int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="pio-profile-sampler")

    def start(self) -> None:
        self._thread.start()

    def _run(self) -> None:
        # watermark ride-along at ~1 Hz regardless of the sampling rate
        wm_every = max(1, round(self.hz))
        tick = 0
        while not self._stop.wait(self.interval):
            self.sample_once()
            tick += 1
            if tick % wm_every == 0:
                update_device_watermark()

    def sample_once(self, frames: Optional[dict] = None) -> None:
        if frames is None:
            frames = sys._current_frames()
        me = threading.get_ident()
        with self._lock:
            for tid, frame in frames.items():
                if tid == me:
                    continue  # never profile the profiler
                key = _collapse(frame, self.depth)
                if key:
                    self._counts[key] = self._counts.get(key, 0) + 1
            self.samples += 1
        SAMPLES_TOTAL.inc()

    def top(self, n: Optional[int] = None) -> list[dict[str, Any]]:
        """Top-N collapsed stacks by sample count, with share of all
        attributed samples."""
        with self._lock:
            items = sorted(self._counts.items(), key=lambda kv: -kv[1])
            total = sum(self._counts.values())
            samples = self.samples
        n = self.topn if n is None else n
        return [{
            "stack": list(stack),
            "samples": count,
            "pct": round(100.0 * count / total, 2) if total else 0.0,
            "of_samples": samples,
        } for stack, count in items[:n]]

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)


# ---------------------------------------------------------------------------
# process-wide wiring
# ---------------------------------------------------------------------------

_STATE_LOCK = threading.Lock()
_SAMPLER: Optional[StackSampler] = None
_SERVICE = "proc"


def _float_env(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning("ignoring non-numeric %s=%r", name, raw)
        return default


def configure_profiler_from_env(service: str) -> Optional[StackSampler]:
    """Apply PIO_PROFILE_* to this process: start (or stop) the wall-stack
    sampler. Phase timers and the watermark collector are always on — only
    the sampler thread is gated. Idempotent; last call wins; returns the
    active sampler (None when off)."""
    global _SAMPLER, _SERVICE
    with _STATE_LOCK:
        _SERVICE = service
        if _SAMPLER is not None:
            _SAMPLER.stop()
            _SAMPLER = None
        hz = _float_env(ENV_HZ, 0.0)
        if hz <= 0:
            return None
        _SAMPLER = StackSampler(
            hz, topn=int(_float_env(ENV_TOPN, DEFAULT_TOPN)))
        _SAMPLER.start()
        logger.info("%s: wall-stack profiler on at %.3g Hz", service, hz)
        return _SAMPLER


def active_sampler() -> Optional[StackSampler]:
    return _SAMPLER


def close_profiler() -> None:
    """Stop the sampler thread (tests, bench lanes, shutdown)."""
    global _SAMPLER
    with _STATE_LOCK:
        if _SAMPLER is not None:
            _SAMPLER.stop()
            _SAMPLER = None


def profile_payload() -> dict[str, Any]:
    """The ``GET /profile.json`` document: phase aggregates, sampler top-N,
    training MFU, and device watermarks."""
    update_device_watermark()
    sampler = _SAMPLER
    return {
        "service": _SERVICE,
        "phases": phase_snapshot(),
        "sampler": None if sampler is None else {
            "hz": sampler.hz,
            "samples": sampler.samples,
            "top": sampler.top(),
        },
        "training": {
            "mfu": MFU_GAUGE.value,
            "peak_flops": _peak_cache[0] if _peak_cache else None,
        },
        "deviceWatermark": {
            "|".join(key): child.value
            for key, child in DEVICE_PEAK.children()
        },
    }


__all__ = [
    "ENV_HZ", "ENV_TOPN", "GPU_PEAK_FLOPS", "StackSampler",
    "step_scope", "phase_scope", "record_phases", "fence",
    "phase_snapshot", "reset_phases",
    "record_training_step", "detected_peak_flops",
    "update_device_watermark",
    "configure_profiler_from_env", "active_sampler", "close_profiler",
    "profile_payload",
]
