"""End-to-end request tracing: contextvar-scoped trace/span IDs, a ring
buffer of recent spans served as JSON, and ``X-PIO-Trace`` header propagation.

Counterpart of ``incubator_predictionio_tpu/obs/trace.py``, whole:
:class:`SpanContext`, :class:`Span`, :class:`TraceBuffer` and
:data:`TRACES`, :func:`span`, :func:`trace_scope`, the header helpers
(:func:`header_value`, :func:`parse_header`, :func:`inject`) and the
sampling hooks (:func:`set_sampling`, :func:`keep_reason`,
:func:`set_exporter`). Pure Python; nothing here touches the card.

A *trace* is one logical request; a *span* is one timed operation inside it
(an HTTP route, a batch dispatch). The current span's identity rides a
:mod:`contextvars` variable, so it composes with the resilience layer's
``deadline_scope`` (both are ambient, both survive
``contextvars.copy_context()`` hops into worker threads) and it crosses
process boundaries via the ``X-PIO-Trace: <trace_id>:<span_id>`` header,
which the telemetry middleware (:mod:`.http`) adopts.

Every finished span lands in :data:`TRACES`, a bounded ring the servers
serve at ``GET /traces.json``. The process at the edge of a request mints a
head-based keep/drop decision when it roots a trace; the decision rides the
header as a ``:s=0|1`` suffix so every downstream hop agrees. Tail-based
keep rules (error spans, slow spans) are applied by the export hook
regardless of the head decision. The export hook is a seam: the durable
span spool that installs it is not ported yet (ROADMAP.md item 6), so
:func:`export_enabled` is False unless a caller sets one.
"""

from __future__ import annotations

import contextlib
import contextvars
import random
import threading
import time
import uuid
from collections import deque
from typing import Any, Callable, Iterator, Optional

#: Propagation header: ``<trace_id>:<span_id>[:s=0|1]`` (ids are 16 hex
#: chars; the optional third field is the head sampling decision — peers
#: that predate it simply ignore extra ``:``-separated fields).
TRACE_HEADER = "X-PIO-Trace"


class SpanContext:
    """The ambient identity: which trace we are in, which span is current,
    and whether the trace's head sampling decision said *keep*."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled


class Span:
    """One timed operation. Mutable while open (attrs, status); recorded
    into the buffer exactly once, at exit."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "service",
                 "start_unix", "duration", "status", "attrs", "sampled",
                 "_t0")

    def __init__(self, trace_id: str, span_id: str, parent_id: Optional[str],
                 name: str, service: Optional[str], attrs: dict[str, Any],
                 sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.service = service
        self.start_unix = time.time()
        self.duration = 0.0
        self.status = "ok"
        self.attrs = attrs
        self.sampled = sampled
        self._t0 = time.perf_counter()

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def to_dict(self) -> dict[str, Any]:
        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "name": self.name,
            "service": self.service,
            "startUnix": self.start_unix,
            "durationSec": self.duration,
            "status": self.status,
            "sampled": self.sampled,
            "attrs": dict(self.attrs),
        }


_CURRENT: contextvars.ContextVar[Optional[SpanContext]] = \
    contextvars.ContextVar("pio_trace_context", default=None)


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


# -- sampling + export configuration ----------------------------------------
# Process-wide, set once at boot or explicitly by tests. ``None`` rate means "not configured": every root is
# sampled, matching the pre-sampling behaviour bit for bit.

_SAMPLE_RATE: Optional[float] = None
_SLOW_SEC: Optional[float] = None
_EXPORTER: Optional[Callable[[Span], None]] = None
_SAMPLE_RNG = random.Random()


def set_sampling(rate: Optional[float] = None,
                 slow_ms: Optional[float] = None) -> None:
    """Install the head sampling rate (0..1; None = keep everything) and the
    tail slow-span threshold in milliseconds (None = no slow rule)."""
    global _SAMPLE_RATE, _SLOW_SEC
    _SAMPLE_RATE = None if rate is None else min(1.0, max(0.0, float(rate)))
    _SLOW_SEC = None if slow_ms is None else float(slow_ms) / 1e3


def sampling() -> tuple[Optional[float], Optional[float]]:
    """(rate, slow_sec) as currently configured."""
    return _SAMPLE_RATE, _SLOW_SEC


def set_exporter(fn: Optional[Callable[[Span], None]]) -> None:
    """Install (or clear) the finished-span export hook. The hook runs on
    whatever thread finished the span and MUST NOT raise — a broken export
    sink must never fail the request that produced the span."""
    global _EXPORTER
    _EXPORTER = fn


def export_enabled() -> bool:
    return _EXPORTER is not None


def _mint_sampled() -> bool:
    """The head-based decision, minted exactly once per trace — at the
    process that roots it (the edge)."""
    if _SAMPLE_RATE is None or _SAMPLE_RATE >= 1.0:
        return True
    if _SAMPLE_RATE <= 0.0:
        return False
    return _SAMPLE_RNG.random() < _SAMPLE_RATE


def keep_reason(sampled: bool, status: str, duration_sec: float,
                slow_sec: Optional[float]) -> Optional[str]:
    """Why a finished span should reach the durable spool, or None to drop.

    Tail rules outrank the head decision: ``error:*`` spans and spans over
    the slow threshold are ALWAYS kept, so 1% head sampling still captures
    100% of the interesting traces. Non-error terminal statuses (e.g. the
    middleware's ``http401`` for orderly raised 4xx) follow the head
    decision — a client hammering bad credentials must not flood the spool.
    Pure — the FakeClock-style tail-sampling tests drive it with synthetic
    durations, zero wall sleeps."""
    if status.startswith("error"):
        return "error"
    if slow_sec is not None and duration_sec >= slow_sec:
        return "slow"
    return "head" if sampled else None


def current_context() -> Optional[SpanContext]:
    return _CURRENT.get()


def current_trace_id() -> Optional[str]:
    ctx = _CURRENT.get()
    return ctx.trace_id if ctx is not None else None


class TraceBuffer:
    """Bounded ring of finished spans, grouped on demand by trace id."""

    def __init__(self, capacity: int = 2048):
        self._lock = threading.Lock()
        self._spans: deque[Span] = deque(maxlen=capacity)

    def add(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def spans(self, trace_id: Optional[str] = None) -> list[dict]:
        with self._lock:
            snap = list(self._spans)
        return [s.to_dict() for s in snap
                if trace_id is None or s.trace_id == trace_id]

    def traces(self, limit: int = 50) -> list[dict]:
        """Recent traces, newest first: one entry per trace id with its span
        tree flattened (spans in start order).

        Each entry carries ``"complete"``: the root span is present AND no
        span's ``parentId`` dangles. A trace whose older spans were evicted
        by the ring looks exactly like a short trace otherwise — the flag is
        what keeps a partial trace from being read as a whole one."""
        if limit <= 0:  # order[-limit:] would invert the meaning
            return []
        with self._lock:
            snap = list(self._spans)
        by_trace: dict[str, list[Span]] = {}
        order: list[str] = []
        for s in snap:
            if s.trace_id not in by_trace:
                by_trace[s.trace_id] = []
                order.append(s.trace_id)
            by_trace[s.trace_id].append(s)
        out = []
        for tid in reversed(order[-limit:]):
            spans = sorted(by_trace[tid], key=lambda s: s.start_unix)
            ids = {s.span_id for s in spans}
            has_root = any(s.parent_id is None for s in spans)
            dangling = any(s.parent_id is not None and s.parent_id not in ids
                           for s in spans)
            out.append({
                "traceId": tid,
                "spanCount": len(spans),
                "durationSec": max((s.duration for s in spans), default=0.0),
                "complete": has_root and not dangling,
                "spans": [s.to_dict() for s in spans],
            })
        return out

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


#: Process-wide flight recorder, served at ``GET /traces.json``.
TRACES = TraceBuffer()


@contextlib.contextmanager
def span(name: str, service: Optional[str] = None,
         buffer: Optional[TraceBuffer] = None, **attrs: Any) -> Iterator[Span]:
    """Open a span as a child of the current context (or the root of a fresh
    trace), make it current for the block, and record it on exit. An escaping
    exception marks ``status="error:<Type>"`` and re-raises."""
    parent = _CURRENT.get()
    trace_id = parent.trace_id if parent is not None else _new_id()
    parent_id = parent.span_id if parent is not None else None
    sampled = parent.sampled if parent is not None else _mint_sampled()
    sp = Span(trace_id, _new_id(), parent_id, name, service, attrs,
              sampled=sampled)
    token = _CURRENT.set(SpanContext(trace_id, sp.span_id, sampled))
    try:
        yield sp
    except BaseException as e:
        # the body may have already classified the outcome (the telemetry
        # middleware downgrades raised 4xx HTTPExceptions to a non-error
        # terminal status before they propagate) — respect it
        if sp.status == "ok":
            sp.status = f"error:{type(e).__name__}"
        raise
    finally:
        sp.duration = time.perf_counter() - sp._t0
        _CURRENT.reset(token)
        (buffer or TRACES).add(sp)
        exporter = _EXPORTER
        if exporter is not None:
            exporter(sp)


@contextlib.contextmanager
def trace_scope(ctx: Optional[SpanContext]) -> Iterator[None]:
    """Force the ambient context for a block — how a server middleware adopts
    a remote parent parsed from ``X-PIO-Trace`` (``ctx=None`` is a no-op, not
    a reset: spans below still start a fresh trace naturally)."""
    if ctx is None:
        yield
        return
    token = _CURRENT.set(ctx)
    try:
        yield
    finally:
        _CURRENT.reset(token)


# -- header propagation -----------------------------------------------------

def header_value() -> Optional[str]:
    """The outbound ``X-PIO-Trace`` value for the current context, or None
    when no trace is active (callers simply omit the header). Carries the
    head sampling decision as ``:s=0|1`` — peers that predate the flag only
    read the first two ``:`` fields and ignore the rest."""
    ctx = _CURRENT.get()
    if ctx is None:
        return None
    return f"{ctx.trace_id}:{ctx.span_id}:s={1 if ctx.sampled else 0}"


def parse_header(value: Optional[str]) -> Optional[SpanContext]:
    """``<trace_id>:<span_id>[:s=0|1]`` (or bare ``<trace_id>``) →
    SpanContext. Malformed values are ignored — a bad header must never
    fail a request. An absent/unparseable ``s=`` flag means *sampled*: a
    header from an old peer keeps today's keep-everything behaviour."""
    if not value:
        return None

    def ok(s: str) -> bool:
        # ASCII-only: isalnum() alone admits non-ASCII "alphanumerics" that
        # http.client cannot latin-1-encode when the id is re-injected into
        # outbound headers — a crafted header must never fail a request
        return 0 < len(s) <= 64 and s.isascii() and s.isalnum()

    parts = value.strip().split(":")
    tid = parts[0]
    if not ok(tid):
        return None
    sid = parts[1] if len(parts) > 1 and parts[1] else tid
    if not ok(sid):
        return None
    sampled = True
    for extra in parts[2:]:
        if extra == "s=0":
            sampled = False
        elif extra == "s=1":
            sampled = True
        # anything else: a future field this version doesn't know — ignore
    return SpanContext(tid, sid, sampled)


def inject(headers) -> None:
    """Set ``X-PIO-Trace`` on a mutable mapping when a trace is active."""
    v = header_value()
    if v is not None:
        headers[TRACE_HEADER] = v
