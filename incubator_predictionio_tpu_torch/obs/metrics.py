"""Process-wide metrics registry with Prometheus text-format exposition.

Counterpart of ``incubator_predictionio_tpu/obs/metrics.py``, whole:
:data:`REGISTRY` (:class:`MetricsRegistry`), its counter, gauge and
fixed-bucket histogram families, :class:`LatencyReservoir`,
:func:`nearest_rank_percentiles`, :func:`timed`,
:func:`parse_prometheus_text` and :func:`bucket_quantiles`. Every subsystem
(servers, the resilience layer, the profiler, the dispatch accounting, the
streaming, sharding and distributed tiers) registers its signals here, and
each server exposes the whole registry at ``GET /metrics`` (``obs/http.py``)
in the Prometheus text format.

Design:

- **Lock-light.** One small lock per metric child, held only around a couple
  of arithmetic ops — the serving hot path pays two short critical sections
  per request (counter inc + histogram observe), no global lock.
- **Exact quantiles.** Prometheus histograms are cumulative fixed buckets,
  which can only approximate quantiles. Each histogram child additionally
  keeps a bounded ring of raw samples, so ``percentiles()`` returns exact
  p50/p95/p99 over the retained window (same nearest-rank definition as the
  serving layer's ``LatencyReservoir``) — status pages and tests read those;
  Prometheus scrapes the buckets.
- **Collectors.** State that lives elsewhere (breaker registries, queues)
  is folded in via named collector callbacks run at exposition time, so an
  exposition never holds stale copies.

``parse_prometheus_text`` is the matching strict parser, so the emitter and
its consumers cannot drift.
"""

from __future__ import annotations

import contextlib
import logging
import math
import re
import threading
import time
from typing import Callable, Iterator, Optional, Sequence

logger = logging.getLogger(__name__)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Default latency buckets (seconds): sub-ms serving hits through multi-second
#: deadline blows. Chosen so the north-star predict p50 (~1ms, BASELINE.md)
#: lands mid-range with resolution on both sides.
DEFAULT_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class MetricError(ValueError):
    """Bad metric/label name, kind mismatch, or malformed exposition text."""


#: Exemplars older than this are dropped at exposition time: they likely
#: outlived the trace spool's retention, and a dangling exemplar sends an
#: operator to `pio-tpu trace show` for a trace nothing holds anymore.
EXEMPLAR_MAX_AGE_SEC = 600.0


def nearest_rank_percentiles(
        samples: Sequence[float],
        qs: Sequence[float] = (0.5, 0.95, 0.99)) -> dict[str, float]:
    """Exact nearest-rank quantiles over raw samples — THE quantile
    definition for the whole codebase (histogram rings here, the serving
    layer's ``LatencyReservoir``), so status pages and /metrics can never
    disagree on what p99 means."""
    if not samples:
        return {f"p{int(q * 100)}": 0.0 for q in qs}
    s = sorted(samples)
    out = {}
    for q in qs:
        idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
        out[f"p{int(q * 100)}"] = s[idx]
    return out


class LatencyReservoir:
    """Fixed-size ring of recent latencies → p50/p95/p99 on demand.

    The instrumented form of the north-star metric (BASELINE.md: predict
    p50); the reference only ever kept avg/last
    (CreateServer.scala:567-575). A general primitive — the serving layer's
    status pages and the admission layer's limiter inputs both read it —
    so it lives here rather than in the query server (its original home;
    ``server.query_server.LatencyReservoir`` remains as a re-export)."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._buf: list[float] = []
        self._pos = 0

    def record(self, seconds: float) -> None:
        if len(self._buf) < self.capacity:
            self._buf.append(seconds)
        else:
            self._buf[self._pos] = seconds
            self._pos = (self._pos + 1) % self.capacity

    def percentiles(
            self, qs: tuple[float, ...] = (0.5, 0.95, 0.99),
    ) -> dict[str, float]:
        return nearest_rank_percentiles(self._buf, qs)


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if isinstance(v, float) and v.is_integer() and abs(v) < 2 ** 53:
        return str(int(v))
    return repr(v)


def _fmt_labels(labelnames: Sequence[str], labelvalues: Sequence[str]) -> str:
    if not labelnames:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(str(v))}"'
        for k, v in zip(labelnames, labelvalues))
    return "{" + inner + "}"


class _Counter:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise MetricError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _Gauge:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _Histogram:
    """Cumulative fixed-bucket histogram + bounded raw-sample ring.

    Optionally keeps one *exemplar* per bucket — the most recent observed
    value that landed there together with the trace id that produced it
    (``observe_exemplar``) — exposed in OpenMetrics exemplar syntax so a
    p99 bucket on ``/metrics`` links straight to a showable trace
    (docs/observability.md "Exemplars")."""

    __slots__ = ("_lock", "buckets", "_counts", "_sum", "_count",
                 "_ring", "_ring_cap", "_ring_pos", "_exemplars")

    def __init__(self, buckets: Sequence[float], ring_capacity: int = 2048):
        self.buckets = tuple(buckets)  # upper bounds, ascending, no +Inf
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._ring: list[float] = []
        self._ring_cap = ring_capacity
        self._ring_pos = 0
        #: bucket index -> (value, trace_id, unix_ts); sparse
        self._exemplars: dict[int, tuple[float, str, float]] = {}

    def _bucket_idx(self, value: float) -> int:
        # bisect without the import: bucket lists are short (~14)
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                return i
        return len(self.buckets)

    def observe(self, value: float) -> None:
        idx = self._bucket_idx(value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            if len(self._ring) < self._ring_cap:
                self._ring.append(value)
            else:
                self._ring[self._ring_pos] = value
                self._ring_pos = (self._ring_pos + 1) % self._ring_cap

    def observe_exemplar(self, value: float,
                         trace_id: Optional[str] = None) -> None:
        """``observe()`` plus: when a trace is active (or ``trace_id`` is
        given), remember (value, trace id, now) as the bucket's exemplar."""
        if trace_id is None:
            # lazy import: metrics must stay importable without the trace
            # module's contextvars machinery in minimal tools
            from incubator_predictionio_tpu_torch.obs import trace as _trace

            trace_id = _trace.current_trace_id()
        self.observe(value)
        if trace_id is None:
            return
        idx = self._bucket_idx(value)
        with self._lock:
            self._exemplars[idx] = (value, trace_id, time.time())

    def exemplars(self, max_age_sec: Optional[float] = None,
                  ) -> dict[int, tuple[float, str, float]]:
        """Per-bucket exemplars, optionally dropping entries older than
        ``max_age_sec`` — an exemplar outliving the spool's retention
        would advertise a trace id nothing can show anymore."""
        with self._lock:
            snap = dict(self._exemplars)
        if max_age_sec is None:
            return snap
        cutoff = time.time() - max_age_sec
        return {idx: ex for idx, ex in snap.items() if ex[2] >= cutoff}

    @contextlib.contextmanager
    def time(self) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0)

    def percentiles(
            self, qs: Sequence[float] = (0.5, 0.95, 0.99)) -> dict[str, float]:
        """Exact nearest-rank quantiles over the retained raw samples (the
        whole history while under ring capacity)."""
        with self._lock:
            buf = list(self._ring)
        return nearest_rank_percentiles(buf, qs)

    def snapshot(self) -> tuple[list[int], float, int]:
        with self._lock:
            return list(self._counts), self._sum, self._count


_KINDS = {"counter": _Counter, "gauge": _Gauge, "histogram": _Histogram}


class Family:
    """One named metric family, optionally labeled. ``labels(**kv)`` returns
    (creating on first use) the child for one label combination; unlabeled
    families proxy the child API directly (``family.inc()``)."""

    def __init__(self, name: str, kind: str, help: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        if not _NAME_RE.match(name):
            raise MetricError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise MetricError(f"invalid label name {ln!r} for {name}")
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self._buckets = tuple(buckets)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], object] = {}
        if not self.labelnames:
            self._children[()] = self._new_child()

    def _new_child(self):
        if self.kind == "histogram":
            return _Histogram(self._buckets)
        return _KINDS[self.kind]()

    def labels(self, **kv: str):
        if set(kv) != set(self.labelnames):
            raise MetricError(
                f"{self.name}: expected labels {self.labelnames}, got "
                f"{tuple(kv)}")
        key = tuple(str(kv[ln]) for ln in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    # unlabeled convenience: family IS its single child
    def _default(self):
        if self.labelnames:
            raise MetricError(
                f"{self.name} has labels {self.labelnames}; use .labels()")
        return self._children[()]

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def set(self, value: float) -> None:
        self._default().set(value)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def observe_exemplar(self, value: float,
                         trace_id: Optional[str] = None) -> None:
        self._default().observe_exemplar(value, trace_id)

    def time(self):
        return self._default().time()

    def percentiles(self, qs: Sequence[float] = (0.5, 0.95, 0.99)):
        return self._default().percentiles(qs)

    @property
    def value(self) -> float:
        """Unlabeled counter/gauge read-through (tests, status pages)."""
        return self._default().value

    def children(self) -> list[tuple[tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())

    def clear(self) -> None:
        with self._lock:
            self._children.clear()
            if not self.labelnames:
                self._children[()] = self._new_child()

    # -- exposition -------------------------------------------------------
    def render(self, exemplars: bool = False) -> list[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} "
                         + self.help.replace("\\", "\\\\").replace("\n", "\\n"))
        lines.append(f"# TYPE {self.name} {self.kind}")
        for key, child in self.children():
            if self.kind == "histogram":
                counts, total, count = child.snapshot()
                exm = (child.exemplars(max_age_sec=EXEMPLAR_MAX_AGE_SEC)
                       if exemplars else {})
                cum = 0
                for idx, (ub, c) in enumerate(
                        zip(child.buckets + (math.inf,), counts)):
                    cum += c
                    lab = _fmt_labels(self.labelnames + ("le",),
                                      key + (_fmt_value(float(ub)),))
                    line = f"{self.name}_bucket{lab} {cum}"
                    ex = exm.get(idx)
                    if ex is not None:
                        # OpenMetrics exemplar syntax: the bucket sample,
                        # then `# {labels} value timestamp` on the same line
                        value, trace_id, ts = ex
                        line += (f' # {{trace_id="'
                                 f'{_escape_label_value(trace_id)}"}} '
                                 f"{_fmt_value(value)} {repr(float(ts))}")
                    lines.append(line)
                lab = _fmt_labels(self.labelnames, key)
                lines.append(f"{self.name}_sum{lab} {_fmt_value(total)}")
                lines.append(f"{self.name}_count{lab} {count}")
            else:
                lab = _fmt_labels(self.labelnames, key)
                lines.append(f"{self.name}{lab} {_fmt_value(child.value)}")
        return lines


class MetricsRegistry:
    """Name -> family map plus exposition-time collector callbacks."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, Family] = {}
        self._collectors: dict[str, Callable[[], None]] = {}

    def _get_or_create(self, name: str, kind: str, help: str,
                       labels: Sequence[str], **kw) -> Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labels):
                    raise MetricError(
                        f"metric {name} already registered as {fam.kind}"
                        f"{fam.labelnames}, requested {kind}{tuple(labels)}")
                return fam
            fam = self._families[name] = Family(name, kind, help, labels, **kw)
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Family:
        return self._get_or_create(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Family:
        return self._get_or_create(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS) -> Family:
        return self._get_or_create(name, "histogram", help, labels,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[Family]:
        with self._lock:
            return self._families.get(name)

    # -- collectors -------------------------------------------------------
    def add_collector(self, key: str, fn: Callable[[], None]) -> None:
        """Register (or replace) a named exposition-time callback. Keyed so a
        re-constructed server replaces its predecessor's collector instead of
        stacking a stale one."""
        with self._lock:
            self._collectors[key] = fn

    def remove_collector(self, key: str) -> None:
        with self._lock:
            self._collectors.pop(key, None)

    # -- exposition -------------------------------------------------------
    def expose(self, exemplars: bool = False) -> str:
        """The full registry as exposition text.

        Default: strict Prometheus text format 0.0.4 — NO exemplars,
        because the 0.0.4 grammar has no exemplar production and a stock
        Prometheus scraper rejects the whole page on the first ``# {...}``
        suffix. ``exemplars=True`` appends them in OpenMetrics *exemplar
        syntax* (the page stays 0.0.4 otherwise — this is pio-tpu's
        extended exposition, requested explicitly via
        ``GET /metrics?exemplars=1``, never served to a scraper that
        didn't ask; obs/http.py)."""
        with self._lock:
            collectors = list(self._collectors.items())
        for key, fn in collectors:
            try:
                fn()
            except Exception:  # noqa: BLE001 - a bad collector must not
                logger.exception("metrics collector %r failed", key)  # kill /metrics
        with self._lock:
            families = sorted(self._families.values(), key=lambda f: f.name)
        lines: list[str] = []
        for fam in families:
            lines.extend(fam.render(exemplars=exemplars))
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Zero every family's children (test isolation). Families and
        collectors registered at import time survive — module-level handles
        stay valid."""
        with self._lock:
            families = list(self._families.values())
        for fam in families:
            fam.clear()


#: The process-wide registry every subsystem shares — ONE /metrics page.
REGISTRY = MetricsRegistry()


def timed(hist):
    """``with timed(HIST.labels(route=...)):`` — observe the block's wall
    duration into a histogram child (or unlabeled family). Free-function
    spelling of ``hist.time()`` — one implementation, two idioms."""
    return hist.time()


# ---------------------------------------------------------------------------
# parser (CLI pretty-printer + format-validity tests)
# ---------------------------------------------------------------------------

# the label block is matched as a sequence of quoted pairs (not [^}]*):
# label VALUES may legally contain '}' — e.g. route="/rpc/{store}/{method}"
_LABELS_BLOCK = (r"(?:\s*[a-zA-Z_][a-zA-Z0-9_]*\s*=\s*"
                 r'"(?:[^"\\]|\\.)*"\s*,?)*')
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>" + _LABELS_BLOCK + r")\})?"
    r"\s+(?P<value>[^\s]+)"
    r"(?:\s+(?P<ts>-?\d+))?"
    # OpenMetrics exemplar: `# {labels} value [timestamp]` after the sample
    r"(?:\s+#\s+\{(?P<exlabels>" + _LABELS_BLOCK + r")\}"
    r"\s+(?P<exvalue>[^\s]+)(?:\s+(?P<exts>[^\s]+))?)?$")
_LABEL_PAIR_RE = re.compile(
    r'\s*([a-zA-Z_][a-zA-Z0-9_]*)\s*=\s*"((?:[^"\\]|\\.)*)"\s*(?:,|$)')


def _unescape(v: str) -> str:
    return v.replace('\\"', '"').replace("\\n", "\n").replace("\\\\", "\\")


def _parse_label_block(raw: Optional[str], lineno: int,
                       line: str) -> dict[str, str]:
    labels: dict[str, str] = {}
    if raw:
        pos = 0
        while pos < len(raw):
            lm = _LABEL_PAIR_RE.match(raw, pos)
            if lm is None:
                raise MetricError(
                    f"line {lineno}: malformed labels: {line!r}")
            labels[lm.group(1)] = _unescape(lm.group(2))
            pos = lm.end()
    return labels


def _parse_value(v: str, lineno: int, line: str) -> float:
    try:
        return float({"+Inf": "inf", "-Inf": "-inf", "NaN": "nan"}
                     .get(v, v))
    except ValueError:
        raise MetricError(f"line {lineno}: bad value {v!r}: {line!r}")


def parse_prometheus_text(text: str) -> dict[str, dict]:
    """Strict parse of the exposition format. Returns
    ``{family: {"type": str|None, "help": str|None,
    "samples": [(name, labels_dict, value)],
    "exemplars": [(name, labels_dict, exemplar_dict)]}}`` and raises
    :class:`MetricError` on any malformed line — the validity oracle for
    ``expose()``'s output. Exemplars (OpenMetrics ``# {...} value ts``
    suffixes on bucket samples) are surfaced in the separate ``exemplars``
    list so existing 3-tuple ``samples`` consumers never see them."""
    families: dict[str, dict] = {}

    def fam_for(name: str) -> dict:
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in families:
                base = name[: -len(suffix)]
                break
        return families.setdefault(
            base, {"type": None, "help": None, "samples": [],
                   "exemplars": []})

    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line[len("# HELP "):].split(" ", 1)
            if not parts or not _NAME_RE.match(parts[0]):
                raise MetricError(f"line {lineno}: malformed HELP: {line!r}")
            families.setdefault(
                parts[0], {"type": None, "help": None, "samples": [],
                           "exemplars": []})[
                "help"] = parts[1] if len(parts) > 1 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line[len("# TYPE "):].split()
            if len(parts) != 2 or parts[1] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                raise MetricError(f"line {lineno}: malformed TYPE: {line!r}")
            families.setdefault(
                parts[0], {"type": None, "help": None, "samples": [],
                           "exemplars": []})[
                "type"] = parts[1]
            continue
        if line.startswith("#"):
            continue  # comment
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise MetricError(f"line {lineno}: malformed sample: {line!r}")
        labels = _parse_label_block(m.group("labels"), lineno, line)
        value = _parse_value(m.group("value"), lineno, line)
        fam = fam_for(m.group("name"))
        fam["samples"].append((m.group("name"), labels, value))
        if m.group("exvalue") is not None:
            exemplar = {
                "labels": _parse_label_block(
                    m.group("exlabels"), lineno, line),
                "value": _parse_value(m.group("exvalue"), lineno, line),
                "timestamp": (_parse_value(m.group("exts"), lineno, line)
                              if m.group("exts") is not None else None),
            }
            fam["exemplars"].append((m.group("name"), labels, exemplar))
    return families


def bucket_quantiles(
        buckets: Sequence[tuple[float, float]],
        qs: Sequence[float] = (0.5, 0.95, 0.99)) -> dict[str, float]:
    """Approximate quantiles from cumulative ``(le, cumulative_count)``
    pairs, linearly interpolated within the winning bucket (the
    ``histogram_quantile`` estimate) — what the CLI pretty-printer shows for
    scraped histograms, where raw samples aren't available."""
    bs = sorted(buckets)
    out: dict[str, float] = {}
    total = bs[-1][1] if bs else 0.0
    for q in qs:
        key = f"p{int(q * 100)}"
        if total <= 0:
            out[key] = 0.0
            continue
        rank = q * total
        prev_ub, prev_cum = 0.0, 0.0
        val = bs[-1][0]
        for ub, cum in bs:
            if cum >= rank:
                span = cum - prev_cum
                frac = (rank - prev_cum) / span if span > 0 else 1.0
                lo = prev_ub if ub != math.inf else prev_ub
                hi = ub if ub != math.inf else prev_ub
                val = lo + (hi - lo) * frac
                break
            prev_ub, prev_cum = ub, cum
        out[key] = val
    return out
