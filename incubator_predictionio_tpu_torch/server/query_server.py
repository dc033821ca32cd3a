"""Engine (query) server — the ``pio deploy`` surface.

Counterpart of ``incubator_predictionio_tpu/server/query_server.py``
(workflow/CreateServer.scala:106-695): :class:`ServerConfig`,
:class:`DeployedEngine` (prepare + warmup + predict / batch predict behind
per-algorithm circuit breakers and an algorithm deadline),
:class:`MicroBatcher` (deadline eviction at batch assembly, live resize),
:func:`load_deployed_engine` and :class:`QueryServer` with its routes:

- ``GET /`` and ``GET /health`` — status; liveness, breakers, admission,
  drain state and the deployment's reload/probation/streaming position;
- ``POST /queries.json`` — the hot path, through the reference's door
  order: admission (429), brownout (degraded 200), the serving breaker,
  the micro-batcher, 504 eviction, the degraded backstop;
- ``POST /reload`` — the latest COMPLETED instance loaded beside the live
  one, gated by smoke queries, swapped in with the previous instance
  pinned for a probation window (a serving-breaker trip inside it rolls
  back); ``POST /rollback`` restores the pinned instance by hand;
- ``POST /delta`` — streaming deltas through the same discipline;
- ``POST /stop`` (graceful drain) and ``GET /plugins.json``;
- ``GET /metrics``, ``/traces.json``, ``/profile.json``
  (``obs/http.py``), every route behind the telemetry middleware;

and :func:`serve_forever` (the CLI ``deploy`` verb, SIGTERM → drain).

Models become device-resident once at deploy: ``prepare_for_serving(ctx)``
receives the server's :class:`DeviceContext`, so the served tables land on
its device (the reference's models ask JAX for the platform instead).
Predictions come back as host objects, so the wall clocks the adaptive
limiter, ``X-PIO-Server-Timing`` and the ``serve.batch`` profiler phases
read around ``predict_batch`` cover the device work with no fence. Not
ported here: the span spool, the performance plane and the SLO block of
``/health`` (the next part of ROADMAP.md item 6), feedback events, TLS and
``--log-url`` shipping (the rest of item 6), the shard-owner routes, the
native HTTP front and tenants (item 7).
"""

from __future__ import annotations

import asyncio
import collections
import contextvars
import dataclasses
import datetime as _dt
import hashlib
import json
import logging
import os
import threading
import time
from typing import Any, Optional

from aiohttp import web

from incubator_predictionio_tpu_torch.core.controller import (
    Engine,
    EngineParams,
    resolve_engine_factory,
    variant_from_file,
)
from incubator_predictionio_tpu_torch.data.storage.base import EngineInstance
from incubator_predictionio_tpu_torch.data.storage.registry import (
    Storage,
    get_storage,
)
from incubator_predictionio_tpu_torch.obs import profile as _profile
from incubator_predictionio_tpu_torch.obs.http import (
    add_observability_routes,
    telemetry_middleware,
)
from incubator_predictionio_tpu_torch.obs.metrics import (
    REGISTRY,
    LatencyReservoir,
)
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext
from incubator_predictionio_tpu_torch.resilience.admission import (
    BROWNOUT,
    REJECT,
    AdmissionConfig,
    AdmissionController,
    ShedExpired,
)
from incubator_predictionio_tpu_torch.resilience.breaker import (
    BREAKERS,
    CircuitBreaker,
    CircuitOpenError,
    publish_breaker_metrics,
)
from incubator_predictionio_tpu_torch.resilience.clock import (
    SYSTEM_CLOCK,
    Clock,
)
from incubator_predictionio_tpu_torch.resilience.policy import (
    DeadlineExceeded,
    ServingUnavailable,
    run_with_deadline,
)
from incubator_predictionio_tpu_torch.server.lifecycle import (
    DrainState,
    drained_exit_deadline,
    install_signal_drain,
    wait_for,
)
from incubator_predictionio_tpu_torch.server.plugins import (
    apply_output_plugins,
)
from incubator_predictionio_tpu_torch.streaming.stream_metrics import (
    APPLIED as _STREAM_APPLIED,
)
from incubator_predictionio_tpu_torch.streaming.stream_metrics import (
    DEDUPED as _STREAM_DEDUPED,
)
from incubator_predictionio_tpu_torch.streaming.stream_metrics import (
    STALENESS as _STREAM_STALENESS,
)
from incubator_predictionio_tpu_torch.utils import jitstats
from incubator_predictionio_tpu_torch.utils.json_util import (
    bind_query,
    to_jsonable,
)
from incubator_predictionio_tpu_torch.utils.serialization import (
    deserialize_model,
)

logger = logging.getLogger(__name__)

#: largest streaming delta body ``POST /delta`` reads; every other route
#: keeps aiohttp's 1 MiB default
DELTA_MAX_BYTES = 64 << 20

#: query-semantic rejections: the query is bad, not the engine (→ 400)
_BAD_QUERY = (TypeError, ValueError, KeyError)

_DEGRADED = REGISTRY.counter(
    "pio_serving_degraded_total",
    "Queries answered from the degradation path (last-good cache / serving "
    "default) instead of a live prediction")
_G_REQUESTS = REGISTRY.gauge(
    "pio_serving_requests", "Successfully served queries (this process)")
_G_BATCHES = REGISTRY.gauge(
    "pio_serving_batches", "Micro-batches dispatched to the device")
_G_MAX_BATCH = REGISTRY.gauge(
    "pio_serving_max_batch_seen", "Largest micro-batch coalesced so far")
_G_LATENCY_Q = REGISTRY.gauge(
    "pio_serving_latency_seconds",
    "Serving latency split into its terms (exact reservoir quantiles)",
    labels=("stage", "quantile"))
_G_DEV_MEM = REGISTRY.gauge(
    "pio_device_bytes_in_use",
    "Accelerator memory in use (the device_memory_report fold)",
    labels=("device",))
_ROLLBACKS = REGISTRY.counter(
    "pio_deploy_rollbacks_total",
    "Reloads rejected by the smoke-query gate or auto-rolled back during "
    "the post-swap probation window (docs/resilience.md)")
_H_TEMPLATE_BATCH = REGISTRY.histogram(
    "pio_serving_template_batch_size",
    "Live queries per coalesced batch_predict dispatch, per algorithm class "
    "— proves the micro-batcher's coalescing reaches the vectorized "
    "template paths (docs/serving.md)",
    labels=("template",),
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0))

#: per-algorithm wall times of the current dispatch, set by ``predict_batch``
#: and read back from the SAME Context object after ``Context.run`` returns
#: (writes inside ``ctx.run`` persist in ``ctx``): per-dispatch state with
#: no shared attribute, so overlapping dispatches can never swap timings
_DISPATCH_ALGO_TIMES: contextvars.ContextVar[list] = contextvars.ContextVar(
    "pio_dispatch_algo_times")


@dataclasses.dataclass
class ServerConfig:
    """(CreateServer.scala:106-175 flags; the reference's defaults, and its
    ``PIO_ADMISSION_*`` / ``PIO_BROWNOUT_*`` environment defaults)"""

    engine_variant: str = "engine.json"
    ip: str = "0.0.0.0"
    port: int = 8000
    # guards /reload, /rollback, /stop and /delta
    server_access_key: Optional[str] = None
    max_batch: int = 64  # micro-batch cap for /queries.json (1 = no batching)
    # concurrent dispatches; None = auto (2 when every deployed algorithm
    # declares ``serving_thread_safe``, else 1); an int overrides
    max_in_flight: Optional[int] = None
    # -- graceful degradation ---------------------------------------------
    # total per-query budget: a query still unanswered after it gets a
    # degraded-but-valid 200 (last-good cache or the serving default); a
    # query whose budget expires while queued is shed with 504. None
    # disables both.
    query_timeout_sec: Optional[float] = None
    # per-algorithm deadline: a slower answer counts a breaker failure
    algo_deadline_sec: Optional[float] = None
    # consecutive failures before an algorithm's (and the serving) breaker
    # opens, and how long it stays open before a half-open probe
    algo_breaker_threshold: int = 3
    algo_breaker_reset_sec: float = 10.0
    # -- crash-safe model lifecycle ---------------------------------------
    # payloads the /reload and /delta gate runs against the NEW engine
    # before it may serve; any failure keeps the live one (409)
    smoke_queries: tuple = ()
    # seconds after a swap during which a serving-breaker trip rolls back
    # to the pinned previous engine; 0 disables (nothing is pinned)
    reload_probation_sec: float = 30.0
    # -- overload protection (resilience/admission.py) --------------------
    admission_max_queue: int = dataclasses.field(
        default_factory=lambda: int(
            os.environ.get("PIO_ADMISSION_MAX_QUEUE", "256")))
    admission_adaptive: bool = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "PIO_ADMISSION_ADAPTIVE", "1") != "0")
    admission_target_ms: Optional[float] = dataclasses.field(
        default_factory=lambda: (
            float(os.environ["PIO_ADMISSION_TARGET_MS"])
            if os.environ.get("PIO_ADMISSION_TARGET_MS") else None))
    brownout_enter_frac: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("PIO_BROWNOUT_ENTER_FRAC", "0.5")))
    brownout_enter_sec: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("PIO_BROWNOUT_ENTER_SEC", "1.0")))
    brownout_exit_sec: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("PIO_BROWNOUT_EXIT_SEC", "2.0")))


class DeployedEngine:
    """Holds the live models + stages for one engine instance, with one
    circuit breaker per algorithm (their lifetime is this deployment's, so
    they stay out of the process-wide :data:`BREAKERS`)."""

    def __init__(
        self,
        engine: Engine,
        engine_params: EngineParams,
        instance: EngineInstance,
        models: list[Any],
        ctx: Optional[DeviceContext] = None,
        max_batch: int = 64,
        warmup: bool = True,
        algo_deadline: Optional[float] = None,
        breaker_threshold: int = 3,
        breaker_reset: float = 10.0,
        clock: Clock = SYSTEM_CLOCK,
    ):
        self.engine = engine
        self.engine_params = engine_params
        self.instance = instance
        algorithms, serving = engine.serving_and_algorithms(engine_params)
        self.algorithms = algorithms
        self.serving = serving
        self.models = [self._prepare(m, ctx) for m in models]
        self.query_cls = next(
            (a.query_class() for a in algorithms if a.query_class() is not None), None
        )
        self.algo_deadline = algo_deadline
        self._clock = clock
        self.algo_breakers = [
            CircuitBreaker(f"algorithm:{i}:{type(a).__name__}",
                           failure_threshold=breaker_threshold,
                           reset_timeout=breaker_reset, clock=clock)
            for i, a in enumerate(algorithms)
        ]
        if warmup:
            self.warmup(max_batch)

    @staticmethod
    def _prepare(model, ctx: Optional[DeviceContext]):
        """Models exposing ``prepare_for_serving(ctx)`` become resident on
        the context's device here."""
        prep = getattr(model, "prepare_for_serving", None)
        return prep(ctx) if callable(prep) else model

    def warmup(self, max_batch: int) -> None:
        """Dispatch every serving batch bucket once at deploy time."""
        for m in self.models:
            w = getattr(m, "warmup", None)
            if callable(w):
                w(max_batch)

    def _record_algo_timing(self, idx: int, took: float) -> None:
        """A completed call slower than the algorithm deadline still counts
        as a breaker failure."""
        brk = self.algo_breakers[idx]
        if self.algo_deadline is not None and took > self.algo_deadline:
            brk.record_failure()
        else:
            brk.record_success()

    def _record_batch_outcome(self, ai: int, results: dict[int, Any],
                              took: float, single_call: bool) -> None:
        """Breaker verdict for one algorithm's share of a batch: healthy if
        ANY query got a prediction, healthy if every failure is
        query-semantic, failing only when every query died with an
        infrastructure-class error."""
        vals = list(results.values())
        if any(not isinstance(v, Exception) for v in vals):
            if single_call:
                self._record_algo_timing(ai, took)
            else:
                self.algo_breakers[ai].record_success()
        elif vals and all(isinstance(v, _BAD_QUERY) for v in vals):
            self.algo_breakers[ai].record_success()
        else:
            self.algo_breakers[ai].record_failure()

    def _live_algorithms(self) -> list[int]:
        live = [i for i in range(len(self.algorithms))
                if self.algo_breakers[i].allow()]
        if not live:
            raise ServingUnavailable(
                "all algorithms have open circuit breakers")
        return live

    def predict(self, payload: dict) -> Any:
        query = self.serving.supplement(bind_query(self.query_cls, payload))
        predictions = []
        live = self._live_algorithms()
        # _live_algorithms admitted a (possibly half-open probe) slot on
        # every live breaker: if an early algorithm raises, the later ones
        # never get an outcome, so their slots are handed back
        pending = set(live)
        try:
            for i in live:
                t0 = self._clock.monotonic()
                try:
                    predictions.append(
                        self.algorithms[i].predict(self.models[i], query))
                except _BAD_QUERY:
                    # a query-semantic rejection: the algorithm is healthy
                    pending.discard(i)
                    self.algo_breakers[i].record_success()
                    raise
                except Exception:
                    pending.discard(i)
                    self.algo_breakers[i].record_failure()
                    raise
                pending.discard(i)
                self._record_algo_timing(i, self._clock.monotonic() - t0)
        finally:
            for j in pending:
                self.algo_breakers[j].release_probe()
        return self.serving.serve(query, predictions)

    def predict_batch(self, payloads: list[dict]) -> list[Any]:
        """One ``batch_predict`` dispatch per live algorithm for the whole
        batch. Returns one result OR exception per payload: a query that
        fails to bind fails alone; an algorithm whose batch raises is
        retried query by query, so only the offender fails; algorithms
        whose breaker is open are skipped, and a query no algorithm could
        answer carries its first error."""
        out: list[Any] = [None] * len(payloads)
        bound: list[Any] = [None] * len(payloads)
        for i, p in enumerate(payloads):
            try:
                bound[i] = self.serving.supplement(bind_query(self.query_cls, p))
            except _BAD_QUERY as e:
                out[i] = e
        live = [i for i in range(len(payloads)) if out[i] is None]
        if not live:
            return out
        try:
            algo_live = self._live_algorithms()
        except ServingUnavailable as e:
            for i in live:
                out[i] = e
            return out
        per_algo: dict[int, dict[int, Any]] = {}
        algo_times: list[tuple[str, float]] = []
        for ai in algo_live:
            a, m = self.algorithms[ai], self.models[ai]
            _H_TEMPLATE_BATCH.labels(template=type(a).__name__).observe(
                len(live))
            t0 = self._clock.monotonic()
            healed = False
            try:
                got = dict(a.batch_predict(m, [(i, bound[i]) for i in live]))
                for i in live:
                    if i not in got:
                        healed = True
                        try:
                            got[i] = a.predict(m, bound[i])
                        except Exception as e:  # noqa: BLE001
                            got[i] = e
                per_algo[ai] = {i: got[i] for i in live}
            except Exception:  # noqa: BLE001 - isolate the failing query
                healed = True
                singles: dict[int, Any] = {}
                for i in live:
                    try:
                        singles[i] = a.predict(m, bound[i])
                    except Exception as e:  # noqa: BLE001
                        singles[i] = e
                per_algo[ai] = singles
            took = self._clock.monotonic() - t0
            algo_times.append((f"algo{ai}.{type(a).__name__}", took))
            # the per-call deadline judges one call only: a single-query
            # batch with no heals
            self._record_batch_outcome(
                ai, per_algo[ai], took,
                single_call=(len(live) == 1 and not healed))
        _DISPATCH_ALGO_TIMES.set(algo_times)
        for i in live:
            preds, first_err = [], None
            for ai in algo_live:
                v = per_algo[ai][i]
                if isinstance(v, Exception):
                    first_err = first_err or v
                else:
                    preds.append(v)
            if not preds:
                out[i] = first_err or ServingUnavailable(
                    "no algorithm produced a prediction")
                continue
            try:
                out[i] = self.serving.serve(bound[i], preds)
            except Exception as e:  # noqa: BLE001 - the query's own error
                out[i] = e
        return out


class _Delivered:
    """What the dispatcher resolves futures with: the payload's result plus
    the batch's per-algorithm timings (a distinct type, so a prediction
    that is a tuple is never mistaken for it); error paths deliver bare
    exceptions."""

    __slots__ = ("result", "algo_times")

    def __init__(self, result: Any, algo_times: list):
        self.result = result
        self.algo_times = algo_times


class MicroBatcher:
    """Continuous micro-batching for the query hot path.

    Requests enqueue; a single drainer coalesces everything that arrived
    while the previous batch was dispatched into ONE ``predict_batch`` call
    (capped at ``max_batch``). No artificial wait: an idle server serves
    single queries at single-query latency. Batches run in a worker thread
    so the event loop keeps accepting requests, and up to ``max_in_flight``
    batches overlap.

    Each request is tagged with its deadline at enqueue; batch assembly
    evicts entries whose deadline already passed (their futures resolve
    :class:`ShedExpired` → 504) instead of dispatching dead work. Deadline
    decisions run on the injected clock. ``queue_delay`` (submit → batch
    assembly) and ``dispatch_sec`` (assembly → results) split the latency
    into its two terms.
    """

    def __init__(self, deployed: DeployedEngine, max_batch: int = 64,
                 max_in_flight: int = 2,
                 deadline_sec: Optional[float] = None,
                 clock: Clock = SYSTEM_CLOCK,
                 admission: Optional[AdmissionController] = None):
        self.deployed = deployed
        self.max_batch = max_batch
        self.max_in_flight = max_in_flight
        self.deadline_sec = deadline_sec
        self._clock = clock
        self._admission = admission  # shed bookkeeping only (may be None)
        self.queue: asyncio.Queue = asyncio.Queue()
        self.batches_served = 0
        self.max_batch_seen = 0
        self.shed_expired = 0
        self.queue_delay = LatencyReservoir()
        self.dispatch_sec = LatencyReservoir()
        self._task: Optional[asyncio.Task] = None
        self._sem: Optional[asyncio.Semaphore] = None
        self._inflight: set[asyncio.Task] = set()
        self._stopped = False

    def start(self) -> None:
        if self._stopped:
            raise RuntimeError("server shutting down")
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._drain())

    async def stop(self) -> None:
        """Cancel the drainer and fail everything still queued."""
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        while True:
            try:
                entry = self.queue.get_nowait()
            except asyncio.QueueEmpty:
                break
            fut = entry[1]
            if not fut.done():
                fut.set_result(RuntimeError("server shutting down"))

    async def submit(self, payload: dict) -> Any:
        return (await self.submit_timed(payload))[0]

    async def submit_timed(self, payload: dict) -> tuple[Any, list]:
        """Submit and also return the dispatch's per-algorithm wall times
        (the ``X-PIO-Server-Timing`` source), per call."""
        self.start()
        fut = asyncio.get_running_loop().create_future()
        deadline_at = (self._clock.monotonic() + self.deadline_sec
                       if self.deadline_sec is not None else None)
        await self.queue.put((payload, fut, time.perf_counter(),
                              contextvars.copy_context(), deadline_at))
        try:
            got = await fut
        except asyncio.CancelledError:
            # the waiter is gone: assembly drops the abandoned entry
            # without counting a shed the caller never saw
            fut.cancel()
            raise
        if isinstance(got, _Delivered):
            result, algo_times = got.result, got.algo_times
        else:
            result, algo_times = got, []
        if isinstance(result, Exception):
            raise result
        return result, algo_times

    async def resize(self, n: int) -> None:
        """Resize the dispatch-slot semaphore live: growing releases slots
        at once; shrinking acquires the excess, waiting out in-flight
        dispatches, so the new bound is real."""
        n = max(1, n)
        delta = n - self.max_in_flight
        self.max_in_flight = n
        if self._sem is None or delta == 0:  # drainer not started yet
            return
        if delta > 0:
            for _ in range(delta):
                self._sem.release()
        else:
            for _ in range(-delta):
                await self._sem.acquire()

    async def _drain(self) -> None:
        loop = asyncio.get_running_loop()
        sem = self._sem = asyncio.Semaphore(self.max_in_flight)
        try:
            while True:
                # slot FIRST, assemble SECOND: requests that arrive while we
                # wait for a free dispatch slot coalesce into this batch
                await sem.acquire()
                try:
                    batch = [await self.queue.get()]
                except asyncio.CancelledError:
                    sem.release()
                    raise
                t_phase = time.perf_counter()
                while len(batch) < self.max_batch:
                    try:
                        batch.append(self.queue.get_nowait())
                    except asyncio.QueueEmpty:
                        break
                now = time.perf_counter()
                for entry in batch:
                    self.queue_delay.record(now - entry[2])
                t_assemble, t_phase = now - t_phase, now
                batch = self._evict_expired(batch)
                t_mask = time.perf_counter() - t_phase
                if not batch:
                    # the whole assembly was dead on arrival: hand the slot
                    # back and keep draining
                    sem.release()
                    continue
                self.batches_served += 1
                self.max_batch_seen = max(self.max_batch_seen, len(batch))
                task = loop.create_task(
                    self._dispatch(loop, batch, t_assemble, t_mask))
                self._inflight.add(task)
                task.add_done_callback(self._inflight.discard)
                task.add_done_callback(lambda _t: sem.release())
        except asyncio.CancelledError:
            for task in list(self._inflight):
                task.cancel()
            for task in list(self._inflight):
                try:
                    await task
                except (asyncio.CancelledError, Exception):  # noqa: BLE001
                    pass
            raise

    def _evict_expired(self, batch: list) -> list:
        """The 504-evict step of the shedding order: entries whose deadline
        passed while they queued resolve :class:`ShedExpired` instead of
        riding the dispatch; abandoned entries are dropped uncounted."""
        now = self._clock.monotonic()
        live = []
        shed = 0
        for entry in batch:
            if entry[1].done():
                continue
            deadline_at = entry[4] if len(entry) > 4 else None
            if deadline_at is not None and now >= deadline_at:
                shed += 1
                entry[1].set_result(ShedExpired(
                    "deadline expired before dispatch"))
            else:
                live.append(entry)
        if shed:
            self.shed_expired += shed
            if self._admission is not None:
                self._admission.on_shed_expired(shed)
        return live

    async def _dispatch(self, loop, batch,
                        t_assemble: float = 0.0, t_mask: float = 0.0) -> None:
        t0 = time.perf_counter()
        payloads = [entry[0] for entry in batch]
        # run_in_executor does not copy contextvars: run_with_deadline
        # re-establishes the deadline scope in the worker thread, inside the
        # first request's captured context
        ctx = batch[0][3]
        try:
            results = await loop.run_in_executor(
                None, ctx.run, run_with_deadline, self.deadline_sec,
                self.deployed.predict_batch, payloads)
        except asyncio.CancelledError:
            for entry in batch:
                if not entry[1].done():
                    entry[1].set_result(RuntimeError("server shutting down"))
            raise
        except Exception as e:  # noqa: BLE001 - keep serving
            results = [e] * len(batch)
        t_dispatch = time.perf_counter() - t0
        self.dispatch_sec.record(t_dispatch)
        algo_times = ctx.get(_DISPATCH_ALGO_TIMES, [])
        t_merge = time.perf_counter()
        for entry, r in zip(batch, results):
            if not entry[1].done():
                entry[1].set_result(_Delivered(r, algo_times))
        # the profiler's phases of this batch's life (reference
        # query_server.py:716-723): coalesce (assemble), deadline eviction
        # (mask), the predict round trip (dispatch: predict_batch returns
        # host objects, so the card's work is inside it and needs no
        # fence), future resolution (merge)
        _profile.record_phases("serve.batch", {
            "assemble": t_assemble, "mask": t_mask, "dispatch": t_dispatch,
            "merge": time.perf_counter() - t_merge,
        })


def load_deployed_engine(
    config: ServerConfig,
    storage: Optional[Storage] = None,
    ctx: Optional[DeviceContext] = None,
    warmup: bool = True,
) -> DeployedEngine:
    """variant → engine factory → latest COMPLETED instance → live models
    (createServerActorWithEngine, CreateServer.scala:187-246); ``warmup``
    False skips the deploy-time dispatch of every batch bucket."""
    storage = storage or get_storage()
    ctx = ctx or DeviceContext.create()
    variant = variant_from_file(config.engine_variant)
    engine = resolve_engine_factory(variant["engineFactory"])()
    engine_params = engine.engine_params_from_variant(variant)
    instance = storage.get_meta_data_engine_instances().get_latest_completed(
        variant.get("id", "default"), variant.get("version", "1"),
        os.path.abspath(config.engine_variant),
    )
    if instance is None:
        raise RuntimeError(
            f"No COMPLETED engine instance for variant {config.engine_variant}; "
            "run train first (reference: CreateServer.scala:199 'Invalid engine instance')"
        )
    blob = storage.get_model_data_models().get(instance.id)
    if blob is None:
        raise RuntimeError(f"model blob missing for instance {instance.id}")
    persisted = deserialize_model(blob.models)
    models = engine.prepare_deploy(ctx, engine_params, persisted, instance.id)
    logger.info("deployed engine instance %s (trained %s) on %s", instance.id,
                instance.start_time, ctx.device)
    return DeployedEngine(engine, engine_params, instance, models, ctx,
                          max_batch=config.max_batch, warmup=warmup,
                          algo_deadline=config.algo_deadline_sec,
                          breaker_threshold=config.algo_breaker_threshold,
                          breaker_reset=config.algo_breaker_reset_sec)


def effective_max_in_flight(config: ServerConfig, deployed: DeployedEngine) -> int:
    """Dispatches that may overlap: ``max_batch=1`` serializes; an explicit
    ``max_in_flight`` wins; otherwise 2 when every deployed algorithm
    declares ``serving_thread_safe`` (host prep of one batch then overlaps
    the device time of the other), else 1."""
    if config.max_batch == 1:
        return 1
    if config.max_in_flight is not None:
        return max(1, config.max_in_flight)
    safe = all(getattr(a, "serving_thread_safe", False)
               for a in deployed.algorithms)
    return 2 if safe else 1


class QueryServer:
    """The engine server. ``deployed`` skips storage loading (tests inject
    hand-built engines); ``clock`` drives every breaker, deadline,
    admission and probation decision, so a :class:`FakeClock` scripts them
    without sleeps."""

    def __init__(
        self,
        config: ServerConfig,
        storage: Optional[Storage] = None,
        ctx: Optional[DeviceContext] = None,
        deployed: Optional[DeployedEngine] = None,
        clock: Clock = SYSTEM_CLOCK,
        name: str = "query_server",
    ):
        self.config = config
        self.name = name
        self._clock = clock
        self.storage = storage or get_storage()
        self.ctx = ctx or DeviceContext.create()
        self.deployed = deployed or load_deployed_engine(
            config, self.storage, self.ctx)
        # the door policy for query traffic: bounded queue + deadline
        # feasibility (429), brownout (degraded 200s), and the adaptive
        # limiter that live-resizes dispatch slots. Health, reload and the
        # other control routes never pass it.
        bound = effective_max_in_flight(config, self.deployed)
        self._admission = AdmissionController(
            AdmissionConfig(
                max_queue=config.admission_max_queue,
                deadline_sec=config.query_timeout_sec,
                adaptive=config.admission_adaptive,
                max_inflight=bound,
                target_latency_sec=(
                    config.admission_target_ms / 1e3
                    if config.admission_target_ms is not None else None),
                brownout_enter_frac=config.brownout_enter_frac,
                brownout_enter_sec=config.brownout_enter_sec,
                brownout_exit_sec=config.brownout_exit_sec,
            ), clock=clock, server=name)
        self.batcher = MicroBatcher(
            self.deployed, max_batch=config.max_batch, max_in_flight=bound,
            deadline_sec=config.query_timeout_sec, clock=clock,
            admission=self._admission)
        self._resize_tasks: set[asyncio.Task] = set()  # strong refs
        self.request_count = 0
        self.avg_serving_sec = 0.0
        self.last_serving_sec = 0.0
        self.latency = LatencyReservoir()
        # the breaker over the whole predict path: after repeated timeouts
        # or unavailability a dead engine answers degraded at once (on the
        # system clock, as the reference's is)
        self._serving_breaker = CircuitBreaker(
            "serving", failure_threshold=config.algo_breaker_threshold,
            reset_timeout=config.algo_breaker_reset_sec)
        # last-good answers keyed by a digest of the query (bounded LRU);
        # _degraded_result runs in executor threads, hence the lock
        self._last_good: dict[str, Any] = {}
        self._last_good_lock = threading.Lock()
        self._LAST_GOOD_MAX = 1024
        self.degraded_count = 0
        # the previous engine stays pinned through the probation window
        # after a swap, so a breaker trip can restore it
        self._previous: Optional[DeployedEngine] = None
        self._probation_until: Optional[float] = None
        self._rollback_count = 0
        self._last_reload: dict = {"status": "initial",
                                   "instanceId": self.deployed.instance.id}
        # streaming delta state: which [from_seq, to_seq) range of the
        # updater's chain this replica has applied; None until the first
        # delta lands (or after a full /reload). Snapshotted with the
        # probation pin, so a rollback restores the matching position.
        self._delta_state: Optional[dict] = None
        self._previous_delta_state: Optional[dict] = None
        # one delta at a time: the chain checks must still hold when the
        # delta-applied engine is swapped in
        self._delta_lock = asyncio.Lock()
        #: server-side seconds of the latest applied deltas: build the
        #: delta-applied engine (copy, prepare on the device), gate, swap
        self.delta_apply_s: collections.deque = collections.deque(maxlen=1024)
        self._drain_state = DrainState(name)
        self._start_time = self._clock.monotonic()
        self._runner: Optional[web.AppRunner] = None
        self._stop_event = asyncio.Event()
        REGISTRY.add_collector(name, self._collect_metrics)

    def _collect_metrics(self) -> None:
        """Exposition-time fold: this server's breakers, counters, latency
        reservoirs, streaming staleness and the cards' memory."""
        breakers = {b.name: b.snapshot() for b in self.deployed.algo_breakers}
        breakers["serving"] = self._serving_breaker.snapshot()
        publish_breaker_metrics(breakers)
        _G_REQUESTS.set(self.request_count)
        _G_BATCHES.set(self.batcher.batches_served)
        _G_MAX_BATCH.set(self.batcher.max_batch_seen)
        self._admission.publish(self.batcher.queue.qsize())
        for stage, res in (("total", self.latency),
                           ("queue_delay", self.batcher.queue_delay),
                           ("dispatch", self.batcher.dispatch_sec)):
            for q, v in res.percentiles().items():
                _G_LATENCY_Q.labels(stage=stage, quantile=q).set(v)
        stream = self._streaming_health()
        if stream is not None and stream.get("stalenessSeconds") is not None:
            _STREAM_STALENESS.set(stream["stalenessSeconds"])
        try:
            # the cards this process initialized (none on a CPU server:
            # the report never starts CUDA)
            from incubator_predictionio_tpu_torch.utils.tracing import (
                device_memory_report,
            )

            for row in device_memory_report():
                if row["bytes_in_use"] is not None:
                    _G_DEV_MEM.labels(device=row["device"]).set(
                        row["bytes_in_use"])
        except Exception:  # noqa: BLE001 - stats are best-effort
            logger.debug("device memory fold failed", exc_info=True)

    # -- routes -------------------------------------------------------------
    def make_app(self) -> web.Application:
        app = web.Application(
            middlewares=[telemetry_middleware("query_server")])
        app.router.add_get("/", self.handle_status)
        app.router.add_get("/health", self.handle_health)
        add_observability_routes(app)
        app.router.add_post("/queries.json", self.handle_query)
        app.router.add_post("/reload", self.handle_reload)
        app.router.add_post("/delta", self.handle_delta)
        app.router.add_post("/rollback", self.handle_rollback)
        app.router.add_post("/stop", self.handle_stop)
        app.router.add_get("/plugins.json", self.handle_plugins)
        return app

    async def handle_health(self, request: web.Request) -> web.Response:
        """Liveness + breaker state (per algorithm, the serving path, every
        backend in :data:`BREAKERS`), admission, drain, and the deployment's
        lifecycle position."""
        algo = {b.name: b.snapshot() for b in self.deployed.algo_breakers}
        serving = self._serving_breaker.snapshot()
        backends = BREAKERS.snapshot()
        degraded = any(
            s["state"] != "closed"
            for s in (serving, *algo.values(), *backends.values()))
        inst = self.deployed.instance
        return web.json_response({
            "status": self._drain_state.health_status(degraded),
            "draining": self._drain_state.draining,
            "device": str(self.ctx.device),
            "servingBreaker": serving,
            "algorithmBreakers": algo,
            "backendBreakers": backends,
            "degradedResponses": self.degraded_count,
            "admission": self._admission.snapshot(self.batcher.queue.qsize()),
            # distinct dispatch shapes served so far (utils/jitstats.py):
            # flat after warmup; a count growing under load is unbounded
            # shapes
            "jitCompileKeys": jitstats.count(),
            "deployment": {
                "instanceId": inst.id,
                "engineId": inst.engine_id,
                "engineVersion": inst.engine_version,
                "previousInstanceId": (
                    self._previous.instance.id
                    if self._previous is not None else None),
                "probationActive": self._probation_active(),
                "rollbacks": self._rollback_count,
                "lastReload": self._last_reload,
                # the delta-chain position the updater's ship-resync keys on
                "streaming": self._streaming_health(),
                # per-model shard state with each shard's [lo, hi) rows
                "sharding": self._sharding_summary(),
            },
        })

    def _sharding_summary(self) -> list:
        """One entry per deployed model (reference query_server.py:1013):
        None when it serves unsharded, else its shard count, mode, merge
        fan-in and each shard's ``[lo, hi)`` item rows."""
        from incubator_predictionio_tpu_torch.sharding.table import ShardSpec

        out = []
        for m in self.deployed.models:
            info = m.serving_info() if hasattr(m, "serving_info") else None
            sh = (info or {}).get("sharding")
            if not sh:
                out.append(None)
                continue
            entry = {"nShards": sh["n_shards"], "mode": sh["mode"],
                     "mergeFanin": sh["merge_fanin"]}
            items = sh.get("items") or None
            if items:
                spec = ShardSpec(items["name"], items["n_rows"],
                                 items["width"], items["n_shards"])
                entry["shardIds"] = list(range(spec.n_shards))
                entry["rows"] = [list(spec.shard_bounds(s))
                                 for s in range(spec.n_shards)]
            out.append(entry)
        return out

    async def handle_status(self, request: web.Request) -> web.Response:
        inst = self.deployed.instance
        if "text/html" in request.headers.get("Accept", ""):
            return web.Response(
                text=self._status_html(), content_type="text/html")
        return web.json_response({
            "status": "alive",
            "engineInstance": {
                "id": inst.id,
                "engineId": inst.engine_id,
                "engineVersion": inst.engine_version,
                "startTime": inst.start_time.isoformat(),
            },
            "algorithms": [type(a).__name__ for a in self.deployed.algorithms],
            # which execution path each model serves from (host numpy for
            # small catalogs, device bf16 / int8-cuda for large ones)
            "servingPaths": [
                m.serving_info() if hasattr(m, "serving_info") else None
                for m in self.deployed.models
            ],
            "device": str(self.ctx.device),
            "requestCount": self.request_count,
            "avgServingSec": self.avg_serving_sec,
            "lastServingSec": self.last_serving_sec,
            "servingSecPercentiles": self.latency.percentiles(),
            # the tail split: time spent waiting for a batch slot against
            # the time the dispatch itself took
            "queueDelaySecPercentiles": self.batcher.queue_delay.percentiles(),
            "dispatchSecPercentiles": self.batcher.dispatch_sec.percentiles(),
            "batchesServed": self.batcher.batches_served,
            "maxBatchSeen": self.batcher.max_batch_seen,
            # queued-past-deadline evictions and the live dispatch bound
            "shedExpired": self.batcher.shed_expired,
            "maxInFlight": self.batcher.max_in_flight,
            # distinct dispatch shapes served so far (utils/jitstats.py)
            "jitCompileKeys": jitstats.count(),
            "uptimeSec": self._clock.monotonic() - self._start_time,
        })

    def _status_html(self) -> str:
        """Human status page on ``/`` (reference query_server.py:1155; the
        twirl template of CreateServer.scala:437-462): engine info, server
        info, per-stage params, algorithms and models; the feedback-loop
        section comes with feedback events (ROADMAP.md item 6).
        Self-contained CSS (serving hosts may have no egress)."""
        import html as _html

        inst = self.deployed.instance
        cfg = self.config

        def esc(v) -> str:
            return _html.escape(str(v))

        def table(rows: list[tuple[str, object]]) -> str:
            return "<table>" + "".join(
                f"<tr><th>{esc(k)}</th><td>{esc(v)}</td></tr>"
                for k, v in rows) + "</table>"

        algo_rows = "".join(
            f"<tr><th rowspan=\"3\">{i + 1}</th>"
            f"<th>Class</th><td>{esc(type(a).__name__)}</td></tr>"
            f"<tr><th>Parameters</th><td>{esc(p)}</td></tr>"
            f"<tr><th>Model</th><td>{esc(m)}</td></tr>"
            for i, (a, p, m) in enumerate(zip(
                self.deployed.algorithms,
                json.loads(inst.algorithms_params or "[]")
                + [""] * len(self.deployed.algorithms),
                [type(m).__name__ for m in self.deployed.models]))
        )
        title = (f"{inst.engine_factory} ({inst.engine_variant}) - "
                 f"Engine Server at {cfg.ip}:{cfg.port}")
        return f"""<!DOCTYPE html>
<html lang="en">
<head><title>{esc(title)}</title>
<style>
 body {{ font-family: sans-serif; margin: 2em; }}
 table {{ border-collapse: collapse; margin-bottom: 1.5em; }}
 th, td {{ border: 1px solid #ccc; padding: 4px 10px; text-align: left; }}
 td {{ font-family: Menlo, Monaco, Consolas, monospace; }}
</style></head>
<body>
<h1>Engine Server at {esc(cfg.ip)}:{esc(cfg.port)}</h1>
<p>{esc(inst.engine_factory)} ({esc(inst.engine_variant)})</p>
<h2>Engine Information</h2>
{table([
    ("Training Start Time", inst.start_time),
    ("Training End Time", inst.end_time),
    ("Variant ID", inst.engine_variant),
    ("Instance ID", inst.id),
])}
<h2>Server Information</h2>
{table([
    ("Start Time", _dt.datetime.fromtimestamp(self._start_time)),
    ("Request Count", self.request_count),
    ("Average Serving Time", f"{self.avg_serving_sec:.4f} seconds"),
    ("Last Serving Time", f"{self.last_serving_sec:.4f} seconds"),
    ("Engine Factory Class", inst.engine_factory),
])}
<h2>Data Source</h2>
{table([("Parameters", inst.data_source_params)])}
<h2>Data Preparator</h2>
{table([("Parameters", inst.preparator_params)])}
<h2>Algorithms and Models</h2>
<table><tr><th>#</th><th colspan="2">Information</th></tr>{algo_rows}</table>
<h2>Serving</h2>
{table([("Parameters", inst.serving_params)])}
</body>
</html>"""

    async def handle_query(self, request: web.Request) -> web.Response:
        if self._drain_state.draining:
            return self._drain_state.reject_response()
        status, result, headers = await self._serve_payload(await request.read())
        return web.json_response(result, status=status, headers=headers)

    @staticmethod
    def _server_timing(total_sec: float,
                       algo_times: list[tuple[str, float]]) -> str:
        """``X-PIO-Server-Timing``: total µs plus this request's dispatch's
        per-algorithm µs (``<name>;us=<int>`` entries)."""
        parts = [f"total;us={int(total_sec * 1e6)}"]
        parts.extend(f"{name};us={int(sec * 1e6)}"
                     for name, sec in algo_times)
        return ", ".join(parts)

    def _feed_admission(self, dt: float,
                        observe_latency: bool = True) -> None:
        """Every request that consumed a batcher queue slot counts as drain
        progress for the service-rate estimate; only clean predictions
        feed the limiter's latency window. A changed limit resizes the
        batcher's slots off the hot path."""
        new_limit = self._admission.on_complete(
            dt, observe_latency=observe_latency)
        if new_limit is not None and new_limit != self.batcher.max_in_flight:
            task = asyncio.create_task(self.batcher.resize(new_limit))
            self._resize_tasks.add(task)
            task.add_done_callback(self._resize_tasks.discard)

    async def _serve_payload(
            self, body: bytes) -> tuple[int, Any, Optional[dict]]:
        """The whole query lifecycle from raw body bytes: (status, jsonable
        body, response headers or None). Door order: admission (429),
        brownout, serving breaker, batcher, 504 eviction, degraded
        backstop."""
        t0 = self._clock.monotonic()
        try:
            payload = json.loads(body)
        except json.JSONDecodeError:
            return 400, {"message": "Invalid JSON query"}, None
        loop = asyncio.get_running_loop()
        decision, retry_after = self._admission.decide(
            self.batcher.queue.qsize())
        if decision == REJECT:
            return 429, {
                "message": "server overloaded; rejected by admission "
                           "control (docs/resilience.md)",
            }, {"Retry-After": str(retry_after)}
        if decision == BROWNOUT:
            # sustained saturation: the degraded path, without touching the
            # device queue
            return 200, await loop.run_in_executor(
                None, self._degraded_result, payload,
                "brownout (admission control)"), None
        if not self._serving_breaker.allow():
            return 200, await loop.run_in_executor(
                None, self._degraded_result, payload,
                "serving breaker open"), None
        try:
            submitted = self.batcher.submit_timed(payload)
            if self.config.query_timeout_sec is not None:
                # the backstop waits a grace past the budget, so under
                # overload the batcher's 504-evict (at the budget) wins and
                # pure overload never charges the serving breaker
                budget = self.config.query_timeout_sec
                prediction, algo_times = await asyncio.wait_for(
                    submitted, budget + max(0.05, 0.1 * budget))
            else:
                prediction, algo_times = await submitted
        except asyncio.CancelledError:
            # the client left: no verdict; hand back a half-open probe slot
            self._serving_breaker.release_probe()
            raise
        except ShedExpired:
            self._serving_breaker.release_probe()
            return 504, {
                "message": "deadline expired before dispatch; request "
                           "shed (docs/resilience.md)",
            }, {"Retry-After": str(
                self._admission.retry_after(self.batcher.queue.qsize()))}
        except _BAD_QUERY as e:
            self._serving_breaker.record_success()
            self._feed_admission(self._clock.monotonic() - t0,
                                 observe_latency=False)
            return 400, {"message": f"Invalid query: {e}"}, None
        except (asyncio.TimeoutError, ServingUnavailable, DeadlineExceeded,
                CircuitOpenError) as e:
            # a blown budget, or every algorithm/backend breaker open:
            # degraded-but-valid beats a 500
            self._serving_breaker.record_failure()
            # a trip inside a swap's probation window indicts the new engine
            await self._maybe_probation_rollback(repr(e))
            self._feed_admission(self._clock.monotonic() - t0,
                                 observe_latency=False)
            return 200, await loop.run_in_executor(
                None, self._degraded_result, payload, repr(e)), None
        except NotImplementedError as e:
            # a query kind the port does not serve yet (it names ROADMAP.md)
            self._serving_breaker.record_success()
            self._feed_admission(self._clock.monotonic() - t0,
                                 observe_latency=False)
            return 501, {"message": str(e)}, None
        except Exception:
            # a per-query engine exception is the engine answering (with an
            # error), not an outage: it must not trip the serving breaker
            self._serving_breaker.record_success()
            self._feed_admission(self._clock.monotonic() - t0,
                                 observe_latency=False)
            raise
        self._serving_breaker.record_success()
        dt = self._clock.monotonic() - t0
        self.request_count += 1
        self.last_serving_sec = dt
        self.avg_serving_sec += (dt - self.avg_serving_sec) / self.request_count
        self.latency.record(dt)
        self._feed_admission(dt)
        # camelCase field names: the reference's response shape
        result = to_jsonable(prediction, camelize_fields=True)
        result = apply_output_plugins(self.deployed.instance, payload, result)
        # cached after the plugins: a degraded replay never leaks what an
        # output plugin removed
        self._remember_good(payload, result)
        return 200, result, {
            "X-PIO-Server-Timing": self._server_timing(dt, algo_times)}

    # -- graceful degradation -------------------------------------------------
    @staticmethod
    def _cache_key(payload: dict) -> str:
        try:
            canon = json.dumps(payload, sort_keys=True, default=str)
        except (TypeError, ValueError):
            canon = repr(payload)
        return hashlib.sha1(canon.encode()).hexdigest()

    def _remember_good(self, payload: dict, result: Any) -> None:
        key = self._cache_key(payload)
        with self._last_good_lock:
            self._last_good.pop(key, None)  # re-insert = move to MRU end
            self._last_good[key] = result
            while len(self._last_good) > self._LAST_GOOD_MAX:
                self._last_good.pop(next(iter(self._last_good)))

    def _degraded_result(self, payload: dict, reason: str) -> Any:
        """The last good answer to this exact query (with ``"degraded":
        true``), else the serving layer's ``default_result(query)``, else a
        minimal valid body: always a 200, never a 500."""
        with self._last_good_lock:
            self.degraded_count += 1
            cached = self._last_good.get(self._cache_key(payload))
        _DEGRADED.inc()
        if cached is not None:
            if isinstance(cached, dict):
                return {**cached, "degraded": True}
            return cached
        default_fn = getattr(self.deployed.serving, "default_result", None)
        if callable(default_fn):
            try:
                query = bind_query(self.deployed.query_cls, payload)
                result = to_jsonable(default_fn(query), camelize_fields=True)
                result = apply_output_plugins(
                    self.deployed.instance, payload, result)
                if isinstance(result, dict):
                    return {**result, "degraded": True}
                return result
            except Exception:  # noqa: BLE001 - the default must never throw
                logger.exception("serving default_result failed")
        return {"degraded": True, "message": f"serving degraded: {reason}"}

    def _authorized(self, request: web.Request) -> bool:
        import hmac

        key = self.config.server_access_key
        if not key:
            return True
        # bytes operands: compare_digest rejects non-ASCII str
        return hmac.compare_digest(
            request.query.get("accessKey", "").encode(), key.encode())

    # -- live-model swaps -----------------------------------------------------
    async def handle_reload(self, request: web.Request) -> web.Response:
        """Versioned hot-swap: load + warm the new instance BESIDE the live
        one (in an executor; the live engine keeps serving), run the smoke
        queries against it (any failure: 409, the live engine stays), then
        swap atomically and pin the previous engine for probation."""
        if not self._authorized(request):
            return web.json_response({"message": "Unauthorized"}, status=401)
        if self._drain_state.draining:
            return self._drain_state.reject_response()
        loop = asyncio.get_running_loop()
        try:
            new = await loop.run_in_executor(
                None, load_deployed_engine, self.config, self.storage,
                self.ctx)
        except RuntimeError as e:
            return web.json_response({"message": str(e)}, status=400)
        failure = await self._smoke_gate(new)
        if failure is not None:
            self._rollback_count += 1
            _ROLLBACKS.inc()
            self._last_reload = {
                "status": "rejected", "instanceId": new.instance.id,
                "reason": failure,
            }
            logger.error("reload: smoke gate rejected instance %s (%s); "
                         "instance %s keeps serving", new.instance.id,
                         failure, self.deployed.instance.id)
            return web.json_response({
                "message": "Reload rejected by smoke-query gate; previous "
                           "instance keeps serving",
                "error": failure,
                "engineInstanceId": self.deployed.instance.id,
            }, status=409)
        old = await self._swap_in(new)
        # a full reload starts a fresh delta chain (the pinned snapshot
        # still restores the old position on a rollback)
        self._delta_state = None
        self._last_reload = {"status": "ok", "instanceId": new.instance.id,
                             "previousInstanceId": old.instance.id}
        return web.json_response({"message": "Reloaded",
                                  "engineInstanceId": new.instance.id})

    async def _rebound(self, deployed: DeployedEngine) -> None:
        """Re-resolve the overlap bound for a swapped-in engine (its
        thread-safety posture may differ) and re-bound the limiter."""
        bound = effective_max_in_flight(self.config, deployed)
        limit = self._admission.set_max_inflight(bound)
        await self.batcher.resize(limit if limit is not None else bound)

    async def _swap_in(self, new: DeployedEngine) -> DeployedEngine:
        """Atomic engine swap + probation pin, shared by /reload and /delta:
        in-flight dispatches hold their own reference to the old engine and
        finish on it; everything after the assignment serves the new one
        (the batcher is repointed too). The old engine, and the delta-chain
        position that matched it, stay pinned for the probation window."""
        old = self.deployed
        self.deployed = new
        self.batcher.deployed = new
        await self._rebound(new)
        self._previous = old
        self._previous_delta_state = (
            dict(self._delta_state) if self._delta_state else None)
        self._probation_until = (
            self._clock.monotonic() + self.config.reload_probation_sec
            if self.config.reload_probation_sec > 0 else None)
        if self._probation_until is not None:
            # release the pin when the window ends even if nothing reads
            # _probation_active(): the previous engine's device tensors
            # would otherwise stay resident (a no-op if a rollback already
            # consumed the pin or an injected clock says probation runs on)
            asyncio.get_running_loop().call_later(
                self.config.reload_probation_sec + 0.5,
                self._probation_active)
        else:
            self._previous = None  # probation disabled: nothing to pin
        return old

    async def _smoke_gate(self, new: DeployedEngine) -> Optional[str]:
        """Run ``config.smoke_queries`` against the not-yet-live engine: an
        error description, or None when the gate passes."""
        loop = asyncio.get_running_loop()
        for payload in self.config.smoke_queries:
            try:
                await loop.run_in_executor(None, new.predict, dict(payload))
            except Exception as e:  # noqa: BLE001 - any failure gates
                return f"smoke query {payload!r} failed: {e!r}"
        return None

    def _probation_active(self) -> bool:
        if self._previous is None or self._probation_until is None:
            return False
        if self._clock.monotonic() >= self._probation_until:
            # probation survived: release the pinned previous engine
            self._previous = None
            self._probation_until = None
            return False
        return True

    async def _restore_previous(self, reason: str) -> DeployedEngine:
        """Swap the pinned previous engine back in (probation rollback and
        ``POST /rollback``): limiter re-bound, delta-chain position
        restored, serving breaker closed so it serves at once."""
        prev, self._previous = self._previous, None
        self._probation_until = None
        rolled_from = self.deployed.instance.id
        self.deployed = prev
        self.batcher.deployed = prev
        self._delta_state = self._previous_delta_state
        self._previous_delta_state = None
        await self._rebound(prev)
        self._serving_breaker.record_success()
        self._rollback_count += 1
        _ROLLBACKS.inc()
        self._last_reload = {"status": "rolled_back",
                             "instanceId": prev.instance.id,
                             "rolledBackFrom": rolled_from,
                             "reason": reason}
        logger.error("reload: rolled back from instance %s to %s (%s)",
                     rolled_from, prev.instance.id, reason)
        return prev

    async def _maybe_probation_rollback(self, reason: str) -> None:
        """After a serving-breaker failure: if the breaker is OPEN inside a
        probation window, the new engine is broken under real traffic, so
        the pinned previous one is restored."""
        if self._serving_breaker.state != "open" or not self._probation_active():
            return
        await self._restore_previous(reason)

    def _streaming_health(self) -> Optional[dict]:
        """Delta-chain position + freshness for /health.deployment (None
        until a streaming delta has been applied to this base)."""
        st = self._delta_state
        if not st:
            return None
        staleness = None
        if st.get("maxEventTimeUs"):
            staleness = max(0.0, time.time() - st["maxEventTimeUs"] / 1e6)
        return {
            "lastDeltaSeq": st["lastDeltaSeq"],
            "chainBase": st["chainBase"],
            "applied": st["applied"],
            "deduped": st["deduped"],
            "maxEventTimeUs": st["maxEventTimeUs"],
            "stalenessSeconds": staleness,
        }

    async def handle_delta(self, request: web.Request) -> web.Response:
        """Streaming delta deploy through the same discipline as /reload:
        build the delta-applied engine BESIDE the live one (in an executor,
        without warmup), run the smoke gate, swap, pin the previous engine
        for probation.

        Exactly-once enforcement: every delta names its ``[from_seq,
        to_seq)`` event range and the base instance it applies to. A
        wrong-base, out-of-order or non-finite delta is rejected 409 (with
        this replica's position, so the updater resyncs the chain); an
        already-applied range answers 200 ``duplicate`` and is counted,
        never re-applied."""
        from incubator_predictionio_tpu_torch.streaming.delta import (
            decode_delta,
        )

        if not self._authorized(request):
            return web.json_response({"message": "Unauthorized"}, status=401)
        if self._drain_state.draining:
            return self._drain_state.reject_response()
        body = await self._read_delta_body(request)
        if body is None:
            return web.json_response(
                {"status": "rejected",
                 "message": f"delta body over {DELTA_MAX_BYTES} bytes"},
                status=413)
        try:
            delta = decode_delta(body)
        except Exception as e:  # noqa: BLE001 - bad/foreign artifact
            return web.json_response(
                {"status": "rejected", "message": f"bad delta: {e}"},
                status=400)
        async with self._delta_lock:
            return await self._apply_delta(delta)

    @staticmethod
    async def _read_delta_body(request: web.Request) -> Optional[bytes]:
        """The body, or None past :data:`DELTA_MAX_BYTES`. A delta grows
        with the rows its batch touched (~130 bytes a row at rank 32: a
        16,384-event batch is ~4 MB), past the app's 1 MiB limit, which
        ``request.read()`` would enforce; the stream read is bounded here
        instead, for this route alone."""
        if (request.content_length or 0) > DELTA_MAX_BYTES:
            return None
        body = bytearray()
        async for chunk in request.content.iter_chunked(1 << 20):
            body += chunk
            if len(body) > DELTA_MAX_BYTES:
                return None
        return bytes(body)

    async def _apply_delta(self, delta) -> web.Response:
        inst_id = self.deployed.instance.id
        st = self._delta_state
        last = st["lastDeltaSeq"] if st else None
        if delta.base_instance != inst_id:
            return web.json_response({
                "status": "rejected", "reason": "base-mismatch",
                "message": f"delta targets instance {delta.base_instance}, "
                           f"this replica serves {inst_id}",
                "instanceId": inst_id, "lastDeltaSeq": last,
            }, status=409)
        if last is not None and delta.to_seq <= last:
            # already applied (the updater crashed between ship and cursor
            # commit and is replaying): idempotent ack, counted
            st["deduped"] += 1
            _STREAM_DEDUPED.inc()
            return web.json_response(
                {"status": "duplicate", "lastDeltaSeq": last})
        expected = last if last is not None else delta.chain_base
        if delta.from_seq != expected:
            return web.json_response({
                "status": "rejected", "reason": "out-of-order",
                "message": f"expected from_seq {expected}, got "
                           f"{delta.from_seq} — resync the chain",
                "lastDeltaSeq": last, "instanceId": inst_id,
            }, status=409)
        if not delta.finite():
            return web.json_response({
                "status": "rejected", "reason": "non-finite",
                "message": "delta carries non-finite rows; quarantine the "
                           "stream",
                "lastDeltaSeq": last,
            }, status=409)
        live = self.deployed

        def build() -> DeployedEngine:
            import signal

            models = []
            applied = False
            for m in live.models:
                if hasattr(m, "apply_delta"):
                    m = m.apply_delta(delta)
                    applied = True
                models.append(m)
            if not applied:
                raise LookupError("no deployed model supports streaming "
                                  "deltas (apply_delta)")
            if os.environ.get("PIO_DELTA_FAULT") == "kill:mid_apply":
                # chaos hook: die with the new tables built but NOT swapped
                # in; after a restart the old engine serves, nothing is
                # half-applied
                logger.error("PIO_DELTA_FAULT tripping mid_apply — SIGKILL")
                os.kill(os.getpid(), signal.SIGKILL)
            return DeployedEngine(
                live.engine, live.engine_params, live.instance, models,
                self.ctx, max_batch=self.config.max_batch, warmup=False,
                algo_deadline=self.config.algo_deadline_sec,
                breaker_threshold=self.config.algo_breaker_threshold,
                breaker_reset=self.config.algo_breaker_reset_sec,
                clock=self._clock)

        t0 = time.perf_counter()
        try:
            new = await asyncio.get_running_loop().run_in_executor(None, build)
        except LookupError as e:
            return web.json_response(
                {"status": "rejected", "message": str(e)}, status=409)
        except (ValueError, RuntimeError) as e:
            return web.json_response({
                "status": "rejected", "reason": "apply-failed",
                "message": str(e), "lastDeltaSeq": last,
            }, status=409)
        failure = await self._smoke_gate(new)
        if failure is not None:
            self._rollback_count += 1
            _ROLLBACKS.inc()
            self._last_reload = {
                "status": "delta_rejected", "instanceId": inst_id,
                "deltaRange": [delta.from_seq, delta.to_seq],
                "reason": failure,
            }
            logger.error("delta [%d, %d): smoke gate rejected (%s); "
                         "previous state keeps serving",
                         delta.from_seq, delta.to_seq, failure)
            return web.json_response({
                "status": "rejected", "reason": "smoke-gate",
                "error": failure, "lastDeltaSeq": last,
            }, status=409)
        await self._swap_in(new)
        self.delta_apply_s.append(time.perf_counter() - t0)
        self._delta_state = {
            "lastDeltaSeq": delta.to_seq,
            "chainBase": delta.chain_base,
            "maxEventTimeUs": max(st["maxEventTimeUs"] if st else 0,
                                  delta.max_event_time_us),
            "applied": (st["applied"] if st else 0) + 1,
            "deduped": st["deduped"] if st else 0,
        }
        _STREAM_APPLIED.inc()
        self._last_reload = {
            "status": "delta", "instanceId": inst_id,
            "deltaRange": [delta.from_seq, delta.to_seq],
        }
        return web.json_response({
            "status": "applied",
            "lastDeltaSeq": delta.to_seq,
            "rows": delta.n_rows,
            "engineInstanceId": inst_id,
        })

    async def handle_rollback(self, request: web.Request) -> web.Response:
        """Operator rollback to the pinned previous engine; 409 once the
        pin is gone (probation over, or a rollback consumed it)."""
        if not self._authorized(request):
            return web.json_response({"message": "Unauthorized"}, status=401)
        if not self._probation_active():
            return web.json_response({
                "message": "no pinned previous instance (probation "
                           "inactive); nothing to roll back to",
            }, status=409)
        prev = await self._restore_previous("operator rollback "
                                            "(POST /rollback)")
        return web.json_response({"message": "Rolled back",
                                  "engineInstanceId": prev.instance.id})

    async def handle_stop(self, request: web.Request) -> web.Response:
        if not self._authorized(request):
            return web.json_response({"message": "Unauthorized"}, status=401)
        self._stop_event.set()
        return web.json_response({"message": "Shutting down"})

    async def handle_plugins(self, request: web.Request) -> web.Response:
        from incubator_predictionio_tpu_torch.server.plugins import (
            ENGINE_SERVER_PLUGINS,
            EngineServerPlugin,
        )

        def listing(output_type):
            return {
                p.name: {"description": p.description, "class": type(p).__name__}
                for p in ENGINE_SERVER_PLUGINS.values()
                if p.output_type == output_type
            }

        return web.json_response({"plugins": {
            "outputblockers": listing(EngineServerPlugin.OUTPUTBLOCKER),
            "outputsniffers": listing(EngineServerPlugin.OUTPUTSNIFFER),
        }})

    # -- lifecycle ------------------------------------------------------------
    async def start(self) -> None:
        self._runner = web.AppRunner(self.make_app())
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.config.ip, self.config.port)
        await site.start()
        logger.info("engine server listening on %s:%d", self.config.ip,
                    self.config.port)

    async def wait_stopped(self) -> None:
        await self._stop_event.wait()
        await self.drain_and_shutdown()

    async def drain_and_shutdown(
            self, deadline_sec: Optional[float] = None) -> None:
        """Graceful exit: stop accepting queries (503 + Retry-After,
        /health → 'draining'), let every queued and in-flight micro-batch
        complete, then shut down, all within the deadline
        (``PIO_DRAIN_DEADLINE`` unless given)."""
        self._drain_state.begin()
        deadline = (drained_exit_deadline()
                    if deadline_sec is None else deadline_sec)
        drained = await wait_for(
            lambda: (self.batcher.queue.qsize() == 0
                     and not self.batcher._inflight),
            deadline)
        if not drained:
            logger.warning("drain: in-flight queries still running after "
                           "%.1fs — shutting down anyway", deadline)
        await self.shutdown()

    async def shutdown(self) -> None:
        # stop accepting connections BEFORE stopping the batcher: a query
        # in the gap would otherwise resurrect the drainer task
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None
        for task in list(self._resize_tasks):
            task.cancel()
        await self.batcher.stop()


def serve_forever(config: ServerConfig, storage: Optional[Storage] = None,
                  ctx: Optional[DeviceContext] = None) -> None:
    """Blocking entry of the CLI ``deploy`` verb: serve until ``POST
    /stop``, SIGTERM or SIGINT, then drain (in-flight micro-batches finish;
    a second signal exits at once)."""

    async def main():
        server = QueryServer(config, storage, ctx)
        await server.start()
        install_signal_drain(asyncio.get_running_loop(), server._stop_event,
                             "engine server")
        await server.wait_stopped()

    asyncio.run(main())
