"""Engine (query) server — the ``pio deploy`` surface.

Counterpart of ``incubator_predictionio_tpu/server/query_server.py``
(workflow/CreateServer.scala:106-695), cut to the deploy → query path:
:class:`ServerConfig`, :class:`DeployedEngine` (prepare + warmup + predict /
batch predict), :class:`MicroBatcher`, :func:`load_deployed_engine` and
:class:`QueryServer` with ``GET /``, ``GET /health`` and
``POST /queries.json``. Circuit breakers, admission control, reload,
streaming deltas, tenancy and plugins come in later slices (ROADMAP.md).

Models become device-resident once at deploy: ``prepare_for_serving(ctx)``
receives the server's :class:`DeviceContext`, so the served tables land on
its device (the reference's models ask JAX for the platform instead).
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import os
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
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext
from incubator_predictionio_tpu_torch.utils.json_util import (
    bind_query,
    to_jsonable,
)
from incubator_predictionio_tpu_torch.utils.serialization import (
    deserialize_model,
)

logger = logging.getLogger(__name__)

#: query-semantic rejections: the query is bad, not the engine (→ 400)
_BAD_QUERY = (TypeError, ValueError, KeyError)


@dataclasses.dataclass
class ServerConfig:
    """(CreateServer.scala:106-175 flags, the subset this slice serves)"""

    engine_variant: str = "engine.json"
    ip: str = "0.0.0.0"
    port: int = 8000
    max_batch: int = 64  # micro-batch cap for /queries.json (1 = no batching)


class DeployedEngine:
    """Holds the live models + stages for one engine instance."""

    def __init__(
        self,
        engine: Engine,
        engine_params: EngineParams,
        instance: EngineInstance,
        models: list[Any],
        ctx: DeviceContext,
        max_batch: int = 64,
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
        self.warmup(max_batch)

    @staticmethod
    def _prepare(model, ctx: DeviceContext):
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

    def predict(self, payload: dict) -> Any:
        query = self.serving.supplement(bind_query(self.query_cls, payload))
        predictions = [a.predict(m, query)
                       for a, m in zip(self.algorithms, self.models)]
        return self.serving.serve(query, predictions)

    def predict_batch(self, payloads: list[dict]) -> list[Any]:
        """One ``batch_predict`` dispatch per algorithm for the whole batch.
        Returns one result OR exception per payload: a query that fails to
        bind fails alone, and when a batch dispatch raises, its queries are
        retried one by one so only the offender fails."""
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
        per_algo: list[dict[int, Any]] = []
        for a, m in zip(self.algorithms, self.models):
            try:
                got = dict(a.batch_predict(m, [(i, bound[i]) for i in live]))
                missing = [i for i in live if i not in got]
            except Exception:  # noqa: BLE001 - isolate the failing query
                got, missing = {}, live
            for i in missing:
                try:
                    got[i] = a.predict(m, bound[i])
                except Exception as e:  # noqa: BLE001 - the query's own error
                    got[i] = e
            per_algo.append(got)
        for i in live:
            preds = [got[i] for got in per_algo]
            err = next((p for p in preds if isinstance(p, Exception)), None)
            if err is not None:
                out[i] = err
                continue
            try:
                out[i] = self.serving.serve(bound[i], preds)
            except Exception as e:  # noqa: BLE001 - the query's own error
                out[i] = e
        return out


class MicroBatcher:
    """Continuous micro-batching for the query hot path.

    Requests enqueue; a single drainer coalesces everything that arrived
    while the previous batch was dispatched into ONE ``predict_batch`` call
    (capped at ``max_batch``). No artificial wait: an idle server serves
    single queries at single-query latency. Batches run in a worker thread
    so the event loop keeps accepting requests, and up to ``max_in_flight``
    batches overlap."""

    def __init__(self, deployed: DeployedEngine, max_batch: int = 64,
                 max_in_flight: int = 2):
        self.deployed = deployed
        self.max_batch = max_batch
        self.max_in_flight = max_in_flight
        self.queue: asyncio.Queue = asyncio.Queue()
        self.batches_served = 0
        self.max_batch_seen = 0
        self._task: Optional[asyncio.Task] = None
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
                _, fut = self.queue.get_nowait()
            except asyncio.QueueEmpty:
                break
            if not fut.done():
                fut.set_result(RuntimeError("server shutting down"))

    async def submit(self, payload: dict) -> Any:
        self.start()
        fut = asyncio.get_running_loop().create_future()
        await self.queue.put((payload, fut))
        result = await fut
        if isinstance(result, Exception):
            raise result
        return result

    async def _drain(self) -> None:
        loop = asyncio.get_running_loop()
        sem = asyncio.Semaphore(self.max_in_flight)
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
                while len(batch) < self.max_batch:
                    try:
                        batch.append(self.queue.get_nowait())
                    except asyncio.QueueEmpty:
                        break
                self.batches_served += 1
                self.max_batch_seen = max(self.max_batch_seen, len(batch))
                task = loop.create_task(self._dispatch(loop, batch))
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

    async def _dispatch(self, loop, batch) -> None:
        try:
            results = await loop.run_in_executor(
                None, self.deployed.predict_batch, [p for p, _ in batch])
        except asyncio.CancelledError:
            for _, fut in batch:
                if not fut.done():
                    fut.set_result(RuntimeError("server shutting down"))
            raise
        except Exception as e:  # noqa: BLE001 - keep serving
            results = [e] * len(batch)
        for (_, fut), r in zip(batch, results):
            if not fut.done():
                fut.set_result(r)


def load_deployed_engine(
    config: ServerConfig,
    storage: Optional[Storage] = None,
    ctx: Optional[DeviceContext] = None,
) -> DeployedEngine:
    """variant → engine factory → latest COMPLETED instance → live models
    (createServerActorWithEngine, CreateServer.scala:187-246)."""
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
                          max_batch=config.max_batch)


def effective_max_in_flight(config: ServerConfig, deployed: DeployedEngine) -> int:
    """Dispatches that may overlap: 2 when every deployed algorithm
    declares ``serving_thread_safe`` (host prep of one batch then overlaps
    the device time of the other), else 1; ``max_batch=1`` serializes."""
    if config.max_batch == 1:
        return 1
    safe = all(getattr(a, "serving_thread_safe", False)
               for a in deployed.algorithms)
    return 2 if safe else 1


class QueryServer:
    def __init__(
        self,
        config: ServerConfig,
        storage: Optional[Storage] = None,
        ctx: Optional[DeviceContext] = None,
    ):
        self.config = config
        self.storage = storage or get_storage()
        self.ctx = ctx or DeviceContext.create()
        self.deployed = load_deployed_engine(config, self.storage, self.ctx)
        self.batcher = MicroBatcher(
            self.deployed, max_batch=config.max_batch,
            max_in_flight=effective_max_in_flight(config, self.deployed))
        self.request_count = 0
        self._start_time = time.monotonic()
        self._runner: Optional[web.AppRunner] = None

    def make_app(self) -> web.Application:
        app = web.Application()
        app.router.add_get("/", self.handle_status)
        app.router.add_get("/health", self.handle_health)
        app.router.add_post("/queries.json", self.handle_query)
        return app

    async def handle_health(self, request: web.Request) -> web.Response:
        inst = self.deployed.instance
        return web.json_response({
            "status": "ok",
            "device": str(self.ctx.device),
            "deployment": {
                "instanceId": inst.id,
                "engineId": inst.engine_id,
                "engineVersion": inst.engine_version,
            },
        })

    async def handle_status(self, request: web.Request) -> web.Response:
        inst = self.deployed.instance
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
            "batchesServed": self.batcher.batches_served,
            "maxBatchSeen": self.batcher.max_batch_seen,
            "maxInFlight": self.batcher.max_in_flight,
            "uptimeSec": time.monotonic() - self._start_time,
        })

    async def handle_query(self, request: web.Request) -> web.Response:
        try:
            payload = json.loads(await request.read())
        except json.JSONDecodeError:
            return web.json_response({"message": "Invalid JSON query"}, status=400)
        try:
            prediction = await self.batcher.submit(payload)
        except _BAD_QUERY as e:
            return web.json_response({"message": f"Invalid query: {e}"}, status=400)
        except NotImplementedError as e:
            # a query kind the port does not serve yet (it names ROADMAP.md)
            return web.json_response({"message": str(e)}, status=501)
        self.request_count += 1
        # camelCase field names: the reference's response shape
        return web.json_response(to_jsonable(prediction, camelize_fields=True))

    async def start(self) -> None:
        self._runner = web.AppRunner(self.make_app())
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.config.ip, self.config.port)
        await site.start()
        logger.info("engine server listening on %s:%d", self.config.ip,
                    self.config.port)

    async def shutdown(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None
        await self.batcher.stop()
