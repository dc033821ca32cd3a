"""Engine (query) server — the ``pio deploy`` surface.

Counterpart of ``incubator_predictionio_tpu/server/query_server.py``
(workflow/CreateServer.scala:106-695), cut to the deploy → query path and
streaming deltas: :class:`ServerConfig`, :class:`DeployedEngine` (prepare +
warmup + predict / batch predict), :class:`MicroBatcher`,
:func:`load_deployed_engine`, :class:`QueryServer` with ``GET /``,
``GET /health``, ``POST /queries.json`` and ``POST /delta``, and
:func:`serve_forever` (the CLI ``deploy`` verb). Circuit
breakers, admission control, reload (with the smoke gate, probation and
rollback that the reference's ``/delta`` shares with it), tenancy and
plugins come in later slices (ROADMAP.md).

Models become device-resident once at deploy: ``prepare_for_serving(ctx)``
receives the server's :class:`DeviceContext`, so the served tables land on
its device (the reference's models ask JAX for the platform instead).
"""

from __future__ import annotations

import asyncio
import collections
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

#: largest streaming delta body ``POST /delta`` reads; every other route
#: keeps aiohttp's 1 MiB default
DELTA_MAX_BYTES = 64 << 20

#: query-semantic rejections: the query is bad, not the engine (→ 400)
_BAD_QUERY = (TypeError, ValueError, KeyError)


@dataclasses.dataclass
class ServerConfig:
    """(CreateServer.scala:106-175 flags, the subset this slice serves)"""

    engine_variant: str = "engine.json"
    ip: str = "0.0.0.0"
    port: int = 8000
    max_batch: int = 64  # micro-batch cap for /queries.json (1 = no batching)
    server_access_key: Optional[str] = None  # guards /delta


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
        warmup: bool = True,
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
        if warmup:
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
                          max_batch=config.max_batch, warmup=warmup)


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
        # streaming delta state: which [from_seq, to_seq) range of the
        # updater's chain this replica has applied; None until the first
        # delta lands
        self._delta_state: Optional[dict] = None
        # one delta at a time: the chain checks must still hold when the
        # delta-applied engine is swapped in
        self._delta_lock = asyncio.Lock()
        #: server-side seconds of the latest applied deltas: build the
        #: delta-applied engine (copy, prepare on the device) and swap
        self.delta_apply_s: collections.deque = collections.deque(maxlen=1024)
        self._start_time = time.monotonic()
        self._runner: Optional[web.AppRunner] = None

    def make_app(self) -> web.Application:
        app = web.Application()
        app.router.add_get("/", self.handle_status)
        app.router.add_get("/health", self.handle_health)
        app.router.add_post("/queries.json", self.handle_query)
        app.router.add_post("/delta", self.handle_delta)
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

    def _swap_in(self, new: DeployedEngine) -> None:
        """Atomic engine swap: in-flight dispatches hold their own
        reference to the old engine and finish on it; everything after the
        assignment serves the new one. The batcher captured the old engine
        at construction, so it is repointed too."""
        self.deployed = new
        self.batcher.deployed = new

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
        """Streaming delta deploy: build the delta-applied engine BESIDE the
        live one (in an executor, without warmup) and swap it in.

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

    def _authorized(self, request: web.Request) -> bool:
        import hmac

        key = self.config.server_access_key
        if not key:
            return True
        # bytes operands: compare_digest rejects non-ASCII str
        return hmac.compare_digest(
            request.query.get("accessKey", "").encode(), key.encode())

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
            return DeployedEngine(
                live.engine, live.engine_params, live.instance, models,
                self.ctx, max_batch=self.config.max_batch, warmup=False)

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
        self._swap_in(new)
        self.delta_apply_s.append(time.perf_counter() - t0)
        st = self._delta_state
        self._delta_state = {
            "lastDeltaSeq": delta.to_seq,
            "chainBase": delta.chain_base,
            "maxEventTimeUs": max(st["maxEventTimeUs"] if st else 0,
                                  delta.max_event_time_us),
            "applied": (st["applied"] if st else 0) + 1,
            "deduped": st["deduped"] if st else 0,
        }
        return web.json_response({
            "status": "applied",
            "lastDeltaSeq": delta.to_seq,
            "rows": delta.n_rows,
            "engineInstanceId": inst_id,
        })

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


def serve_forever(config: ServerConfig, storage: Optional[Storage] = None,
                  ctx: Optional[DeviceContext] = None) -> None:
    """Blocking entry of the CLI ``deploy`` verb: serve until SIGINT or
    SIGTERM, then shut the server down (in-flight micro-batches finish)."""
    import signal

    async def main():
        server = QueryServer(config, storage, ctx)
        await server.start()
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        try:
            await stop.wait()
        finally:
            await server.shutdown()

    asyncio.run(main())
