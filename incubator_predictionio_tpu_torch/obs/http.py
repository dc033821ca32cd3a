"""aiohttp telemetry: ONE middleware instruments every route of every server.

Counterpart of ``incubator_predictionio_tpu/obs/http.py``:
:func:`telemetry_middleware`, :func:`handle_metrics` (``?exemplars=1``),
:func:`handle_traces`, :func:`handle_profile`, the obs server's
``/health`` with its mesh block (:func:`_mesh_health_block`, over
``distributed/meshdir.py``), :func:`add_observability_routes` and
:func:`start_obs_server` with :class:`ObsServerHandle`. The reference's
``GET /history.json`` is not registered: the metrics history it serves
(``obs/history.py``) comes with the next part of ROADMAP.md item 6.

Per request the middleware:

- adopts the caller's trace from ``X-PIO-Trace`` (else roots a fresh one)
  and opens a server span for the route;
- records the per-route latency histogram and status counter;
- echoes ``X-PIO-Trace: <trace_id>`` on the response (success AND error
  paths) so callers can correlate;
- emits a trace-ID'd structured JSON access log line on the ``pio.access``
  logger (guarded by ``isEnabledFor``: silenced loggers cost one check).

``add_observability_routes`` mounts the shared ``GET /metrics`` (Prometheus
text), ``GET /traces.json`` (recent span trees), ``GET /profile.json``
(phase aggregates, sampler, MFU, device watermarks) and ``GET /health``.
These routes never pass the query server's admission controller: only
``POST /queries.json`` does, so telemetry is answered while the queue is
full or in brownout. The ``__pio_telemetry__`` marker on the middleware
lets a test walk an app and see that it is instrumented.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Optional

from aiohttp import web

from incubator_predictionio_tpu_torch.obs import profile as _profile
from incubator_predictionio_tpu_torch.obs import trace
from incubator_predictionio_tpu_torch.obs.metrics import REGISTRY

logger = logging.getLogger(__name__)
access_log = logging.getLogger("pio.access")

HTTP_REQUESTS = REGISTRY.counter(
    "pio_http_requests_total",
    "HTTP requests by server, route pattern, method, and status",
    labels=("service", "route", "method", "status"))
HTTP_LATENCY = REGISTRY.histogram(
    "pio_http_request_seconds",
    "HTTP request latency (seconds) by server and route pattern",
    labels=("service", "route"))


def _route_pattern(request: web.Request) -> str:
    """The route's canonical pattern (``/events/{event_id}.json``), NOT the
    raw path — label cardinality must stay bounded."""
    try:
        resource = request.match_info.route.resource
        if resource is not None:
            return resource.canonical
    except Exception:  # noqa: BLE001 - label resolution must never 500
        pass
    return "__unmatched__"


def telemetry_middleware(service: str):
    """Build the middleware for one server (the label value on every
    metric/span it emits)."""

    @web.middleware
    async def middleware(request: web.Request, handler):
        route = _route_pattern(request)
        parent = trace.parse_header(request.headers.get(trace.TRACE_HEADER))
        t0 = time.perf_counter()
        status = 500
        http_exc = False
        with trace.trace_scope(parent):
            with trace.span(f"{request.method} {route}", service=service,
                            method=request.method, route=route) as sp:
                try:
                    resp = await handler(request)
                    status = resp.status
                except web.HTTPException as ex:
                    # auth/validation raise these; they ARE responses —
                    # stamp the trace header on them before they propagate
                    http_exc = True
                    status = ex.status
                    ex.headers[trace.TRACE_HEADER] = sp.trace_id
                    raise
                except Exception:  # noqa: BLE001 - CancelledError passes through
                    # an unhandled handler error would become aiohttp's bare
                    # 500 with no trace header; build the 500 here so even
                    # THE failed request is correlatable (the whole point)
                    logger.exception("unhandled error in %s %s",
                                     request.method, request.path)
                    resp = web.json_response(
                        {"message": "Internal Server Error",
                         "traceId": sp.trace_id}, status=500)
                    status = 500
                finally:
                    sp.set_attr("status", status)
                    if status >= 500 and sp.status == "ok":
                        # a server error is exactly what the tail keep
                        # rules exist for: mark the span so it reaches the
                        # durable spool even at s=0 (docs/observability.md)
                        sp.status = f"error:http{status}"
                    elif http_exc and status < 500:
                        # a raised 4xx (bad accessKey, validation) is an
                        # ORDERLY answer, not an error — without this, a
                        # client hammering 401s would tail-keep every span
                        # and evict the genuine 5xx/slow traces the spool
                        # exists to retain. The non-"ok" terminal status
                        # keeps the outcome visible AND stops span()'s
                        # exception handler from re-stamping it as error
                        sp.status = f"http{status}"
                    dt = time.perf_counter() - t0
                    HTTP_REQUESTS.labels(service=service, route=route,
                                         method=request.method,
                                         status=str(status)).inc()
                    # exemplar: the p99 bucket on /metrics links straight
                    # to this request's trace.
                    # Only for traces that will stay FINDABLE: when the
                    # spool is on, a head-dropped span that no tail rule
                    # keeps would leave the exemplar pointing at nothing
                    _, slow_sec = trace.sampling()
                    findable = (not trace.export_enabled()
                                or trace.keep_reason(sp.sampled, sp.status,
                                                     dt, slow_sec))
                    lat = HTTP_LATENCY.labels(service=service, route=route)
                    if findable:
                        lat.observe_exemplar(dt, trace_id=sp.trace_id)
                    else:
                        lat.observe(dt)
                    if access_log.isEnabledFor(logging.INFO):
                        access_log.info(json.dumps({
                            "service": service,
                            "method": request.method,
                            "path": request.path,
                            "route": route,
                            "status": status,
                            "durationSec": round(dt, 6),
                            "traceId": sp.trace_id,
                            "remote": request.remote,
                        }, separators=(",", ":")))
        resp.headers[trace.TRACE_HEADER] = sp.trace_id
        return resp

    middleware.__pio_telemetry__ = service
    return middleware


async def handle_metrics(request: web.Request) -> web.Response:
    # exemplars only on explicit request (`?exemplars=1`, which the
    # `pio-tpu metrics` pretty-printer sends): a stock Prometheus 0.0.4
    # parser rejects the whole page on the first `# {...}` suffix, and
    # Accept-header sniffing is a trap — stock Prometheus advertises
    # openmetrics in its default Accept while expecting spec-exact OM
    # (counter families without the _total suffix), which this exposition
    # is not. A query param can only come from a caller that means it.
    exemplars = request.query.get("exemplars") == "1"
    return web.Response(
        text=REGISTRY.expose(exemplars=exemplars),
        content_type="text/plain", charset="utf-8",
        headers={"X-Prometheus-Format": "0.0.4"})


async def handle_traces(request: web.Request) -> web.Response:
    try:
        limit = int(request.query.get("limit", 50))
    except ValueError:
        limit = -1
    if limit < 0:
        return web.json_response({"message": "invalid limit"}, status=400)
    trace_id = request.query.get("traceId")
    if trace_id:
        return web.json_response(
            {"traceId": trace_id, "spans": trace.TRACES.spans(trace_id)})
    return web.json_response({"traces": trace.TRACES.traces(limit)})


async def handle_profile(request: web.Request) -> web.Response:
    """``GET /profile.json`` — the continuous profiler's live document:
    phase aggregates, wall-stack top-N (when PIO_PROFILE_HZ > 0), training
    MFU, device-memory watermarks (``pio-tpu profile <url>``)."""
    return web.json_response(_profile.profile_payload())


def _mesh_health_block() -> Optional[dict]:
    """The /health mesh block: the coordination directory's snapshot when
    this process runs under (or supervises) a distributed training mesh
    (``PIO_DIST_STATE_DIR``); None otherwise. Synchronous — callers hop
    through an executor."""
    import os

    from incubator_predictionio_tpu_torch.distributed.context import DistConfig
    from incubator_predictionio_tpu_torch.distributed.meshdir import (
        MeshDirectory,
    )

    state_dir = os.environ.get("PIO_DIST_STATE_DIR")
    if not state_dir:
        return None
    conf = DistConfig.from_env()
    snap = MeshDirectory(state_dir).health_snapshot(
        conf.heartbeat_ms, quorum=conf.quorum or None)
    return {
        "stateDir": snap["stateDir"],
        "generation": snap["generation"],
        "members": snap["aliveMembers"],
        "expectedMembers": snap["expectedMembers"],
        "quorum": snap["quorum"],
        "degraded": snap["degraded"],
        "lastCommit": snap["lastCommit"],
    }


async def handle_obs_health(request: web.Request) -> web.Response:
    """``GET /health`` on the dark-plane obs server (jobs worker, stream
    updater): process liveness plus the distributed-training mesh block —
    status degrades when the mesh falls below quorum, so one probe covers
    both the worker and the fleet it trains."""
    import asyncio

    # the mesh snapshot stats/reads small files: executor hop keeps the
    # event loop non-blocking (R1)
    mesh = await asyncio.get_running_loop().run_in_executor(
        None, _mesh_health_block)
    body: dict = {"status": "ok"}
    if mesh is not None:
        body["mesh"] = mesh
        if mesh["degraded"]:
            body["status"] = "degraded"
    return web.json_response(body)


def add_observability_routes(app: web.Application) -> None:
    app.router.add_get("/metrics", handle_metrics)
    app.router.add_get("/traces.json", handle_traces)
    app.router.add_get("/profile.json", handle_profile)
    app.router.add_get("/health", handle_obs_health)


# ---------------------------------------------------------------------------
# dark-plane observability server (stream updater, jobs worker)
# ---------------------------------------------------------------------------

class ObsServerHandle:
    """Handle for a :func:`start_obs_server` thread — close() tears the
    listener and its loop down."""

    def __init__(self, thread, loop, runner, port: int):
        self._thread = thread
        self._loop = loop
        self._runner = runner
        self.port = port

    def close(self, timeout: float = 5.0) -> None:
        import asyncio

        async def stop():
            await self._runner.cleanup()
            self._loop.stop()

        try:
            asyncio.run_coroutine_threadsafe(stop(), self._loop)
            self._thread.join(timeout=timeout)
        except RuntimeError:  # pragma: no cover - loop already gone
            pass


def start_obs_server(service: str, port: int,
                     ip: str = "127.0.0.1") -> ObsServerHandle:
    """Serve the shared ``GET /metrics`` + ``GET /traces.json`` routes from
    a daemon thread with its own event loop — how processes without an HTTP
    surface of their own (the stream updater, the jobs worker) publish
    their slice of the process-wide registry and span ring
    (``--obs-port``; docs/observability.md). Loopback by default — span
    attributes carry internal endpoints; exposing wider is an explicit
    ``--obs-ip`` decision, like every other server's ``--ip``."""
    import asyncio
    import threading

    started = threading.Event()
    holder: dict = {}

    def run() -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)

        async def boot():
            app = web.Application(
                middlewares=[telemetry_middleware(service)])
            add_observability_routes(app)
            runner = web.AppRunner(app)
            await runner.setup()
            site = web.TCPSite(runner, ip, port)
            await site.start()
            bound = site._server.sockets[0].getsockname()[1]
            return runner, bound

        try:
            holder["runner"], holder["port"] = loop.run_until_complete(boot())
        except Exception as e:  # noqa: BLE001 - surfaced to the caller
            holder["error"] = e
            started.set()
            loop.close()
            return
        holder["loop"] = loop
        started.set()
        loop.run_forever()
        # stop() already ran runner.cleanup on this loop
        loop.close()

    thread = threading.Thread(target=run, daemon=True,
                              name=f"obs-server-{service}")
    thread.start()
    started.wait(timeout=10.0)
    if "error" in holder:
        raise holder["error"]
    if "loop" not in holder:  # pragma: no cover - boot wedged
        raise TimeoutError("obs server failed to start in 10s")
    logger.info("%s: observability server on %s:%d (/metrics, /traces.json)",
                service, ip, holder["port"])
    return ObsServerHandle(thread, holder["loop"], holder["runner"],
                           holder["port"])
