"""PyTorch port, the query server's telemetry routes against the JAX
package's, on the CPU.

One seeded two-tower model (20 users, 60 items, rank 8, as
tests/test_torch_reload.py serves it) is deployed on each package's
``QueryServer`` and sent the same 32 queries, 16 of them carrying a seeded
``X-PIO-Trace``. Each server's ``/metrics`` is scraped before and after and
parsed with the reference's strict parser: the families the port exposes,
their label sets and their event counts (requests by status, the latency
histograms' counts, ``serve.batch`` scopes and phases, breaker and
admission families) equal the reference's; ``/traces.json`` returns each
traced request's span on both; ``/health``'s keys are the reference's,
less what is not ported yet. Then the routes themselves: the middleware
on every route (also on an unhandled 500), ``/traces.json``'s 400, the
shared route list (the reference's less ``/history.json``), telemetry
answered while the admission queue is full and in brownout, the obs server
with its mesh block, and the CLI verbs ``metrics``, ``profile`` and
``status`` against a live port server in-process.
"""

import asyncio
import json
import os
import urllib.request

import pytest

pytest.importorskip("torch")

from aiohttp import web  # noqa: E402
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

from incubator_predictionio_tpu.distributed import meshdir as jmeshdir  # noqa: E402
from incubator_predictionio_tpu.obs import http as jhttp  # noqa: E402
from incubator_predictionio_tpu.obs import metrics as jmetrics  # noqa: E402
from incubator_predictionio_tpu.obs import profile as jprof  # noqa: E402
from incubator_predictionio_tpu_torch.obs import http as thttp  # noqa: E402
from incubator_predictionio_tpu_torch.obs import profile as tprof  # noqa: E402
from incubator_predictionio_tpu_torch.obs import trace as ttrace  # noqa: E402
from incubator_predictionio_tpu_torch.tools import cli  # noqa: E402

from tests.test_torch_reload import (  # noqa: E402
    PAYLOAD,
    Harness,
    Side,
    _StubAlgo,
    _stub_deployed,
)
from tests.test_torch_streaming import _serve  # noqa: E402

N_QUERIES, N_TRACED = 32, 16
#: /health keys of the reference not ported yet (the SLO block, with the
#: performance plane), and the port's own: the serving device and the
#: dispatch-shape count
HEALTH_REF_ONLY = {"slo"}
HEALTH_PORT_ONLY = {"device", "jitCompileKeys"}
#: routes of the reference's QueryServer not ported yet: the metrics
#: history (the performance plane) and the shard-owner routes (item 7)
ROUTES_REF_ONLY = {("GET", "/history.json"), ("POST", "/shard/queries.json"),
                   ("POST", "/shard/promote")}
#: families whose values are wall times or follow them (latency gauges,
#: the adaptive limiter, the service-rate estimate): compared by label
#: set, not by value
TIMED = ("seconds", "pio_admission_limit", "pio_admission_throttled",
         "pio_admission_drain")


def _trace_header(i):
    return f"{0xabc000 + i:016x}:{0xdef000 + i:016x}:s=1"


def _routes(app):
    return {(r.method, r.resource.canonical) for r in app.router.routes()
            if r.method != "HEAD"}


def _events(before, after, names):
    """Per (sample name, labels) increase between two parsed pages, over
    the families ``names``; histograms by their ``_count``."""
    out = {}
    for name in names:
        fam = after.get(name)
        if fam is None:
            continue
        old = {(s, tuple(sorted(lab.items()))): v
               for s, lab, v in before.get(name, {"samples": []})["samples"]}
        for s, lab, v in fam["samples"]:
            if fam["type"] == "histogram" and not s.endswith("_count"):
                continue
            key = (s, tuple(sorted(lab.items())))
            if v != old.get(key, 0.0):
                out[key] = v - old.get(key, 0.0)
    return out


async def _scrape(h):
    resp = await h.client.get("/metrics")
    assert resp.status == 200
    assert resp.headers["X-Prometheus-Format"] == "0.0.4"
    return jmetrics.parse_prometheus_text(await resp.text())


async def _traffic(h):
    """The 32 queries, one at a time (one batch each); the record of what
    the client and the routes saw."""
    h.rec_env()
    await h.start({"engine_variant": h.variant})
    try:
        before = await _scrape(h)
        echoed, spans = [], []
        for i in range(N_QUERIES):
            headers = ({"X-PIO-Trace": _trace_header(i)} if i < N_TRACED
                       else {})
            resp = await h.client.post("/queries.json", headers=headers,
                                       json={"user": f"u{i % 20}", "num": 5})
            assert resp.status == 200
            tid = resp.headers["X-PIO-Trace"]
            echoed.append(tid == _trace_header(i).split(":")[0]
                          if i < N_TRACED else len(tid) == 16)
        for i in range(N_TRACED):
            tid = _trace_header(i).split(":")[0]
            doc = await (await h.client.get(
                f"/traces.json?traceId={tid}")).json()
            spans.append([(s["name"], s["service"], s["parentId"],
                           s["status"], s["attrs"]["status"])
                          for s in doc["spans"]])
        after = await _scrape(h)
        health = await (await h.client.get("/health")).json()
        status = await (await h.client.get("/")).json()
        profile = await (await h.client.get("/profile.json")).json()
        batches = h.server.batcher.batches_served
    finally:
        await h.stop()
        h.storage.close()
    return {"before": before, "after": after, "echoed": echoed,
            "spans": spans, "health": health, "status": status,
            "profile": profile, "batches": batches}


def test_one_model_on_both_servers_scrapes_the_same(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_RETRIEVAL_MODE", "exact")
    got = {}
    for name in ("jax", "port"):
        h = Harness(Side(name), tmp_path / name, monkeypatch)
        h.tmp.mkdir()
        got[name] = asyncio.run(_traffic(h))
    port, ref = got["port"], got["jax"]
    # the families the port exposes: the reference's, by type, help and
    # label names
    for name, fam in port["after"].items():
        want = ref["after"].get(name)
        assert want is not None, name
        assert (fam["type"], fam["help"]) == (want["type"], want["help"]), name
        labels = {tuple(sorted(k for k in lab if k != "le"))
                  for _, lab, _ in fam["samples"]}
        want_labels = {tuple(sorted(k for k in lab if k != "le"))
                       for _, lab, _ in want["samples"]}
        if labels and want_labels:
            assert labels == want_labels, name
    # the events of this traffic: the same families moved, by the same
    # counts, with the same label sets
    names = sorted(port["after"])
    ev = {k: _events(got[k]["before"], got[k]["after"], names) for k in got}
    assert {key for key in ev["port"]} == {key for key in ev["jax"]}
    counted = {key: v for key, v in ev["port"].items()
               if not any(t in key[0] for t in TIMED)}
    assert counted == {key: ev["jax"][key] for key in counted}
    requests = ev["port"][("pio_http_requests_total", (
        ("method", "POST"), ("route", "/queries.json"),
        ("service", "query_server"), ("status", "200")))]
    assert requests == N_QUERIES
    assert ev["port"][("pio_http_request_seconds_count", (
        ("route", "/queries.json"), ("service", "query_server")))] == N_QUERIES
    assert ev["port"][("pio_profile_scopes_total", (
        ("scope", "serve.batch"),))] == port["batches"] == N_QUERIES
    assert {key[1][0][1] for key in ev["port"]
            if key[0] == "pio_profile_phases_total"} == {
        "assemble", "mask", "dispatch", "merge"}
    # every traced request echoed its id, and its server span is findable
    assert port["echoed"] == ref["echoed"] == [True] * N_QUERIES
    assert port["spans"] == ref["spans"]
    for i, spans in enumerate(port["spans"]):
        assert spans == [("POST /queries.json", "query_server",
                          _trace_header(i).split(":")[1], "ok", 200)]
    # /health: the reference's keys, less what is not ported yet
    assert set(port["health"]) - HEALTH_PORT_ONLY \
        == set(ref["health"]) - HEALTH_REF_ONLY
    assert port["health"]["jitCompileKeys"] == port["status"]["jitCompileKeys"]
    assert set(port["status"]) - {"device"} == set(ref["status"])
    assert port["profile"]["phases"]["serve.batch"]["count"] >= N_QUERIES
    assert sorted(port["profile"]) == sorted(ref["profile"])


def test_the_shared_routes_are_the_references_less_history():
    apps = {}
    for name, mod in (("jax", jhttp), ("port", thttp)):
        apps[name] = web.Application(
            middlewares=[mod.telemetry_middleware("svc")])
        mod.add_observability_routes(apps[name])
    assert _routes(apps["port"]) == _routes(apps["jax"]) - {
        ("GET", "/history.json")}


def test_every_query_server_route_is_wrapped(tmp_path, monkeypatch):
    apps = {}
    for name in ("jax", "port"):
        h = Harness(Side(name), tmp_path / name, monkeypatch)
        h.tmp.mkdir()
        h.rec_env()
        server = h.side.qs.QueryServer(
            h.side.qs.ServerConfig(engine_variant=h.variant),
            storage=h.storage, **h.side.server_kw)
        apps[name] = server.make_app()
        asyncio.run(server.shutdown())
        h.storage.close()
    marks = [getattr(m, "__pio_telemetry__", None)
             for m in apps["port"].middlewares]
    assert marks == ["query_server"]
    assert _routes(apps["port"]) == _routes(apps["jax"]) - ROUTES_REF_ONLY


def _boom_app(mod):
    async def boom(request):
        raise RuntimeError("planted")

    async def forbidden(request):
        raise web.HTTPForbidden(text="no")

    app = web.Application(middlewares=[mod.telemetry_middleware("svc")])
    app.router.add_get("/boom", boom)
    app.router.add_get("/forbidden", forbidden)
    mod.add_observability_routes(app)
    return app


@pytest.mark.parametrize("mod", [jhttp, thttp], ids=["jax", "port"])
def test_middleware_stamps_a_trace_on_an_unhandled_500(mod):
    async def body():
        client = TestClient(TestServer(_boom_app(mod)))
        await client.start_server()
        try:
            r = await client.get("/boom")
            doc = await r.json()
            assert r.status == 500 and doc["traceId"] == r.headers["X-PIO-Trace"]
            r = await client.get("/forbidden", headers={
                "X-PIO-Trace": "feed0000feed0000:beef"})
            assert r.status == 403
            assert r.headers["X-PIO-Trace"] == "feed0000feed0000"
            out = {}
            for q in ("limit=-1", "limit=abc", "limit=0", "limit=2"):
                r = await client.get(f"/traces.json?{q}")
                out[q] = (r.status, await r.json())
            return doc["traceId"], out
        finally:
            await client.close()

    tid, out = asyncio.run(body())
    assert out["limit=-1"] == (400, {"message": "invalid limit"})
    assert out["limit=abc"] == (400, {"message": "invalid limit"})
    assert out["limit=0"] == (200, {"traces": []})
    status, doc = out["limit=2"]
    assert status == 200 and len(doc["traces"]) == 2
    (forbidden,) = mod.trace.TRACES.spans("feed0000feed0000")
    assert forbidden["status"] == "http403"
    assert forbidden["parentId"] == "beef"
    (boom,) = mod.trace.TRACES.spans(tid)
    assert boom["status"] == "error:http500"


async def _full_and_brownout(h):
    """Telemetry while the queue is full, then in brownout: every
    observability route answers 200 and the query route 429 / degraded."""
    statuses = []

    async def probe(tag):
        for path in ("/metrics", "/traces.json", "/profile.json", "/health"):
            r = await h.client.get(path)
            statuses.append((tag, path, r.status))

    algo = h.algo
    algo.gate = asyncio_gate = __import__("threading").Event()
    tasks = [asyncio.create_task(h.post("/queries.json", PAYLOAD, note=False))]
    await h.wait(lambda: h.server.batcher._inflight, "the wedged dispatch")
    tasks += [asyncio.create_task(h.post("/queries.json", PAYLOAD, note=False))
              for _ in range(2)]
    await h.wait(lambda: h.server.batcher.queue.qsize() >= 2, "a full queue")
    statuses.append(("full", "/queries.json",
                     (await h.post("/queries.json", PAYLOAD))["status"]))
    await probe("full")
    asyncio_gate.set()
    for t in tasks:
        await t
    ctrl = h.server._admission
    ctrl.decide(6)
    h.clk.advance(1.1)
    ctrl.decide(6)
    assert ctrl.brownout_active
    r = await h.post("/queries.json", PAYLOAD)
    statuses.append(("brownout", "/queries.json", r["body"].get("degraded")))
    await probe("brownout")
    return statuses


def test_telemetry_is_answered_while_the_queue_is_full_and_in_brownout(
        tmp_path, monkeypatch):
    got = {}
    config = {"admission_max_queue": 2, "max_in_flight": 1,
              "brownout_enter_sec": 1.0, "brownout_exit_sec": 2.0}
    for name in ("jax", "port"):
        h = Harness(Side(name), tmp_path / name, monkeypatch)
        h.storage = h.side.storage_mod.Storage(
            {"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})
        h.algo = _StubAlgo()

        async def run(h=h):
            await h.start(config, deployed=_stub_deployed(h, h.algo, config))
            try:
                return await _full_and_brownout(h)
            finally:
                await h.stop()
                h.storage.close()

        got[name] = asyncio.run(run())
    assert got["port"] == got["jax"]
    assert ("full", "/queries.json", 429) in got["port"]
    assert ("brownout", "/queries.json", True) in got["port"]
    assert all(s == 200 for _, p, s in got["port"] if p != "/queries.json")


def test_obs_server_serves_metrics_and_the_mesh_block(tmp_path, monkeypatch):
    state = tmp_path / "mesh"
    jmeshdir.MeshDirectory(str(state)).bump_generation(2)
    monkeypatch.setenv("PIO_DIST_STATE_DIR", str(state))
    handle = thttp.start_obs_server("stream_updater", 0)
    try:
        base = f"http://127.0.0.1:{handle.port}"

        def get(path):
            with urllib.request.urlopen(base + path, timeout=10) as r:
                return r.status, r.read().decode()

        status, text = get("/metrics")
        assert status == 200 and "pio_http_requests_total" in text
        status, body = get("/health")
        health = json.loads(body)
        assert health["mesh"] == jhttp._mesh_health_block()
        assert health["status"] == "degraded"  # no member holds a lease
        assert json.loads(get("/profile.json")[1])["service"]
        assert json.loads(get("/traces.json")[1])["traces"]
    finally:
        handle.close()
    monkeypatch.delenv("PIO_DIST_STATE_DIR")
    assert thttp._mesh_health_block() is None


def test_stream_verb_serves_its_fold_on_the_obs_port(tmp_path, monkeypatch,
                                                    capsys):
    """``stream --once --obs-port P``: while the verb runs, its obs server
    answers ``/metrics`` with the fold's counters and ``/profile.json``
    with its ``stream.fold`` phases (scraped when the verb closes it);
    afterwards the port is closed."""
    import gc
    import socket

    from incubator_predictionio_tpu_torch.data.event import DataMap, Event
    from incubator_predictionio_tpu_torch.data.storage import registry as treg
    from tests.test_torch_reload import _stream_argv
    from tests.test_torch_streaming import ROUND1, _events_of, _PortLog

    monkeypatch.setenv("PIO_RETRIEVAL_MODE", "exact")
    monkeypatch.delenv("PIO_STREAM_FUSED", raising=False)
    h = Harness(Side("port"), tmp_path, monkeypatch)
    h.rec_env()
    _PortLog(str(tmp_path / "live.piolog")).append(
        _events_of(ROUND1, Event, DataMap, 0))
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    seen = {}
    real = thttp.ObsServerHandle.close

    def close(handle, timeout=5.0):
        base = f"http://127.0.0.1:{handle.port}"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            seen["metrics"] = r.read().decode()
        with urllib.request.urlopen(base + "/profile.json", timeout=10) as r:
            seen["profile"] = json.loads(r.read().decode())
        real(handle, timeout)

    monkeypatch.setattr(thttp.ObsServerHandle, "close", close)
    prev = treg.use_storage(h.storage)

    async def body(server, url):
        loop = asyncio.get_running_loop()
        try:
            return await loop.run_in_executor(None, cli.main, _stream_argv(
                h, url, "--once", "--obs-port", str(port)))
        finally:
            gc.unfreeze()

    try:
        rc = _serve(h.storage, h.variant, body, server_access_key=None)
    finally:
        treg.use_storage(prev)
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["status"] == "applied"
    page = jmetrics.parse_prometheus_text(seen["metrics"])
    assert page["pio_stream_folded_total"]["samples"][0][2] >= 4
    assert "stream.fold" in seen["profile"]["phases"]
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2)


def test_cli_metrics_profile_and_status_against_a_live_port_server(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PIO_RETRIEVAL_MODE", "exact")
    h = Harness(Side("port"), tmp_path, monkeypatch)
    h.rec_env()

    async def body(server, url):
        loop = asyncio.get_running_loop()
        import aiohttp

        async with aiohttp.ClientSession() as s:
            for u in ("u1", "u2"):
                async with s.post(f"{url}/queries.json",
                                  json={"user": u, "num": 3}) as r:
                    assert r.status == 200
        out = {}
        for argv in (["metrics", url, "--filter", "pio_http"],
                     ["metrics", url, "--raw"],
                     ["metrics", url, url.replace("127.0.0.1", "localhost"),
                      "--filter", "pio_profile_scopes"],
                     ["profile", url], ["profile", url, "--json"],
                     ["status"], ["metrics", "http://127.0.0.1:9",
                                  "--timeout", "0.5"]):
            rc = await loop.run_in_executor(None, cli.main, argv)
            captured = capsys.readouterr()
            out[" ".join(argv[:1] + argv[2:])] = (rc, captured.out,
                                                  captured.err)
        return out

    out = _serve(h.storage, h.variant, body)
    rc, text, _ = out["metrics --filter pio_http"]
    assert rc == 0 and "pio_http_requests_total (counter)" in text
    # the process-wide registry: this server's 2 answers and earlier ones
    row = "method=POST,route=/queries.json,service=query_server,status=200: "
    assert int(text.split(row)[1].split()[0]) >= 2
    rc, text, _ = out["metrics --raw"]
    assert rc == 0 and "# TYPE pio_profile_scopes_total counter" in text
    jmetrics.parse_prometheus_text(text)
    rc, text, _ = out[next(k for k in out if k.endswith("pio_profile_scopes"))]
    assert rc == 0 and "servers:" in text and "sum=" in text
    rc, text, _ = out["profile"]
    assert rc == 0 and "serve.batch: wall" in text and "dispatch" in text
    rc, text, _ = out["profile --json"]
    assert rc == 0 and json.loads(text)["phases"]["serve.batch"]["count"] >= 2
    rc, text, _ = out["status"]
    assert rc == 0 and text.startswith("incubator_predictionio_tpu_torch 0.1.0")
    assert "Devices: 1 × cpu" in text and "all ready" in text
    rc, _, err = out[next(k for k in out if "--timeout" in k)]
    assert rc == 1 and "Unable to fetch" in err


def test_the_profile_document_has_the_references_shape():
    assert sorted(tprof.profile_payload()) == sorted(jprof.profile_payload())
    assert os.environ.get("PIO_PROFILE_HZ", "") in ("", "0") \
        or tprof.active_sampler() is not None
    with ttrace.span("probe", buffer=ttrace.TraceBuffer()):
        assert ttrace.current_trace_id() is not None
