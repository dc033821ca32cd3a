"""PyTorch port, the query server's safety tier against the JAX package's
query server, on the CPU.

Every scenario runs twice, once on each package's ``QueryServer`` with
its own ``FakeClock``, on the same recommendation arrays (20 users, 60
items, rank 8; as tests/test_torch_query_server.py holds them) or on the
same stub engine, and records what a client sees: status codes,
``Retry-After``, JSON bodies with instance ids and times masked,
``/health``'s breaker, admission, drain and deployment blocks key for key,
and the answers (ids equal, scores within 1e-4). The two records must
agree. The scenarios are the reference's own:

- tests/test_query_server.py:129 and :368-805 — auth, reload during a
  dispatch, reload re-resolving the in-flight bound, the smoke gate both
  ways, probation rollback and expiry, ``/rollback`` 200 then 409, loading
  beside the live instance, draining;
- tests/test_overload.py:366-756 — 429 at the door, 504 eviction,
  brownout in and out, the limiter resizing the batcher;
- tests/test_resilience.py:466-575 — degrading on a deadline and
  recovering, the default degraded body;
- tests/test_streaming.py:467 and :492 — delta rollback, the delta smoke
  gate.

Then the CLI: ``deploy``'s flags, ``undeploy`` and the ``stream`` verb's
``--once``, ``--status`` and ``--dead-letter`` against a port server.
"""

import asyncio
import datetime as dt
import gc
import json
import os
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

from incubator_predictionio_tpu import core as jcore  # noqa: E402
from incubator_predictionio_tpu.data import storage as jstorage  # noqa: E402
from incubator_predictionio_tpu.data.bimap import BiMap as JBiMap  # noqa: E402
from incubator_predictionio_tpu.models import two_tower as jtt  # noqa: E402
from incubator_predictionio_tpu.resilience import clock as jclock  # noqa: E402
from incubator_predictionio_tpu.resilience import policy as jpol  # noqa: E402
from incubator_predictionio_tpu.server import query_server as jqs  # noqa: E402
from incubator_predictionio_tpu.streaming import delta as jdeltas  # noqa: E402
from incubator_predictionio_tpu.streaming import updater as jup  # noqa: E402
from incubator_predictionio_tpu.templates import recommendation as jrec  # noqa: E402
from incubator_predictionio_tpu.utils import serialization as jser  # noqa: E402
from incubator_predictionio_tpu_torch import convert  # noqa: E402
from incubator_predictionio_tpu_torch import core as tcore  # noqa: E402
from incubator_predictionio_tpu_torch.data import storage as tstorage  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext  # noqa: E402
from incubator_predictionio_tpu_torch.resilience import clock as tclock  # noqa: E402
from incubator_predictionio_tpu_torch.resilience import policy as tpol  # noqa: E402
from incubator_predictionio_tpu_torch.resilience import wal as twal  # noqa: E402
from incubator_predictionio_tpu_torch.server import query_server as tqs  # noqa: E402
from incubator_predictionio_tpu_torch.streaming import delta as tdeltas  # noqa: E402
from incubator_predictionio_tpu_torch.templates import recommendation as trec  # noqa: E402
from incubator_predictionio_tpu_torch.tools import cli  # noqa: E402
from incubator_predictionio_tpu_torch.utils import serialization as tser  # noqa: E402

from tests.test_torch_streaming import (  # noqa: E402
    ROUND1,
    _events_of,
    _PortLog,
    _serve,
)

UTC = dt.timezone.utc
T0 = dt.datetime(2024, 3, 1, tzinfo=UTC)
N_USERS, N_ITEMS, RANK = 20, 60, 8
CPU = DeviceContext.create(device="cpu")
#: keys whose values are wall times or wall-clock ages
TIME_KEYS = {"uptimeSec", "stalenessSeconds", "startTime", "avgServingSec",
             "lastServingSec", "maxEventTimeUs"}
#: the /health blocks this tier adds, compared key for key
HEALTH_KEYS = ("status", "draining", "servingBreaker", "algorithmBreakers",
               "degradedResponses", "admission")
DEPLOYMENT_KEYS = ("instanceId", "previousInstanceId", "probationActive",
                   "rollbacks", "lastReload", "streaming")


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(N_USERS, RANK)) * 0.5).astype(np.float32),
            (rng.normal(size=(N_ITEMS, RANK)) * 0.5).astype(np.float32),
            (rng.normal(size=N_USERS) * 0.1).astype(np.float32),
            (rng.normal(size=N_ITEMS) * 0.1).astype(np.float32))


USERS = [f"u{i}" for i in range(N_USERS)]
ITEMS = [f"i{j}" for j in range(N_ITEMS)]


class Side:
    """One package's classes, behind one set of names."""

    def __init__(self, name):
        self.name = name
        jax = name == "jax"
        self.qs = jqs if jax else tqs
        self.clock = jclock if jax else tclock
        self.pol = jpol if jax else tpol
        self.deltas = jdeltas if jax else tdeltas
        self.storage_mod = jstorage if jax else tstorage
        self.ser = jser if jax else tser
        self.core = jcore if jax else tcore
        self.rec = jrec if jax else trec
        pkg = "incubator_predictionio_tpu" + ("" if jax else "_torch")
        self.factory = f"{pkg}.templates.recommendation.RecommendationEngine"
        self.server_kw = {} if jax else {"ctx": CPU}

    def model(self, arrays):
        ue, ie, ub, ib = arrays
        if self.name == "jax":
            mf = jtt.TwoTowerModel(
                user_emb=ue, item_emb=ie, user_bias=ub, item_bias=ib,
                mean=3.0, config=jtt.TwoTowerConfig(rank=RANK))
            return jrec.RecModel(mf, JBiMap({u: i for i, u in enumerate(USERS)}),
                                 JBiMap({t: j for j, t in enumerate(ITEMS)}))
        return convert.rec_model_from_arrays(ue, ie, ub, ib, 3.0, RANK,
                                             USERS, ITEMS)


SIDES = ("jax", "port")


class Harness:
    """A running server of one side, its test client and fake clock, and
    the record of what the client saw."""

    def __init__(self, side, tmp_path, monkeypatch):
        self.side = side
        self.tmp = tmp_path
        self.monkeypatch = monkeypatch
        self.notes: list = []
        self.labels: dict = {}
        self.clk = side.clock.FakeClock()

    # -- storage ------------------------------------------------------------
    def rec_env(self):
        self.variant = str(self.tmp / "engine.json")
        with open(self.variant, "w") as f:
            json.dump({"id": "default", "version": "1",
                       "engineFactory": self.side.factory,
                       "algorithms": [{"name": "als",
                                       "params": {"rank": RANK}}]}, f)
        self.storage = self.side.storage_mod.Storage(
            {"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})
        self.add_instance("A", _arrays(1), minutes=0)

    def add_instance(self, label, arrays, minutes):
        sm = self.side.storage_mod
        start = T0 + dt.timedelta(minutes=minutes)
        iid = self.storage.get_meta_data_engine_instances().insert(
            sm.EngineInstance(
                id="", status="COMPLETED", start_time=start, end_time=start,
                engine_id="default", engine_version="1",
                engine_variant=os.path.abspath(self.variant),
                engine_factory=self.side.factory))
        self.storage.get_model_data_models().insert(sm.Model(
            iid, self.side.ser.serialize_model([self.side.model(arrays)])))
        self.labels[iid] = label
        return iid

    def add_b(self):
        return self.add_instance("B", _arrays(2), minutes=1)

    # -- the server -----------------------------------------------------------
    async def start(self, config, deployed=None, clock=True):
        self.server = self.side.qs.QueryServer(
            self.side.qs.ServerConfig(**config),
            storage=self.storage, deployed=deployed,
            clock=self.clk if clock else self.side.clock.SYSTEM_CLOCK,
            **self.side.server_kw)
        if clock:
            # the serving breaker runs on the system clock in both
            # packages; on the fake one its windows are scripted
            self.server._serving_breaker._clock = self.clk
        self.client = TestClient(TestServer(self.server.make_app()))
        await self.client.start_server()

    async def stop(self):
        await self.client.close()
        await self.server.shutdown()

    # -- what the client sees ---------------------------------------------------
    def mask(self, x):
        if isinstance(x, dict):
            return {k: ("<time>" if k in TIME_KEYS else self.mask(v))
                    for k, v in x.items()}
        if isinstance(x, list):
            return [self.mask(v) for v in x]
        if isinstance(x, str):
            for iid, label in self.labels.items():
                x = x.replace(iid, f"<{label}>")
            return x
        return x

    def note(self, *what):
        self.notes.append(self.mask(list(what)))

    async def post(self, path, payload=None, data=None, note=True):
        resp = await self.client.post(path, json=payload, data=data)
        body = await resp.json()
        rec = {"status": resp.status,
               "retryAfter": resp.headers.get("Retry-After"),
               "timing": "X-PIO-Server-Timing" in resp.headers,
               "body": body}
        if note:
            self.note(path, rec)
        return rec

    async def query(self, user="u1", num=5, note=True, **extra):
        return await self.post("/queries.json", {"user": user, "num": num,
                                                 **extra}, note=note)

    async def health(self, note=True):
        h = await (await self.client.get("/health")).json()
        picked = {k: h[k] for k in HEALTH_KEYS}
        picked["deployment"] = {k: h["deployment"][k] for k in DEPLOYMENT_KEYS}
        if note:
            self.note("/health", picked)
        return h

    async def wait(self, cond, what):
        for _ in range(2000):
            if cond():
                return
            await asyncio.sleep(0.002)
        raise AssertionError(f"timed out waiting for {what}")


def _same(a, b, where="record"):
    """Equal, floats within 1e-4 (the answers' scores)."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), where
        assert abs(a - b) <= 1e-4 * max(1.0, abs(a)), f"{where}: {a} vs {b}"
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), \
            f"{where}: keys {sorted(a)} vs {sorted(b)}"
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), f"{where}: {a} vs {b}"
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, f"{where}: {a!r} vs {b!r}"


SCENARIOS: dict = {}


def scenario(kind, **config):
    def deco(fn):
        SCENARIOS[fn.__name__] = (fn, kind, config)
        return fn
    return deco


# -- tests/test_query_server.py ------------------------------------------------------

@scenario("rec", server_access_key="sekret")
async def reload_and_stop_auth(h):
    await h.query("u3")
    assert (await h.post("/reload"))["status"] == 401
    assert (await h.post("/stop"))["status"] == 401
    h.add_b()
    r = await h.post("/reload?accessKey=sekret")
    assert r["status"] == 200 and r["body"]["message"] == "Reloaded"
    assert h.server.batcher.deployed is h.server.deployed
    await h.query("u3")  # B's answer
    assert (await h.post("/stop?accessKey=sekret"))["status"] == 200
    await h.health()


@scenario("rec", server_access_key="sk")
async def reload_during_in_flight_dispatch(h):
    gate = threading.Event()
    real = h.server.deployed.predict_batch

    def slow_predict_batch(payloads):
        gate.wait(timeout=5.0)
        return real(payloads)

    h.server.deployed.predict_batch = slow_predict_batch
    h.add_b()
    inflight = asyncio.create_task(h.query("u4", note=False))
    await h.wait(lambda: h.server.batcher.queue.qsize() == 0
                 and h.server.batcher._inflight, "the dispatch")
    reload_task = asyncio.create_task(h.post("/reload?accessKey=sk",
                                             note=False))
    await asyncio.sleep(0.02)
    gate.set()
    h.note("in flight (A)", await inflight)
    h.note("reload", await reload_task)
    assert h.server.batcher.deployed is h.server.deployed
    assert h.server.deployed.predict_batch is not slow_predict_batch
    await h.query("u4")  # B's answer
    await h.health()


@scenario("rec", server_access_key="sk")
async def reload_reresolves_max_in_flight(h):
    h.note("bound", h.server.batcher.max_in_flight)
    await h.query("u0")
    algo = h.side.rec.ALSAlgorithm
    h.monkeypatch.setattr(algo, "serving_thread_safe", False)
    h.add_b()
    await h.post("/reload?accessKey=sk")
    h.monkeypatch.undo()
    h.note("bound after reload", h.server.batcher.max_in_flight)
    assert h.server.batcher.max_in_flight == 1
    barrier = threading.Barrier(2)
    real = h.server.deployed.predict_batch

    def gated(payloads):
        try:
            barrier.wait(timeout=0.2)
        except threading.BrokenBarrierError:
            pass
        return real(payloads)

    h.server.deployed.predict_batch = gated
    got = await asyncio.gather(*(h.query(u, note=False) for u in ("u1", "u2")))
    h.note("two queries", got)
    assert barrier.broken  # one dispatch at a time


@scenario("rec", server_access_key="sk", smoke_queries=({"bogus": "nope"},))
async def reload_smoke_gate_rejects_and_keeps_old(h):
    old = h.server.deployed
    h.add_b()
    r = await h.post("/reload?accessKey=sk")
    assert r["status"] == 409 and "smoke" in r["body"]["error"]
    assert h.server.deployed is old and h.server.batcher.deployed is old
    dep = (await h.health())["deployment"]
    assert dep["lastReload"]["status"] == "rejected" and dep["rollbacks"] == 1
    await h.query("u5")  # still A


@scenario("rec", server_access_key="sk", smoke_queries=({"user": "u1", "num": 3},))
async def reload_smoke_gate_passes_and_pins_previous(h):
    old = h.server.deployed
    h.add_b()
    assert (await h.post("/reload?accessKey=sk"))["status"] == 200
    assert h.server.deployed is not old and h.server._previous is old
    dep = (await h.health())["deployment"]
    assert dep["probationActive"] is True
    await h.query("u5")  # B


PROBATION = dict(server_access_key="sk", reload_probation_sec=30.0,
                 algo_breaker_threshold=2)


def _boom(h, message):
    def boom(payloads):
        raise h.side.pol.ServingUnavailable(message)
    return boom


@scenario("rec", **PROBATION)
async def reload_probation_rollback_on_breaker_trip(h):
    old = h.server.deployed
    await h.query("u6")  # cached as last-good
    h.add_b()
    assert (await h.post("/reload?accessKey=sk"))["status"] == 200
    new = h.server.deployed
    new.predict_batch = _boom(h, "post-swap burst")
    for user in ("u6", "u7"):  # a cached answer, then the default body
        r = await h.query(user)
        assert r["status"] == 200 and r["body"]["degraded"] is True
    assert h.server.deployed is old and h.server.batcher.deployed is old
    assert h.server._previous is None
    dep = (await h.health())["deployment"]
    assert dep["lastReload"]["status"] == "rolled_back"
    r = await h.query("u6")
    assert "degraded" not in r["body"]


@scenario("rec", **PROBATION)
async def reload_probation_expires_and_releases_previous(h):
    h.add_b()
    assert (await h.post("/reload?accessKey=sk"))["status"] == 200
    new = h.server.deployed
    h.clk.advance(30.1)
    new.predict_batch = _boom(h, "late failure")
    for _ in range(2):
        assert (await h.query("u8"))["status"] == 200
    assert h.server.deployed is new and h.server._previous is None
    dep = (await h.health())["deployment"]
    assert dep["lastReload"]["status"] == "ok" and dep["rollbacks"] == 0


@scenario("rec", **PROBATION)
async def rollback_endpoint_restores_pinned_previous(h):
    await h.health()
    assert (await h.post("/rollback?accessKey=sk"))["status"] == 409
    old = h.server.deployed
    await h.query("u9")
    h.add_b()
    assert (await h.post("/reload?accessKey=sk"))["status"] == 200
    await h.query("u9")
    assert (await h.post("/rollback"))["status"] == 401
    r = await h.post("/rollback?accessKey=sk")
    assert r["status"] == 200 and h.server.deployed is old
    await h.health()
    await h.query("u9")
    assert (await h.post("/rollback?accessKey=sk"))["status"] == 409


@scenario("rec", **PROBATION)
async def rollback_endpoint_409_after_probation_expiry(h):
    h.add_b()
    assert (await h.post("/reload?accessKey=sk"))["status"] == 200
    new = h.server.deployed
    h.clk.advance(30.1)
    assert (await h.post("/rollback?accessKey=sk"))["status"] == 409
    assert h.server.deployed is new
    await h.health()


@scenario("rec", server_access_key="sk")
async def reload_loads_beside_live_instance(h):
    old = h.server.deployed
    gate = threading.Event()
    real_load = h.side.qs.load_deployed_engine

    def slow_load(config, storage, ctx):
        gate.wait(timeout=10.0)
        return real_load(config, storage, ctx)

    h.monkeypatch.setattr(h.side.qs, "load_deployed_engine", slow_load)
    h.add_b()
    reload_task = asyncio.create_task(h.post("/reload?accessKey=sk",
                                             note=False))
    await asyncio.sleep(0.05)  # the load is blocked on the gate
    for user in ("u1", "u2", "u3"):
        await h.query(user)  # A serves throughout
    assert h.server.deployed is old
    gate.set()
    h.note("reload", await reload_task)
    assert h.server.deployed is not old
    await h.query("u1")  # B


@scenario("rec")
async def query_server_draining_rejects_queries(h):
    await h.query("u2")
    h.server._drain_state.begin()
    r = await h.query("u2")
    assert r["status"] == 503 and r["retryAfter"]
    assert (await h.post("/reload?accessKey=x"))["status"] == 503
    assert (await h.health())["status"] == "draining"
    await h.server.drain_and_shutdown(deadline_sec=2.0)


# -- tests/test_streaming.py -----------------------------------------------------------

def _user_delta(h, base, to_seq=50):
    strong = np.zeros(RANK + 1, np.float32)
    strong[:RANK] = _arrays(1)[1][7] * 50  # u2's row moves
    return h.side.deltas.encode_delta(h.side.deltas.ModelDelta(
        base_instance=base, chain_base=8, from_seq=8, to_seq=to_seq,
        user_rows={2: strong}, item_rows={},
        max_event_time_us=1_700_000_000_000_000, n_events=3))


@scenario("rec", reload_probation_sec=300.0)
async def delta_rollback_restores_model_and_chain_position(h):
    base = await h.query("u2", num=1)
    r = await h.post("/delta", data=_user_delta(h, h.server.deployed.instance.id))
    assert r["body"]["status"] == "applied"
    after = await h.query("u2", num=1)
    assert after["body"]["itemScores"] != base["body"]["itemScores"]
    assert (await h.post("/rollback"))["status"] == 200
    assert (await h.health())["deployment"]["streaming"] is None
    again = await h.query("u2", num=1)
    assert again["body"]["itemScores"] == base["body"]["itemScores"]


@scenario("rec", smoke_queries=({"bogus": True},))
async def delta_smoke_gate_keeps_old_model(h):
    r = await h.post("/delta", data=_user_delta(h, h.server.deployed.instance.id))
    assert r["status"] == 409 and r["body"]["reason"] == "smoke-gate"
    assert (await h.health())["deployment"]["streaming"] is None
    assert (await h.query("u2", num=2))["status"] == 200


# -- tests/test_overload.py and tests/test_resilience.py: a stub engine ----------------

class _StubServing:
    def supplement(self, q):
        return q

    def serve(self, q, preds):
        return preds[0]


class _StubAlgo:
    """Answers ``{"label": 1, "source": "live"}``; ``gate`` (an Event)
    holds every call until set; ``mode`` ``slow`` holds on ``slow_gate``."""

    serving_thread_safe = True

    def __init__(self):
        self.gate = None
        self.mode = "ok"
        self.slow_gate = threading.Event()

    def query_class(self):
        return None

    def predict(self, model, query):
        if self.gate is not None:
            self.gate.wait(timeout=10.0)
        if self.mode == "slow":
            self.slow_gate.wait(timeout=10.0)
        return {"label": 1, "source": "live"}

    def batch_predict(self, model, pairs):
        return [(i, self.predict(model, q)) for i, q in pairs]


class _StubEngine:
    def __init__(self, algo):
        self._algo = algo

    def serving_and_algorithms(self, engine_params):
        return [self._algo], _StubServing()


def _stub_deployed(h, algo, config):
    sm = h.side.storage_mod
    instance = sm.EngineInstance(
        id="inst-1", status="COMPLETED", start_time=T0, end_time=None,
        engine_id="stub", engine_version="1", engine_variant="v",
        engine_factory="stub.Engine")
    return h.side.qs.DeployedEngine(
        _StubEngine(algo), h.side.core.EngineParams(), instance, [None],
        warmup=False, algo_deadline=config.get("algo_deadline_sec"),
        breaker_threshold=config.get("algo_breaker_threshold", 3),
        breaker_reset=config.get("algo_breaker_reset_sec", 10.0),
        clock=h.clk)


PAYLOAD = {"features": [1]}


@scenario("stub", admission_max_queue=2, max_in_flight=1)
async def query_server_429_at_the_door_when_queue_saturates(h):
    algo = h.algo
    algo.gate = threading.Event()
    tasks = [asyncio.create_task(h.post("/queries.json", PAYLOAD, note=False))]
    await h.wait(lambda: h.server.batcher._inflight, "the wedged dispatch")
    tasks += [asyncio.create_task(h.post("/queries.json", PAYLOAD, note=False))
              for _ in range(2)]
    await h.wait(lambda: h.server.batcher.queue.qsize() >= 2, "a full queue")
    r = await h.post("/queries.json", PAYLOAD)
    assert r["status"] == 429 and r["retryAfter"]
    algo.gate.set()
    h.note("queued", [await t for t in tasks])
    h2 = await h.health()
    assert h2["admission"]["rejected"] == 1 and h2["admission"]["queueMax"] == 2


@scenario("stub", query_timeout_sec=30.0, admission_max_queue=100,
          max_in_flight=1)
async def query_server_504_evicts_expired_queued_request(h):
    algo = h.algo
    algo.gate = threading.Event()
    first = asyncio.create_task(h.post("/queries.json", PAYLOAD, note=False))
    await h.wait(lambda: h.server.batcher._inflight, "the wedged dispatch")
    second = asyncio.create_task(h.post("/queries.json", PAYLOAD, note=False))
    await h.wait(lambda: h.server.batcher.queue.qsize() >= 1, "a queued query")
    h.clk.advance(31.0)  # the queued query's budget expires
    algo.gate.set()
    r1, r2 = await first, await second
    h.note("dispatched", r1, "shed", r2)
    assert r1["status"] == 200 and r2["status"] == 504 and r2["retryAfter"]
    assert (await h.health())["admission"]["shedExpired"] == 1
    status = await (await h.client.get("/")).json()
    h.note("shedExpired", status["shedExpired"])


@scenario("stub", admission_max_queue=10, brownout_enter_sec=1.0,
          brownout_exit_sec=2.0)
async def query_server_brownout_serves_degraded_then_recovers(h):
    assert (await h.post("/queries.json", PAYLOAD))["status"] == 200
    ctrl = h.server._admission
    h.note("decide", ctrl.decide(6))
    h.clk.advance(1.1)
    h.note("decide", ctrl.decide(6))
    r = await h.post("/queries.json", PAYLOAD)
    assert r["status"] == 200 and r["body"]["degraded"] is True
    assert (await h.health())["admission"]["brownoutActive"] is True
    h.clk.advance(0.1)
    await h.post("/queries.json", PAYLOAD)
    h.clk.advance(2.1)
    r = await h.post("/queries.json", PAYLOAD)
    assert "degraded" not in r["body"] and not ctrl.brownout_active
    await h.health()


@scenario("stub", clock=False, admission_target_ms=0.000001,
          admission_max_queue=1000)
async def query_server_adaptive_limiter_resizes_batcher_live(h):
    h.note("bound", h.server.batcher.max_in_flight)
    for _ in range(33):  # one window of completions over the target
        assert (await h.post("/queries.json", PAYLOAD, note=False))[
            "status"] == 200
    await h.wait(lambda: h.server.batcher.max_in_flight == 1, "the resize")
    h.note("after", h.server.batcher.max_in_flight,
           h.server._admission.current_limit())


@scenario("stub", query_timeout_sec=0.05, algo_deadline_sec=0.05,
          algo_breaker_threshold=1, algo_breaker_reset_sec=1.0)
async def query_server_degrades_on_deadline_and_recovers(h):
    algo = h.algo
    r = await h.post("/queries.json", PAYLOAD)  # cached as last-good
    assert r["status"] == 200 and "degraded" not in r["body"]
    assert (await h.health())["status"] == "ok"
    algo.mode = "slow"
    r = await h.post("/queries.json", PAYLOAD)  # the budget runs out
    assert r["status"] == 200 and r["body"]["degraded"] is True
    # the slow call ends past the algorithm deadline on the fake clock
    h.clk.advance(0.2)
    algo.slow_gate.set()
    await h.wait(lambda: not h.server.batcher._inflight, "the slow dispatch")
    health = await h.health()
    assert health["status"] == "degraded"
    assert health["servingBreaker"]["state"] == "open"
    algo.mode = "ok"
    r = await h.post("/queries.json", PAYLOAD)  # breaker open: at once
    assert r["body"]["degraded"] is True
    h.clk.advance(1.05)  # half-open probes through the healthy algorithm
    r = await h.post("/queries.json", PAYLOAD)
    assert "degraded" not in r["body"]
    health = await h.health()
    assert health["servingBreaker"]["state"] == "closed"
    assert health["degradedResponses"] >= 2


@scenario("stub", query_timeout_sec=0.05, algo_breaker_threshold=10)
async def query_server_unknown_query_degrades_to_default_body(h):
    h.algo.mode = "slow"
    try:
        r = await h.post("/queries.json", {"features": [9]})
        assert r["status"] == 200 and r["body"]["degraded"] is True
        assert "message" in r["body"]
    finally:
        h.algo.slow_gate.set()
    await h.wait(lambda: not h.server.batcher._inflight, "the slow dispatch")
    await h.health()


async def _run_scenario(name, side_name, tmp_path, monkeypatch):
    fn, kind, config = SCENARIOS[name]
    config = dict(config)
    clock = config.pop("clock", True)
    h = Harness(Side(side_name), tmp_path / side_name, monkeypatch)
    h.tmp.mkdir()
    if kind == "rec":
        h.rec_env()
        await h.start({"engine_variant": h.variant, **config}, clock=clock)
    else:
        h.storage = h.side.storage_mod.Storage(
            {"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})
        h.algo = _StubAlgo()
        await h.start(config, deployed=_stub_deployed(h, h.algo, config),
                      clock=clock)
    try:
        await fn(h)
    finally:
        await h.stop()
        h.storage.close()
    return h.notes


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name, tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_RETRIEVAL_MODE", "exact")
    records = {s: asyncio.run(_run_scenario(name, s, tmp_path, monkeypatch))
               for s in SIDES}
    assert len(records["port"]) == len(records["jax"]) > 0
    _same(records["jax"], records["port"], name)


# -- the CLI --------------------------------------------------------------------

def test_deploy_flags_build_the_references_config(monkeypatch):
    """``deploy``'s flags land in ServerConfig as the reference's do; unset
    admission flags keep the ``PIO_ADMISSION_*`` environment defaults."""
    monkeypatch.setenv("PIO_ADMISSION_MAX_QUEUE", "77")
    seen = {}
    monkeypatch.setattr(tqs, "serve_forever",
                        lambda config, storage, ctx: seen.update(c=config))
    argv = ["deploy", "-v", "e.json", "--device", "cpu", "--query-timeout",
            "0.5", "--algo-deadline", "0.1", "--algo-breaker-threshold", "4",
            "--algo-breaker-reset", "2.5", "--smoke-query", '{"user": "u1"}',
            "--smoke-query", '{"user": "u2", "num": 3}',
            "--reload-probation", "12", "--admission-target-ms", "40",
            "--no-adaptive-admission"]
    assert cli.main(argv) == 0
    c = seen["c"]
    assert (c.query_timeout_sec, c.algo_deadline_sec, c.algo_breaker_threshold,
            c.algo_breaker_reset_sec, c.reload_probation_sec) == \
        (0.5, 0.1, 4, 2.5, 12.0)
    assert c.smoke_queries == ({"user": "u1"}, {"user": "u2", "num": 3})
    assert (c.admission_max_queue, c.admission_target_ms,
            c.admission_adaptive) == (77, 40.0, False)
    assert cli.main(["deploy", "--device", "cpu", "--admission-max-queue",
                     "9"]) == 0
    assert seen["c"].admission_max_queue == 9 and seen["c"].admission_adaptive
    assert seen["c"].reload_probation_sec == jqs.ServerConfig().reload_probation_sec
    ref = set(jqs.ServerConfig.__dataclass_fields__)
    assert set(tqs.ServerConfig.__dataclass_fields__) <= ref


def test_undeploy_stops_a_port_server(tmp_path, capsys):
    h = Harness(Side("port"), tmp_path, None)
    h.rec_env()

    async def body(server, url):
        port = url.rsplit(":", 1)[1]
        loop = asyncio.get_running_loop()
        rc = await loop.run_in_executor(None, cli.main, [
            "undeploy", "--port", port, "--server-access-key", "wrong"])
        assert rc == 1 and not server._stop_event.is_set()
        rc = await loop.run_in_executor(None, cli.main, [
            "undeploy", "--port", port, "--server-access-key", "k"])
        assert rc == 0 and server._stop_event.is_set()

    _serve(h.storage, h.variant, body, server_access_key="k")
    assert "Shutting down" in capsys.readouterr().out


def _stream_argv(h, url, *extra):
    return ["stream", "-v", h.variant, "--state-dir", str(h.tmp / "state"),
            "--feed-path", str(h.tmp / "live.piolog"), "--replica", url,
            "--from-start", "--device", "cpu", "--batch-events", "100", *extra]


def test_stream_verb_once_status_and_dead_letter(tmp_path, capsys, monkeypatch):
    """``stream --once`` against a port server with a smoke gate: the
    delta passes the gate, is applied and pins the previous engine; the
    touched users' answers equal the JAX model's with the archived delta
    applied. ``--status`` prints what the JAX package's
    ``inspect_state_dir`` reads from the same state dir, ``--dead-letter``
    the poison event the fold rejected."""
    monkeypatch.setenv("PIO_RETRIEVAL_MODE", "exact")
    monkeypatch.delenv("PIO_STREAM_FUSED", raising=False)
    h = Harness(Side("port"), tmp_path, monkeypatch)
    h.rec_env()
    from incubator_predictionio_tpu_torch.data.event import DataMap, Event

    log = _PortLog(str(tmp_path / "live.piolog"))
    log.append(_events_of(ROUND1, Event, DataMap, 0))
    prev = treg.use_storage(h.storage)

    async def body(server, url):
        loop = asyncio.get_running_loop()
        base = server.deployed
        try:
            rc = await loop.run_in_executor(None, cli.main,
                                            _stream_argv(h, url, "--once"))
        finally:
            gc.unfreeze()
        assert rc == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["status"] == "applied" and out["deadLettered"] == 1
        assert out["ships"][0]["shipped"] == 1 and "error" not in out["ships"][0]
        assert server._previous is base and server._probation_active()
        assert server._last_reload["status"] == "delta"
        import aiohttp

        answers = {}
        async with aiohttp.ClientSession() as s:
            for u in ("u1", "u2", "u4"):
                async with s.post(f"{url}/queries.json",
                                  json={"user": u, "num": 10}) as r:
                    answers[u] = (await r.json())["itemScores"]
        return answers

    try:
        answers = _serve(h.storage, h.variant, body, server_access_key=None,
                         smoke_queries=({"user": "u1", "num": 3},))
    finally:
        treg.use_storage(prev)
    # the JAX model with the archived delta applied answers the same
    (path,) = [p for _, _, p in tdeltas.list_archived(str(tmp_path / "state"))]
    d = tdeltas.load_delta(path)
    jm = Side("jax").model(_arrays(1)).apply_delta(jdeltas.ModelDelta(**{
        f: getattr(d, f) for f in jdeltas.ModelDelta.__dataclass_fields__}))
    algo = jrec.ALSAlgorithm(jrec.ALSAlgorithmParams(rank=RANK))
    for u, got in answers.items():
        want = algo.predict(jm.prepare_for_serving(), jrec.Query(user=u, num=10))
        assert [s["item"] for s in got] == [s.item for s in want.item_scores]
        np.testing.assert_allclose([s["score"] for s in got],
                                   [s.score for s in want.item_scores],
                                   rtol=1e-4, atol=1e-4)
    state = str(tmp_path / "state")
    assert cli.main(["stream", "--state-dir", state, "--status"]) == 0
    status = json.loads(capsys.readouterr().out)
    assert status == json.loads(json.dumps(jup.inspect_state_dir(state),
                                           default=str))
    assert status["deadLettered"] == 1 and status["archivedDeltas"] == 1
    assert cli.main(["stream", "--state-dir", state, "--dead-letter"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    records, _, _ = twal.tail_frames(os.path.join(state, "deadletter.log"))
    assert [json.loads(x) for x in lines] == [r for _, r in records]
    assert len(lines) == 1 and "garbage" in lines[0]
    empty = str(tmp_path / "empty")
    assert cli.main(["stream", "--state-dir", empty, "--dead-letter"]) == 0
    assert "No dead letters." in capsys.readouterr().out
