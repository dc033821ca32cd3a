"""PyTorch port, the streaming slice as a whole, held against the JAX
package on the CPU at a small size (20 users × 30 items, rank 8, as in
tests/test_streaming.py:49):

- the port's ``EventLogFeed`` over logs written by the JAX package's
  ``EventLogEvents`` (and the JAX feed over a log written by the port's
  codec) yields the same events and ``[from_seq, to_seq)``, torn tails and
  mid-log bootstraps included;
- delta artifacts round-trip with their CRC; ``apply_delta`` is exact
  against the JAX ``RecModel.apply_delta``; the two-stage staleness overlay
  and its rebuild threshold; cold-start buckets bitwise and cold users
  served in ``hash`` mode;
- ``POST /delta`` exactly-once on the port's server (``device="cpu"``);
- ``StreamUpdater`` folding, archiving, shipping to the port's QueryServer
  over a real socket and committing: each delta's rows bitwise the JAX
  ``DeltaTrainer``'s in mode ``1`` on the same log, the served top-10 after
  the stream equal to the JAX delta-applied model's host answer; crash
  replay between ship and commit dedupes; the guard quarantines.
"""

import asyncio
import datetime as dt
import json
import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import aiohttp  # noqa: E402
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

from incubator_predictionio_tpu.data import DataMap as JDataMap  # noqa: E402
from incubator_predictionio_tpu.data import Event as JEvent  # noqa: E402
from incubator_predictionio_tpu.data.bimap import BiMap as JBiMap  # noqa: E402
from incubator_predictionio_tpu.data.storage.eventlog_backend import (  # noqa: E402
    EventLogEvents,
)
from incubator_predictionio_tpu.models import two_tower as jtt  # noqa: E402
from incubator_predictionio_tpu.serving import ann as jann  # noqa: E402
from incubator_predictionio_tpu.streaming import coldstart as jcs  # noqa: E402
from incubator_predictionio_tpu.streaming import delta as jdeltas  # noqa: E402
from incubator_predictionio_tpu.streaming import feed as jfeeds  # noqa: E402
from incubator_predictionio_tpu.streaming import trainer as jtr  # noqa: E402
from incubator_predictionio_tpu.templates import recommendation as jrec  # noqa: E402
from incubator_predictionio_tpu_torch import convert  # noqa: E402
from incubator_predictionio_tpu_torch.data.event import (  # noqa: E402
    DataMap,
    Event,
)
from incubator_predictionio_tpu_torch.data.storage import (  # noqa: E402
    EngineInstance,
    Model,
    Storage,
)
from incubator_predictionio_tpu_torch.models import two_tower as ttt  # noqa: E402
from incubator_predictionio_tpu_torch.native import format as tfmt  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext  # noqa: E402
from incubator_predictionio_tpu_torch.resilience import wal as twal  # noqa: E402
from incubator_predictionio_tpu_torch.server.query_server import (  # noqa: E402
    QueryServer,
    ServerConfig,
)
from incubator_predictionio_tpu_torch.serving import ann as tann  # noqa: E402
from incubator_predictionio_tpu_torch.streaming import coldstart as tcs  # noqa: E402
from incubator_predictionio_tpu_torch.streaming import delta as tdeltas  # noqa: E402
from incubator_predictionio_tpu_torch.streaming import feed as tfeeds  # noqa: E402
from incubator_predictionio_tpu_torch.streaming import guard as tguards  # noqa: E402
from incubator_predictionio_tpu_torch.streaming import updater as tup  # noqa: E402
from incubator_predictionio_tpu_torch.templates import recommendation as trec  # noqa: E402
from incubator_predictionio_tpu_torch.utils.serialization import (  # noqa: E402
    serialize_model,
)

UTC = dt.timezone.utc
T0 = dt.datetime(2023, 5, 1, tzinfo=UTC)
FACTORY = "incubator_predictionio_tpu_torch.templates.recommendation.RecommendationEngine"
CPU = DeviceContext.create(device="cpu")
LR, REG = 0.05, 1e-4


# -- helpers -----------------------------------------------------------------------

def _arrays(n_users=20, n_items=30, rank=8, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(n_users, rank)) * 0.3).astype(np.float32),
            (rng.normal(size=(n_items, rank)) * 0.3).astype(np.float32),
            np.zeros(n_users, np.float32), np.zeros(n_items, np.float32))


def _jax_model(n_users=20, n_items=30, rank=8, seed=0, lr=LR):
    ue, ie, ub, ib = _arrays(n_users, n_items, rank, seed)
    mf = jtt.TwoTowerModel(user_emb=ue, item_emb=ie, user_bias=ub,
                           item_bias=ib, mean=2.5,
                           config=jtt.TwoTowerConfig(rank=rank,
                                                     learning_rate=lr, reg=REG))
    return jrec.RecModel(mf, JBiMap({f"u{i}": i for i in range(n_users)}),
                         JBiMap({f"i{j}": j for j in range(n_items)}))


def _port_model(n_users=20, n_items=30, rank=8, seed=0, lr=LR):
    ue, ie, ub, ib = _arrays(n_users, n_items, rank, seed)
    return convert.rec_model_from_arrays(
        ue, ie, ub, ib, 2.5, rank, [f"u{i}" for i in range(n_users)],
        [f"i{j}" for j in range(n_items)], learning_rate=lr, reg=REG)


def _rate(cls, dm, user, item, rating, minute=0):
    return cls(event="rate", entity_type="user", entity_id=user,
               target_entity_type="item", target_entity_id=item,
               properties=dm({"rating": rating}),
               event_time=T0 + dt.timedelta(minutes=minute))


def _jrate(*a):
    return _rate(JEvent, JDataMap, *a)


def _trate(*a):
    return _rate(Event, DataMap, *a)


def _jax_store(tmp_path, events=()):
    store = EventLogEvents(str(tmp_path / "eventlog"))
    store.init(1)
    if events:
        store.insert_batch(list(events), 1)
    return store, store.log_path(1)


class _PortLog:
    """A PIOLOG01 log written with the port's codec alone."""

    def __init__(self, path):
        self.path = path
        self.interner = tfmt.Interner()
        self.n = 0
        with open(path, "wb") as f:
            f.write(tfmt.MAGIC)

    def append(self, events):
        with open(self.path, "ab") as f:
            for e in events:
                self.n += 1
                f.write(tfmt.encode_event(e, f"ev{self.n:08d}", self.interner))


def _same_events(port_events, jax_events):
    assert [e.to_json_dict() for e in port_events] == \
        [e.to_json_dict() for e in jax_events]


def _delta(cls, instance="inst-1", from_seq=8, to_seq=100, chain_base=8,
           user_rows=None, item_rows=None, **kw):
    return cls(base_instance=instance, chain_base=chain_base,
               from_seq=from_seq, to_seq=to_seq, user_rows=user_rows or {},
               item_rows=item_rows or {},
               max_event_time_us=1_700_000_000_000_000, n_events=3, **kw)


def _deploy_env(tmp_path, model, name="engine"):
    variant_path = str(tmp_path / f"{name}.json")
    with open(variant_path, "w") as f:
        json.dump({"id": name, "version": "1", "engineFactory": FACTORY,
                   "algorithms": [{"name": "als", "params": {"rank": 8}}]}, f)
    storage = Storage({"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})
    now = dt.datetime.now(UTC)
    iid = storage.get_meta_data_engine_instances().insert(EngineInstance(
        id="", status="COMPLETED", start_time=now, end_time=now,
        engine_id=name, engine_version="1",
        engine_variant=os.path.abspath(variant_path), engine_factory=FACTORY))
    storage.get_model_data_models().insert(Model(iid, serialize_model([model])))
    return storage, variant_path


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(storage, variant_path, body, **config):
    """The port's QueryServer on a real socket; ``body(server, url)``."""
    async def run():
        server = QueryServer(
            ServerConfig(engine_variant=variant_path, ip="127.0.0.1",
                         port=_free_port(), **config), storage=storage, ctx=CPU)
        await server.start()
        try:
            return await body(server, f"http://127.0.0.1:{server.config.port}")
        finally:
            await server.shutdown()

    return asyncio.run(run())


# -- the feed ---------------------------------------------------------------------

def test_feed_matches_jax_feed_with_torn_tail(tmp_path):
    store, src = _jax_store(tmp_path, [_jrate("u1", "i1", 4.0, 0),
                                       _jrate("u2", "i2", 3.0, 1)])
    with open(src, "rb") as f:
        base = f.read()
    store.insert_batch([_jrate("u3", "i3", 5.0, 2)], 1)
    with open(src, "rb") as f:
        full = f.read()
    suffix = full[len(base):]
    live = str(tmp_path / "live.piolog")
    with open(live, "wb") as f:
        f.write(base)
    pf, jf = tfeeds.EventLogFeed(live), jfeeds.EventLogFeed(live)
    pb, jb = pf.poll(), jf.poll()
    assert (pb.from_seq, pb.to_seq, pb.waiting) == \
        (jb.from_seq, jb.to_seq, jb.waiting) == (8, len(base), False)
    _same_events(pb.events, jb.events)
    for cut in (2, len(suffix) // 2, len(suffix) - 1):
        with open(live, "wb") as f:
            f.write(base + suffix[:cut])
        pb, jb = pf.poll(), jf.poll()
        assert pb.waiting and jb.waiting and pb.events == jb.events == []
        assert pf.position == jf.position == len(base)
    with open(live, "wb") as f:
        f.write(full)
    pb, jb = pf.poll(), jf.poll()
    _same_events(pb.events, jb.events)
    assert [e.entity_id for e in pb.events] == ["u3"]
    assert (pb.from_seq, pb.to_seq) == (jb.from_seq, jb.to_seq)
    assert pf.poll().events == []


def test_feed_bootstrap_mid_log_and_bounded_poll_match_jax(tmp_path):
    store, src = _jax_store(tmp_path, [_jrate("alice", "widget", 4.0)])
    with open(src, "rb") as f:
        mid = len(f.read())
    store.insert_batch([_jrate("alice", "widget", 5.0, 1)]
                       + [_jrate(f"u{i % 20}", f"i{i % 30}", 4.0, i)
                          for i in range(30)], 1)
    pb = tfeeds.EventLogFeed(src, from_seq=mid).poll()
    jb = jfeeds.EventLogFeed(src, from_seq=mid).poll()
    _same_events(pb.events, jb.events)
    assert pb.from_seq == jb.from_seq == mid and pb.to_seq == jb.to_seq
    assert (pb.events[0].entity_id, pb.events[0].target_entity_id) == \
        ("alice", "widget")
    with pytest.raises(ValueError, match="record boundary"):
        tfeeds.EventLogFeed(src, from_seq=mid + 3)
    # a tiny read bound: bounded polls, never 'waiting', exactly once
    pf, jf = tfeeds.EventLogFeed(src), jfeeds.EventLogFeed(src)
    while True:
        pb, jb = pf.poll(max_bytes=256), jf.poll(max_bytes=256)
        assert (pb.from_seq, pb.to_seq, pb.waiting) == \
            (jb.from_seq, jb.to_seq, jb.waiting)
        _same_events(pb.events, jb.events)
        if not pb.events:
            assert not pb.waiting
            break


def test_port_codec_log_reads_back_in_both_feeds(tmp_path):
    log = _PortLog(str(tmp_path / "port.piolog"))
    events = [_trate("u1", "i2", 4.5, 0), _trate("u2", "i3", 1, 1),
              Event(event="buy", entity_type="user", entity_id="u3",
                    target_entity_type="item", target_entity_id="i4",
                    properties=DataMap({"tags": ["a", None, True],
                                        "big": 2 ** 70, "n": {"x": -1.5}}),
                    event_time=T0, tags=("t1",), pr_id="pr")]
    log.append(events)
    with open(log.path, "ab") as f:
        f.write(tfmt.encode_tombstone("ev00000001"))
    pb = tfeeds.EventLogFeed(log.path).poll()
    jb = jfeeds.EventLogFeed(log.path).poll()
    _same_events(pb.events, jb.events)
    assert [e.event_id for e in pb.events] == ["ev00000001", "ev00000002",
                                               "ev00000003"]
    assert pb.events[2].properties["big"] == 2 ** 70
    with open(log.path, "rb") as f:
        data = f.read()
    assert pb.to_seq == jb.to_seq == tfmt.valid_extent(data) == len(data)
    assert [k for _, k, _ in tfmt.iter_records(data)].count(
        tfmt.KIND_EVENT) == 3


def test_feed_cursor_is_atomic(tmp_path):
    d = str(tmp_path / "state")
    assert tfeeds.read_cursor(d) is None
    tfeeds.write_cursor(d, {"seq": 123, "chain_base": 8, "base_instance": "i"})
    assert tfeeds.read_cursor(d)["seq"] == 123
    assert not os.path.exists(os.path.join(d, tfeeds.CURSOR_FILE + ".tmp"))


# -- deltas, apply, the IVF overlay, cold start -----------------------------------

def test_delta_roundtrip_crc_and_archive(tmp_path):
    d = _delta(tdeltas.ModelDelta, user_rows={1: np.arange(9, dtype=np.float32)})
    data = tdeltas.encode_delta(d)
    back = tdeltas.decode_delta(data)
    assert (back.from_seq, back.to_seq, back.n_rows) == (8, 100, 1)
    assert back.user_rows[1].tobytes() == d.user_rows[1].tobytes()
    bad = bytearray(data)
    bad[-1] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        tdeltas.decode_delta(bytes(bad))
    with pytest.raises(ValueError, match="magic"):
        tdeltas.decode_delta(b"not a delta")
    path = tdeltas.save_delta(str(tmp_path), d)
    assert tdeltas.load_delta(path).to_seq == 100
    assert tdeltas.list_archived(str(tmp_path)) == [(8, 100, path)]
    assert tdeltas.chain_from(str(tmp_path), None) == [path]
    assert tdeltas.chain_from(str(tmp_path), 100) == []
    sub = tdeltas.restrict_to_item_rows(
        _delta(tdeltas.ModelDelta, item_rows={2: np.ones(9, np.float32),
                                              7: np.ones(9, np.float32)}), 0, 5)
    assert set(sub.item_rows) == {2} and sub.to_seq == 100
    assert not _delta(tdeltas.ModelDelta, user_rows={
        0: np.full(9, np.nan, np.float32)}).finite()


def test_apply_delta_exact_vs_jax():
    row = np.arange(9, dtype=np.float32)
    rows = {"user_rows": {3: row}, "item_rows": {5: row * 2, 29: -row}}
    jm, tm = _jax_model(), _port_model()
    before = tm.mf.user_emb.copy()
    jn = jm.apply_delta(_delta(jdeltas.ModelDelta, **rows))
    tn = tm.apply_delta(_delta(tdeltas.ModelDelta, **rows))
    for name in ("user_emb", "item_emb", "user_bias", "item_bias"):
        assert getattr(tn.mf, name).tobytes() == getattr(jn.mf, name).tobytes()
    assert tm.mf.user_emb.tobytes() == before.tobytes()  # build-beside
    assert tn.user_map is tm.user_map and not tn.mf.prepared
    with pytest.raises(ValueError, match="outside"):
        tm.apply_delta(_delta(tdeltas.ModelDelta, user_rows={99: row}))
    with pytest.raises(ValueError, match="shape"):
        tm.apply_delta(_delta(tdeltas.ModelDelta, user_rows={1: row[:4]}))
    # a model without host tables: with sharded serving state the delta
    # routes to the owning shards (sharding/serve.py); a bare model does
    # what the reference's does — no refusal, empty 0-d tables back
    bare = ttt.TwoTowerModel(config=tm.mf.config).with_row_updates({}, {})
    jbare = jtt.TwoTowerModel(config=jm.mf.config).with_row_updates({}, {})
    for name in ("user_emb", "item_emb", "user_bias", "item_bias"):
        got, want = getattr(bare, name), getattr(jbare, name)
        assert got.shape == want.shape == () and got.dtype == want.dtype
        assert np.isnan(got) and np.isnan(want)
    sharded = ttt.TwoTowerModel(mean=tm.mf.mean, config=tm.mf.config)
    sharded._tables = {
        "ue": torch.from_numpy(np.concatenate(
            [tm.mf.user_emb, tm.mf.user_bias[:, None]], 1)),
        "ie": torch.from_numpy(np.concatenate(
            [tm.mf.item_emb, tm.mf.item_bias[:, None]], 1))}
    sharded._n_users, sharded._n_items = tm.mf.n_users, tm.mf.n_items
    sharded._build_sharded(2)
    routed = sharded.with_row_updates(**rows)
    assert routed._sharded is not sharded._sharded
    assert routed.user_emb is None and sharded.user_emb is None
    for table, name, idx in (("ie", "item_emb", 29), ("ue", "user_emb", 3)):
        np.testing.assert_array_equal(
            routed._tables[table][idx].numpy()[:8],
            getattr(jn.mf, name)[idx])


def test_two_stage_overlay_serves_current_rows_like_jax(monkeypatch):
    """tests/test_streaming.py:841 on both packages: an item moved into
    u0's taste is served first by the pruned probe with its post-update
    score, and the port's two-stage answer equals the JAX package's."""
    monkeypatch.setenv("PIO_RETRIEVAL_MODE", "two_stage")
    monkeypatch.setenv("PIO_RETRIEVAL_PARTITIONS", "16")
    monkeypatch.setenv("PIO_RETRIEVAL_NPROBE", "2")
    n_items, rank, target = 400, 8, 123
    jm = _jax_model(n_users=10, n_items=n_items, seed=3)
    tm = _port_model(n_users=10, n_items=n_items, seed=3)
    jm.mf._ivf = jann.build_ivf(jm.mf.item_emb, jm.mf.item_bias,
                                key=jann.build_key(n_items))
    tm.mf._ivf = tann.build_ivf(tm.mf.item_emb, tm.mf.item_bias,
                                key=tann.build_key(n_items))
    row = np.zeros(rank + 1, np.float32)
    row[:rank] = tm.mf.user_emb[0] * 40
    jn = jm.apply_delta(_delta(jdeltas.ModelDelta, item_rows={target: row}))
    tn = tm.apply_delta(_delta(tdeltas.ModelDelta, item_rows={target: row}))
    assert tn.mf._ivf.stale_count == 1 and tn.mf._ivf.stats()["stale_rows"] == 1
    assert tm.mf._ivf.stale_count == 0  # the old view is untouched
    np.testing.assert_array_equal(tn.mf._ivf.stale_emb, jn.mf._ivf.stale_emb)
    tn.mf.prepare_for_serving(device="cpu")
    uidx = np.arange(10, dtype=np.int32)
    pi, ps = ttt.TwoTowerMF.recommend_batch(tn.mf, uidx, 5)
    ei, es = ttt.TwoTowerMF.recommend_batch(tn.mf, uidx, 5, _force_exact=True)
    assert pi[0][0] == ei[0][0] == target
    np.testing.assert_allclose(ps[0][0], es[0][0], rtol=1e-5)
    ji, js = jtt.TwoTowerMF.recommend_batch(jn.mf, uidx, 5)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(ps, js, rtol=1e-5, atol=1e-5)


def test_two_stage_stale_threshold_rebuilds(monkeypatch):
    monkeypatch.setenv("PIO_RETRIEVAL_MODE", "two_stage")
    monkeypatch.setenv("PIO_RETRIEVAL_PARTITIONS", "8")
    monkeypatch.setenv("PIO_STREAM_STALE_REBUILD_FRAC", "0.01")
    tm = _port_model(n_users=10, n_items=200, seed=5)
    jm = _jax_model(n_users=10, n_items=200, seed=5)
    tm.mf._ivf = tann.build_ivf(tm.mf.item_emb, tm.mf.item_bias,
                                key=tann.build_key(200))
    jm.mf._ivf = jann.build_ivf(jm.mf.item_emb, jm.mf.item_bias,
                                key=jann.build_key(200))
    rows = {j: np.ones(9, np.float32) * 0.1 for j in range(10)}
    tn = tm.apply_delta(_delta(tdeltas.ModelDelta, item_rows=rows))
    jn = jm.apply_delta(_delta(jdeltas.ModelDelta, item_rows=rows))
    # 5% stale > 1%: re-clustered from the updated tables, like the JAX one
    assert tn.mf._ivf.stale_count == 0 and tn.mf._ivf is not tm.mf._ivf
    np.testing.assert_array_equal(tn.mf._ivf.member_ids, jn.mf._ivf.member_ids)
    np.testing.assert_array_equal(tn.mf._ivf.centroids, jn.mf._ivf.centroids)


def test_coldstart_buckets_bitwise_and_cold_users_served(monkeypatch):
    a = tcs.ColdStartBuckets.build(rank=8, buckets=16, seed=0)
    b = jcs.ColdStartBuckets.build(rank=8, buckets=16, seed=0)
    assert a.user_rows.tobytes() == b.user_rows.tobytes()
    assert a.item_rows.tobytes() == b.item_rows.tobytes()
    for eid in ("stranger", "x", "u1"):
        assert a.user_bucket(eid) == b.user_bucket(eid)
        assert a.item_bucket(eid) == b.item_bucket(eid)
    jm = _jax_model()
    tm = _port_model().prepare_for_serving(CPU)
    jalgo = jrec.ALSAlgorithm(jrec.ALSAlgorithmParams(rank=8))
    talgo = trec.ALSAlgorithm(trec.ALSAlgorithmParams(rank=8))
    cold, known = ("stranger", 5, None), ("u1", 5, None)
    banned = ("stranger", 5, ("i3",))

    def both(u, num, bl):
        return (talgo.predict(tm, trec.Query(user=u, num=num, black_list=bl)),
                jalgo.predict(jm, jrec.Query(user=u, num=num, black_list=bl)))

    monkeypatch.delenv("PIO_COLDSTART_MODE", raising=False)
    off_known, _ = both(*known)
    assert both(*cold)[0].item_scores == ()
    monkeypatch.setenv("PIO_COLDSTART_MODE", "hash")
    for q in (cold, known, banned):
        t, j = both(*q)
        assert [s.item for s in t.item_scores] == [s.item for s in j.item_scores]
        np.testing.assert_allclose([s.score for s in t.item_scores],
                                   [s.score for s in j.item_scores], rtol=1e-5)
    assert both(*known)[0] == off_known  # known users untouched
    assert "i3" not in [s.item for s in both(*banned)[0].item_scores]
    got = dict(talgo.batch_predict(tm, [(0, trec.Query(user="stranger", num=5)),
                                        (1, trec.Query(user="u1", num=5))]))
    assert got[0] == both(*cold)[0] and got[1] == off_known


# -- POST /delta ------------------------------------------------------------------

def test_delta_endpoint_exactly_once(tmp_path):
    """tests/test_streaming.py:403 on the port's server (device="cpu")."""
    model = _port_model()
    storage, variant_path = _deploy_env(tmp_path, model)
    inst = storage.get_meta_data_engine_instances().get_latest_completed(
        "engine", "1", os.path.abspath(variant_path)).id
    strong = np.zeros(9, np.float32)
    strong[:8] = model.mf.item_emb[7] * 50  # u2 now loves item i7
    D = tdeltas.ModelDelta
    d1 = _delta(D, inst, 8, 50, user_rows={2: strong})
    d2 = _delta(D, inst, 50, 90, user_rows={5: strong * 0.5})
    gap = _delta(D, inst, 300, 400)
    wrong_base = _delta(D, "other-instance", 90, 120)
    nan = _delta(D, inst, 90, 120, user_rows={1: np.full(9, np.nan, np.float32)})

    async def run():
        server = QueryServer(ServerConfig(engine_variant=variant_path),
                             storage=storage, ctx=CPU)
        client = TestClient(TestServer(server.make_app()))
        await client.start_server()

        async def post(d):
            resp = await client.post("/delta", data=tdeltas.encode_delta(d))
            return resp.status, await resp.json()

        try:
            before = server.deployed
            status, body = await post(d2)
            assert status == 409 and body["reason"] == "out-of-order"
            status, body = await post(d1)
            assert status == 200 and body["status"] == "applied"
            assert body["lastDeltaSeq"] == 50 and server.deployed is not before
            assert server.batcher.deployed is server.deployed
            # an applied delta pins the engine it replaced for probation
            assert server._previous is before and server._probation_active()
            assert server._last_reload == {"status": "delta",
                                           "instanceId": inst,
                                           "deltaRange": [8, 50]}
            q = await (await client.post(
                "/queries.json", json={"user": "u2", "num": 3})).json()
            assert q["itemScores"][0]["item"] == "i7"
            status, body = await post(d1)
            assert status == 200 and body["status"] == "duplicate"
            assert (await post(d2))[1]["status"] == "applied"
            status, body = await post(gap)
            assert status == 409 and body["lastDeltaSeq"] == 90
            status, body = await post(wrong_base)
            assert status == 409 and body["reason"] == "base-mismatch"
            status, body = await post(nan)
            assert status == 409 and body["reason"] == "non-finite"
            resp = await client.post("/delta", data=b"not a delta")
            assert resp.status == 400
            health = await (await client.get("/health")).json()
            stream = health["deployment"]["streaming"]
            assert stream["lastDeltaSeq"] == 90 and stream["chainBase"] == 8
            assert stream["applied"] == 2 and stream["deduped"] == 1
            assert stream["maxEventTimeUs"] == 1_700_000_000_000_000
            assert stream["stalenessSeconds"] is not None
            assert len(server.delta_apply_s) == 2
        finally:
            await client.close()
            await server.shutdown()

    asyncio.run(run())


def test_delta_endpoint_access_key_and_body_limits(tmp_path, monkeypatch):
    """``server_access_key`` guards ``/delta`` as the reference's
    ``_authorized`` does; ``/delta`` alone reads bodies past aiohttp's 1 MiB
    default, up to ``DELTA_MAX_BYTES``."""
    from incubator_predictionio_tpu_torch.server import query_server as tqs

    model = _port_model()
    storage, variant_path = _deploy_env(tmp_path, model)
    inst = storage.get_meta_data_engine_instances().get_latest_completed(
        "engine", "1", os.path.abspath(variant_path)).id
    payload = tdeltas.encode_delta(_delta(
        tdeltas.ModelDelta, inst, 8, 50,
        user_rows={2: np.ones(9, np.float32)}))

    async def body(server, url):
        loop = asyncio.get_running_loop()
        async with aiohttp.ClientSession() as s:
            for qs in ("", "?accessKey=wrong"):
                async with s.post(f"{url}/delta{qs}", data=payload) as r:
                    assert r.status == 401
            # over 1 MiB: /delta reads it (a bad artifact, 400), the
            # queries route keeps aiohttp's limit (413)
            async with s.post(f"{url}/delta?accessKey=k",
                              data=b"x" * (2 << 20)) as r:
                assert r.status == 400
            async with s.post(f"{url}/queries.json",
                              data=b" " * (2 << 20)) as r:
                assert r.status == 413
            monkeypatch.setattr(tqs, "DELTA_MAX_BYTES", len(payload) - 1)
            async with s.post(f"{url}/delta?accessKey=k", data=payload) as r:
                assert r.status == 413

            async def chunked():  # no Content-Length: the stream read bounds it
                yield payload

            async with s.post(f"{url}/delta?accessKey=k", data=chunked()) as r:
                assert r.status == 413
            monkeypatch.setattr(tqs, "DELTA_MAX_BYTES", len(payload))
        assert server._delta_state is None
        wrong = tup.HttpTransport(access_key="wrong")
        with pytest.raises(tup.ShipError, match="401"):
            await loop.run_in_executor(None, wrong.ship, url, payload)
        ans = await loop.run_in_executor(
            None, tup.HttpTransport(access_key="k").ship, url, payload)
        assert ans["status"] == "applied" and ans["lastDeltaSeq"] == 50

    _serve(storage, variant_path, body, server_access_key="k")


# -- the updater over a real socket ------------------------------------------------

#: two rounds of live events (a duplicate pair, a poison event, an event
#: name outside the signal)
ROUND1 = [("u1", "i2", 5.0), ("u1", "i3", 1.0), ("u4", "i2", 4.0),
          ("u7", "i9", "garbage"), ("u2", "i5", 2.5)]
ROUND2 = [("u1", "i2", 3.0), ("u9", "i2", 4.0), ("u2", "i11", 5.0)]


def _events_of(round_, cls, dm, minute0):
    return [_rate(cls, dm, u, i, r, minute0 + k)
            for k, (u, i, r) in enumerate(round_)]


def _updater(tmp_path, storage, variant_path, transport=None, **kw):
    model, inst, names, defaults = tup.load_base_model(
        variant_path, storage, ctx=CPU)
    cfg = tup.UpdaterConfig(state_dir=str(tmp_path / "state"),
                            feed_path=str(tmp_path / "live.piolog"),
                            micro_batch=2, **kw)
    return tup.StreamUpdater(cfg, model, inst, transport=transport,
                             event_names=names, default_values=defaults,
                             ctx=CPU)


def test_updater_streams_into_the_served_model(tmp_path, monkeypatch):
    monkeypatch.delenv("PIO_STREAM_FUSED", raising=False)  # auto → the host pass
    storage, variant_path = _deploy_env(tmp_path, _port_model())
    log = _PortLog(str(tmp_path / "live.piolog"))
    log.append([_trate("u0", "i0", 3.0)])  # before the updater: never folded
    jm = _jax_model()
    jt = jtr.DeltaTrainer(jm.mf.user_emb, jm.mf.user_bias, jm.mf.item_emb,
                          jm.mf.item_bias, jm.mf.mean,
                          dict(jm.user_map.items()), dict(jm.item_map.items()),
                          learning_rate=LR, reg=REG, micro_batch=2)
    monkeypatch.setenv("PIO_STREAM_FUSED", "1")

    async def body(server, url):
        loop = asyncio.get_running_loop()
        up = _updater(tmp_path, storage, variant_path, replicas=(url,))
        monkeypatch.delenv("PIO_STREAM_FUSED")
        assert up.trainer.device.type == "cpu"
        assert (await loop.run_in_executor(None, up.run_once))["status"] == "idle"
        jmodel, outs = jm, []
        for n, round_ in enumerate((ROUND1, ROUND2)):
            log.append(_events_of(round_, Event, DataMap, 10 * n))
            out = await loop.run_in_executor(None, up.run_once)
            assert out["status"] == "applied", out
            async with aiohttp.ClientSession() as s:
                async with s.get(f"{url}/health") as r:
                    stream = (await r.json())["deployment"]["streaming"]
            assert stream["lastDeltaSeq"] == out["toSeq"]
            outs.append(out)
            # the JAX trainer in mode 1 on the same events: the delta's rows
            monkeypatch.setenv("PIO_STREAM_FUSED", "1")
            jres, jpoison = jt.fold(_events_of(round_, JEvent, JDataMap, 10 * n))
            monkeypatch.delenv("PIO_STREAM_FUSED")
            d = tdeltas.load_delta(tdeltas.chain_from(
                up.config.state_dir, out["fromSeq"])[0])
            assert (d.from_seq, d.to_seq) == (out["fromSeq"], out["toSeq"])
            for side in ("user_rows", "item_rows"):
                assert {k: v.tobytes() for k, v in getattr(d, side).items()} \
                    == {k: v.tobytes() for k, v in getattr(jres, side).items()}
            jmodel = jmodel.apply_delta(jdeltas.ModelDelta(
                base_instance="x", chain_base=0, from_seq=d.from_seq,
                to_seq=d.to_seq, user_rows=jres.user_rows,
                item_rows=jres.item_rows))
        assert outs[0]["deadLettered"] == 1 and outs[0]["events"] == 4
        assert outs[1]["fromSeq"] == outs[0]["toSeq"]
        assert server.deployed.models[0].mf.user_emb.tobytes() == \
            up.model.mf.user_emb.tobytes()
        jalgo = jrec.ALSAlgorithm(jrec.ALSAlgorithmParams(rank=8))
        async with aiohttp.ClientSession() as s:
            for u in ("u1", "u2", "u4", "u9", "u0"):
                async with s.post(f"{url}/queries.json",
                                  json={"user": u, "num": 10}) as r:
                    got = (await r.json())["itemScores"]
                want = jalgo.predict(jmodel, jrec.Query(user=u, num=10))
                assert [x["item"] for x in got] == \
                    [x.item for x in want.item_scores]
                np.testing.assert_allclose(
                    [x["score"] for x in got],
                    [x.score for x in want.item_scores], rtol=1e-5, atol=1e-5)
        assert (await loop.run_in_executor(None, up.run_once))["status"] == "idle"
        # a restarted updater resumes from the cursor and re-folds nothing
        up2 = _updater(tmp_path, storage, variant_path, replicas=(url,))
        assert (await loop.run_in_executor(None, up2.run_once))["status"] == "idle"
        assert server._delta_state["applied"] == 2
        records, _, status = twal.tail_frames(
            os.path.join(up.config.state_dir, tup.DEAD_LETTER_FILE))
        assert status == "ok" and len(records) == 1
        assert records[0][1]["event"]["properties"]["rating"] == "garbage"
        info = tup.inspect_state_dir(up.config.state_dir)
        assert info["archivedDeltas"] == 2 and info["deadLettered"] == 1
        assert info["chainHead"] == outs[1]["toSeq"]

    _serve(storage, variant_path, body)


class _Boom(Exception):
    pass


def test_updater_crash_between_ship_and_commit_dedupes(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_STREAM_FUSED", "1")
    storage, variant_path = _deploy_env(tmp_path, _port_model())
    log = _PortLog(str(tmp_path / "live.piolog"))

    async def body(server, url):
        loop = asyncio.get_running_loop()
        up = _updater(tmp_path, storage, variant_path, replicas=(url,),
                      from_start=True)
        log.append(_events_of(ROUND2, Event, DataMap, 0))

        def exploding_commit(to_seq, delta_head=None):
            raise _Boom()

        up._commit = exploding_commit
        with pytest.raises(_Boom):
            await loop.run_in_executor(None, up.run_once)
        assert server._delta_state["applied"] == 1  # the ship DID land
        served = server.deployed.models[0].mf.user_emb.copy()
        # restart: the same range re-folds and re-archives; the replica's
        # /health says it has it, so nothing re-ships
        up2 = _updater(tmp_path, storage, variant_path, replicas=(url,),
                       from_start=True)
        out = await loop.run_in_executor(None, up2.run_once)
        assert out["status"] == "applied"
        assert out["ships"][0]["shipped"] == 0
        assert server._delta_state["applied"] == 1
        # a replay of the archived range is a counted duplicate
        path = tdeltas.chain_from(up2.config.state_dir, None)[0]
        with open(path, "rb") as f:
            answer = await loop.run_in_executor(
                None, up2.transport.ship, url, f.read())
        assert answer["status"] == "duplicate"
        assert server._delta_state["deduped"] == 1
        assert server.deployed.models[0].mf.user_emb.tobytes() == \
            served.tobytes() == up2.model.mf.user_emb.tobytes()
        assert (await loop.run_in_executor(None, up2.run_once))["status"] == "idle"

    _serve(storage, variant_path, body)


class _NoShip:
    def applied_seq(self, url):
        return None, None

    def ship(self, url, payload):
        raise AssertionError("a quarantined stream must not ship")


def test_guard_quarantines_before_shipping(tmp_path, monkeypatch):
    """tests/test_streaming.py:668: an absurd learning rate detonates the
    touched rows; the stream quarantines durably and ships nothing."""
    monkeypatch.setenv("PIO_STREAM_FUSED", "1")
    storage, variant_path = _deploy_env(tmp_path, _port_model(lr=1e9))
    log = _PortLog(str(tmp_path / "live.piolog"))
    log.append([_trate("u1", "i2", 5.0)])
    up = _updater(tmp_path, storage, variant_path, replicas=("fake://r",),
                  from_start=True, transport=_NoShip())
    out = up.run_once()
    assert out["status"] == "quarantined" and "norm" in out["marker"]["reason"]
    up2 = _updater(tmp_path, storage, variant_path, replicas=("fake://r",),
                   from_start=True, transport=_NoShip())
    assert up2.run_once()["status"] == "quarantined"
    assert tguards.read_quarantine(str(tmp_path / "state")) is not None
    assert tup.inspect_state_dir(str(tmp_path / "state"))["quarantine"]


def test_guard_recall_probe_and_reference_compare(monkeypatch):
    """The recall probe prepares the applied copy on the device it is given
    and trips under its floor; compare_to_reference agrees with the JAX
    package's on the same models."""
    from incubator_predictionio_tpu.streaming import guard as jguards

    monkeypatch.setenv("PIO_RETRIEVAL_MODE", "two_stage")
    monkeypatch.setenv("PIO_RETRIEVAL_PARTITIONS", "16")
    monkeypatch.setenv("PIO_RETRIEVAL_NPROBE", "2")
    tm = _port_model(n_users=40, n_items=400, seed=3)
    tm.mf._ivf = tann.build_ivf(tm.mf.item_emb, tm.mf.item_bias,
                                key=tann.build_key(400))
    cfg = tguards.GuardConfig(recall_every=2, recall_floor=0.0)
    guard = tguards.DivergenceGuard(cfg)
    assert guard.maybe_check_recall(tm, "cpu") is None and not tm.mf.prepared
    assert guard.maybe_check_recall(tm, "cpu") is None  # the probe ran
    assert tm.mf.prepared and tm.mf._device.type == "cpu"
    cfg.recall_floor = 1.01
    guard.maybe_check_recall(tm, "cpu")
    assert "under floor" in guard.maybe_check_recall(tm, "cpu")
    monkeypatch.setenv("PIO_RETRIEVAL_MODE", "exact")
    row = np.full(9, 0.5, np.float32)
    rows = {"user_rows": {1: row}, "item_rows": {3: row, 7: -row}}
    jm, tb = _jax_model(), _port_model()
    got = tguards.compare_to_reference(
        tb.apply_delta(_delta(tdeltas.ModelDelta, **rows)), tb,
        sample_users=8, device="cpu")
    want = jguards.compare_to_reference(
        jm.apply_delta(_delta(jdeltas.ModelDelta, **rows)), jm, sample_users=8)
    assert got["topk_overlap"] == want["topk_overlap"] < 1.0
    np.testing.assert_allclose(got["score_rmse"], want["score_rmse"], rtol=1e-6)


# -- a device-resident (card-trained) model -------------------------------------

def _resident(model):
    """``model`` with its tables resident (the layout ``TwoTowerMF.fit``
    leaves with ``gather="device"``): fused ``[n, rank+1]`` tensors, no
    host arrays."""
    mf = model.mf
    res = ttt.TwoTowerModel(mean=mf.mean, config=mf.config)
    res._tables = {
        "ue": torch.from_numpy(np.column_stack([mf.user_emb, mf.user_bias])),
        "ie": torch.from_numpy(np.column_stack([mf.item_emb, mf.item_bias]))}
    res._n_users, res._n_items = mf.n_users, mf.n_items
    res._device = torch.device("cpu")
    out = trec.RecModel(res, model.user_map, model.item_map)
    out.coldstart = None
    return out


def test_resident_model_takes_a_delta_like_jax():
    """with_row_updates on a resident model pulls its tables once
    (ensure_host, as reference two_tower.py:481) and scatters on the host:
    the delta-applied tables are bitwise the JAX model's."""
    row = np.arange(9, dtype=np.float32)
    rows = {"user_rows": {3: row, 19: -row}, "item_rows": {5: row * 2, 29: -row}}
    jm, tm = _jax_model(), _resident(_port_model())
    assert tm.mf.device_resident and tm.mf.user_emb is None
    jn = jm.apply_delta(_delta(jdeltas.ModelDelta, **rows))
    tn = tm.apply_delta(_delta(tdeltas.ModelDelta, **rows))
    for name in ("user_emb", "item_emb", "user_bias", "item_bias"):
        assert getattr(tn.mf, name).tobytes() == getattr(jn.mf, name).tobytes()
    assert not tn.mf.device_resident and tm.mf.device_resident  # build-beside
    assert torch.equal(tm.mf._tables["ue"][3, :8], torch.from_numpy(
        _arrays()[0][3]))  # the receiver's tables are untouched


def test_updater_and_guard_start_on_a_resident_model(tmp_path, monkeypatch):
    """The card-trained path on the CPU: a resident model persisted with
    ``RecModel.save`` deploys resident; the updater starts on it (its one
    table pull), folds a round and ships it to ``/delta``, where the served
    resident model takes the delta; the served tables equal the JAX
    delta-applied model's bitwise. The guard's reference comparison runs on
    resident models and agrees with the JAX package's."""
    from incubator_predictionio_tpu.streaming import guard as jguards
    from incubator_predictionio_tpu_torch.core import PersistentModelManifest
    from incubator_predictionio_tpu_torch.core.controller import class_path

    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "fs"))
    monkeypatch.setenv("PIO_STREAM_FUSED", "1")
    storage, variant_path = _deploy_env(tmp_path, _port_model())
    iid = storage.get_meta_data_engine_instances().get_all()[0].id
    assert _resident(_port_model()).save(
        f"{iid}_0", trec.ALSAlgorithmParams(rank=8), CPU)
    storage.get_model_data_models().insert(Model(iid, serialize_model(
        [PersistentModelManifest(class_path(trec.RecModel))])))
    log = _PortLog(str(tmp_path / "live.piolog"))
    jm = _jax_model()
    jt = jtr.DeltaTrainer(jm.mf.user_emb, jm.mf.user_bias, jm.mf.item_emb,
                          jm.mf.item_bias, jm.mf.mean,
                          dict(jm.user_map.items()), dict(jm.item_map.items()),
                          learning_rate=LR, reg=REG, micro_batch=2)

    async def body(server, url):
        loop = asyncio.get_running_loop()
        assert server.deployed.models[0].mf.device_resident
        up = _updater(tmp_path, storage, variant_path, replicas=(url,),
                      from_start=True)
        assert up.model.mf.device_resident and up.model.mf.user_emb is not None
        log.append(_events_of(ROUND2, Event, DataMap, 0))
        out = await loop.run_in_executor(None, up.run_once)
        assert out["status"] == "applied", out
        jres, _ = jt.fold(_events_of(ROUND2, JEvent, JDataMap, 0))
        want = jm.apply_delta(jdeltas.ModelDelta(
            base_instance="x", chain_base=0, from_seq=out["fromSeq"],
            to_seq=out["toSeq"], user_rows=jres.user_rows,
            item_rows=jres.item_rows))
        served = server.deployed.models[0].mf
        assert not served.device_resident  # the delta-applied host model
        for name in ("user_emb", "item_emb", "user_bias", "item_bias"):
            assert getattr(served, name).tobytes() == \
                getattr(want.mf, name).tobytes() == \
                getattr(up.model.mf, name).tobytes()

    _serve(storage, variant_path, body)
    row = np.full(9, 0.5, np.float32)
    rows = {"user_rows": {1: row}, "item_rows": {3: row, 7: -row}}
    base = _resident(_port_model())
    got = tguards.compare_to_reference(
        _resident(base.apply_delta(_delta(tdeltas.ModelDelta, **rows))),
        _resident(_port_model()), sample_users=8, device="cpu")
    want = jguards.compare_to_reference(
        _jax_model().apply_delta(_delta(jdeltas.ModelDelta, **rows)),
        _jax_model(), sample_users=8)
    assert got["topk_overlap"] == want["topk_overlap"] < 1.0
    np.testing.assert_allclose(got["score_rmse"], want["score_rmse"], rtol=1e-6)
