"""PyTorch port, the serving-time event reads and the sequential template
from stored events, held against the JAX package on the CPU over the same
events (each package's own sqlite store, filled from the same JSON):

- ``LEventStore.find_by_entity`` / ``find_by_entities`` / ``find``: the
  same events in the same order (event time, then id), ``limit`` and
  ``latest`` included; the memory backend's ``find_by_entities`` too;
- the sequential ``DataSource.read_training``: sessions, token space and
  rows bitwise the reference's;
- ``{"user": U}`` queries: the history read from the store, served
  top-10 equal to the JAX template's on the same weights up to near-ties
  at the cut-off (scores within the sequential serving band, 1e-2: served
  scores are bf16 values, tests/test_torch_sequential_serving.py), and
  bitwise the port's own ``recentItems`` answer for the same history; a
  user the store does not know answers empty.
"""

import datetime as dt

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from incubator_predictionio_tpu.data import event as jevent  # noqa: E402
from incubator_predictionio_tpu.data import store as jstore  # noqa: E402
from incubator_predictionio_tpu.data.bimap import BiMap as JBiMap  # noqa: E402
from incubator_predictionio_tpu.data.storage import base as jbase  # noqa: E402
from incubator_predictionio_tpu.data.storage import memory as jmem  # noqa: E402
from incubator_predictionio_tpu.data.storage import registry as jreg  # noqa: E402
from incubator_predictionio_tpu.models import transformer as jtr  # noqa: E402
from incubator_predictionio_tpu.parallel.mesh import MeshContext  # noqa: E402
from incubator_predictionio_tpu.templates import sequential as jseq  # noqa: E402
from incubator_predictionio_tpu_torch import convert  # noqa: E402
from incubator_predictionio_tpu_torch.data import event as tevent  # noqa: E402
from incubator_predictionio_tpu_torch.data import store as tstore  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import base as tbase  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import memory as tmem  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402
from incubator_predictionio_tpu_torch.models import transformer as ttr  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext  # noqa: E402
from incubator_predictionio_tpu_torch.templates import sequential as tseq  # noqa: E402

CPU = DeviceContext.create(device="cpu")
T0 = dt.datetime(2026, 2, 1, tzinfo=dt.timezone.utc)
N_ITEMS, MAX_LEN, D, HEADS, LAYERS = 60, 16, 32, 2, 2
TOL = 1e-2  # tests/test_torch_sequential_serving.py's score band


def _event_dicts(seed=4):
    """view/buy sessions of 30 users (0-40 items each; equal timestamps
    for the id tie-break), rate events, events without a target or with
    another target type, all with explicit ids and creation times so both
    stores hold the same rows."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(900):
        u = int(rng.integers(0, 30))
        name = str(rng.choice(["view", "view", "buy", "rate"]))
        d = {"event": name, "entityType": "user", "entityId": f"u{u}",
             "targetEntityType": "item",
             "targetEntityId": f"i{int(rng.integers(0, N_ITEMS))}",
             "eventTime": (T0 + dt.timedelta(seconds=int(j // 3))).isoformat(),
             "eventId": f"e{j:05d}"}
        if name == "rate":
            d["properties"] = {"rating": 3.0}
        out.append(d)
    out.append({"event": "view", "entityType": "user", "entityId": "u1",
                "eventTime": T0.isoformat(), "eventId": "no-target"})
    out.append({"event": "view", "entityType": "user", "entityId": "u2",
                "targetEntityType": "page", "targetEntityId": "p1",
                "eventTime": T0.isoformat(), "eventId": "page"})
    out.append({"event": "view", "entityType": "user", "entityId": "solo",
                "targetEntityType": "item", "targetEntityId": "i1",
                "eventTime": T0.isoformat(), "eventId": "solo"})
    for d in out:
        d["creationTime"] = T0.isoformat()
    return out


def _fill(reg, base, event_mod, path, dicts, app_name="seq"):
    storage = reg.Storage({"PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
                           "PIO_STORAGE_SOURCES_DB_PATH": path})
    app_id = storage.get_meta_data_apps().insert(base.App(0, app_name))
    events = storage.get_events()
    events.init(app_id)
    events.insert_batch([event_mod.Event.from_json_dict(d) for d in dicts], app_id)
    return storage


@pytest.fixture()
def stores(tmp_path):
    dicts = _event_dicts()
    js = _fill(jreg, jbase, jevent, str(tmp_path / "jax.db"), dicts)
    ts = _fill(treg, tbase, tevent, str(tmp_path / "torch.db"), dicts)
    prev_j, prev_t = jreg.use_storage(js), treg.use_storage(ts)
    yield js, ts
    jreg.use_storage(prev_j)
    treg.use_storage(prev_t)
    js.close()
    ts.close()


def _same(got, want):
    got, want = list(got), list(want)
    assert [e.to_json_dict() for e in got] == [e.to_json_dict() for e in want]


@pytest.mark.parametrize("kw", [
    {},
    {"limit": 5},
    {"limit": 5, "latest": False},
    {"event_names": ("view", "buy"), "target_entity_type": "item",
     "limit": MAX_LEN},
    {"event_names": ("buy",), "latest": False},
    {"start_time": T0 + dt.timedelta(seconds=40),
     "until_time": T0 + dt.timedelta(seconds=200), "limit": 0},
    {"target_entity_id": "i3"},
], ids=["all", "limit", "oldest", "history", "buys", "window", "target"])
def test_find_by_entity_matches_jax(stores, kw):
    got_l, want_l = tstore.LEventStore(), jstore.LEventStore()
    for user in ("u1", "u7", "solo", "nobody"):
        _same(got_l.find_by_entity("seq", "user", user, **kw),
              want_l.find_by_entity("seq", "user", user, **kw))
    with pytest.raises(ValueError, match="Invalid app name"):
        got_l.find_by_entity("nope", "user", "u1")


@pytest.mark.parametrize("latest", [True, False])
def test_find_by_entities_and_find_match_jax(stores, latest):
    ids = ["u3", "u9", "nobody", "u3", "solo"]
    got_l, want_l = tstore.LEventStore(), jstore.LEventStore()
    for cap in (None, 3):
        got = got_l.find_by_entities("seq", "user", ids, limit_per_entity=cap,
                                     event_names=("view", "buy"), latest=latest)
        want = want_l.find_by_entities("seq", "user", ids, limit_per_entity=cap,
                                       event_names=("view", "buy"), latest=latest)
        assert list(got) == list(want) == ["u3", "u9", "nobody", "solo"]
        for k in got:
            _same(got[k], want[k])
            # each entity's list is exactly its single read
            _same(got[k], got_l.find_by_entity(
                "seq", "user", k, event_names=("view", "buy"), limit=cap,
                latest=latest))
    _same(got_l.find("seq", entity_type="user", limit=25),
          want_l.find("seq", entity_type="user", limit=25))


def test_memory_find_by_entities_matches_jax():
    dicts = _event_dicts()
    got_s, want_s = tmem.MemEvents(), jmem.MemEvents()
    got_s.insert_batch([tevent.Event.from_json_dict(d) for d in dicts], 1)
    want_s.insert_batch([jevent.Event.from_json_dict(d) for d in dicts], 1)
    for kw in ({}, {"limit_per_entity": 4, "reversed": True},
               {"event_names": ("buy",), "target_entity_type": "item"}):
        got = got_s.find_by_entities(1, "user", ["u5", "u0", "x"], **kw)
        want = want_s.find_by_entities(1, "user", ["u5", "u0", "x"], **kw)
        assert list(got) == list(want)
        for k in got:
            _same(got[k], want[k])
    _same(got_s.find(1, entity_id="u5", limit=3, reversed=True),
          want_s.find(1, entity_id="u5", limit=3, reversed=True))


def test_sequential_read_training_is_the_references(stores):
    params = dict(app_name="seq", max_len=MAX_LEN)
    want = jseq.DataSource(jseq.DataSourceParams(**params)).read_training(
        MeshContext.create())
    got = tseq.DataSource(tseq.DataSourceParams(**params)).read_training(CPU)
    got.sanity_check()
    assert dict(got.item_map.items()) == dict(want.item_map.items())
    assert got.sequences.dtype == want.sequences.dtype == np.int32
    assert got.sequences.tobytes() == want.sequences.tobytes()
    # the sessions themselves: each user's view/buy items in event order
    sessions, sharded = tseq.DataSource(
        tseq.DataSourceParams(**params))._collect_sessions(CPU)
    jsessions, _ = jseq.DataSource(
        jseq.DataSourceParams(**params))._collect_sessions(MeshContext.create())
    assert not sharded and sessions == jsessions
    assert sessions["solo"] == ["i1"] and "page" not in sum(sessions.values(), [])
    assert got.sequences.shape[0] == sum(len(s) >= 2 for s in sessions.values())


def _models():
    """One set of random weights in both packages, the item map in the
    stored events' first-seen order, as read_training builds it."""
    cfg = ttr.TransformerConfig(vocab_size=N_ITEMS + 1, max_len=MAX_LEN,
                                d_model=D, n_heads=HEADS, n_layers=LAYERS)
    params = ttr.init_params_numpy(cfg, 3)
    td = tseq.DataSource(tseq.DataSourceParams(
        app_name="seq", max_len=MAX_LEN)).read_training(CPU)
    ids = [iid for iid, _ in sorted(td.item_map.items(), key=lambda kv: kv[1])]
    ids += [f"i{j}" for j in range(N_ITEMS) if f"i{j}" not in td.item_map]
    jcfg = jtr.TransformerConfig(vocab_size=N_ITEMS + 1, max_len=MAX_LEN,
                                 d_model=D, n_heads=HEADS, n_layers=LAYERS)
    jm = jtr.TransformerModel(jax.tree.map(jnp.asarray, params),
                              JBiMap({iid: j + 1 for j, iid in enumerate(ids)}),
                              jcfg)
    tm = convert.transformer_model_from_params(params, ids, n_heads=HEADS)
    return jm, tm.prepare_for_serving(CPU)


def test_user_queries_match_jax_and_the_recent_items_answer(stores):
    jm, tm = _models()
    jalgo = jseq.TransformerAlgorithm(jseq.TransformerAlgorithmParams(
        app_name="seq", max_len=MAX_LEN))
    talgo = tseq.TransformerAlgorithm(tseq.TransformerAlgorithmParams(
        app_name="seq", max_len=MAX_LEN))
    users = [f"u{u}" for u in range(0, 30, 3)]
    tq = [(i, tseq.Query(user=u, num=10)) for i, u in enumerate(users)]
    jq = [(i, jseq.Query(user=u, num=10)) for i, u in enumerate(users)]
    got, want = dict(talgo.batch_predict(tm, tq)), dict(jalgo.batch_predict(jm, jq))
    served = 0
    for i, u in enumerate(users):
        history = talgo._history(tq[i][1], tm)
        assert history == jalgo._history(jq[i][1], jm)
        assert len(history) <= MAX_LEN
        newest = [e.target_entity_id for e in reversed(list(
            tstore.LEventStore().find_by_entity(
                "seq", "user", u, event_names=("view", "buy"),
                target_entity_type="item", limit=MAX_LEN)))]
        assert history == newest  # the latest max_len, newest last
        g = [(s.item, s.score) for s in got[i].item_scores]
        w = [(s.item, s.score) for s in want[i].item_scores]
        if not history:
            assert g == w == []
            continue
        served += 1
        assert len(g) == len(w) == 10 and not {x for x, _ in g} & set(history)
        cut = w[-1][1]
        wscore = dict(w)
        rows = jtr.TransformerRecommender.next_item_scores(jm, np.stack(
            [jseq.encode_session(history, jm.item_map, MAX_LEN)]))[0]
        for iid in {x for x, _ in g} ^ set(wscore):
            assert abs(float(rows[jm.item_map[iid]]) - cut) <= TOL, (u, g, w)
        for iid, s in g:
            assert abs(s - float(rows[jm.item_map[iid]])) <= TOL
        # the same history sent as recentItems: the same answer, bitwise
        recent = talgo.predict(tm, tseq.Query(recent_items=tuple(history), num=10))
        assert [(s.item, s.score) for s in recent.item_scores] == g
    assert served == len(users)
    # a user the store does not know: an empty answer, as the reference's
    assert talgo.predict(tm, tseq.Query(user="nobody")) == tseq.PredictedResult()
    assert jalgo.predict(jm, jseq.Query(user="nobody")).item_scores == ()
