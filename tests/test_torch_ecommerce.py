"""PyTorch port, the e-commerce template against the JAX package's, on the
CPU: ``read_training`` over the same stored events, ``predict`` and the
vectorized ``batch_predict`` on the same converted model and events (a
known user, an unknown user with views: predictSimilar, an unknown user
without: popularity; the live unavailable-items constraint, unseen-only,
categories, white and black lists), the TTL constraint cache, pickling,
and train → persist → deploy through ``create_workflow``.

Tolerances: every comparison is exact. ``read_training`` is bitwise, and
scoring is host numpy in both packages, the same BLAS call chain for the
serial and the batched paths, so ids and scores are bitwise equal.
"""

import dataclasses
import datetime as dt
import json
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from incubator_predictionio_tpu.data import event as jevent  # noqa: E402
from incubator_predictionio_tpu.data.bimap import BiMap as JBiMap  # noqa: E402
from incubator_predictionio_tpu.data.storage import base as jbase  # noqa: E402
from incubator_predictionio_tpu.data.storage import registry as jreg  # noqa: E402
from incubator_predictionio_tpu.models.two_tower import (  # noqa: E402
    TwoTowerConfig as JTwoTowerConfig,
    TwoTowerModel as JTwoTowerModel,
)
from incubator_predictionio_tpu.parallel.mesh import MeshContext  # noqa: E402
from incubator_predictionio_tpu.resilience.clock import FakeClock  # noqa: E402
from incubator_predictionio_tpu.serving import TTLCache as JTTLCache  # noqa: E402
from incubator_predictionio_tpu.templates import ecommerce as jec  # noqa: E402
from incubator_predictionio_tpu_torch import convert  # noqa: E402
from incubator_predictionio_tpu_torch.core.workflow.create_workflow import (  # noqa: E402
    WorkflowConfig,
    create_workflow,
)
from incubator_predictionio_tpu_torch.data import event as tevent  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import base as tbase  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext  # noqa: E402
from incubator_predictionio_tpu_torch.server.query_server import (  # noqa: E402
    ServerConfig,
    load_deployed_engine,
)
from incubator_predictionio_tpu_torch.serving import TTLCache as TTTLCache  # noqa: E402
from incubator_predictionio_tpu_torch.serving import cache as tcache  # noqa: E402
from incubator_predictionio_tpu_torch.templates import ecommerce as tec  # noqa: E402
from incubator_predictionio_tpu_torch.utils.serialization import (  # noqa: E402
    deserialize_model,
    serialize_model,
)
from tests.test_torch_similarproduct import pickle_names_torch  # noqa: E402

CPU = DeviceContext.create(device="cpu")
FACTORY = "incubator_predictionio_tpu_torch.templates.ecommerce.ECommerceEngine"
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
N_USERS, N_ITEMS, RANK = 30, 60, 8
CATS = ("a", "b", "c")


def _event_dicts(unavailable=("i3", "i7", "i11")):
    rng = np.random.default_rng(21)
    out = []
    for i in range(N_ITEMS):
        out.append({"event": "$set", "entityType": "item", "entityId": f"i{i}",
                    "properties": {"categories": [CATS[i % 3]] + (["x"] if i % 5 == 0 else [])},
                    "eventTime": T0.isoformat()})
    j = 0
    for u in range(N_USERS):
        for i in rng.choice(N_ITEMS, 6, replace=False):
            ev = "buy" if rng.random() < 0.3 else "view"
            out.append({"event": ev, "entityType": "user", "entityId": f"u{u}",
                        "targetEntityType": "item", "targetEntityId": f"i{i}",
                        "eventTime": (T0 + dt.timedelta(seconds=j)).isoformat()})
            j += 1
    # views of users the model will not know (trained before them)
    for u, items in (("new1", (4, 9, 14)), ("new2", (20,))):
        for i in items:
            out.append({"event": "view", "entityType": "user", "entityId": u,
                        "targetEntityType": "item", "targetEntityId": f"i{i}",
                        "eventTime": (T0 + dt.timedelta(seconds=j)).isoformat()})
            j += 1
    for k, items in enumerate((("i1",), unavailable)):  # the latest wins
        out.append({"event": "$set", "entityType": "constraint",
                    "entityId": "unavailableItems",
                    "properties": {"items": list(items)},
                    "eventTime": (T0 + dt.timedelta(seconds=j + k)).isoformat()})
    return out


def _fill(reg, base, event_mod, path, dicts):
    storage = reg.Storage({"PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
                           "PIO_STORAGE_SOURCES_DB_PATH": path})
    app_id = storage.get_meta_data_apps().insert(base.App(0, "ec"))
    events = storage.get_events()
    events.init(app_id)
    events.insert_batch([event_mod.Event.from_json_dict(d) for d in dicts], app_id)
    return storage


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ec")
    dicts = _event_dicts()
    js = _fill(jreg, jbase, jevent, str(tmp / "jax.db"), dicts)
    ts = _fill(treg, tbase, tevent, str(tmp / "torch.db"), dicts)
    prev_j, prev_t = jreg.use_storage(js), treg.use_storage(ts)
    yield js, ts
    jreg.use_storage(prev_j)
    treg.use_storage(prev_t)
    js.close()
    ts.close()


def test_read_training_is_the_references(stores):
    params = dict(app_name="ec")
    want = jec.DataSource(jec.DataSourceParams(**params)).read_training(
        MeshContext.create())
    got = tec.DataSource(tec.DataSourceParams(**params)).read_training(CPU)
    got.sanity_check()
    assert list(got.users.items()) == list(want.users.items())
    assert list(got.items.items()) == list(want.items.items())
    assert got.categories == want.categories
    for name in ("u_idx", "i_idx", "weight", "buy_counts"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    with pytest.raises(RuntimeError, match="no process group was joined"):
        tec.DataSource(tec.DataSourceParams(**params)).read_training(
            DeviceContext(torch.device("cpu"), process_index=0, process_count=2))


def _arrays():
    rng = np.random.default_rng(22)
    ue = rng.standard_normal((N_USERS, RANK)).astype(np.float32)
    ie = rng.standard_normal((N_ITEMS, RANK)).astype(np.float32)
    ub = (0.1 * rng.standard_normal(N_USERS)).astype(np.float32)
    ib = (0.1 * rng.standard_normal(N_ITEMS)).astype(np.float32)
    pop = rng.integers(0, 20, N_ITEMS).astype(np.float32)
    pop[5] = pop[6] = 30.0  # a tie at the top of the popularity fallback
    norm = ie / (np.linalg.norm(ie, axis=1, keepdims=True) + 1e-9)
    cats = {f"i{i}": (CATS[i % 3],) + (("x",) if i % 5 == 0 else ())
            for i in range(N_ITEMS)}
    return ue, ie, ub, ib, pop, norm, cats


@pytest.fixture(scope="module")
def models():
    ue, ie, ub, ib, pop, norm, cats = _arrays()
    users = [f"u{u}" for u in range(N_USERS)]
    items = [f"i{i}" for i in range(N_ITEMS)]
    jm = jec.ECommModel(
        mf=JTwoTowerModel(user_emb=ue, item_emb=ie, user_bias=ub, item_bias=ib,
                          mean=2.5, config=JTwoTowerConfig(rank=RANK)),
        user_map=JBiMap({k: i for i, k in enumerate(users)}),
        item_map=JBiMap({k: i for i, k in enumerate(items)}),
        categories=cats, popularity=pop, item_vecs_norm=norm)
    tm = convert.ecomm_model_from_arrays(ue, ie, ub, ib, 2.5, RANK, users, items,
                                         cats, pop, norm)
    return jm.prepare_for_serving(), tm.prepare_for_serving(CPU)


QUERIES = [
    dict(user="u0", num=10),
    dict(user="u1", num=5, categories=("a", "x")),
    dict(user="u2", num=8, white_list=tuple(f"i{j}" for j in range(0, 40, 2)) + ("nope",)),
    dict(user="u3", num=10, black_list=("i0", "i2", "ghost")),
    dict(user="new1", num=6),                    # predictSimilar
    dict(user="new2", num=6, categories=("b",)),  # predictSimilar, filtered
    dict(user="stranger", num=7),                # popularity
    dict(user="stranger", num=3, black_list=("i5",)),
    dict(user="u4", num=0),
    dict(user="u5", num=500),
]


def _algos(unseen_only, ttl=0.0):
    ja = jec.ECommAlgorithm(jec.ECommAlgorithmParams(app_name="ec", unseen_only=unseen_only))
    ta = tec.ECommAlgorithm(tec.ECommAlgorithmParams(app_name="ec", unseen_only=unseen_only))
    ja._constraint_cache = JTTLCache(ttl)
    ta._constraint_cache = TTTLCache(ttl)
    return ja, ta


def _as_jax(res):
    return [(s.item, s.score) for s in res.item_scores]


@pytest.mark.parametrize("unseen_only", [True, False])
def test_predict_and_batch_predict_bitwise_against_jax(stores, models, unseen_only):
    jm, tm = models
    ja, ta = _algos(unseen_only)
    jq = [jec.Query(**q) for q in QUERIES]
    tq = [tec.Query(**q) for q in QUERIES]
    serial = [ta.predict(tm, q) for q in tq]
    for q, got, w in zip(jq, serial, (ja.predict(jm, q) for q in jq)):
        assert _as_jax(got) == _as_jax(w), q
        banned = {"i3", "i7", "i11"} | set(q.black_list or ())
        assert not banned & {s.item for s in got.item_scores}
    assert len(serial[0].item_scores) == 10 and serial[8].item_scores == ()
    # the batched path: row for row the serial answers and the JAX batch
    batch = dict(ta.batch_predict(tm, list(enumerate(tq))))
    jbatch = dict(ja.batch_predict(jm, list(enumerate(jq))))
    for i in range(len(tq)):
        assert batch[i] == serial[i], QUERIES[i]
        assert _as_jax(batch[i]) == _as_jax(jbatch[i])


def test_fallbacks_take_their_paths(stores, models):
    _, tm = models
    _, ta = _algos(False)
    # an unknown user with views scores by the summed cosine of those views
    res = ta.predict(tm, tec.Query(user="new2", num=3))
    qv = tm.item_vecs_norm[[tm.item_map["i20"]]]
    s = (qv @ tm.item_vecs_norm.T).sum(axis=0)
    mask = np.zeros(N_ITEMS, np.float32)
    mask[[tm.item_map[i] for i in ("i3", "i7", "i11")]] = -np.inf
    top = np.argsort(-(s + mask), kind="stable")[:3]
    assert [r.item for r in res.item_scores] == [f"i{int(i)}" for i in top]
    # no history at all: popularity
    res = ta.predict(tm, tec.Query(user="stranger", num=2))
    assert [r.score for r in res.item_scores] == [30.0, 30.0]


def test_constraint_cache_under_a_fake_clock(stores, models):
    """The constraint read goes through the TTL cache: the default TTL reads
    once per window, a read per query with TTL 0 (the reference's)."""
    _, tm = models
    _, ta = _algos(False)
    clock = FakeClock()
    ta._constraint_cache = TTTLCache(1.0, clock=clock)
    m0 = tcache._MISSES.value
    for _ in range(5):
        ta.predict(tm, tec.Query(user="u0", num=3))
    assert tcache._MISSES.value - m0 == 1
    clock.advance(1.5)
    ta.batch_predict(tm, [(0, tec.Query(user="u0", num=3))])
    assert tcache._MISSES.value - m0 == 2
    _, ta0 = _algos(False, ttl=0.0)
    for _ in range(3):
        ta0.predict(tm, tec.Query(user="u0", num=3))
    assert tcache._MISSES.value - m0 == 5


def test_pickled_model_serves_the_same_and_holds_no_tensor(stores, models):
    _, tm = models
    _, ta = _algos(True)
    blob = serialize_model([tm])
    assert not pickle_names_torch(blob) and not pickle_names_torch(pickle.dumps(tm))
    (back,) = deserialize_model(blob)
    back.prepare_for_serving(CPU)
    for q in QUERIES:
        assert ta.predict(back, tec.Query(**q)) == ta.predict(tm, tec.Query(**q))


def test_convert_round_trips(models):
    jm, tm = models
    for name in ("user_emb", "item_emb", "user_bias", "item_bias"):
        assert getattr(tm.mf, name).tobytes() == getattr(jm.mf, name).tobytes()
    assert tm.mf.mean == jm.mf.mean and tm.mf.config.rank == RANK
    assert tm.popularity.tobytes() == jm.popularity.tobytes()
    assert tm.item_vecs_norm.tobytes() == jm.item_vecs_norm.tobytes()
    assert tm.categories == jm.categories
    with pytest.raises(ValueError):
        ue, ie, ub, ib, pop, norm, cats = _arrays()
        convert.ecomm_model_from_arrays(ue, ie, ub, ib, 0.0, RANK,
                                        [f"u{u}" for u in range(N_USERS)],
                                        [f"i{i}" for i in range(N_ITEMS)],
                                        cats, pop[:3], norm)


def test_train_persist_deploy_query(stores, tmp_path):
    _, storage = stores
    path = str(tmp_path / "engine.json")
    with open(path, "w") as f:
        json.dump({"id": "ec", "version": "1", "engineFactory": FACTORY,
                   "datasource": {"params": {"appName": "ec"}},
                   "algorithms": [{"name": "ecomm", "params": {
                       "appName": "ec", "rank": 8, "numIterations": 5,
                       "seed": 1}}]}, f)
    iid = create_workflow(WorkflowConfig(engine_variant=path, device="cpu"), storage)
    assert not pickle_names_torch(storage.get_model_data_models().get(iid).models)
    deployed = load_deployed_engine(ServerConfig(engine_variant=path), storage,
                                    ctx=CPU, warmup=False)
    model = deployed.models[0]
    assert model.serving_info()["path"] == "host-numpy"
    algo = deployed.algorithms[0]
    algo._constraint_cache = TTTLCache(0.0)
    for q in ({"user": "u0", "num": 4}, {"user": "new1", "num": 4},
              {"user": "stranger", "num": 4, "categories": ["a"]}):
        res = deployed.predict(q)
        assert len(res.item_scores) == 4
        assert not {"i3", "i7", "i11"} & {s.item for s in res.item_scores}
        assert deployed.predict_batch([q])[0] == res
    # the trained towers score a known user as numpy does
    mf = model.mf
    r = model.user_map["u0"]
    s = mf.user_emb[r] @ mf.item_emb.T + mf.item_bias + mf.user_bias[r] + mf.mean
    res = algo.predict(model, tec.Query(user="u0", num=3))
    for item in res.item_scores:
        assert item.score == float(s[model.item_map[item.item]])
    assert dataclasses.asdict(res)["item_scores"]
