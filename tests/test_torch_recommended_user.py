"""PyTorch port, the recommended-user template against the JAX package's, on
the CPU: ``read_training`` over the same stored follow events, serving on
the same converted table (the ``score > 0`` cut, self-exclusion, white and
black lists; batch against serial), the fit on planted data, pickling, and
train → persist → deploy through ``create_workflow``.

Tolerances, each measured on this file's data: ``read_training`` bitwise;
served scores within q bf16 ulps of the JAX package's for a query of q
users (each ``qv_scores`` entry within 1 ulp,
tests/test_torch_similarproduct.py), ids equal up to near-ties at the last
place; the port's batch path bitwise its serial path; the fits (different
inits) overlap > 0.8 in their top-10 lists and recover the planted
neighbours within 0.05 of each other.
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
from incubator_predictionio_tpu.parallel.mesh import MeshContext  # noqa: E402
from incubator_predictionio_tpu.templates import recommended_user as jru  # noqa: E402
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
from incubator_predictionio_tpu_torch.templates import _similarity as tsim  # noqa: E402
from incubator_predictionio_tpu_torch.templates import recommended_user as tru  # noqa: E402
from incubator_predictionio_tpu_torch.utils.serialization import (  # noqa: E402
    deserialize_model,
    serialize_model,
)
from tests.test_torch_similarproduct import pickle_names_torch  # noqa: E402

CPU = DeviceContext.create(device="cpu")
FACTORY = ("incubator_predictionio_tpu_torch.templates.recommended_user."
           "RecommendedUserEngine")
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
N_GROUPS, GROUP, PER_USER = 10, 11, 10
N_USERS = N_GROUPS * GROUP


def _event_dicts():
    """Each user follows PER_USER others of its group: a user's 10 planted
    neighbours are its group-mates (as followed users)."""
    rng = np.random.default_rng(8)
    out = []
    for u in range(0, N_USERS, 3):
        out.append({"event": "$set", "entityType": "user", "entityId": f"u{u}",
                    "properties": {"name": f"n{u}"}, "eventTime": T0.isoformat()})
    out.append({"event": "$set", "entityType": "user", "entityId": "solo",
                "properties": {}, "eventTime": T0.isoformat()})
    j = 0
    for u in range(N_USERS):
        g = u // GROUP
        mates = [m for m in range(g * GROUP, (g + 1) * GROUP) if m != u]
        for t in rng.choice(mates, PER_USER, replace=False):
            out.append({"event": "follow", "entityType": "user", "entityId": f"u{u}",
                        "targetEntityType": "user", "targetEntityId": f"u{t}",
                        "eventTime": (T0 + dt.timedelta(seconds=j)).isoformat()})
            j += 1
    out.append({"event": "follow", "entityType": "user", "entityId": "u1",
                "targetEntityType": "item", "targetEntityId": "i1",
                "eventTime": (T0 + dt.timedelta(seconds=j)).isoformat()})
    return out


def _fill(reg, base, event_mod, path, dicts):
    storage = reg.Storage({"PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
                           "PIO_STORAGE_SOURCES_DB_PATH": path})
    app_id = storage.get_meta_data_apps().insert(base.App(0, "ru"))
    events = storage.get_events()
    events.init(app_id)
    events.insert_batch([event_mod.Event.from_json_dict(d) for d in dicts], app_id)
    return storage


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ru")
    dicts = _event_dicts()
    js = _fill(jreg, jbase, jevent, str(tmp / "jax.db"), dicts)
    ts = _fill(treg, tbase, tevent, str(tmp / "torch.db"), dicts)
    prev_j, prev_t = jreg.use_storage(js), treg.use_storage(ts)
    yield js, ts
    jreg.use_storage(prev_j)
    treg.use_storage(prev_t)
    js.close()
    ts.close()


@pytest.fixture(scope="module")
def training(stores):
    want = jru.DataSource(jru.DataSourceParams(app_name="ru")).read_training(
        MeshContext.create())
    got = tru.DataSource(tru.DataSourceParams(app_name="ru")).read_training(CPU)
    return got, want


def test_read_training_is_the_references(training):
    got, want = training
    got.sanity_check()
    assert list(got.users.items()) == list(want.users.items())
    for name in ("follow_u", "follow_t"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert "solo" in got.users and len(got.follow_u) == N_USERS * PER_USER
    with pytest.raises(RuntimeError, match="no process group was joined"):
        tru.DataSource(tru.DataSourceParams(app_name="ru")).read_training(
            DeviceContext(torch.device("cpu"), process_index=0, process_count=2))


def _models():
    rng = np.random.default_rng(9)
    vecs = tsim.l2_normalize(rng.standard_normal((N_USERS, 8)).astype(np.float32))
    ids = [f"u{u}" for u in range(N_USERS)]
    jm = jru.SimilarUserModel(vecs, JBiMap({k: i for i, k in enumerate(ids)}))
    tm = convert.similar_user_model_from_arrays(vecs, ids)
    return jm.prepare_for_serving(), tm.prepare_for_serving(CPU)


QUERIES = [
    jru.Query(users=("u1",), num=10),
    jru.Query(users=("u2", "u40", "u77"), num=7),
    jru.Query(users=("u5",), num=200),  # the score > 0 cut trims the tail
    jru.Query(users=("u9",), num=5, white_list=tuple(f"u{j}" for j in range(0, 60, 3))),
    jru.Query(users=("u10", "u11", "u12"), num=12, black_list=("u13", "u14", "u15")),
    jru.Query(users=("nobody",), num=4),
    jru.Query(users=("u3",), num=0),
]


def _port(q):
    return tru.Query(**dataclasses.asdict(q))


def test_serving_against_jax_and_batch_is_serial():
    jm, tm = _models()
    ja, ta = jru.ALSAlgorithm(jru.ALSAlgorithmParams()), tru.ALSAlgorithm(tru.ALSAlgorithmParams())
    for q in QUERIES:
        want, got = ja.predict(jm, q), ta.predict(tm, _port(q))
        tol = max(1, len(q.users)) * 2.0 ** -7 * 4  # q summed rows, |s| < 4
        g = [s.user for s in got.similar_user_scores]
        w = [s.user for s in want.similar_user_scores]
        assert abs(len(g) - len(w)) <= 1  # a score at 0 may fall on either side
        for s in got.similar_user_scores:
            assert s.score > 0 and s.user not in q.users
            if q.white_list is not None:
                assert s.user in q.white_list
            assert s.user not in (q.black_list or ())
        if w:
            known = [tm.user_map[u] for u in q.users if u in tm.user_map]
            full = tsim.sim_scores(tm.user_vecs[known], tm._device_vt,
                                   ta._filter_mask(tm, _port(q)))
            last = want.similar_user_scores[-1].score
            for uid in set(g) ^ set(w):
                assert abs(float(full[tm.user_map[uid]]) - last) <= tol or \
                    abs(float(full[tm.user_map[uid]])) <= tol, (g, w)
    batch = dict(ta.batch_predict(tm, [(i, _port(q)) for i, q in enumerate(QUERIES)]))
    for i, q in enumerate(QUERIES):
        assert batch[i] == ta.predict(tm, _port(q))
    assert ta.predict(tm, _port(QUERIES[5])) == tru.PredictedResult()
    assert len(ta.predict(tm, _port(QUERIES[2])).similar_user_scores) < N_USERS - 1


def _recovery(predict):
    tops, hit = {}, 0
    for u in range(N_USERS):
        tops[u] = [s.user for s in predict(f"u{u}").similar_user_scores]
        hit += sum(s[1:].isdigit() and int(s[1:]) // GROUP == u // GROUP
                   for s in tops[u])
    return hit / (10 * N_USERS), tops


def test_fit_recovers_planted_neighbours_like_jax(training):
    got_td, want_td = training
    params = dict(rank=16, num_iterations=30, seed=5)
    jm = jru.ALSAlgorithm(jru.ALSAlgorithmParams(**params)).train(
        MeshContext.create(), want_td)
    ta = tru.ALSAlgorithm(tru.ALSAlgorithmParams(**params))
    tm = ta.train(CPU, got_td).prepare_for_serving(CPU)
    ja = jru.ALSAlgorithm(jru.ALSAlgorithmParams(**params))
    jrate, jtops = _recovery(lambda u: ja.predict(jm, jru.Query(users=(u,), num=10)))
    trate, ttops = _recovery(lambda u: ta.predict(tm, tru.Query(users=(u,), num=10)))
    overlap = np.mean([len(set(jtops[u]) & set(ttops[u])) / 10 for u in jtops])
    assert abs(trate - jrate) <= 0.05, (trate, jrate)
    assert trate > 0.85 and overlap > 0.8, (trate, overlap)


def test_pickled_model_serves_the_same_and_holds_no_tensor():
    _, tm = _models()
    ta = tru.ALSAlgorithm(tru.ALSAlgorithmParams())
    blob = serialize_model([tm])
    assert not pickle_names_torch(blob) and not pickle_names_torch(pickle.dumps(tm))
    (back,) = deserialize_model(blob)
    assert back._device_vt is None
    back.prepare_for_serving(CPU)
    for q in QUERIES:
        assert ta.predict(back, _port(q)) == ta.predict(tm, _port(q))


def test_convert_round_trips():
    jm, tm = _models()
    assert tm.user_vecs.tobytes() == jm.user_vecs.tobytes()
    assert list(tm.user_map.items()) == list(jm.user_map.items())
    with pytest.raises(ValueError):
        convert.similar_user_model_from_arrays(tm.user_vecs[:3], ["a"])


def test_train_persist_deploy_query(stores, tmp_path):
    _, storage = stores
    path = str(tmp_path / "engine.json")
    with open(path, "w") as f:
        json.dump({"id": "ru", "version": "1", "engineFactory": FACTORY,
                   "datasource": {"params": {"appName": "ru"}},
                   "algorithms": [{"name": "als", "params": {
                       "rank": 8, "numIterations": 5, "seed": 1}}]}, f)
    iid = create_workflow(WorkflowConfig(engine_variant=path, device="cpu"), storage)
    assert not pickle_names_torch(storage.get_model_data_models().get(iid).models)
    deployed = load_deployed_engine(ServerConfig(engine_variant=path), storage,
                                    ctx=CPU)
    assert deployed.models[0].serving_info()["device"] == "cpu"
    q = {"users": ["u1", "u2"], "num": 5, "blackList": ["u3"]}
    res = deployed.predict(q)
    assert 0 < len(res.similar_user_scores) <= 5
    assert not {"u1", "u2", "u3"} & {s.user for s in res.similar_user_scores}
    assert deployed.predict_batch([q, {"users": ["u60"], "num": 3}])[0] == res
