"""PyTorch port, the similarproduct template against the JAX package's, on
the CPU: ``read_training`` over the same stored events, the cosine
scoring path (``templates/_similarity.py``), the co-occurrence top lists,
the ALS and Like fits on planted data, pickling, and train → persist →
deploy through ``create_workflow`` and ``load_deployed_engine``.

Tolerances, each measured on this file's data:

- ``read_training`` arrays are bitwise the reference's (the same numpy
  code); the co-occurrence top lists and their served answers too where
  counts are ≤ 256; above, the counts are bitwise the bf16 product's (an
  int64 ``Uᵀ U`` rounded to bf16), which XLA's CPU backend does not round
  in the jitted reference;
- each ``qv_scores`` entry within 1 bf16 ulp of the JAX function's (both
  round an fp32 sum of exact bf16 products to bf16; the two BLAS sum in
  different orders), so a summed score over q rows within q ulps; served
  ids equal up to near-ties at the last place;
- the port's batch path equals its serial path row for row, bitwise;
- fits (the two packages draw different inits): top-10 overlap of the
  similar items > 0.8, and each package's rate of recovering the planted
  neighbours within 0.05 of the other's.
"""

import dataclasses
import datetime as dt
import json
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from incubator_predictionio_tpu.data import event as jevent  # noqa: E402
from incubator_predictionio_tpu.data.bimap import BiMap as JBiMap  # noqa: E402
from incubator_predictionio_tpu.data.storage import base as jbase  # noqa: E402
from incubator_predictionio_tpu.data.storage import registry as jreg  # noqa: E402
from incubator_predictionio_tpu.parallel.mesh import MeshContext  # noqa: E402
from incubator_predictionio_tpu.templates import _similarity as jsim  # noqa: E402
from incubator_predictionio_tpu.templates import similarproduct as jsp  # noqa: E402
from incubator_predictionio_tpu_torch import convert  # noqa: E402
from incubator_predictionio_tpu_torch.core.workflow.create_workflow import (  # noqa: E402
    WorkflowConfig,
    create_workflow,
)
from incubator_predictionio_tpu_torch.data import event as tevent  # noqa: E402
from incubator_predictionio_tpu_torch.data.bimap import BiMap as TBiMap  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import base as tbase  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext  # noqa: E402
from incubator_predictionio_tpu_torch.server.query_server import (  # noqa: E402
    ServerConfig,
    load_deployed_engine,
)
from incubator_predictionio_tpu_torch.templates import _similarity as tsim  # noqa: E402
from incubator_predictionio_tpu_torch.templates import similarproduct as tsp  # noqa: E402
from incubator_predictionio_tpu_torch.utils.serialization import (  # noqa: E402
    deserialize_model,
    serialize_model,
)

CPU = DeviceContext.create(device="cpu")
FACTORY = "incubator_predictionio_tpu_torch.templates.similarproduct.SimilarProductEngine"
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
N_CLUSTERS, CLUSTER, N_USERS, PER_USER = 12, 11, 240, 8
N_ITEMS = N_CLUSTERS * CLUSTER
CATS = ("c0", "c1", "c2", "c3")


def _planted(seed=0):
    """Users each view PER_USER items of their cluster: an item's 10 planted
    neighbours are its cluster-mates."""
    rng = np.random.default_rng(seed)
    vu, vi = [], []
    for u in range(N_USERS):
        c = u % N_CLUSTERS
        for j in rng.choice(CLUSTER, PER_USER, replace=False):
            vu.append(u)
            vi.append(c * CLUSTER + int(j))
    return np.asarray(vu, np.int32), np.asarray(vi, np.int32)


def _event_dicts():
    """Items' categories, some users' ``$set``, the planted views, likes in
    each user's cluster and dislikes in the next cluster, and events the
    read drops or skips."""
    rng = np.random.default_rng(5)
    out = []
    for i in range(N_ITEMS):
        out.append({"event": "$set", "entityType": "item", "entityId": f"i{i}",
                    "properties": {"categories": [CATS[i % 4], CATS[(i // 4) % 4]]},
                    "eventTime": T0.isoformat()})
    for u in range(0, N_USERS, 7):  # some users are $set too
        out.append({"event": "$set", "entityType": "user", "entityId": f"u{u}",
                    "properties": {"age": u}, "eventTime": T0.isoformat()})
    vu, vi = _planted()
    for j, (u, i) in enumerate(zip(vu, vi)):
        out.append({"event": "view", "entityType": "user", "entityId": f"u{u}",
                    "targetEntityType": "item", "targetEntityId": f"i{i}",
                    "eventTime": (T0 + dt.timedelta(seconds=j)).isoformat()})
    j = 0
    for u in range(N_USERS):  # likes in the user's cluster, dislikes in the next
        c = u % N_CLUSTERS
        liked = [c * CLUSTER + int(i) for i in rng.choice(CLUSTER, 9, replace=False)]
        others = [(c + 1) % N_CLUSTERS * CLUSTER + int(i)
                  for i in rng.choice(CLUSTER, 6, replace=False)]
        for i, ev in [(i, "like") for i in liked] + [(i, "dislike") for i in others]:
            out.append({"event": ev, "entityType": "user", "entityId": f"u{u}",
                        "targetEntityType": "item", "targetEntityId": f"i{i}",
                        "eventTime": (T0 + dt.timedelta(seconds=5000 + j)).isoformat()})
            j += 1
    # an unknown item, a user without a target, another event name
    out.append({"event": "view", "entityType": "user", "entityId": "u1",
                "targetEntityType": "item", "targetEntityId": "ghost",
                "eventTime": (T0 + dt.timedelta(seconds=9000)).isoformat()})
    out.append({"event": "view", "entityType": "user", "entityId": "lonely",
                "eventTime": (T0 + dt.timedelta(seconds=9001)).isoformat()})
    out.append({"event": "buy", "entityType": "user", "entityId": "u2",
                "targetEntityType": "item", "targetEntityId": "i3",
                "eventTime": (T0 + dt.timedelta(seconds=9002)).isoformat()})
    return out


def _fill(reg, base, event_mod, path, dicts):
    storage = reg.Storage({"PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
                           "PIO_STORAGE_SOURCES_DB_PATH": path})
    app_id = storage.get_meta_data_apps().insert(base.App(0, "sp"))
    events = storage.get_events()
    events.init(app_id)
    events.insert_batch([event_mod.Event.from_json_dict(d) for d in dicts], app_id)
    return storage


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
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
    want = jsp.DataSource(jsp.DataSourceParams(app_name="sp")).read_training(
        MeshContext.create())
    got = tsp.DataSource(tsp.DataSourceParams(app_name="sp")).read_training(CPU)
    return got, want


def test_read_training_is_the_references(training):
    got, want = training
    got.sanity_check()
    assert dict(got.users.items()) == dict(want.users.items())
    assert list(got.items.items()) == list(want.items.items())
    assert got.categories == want.categories
    for name in ("view_u", "view_i", "like_u", "like_i", "like_sign"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(got.view_u) == N_USERS * PER_USER  # the ghost item is dropped
    with pytest.raises(RuntimeError, match="no process group was joined"):
        tsp.DataSource(tsp.DataSourceParams(app_name="sp")).read_training(
            DeviceContext(torch.device("cpu"), process_index=0, process_count=2))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (2^(e-7) for x in [2^e, 2^(e+1)))."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def test_qv_scores_within_one_bf16_ulp_of_jax():
    rng = np.random.default_rng(1)
    table = tsim.l2_normalize(rng.standard_normal((300, 24)).astype(np.float32))
    q = table[rng.integers(0, 300, 20)]
    want = np.asarray(jsim.qv_scores(jnp.asarray(q), jnp.asarray(table.T)))
    got = tsim.qv_scores(torch.from_numpy(q), tsim.device_catalog(table, "cpu")).numpy()
    assert got.dtype == np.float32
    # bf16-valued
    assert np.array_equal(got, torch.from_numpy(got).bfloat16().float().numpy())
    diff = np.abs(got - want)
    assert (diff <= _bf16_ulp(want)).all(), float((diff / _bf16_ulp(want)).max())


def test_sim_scores_stacked_is_serial_bitwise_and_near_jax():
    rng = np.random.default_rng(2)
    table = tsim.l2_normalize(rng.standard_normal((500, 16)).astype(np.float32))
    vt = tsim.device_catalog(table, "cpu")
    counts = [1, 3, 5, 2, 4, 1, 1, 5]
    qs = [table[rng.integers(0, 500, c)] for c in counts]
    masks = np.zeros((len(counts), 500), np.float32)
    masks[:, rng.integers(0, 500, 40)] = -np.inf
    stacked = tsim.sim_scores_stacked(np.concatenate(qs), counts, vt, masks)
    for r, q in enumerate(qs):
        serial = tsim.sim_scores(q, vt, masks[r])
        assert serial.tobytes() == stacked[r].tobytes()
        want = jsim.sim_scores(q, jnp.asarray(table.T), masks[r])
        fin = np.isfinite(want)
        assert (np.isfinite(serial) == fin).all()
        tol = len(q) * _bf16_ulp(np.abs(want[fin]) + 1.0)
        assert (np.abs(serial[fin] - want[fin]) <= tol).all()


def _models(seed=4):
    rng = np.random.default_rng(seed)
    vecs = tsim.l2_normalize(rng.standard_normal((N_ITEMS, 12)).astype(np.float32))
    ids = [f"i{i}" for i in range(N_ITEMS)]
    cats = {f"i{i}": (CATS[i % 4], CATS[(i // 4) % 4]) for i in range(N_ITEMS)}
    jm = jsp.ItemSimModel(vecs, JBiMap({k: i for i, k in enumerate(ids)}), cats)
    tm = convert.item_sim_model_from_arrays(vecs, ids, cats)
    return jm.prepare_for_serving(), tm.prepare_for_serving(CPU)


QUERIES = [
    jsp.Query(items=("i1",), num=10),
    jsp.Query(items=("i2", "i40", "i77"), num=7, categories=("c1",)),
    jsp.Query(items=("i5", "i6"), num=10, category_black_list=("c0", "c3")),
    jsp.Query(items=("i9",), num=5, white_list=tuple(f"i{j}" for j in range(0, 60, 3))),
    jsp.Query(items=("i10", "i11", "i12", "i13", "i14"), num=12,
              black_list=("i15", "i16", "i17")),
    jsp.Query(items=("ghost",), num=4),
    jsp.Query(items=("i3",), num=0),
]


def _as_port(q):
    return tsp.Query(**dataclasses.asdict(q))


def _check_near(got, want, scores_of, tol):
    """ids equal up to near-ties at the last place: every id in one answer
    only scores within ``tol`` of the last kept score."""
    g = [s.item for s in got.item_scores]
    w = [s.item for s in want.item_scores]
    assert len(g) == len(w)
    if not w:
        return
    last = want.item_scores[-1].score
    for iid in set(g) ^ set(w):
        assert abs(scores_of[iid] - last) <= tol, (g, w)
    for a, b in zip(got.item_scores, want.item_scores):
        if a.item == b.item:
            assert abs(a.score - b.score) <= tol


def test_similar_items_against_jax_and_batch_is_serial(training):
    jm, tm = _models()
    tol = 5 * 2.0 ** -7 * 8  # ≤ 5 summed rows, each within 1 ulp at |s| < 8
    for q in QUERIES:
        want = jsp._similar_items(jm, q)
        got = tsp._similar_items(tm, _as_port(q))
        scores = {}
        known = [tm.item_map[i] for i in q.items if i in tm.item_map]
        if known:
            s = tsim.sim_scores(tm.item_vecs[known], tm._device_vt,
                                tsp._category_mask(tm, _as_port(q)))
            scores = {iid: float(s[j]) for iid, j in tm.item_map.items()}
        _check_near(got, want, scores, tol)
        for s in got.item_scores:
            assert s.item not in q.items and np.isfinite(s.score)
    batch = tsp._similar_items_batch(tm, [(i, _as_port(q)) for i, q in enumerate(QUERIES)])
    for i, q in enumerate(QUERIES):
        assert dict(batch)[i] == tsp._similar_items(tm, _as_port(q))


def test_filters_hold(training):
    _, tm = _models()
    cat_rows = tm.category_index()
    res = tsp._similar_items(tm, tsp.Query(items=("i2",), num=50, categories=("c1",)))
    assert res.item_scores and all("c1" in tm.categories[s.item] for s in res.item_scores)
    res = tsp._similar_items(tm, tsp.Query(items=("i2",), num=200,
                                           category_black_list=("c0",)))
    assert all("c0" not in tm.categories[s.item] for s in res.item_scores)
    assert len(res.item_scores) == N_ITEMS - len(cat_rows.rows_with_any(("c0",))) - (
        0 if "c0" in tm.categories["i2"] else 1)
    white = ("i3", "i4", "i2", "nope")
    res = tsp._similar_items(tm, tsp.Query(items=("i2",), num=10, white_list=white))
    assert {s.item for s in res.item_scores} == {"i3", "i4"}


def _cooccur_data(n_users):
    """Users viewing random items; every other user also views i0..i2, so
    those co-counts reach about n_users / 2."""
    rng = np.random.default_rng(6)
    vu, vi = [], []
    for u in range(n_users):
        items = set(rng.choice(40, rng.integers(1, 10), replace=False).tolist())
        if u % 2 == 0:
            items |= {0, 1, 2}
        for i in sorted(items):
            vu.append(u)
            vi.append(i)
    vu, vi = np.asarray(vu, np.int32), np.asarray(vi, np.int32)
    users = {f"u{u}": u for u in range(n_users)}
    items = {f"i{i}": i for i in range(40)}
    cats = {f"i{i}": (CATS[i % 4],) for i in range(40)}
    empty_i, empty_f = np.zeros(0, np.int32), np.zeros(0, np.float32)
    jtd = jsp.TrainingData(JBiMap(users), JBiMap(items), cats, vu, vi,
                           empty_i, empty_i, empty_f)
    ttd = tsp.TrainingData(TBiMap(users), TBiMap(items), cats, vu, vi,
                           empty_i, empty_i, empty_f)
    return jtd, ttd


def test_cooccurrence_top_lists_bitwise():
    """Counts up to 256 (exact in bf16): the top lists and served answers
    equal the JAX package's."""
    jtd, ttd = _cooccur_data(500)
    for n in (20, 5):
        jm = jsp.CooccurrenceAlgorithm(jsp.CooccurrenceAlgorithmParams(n=n)).train(
            MeshContext.create(), jtd)
        tm = tsp.CooccurrenceAlgorithm(tsp.CooccurrenceAlgorithmParams(n=n)).train(
            CPU, ttd)
        assert tm.top_cooccurrences == jm.top_cooccurrences
        assert max(c for lst in tm.top_cooccurrences.values() for _, c in lst) > 200
        ja = jsp.CooccurrenceAlgorithm(jsp.CooccurrenceAlgorithmParams(n=n))
        ta = tsp.CooccurrenceAlgorithm(tsp.CooccurrenceAlgorithmParams(n=n))
        for q in (jsp.Query(items=("i0", "i5"), num=10),
                  jsp.Query(items=("i1",), num=4, categories=("c1", "c2")),
                  jsp.Query(items=("i7",), num=10, black_list=("i0",))):
            assert ta.predict(tm, _as_port(q)) == tsp.PredictedResult(tuple(
                tsp.ItemScore(s.item, s.score)
                for s in ja.predict(jm, q).item_scores))


def test_cooccurrence_counts_above_256_round_to_bf16():
    """Counts above 256: the reference's product is bf16 (``u.T.bf16 @
    u.bf16`` has dtype bf16), so a count rounds to the nearest even bf16
    value — the port's counts are bitwise that, against numpy's int64
    ``Uᵀ U`` and against the JAX package's product run eagerly. (Its jitted
    ``_cooccur`` on XLA's CPU backend folds the bf16 round trip away and
    keeps 303 where the bf16 product is 304; the port keeps the bf16
    answer.)"""
    _, ttd = _cooccur_data(600)
    u = np.zeros((600, 40), np.int64)
    u[ttd.view_u, ttd.view_i] = 1
    exact = (u.T @ u).astype(np.float32)
    assert exact.max() > 256 and (exact % 2 == 1).any()
    want = torch.from_numpy(exact).bfloat16().float().numpy()
    got = tsp._cooccur(ttd.view_u, ttd.view_i, 600, 40, "cpu")
    assert got.tobytes() == want.tobytes()
    uj = jnp.asarray(u.astype(np.float32))
    eager = np.asarray((uj.T.astype(jnp.bfloat16) @ uj.astype(jnp.bfloat16))
                       .astype(jnp.float32))
    assert got.tobytes() == eager.tobytes()
    tm = tsp.CooccurrenceAlgorithm(tsp.CooccurrenceAlgorithmParams(n=5)).train(
        CPU, ttd)
    np.fill_diagonal(want, 0)
    for i, lst in tm.top_cooccurrences.items():
        assert [c for _, c in lst] == sorted(
            (int(c) for c in want[i] if c), reverse=True)[:5]


def _recovery(predict, n=N_ITEMS):
    """Share of each item's top-10 that are its planted cluster-mates, and
    the top-10 lists."""
    tops, hit = {}, 0
    for i in range(n):
        res = predict(f"i{i}")
        tops[i] = [s.item for s in res.item_scores]
        hit += sum(int(s[1:]) // CLUSTER == i // CLUSTER for s in tops[i])
    return hit / (10 * n), tops


@pytest.mark.parametrize("algo", ["als", "likealgo"])
def test_fit_recovers_planted_neighbours_like_jax(training, algo):
    got_td, want_td = training
    params = dict(rank=16, num_iterations=20 if algo == "als" else 200, seed=3)
    jcls = {"als": jsp.ALSAlgorithm, "likealgo": jsp.LikeAlgorithm}[algo]
    tcls = {"als": tsp.ALSAlgorithm, "likealgo": tsp.LikeAlgorithm}[algo]
    jm = jcls(jsp.ALSAlgorithmParams(**params)).train(MeshContext.create(), want_td)
    tm = tcls(tsp.ALSAlgorithmParams(**params)).train(CPU, got_td)
    tm.prepare_for_serving(CPU)
    jrate, jtops = _recovery(lambda i: jsp._similar_items(jm, jsp.Query(items=(i,), num=10)))
    trate, ttops = _recovery(lambda i: tsp._similar_items(tm, tsp.Query(items=(i,), num=10)))
    overlap = np.mean([len(set(jtops[i]) & set(ttops[i])) / 10 for i in jtops])
    assert abs(trate - jrate) <= 0.05, (trate, jrate)
    assert trate > 0.85 and overlap > 0.8, (trate, overlap)


def pickle_names_torch(blob: bytes) -> bool:
    """Whether a pickle refers to the torch module (a tensor in it would:
    ``torch._utils._rebuild_tensor_v2``)."""
    import pickletools

    return any(isinstance(arg, str) and (arg == "torch" or arg.startswith("torch."))
               for _, arg, _ in pickletools.genops(blob))


def test_pickled_model_serves_the_same_and_holds_no_tensor(training):
    _, tm = _models()
    blob = serialize_model([tm])
    assert not pickle_names_torch(blob) and not pickle_names_torch(pickle.dumps(tm))
    (back,) = deserialize_model(blob)
    assert back._device_vt is None and not any(
        isinstance(v, torch.Tensor) for v in vars(back).values())
    back.prepare_for_serving(CPU)
    for q in QUERIES:
        assert tsp._similar_items(back, _as_port(q)) == tsp._similar_items(tm, _as_port(q))
    assert pickle.loads(pickle.dumps(tm))._device_vt is None


def test_convert_round_trips(training):
    jm, tm = _models()
    assert tm.item_vecs.tobytes() == jm.item_vecs.tobytes()
    assert list(tm.item_map.items()) == list(jm.item_map.items())
    assert tm.categories == jm.categories
    with pytest.raises(ValueError):
        convert.item_sim_model_from_arrays(tm.item_vecs[:3], ["a"], {})


def test_train_persist_deploy_query(stores, tmp_path):
    """The engine through ``create_workflow`` (ALS and co-occurrence
    together, summed by its Serving) and a deploy of the persisted models
    from MODELDATA."""
    _, storage = stores
    path = str(tmp_path / "engine.json")
    with open(path, "w") as f:
        json.dump({"id": "sp", "version": "1", "engineFactory": FACTORY,
                   "datasource": {"params": {"appName": "sp"}},
                   "algorithms": [
                       {"name": "als", "params": {"rank": 8, "numIterations": 5,
                                                  "seed": 1}},
                       {"name": "cooccurrence", "params": {"n": 10}}]}, f)
    iid = create_workflow(WorkflowConfig(engine_variant=path, device="cpu"), storage)
    blob = storage.get_model_data_models().get(iid).models
    assert not pickle_names_torch(blob)
    deployed = load_deployed_engine(ServerConfig(engine_variant=path), storage,
                                    ctx=CPU)
    als, cooc = deployed.models
    assert als.serving_info()["device"] == "cpu"
    q = {"items": ["i1", "i2"], "num": 6, "categoryBlackList": ["c3"]}
    res = deployed.predict(q)
    assert 0 < len(res.item_scores) <= 6
    assert not {"i1", "i2"} & {s.item for s in res.item_scores}
    assert all("c3" not in als.categories[s.item] for s in res.item_scores)
    batch = deployed.predict_batch([q, {"items": ["i50"], "num": 3}])
    assert batch[0] == res
