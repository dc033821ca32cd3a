"""PyTorch port, deploy → /queries.json: a recommendation model's arrays
cross from the JAX package through ``convert.py``, persist as a COMPLETED
instance in the port's memory storage, deploy through the port's
QueryServer on ``DeviceContext.create(device="cpu")``, and answer
``POST /queries.json`` exactly as the JAX package's ``ALSAlgorithm``
answers on the same arrays: the same item ids, scores within 1e-4.
"""

import asyncio
import datetime as dt
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

from incubator_predictionio_tpu.data.bimap import BiMap as JBiMap  # noqa: E402
from incubator_predictionio_tpu.models import two_tower as jtt  # noqa: E402
from incubator_predictionio_tpu.templates import recommendation as jrec  # noqa: E402
from incubator_predictionio_tpu_torch import convert  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import (  # noqa: E402
    EngineInstance,
    Model,
    Storage,
)
from incubator_predictionio_tpu_torch.models import two_tower as ttt  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext  # noqa: E402
from incubator_predictionio_tpu_torch.server.query_server import (  # noqa: E402
    QueryServer,
    ServerConfig,
)
from incubator_predictionio_tpu_torch.templates import recommendation as trec  # noqa: E402
from incubator_predictionio_tpu_torch.utils.serialization import (  # noqa: E402
    serialize_model,
)

from tests.test_torch_distributed_train import ShardStub, mirror  # noqa: E402

UTC = dt.timezone.utc
N_USERS, N_ITEMS, RANK = 30, 400, 16
FACTORY = "incubator_predictionio_tpu_torch.templates.recommendation.RecommendationEngine"


def _jax_model(seed=3):
    rng = np.random.default_rng(seed)
    mf = jtt.TwoTowerModel(
        user_emb=rng.normal(size=(N_USERS, RANK)).astype(np.float32),
        item_emb=rng.normal(size=(N_ITEMS, RANK)).astype(np.float32),
        user_bias=rng.normal(size=N_USERS).astype(np.float32),
        item_bias=rng.normal(size=N_ITEMS).astype(np.float32),
        mean=3.5, config=jtt.TwoTowerConfig(rank=RANK))
    return jrec.RecModel(mf, JBiMap({f"u{i}": i for i in range(N_USERS)}),
                         JBiMap({f"i{i}": i for i in range(N_ITEMS)}))


def _port_model(jm):
    """What crosses: the towers as numpy and the id lists in index order."""
    mf = jm.mf
    uinv, iinv = jm.user_map.inverse(), jm.item_map.inverse()
    return convert.rec_model_from_arrays(
        mf.user_emb, mf.item_emb, mf.user_bias, mf.item_bias, mf.mean,
        mf.config.rank, [uinv[i] for i in range(len(uinv))],
        [iinv[i] for i in range(len(iinv))])


def _deploy_env(tmp_path, port_model):
    variant_path = str(tmp_path / "engine.json")
    with open(variant_path, "w") as f:
        json.dump({"id": "default", "version": "1", "engineFactory": FACTORY,
                   "algorithms": [{"name": "als", "params": {"rank": RANK}}]},
                  f)
    storage = Storage({"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})
    now = dt.datetime.now(UTC)
    iid = storage.get_meta_data_engine_instances().insert(EngineInstance(
        id="", status="COMPLETED", start_time=now, end_time=now,
        engine_id="default", engine_version="1",
        engine_variant=os.path.abspath(variant_path), engine_factory=FACTORY))
    storage.get_model_data_models().insert(
        Model(iid, serialize_model([port_model])))
    return storage, variant_path


def _queries():
    rng = np.random.default_rng(9)
    out = [{"user": f"u{u}", "num": int(n)}
           for u, n in zip(rng.integers(0, N_USERS, 12), rng.integers(1, 20, 12))]
    out += [{"user": f"u{u}", "num": 8,
             "blackList": [f"i{i}" for i in rng.integers(0, N_ITEMS, 6)]
             + ["not-an-item"]}
            for u in rng.integers(0, N_USERS, 6)]
    out += [{"user": "stranger", "num": 5},
            {"user": "stranger", "num": 5, "blackList": ["i1"]}]
    return out


def _jax_answer(algo, jm, payload):
    q = jrec.Query(user=payload["user"], num=payload["num"],
                   black_list=tuple(payload.get("blackList", ())) or None)
    return algo.predict(jm, q)


def _assert_json_matches(body, want):
    got = body["itemScores"]
    assert [s["item"] for s in got] == [s.item for s in want.item_scores]
    np.testing.assert_allclose([s["score"] for s in got],
                               [s.score for s in want.item_scores],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("path", ["host", "device"])
def test_queries_json_matches_jax_predict(path, tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_RETRIEVAL_MODE", "exact")
    if path == "device":
        # pin both packages' device (bf16) scorer for this toy catalog
        monkeypatch.setattr(jtt, "HOST_SERVE_MAX_ELEMENTS", 0)
        monkeypatch.setattr(ttt, "HOST_SERVE_MAX_ELEMENTS", 0)
    jm = _jax_model()
    jalgo = jrec.ALSAlgorithm(jrec.ALSAlgorithmParams(rank=RANK))
    storage, variant_path = _deploy_env(tmp_path, _port_model(jm))
    queries = _queries()

    async def run():
        server = QueryServer(ServerConfig(engine_variant=variant_path),
                             storage=storage,
                             ctx=DeviceContext.create(device="cpu"))
        expect = {"host": "host-numpy", "device": "device-bf16"}[path]
        assert server.deployed.models[0].serving_info()["path"] == expect
        client = TestClient(TestServer(server.make_app()))
        await client.start_server()
        try:
            for p in queries:  # one at a time
                resp = await client.post("/queries.json", json=p)
                assert resp.status == 200
                _assert_json_matches(await resp.json(),
                                     _jax_answer(jalgo, jm, p))
            # a concurrent burst coalesces into batch_predict dispatches
            resps = await asyncio.gather(*[
                client.post("/queries.json", json=p) for p in queries * 3])
            for p, resp in zip(queries * 3, resps):
                assert resp.status == 200
                _assert_json_matches(await resp.json(),
                                     _jax_answer(jalgo, jm, p))
            assert server.batcher.max_batch_seen > 1
            bad = await client.post("/queries.json", data=b"{nope")
            assert bad.status == 400
            bad = await client.post("/queries.json",
                                    json={"user": "u1", "colour": "red"})
            assert bad.status == 400
            status = await (await client.get("/")).json()
            assert status["servingPaths"][0]["path"] == expect
            assert status["device"] == "cpu"
            health = await (await client.get("/health")).json()
            assert health["status"] == "ok"
        finally:
            await client.close()
            await server.shutdown()

    asyncio.run(run())


def test_batch_predict_matches_jax(monkeypatch):
    monkeypatch.setenv("PIO_RETRIEVAL_MODE", "exact")
    jm = _jax_model(seed=4)
    tm = _port_model(jm).prepare_for_serving(DeviceContext.create(device="cpu"))
    qs = _queries()
    jq = [(i, jrec.Query(user=p["user"], num=p["num"],
                         black_list=tuple(p.get("blackList", ())) or None))
          for i, p in enumerate(qs)]
    tq = [(i, trec.Query(user=p["user"], num=p["num"],
                         black_list=tuple(p.get("blackList", ())) or None))
          for i, p in enumerate(qs)]
    want = dict(jrec.ALSAlgorithm(jrec.ALSAlgorithmParams()).batch_predict(jm, jq))
    got = dict(trec.ALSAlgorithm(trec.ALSAlgorithmParams()).batch_predict(tm, tq))
    assert sorted(got) == sorted(want)
    for i in want:
        assert [s.item for s in got[i].item_scores] == \
            [s.item for s in want[i].item_scores]
        np.testing.assert_allclose([s.score for s in got[i].item_scores],
                                   [s.score for s in want[i].item_scores],
                                   rtol=1e-4, atol=1e-4)


def test_deploy_without_completed_instance_raises(tmp_path):
    storage = Storage({"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})
    variant_path = str(tmp_path / "engine.json")
    with open(variant_path, "w") as f:
        json.dump({"engineFactory": FACTORY}, f)
    with pytest.raises(RuntimeError, match="No COMPLETED engine instance"):
        QueryServer(ServerConfig(engine_variant=variant_path), storage=storage,
                    ctx=DeviceContext.create(device="cpu"))


def test_training_stages_name_the_slice_that_ports_them(tmp_path):
    """Training is ported, mid-training checkpoints (of one process and of
    several), per-process staging and the per-process sharded read too; a
    context that claims two processes without a group refuses."""
    cpu = DeviceContext.create(device="cpu")
    td = trec.TrainingData(np.zeros(4, np.int32), np.arange(4, dtype=np.int32),
                           np.ones(4, np.float32), np.array(["u0"], object),
                           np.array([f"i{j}" for j in range(4)], object),
                           rows_are_local=True)
    model = trec.ALSAlgorithm(trec.ALSAlgorithmParams(
        rank=4, num_iterations=2, checkpoint_every=1)).train(mirror(), td)
    assert model.mf.user_emb.shape == (1, 4) and np.isfinite(model.mf.final_loss)
    model = trec.ALSAlgorithm(trec.ALSAlgorithmParams(
        rank=4, num_iterations=2, checkpoint_every=1,
        checkpoint_dir=str(tmp_path))).train(mirror(), td)
    assert np.isfinite(model.mf.final_loss)
    assert sorted(os.listdir(tmp_path)) == ["step-1.pt", "step-2.pt"]
    with pytest.raises(RuntimeError, match="no process group was joined"):
        trec.ALSAlgorithm(trec.ALSAlgorithmParams(rank=4)).train(
            DeviceContext(cpu.device, process_index=0, process_count=2), td)
    # process 1 of 2 reads its shard: users offset past shard 0's, items
    # remapped into the first-seen union
    shard0 = (np.array(["a", "b"], object), np.array(["x", "y"], object))
    shard1 = (np.array(["c"], object), np.array(["y", "z"], object),
              np.array([0, 0], np.int32), np.array([0, 1], np.int32),
              np.array([2.0, 3.0], np.float32))
    ds = trec.DataSource(trec.DataSourceParams())
    ds._store = type("Shard1", (), {"assemble_triples": lambda self, *a, **k: (
        shard1 if k["n_shards"] == 2 and k["shard_index"] == 1 else None)})()
    script = [[list(shard0[0]), ["c"]], [list(shard0[1]), ["y", "z"]], [3, 2]]
    got = ds.read_training(ShardStub(1, script))
    assert list(got.user_vocab) == ["a", "b", "c"] and list(got.item_vocab) == ["x", "y", "z"]
    assert got.user_idx.tolist() == [2, 2] and got.item_idx.tolist() == [1, 2]
    assert got.rows_are_local and got.n_rows_global == 5
