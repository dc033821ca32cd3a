"""PyTorch port, the recommendation template's train → persist → deploy
path on the CPU: the sqlite event store, ``DataSource.read_training``
against the JAX package's on the same events, ``run_train`` /
``create_workflow``, ``RecModel.save`` / ``load`` of a device-resident
model, ``load_deployed_engine`` and the CLI verbs ``app new``, ``import``
and ``train``, in-process.

Tolerances: ``read_training`` is bitwise the reference's (the same numpy
code over the same rows in the same order); the served top-k equals numpy
scoring of the trained tables (the host serving path is the reference's
numpy code); a resident model's tables round-trip bitwise.
"""

import datetime as dt
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from incubator_predictionio_tpu.data import event as jevent  # noqa: E402
from incubator_predictionio_tpu.data.storage import base as jbase  # noqa: E402
from incubator_predictionio_tpu.data.storage import registry as jreg  # noqa: E402
from incubator_predictionio_tpu.parallel.mesh import MeshContext  # noqa: E402
from incubator_predictionio_tpu.templates import recommendation as jrec  # noqa: E402
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
from incubator_predictionio_tpu_torch.templates import recommendation as trec  # noqa: E402
from incubator_predictionio_tpu_torch.tools import cli  # noqa: E402

from tests.test_torch_distributed_train import ShardStub, mirror  # noqa: E402

CPU = DeviceContext.create(device="cpu")
FACTORY = ("incubator_predictionio_tpu_torch.templates.recommendation."
           "RecommendationEngine")
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)


def _event_dicts(n=400, seed=2):
    """rate events with ratings, re-rated pairs (the latest must win), buy
    events without a rating (they count buy_rating), a buy WITH a rating,
    an event of another name and a rate without a target (both skipped)."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n):
        u, i = int(rng.integers(0, 40)), int(rng.integers(0, 25))
        out.append({"event": "rate", "entityType": "user", "entityId": f"u{u}",
                    "targetEntityType": "item", "targetEntityId": f"i{i}",
                    "properties": {"rating": float(rng.integers(1, 6))},
                    "eventTime": (T0 + dt.timedelta(seconds=j)).isoformat()})
    for j in range(20):  # re-rate earlier pairs later on
        d = dict(out[j * 7])
        d["properties"] = {"rating": 5.0 if j % 2 else 1.0}
        d["eventTime"] = (T0 + dt.timedelta(seconds=n + j)).isoformat()
        out.append(d)
    for j in range(15):
        out.append({"event": "buy", "entityType": "user", "entityId": f"u{j}",
                    "targetEntityType": "item", "targetEntityId": f"i{j + 30}",
                    "eventTime": (T0 + dt.timedelta(seconds=n + 50 + j)).isoformat()})
    out.append({"event": "buy", "entityType": "user", "entityId": "u3",
                "targetEntityType": "item", "targetEntityId": "i3",
                "properties": {"rating": 2.0},
                "eventTime": (T0 + dt.timedelta(seconds=n + 90)).isoformat()})
    out.append({"event": "view", "entityType": "user", "entityId": "u1",
                "targetEntityType": "item", "targetEntityId": "i1",
                "eventTime": (T0 + dt.timedelta(seconds=n + 91)).isoformat()})
    out.append({"event": "rate", "entityType": "user", "entityId": "u2",
                "properties": {"rating": 3.0},
                "eventTime": (T0 + dt.timedelta(seconds=n + 92)).isoformat()})
    return out


def _fill(reg, base, event_mod, path, app_name, dicts):
    storage = reg.Storage({"PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
                           "PIO_STORAGE_SOURCES_DB_PATH": path})
    app_id = storage.get_meta_data_apps().insert(base.App(0, app_name))
    events = storage.get_events()
    events.init(app_id)
    events.insert_batch([event_mod.Event.from_json_dict(d) for d in dicts], app_id)
    return storage


@pytest.fixture()
def stores(tmp_path):
    """The same events in each package's sqlite store."""
    dicts = _event_dicts()
    js = _fill(jreg, jbase, jevent, str(tmp_path / "jax.db"), "rec", dicts)
    ts = _fill(treg, tbase, tevent, str(tmp_path / "torch.db"), "rec", dicts)
    prev_j, prev_t = jreg.use_storage(js), treg.use_storage(ts)
    yield js, ts
    jreg.use_storage(prev_j)
    treg.use_storage(prev_t)
    js.close()
    ts.close()


def test_read_training_is_the_references(stores):
    params = dict(app_name="rec")
    want = jrec.DataSource(jrec.DataSourceParams(**params)).read_training(
        MeshContext.create())
    got = trec.DataSource(trec.DataSourceParams(**params)).read_training(CPU)
    got.sanity_check()
    for name in ("user_vocab", "item_vocab", "user_idx", "item_idx", "ratings"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    inv_u = {i: u for i, u in enumerate(got.user_vocab)}
    inv_i = {i: t for i, t in enumerate(got.item_vocab)}
    pairs = {(inv_u[u], inv_i[i]): r for u, i, r in
             zip(got.user_idx, got.item_idx, got.ratings)}
    assert len(pairs) == len(got.ratings)  # one row a pair
    dicts = _event_dicts()
    latest = {}
    for d in dicts:
        if d["event"] not in ("rate", "buy") or "targetEntityId" not in d:
            continue
        r = 4.0 if d["event"] == "buy" else d["properties"]["rating"]
        latest[(d["entityId"], d["targetEntityId"])] = r
    assert pairs == latest  # the latest event of a pair wins; buy counts 4.0
    assert pairs[("u3", "i3")] == 4.0  # a buy's rating property is ignored


def test_empty_training_data_fails_its_sanity_check(tmp_path):
    storage = _fill(treg, tbase, tevent, str(tmp_path / "e.db"), "empty", [])
    prev = treg.use_storage(storage)
    try:
        td = trec.DataSource(trec.DataSourceParams(app_name="empty")).read_training(CPU)
        with pytest.raises(ValueError, match="empty"):
            td.sanity_check()
    finally:
        treg.use_storage(prev)
        storage.close()


def _variant(tmp_path, gather="auto", rank=4, name="engine.json"):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        json.dump({"id": "rec", "version": "1", "engineFactory": FACTORY,
                   "datasource": {"params": {"appName": "rec"}},
                   "algorithms": [{"name": "als", "params": {
                       "rank": rank, "numIterations": 3, "batchSize": 64,
                       "seed": 1, "gather": gather}}]}, f)
    return path


def _numpy_top(mf, uidx, num):
    s = mf.user_emb[uidx] @ mf.item_emb.T + mf.item_bias + mf.user_bias[uidx] + mf.mean
    return np.argsort(-s, kind="stable")[:num]


@pytest.mark.parametrize("gather", ["host", "device"])
def test_train_persist_deploy_query(stores, tmp_path, monkeypatch, gather):
    """``create_workflow`` trains on the CPU and marks the instance
    COMPLETED with its model row; ``load_deployed_engine`` serves the
    persisted model: a host model through default pickling, a resident one
    through ``RecModel.save`` / ``load`` (its manifest in MODELDATA)."""
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "fs"))
    _, storage = stores
    path = _variant(tmp_path, gather)
    iid = create_workflow(WorkflowConfig(engine_variant=path, device="cpu"), storage)
    inst = storage.get_meta_data_engine_instances().get(iid)
    assert inst.status == "COMPLETED" and inst.end_time is not None
    assert inst.engine_variant == os.path.abspath(path)
    assert storage.get_model_data_models().get(iid) is not None
    deployed = load_deployed_engine(ServerConfig(engine_variant=path), storage,
                                    ctx=CPU, warmup=False)
    model = deployed.models[0]
    assert model.mf.device_resident == (gather == "device")
    assert model.serving_info()["path"] == "host-numpy"
    mf = model.mf.ensure_host()
    for u in ("u0", "u5", "u17"):
        res = deployed.predict({"user": u, "num": 5})
        want = [model.item_map.inverse()[int(i)]
                for i in _numpy_top(mf, model.user_map[u], 5)]
        assert [s.item for s in res.item_scores] == want
        banned = deployed.predict({"user": u, "num": 5, "blackList": want[:2]})
        assert not {s.item for s in banned.item_scores} & set(want[:2])
    assert deployed.predict({"user": "nobody"}).item_scores == ()


def test_resident_model_round_trips_bitwise(stores, tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "fs"))
    td = trec.DataSource(trec.DataSourceParams(app_name="rec")).read_training(CPU)
    params = trec.ALSAlgorithmParams(rank=4, num_iterations=2, batch_size=64,
                                     gather="device")
    model = trec.ALSAlgorithm(params).train(CPU, td)
    assert model.mf.device_resident
    assert model.save("inst_0", params, CPU)
    assert os.path.exists(tmp_path / "fs" / "device_models" / "inst_0" / "tables.pt")
    back = trec.RecModel.load("inst_0", params, CPU)
    assert back.mf.device_resident and back.mf._device == CPU.device
    for k in ("ue", "ie"):
        assert torch.equal(back.mf._tables[k], model.mf._tables[k])
    assert back.user_map == model.user_map and back.item_map == model.item_map
    assert (back.mf.mean, back.mf.config) == (model.mf.mean, model.mf.config)
    # a host model leaves persistence to default pickling
    host = trec.ALSAlgorithm(trec.ALSAlgorithmParams(
        rank=4, num_iterations=1, batch_size=64, gather="host")).train(CPU, td)
    assert host.save("inst_1", params, CPU) is False


def test_train_refuses_what_is_not_ported(stores):
    td = trec.DataSource(trec.DataSourceParams(app_name="rec")).read_training(CPU)
    # per-process staging of a sharded read trains (over a gloo group:
    # tests/test_torch_distributed_train.py); with mirrored peers it is the
    # single-process fit's data twice over, and a context that claims two
    # processes without a group refuses at its first collective
    td.rows_are_local = True
    algo = trec.ALSAlgorithm(trec.ALSAlgorithmParams(
        rank=4, num_iterations=2, checkpoint_every=1))
    two = mirror()
    model = algo.train(two, td)
    assert model.mf.user_emb.shape == (len(td.user_vocab), 4)
    assert np.isfinite(model.mf.final_loss) and "exchange_sec" in model.mf.timings
    with pytest.raises(RuntimeError, match="no process group was joined"):
        algo.train(DeviceContext(torch.device("cpu"), process_index=0,
                                 process_count=2), td)
    # the sharded read of each process, from a stub that gives each
    # allgather every shard's part: disjoint users, the global row count
    _, ts = stores
    reads = [ts.get_events().assemble_triples(
        1, entity_type="user", event_names=("rate", "buy"),
        target_entity_type="item", value_property="rating",
        default_values={"buy": 4.0}, dedup=True, n_shards=2, shard_index=s)
        for s in range(2)]
    script = [[list(r[0]) for r in reads], [list(r[1]) for r in reads],
              [len(r[4]) for r in reads]]
    shards = [trec.DataSource(trec.DataSourceParams(app_name="rec")).read_training(
        ShardStub(s, script)) for s in range(2)]
    assert all(sh.rows_are_local and sh.n_rows_global == len(td.ratings)
               for sh in shards)
    assert sum(len(sh.ratings) for sh in shards) == len(td.ratings)
    assert set(shards[1].user_idx) >= {len(reads[0][0])}  # the offset
    # sharded evaluation folds (held bitwise against the reference's in
    # tests/test_torch_distributed_eval.py): two processes in lockstep
    # each train on their shard of a fold and evaluate the same queries
    from tests.test_torch_distributed_eval import Lockstep

    folds = Lockstep(2).run(lambda ctx: trec.DataSource(trec.DataSourceParams(
        app_name="rec", eval_k=2)).read_eval(ctx))
    for (a, ei_a, qa_a), (b, ei_b, qa_b) in zip(*folds):
        assert ei_a == ei_b and qa_a == qa_b and qa_a
        assert a.rows_are_local and a.n_rows_global == len(a.ratings) + len(b.ratings)
        held = sum(len(act.ratings) for _, act in qa_a)
        assert a.n_rows_global + held == len(td.ratings)
    with pytest.raises(RuntimeError, match="no process group was joined"):
        trec.DataSource(trec.DataSourceParams(app_name="rec", eval_k=2)).read_eval(
            DeviceContext(torch.device("cpu"), process_index=0, process_count=2))
    # evaluation is ported: create_workflow runs it on the CPU through
    # FastEvalEngine and writes an EVALCOMPLETED row
    _, ts = stores
    iid = create_workflow(WorkflowConfig(
        evaluation_class=f"{__name__}:RecEvaluation", device="cpu"), ts)
    inst = ts.get_meta_data_evaluation_instances().get(iid)
    assert inst.status == "EVALCOMPLETED" and inst.end_time is not None
    assert inst.evaluator_results.startswith("[") and "Precision@K" in inst.evaluator_results
    assert len(json.loads(inst.evaluator_results_json)["results"]) == 4


class RecEvaluation(trec.RecommendationEvaluation):
    """The reference grid on this file's ``rec`` app, 2 folds."""

    def __init__(self):
        super().__init__(app_name="rec", eval_k=2)


def test_cli_app_new_import_train(tmp_pio_home, tmp_path, capsys):
    """The CLI verbs in-process against the sqlite storage the environment
    names; a failed train marks its instance FAILED."""
    prev = treg.use_storage(None)
    try:
        assert cli.main(["app", "new", "rec"]) == 0
        out = capsys.readouterr().out
        app_id = int(out.split("ID: ")[-1].split()[0])
        assert cli.main(["app", "new", "rec"]) == 1  # exists
        events = tmp_path / "events.json"
        dicts = _event_dicts(n=200)
        events.write_text("\n".join(json.dumps(d) for d in dicts) + "\n\n")
        assert cli.main(["import", "--appid", str(app_id), "--input", str(events)]) == 0
        assert f"Imported {len(dicts)} events." in capsys.readouterr().out
        path = _variant(tmp_path)
        assert cli.main(["train", "-v", path, "--device", "cpu"]) == 0
        iid = capsys.readouterr().out.split("Engine instance ID: ")[-1].strip()
        storage = treg.get_storage()
        assert storage.get_meta_data_engine_instances().get(iid).status == "COMPLETED"
        with open(path) as f:
            bad = json.load(f)
        bad["datasource"]["params"]["appName"] = "nope"
        bad_path = tmp_path / "bad.json"
        bad_path.write_text(json.dumps(bad))
        with pytest.raises(ValueError, match="Invalid app name"):
            cli.main(["train", "-v", str(bad_path), "--device", "cpu"])
        statuses = sorted(i.status for i in
                          storage.get_meta_data_engine_instances().get_all())
        assert statuses == ["COMPLETED", "FAILED"]
        bad_line = tmp_path / "bad_events.json"
        bad_line.write_text(json.dumps({"event": "rate", "entityType": "user",
                                        "entityId": "u1",
                                        "targetEntityType": "item"}) + "\n")
        with pytest.raises(tevent.EventValidationError):
            cli.main(["import", "--appid", str(app_id), "--input", str(bad_line)])
    finally:
        s = treg.use_storage(prev)
        if s is not None:
            s.close()
