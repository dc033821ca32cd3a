"""PyTorch port, the sequential template's serving path: the same numpy
parameters go into the JAX package's ``TransformerModel`` (built directly,
no training) and, through ``convert.transformer_model_from_params``, into
the port's; ``next_item_scores``, ``batch_predict`` and ``/queries.json``
must answer alike.

Tolerance on scores: 1e-2 absolute. Every matmul of the model rounds its
operands and its product to bf16, so the scores are bf16 values (spacing
2^-9 to 2^-8 at the |scores| < 1 these weights give). The two packages
compute layer norm and gelu in fp32 in different orders (≤ 1 ulp apart,
tested below), and such a difference flips the bf16 rounding of a matmul
operand now and then: the scores then move by a few bf16 steps. For the
same reason ids are compared tie-aware: an id may differ only where its
score is within the tolerance of the cut-off.
"""

import asyncio
import dataclasses
import datetime as dt
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

from incubator_predictionio_tpu.data.bimap import BiMap as JBiMap  # noqa: E402
from incubator_predictionio_tpu.models import transformer as jtr  # noqa: E402
from incubator_predictionio_tpu.templates import sequential as jseq  # noqa: E402
from incubator_predictionio_tpu.utils.json_util import (  # noqa: E402
    bind_query as jbind_query,
)
from incubator_predictionio_tpu_torch import convert  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import (  # noqa: E402
    EngineInstance,
    Model,
    Storage,
)
from incubator_predictionio_tpu_torch.data.store import LEventStore  # noqa: E402
from incubator_predictionio_tpu_torch.models import transformer as ttr  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext  # noqa: E402
from incubator_predictionio_tpu_torch.server.query_server import (  # noqa: E402
    QueryServer,
    ServerConfig,
)
from incubator_predictionio_tpu_torch.templates import sequential as tseq  # noqa: E402
from incubator_predictionio_tpu_torch.utils.json_util import bind_query  # noqa: E402
from incubator_predictionio_tpu_torch.utils.serialization import (  # noqa: E402
    deserialize_model,
    serialize_model,
)

TOL = 1e-2
N_ITEMS, D, HEADS, LAYERS = 199, 64, 2, 2
ITEM_IDS = [f"i{j}" for j in range(N_ITEMS)]  # token j + 1
FACTORY = "incubator_predictionio_tpu_torch.templates.sequential.SequentialEngine"
CPU = DeviceContext.create(device="cpu")


def _params(max_len, seed=0):
    cfg = ttr.TransformerConfig(vocab_size=N_ITEMS + 1, max_len=max_len,
                                d_model=D, n_heads=HEADS, n_layers=LAYERS)
    return ttr.init_params_numpy(cfg, seed)


def _pair(max_len, seed=0):
    """(JAX model, port model, served on the CPU) over the same arrays."""
    params = _params(max_len, seed)
    jcfg = jtr.TransformerConfig(vocab_size=N_ITEMS + 1, max_len=max_len,
                                 d_model=D, n_heads=HEADS, n_layers=LAYERS)
    jm = jtr.TransformerModel(jax.tree.map(jnp.asarray, params),
                              JBiMap({iid: j + 1 for j, iid in enumerate(ITEM_IDS)}),
                              jcfg)
    tm = convert.transformer_model_from_params(params, ITEM_IDS, n_heads=HEADS)
    return jm, tm.prepare_for_serving(CPU)


def _sessions(max_len, seed=9):
    """recentItems sessions: short ones (padded rows), ones longer than
    max_len (truncated), ones with unknown ids, a cold one, an empty one."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (1, 3, max_len // 2, max_len - 1, max_len, max_len + 7):
        out.append([f"i{i}" for i in rng.integers(0, N_ITEMS, n)])
    out.append(["i5", "nope", "i9", "i5"])       # unknown id and a repeat
    out.append(["nope", "never-seen"])           # cold: no known item
    out.append([])                               # empty session
    return out


def _assert_same_items(got, want_scores, want, tol=TOL):
    """``got`` and ``want`` are PredictedResults; ``want_scores`` is the
    reference's full score row (history and padding at -inf). Ids may
    differ only through near-ties at the cut-off; every served score
    matches the reference's score of that item."""
    g = [s.item for s in got.item_scores]
    w = [s.item for s in want.item_scores]
    assert len(g) == len(w)
    if not w:
        return
    cut = want.item_scores[-1].score
    for iid in set(g) ^ set(w):
        assert abs(want_scores[iid] - cut) <= tol, (iid, g, w)
    for s in got.item_scores:
        assert abs(s.score - want_scores[s.item]) <= tol, (s, want_scores[s.item])
    scores = [s.score for s in got.item_scores]
    assert scores == sorted(scores, reverse=True)


def _reference_rows(jm, sessions):
    """The reference's score rows with its host-side exclusions applied,
    keyed by item id."""
    rows = np.stack([jseq.encode_session(s, jm.item_map, jm.config.max_len)
                     for s in sessions])
    scores = jtr.TransformerRecommender.next_item_scores(jm, rows)
    inv = jm.item_map.inverse()
    return [{inv[t]: float(r[t]) for t in range(1, len(r))} for r in scores]


@pytest.mark.parametrize("max_len", [32, 128])
def test_next_item_scores_match_jax(max_len):
    jm, tm = _pair(max_len)
    rng = np.random.default_rng(max_len)
    rows = rng.integers(1, N_ITEMS + 1, (6, max_len)).astype(np.int32)
    rows[:3, : max_len // 2] = 0  # left-padded rows
    rows[3, :-1] = 0              # one item
    want = jtr.TransformerRecommender.next_item_scores(jm, rows)
    got = ttr.TransformerRecommender.next_item_scores(tm, rows)
    assert got.shape == want.shape == (6, N_ITEMS + 1)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # the scores are bf16 values, as the reference's are
    np.testing.assert_array_equal(
        got, torch.from_numpy(got).bfloat16().float().numpy())


@pytest.mark.parametrize("max_len", [32, 128])
def test_batch_predict_matches_jax(max_len):
    jm, tm = _pair(max_len, seed=1)
    sessions = _sessions(max_len)
    nums = [10, 1, 30, 10, 5, 10, 10, 10, 10]
    jalgo = jseq.TransformerAlgorithm(jseq.TransformerAlgorithmParams())
    talgo = tseq.TransformerAlgorithm(tseq.TransformerAlgorithmParams())
    jq = [(i, jseq.Query(recent_items=tuple(s), num=n))
          for i, (s, n) in enumerate(zip(sessions, nums))]
    tq = [(i, tseq.Query(recent_items=tuple(s), num=n))
          for i, (s, n) in enumerate(zip(sessions, nums))]
    want = dict(jalgo.batch_predict(jm, jq))
    got = dict(talgo.batch_predict(tm, tq))
    assert sorted(got) == sorted(want) == list(range(len(sessions)))
    ref_rows = _reference_rows(jm, sessions)
    for i, s in enumerate(sessions):
        served = [x.item for x in got[i].item_scores]
        assert not set(served) & set(s), "a history item was served"
        if not any(iid in tm.item_map for iid in s):
            assert got[i].item_scores == () == want[i].item_scores
            continue
        assert len(served) == min(nums[i], N_ITEMS - len(set(s) & set(ITEM_IDS)))
        _assert_same_items(got[i], ref_rows[i], want[i])
    # predict is batch_predict of one
    one = talgo.predict(tm, tq[2][1])
    _assert_same_items(one, ref_rows[2], want[2])


def test_layer_norm_and_gelu_match_jax_to_fp32_roundoff():
    """The two packages' building blocks: the bf16 matmul bitwise, layer
    norm (eps 1e-6, population variance) and tanh-gelu within fp32
    roundoff — the source of the score tolerance above."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 16, 64)).astype(np.float32)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    g, b = rng.normal(size=64).astype(np.float32), rng.normal(size=64).astype(np.float32)
    np.testing.assert_array_equal(
        ttr._bf16_matmul(torch.from_numpy(x), torch.from_numpy(w).bfloat16()).numpy(),
        np.asarray(jtr._bf16_matmul(jnp.asarray(x), jnp.asarray(w))))
    np.testing.assert_allclose(
        ttr._ln(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b)).numpy(),
        np.asarray(jtr._ln(jnp.asarray(x), {"g": jnp.asarray(g), "b": jnp.asarray(b)})),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("items,width", [
    (["a", "b", "c"], 5), (["a", "x", "b", "c", "a"], 3), ([], 4),
    (["x", "y"], 4), (["c"] * 9, 6)])
def test_encode_session_matches_jax(items, width):
    fwd = {"a": 1, "b": 2, "c": 3}
    np.testing.assert_array_equal(
        tseq.encode_session(items, tseq.BiMap(fwd), width),
        jseq.encode_session(items, JBiMap(fwd), width))


def test_recent_items_bind_from_json_as_in_the_reference():
    payload = {"recentItems": ["i1", "i2"], "num": 4}
    got = bind_query(tseq.Query, payload)
    want = jbind_query(jseq.Query, payload)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert list(got.recent_items) == ["i1", "i2"] and got.num == 4
    with pytest.raises(TypeError, match="unknown parameter"):
        bind_query(tseq.Query, {"recentItems": [], "colour": "red"})


def _deploy_env(tmp_path, model, variant_params=None):
    variant_path = str(tmp_path / "engine.json")
    with open(variant_path, "w") as f:
        json.dump({"id": "default", "version": "1", "engineFactory": FACTORY,
                   "algorithms": [{"name": "transformer",
                                   "params": variant_params or {}}]}, f)
    storage = Storage({"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})
    now = dt.datetime.now(dt.timezone.utc)
    iid = storage.get_meta_data_engine_instances().insert(EngineInstance(
        id="", status="COMPLETED", start_time=now, end_time=now,
        engine_id="default", engine_version="1",
        engine_variant=os.path.abspath(variant_path), engine_factory=FACTORY))
    storage.get_model_data_models().insert(Model(iid, serialize_model([model])))
    return storage, variant_path


def test_queries_json_matches_jax_and_isolates_user_queries(tmp_path):
    """Sessions answer as the JAX template does; user queries in a burst
    read their histories from the event store on their own: a user the
    store does not know answers empty (tests/test_torch_event_store_reads.py
    holds the answers of known users)."""
    max_len = 32
    jm, tm = _pair(max_len, seed=2)
    storage, variant_path = _deploy_env(
        tmp_path, convert.transformer_model_from_params(
            _params(max_len, seed=2), ITEM_IDS, n_heads=HEADS),
        {"maxLen": max_len, "dModel": D, "nHeads": HEADS, "nLayers": LAYERS})
    sessions = _sessions(max_len, seed=4)
    jalgo = jseq.TransformerAlgorithm(jseq.TransformerAlgorithmParams())
    want = [jalgo.predict(jm, jseq.Query(recent_items=tuple(s), num=10))
            for s in sessions]
    ref_rows = _reference_rows(jm, sessions)

    def check(i, body):
        got = tseq.PredictedResult(tuple(
            tseq.ItemScore(x["item"], x["score"]) for x in body["itemScores"]))
        if not any(iid in tm.item_map for iid in sessions[i]):
            assert got.item_scores == ()
        else:
            _assert_same_items(got, ref_rows[i], want[i])

    async def run():
        server = QueryServer(ServerConfig(engine_variant=variant_path),
                             storage=storage, ctx=CPU)
        info = server.deployed.models[0].serving_info()
        assert info["device"] == "cpu" and info["max_len"] == max_len
        server.deployed.algorithms[0]._levents = LEventStore(Storage({
            "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
            "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "events.db")}))
        client = TestClient(TestServer(server.make_app()))
        await client.start_server()
        try:
            for i, s in enumerate(sessions):  # one at a time
                resp = await client.post("/queries.json",
                                         json={"recentItems": s, "num": 10})
                assert resp.status == 200
                check(i, await resp.json())
            # a concurrent burst with user queries among the sessions: each
            # user query reads its own history (none here), the others get
            # their answers
            burst = [{"recentItems": s, "num": 10} for s in sessions] * 2
            burst[3:3] = [{"user": "u1", "num": 10}]
            burst.append({"user": "u2"})
            resps = await asyncio.gather(*[
                client.post("/queries.json", json=p) for p in burst])
            k = 0
            for p, resp in zip(burst, resps):
                body = await resp.json()
                if "user" in p:
                    assert resp.status == 200 and body == {"itemScores": []}
                    continue
                assert resp.status == 200
                check(k % len(sessions), body)
                k += 1
            assert server.batcher.max_batch_seen > 1
        finally:
            await client.close()
            await server.shutdown()

    asyncio.run(run())


def test_serialize_deserialize_deploy_round_trip():
    params = _params(32, seed=3)
    model = convert.transformer_model_from_params(params, ITEM_IDS, n_heads=HEADS)
    served = model.prepare_for_serving(CPU)
    back = deserialize_model(serialize_model([served]))[0]
    assert back._net is None  # serving state is rebuilt at deploy
    assert back.config == model.config and back.item_map == model.item_map
    np.testing.assert_array_equal(back.params["layers"][1]["w2"],
                                  params["layers"][1]["w2"])
    back.prepare_for_serving(CPU)
    rows = np.stack([tseq.encode_session(s, model.item_map, 32)
                     for s in _sessions(32)[:6]])
    np.testing.assert_array_equal(
        ttr.TransformerRecommender.next_item_scores(back, rows),
        ttr.TransformerRecommender.next_item_scores(served, rows))


def test_unported_stages_raise_and_name_the_roadmap(tmp_path):
    cfg = ttr.TransformerConfig(vocab_size=N_ITEMS + 1, max_len=32,
                                d_model=D, n_heads=HEADS, n_layers=LAYERS,
                                n_experts=4)
    # a mixture-of-experts model serves (ported: tests/test_torch_moe.py),
    # as the JAX package's does, over the same arrays
    moe_params = ttr.init_params_numpy(cfg, 0)
    moe = ttr.TransformerModel(moe_params, tseq.BiMap({}), cfg)
    assert moe.prepare_for_serving(CPU) is moe
    assert moe.serving_info()["n_experts"] == 4
    rows = np.zeros((2, 33), np.int32)
    hist = np.asarray(jax.random.randint(jax.random.key(3), (4, 32), 0, N_ITEMS + 1),
                      np.int32)
    want = jtr.TransformerRecommender.next_item_scores(jtr.TransformerModel(
        jax.tree.map(jnp.asarray, moe_params), None, jtr.TransformerConfig(
            vocab_size=N_ITEMS + 1, max_len=32, d_model=D, n_heads=HEADS,
            n_layers=LAYERS, n_experts=4)), hist)
    np.testing.assert_allclose(
        ttr.TransformerRecommender.next_item_scores(moe, hist), want,
        rtol=0, atol=TOL)
    # training options of the sharding slice: ring attention without a
    # 'seq' axis raises the reference's ValueError (tests/
    # test_torch_ring_attention.py); the pipeline, tensor and expert
    # parallelism are ported on their axes (tests/test_torch_pipeline.py,
    # test_torch_tensor_parallel.py, test_torch_moe.py), checkpoints
    # included (tests/test_torch_sharded_checkpoint.py): on a context with
    # no process group behind it such a fit goes as far as its first
    # collective, the checkpoint's
    with pytest.raises(ValueError, match="'seq' axis"):
        ttr.TransformerRecommender(dataclasses.replace(
            cfg, n_experts=0, attention="ring")).fit(CPU, rows, None)
    for field, value in (("pipeline_stages", 2), ("tensor_parallel", True),
                         ("n_experts", 4)):
        c = dataclasses.replace(cfg, **{"n_experts": 0, field: value})
        axis = {"pipeline_stages": "pipe", "tensor_parallel": "model",
                "n_experts": "expert"}[field]
        ctx = DeviceContext(torch.device("cpu"), 0, 2, axes={axis: 2})
        c = dataclasses.replace(c, checkpoint_dir=str(tmp_path / field),
                                checkpoint_every=1)
        with pytest.raises(RuntimeError, match="no process group was joined"):
            ttr.TransformerRecommender(c).fit(ctx, rows, None)
        assert (tmp_path / field).is_dir()  # the checkpointer opened it
    # the template's numExperts trains a mixture of experts on one device
    # (the degradation recorded: no 'expert' axis) and serves it
    algo = tseq.TransformerAlgorithm(tseq.TransformerAlgorithmParams(
        max_len=32, num_experts=2, epochs=1))
    trained = algo.train(CPU, tseq.TrainingData(rows, tseq.BiMap({"i0": 1})))
    assert trained.config.n_experts == 2
    assert trained.params["layers"][0]["we1"].shape == (2, 64, 256)
    assert np.isfinite(trained.final_loss)
    assert ttr.TransformerRecommender.next_item_scores(
        trained, rows[:, 1:]).shape == (2, 2)
    # the event-store reads are ported (tests/test_torch_event_store_reads.py),
    # the sharded read of the sessions too (tests/test_torch_distributed_eval.py):
    # two processes read the store as one does, and an app the store does
    # not know fails alike; a user of such an app answers empty
    for ctx in (CPU, DeviceContext(torch.device("cpu"), process_index=0,
                                   process_count=2)):
        with pytest.raises(ValueError, match="Invalid app name sequential"):
            tseq.DataSource(tseq.DataSourceParams()).read_training(ctx)
    _, tm = _pair(32)
    tm.prepare_for_serving(CPU)
    algo._levents = LEventStore(Storage({
        "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.db")}))
    assert algo.predict(tm, tseq.Query(user="u1")) == tseq.PredictedResult()
    with pytest.raises(RuntimeError, match="prepare_for_serving"):
        ttr.TransformerRecommender.next_item_scores(
            convert.transformer_model_from_params(_params(32), ITEM_IDS,
                                                  n_heads=HEADS),
            np.zeros((1, 32), np.int32))


def test_convert_checks_the_arrays():
    params = _params(32)
    with pytest.raises(ValueError, match="padding token"):
        convert.transformer_model_from_params(params, ITEM_IDS[:-1], n_heads=HEADS)
    with pytest.raises(ValueError, match="heads"):
        convert.transformer_model_from_params(params, ITEM_IDS, n_heads=3)
    # a layer with neither FFN still raises; a mixture-of-experts tree
    # (ported) converts with its shapes checked and n_experts from the arrays
    no_ffn = {k: v for k, v in params["layers"][0].items()
              if k not in ("w1", "b1", "w2", "b2")}
    with pytest.raises(ValueError, match="lacks.*dense"):
        convert.transformer_model_from_params(
            {**params, "layers": [no_ffn]}, ITEM_IDS, n_heads=HEADS)
    moe_params = ttr.init_params_numpy(ttr.TransformerConfig(
        vocab_size=N_ITEMS + 1, max_len=32, d_model=D, n_heads=HEADS,
        n_layers=LAYERS, n_experts=3), 1)
    moe = convert.transformer_model_from_params(moe_params, ITEM_IDS,
                                                n_heads=HEADS)
    assert moe.config.n_experts == 3
    np.testing.assert_array_equal(moe.params["layers"][1]["we2"],
                                  moe_params["layers"][1]["we2"])
    with pytest.raises(ValueError, match="n_experts=4 but the layers hold 3"):
        convert.transformer_model_from_params(moe_params, ITEM_IDS,
                                              n_heads=HEADS, n_experts=4)
    bad = jax.tree.map(np.array, moe_params)
    bad["layers"][1]["be1"] = bad["layers"][1]["be1"][:, :-1]
    with pytest.raises(ValueError, match="layer 1 be1 shape"):
        convert.transformer_model_from_params(bad, ITEM_IDS, n_heads=HEADS)
    mixed = {**params, "layers": [params["layers"][0], moe_params["layers"][1]]}
    with pytest.raises(ValueError, match="layer 1 lacks"):
        convert.transformer_model_from_params(mixed, ITEM_IDS, n_heads=HEADS)
    m = convert.transformer_model_from_params(params, ITEM_IDS, n_heads=HEADS)
    assert (m.config.vocab_size, m.config.max_len, m.config.d_model,
            m.config.n_layers, m.config.n_heads) == (N_ITEMS + 1, 32, D, LAYERS, HEADS)
    assert m.item_map["i0"] == 1 and m.item_map[ITEM_IDS[-1]] == N_ITEMS


def test_init_params_numpy_has_the_reference_tree_and_scales():
    cfg = ttr.TransformerConfig(vocab_size=50, max_len=16, d_model=32,
                                n_heads=2, n_layers=3)
    jparams = jtr._init_params(jax.random.key(0), jtr.TransformerConfig(
        vocab_size=50, max_len=16, d_model=32, n_heads=2, n_layers=3))
    tparams = ttr.init_params_numpy(cfg, 0)
    jflat, jtree = jax.tree.flatten(jparams)
    tflat, ttree = jax.tree.flatten(tparams)
    assert jtree == ttree
    for a, b in zip(jflat, tflat):
        assert a.shape == b.shape and b.dtype == np.float32
        if float(np.std(a)) > 0:
            assert 0.8 < float(np.std(b)) / float(np.std(a)) < 1.25
        else:
            np.testing.assert_array_equal(np.asarray(a), b)
