"""PyTorch port, the classification template and its MLP against the JAX
package's, on the CPU: ``read_training`` (``aggregate_properties`` with
``required=``), the MLP's step and fit from the same (converted)
parameters, naive Bayes, the vote serving, pickling, ``convert.py``'s MLP
functions, and train → persist → deploy through ``create_workflow``.

Tolerances, each measured on this file's data:

- ``read_training`` bitwise;
- one MLP step from the same parameters: the loss within 1e-4 relative;
  every gradient within 4e-3 of its max abs of the reference's — measured
  bitwise, with the bias gradients taken as the sum of JAX's per-row bf16
  cotangents accumulated in fp32 and rounded once to bf16 (how torch
  reduces bf16). XLA's CPU backend sums those cotangents in bf16 instead:
  against its own bias gradients the port is within 1e-2 of max abs
  (measured 6.9e-3), the weights' still bitwise;
- a 6-epoch fit from the same init: the loss within 5e-3 relative of the
  JAX package's on the CPU (measured 2.6e-3: the bf16 bias sums above,
  compounded by adam), the predicted labels of held-out rows equal on
  ≥ 99% of them;
- naive Bayes means, variances and log priors within 1e-5 relative (fp32
  segment sums in another order), labels equal.
"""

import datetime as dt
import json
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from incubator_predictionio_tpu.data import event as jevent  # noqa: E402
from incubator_predictionio_tpu.data.storage import base as jbase  # noqa: E402
from incubator_predictionio_tpu.data.storage import registry as jreg  # noqa: E402
from incubator_predictionio_tpu.models import mlp as jmlp  # noqa: E402
from incubator_predictionio_tpu.parallel.mesh import MeshContext  # noqa: E402
from incubator_predictionio_tpu.templates import classification as jcl  # noqa: E402
from incubator_predictionio_tpu_torch import convert  # noqa: E402
from incubator_predictionio_tpu_torch.core.workflow.create_workflow import (  # noqa: E402
    WorkflowConfig,
    create_workflow,
)
from incubator_predictionio_tpu_torch.data import event as tevent  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import base as tbase  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402
from incubator_predictionio_tpu_torch.models import mlp as tmlp  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext  # noqa: E402
from incubator_predictionio_tpu_torch.server.query_server import (  # noqa: E402
    ServerConfig,
    load_deployed_engine,
)
from incubator_predictionio_tpu_torch.templates import classification as tcl  # noqa: E402
from incubator_predictionio_tpu_torch.utils.json_util import to_jsonable  # noqa: E402
from incubator_predictionio_tpu_torch.utils.serialization import (  # noqa: E402
    deserialize_model,
    serialize_model,
)
from tests.test_torch_similarproduct import pickle_names_torch  # noqa: E402

CPU = DeviceContext.create(device="cpu")
FACTORY = "incubator_predictionio_tpu_torch.templates.classification.ClassificationEngine"
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
GRAD_TOL, CPU_BIAS_TOL, FIT_LOSS_RTOL, NB_RTOL = 4e-3, 1e-2, 5e-3, 1e-5


def _data(n=600, seed=0):
    """Three features, the plan a linear rule of them (three classes)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3)).astype(np.float32) * [1.0, 2.0, 0.5] + [0, 3, -1]
    s = x @ np.array([1.0, -0.5, 2.0], np.float32)
    y = np.digitize(s, np.quantile(s, [1 / 3, 2 / 3])).astype(np.float64)
    return x.astype(np.float32), y


def _event_dicts():
    x, y = _data(200, seed=3)
    out = []
    for j, (row, label) in enumerate(zip(x, y)):
        props = {f"attr{k}": float(row[k]) for k in range(3)}
        props["plan"] = float(label)
        if j % 17 == 0:
            props.pop("attr1")  # incomplete: filtered by required=
        out.append({"event": "$set", "entityType": "user", "entityId": f"u{j}",
                    "properties": props,
                    "eventTime": (T0 + dt.timedelta(seconds=j)).isoformat()})
    out.append({"event": "$set", "entityType": "user", "entityId": "u5",
                "properties": {"plan": 2.0},  # a later $set wins
                "eventTime": (T0 + dt.timedelta(seconds=500)).isoformat()})
    out.append({"event": "$unset", "entityType": "user", "entityId": "u6",
                "properties": {"plan": None},
                "eventTime": (T0 + dt.timedelta(seconds=501)).isoformat()})
    return out


def _fill(reg, base, event_mod, path, dicts):
    storage = reg.Storage({"PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
                           "PIO_STORAGE_SOURCES_DB_PATH": path})
    app_id = storage.get_meta_data_apps().insert(base.App(0, "cls"))
    events = storage.get_events()
    events.init(app_id)
    events.insert_batch([event_mod.Event.from_json_dict(d) for d in dicts], app_id)
    return storage


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cls")
    dicts = _event_dicts()
    js = _fill(jreg, jbase, jevent, str(tmp / "jax.db"), dicts)
    ts = _fill(treg, tbase, tevent, str(tmp / "torch.db"), dicts)
    prev_j, prev_t = jreg.use_storage(js), treg.use_storage(ts)
    yield js, ts, str(tmp / "torch.db")
    jreg.use_storage(prev_j)
    treg.use_storage(prev_t)
    js.close()
    ts.close()


def test_read_training_is_the_references(stores):
    want = jcl.DataSource(jcl.DataSourceParams(app_name="cls")).read_training(
        MeshContext.create())
    got = tcl.DataSource(tcl.DataSourceParams(app_name="cls")).read_training(CPU)
    got.sanity_check()
    for name in ("x", "y"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(got.x) == 200 - len(range(0, 200, 17)) - 1  # incomplete, unset
    with pytest.raises(NotImplementedError, match="item 4"):
        tcl.DataSource(tcl.DataSourceParams(app_name="cls")).read_training(
            DeviceContext(torch.device("cpu"), process_index=0, process_count=2))
    # read_eval: k folds by row position, bitwise the reference's
    want_folds = jcl.DataSource(jcl.DataSourceParams(
        app_name="cls", eval_k=3)).read_eval(MeshContext.create())
    got_folds = tcl.DataSource(tcl.DataSourceParams(
        app_name="cls", eval_k=3)).read_eval(CPU)
    assert len(got_folds) == len(want_folds) == 3
    for (gtd, gei, gqa), (wtd, wei, wqa) in zip(got_folds, want_folds):
        assert gei == wei
        for name in ("x", "y"):
            a, b = getattr(gtd, name), getattr(wtd, name)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
        assert [(q.features, a) for q, a in gqa] == [(q.features, a) for q, a in wqa]
        assert len(gtd.x) + len(gqa) == len(got.x)


def _jax_params(dims, seed=0):
    return jax.tree.map(np.asarray, jmlp._init_params(jax.random.key(seed), dims))


def _forward_with_taps(p, x, taps):
    """The reference ``_forward`` with a zero bf16 tap added to each layer's
    pre-activation: the same values (x + 0 is x), and the gradient with
    respect to a tap is that layer's per-row cotangent."""
    bf16 = jnp.bfloat16
    h = x.astype(bf16)
    for layer, tap in zip(p[:-1], taps[:-1]):
        h = jnp.maximum(h @ layer["w"].astype(bf16) + layer["b"].astype(bf16)
                        + tap, 0.0)
    out = h @ p[-1]["w"].astype(bf16) + p[-1]["b"].astype(bf16) + taps[-1]
    return out.astype(jnp.float32)


def test_one_step_gradients_match_jax():
    x, y = _data(256)
    classes, y_idx = np.unique(y, return_inverse=True)
    xn = ((x - x.mean(0)) / (x.std(0) + 1e-8)).astype(np.float32)
    w = np.ones(256, np.float32)
    w[-20:] = 0.0  # padding rows weigh nothing
    dims = [3, 32, 32, 3]
    params = _jax_params(dims)
    taps = [jnp.zeros((256, d), jnp.bfloat16) for d in dims[1:]]

    def loss_fn(p, taps=None):
        logits = (jmlp._forward(p, jnp.asarray(xn)) if taps is None
                  else _forward_with_taps(p, jnp.asarray(xn), taps))
        losses = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y_idx.astype(np.int32)))
        return jnp.sum(losses * w) / jnp.maximum(jnp.sum(w), 1.0)

    assert np.array_equal(np.asarray(_forward_with_taps(params, jnp.asarray(xn), taps)),
                          np.asarray(jmlp._forward(params, jnp.asarray(xn))))
    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    cotangents = jax.grad(loss_fn, argnums=1)(params, taps)
    net = tmlp.MLPNet([{k: torch.from_numpy(v) for k, v in layer.items()}
                       for layer in convert.mlp_params_from_jax(params)])
    loss = tmlp.weighted_xent(net(torch.from_numpy(xn)),
                              torch.from_numpy(y_idx.astype(np.int64)),
                              torch.from_numpy(w))
    grads = torch.autograd.grad(loss, list(net.parameters()))
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-4 * abs(float(jloss))

    def rel(got, ref):
        ref = np.asarray(ref, np.float32)
        return float(np.abs(got.numpy() - ref).max() / np.abs(ref).max())

    n = len(params)
    for got, layer in zip(grads[:n], jgrads):
        assert rel(got, layer["w"]) <= GRAD_TOL
    for got, layer, ct in zip(grads[n:], jgrads, cotangents):
        tpu_sum = jnp.sum(ct.astype(jnp.float32), axis=0).astype(jnp.bfloat16)
        assert rel(got, tpu_sum.astype(jnp.float32)) <= GRAD_TOL
        assert rel(got, layer["b"]) <= CPU_BIAS_TOL


def test_fit_from_the_same_init_matches_jax(monkeypatch):
    x, y = _data(900, seed=1)
    xt, yt = x[:700], y[:700]
    cfg = dict(hidden_dims=(32, 32), learning_rate=1e-2, batch_size=64, epochs=6)
    jm = jmlp.MLPClassifier(jmlp.MLPConfig(**cfg, seed=0)).fit(MeshContext.create(), xt, yt)
    seeded = tmlp.MLPClassifier(tmlp.MLPConfig(**cfg, seed=0)).fit(CPU, xt, yt)
    init = convert.mlp_params_from_jax(_jax_params([3, 32, 32, 3], seed=0))
    monkeypatch.setattr(tmlp, "init_params", lambda gen, dims, device: [
        {k: torch.from_numpy(v).to(device) for k, v in layer.items()} for layer in init])
    tm = tmlp.MLPClassifier(tmlp.MLPConfig(**cfg, seed=0)).fit(CPU, xt, yt)
    assert abs(tm.final_loss - jm.final_loss) <= FIT_LOSS_RTOL * abs(jm.final_loss), (
        tm.final_loss, jm.final_loss)
    assert tm.classes == jm.classes
    got = tmlp.MLPClassifier.predict(tm, x[700:])
    want = jmlp.MLPClassifier.predict(jm, x[700:])
    assert np.mean(got == want) >= 0.99
    assert np.mean(got == y[700:]) > 0.9
    # the seeded init (torch.Generator) trains as well
    assert np.mean(tmlp.MLPClassifier.predict(seeded, x[700:]) == y[700:]) > 0.9


def test_forward_casts_match_jax():
    x, _ = _data(64, seed=2)
    params = _jax_params([3, 16, 3], seed=4)
    want = np.asarray(jmlp._forward(params, jnp.asarray(x)))
    net = tmlp.MLPNet([{k: torch.from_numpy(v) for k, v in layer.items()}
                       for layer in convert.mlp_params_from_jax(params)])
    got = net(torch.from_numpy(x)).detach().numpy()
    # bf16 logits: each within one bf16 ulp of the JAX forward's
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert (np.abs(got - want) <= ulp).all()


def test_naive_bayes_matches_jax(stores):
    x, y = _data(500, seed=5)
    jtd, ttd = jcl.TrainingData(x, y), tcl.TrainingData(x, y)
    jm = jcl.NaiveBayesAlgorithm(jcl.NaiveBayesAlgorithmParams()).train(
        MeshContext.create(), jtd)
    ta = tcl.NaiveBayesAlgorithm(tcl.NaiveBayesAlgorithmParams())
    tm = ta.train(CPU, ttd)
    np.testing.assert_array_equal(tm.classes, jm.classes)
    for name in ("means", "variances", "log_priors"):
        np.testing.assert_allclose(getattr(tm, name), getattr(jm, name),
                                   rtol=NB_RTOL, atol=0, err_msg=name)
    ja = jcl.NaiveBayesAlgorithm(jcl.NaiveBayesAlgorithmParams())
    queries = [(i, tcl.Query(tuple(map(float, r)))) for i, r in enumerate(x[:50])]
    jq = [(i, jcl.Query(q.features)) for i, q in queries]
    assert [p.label for _, p in ta.batch_predict(tm, queries)] == \
        [p.label for _, p in ja.batch_predict(jm, jq)]
    for (_, q), (_, jqq) in zip(queries[:10], jq[:10]):
        got, want = ta.predict(tm, q), ja.predict(jm, jqq)
        assert got.label == want.label
        for k in want.scores:
            assert abs(got.scores[k] - want.scores[k]) <= 1e-4


def test_vote_serving():
    p = [tcl.PredictedResult(label=1.0), tcl.PredictedResult(label=2.0),
         tcl.PredictedResult(label=2.0)]
    assert tcl.VoteServing().serve(None, p) is p[1]
    assert tcl.VoteServing().serve(None, p[:2]) is p[0]  # ties: first algorithm
    with pytest.raises(ValueError):
        tcl.VoteServing().serve(None, [])


def test_pickled_models_serve_the_same_and_hold_no_tensor():
    x, y = _data(300, seed=6)
    td = tcl.TrainingData(x, y)
    mlp = tcl.MLPAlgorithm(tcl.MLPAlgorithmParams(hidden_dims=(8,), epochs=2))
    nb = tcl.NaiveBayesAlgorithm(tcl.NaiveBayesAlgorithmParams())
    for algo in (mlp, nb):
        model = algo.train(CPU, td)
        blob = serialize_model([model])
        assert not pickle_names_torch(blob) and not pickle_names_torch(pickle.dumps(model))
        (back,) = deserialize_model(blob)
        back.prepare_for_serving(CPU)
        qs = [(i, tcl.Query(tuple(map(float, r)))) for i, r in enumerate(x[:20])]
        assert algo.batch_predict(back, qs) == algo.batch_predict(model, qs)
        assert algo.predict(back, qs[0][1]) == algo.predict(model, qs[0][1])


def test_convert_round_trips():
    params = _jax_params([3, 8, 4, 2], seed=7)
    layers = convert.mlp_params_from_jax(params)
    for a, b in zip(layers, params):
        assert a["w"].tobytes() == np.asarray(b["w"], np.float32).tobytes()
        assert a["b"].tobytes() == np.asarray(b["b"], np.float32).tobytes()
    with pytest.raises(ValueError):
        convert.mlp_params_from_jax([params[0], params[2]])
    # the converted parameters serve the JAX model's labels
    x, _ = _data(50, seed=8)
    mean, std = x.mean(0), x.std(0) + 1e-8
    jm = jmlp.MLPModel(params, mean, std, [0.0, 1.0], jmlp.MLPConfig(hidden_dims=(8, 4)))
    tm = tmlp.MLPModel(layers, mean, std, [0.0, 1.0], tmlp.MLPConfig(hidden_dims=(8, 4)))
    tm.prepare_for_serving(CPU)
    assert (tmlp.MLPClassifier.predict(tm, x) == jmlp.MLPClassifier.predict(jm, x)).mean() >= 0.99


def test_fit_refuses_sharded_rows():
    x, y = _data(50)
    with pytest.raises(NotImplementedError, match="item 4"):
        tmlp.MLPClassifier(tmlp.MLPConfig(epochs=1)).fit(
            DeviceContext(torch.device("cpu"), process_index=0, process_count=2),
            x, y, rows_are_local=True)


def test_train_persist_deploy_query(stores, tmp_path):
    """MLP and naive Bayes behind the vote serving, through
    ``create_workflow`` and a deploy of the persisted models; a fresh
    process loads them from the same store and answers alike."""
    _, storage, db_path = stores
    path = str(tmp_path / "engine.json")
    with open(path, "w") as f:
        json.dump({"id": "cls", "version": "1", "engineFactory": FACTORY,
                   "datasource": {"params": {"appName": "cls"}},
                   "algorithms": [
                       {"name": "mlp", "params": {"hiddenDims": [16, 16],
                                                  "epochs": 20, "batchSize": 64}},
                       {"name": "nb", "params": {}}],
                   "serving": {"name": "vote"}}, f)
    iid = create_workflow(WorkflowConfig(engine_variant=path, device="cpu"), storage)
    assert not pickle_names_torch(storage.get_model_data_models().get(iid).models)
    deployed = load_deployed_engine(ServerConfig(engine_variant=path), storage,
                                    ctx=CPU)
    assert [m.serving_info()["device"] for m in deployed.models] == ["cpu", "cpu"]
    x, y = _data(200, seed=3)
    qs = [{"features": [float(v) for v in row]} for row in x[:40]]
    got = deployed.predict_batch(qs)
    assert [r.label for r in got] == [deployed.predict(q).label for q in qs]
    assert np.mean([r.label == t for r, t in zip(got, y[:40])]) > 0.8
    # a fresh process loads the persisted models from the same store and
    # serves the same answers
    code = (
        "import json, sys\n"
        "from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext\n"
        "from incubator_predictionio_tpu_torch.server.query_server import (\n"
        "    ServerConfig, load_deployed_engine)\n"
        "from incubator_predictionio_tpu_torch.utils.json_util import to_jsonable\n"
        "d = load_deployed_engine(ServerConfig(engine_variant=sys.argv[1]),\n"
        "                         ctx=DeviceContext.create('cpu'))\n"
        "qs = json.loads(sys.stdin.read())\n"
        "print(json.dumps([to_jsonable(d.predict(q)) for q in qs]))\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PIO_STORAGE_")}
    env.update(PIO_STORAGE_SOURCES_DB_TYPE="sqlite",
               PIO_STORAGE_SOURCES_DB_PATH=db_path,
               PYTHONPATH=str(pathlib.Path(__file__).resolve().parent.parent))
    out = subprocess.run([sys.executable, "-c", code, path], input=json.dumps(qs),
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    fresh = json.loads(out.stdout.strip().splitlines()[-1])
    assert fresh == [to_jsonable(deployed.predict(q)) for q in qs]
