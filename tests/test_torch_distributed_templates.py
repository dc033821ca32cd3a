"""PyTorch port, the similar-product, recommended-user, e-commerce and
classification templates across processes on the CPU: the four sharded
reads, the sharded co-occurrence counts, the sharded naive Bayes fit, the
MLP's sharded moments and staging and its data-parallel fit over a
2-process gloo group, and ``launch -n 2 train`` / ``launch -n 2 eval``
through the CLI — against the JAX package's functions on the same inputs.

The reads and the host sums run every process of a job as a thread of this
process (``Lockstep``, tests/test_torch_distributed_eval.py), each package
on its own sqlite store of the same events (the four templates' test
modules' events, one app each). The fits run real processes through
``parallel/launcher.py:launch_local``.

Tolerances, with their reasons:
- the sharded reads, the co-occurrence lists, the naive Bayes moments and
  the MLP's moments and staging: bitwise (the same numpy and Python code
  on the same rows; the co-occurrence counts here stay below 256, where
  bf16 is exact and XLA's CPU backend, which drops the bf16 rounding,
  agrees with the port).
- the sharded naive Bayes fit against the port's one-process fit: 1e-5
  relative, tests/test_torch_classification.py's ``NB_RTOL`` (float64 host
  sums against float32 segment sums).
- the 2-process MLP fit against the JAX training step run single-process
  on the same global batches from the same initial parameters: the final
  loss within 5e-3 relative and the labels of held-out rows equal on at
  least 99%, tests/test_torch_classification.py's fit parity
  (``FIT_LOSS_RTOL``: the bf16 casts of the forward flip roundings where
  the fp32 sums of the two packages differ by an ulp, and adam carries
  that through the epochs).
- the replicas: bitwise (one all-reduce gives both processes the same
  gradient bytes; adam is then the same ops on the same inputs).
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from incubator_predictionio_tpu.data import event as jevent  # noqa: E402
from incubator_predictionio_tpu.data.storage import base as jbase  # noqa: E402
from incubator_predictionio_tpu.data.storage import registry as jreg  # noqa: E402
from incubator_predictionio_tpu.models import mlp as jmlp  # noqa: E402
from incubator_predictionio_tpu.parallel import staging as jstaging  # noqa: E402
from incubator_predictionio_tpu.templates import classification as jcl  # noqa: E402
from incubator_predictionio_tpu.templates import ecommerce as jec  # noqa: E402
from incubator_predictionio_tpu.templates import recommended_user as jru  # noqa: E402
from incubator_predictionio_tpu.templates import similarproduct as jsp  # noqa: E402
from incubator_predictionio_tpu.utils.optim import jit_adam_init  # noqa: E402
from incubator_predictionio_tpu_torch import convert  # noqa: E402
from incubator_predictionio_tpu_torch.data import event as tevent  # noqa: E402
from incubator_predictionio_tpu_torch.data.bimap import BiMap  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import base as tbase  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402
from incubator_predictionio_tpu_torch.models import mlp as tmlp  # noqa: E402
from incubator_predictionio_tpu_torch.parallel import launcher  # noqa: E402
from incubator_predictionio_tpu_torch.parallel import staging as tstaging  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext  # noqa: E402
from incubator_predictionio_tpu_torch.server.query_server import (  # noqa: E402
    ServerConfig,
    load_deployed_engine,
)
from incubator_predictionio_tpu_torch.templates import classification as tcl  # noqa: E402
from incubator_predictionio_tpu_torch.templates import ecommerce as tec  # noqa: E402
from incubator_predictionio_tpu_torch.templates import recommended_user as tru  # noqa: E402
from incubator_predictionio_tpu_torch.templates import similarproduct as tsp  # noqa: E402

from tests import test_torch_classification as cls_case  # noqa: E402
from tests import test_torch_ecommerce as ec_case  # noqa: E402
from tests import test_torch_recommended_user as ru_case  # noqa: E402
from tests import test_torch_similarproduct as sp_case  # noqa: E402
from tests.test_torch_distributed_eval import Lockstep  # noqa: E402
from tests.test_torch_distributed_train import _bitwise, mirror  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = DeviceContext.create(device="cpu")
LAUNCH_TIMEOUT = 120.0
NB_RTOL, FIT_LOSS_RTOL = cls_case.NB_RTOL, cls_case.FIT_LOSS_RTOL

#: app → (its events, the reference's template, the port's)
APPS = {"sp": (sp_case._event_dicts, jsp, tsp),
        "ru": (ru_case._event_dicts, jru, tru),
        "ec": (ec_case._event_dicts, jec, tec),
        "cls": (cls_case._event_dicts, jcl, tcl)}
#: app → (a row field, the field of its job-wide count) of TrainingData
ROWS = {"sp": [("view_u", "n_views_global"), ("like_u", "n_likes_global")],
        "ru": [("follow_u", "n_follows_global")],
        "ec": [("u_idx", "n_rows_global")],
        "cls": [("x", "n_rows_global")]}


def _fill(reg, base, event_mod, path):
    storage = reg.Storage({"PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
                           "PIO_STORAGE_SOURCES_DB_PATH": path})
    for app, (events, _, _) in APPS.items():
        app_id = storage.get_meta_data_apps().insert(base.App(0, app))
        storage.get_events().init(app_id)
        storage.get_events().insert_batch(
            [event_mod.Event.from_json_dict(d) for d in events()], app_id)
    return storage


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("templates")
    js = _fill(jreg, jbase, jevent, str(tmp / "jax.db"))
    ts = _fill(treg, tbase, tevent, str(tmp / "torch.db"))
    prev_j, prev_t = jreg.use_storage(js), treg.use_storage(ts)
    yield js, ts
    jreg.use_storage(prev_j)
    treg.use_storage(prev_t)
    js.close()
    ts.close()


def _ds(pkg, app):
    return pkg.DataSource(pkg.DataSourceParams(app_name=app))


def _same(got, want, what):
    """Two TrainingData of one template, field by field: arrays bitwise,
    BiMaps in order, the rest equal."""
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            _bitwise(a, b, f"{what}: {f.name}")
        elif hasattr(b, "items") and not isinstance(b, dict):
            assert list(a.items()) == list(b.items()), f"{what}: {f.name}"
        else:
            assert a == b, f"{what}: {f.name}"


def _rows(app, td):
    """A TrainingData's rows as sorted tuples of ids and values."""
    if app == "cls":
        return sorted(zip(map(tuple, td.x.tolist()), td.y.tolist()))
    if app == "ru":
        inv = td.users.inverse()
        return sorted(zip((inv[int(u)] for u in td.follow_u),
                          (inv[int(t)] for t in td.follow_t)))
    users, items = td.users.inverse(), td.items.inverse()
    if app == "ec":
        return sorted(zip((users[int(u)] for u in td.u_idx),
                          (items[int(i)] for i in td.i_idx), td.weight.tolist()))
    return sorted(
        [("view", users[int(u)], items[int(i)], 1.0)
         for u, i in zip(td.view_u, td.view_i)]
        + [("like", users[int(u)], items[int(i)], float(s))
           for u, i, s in zip(td.like_u, td.like_i, td.like_sign)])


# -- (1) the sharded reads ------------------------------------------------------

@pytest.mark.parametrize("n_procs", [2, 3])
@pytest.mark.parametrize("app", list(APPS))
def test_sharded_reads_are_the_references(stores, app, n_procs):
    """``read_training`` of every process bitwise the reference's; the
    shards' rows partition the one-process read's rows, every process
    holds the job-wide counts and the global vocabularies of one process's
    read (e-commerce: its global buy counts too)."""
    _, jpkg, tpkg = APPS[app]
    want = Lockstep(n_procs).run(lambda ctx: _ds(jpkg, app).read_training(ctx))
    got = Lockstep(n_procs).run(lambda ctx: _ds(tpkg, app).read_training(ctx))
    whole = _ds(tpkg, app).read_training(CPU)
    for p, (g, w) in enumerate(zip(got, want)):
        _same(g, w, f"process {p}")
        assert g.rows_are_local
        g.sanity_check()
    for field, count in ROWS[app]:
        sizes = [len(getattr(g, field)) for g in got]
        assert {getattr(g, count) for g in got} == {sum(sizes)}
        assert sum(sizes) == len(getattr(whole, field))
    assert sorted(r for g in got for r in _rows(app, g)) == _rows(app, whole)
    for name in ("users", "items"):
        if hasattr(whole, name):
            assert all(list(getattr(g, name).items())
                       == list(getattr(whole, name).items()) for g in got), name
    if app == "ec":
        for g in got:
            _bitwise(g.buy_counts, whole.buy_counts, "buy counts")


# -- (2) co-occurrence and naive Bayes over the shards ------------------------------

@pytest.mark.parametrize("n_procs", [2, 3])
def test_sharded_cooccurrence_is_the_references(stores, n_procs):
    """Each process counts its user shard's co-views and the processes'
    matrices are summed: every process's top lists bitwise the reference's
    and the one-process fit's."""
    def fit(pkg):
        def run(ctx):
            td = _ds(pkg, "sp").read_training(ctx)
            return pkg.CooccurrenceAlgorithm(
                pkg.CooccurrenceAlgorithmParams(n=6)).train(ctx, td)
        return run

    want = Lockstep(n_procs).run(fit(jsp))
    got = Lockstep(n_procs).run(fit(tsp))
    one = fit(tsp)(CPU)
    assert one.top_cooccurrences
    for g, w in zip(got, want):
        assert g.top_cooccurrences == w.top_cooccurrences == one.top_cooccurrences
        assert list(g.item_map.items()) == list(w.item_map.items())


def test_sharded_cooccurrence_rounds_each_process_counts():
    """The counts are rounded to bf16 in each process before the sum, as
    the reference does: 300 co-views in one shard and 1 in the other sum to
    301, where one process's count of all 301 rounds to 300."""
    users = BiMap.string_int([f"u{k}" for k in range(301)])
    items = BiMap.string_int(["a", "b", "c"])
    shards = [np.arange(300), np.asarray([300])]

    def data(u, local):
        vu = np.repeat(u, 2).astype(np.int32)
        vi = np.tile(np.asarray([0, 1], np.int32), len(u))
        return tsp.TrainingData(users, items, {}, vu, vi, vu[:0], vi[:0],
                                np.zeros(0, np.float32), rows_are_local=local)

    algo = tsp.CooccurrenceAlgorithm(tsp.CooccurrenceAlgorithmParams(n=2))
    got = Lockstep(2).run(lambda ctx: algo.train(ctx, data(shards[ctx.process_index], True)))
    one = algo.train(CPU, data(np.arange(301), False))
    assert [m.top_cooccurrences[0] for m in got] == [[(1, 301)]] * 2
    assert one.top_cooccurrences[0] == [(1, 300)]


@pytest.mark.parametrize("n_procs", [2, 3])
def test_sharded_naive_bayes_is_the_references(stores, n_procs):
    """``_train_sharded``: the classes, means, variances and priors of
    every process bitwise the reference's; within NB_RTOL of the port's
    one-process fit."""
    def fit(pkg):
        def run(ctx):
            td = _ds(pkg, "cls").read_training(ctx)
            return pkg.NaiveBayesAlgorithm(pkg.NaiveBayesAlgorithmParams()).train(ctx, td)
        return run

    want = Lockstep(n_procs).run(fit(jcl))
    got = Lockstep(n_procs).run(fit(tcl))
    one = fit(tcl)(CPU)
    for g, w in zip(got, want):
        _bitwise(g.classes, w.classes, "classes")
        for name in ("means", "variances", "log_priors"):
            _bitwise(getattr(g, name), getattr(w, name), name)
            np.testing.assert_allclose(getattr(g, name), getattr(one, name),
                                       rtol=NB_RTOL, atol=0, err_msg=name)
    _bitwise(got[0].classes, one.classes, "classes")


# -- (3) the MLP over the shards ----------------------------------------------------

class _Staged(Exception):
    """Stops a fit once its staging is recorded."""


def _capture_staging(monkeypatch, module, store):
    """Record every process's call of ``module.stage_sharded_batches`` (its
    arrays, batch, seed and global count, and what the real function
    stages), then stop the fit."""
    real = module.stage_sharded_batches

    def staged(ctx, arrays, batch_size, seed, n_global=None):
        arrays = [np.array(a) for a in arrays]
        store[ctx.process_index] = (arrays, batch_size, seed, n_global,
                                    real(ctx, arrays, batch_size, seed, n_global))
        raise _Staged

    monkeypatch.setattr(module, "stage_sharded_batches", staged)


def _mlp_shards(n_procs, n=301, seed=4):
    x, y = cls_case._data(n, seed=seed)
    cuts = np.linspace(0, n, n_procs + 1).astype(int)
    cuts[1] += 17  # uneven shards: the smaller ones resample padding rows
    return [(x[a:b], y[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]


def _staged_sharded(monkeypatch, pkg, module, shards, cfg):
    store = {}
    _capture_staging(monkeypatch, module, store)

    def run(ctx):
        xs, ys = shards[ctx.process_index]
        with pytest.raises(_Staged):
            pkg.MLPClassifier(pkg.MLPConfig(**cfg)).fit(ctx, xs, ys,
                                                        rows_are_local=True)

    Lockstep(len(shards)).run(run)
    return [store[p] for p in range(len(shards))]


@pytest.mark.parametrize("n_procs", [2, 3])
def test_mlp_sharded_moments_and_staging_are_the_references(monkeypatch, n_procs):
    """Each process's normalized rows (the global moments from the shards'
    (n, Σx, Σx²)), its class indices (the union of the shards' labels), the
    global count, and the staged batches and weights, bitwise the
    reference's."""
    shards = _mlp_shards(n_procs)
    cfg = dict(hidden_dims=(8,), batch_size=30, epochs=1, seed=3)
    want = _staged_sharded(monkeypatch, jmlp, jstaging, shards, cfg)
    got = _staged_sharded(monkeypatch, tmlp, tstaging, shards, cfg)
    n = sum(len(x) for x, _ in shards)
    for p, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g[0], w[0]):
            _bitwise(a, b, f"process {p}: normalized rows and labels")
        assert g[1:4] == w[1:4] == (cfg["batch_size"], cfg["seed"], n)
        (gx, gy), gw, gn = g[4]
        (wx, wy), ww, wn = w[4]
        _bitwise(gx.numpy(), wx, "xb")
        _bitwise(gy.numpy(), wy, "yb")
        _bitwise(gw.numpy(), ww, "wb")
        assert gn == wn == n
    # the normalization is the global one: every shard's rows together
    xn = np.concatenate([g[0][0] for g in got])
    np.testing.assert_allclose(xn.mean(0), 0.0, atol=1e-5)
    np.testing.assert_allclose(xn.std(0), 1.0, rtol=1e-4)


def test_mlp_replicated_staging_slices_the_global_batches():
    """Replicated rows under several processes (``launch -n 2 eval``):
    each process stages the global batches and keeps its slice of each on
    the data axis; the slices side by side are the global batches."""
    x, y = _mlp_shards(1, n=70)[0]
    xn = ((x - x.mean(0)) / (x.std(0) + 1e-8)).astype(np.float32)
    got = Lockstep(2).run(lambda ctx: tmlp.stage_batches(xn, y.astype(np.int64), 32,
                                                         ctx, ctx.device))
    n_batches, batch = 3, 32  # 70 rows padded to 96
    want = [np.concatenate([xn, np.zeros((26, 3), np.float32)]),
            np.concatenate([y.astype(np.int64), np.zeros(26, np.int64)]),
            np.concatenate([np.ones(70, np.float32), np.zeros(26, np.float32)])]
    for k, w in enumerate(want):
        whole = torch.cat([g[k] for g in got], 1).numpy()
        _bitwise(whole, w.reshape(n_batches, batch, *w.shape[1:]), f"array {k}")
        assert got[0][k].shape[1] == batch // 2


def test_mlp_replicated_rows_fit_is_the_loop_on_its_slices(monkeypatch):
    """``rows_are_local=False`` under several processes: with mirrored peers
    (each holds process 0's slice of every global batch) the fit is the
    single-process loop over global batches of that slice twice, from the
    same initial parameters."""
    x, y = _mlp_shards(1, n=90)[0]
    cfg = dict(hidden_dims=(16,), learning_rate=1e-2, batch_size=32, epochs=3, seed=0)
    init = convert.mlp_params_from_jax(cls_case._jax_params([3, 16, 3], seed=0))
    monkeypatch.setattr(tmlp, "init_params", lambda gen, dims, device: [
        {k: torch.from_numpy(v).to(device) for k, v in layer.items()} for layer in init])
    got = tmlp.MLPClassifier(tmlp.MLPConfig(**cfg)).fit(mirror(), x, y)
    classes, y_idx = np.unique(y, return_inverse=True)
    xn = ((x - x.mean(0)) / (x.std(0) + 1e-8)).astype(np.float32)
    xb, yb, wb = tmlp.stage_batches(xn, y_idx, cfg["batch_size"], mirror(), "cpu")
    twice = [torch.cat([a, a], 1) for a in (xb, yb, wb)]
    net = tmlp.MLPNet([{k: torch.from_numpy(v) for k, v in layer.items()}
                       for layer in init])
    loss = tmlp.train_epochs(net, *twice, cfg["learning_rate"], cfg["epochs"])
    np.testing.assert_allclose(got.final_loss, float(loss), rtol=1e-5)
    assert got.classes == classes.tolist()
    band = 2 * cfg["learning_rate"] * cfg["epochs"] * xb.shape[0]
    for a, b in zip(got.params, net.host_params()):
        for k in ("w", "b"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=band)


MLP_CHILD = textwrap.dedent("""
    import json
    import logging
    import sys

    import numpy as np
    import torch

    from incubator_predictionio_tpu_torch.models import mlp as tmlp
    from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext

    logging.basicConfig(level=logging.INFO)
    work = sys.argv[1]
    data = np.load(f"{work}/inputs.npz")
    cfg = tmlp.MLPConfig(**json.loads(open(f"{work}/cfg.json").read()))
    init = [{"w": data[f"w{i}"], "b": data[f"b{i}"]}
            for i in range(len(cfg.hidden_dims) + 1)]
    tmlp.init_params = lambda gen, dims, device: [
        {k: torch.from_numpy(v).to(device) for k, v in layer.items()}
        for layer in init]
    ctx = DeviceContext.create("cpu", distributed=True)
    p = ctx.process_index
    model = tmlp.MLPClassifier(cfg).fit(ctx, data[f"x{p}"], data[f"y{p}"],
                                        rows_are_local=True)
    out = {f"{k}{i}": v for i, layer in enumerate(model.params)
           for k, v in layer.items()}
    np.savez(f"{work}/out{p}.npz", **out, mean=model.mean, std=model.std,
             classes=np.asarray(model.classes), final=model.final_loss)
    ctx.stop()
""")


def test_two_process_mlp_fit_matches_jax_on_the_global_batches(monkeypatch, tmp_path):
    """Shards of 167 and 134 rows at batch 64 (32 a process, 6 batches, the
    smaller shard resampling padding rows): the launched replicas bitwise,
    the final loss and the held-out labels in the fit-parity bands of the
    JAX training step on the concatenated global batches."""
    shards = _mlp_shards(2)
    cfg = dict(hidden_dims=(16, 16), learning_rate=1e-2, batch_size=64,
               epochs=10, seed=0)
    staged = _staged_sharded(monkeypatch, jmlp, jstaging, shards, cfg)
    xb, yb = (np.concatenate([s[4][0][k] for s in staged], 1) for k in range(2))
    wb = np.concatenate([s[4][1] for s in staged], 1)
    assert xb.shape[:2] == (6, 64)
    jinit = cls_case._jax_params([3, 16, 16, 3], seed=0)
    params = jax.tree.map(jnp.asarray, jinit)
    opt = jit_adam_init(cfg["learning_rate"])(params)
    epoch = jmlp._train_epoch_fn(cfg["learning_rate"])
    for _ in range(cfg["epochs"]):
        params, opt, jloss = epoch(params, opt, jnp.asarray(xb), jnp.asarray(yb),
                                   jnp.asarray(wb))

    work = tmp_path / "fit"
    work.mkdir()
    init = convert.mlp_params_from_jax(jinit)
    np.savez(work / "inputs.npz", x0=shards[0][0], y0=shards[0][1],
             x1=shards[1][0], y1=shards[1][1],
             **{f"{k}{i}": v for i, layer in enumerate(init) for k, v in layer.items()})
    (work / "cfg.json").write_text(json.dumps(cfg))
    script = tmp_path / "mlp_child.py"
    script.write_text(MLP_CHILD)
    res = launcher.launch_local(
        [], 2, coordinator_port=launcher.free_port(), timeout=LAUNCH_TIMEOUT,
        env={"PYTHONPATH": REPO}, command=[sys.executable, str(script), str(work)])
    assert res.ok, res.outputs
    assert all("replica digest" in o and "backend gloo" in o for o in res.outputs)
    outs = [np.load(work / f"out{p}.npz") for p in range(2)]
    for name in outs[0].files:  # the replicas
        _bitwise(outs[0][name], outs[1][name], name)
    got = outs[0]
    assert abs(float(got["final"]) - float(jloss)) <= FIT_LOSS_RTOL * abs(float(jloss)), (
        float(got["final"]), float(jloss))
    x, y = cls_case._data(400, seed=11)
    classes = got["classes"].tolist()
    tm = tmlp.MLPModel([{"w": got[f"w{i}"], "b": got[f"b{i}"]} for i in range(3)],
                       got["mean"], got["std"], classes, tmlp.MLPConfig(**cfg))
    tm.prepare_for_serving(CPU)
    jm = jmlp.MLPModel(jax.tree.map(np.asarray, params), got["mean"], got["std"],
                       classes, jmlp.MLPConfig(**cfg))
    labels = tmlp.MLPClassifier.predict(tm, x)
    assert np.mean(labels == jmlp.MLPClassifier.predict(jm, x)) >= 0.99
    assert np.mean(labels == y) > 0.9


# -- (4) the CLI: launch -n 2 train and eval on a sqlite app ------------------------

def _cli_app(tmp_path, app):
    """One app's events in a sqlite file, and the environment that names
    it for the launched processes."""
    path = str(tmp_path / "pio.db")
    config = {"PIO_STORAGE_SOURCES_SQLITE_TYPE": "sqlite",
              "PIO_STORAGE_SOURCES_SQLITE_PATH": path}
    storage = treg.Storage(config)
    app_id = storage.get_meta_data_apps().insert(tbase.App(0, app))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch(
        [tevent.Event.from_json_dict(d) for d in APPS[app][0]()], app_id)
    storage.close()
    env = dict(os.environ)
    env.update(config)
    env.update({"PIO_FS_BASEDIR": str(tmp_path / "fs"), "PYTHONPATH": REPO})
    return env, config


def _launch(env, cwd, *argv):
    out = subprocess.run(
        [sys.executable, "-m", "incubator_predictionio_tpu_torch.tools.cli",
         "launch", "-n", "2", "--cpu-devices-per-process", "1",
         "--coordinator-port", str(launcher.free_port()),
         "--timeout", str(LAUNCH_TIMEOUT), *argv],
        capture_output=True, text=True, env=env, cwd=cwd,
        timeout=LAUNCH_TIMEOUT + 30)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_cli_launch_two_process_train_of_similar_product(tmp_path):
    """``launch -n 2 train`` of the similar-product template with the
    implicit MF and the co-occurrence algorithms: each process reads a
    proper subset of the views, the MF fit's replicas agree, the
    co-occurrence counts are summed, only process 0 writes the instance,
    and the stored co-occurrence model is the one-process fit's."""
    env, config = _cli_app(tmp_path, "sp")
    variant = tmp_path / "engine.json"
    variant.write_text(json.dumps({
        "id": "sp-launch", "version": "1",
        "engineFactory": "incubator_predictionio_tpu_torch.templates."
                         "similarproduct.SimilarProductEngine",
        "datasource": {"params": {"appName": "sp"}},
        "algorithms": [{"name": "als", "params": {"rank": 8, "numIterations": 3}},
                       {"name": "cooccurrence", "params": {"n": 6}}]}))
    out = _launch(env, tmp_path, "train", "-v", str(variant))
    assert "Training completed. Engine instance ID" in out
    assert "secondary process" in out and "backend gloo, device cpu" in out
    reads = re.findall(r"sharded read: (\d+) of (\d+) rows \(shard (\d+)/2\)", out)
    assert sorted(s for _, _, s in reads) == ["0", "1"], out
    total = {int(t) for _, t, _ in reads}
    assert len(total) == 1 and sum(int(n) for n, _, _ in reads) == total.pop()
    assert all(int(n) > 0 for n, _, _ in reads)
    digests = re.findall(r"replica digest (\w+), equal", out)
    assert len(digests) == 2 and digests[0] == digests[1]
    assert out.count("co-occurrence: the processes'") == 2
    storage = treg.Storage(config)
    try:
        insts = storage.get_meta_data_engine_instances().get_all()
        assert [i.status for i in insts] == ["COMPLETED"]
        deployed = load_deployed_engine(ServerConfig(engine_variant=str(variant)),
                                        storage, ctx=CPU, warmup=False)
        prev = treg.use_storage(storage)
        try:
            td = _ds(tsp, "sp").read_training(CPU)
        finally:
            treg.use_storage(prev)
        one = tsp.CooccurrenceAlgorithm(tsp.CooccurrenceAlgorithmParams(n=6)).train(CPU, td)
        assert deployed.models[1].top_cooccurrences == one.top_cooccurrences
        assert len(deployed.models[0].item_map) == len(td.items)
        res = deployed.predict({"items": ["i0"], "num": 4})
        assert 0 < len(res.item_scores) <= 4
        assert all(s.item != "i0" for s in res.item_scores)
    finally:
        storage.close()


EVAL_MODULE = textwrap.dedent("""
    from incubator_predictionio_tpu_torch.core import EngineParams
    from incubator_predictionio_tpu_torch.templates import classification as tcl


    class ClsEval(tcl.AccuracyEvaluation):
        def __init__(self):
            super().__init__(app_name="cls", eval_k=2)
            self.engine_params_list = [EngineParams.create(
                data_source=tcl.DataSourceParams(app_name="cls", eval_k=2),
                algorithms=[("mlp", tcl.MLPAlgorithmParams(
                    hidden_dims=(8,), learning_rate=lr, batch_size=32,
                    epochs=4))])
                for lr in (1e-2, 3e-2)]
""")


def test_cli_launch_two_process_eval_of_classification(tmp_path):
    """``launch -n 2 eval`` of the classification template: every process
    reads every row (``read_eval`` is not sharded) and trains its slice of
    each global batch, the replicas agree in every fit, both processes
    compute the same results, and only process 0 writes the one
    EVALCOMPLETED row."""
    env, config = _cli_app(tmp_path, "cls")
    (tmp_path / "evalmod.py").write_text(EVAL_MODULE)
    out = _launch(env, tmp_path, "eval", "evalmod:ClsEval")
    assert out.count("Evaluation completed. Instance ID") == 1
    assert "Evaluation completed (secondary process" in out
    # each process's log in turn: 2 variants × 2 folds, the same replicas
    digests = re.findall(r"replica digest (\w+), equal", out)
    assert len(digests) == 2 * 2 * 2 and digests[:4] == digests[4:]
    finished = [line.split("evaluation finished: ", 1)[1]
                for line in out.splitlines() if "evaluation finished: " in line]
    assert len(finished) == 2 and finished[0] == finished[1]
    storage = treg.Storage(config)
    try:
        rows = storage.get_meta_data_evaluation_instances().get_all()
        assert [r.status for r in rows] == ["EVALCOMPLETED"]
        scores = [r["score"] for r in json.loads(rows[0].evaluator_results_json)["results"]]
        assert len(scores) == 2 and all(0.0 <= s <= 1.0 for s in scores)
        assert rows[0].evaluator_results in out
    finally:
        storage.close()
