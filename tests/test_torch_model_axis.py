"""PyTorch port, the ``model`` mesh axis on the CPU: named axes on
``parallel/mesh.py:DeviceContext`` (counterparts of tests/test_mesh.py),
``sharding/table.py:ShardedTable.init_train`` (tests/test_sharding.py),
the model-axis fit of ``models/two_tower.py`` over real gloo processes,
its checkpoints (the plain path and member slices) and ``launch -n 2
train --mesh-axes`` through the CLI, then deploy and query.

Processes run through ``parallel/launcher.py:launch_local``, each launch
with its own deadline; every launch is 2 processes but one 4-process
``{"data": 2, "model": 2}`` case. A child writes its tables to an npz,
which the test reads.

Tolerances, with their reasons:
- the mesh, the layout, the init and the model-axis fit against the
  one-process fit on the same global batches from the same initial
  tables: bitwise (the same ops on the same rows in the same order; a
  row gathered over the model axis is its owner's, ``x + -0.0 == x``).
- the model-axis fit against the JAX fit on its 8-device CPU mesh
  ``{"data": 4, "model": 2}`` from the JAX package's initial tables:
  tests/test_torch_two_tower_training.py's 3-epoch bands (the last
  epoch's loss 1e-4 relative, each table 1e-2 relative Frobenius).
"""

import glob
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from incubator_predictionio_tpu.models import two_tower as jtt  # noqa: E402
from incubator_predictionio_tpu.parallel.mesh import MeshConf as JMeshConf  # noqa: E402
from incubator_predictionio_tpu.parallel.mesh import MeshContext  # noqa: E402
from incubator_predictionio_tpu.sharding import table as jtable  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402
from incubator_predictionio_tpu_torch.models import two_tower as ttt  # noqa: E402
from incubator_predictionio_tpu_torch.parallel import launcher  # noqa: E402
from incubator_predictionio_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.mesh import (  # noqa: E402
    DeviceContext,
    MeshConf,
)
from incubator_predictionio_tpu_torch.server.query_server import (  # noqa: E402
    ServerConfig,
    load_deployed_engine,
)
from incubator_predictionio_tpu_torch.sharding import table as ttable  # noqa: E402
from incubator_predictionio_tpu_torch.tools import cli  # noqa: E402
from incubator_predictionio_tpu_torch.utils import checkpoint as tckpt  # noqa: E402

from tests.test_torch_distributed_train import _seed_app  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = DeviceContext.create(device="cpu")
LAUNCH_TIMEOUT = 120.0
LOSS_RTOL, TABLE_RTOL = 1e-4, 1e-2
N, N_USERS, N_ITEMS, RANK = 900, 61, 41, 8  # odd counts: padded blocks
CFG = dict(rank=RANK, batch_size=128, epochs=3, seed=5, gather="host")


def cpu_ctx(rank, world, axes):
    """Process ``rank`` of a ``world``-process job over ``axes``, without a
    group: what needs no collective (coordinates, layouts, validations)."""
    return DeviceContext(torch.device("cpu"), rank, world, axes=axes)


# -- the mesh (reference tests/test_mesh.py:11-62) ---------------------------

def test_default_mesh_is_one_data_axis():
    assert CPU.shape == {"data": 1} and CPU.data_axis == "data"
    ctx = cpu_ctx(0, 8, None)
    assert ctx.shape == {"data": 8} and ctx.axis_names == ("data",)
    assert ctx.data_size == 8 and ctx.axis_size_or("model") == 1
    assert ctx.pad_to_batch_multiple(3) == 8
    assert ctx.pad_to_batch_multiple(8) == 8


def test_axes_inference_is_the_references():
    ctx = cpu_ctx(0, 8, {"data": -1, "model": 2})
    want = MeshContext.create(axes={"data": -1, "model": 2})
    assert ctx.shape == dict(want.mesh.shape) == {"data": 4, "model": 2}
    assert ctx.axis_size("data") == want.axis_size("data") == 4
    assert ctx.axis_size_or("seq", 7) == want.axis_size_or("seq", 7) == 7
    # the batch pads to the data axis, not to the process count
    assert ctx.pad_to_batch_multiple(3) == want.pad_to_batch_multiple(3) == 4


@pytest.mark.parametrize("axes", [{"data": 3}, {"data": -1, "model": -1},
                                  {"data": -1, "model": 3},
                                  {"data": 2, "model": 2}])
def test_bad_axes_raise_the_references_texts(axes):
    with pytest.raises(ValueError) as want:
        MeshContext.create(axes=axes)
    with pytest.raises(ValueError) as got:
        cpu_ctx(0, 8, axes)
    assert str(got.value) == str(want.value)


def test_process_coordinates_are_the_reference_device_placement():
    """Process p sits where the reference's mesh puts device p:
    ``np.array(devs).reshape(sizes)``, row-major."""
    axes = {"data": 2, "model": 2, "seq": 2}
    jm = MeshContext.create(axes=axes).mesh
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for p in range(8):
        coords = cpu_ctx(p, 8, axes)
        at = tuple(coords.axis_index(n) for n in jm.axis_names)
        assert ids[at] == p
        assert coords.data_index == at[0]
    # the subgroup lines: every process of a line differs in that axis only
    resolved = tmesh.resolve_axes(axes, 8)
    assert tmesh.axis_lines(resolved, "model") == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert tmesh.axis_lines(resolved, "data") == [[0, 4], [1, 5], [2, 6], [3, 7]]


def test_conf_roundtrip():
    conf = MeshConf(axes={"data": 4, "model": 2})
    back = MeshConf.from_dict(conf.to_dict())
    assert back == conf
    assert conf.to_dict() == JMeshConf(axes={"data": 4, "model": 2}).to_dict()
    want = MeshContext.from_conf(conf.to_dict())
    assert cpu_ctx(0, 8, back.axes).shape == dict(want.mesh.shape)
    # a one-process context refuses axes that need more processes
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        DeviceContext.from_conf({"axes": {"model": 2}}, device="cpu")
    assert DeviceContext.from_conf(None, device="cpu").shape == {"data": 1}


def test_collectives_without_a_group_raise():
    ctx = cpu_ctx(0, 2, {"model": 2})
    with pytest.raises(RuntimeError, match="no process group"):
        ctx.all_reduce_sum(torch.ones(2), axis="model")
    # a one-process data line needs no group
    assert ctx.allgather_obj("x", axis="data") == ["x"]
    assert ctx.all_gather(torch.ones(2), axis="data").shape == (1, 2)


# -- ShardedTable.init_train (reference tests/test_sharding.py:126-160) -----

def test_init_train_builds_only_the_owned_block():
    scale = 0.25
    blocks = []
    for s in range(4):
        gen = torch.Generator().manual_seed(7)
        t = ttable.ShardedTable.init_train(
            cpu_ctx(s, 4, {"model": 4}), "ue", 101, RANK, gen, scale)
        assert t.spec.n_shards == 4 and t.axis == "model" and t.shard == s
        assert t.array.shape == (26, RANK + 1)  # 101 rows padded to 104
        assert torch.all(t.array[:, RANK] == 0)  # bias column zero
        assert ttable.array_model_shards(t) == 4
        # a block depends only on (seed, table, shard): a replay rebuilds it
        again = ttable.init_block(t.spec, s, RANK, 7, scale, "cpu")
        assert torch.equal(t.array, again)
        blocks.append(t.array)
    whole = torch.cat(blocks)
    assert len(torch.unique(whole[:, 0])) == 104  # every block its own draw
    assert 0.2 < float(whole[:, :RANK].std()) < 0.3
    other = ttable.init_block(ttable.ShardSpec("ie", 101, RANK + 1, 4), 0,
                              RANK, 7, scale, "cpu")
    assert not torch.equal(other, blocks[0])  # the table's name folds in
    assert ttable.fold_in(7, "ue", 0) == ttable.fold_in(7, "ue", 0) < 1 << 63
    assert ttable.fold_in(7, "ue", 0) != ttable.fold_in(7, "ue", 1)


def test_one_shard_init_is_todays_draw_bitwise():
    cfg = ttt.TwoTowerConfig(rank=RANK, seed=3)
    want = ttt._init_tables(cfg, N_USERS, N_ITEMS, "cpu",
                            torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    got = [ttable.ShardedTable.init_train(CPU, name, n, RANK, gen,
                                          float(1 / np.sqrt(RANK)))
           for name, n in (("ue", N_USERS), ("ie", N_ITEMS))]
    for t, w in zip(got, want):
        assert t.spec.n_shards == 1 and t.axis is None
        assert torch.equal(t.array, w)
    assert ttable.array_model_shards(got[0]) == 1
    assert ttable.array_model_shards(torch.zeros(4, 3)) == 1
    assert ttable.array_model_shards([torch.zeros(2, 3)] * 3) == 3


def test_init_train_enforces_the_budget_per_shard(monkeypatch):
    monkeypatch.setenv("PIO_SHARD_HBM_BUDGET", "64KB")
    gen = torch.Generator().manual_seed(0)
    # 2000/4 rows × 17 × 12 B ≈ 102 KB a shard > 64 KB, as the reference's
    with pytest.raises(ttable.HBMBudgetExceeded):
        ttable.ShardedTable.init_train(cpu_ctx(0, 4, {"model": 4}), "ue",
                                       2000, 16, gen, 0.25)
    with pytest.raises(jtable.HBMBudgetExceeded):
        jtable.check_budget(jtable.ShardSpec("ue", 2000, 17, 4))
    ttable.ShardedTable.init_train(cpu_ctx(0, 4, {"model": 4}), "ue", 500,
                                   16, gen, 0.25)  # fits
    with pytest.raises(ttable.HBMBudgetExceeded, match="model.*mesh axis"):
        ttable.ShardedTable.init_train(CPU, "ue", 2000, 16, gen, 0.25)


# -- the model-axis fit over real processes ---------------------------------

CHILD = textwrap.dedent('''
    import json, logging, os, sys
    import numpy as np, torch
    from incubator_predictionio_tpu_torch.distributed.context import (
        maybe_wrap_distributed)
    from incubator_predictionio_tpu_torch.models import two_tower as tt
    from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext
    from incubator_predictionio_tpu_torch.sharding.table import ShardedTable
    logging.basicConfig(level=logging.INFO)
    axes, data, out, cfg = (json.loads(sys.argv[1]), sys.argv[2],
                            sys.argv[3], json.loads(sys.argv[4]))
    d = np.load(data)
    ctx = DeviceContext.create("cpu", distributed=True, axes=axes)
    if "init_ue" in d.files:  # blocks of injected whole tables
        real = tt._init_blocks
        def inject(cfg_, ctx_, nu, ni, gen):
            placed = real(cfg_, ctx_, nu, ni, gen)
            for t, key in zip(placed, ("init_ue", "init_ie")):
                lo = t.shard * t.spec.rows_per_shard
                t.array.copy_(torch.from_numpy(
                    d[key][lo:lo + t.spec.rows_per_shard]))
            return placed
        tt._init_blocks = inject
    ctx = maybe_wrap_distributed(ctx)
    mf = tt.TwoTowerMF(tt.TwoTowerConfig(**cfg)).fit(
        ctx, d["u"], d["i"], d["r"], int(d["nu"]), int(d["ni"]))
    if ctx.is_primary:
        np.savez(out, ue=mf.user_emb, ie=mf.item_emb, ub=mf.user_bias,
                 ib=mf.item_bias, loss=mf.final_loss)
    print("timings", json.dumps(mf.timings))
    ctx.stop()
''')


def _triples(seed=3):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, N_USERS, N).astype(np.int32)
    items = rng.integers(0, N_ITEMS, N).astype(np.int32)
    ratings = (1.0 + 4.0 * rng.random(N)).astype(np.float32)
    return users, items, ratings


def _launch_fit(tmp_path, axes, cfg, init=None, env=None, tag="fit"):
    """The model-axis fit in ``prod(axes)`` gloo processes on the same
    triples; returns the primary's tables and every process's log."""
    users, items, ratings = _triples()
    data = tmp_path / f"{tag}-data.npz"
    extra = {} if init is None else {"init_ue": init[0], "init_ie": init[1]}
    np.savez(data, u=users, i=items, r=ratings, nu=N_USERS, ni=N_ITEMS,
             **extra)
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    out = tmp_path / f"{tag}-out.npz"
    res = launcher.launch_local(
        [], int(np.prod(list(axes.values()))),
        env={"PYTHONPATH": REPO, **(env or {})}, timeout=LAUNCH_TIMEOUT,
        command=[sys.executable, str(script), json.dumps(axes), str(data),
                 str(out), json.dumps(cfg)])
    assert res.ok, "\n".join(o[-3000:] for o in res.outputs)
    return dict(np.load(out)), res.outputs


def _blocks_of(cfg, n_shards):
    """The whole padded tables the launched processes' blocks make."""
    scale = float(1 / np.sqrt(cfg["rank"]))
    return [torch.cat([ttable.init_block(
        ttable.ShardSpec(name, n, cfg["rank"] + 1, n_shards), s, cfg["rank"],
        cfg["seed"], scale, "cpu") for s in range(n_shards)])
        for name, n in (("ue", N_USERS), ("ie", N_ITEMS))]


def _one_process(monkeypatch, cfg, init):
    """The one-process fit on the same triples from ``init``."""
    real = ttt._init_blocks

    def inject(cfg_, ctx, nu, ni, gen):  # one block each: the whole table
        placed = real(cfg_, ctx, nu, ni, gen)
        for t, a in zip(placed, init):
            t.array = a.clone()
        return placed

    monkeypatch.setattr(ttt, "_init_blocks", inject)
    users, items, ratings = _triples()
    return ttt.TwoTowerMF(ttt.TwoTowerConfig(**cfg)).fit(
        CPU, users, items, ratings, N_USERS, N_ITEMS)


def _assert_bitwise(got, want):
    for key, name in (("ue", "user_emb"), ("ie", "item_emb"),
                      ("ub", "user_bias"), ("ib", "item_bias")):
        a, b = got[key], getattr(want, name)
        assert a.shape == b.shape and a.dtype == b.dtype, key
        assert np.array_equal(a, b), (key, float(np.abs(a - b).max()))


@pytest.mark.parametrize("axes", [{"model": 2}, {"data": 2, "model": 2}],
                         ids=["model2", "data2-model2"])
def test_model_axis_fit_is_the_one_process_fit_bitwise(tmp_path, monkeypatch,
                                                       axes):
    got, logs = _launch_fit(tmp_path, axes, CFG)
    want = _one_process(monkeypatch, CFG, _blocks_of(CFG, 2))
    _assert_bitwise(got, want)
    np.testing.assert_allclose(float(got["loss"]), want.final_loss,
                               rtol=LOSS_RTOL)
    # each process holds half of each padded table (62 and 42 rows)
    lines = [line for o in logs for line in o.splitlines()
             if "model-axis fit: process" in line]
    assert len(lines) == len(logs)
    for p, line in enumerate(lines):
        s = p % 2
        assert f"ue rows [{31 * s}, {31 * (s + 1)}) of 62" in line, line
        assert f"ie rows [{21 * s}, {21 * (s + 1)}) of 42" in line, line
    timings = json.loads(logs[0].split("timings ")[-1].splitlines()[0])
    assert timings["exchange_sec"] == pytest.approx(
        timings["exchange_rows_sec"] + timings["exchange_grads_sec"], abs=2e-4)


def test_model_axis_fit_matches_jax_on_its_model_mesh(tmp_path, monkeypatch):
    """The JAX fit on its 8-device CPU mesh ``{"data": 4, "model": 2}``
    (tests/test_checkpoint.py's mesh), from the tables its
    ``ShardedTable.init_train`` renders; the port's ``{"model": 2}`` fit
    from the same tables (both pad the tables to a multiple of 2, and a
    global batch that is a multiple of 4 stages alike)."""
    users, items, ratings = _triples()
    seen = {}
    real = jtt._train_epochs

    def capture(p, o, *a):
        seen.setdefault("init", [np.array(p[k]) for k in ("ue", "ie")])
        return real(p, o, *a)

    monkeypatch.setattr(jtt, "_train_epochs", capture)
    want = jtt.TwoTowerMF(jtt.TwoTowerConfig(**CFG)).fit(
        MeshContext.create(axes={"data": 4, "model": 2}), users, items,
        ratings, N_USERS, N_ITEMS)
    assert [a.shape for a in seen["init"]] == [(62, RANK + 1), (42, RANK + 1)]
    got, _ = _launch_fit(tmp_path, {"model": 2}, CFG, init=seen["init"])
    np.testing.assert_allclose(float(got["loss"]), want.final_loss,
                               rtol=LOSS_RTOL)
    for key, name in (("ue", "user_emb"), ("ie", "item_emb"),
                      ("ub", "user_bias"), ("ib", "item_bias")):
        a, b = got[key], np.asarray(getattr(want, name))
        assert a.shape == b.shape
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel <= TABLE_RTOL, (name, rel)
    assert np.abs(got["ue"] - seen["init"][0][:N_USERS, :RANK]).max() > 3e-2


# -- checkpoints of model-axis tables ---------------------------------------

def _ckpt_cfg(directory, epochs):
    return dict(CFG, epochs=epochs, checkpoint_dir=str(directory),
                checkpoint_every=1)


def test_plain_checkpoints_hold_whole_leaves_and_resume_bitwise(tmp_path):
    """No supervisor: the primary writes whole leaves gathered from the
    blocks; a fit resumed from epoch 2 ends bitwise the uninterrupted one."""
    straight, _ = _launch_fit(tmp_path, {"model": 2},
                              _ckpt_cfg(tmp_path / "a", 4), tag="a")
    _launch_fit(tmp_path, {"model": 2}, _ckpt_cfg(tmp_path / "b", 2), tag="b1")
    with tckpt.TrainCheckpointer(str(tmp_path / "b")) as ck:
        assert ck.all_steps() == [1, 2]
        state = ck.restore(2)
    ue = state["params"][0]
    assert tuple(ue.shape) == (62, RANK + 1)  # the whole padded table
    assert tuple(state["opt"]["m"][1].shape) == (42, RANK + 1)
    resumed, logs = _launch_fit(tmp_path, {"model": 2},
                                _ckpt_cfg(tmp_path / "b", 4), tag="b2")
    assert all("resuming from epoch 2" in o for o in logs)
    _assert_bitwise(resumed, _as_model(straight))


def test_member_slices_are_disjoint_and_resume_bitwise(tmp_path):
    """Under a coordination directory (the supervisor's members): each
    member writes its own block of every table and moment, member 0 the
    whole leaves too; the committed step reassembles to the gathered
    tables; a resumed fit ends bitwise the uninterrupted one."""
    def dist_env(tag):
        return {"PIO_DIST_STATE_DIR": str(tmp_path / f"mesh-{tag}")}

    straight, _ = _launch_fit(tmp_path, {"model": 2},
                              _ckpt_cfg(tmp_path / "a", 4),
                              env=dist_env("a"), tag="a")
    step = tckpt.committed_steps(str(tmp_path / "a"))[-1]
    assert step == 4
    manifests = []
    for path in sorted(glob.glob(str(tmp_path / "a" / "slices" / "step-4"
                                     / "member-*.json"))):
        with open(path) as f:
            manifests.append(json.load(f))
    assert len(manifests) == 2
    rows = [{(e["leaf"], tuple(e["index"][0])) for e in m["entries"]
             if e["index"]} for m in manifests]
    assert rows[0] and rows[1] and not rows[0] & rows[1]
    # member 0: rows [0, 31) / [0, 21) of the tables and moments, and the
    # epoch and adam's count whole; member 1 the other halves
    assert {r for _, r in rows[0]} == {(0, 31), (0, 21)}
    assert {r for _, r in rows[1]} == {(31, 62), (21, 42)}
    assert all(e["index"] is None for e in manifests[0]["entries"]
               if e["leaf"] in (0, 1))
    leaves = tckpt.assemble_committed_step(str(tmp_path / "a"), 4)
    ue, ie = leaves[-2], leaves[-1]
    np.testing.assert_array_equal(ue[:N_USERS, :RANK], straight["ue"])
    np.testing.assert_array_equal(ie[:N_ITEMS, RANK], straight["ib"])
    _launch_fit(tmp_path, {"model": 2}, _ckpt_cfg(tmp_path / "b", 2),
                env=dist_env("b"), tag="b1")
    resumed, logs = _launch_fit(tmp_path, {"model": 2},
                                _ckpt_cfg(tmp_path / "b", 4),
                                env=dist_env("b"), tag="b2")
    assert all("resuming from epoch 2" in o for o in logs)
    _assert_bitwise(resumed, _as_model(straight))


def _as_model(tables):
    return ttt.TwoTowerModel(user_emb=tables["ue"], item_emb=tables["ie"],
                             user_bias=tables["ub"], item_bias=tables["ib"],
                             mean=0.0)


def test_row_blocks_cut_refuses_a_leaf_of_other_blocks():
    layout = tckpt.RowBlocks(cpu_ctx(1, 2, {"model": 2}))
    like = {"params": [torch.zeros(3, 2)], "epoch": tckpt.scalar(0)}
    whole = [np.asarray(5, np.int32), np.arange(12, dtype=np.float32)
             .reshape(6, 2)]
    placed = layout.cut(whole, like)
    assert placed["params"][0].tolist() == [[6, 7], [8, 9], [10, 11]]
    with pytest.raises(ValueError, match="does not hold 2 blocks"):
        layout.cut([whole[0], whole[1][:4]], like)


# -- the CLI: launch -n 2 train --mesh-axes, deploy, query ------------------

def test_cli_launch_model_axis_train_then_deploy(tmp_path):
    env, variant = _seed_app(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "incubator_predictionio_tpu_torch.tools.cli",
         "launch", "-n", "2", "--cpu-devices-per-process", "1",
         "--coordinator-port", str(launcher.free_port()),
         "--timeout", str(LAUNCH_TIMEOUT), "train", "-v", str(variant),
         "--mesh-axes", '{"model": 2}'],
        capture_output=True, text=True, env=env, timeout=LAUNCH_TIMEOUT + 30)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "Training completed. Engine instance ID" in out.stdout
    assert "mesh: {'model': 2} over 2 processes" in out.stdout
    # no data shards: both processes read every row
    assert "sharded read" not in out.stdout
    fits = [line for line in out.stdout.splitlines()
            if "model-axis fit: process" in line]
    assert len(fits) == 2
    assert "ue rows [0, 6) of 12" in fits[0] and "ue rows [6, 12) of 12" in fits[1]
    tables = {line.split("table digest ")[1].split(";")[0] for line in fits}
    assert len(tables) == 1
    storage = treg.Storage({"PIO_STORAGE_SOURCES_SQLITE_TYPE": "sqlite",
                            "PIO_STORAGE_SOURCES_SQLITE_PATH": str(tmp_path / "pio.db")})
    try:
        (inst,) = storage.get_meta_data_engine_instances().get_all()
        assert inst.status == "COMPLETED"
        assert inst.mesh_conf == {"axes": {"model": 2}, "distributed": True}
        deployed = load_deployed_engine(ServerConfig(engine_variant=str(variant)),
                                        storage, ctx=CPU, warmup=False)
        model = deployed.models[0]
        assert len(model.user_map) == 12 and len(model.item_map) == 9
        res = deployed.predict({"user": "3", "num": 4})
        assert len(res.item_scores) == 4
        assert all(np.isfinite(s.score) for s in res.item_scores)
    finally:
        storage.close()


@pytest.mark.parametrize("verb", [
    ["train", "-v", "engine.json"],
    ["eval", "some.Evaluation"],
    ["batchpredict", "--input", "q.json"]], ids=lambda v: v[0])
def test_every_workflow_verb_takes_mesh_axes(verb):
    """``--mesh-axes`` on train, eval and batchpredict, as the reference's
    (tools/cli.py:2983, :3009, :3169)."""
    args = cli.build_parser().parse_args(
        verb + ["--mesh-axes", '{"data": 2, "model": 2}'])
    assert cli._mesh_axes(args) == {"data": 2, "model": 2}
    assert cli._mesh_axes(cli.build_parser().parse_args(verb)) is None


def test_cli_mesh_axes_must_match_the_process_count(tmp_path, monkeypatch):
    env, variant = _seed_app(tmp_path)
    for key, value in env.items():
        if key.startswith("PIO_"):
            monkeypatch.setenv(key, value)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        cli.main(["train", "-v", str(variant), "--device", "cpu",
                  "--mesh-axes", '{"model": 2}'])
