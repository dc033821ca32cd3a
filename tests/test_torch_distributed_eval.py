"""PyTorch port, sharded evaluation and the sequential template across
processes on the CPU: the recommendation template's ``_read_eval_sharded``,
``parallel/staging.py:stage_sharded_batches``, the sequential template's
sharded ``_collect_sessions`` / ``_build_fold`` / ``read_eval``, the
transformer's data-parallel fit over a 2-process gloo group, and
``launch -n 2 eval`` of both templates — against the JAX package's
functions on the same inputs.

The sharded reads run every process of a job as a thread of this process
(:class:`Lockstep`): each thread's context exchanges ``allgather_obj``
objects with the others through a barrier, so the reference's and the
port's functions run unchanged, each package on its own sqlite store of
the same events. The fit runs real processes through
``parallel/launcher.py:launch_local``.

Tolerances, with their reasons:
- the sharded reads and the staging: bitwise (the same numpy and Python
  code on the same rows).
- the 2-process fit against the JAX package's training step run
  single-process, step by step, on the same global batches from the same
  initial parameters, and against the port's own single-process fit on
  those batches: the first epoch's steps within 1e-5 relative, as
  tests/test_torch_sequential_training.py holds the one-process fit
  (measured 2.7e-6 and 8.8e-6), every step of the 3 epochs within 1e-4.
  The cause of the wider band is adam's amplification of fp32 rounding,
  not the exchange: the port's single-process fit on the same batches
  drifts from the JAX steps by as much (5.6e-5 at step 6; layer norm and
  gelu differ by fp32 ulps and flip bf16 roundings downstream), and the
  2-process fit, whose global gradient is the sum of two local ones
  (another order of fp32 sums than one backward), from the port's
  single-process fit by 1.4e-5 at step 5. Every parameter within
  2·lr·steps (that file's band: it checks the tree and the layout, adam
  turns a small gradient difference near 0 into a full ±lr step).
- the replicas: bitwise (one all-reduce gives both processes the same
  gradient bytes; adam is then the same ops on the same inputs).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from incubator_predictionio_tpu.models import transformer as jtr  # noqa: E402
from incubator_predictionio_tpu.parallel import staging as jstaging  # noqa: E402
from incubator_predictionio_tpu.parallel.mesh import MeshContext  # noqa: E402
from incubator_predictionio_tpu.templates import recommendation as jrec  # noqa: E402
from incubator_predictionio_tpu.templates import sequential as jseq  # noqa: E402
from incubator_predictionio_tpu.utils.optim import jit_adam_init  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import base as tbase  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402
from incubator_predictionio_tpu_torch.models import transformer as ttr  # noqa: E402
from incubator_predictionio_tpu_torch.parallel import launcher  # noqa: E402
from incubator_predictionio_tpu_torch.parallel import staging as tstaging  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext  # noqa: E402
from incubator_predictionio_tpu_torch.templates import recommendation as trec  # noqa: E402
from incubator_predictionio_tpu_torch.templates import sequential as tseq  # noqa: E402
from incubator_predictionio_tpu_torch.utils import optim as toptim  # noqa: E402

from tests.test_torch_distributed_train import _bitwise, mirror  # noqa: E402
from tests.test_torch_evaluation import (  # noqa: E402
    APPS,
    _rec_fold,
    _seq_fold,
    stores,  # noqa: F401 - the module's fixture: both packages' sqlite stores
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = DeviceContext.create(device="cpu")
LAUNCH_TIMEOUT = 180.0
STEP_LOSS_RTOL = 1e-5
#: every step of the 3-epoch fits (module docstring)
ALL_STEPS_RTOL = 1e-4


class Lockstep:
    """``n`` processes of a job as threads of this process. Each thread's
    context (:meth:`context`) has the surface the sharded reads and the
    staging use — ``process_index``, ``process_count``, ``is_primary``,
    ``device`` (the CPU), ``pad_to_batch_multiple``, ``allgather_obj``
    (every thread's object, in process order, through a barrier) and the
    reference's ``put_local_batches`` (the numpy array back). :meth:`run`
    calls ``fn(ctx)`` on every thread and returns the results in process
    order; a thread that raises breaks the barrier, so its peers fail
    instead of waiting, and the first error is raised."""

    def __init__(self, n: int):
        self.n = n
        self._barrier = threading.Barrier(n, timeout=60)
        self._slots = [None] * n

    def context(self, index: int):
        group = self

        class Ctx:
            process_index = data_index = index
            process_count = data_size = group.n
            is_primary = index == 0
            device = torch.device("cpu")
            backend = "lockstep"

            def pad_to_batch_multiple(self, n):
                return ((n + group.n - 1) // group.n) * group.n

            def allgather_obj(self, obj, axis=None):
                group._slots[index] = obj
                group._barrier.wait()
                out = list(group._slots)
                group._barrier.wait()  # every thread has read the slots
                return out

            def put_local_batches(self, a):
                return a

        return Ctx()

    def run(self, fn):
        results, errors = [None] * self.n, [None] * self.n

        def body(i):
            try:
                results[i] = fn(self.context(i))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors[i] = e
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(i,)) for i in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        first = next((e for e in errors
                      if e is not None and not isinstance(e, threading.BrokenBarrierError)),
                     next((e for e in errors if e is not None), None))
        if first is not None:
            raise first
        return results


# -- (1) the recommendation template's sharded folds ---------------------------

@pytest.mark.parametrize("n_procs,k", [(2, 3), (3, 2), (2, 5)])
def test_read_eval_sharded_is_the_references(stores, n_procs, k):
    """Fold membership, fold-local vocabularies, the local train rows and
    the gathered query set of every process, bitwise the reference's."""
    def read(pkg):
        return lambda ctx: pkg.DataSource(pkg.DataSourceParams(
            app_name="rec", eval_k=k)).read_eval(ctx)

    want = Lockstep(n_procs).run(read(jrec))
    got = Lockstep(n_procs).run(read(trec))
    whole = trec.DataSource(trec.DataSourceParams(app_name="rec")).read_training(CPU)
    for p in range(n_procs):
        assert len(got[p]) == len(want[p]) == k
        assert [_rec_fold(f) for f in got[p]] == [_rec_fold(f) for f in want[p]]
    for fold in range(k):
        tds = [got[p][fold][0] for p in range(n_procs)]
        qas = [got[p][fold][2] for p in range(n_procs)]
        # every process evaluates the same query set
        assert all(qa == qas[0] for qa in qas)
        assert all(td.rows_are_local for td in tds)
        n_train = sum(len(td.ratings) for td in tds)
        assert all(td.n_rows_global == n_train for td in tds)
        held = sum(len(a.ratings) for _, a in qas[0])
        assert n_train + held == len(whole.ratings)
        tds[0].sanity_check()
        # the global vocabularies are the same on every process
        assert all(list(td.user_vocab) == list(tds[0].user_vocab) for td in tds)
        assert all(list(td.item_vocab) == list(tds[0].item_vocab) for td in tds)


# -- (2) per-process staging ---------------------------------------------------

@pytest.mark.parametrize("sizes", [(37, 29), (20, 33, 7), (25, 0)])
def test_stage_sharded_batches_is_the_references(sizes):
    """The staged arrays and weight columns of every process, bitwise the
    reference's numpy staging; an empty shard stages one zero row with all
    weights 0."""
    rng = np.random.default_rng(len(sizes))
    shards = [(rng.integers(0, 50, (n, 5)).astype(np.int32),
               rng.random(n).astype(np.float32)) for n in sizes]

    def stage(fn):
        return lambda ctx: fn(ctx, shards[ctx.process_index], 24, 7)

    want = Lockstep(len(sizes)).run(stage(jstaging.stage_sharded_batches))
    got = Lockstep(len(sizes)).run(stage(tstaging.stage_sharded_batches))
    b_local = 24 // len(sizes) if 24 % len(sizes) == 0 else None
    for p, ((ws, ww, wn), (gs, gw, gn)) in enumerate(zip(want, got)):
        assert gn == wn == sum(sizes)
        for a, b in zip(gs, ws):
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            _bitwise(a.numpy(), b, f"process {p}")
        _bitwise(gw.numpy(), ww, f"process {p} weights")
        assert float(gw.sum()) == sizes[p]
        if b_local:
            assert gw.shape[1] == b_local
        if sizes[p] == 0:
            assert not gs[0].numpy().any()
    assert len({g[1].shape for g in got}) == 1  # the same batch count


# -- (3) the sequential template's sharded reads ------------------------------

@pytest.mark.parametrize("n_procs", [2, 3])
def test_sequential_sharded_reads_are_the_references(stores, n_procs):
    """``_collect_sessions`` (each process's user shard), ``read_training``
    (``_build_fold(sharded=True)``: the token space the union in process
    order, token 0 padding) and ``read_eval`` (crc32 folds, the held-out
    queries gathered in process order), every process bitwise the
    reference's."""
    def ds(pkg, **kw):
        return pkg.DataSource(pkg.DataSourceParams(app_name="seq", max_len=8, **kw))

    for read in ("_collect_sessions", "read_training"):
        want = Lockstep(n_procs).run(lambda ctx: getattr(ds(jseq), read)(ctx))
        got = Lockstep(n_procs).run(lambda ctx: getattr(ds(tseq), read)(ctx))
        if read == "_collect_sessions":
            assert got == want
            users = [set(s) for s, _ in got]
            assert all(sharded for _, sharded in got)
            whole, _ = ds(tseq)._collect_sessions(CPU)
            assert set().union(*users) == set(whole)
            assert sum(len(u) for u in users) == len(whole)  # disjoint
            for sessions, _ in got:
                assert all(whole[u] == items for u, items in sessions.items())
            continue
        for g, w in zip(got, want):
            assert dict(g.item_map.items()) == dict(w.item_map.items())
            _bitwise(g.sequences, w.sequences)
            assert g.rows_are_local and g.n_rows_global == w.n_rows_global
        assert sum(len(g.sequences) for g in got) == got[0].n_rows_global
        assert 0 not in set(got[0].item_map.values())
        assert all(dict(g.item_map.items()) == dict(got[0].item_map.items())
                   for g in got)
    want = Lockstep(n_procs).run(lambda ctx: ds(jseq, eval_k=3).read_eval(ctx))
    got = Lockstep(n_procs).run(lambda ctx: ds(tseq, eval_k=3).read_eval(ctx))
    for g, w in zip(got, want):
        assert [_seq_fold(f) for f in g] == [_seq_fold(f) for f in w]
    single = ds(tseq, eval_k=3).read_eval(CPU)
    for fold in range(3):
        qas = [got[p][fold][2] for p in range(n_procs)]
        assert all(qa == qas[0] for qa in qas)
        # the same held-out sessions as one process's read, in shard order
        key = [(q.recent_items, a.next_item) for q, a in qas[0]]
        assert sorted(key) == sorted((q.recent_items, a.next_item)
                                     for q, a in single[fold][2])


# -- (4) the transformer's data-parallel fit, 2 processes over gloo -----------

FIT = dict(vocab_size=40, max_len=12, d_model=32, n_heads=2, n_layers=2,
           batch_size=16, epochs=3, learning_rate=1e-3, attention="local", seed=5)

FIT_CHILD = textwrap.dedent("""
    import json
    import sys

    import numpy as np

    from incubator_predictionio_tpu_torch.models import transformer as ttr
    from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext

    work = sys.argv[1]
    data = np.load(f"{work}/inputs.npz")
    cfg = ttr.TransformerConfig(**json.loads(open(f"{work}/cfg.json").read()))
    init = ttr.init_params_numpy(cfg, 5)
    ttr._init_params = lambda cfg, generator, device: init
    ctx = DeviceContext.create("cpu", distributed=True)
    p = ctx.process_index
    model = ttr.TransformerRecommender(cfg).fit(
        ctx, data[f"seq{p}"], None, rows_are_local=True)


    def flat(tree, prefix="p"):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, f"{prefix}.{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from flat(v, f"{prefix}.{i}")
        else:
            yield prefix, tree


    np.savez(f"{work}/out{p}.npz", **dict(flat(model.params)),
             step_losses=model.step_losses, final=model.final_loss,
             exchange=model.timings["exchange_sec"])
    ctx.stop()
""")


def _flat(tree, prefix="p"):
    """A parameter tree as {path: array} (the child script's naming)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}.{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}.{i}"))
        return out
    return {prefix: np.asarray(tree)}


def _shard_rows(n, seed):
    rng = np.random.default_rng(seed)
    seqs = rng.integers(1, FIT["vocab_size"], (n, FIT["max_len"] + 1)).astype(np.int32)
    seqs[: n // 3, : FIT["max_len"] // 2] = 0  # left-padded sessions
    return seqs


def _global_batches(shards, cfg):
    """The reference's per-process staging of ``shards`` concatenated into
    the global batches, the resampled padding rows zeroed (a zero row has
    weight 0 in both packages, as a padding row of the staging does):
    ``[n_batches × global batch, max_len+1]`` rows in batch order."""
    def stage(ctx):
        seqs = shards[ctx.process_index]
        (sb,), w, _ = jstaging.stage_sharded_batches(
            ctx, (seqs,), cfg["batch_size"], cfg["seed"])
        return np.where(w[..., None] > 0, sb, 0)

    local = Lockstep(len(shards)).run(stage)
    glob = np.concatenate(local, axis=1)  # [n_batches, B, L+1]
    return glob.reshape(-1, glob.shape[-1]), glob.shape[0]


def _jax_steps(rows, n_batches, cfg, init):
    """The JAX package's training step, one batch at a time, from ``init``:
    the loss of every step and the final parameters."""
    jcfg = jtr.TransformerConfig(**cfg)
    cache_cfg = dataclasses.replace(jcfg, seed=0, checkpoint_dir=None,
                                        checkpoint_every=0)
    step = jtr._train_epochs_fn(cache_cfg, MeshContext.create().mesh, False)
    params = jax.tree.map(jnp.asarray, init)
    opt = jit_adam_init(cfg["learning_rate"], jcfg.adam_moments_dtype)(params)
    b = len(rows) // n_batches
    tokens, targets = rows[:, :-1], rows[:, 1:]
    weights = ((targets != 0) & (tokens != 0)).astype(np.float32)
    positions = np.broadcast_to(np.arange(cfg["max_len"], dtype=np.int32),
                                tokens.shape)
    arrays = [np.ascontiguousarray(a).reshape(n_batches, b, cfg["max_len"])
              for a in (tokens, positions, targets, weights)]
    losses = []
    for _ in range(cfg["epochs"]):
        for i in range(n_batches):
            params, opt, loss = step(params, opt,
                                     *(jnp.asarray(a[i:i + 1]) for a in arrays),
                                     n_epochs=1)
            losses.append(float(loss))
    return np.asarray(losses), jax.tree.map(np.asarray, params)


def test_two_process_transformer_fit_matches_jax_on_the_global_batches(tmp_path):
    """Shards of 16 and 11 rows at batch 16 (8 a process, 2 batches, 5
    resampled padding rows in shard 1): the global batch's denominator, not
    the local one, gives the reference's losses."""
    shards = [_shard_rows(16, 1), _shard_rows(11, 2)]
    rows, n_batches = _global_batches(shards, FIT)
    assert n_batches == 2 and len(rows) == 32
    init = ttr.init_params_numpy(ttr.TransformerConfig(**FIT), 5)
    want_losses, want_params = _jax_steps(rows, n_batches, FIT, init)

    work = tmp_path / "fit"
    work.mkdir()
    np.savez(work / "inputs.npz", seq0=shards[0], seq1=shards[1])
    (work / "cfg.json").write_text(json.dumps(FIT))
    script = tmp_path / "fit_child.py"
    script.write_text(FIT_CHILD)
    res = launcher.launch_local(
        [], 2, coordinator_port=launcher.free_port(), timeout=LAUNCH_TIMEOUT,
        env={"PYTHONPATH": REPO}, command=[sys.executable, str(script), str(work)])
    assert res.ok, res.outputs
    outs = [np.load(work / f"out{p}.npz") for p in range(2)]
    want, start = _flat(want_params), _flat(init)
    assert set(outs[0].files) == set(want) | {"step_losses", "final", "exchange"}
    for name in list(want) + ["step_losses", "final"]:
        _bitwise(outs[0][name], outs[1][name], name)  # the replicas
    got = outs[0]
    assert got["step_losses"].shape == (FIT["epochs"], n_batches)
    losses = got["step_losses"].reshape(-1)
    np.testing.assert_allclose(losses[:n_batches], want_losses[:n_batches],
                               rtol=STEP_LOSS_RTOL)
    np.testing.assert_allclose(losses, want_losses, rtol=ALL_STEPS_RTOL)
    # the port's single-process fit on the same global batches
    single = ttr.TransformerRecommender(ttr.TransformerConfig(**FIT))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttr, "_init_params", lambda cfg, generator, device: init)
        one = single.fit(CPU, rows, None)
    one = one.step_losses.reshape(-1)
    np.testing.assert_allclose(losses[:n_batches], one[:n_batches],
                               rtol=STEP_LOSS_RTOL)
    np.testing.assert_allclose(losses, one, rtol=ALL_STEPS_RTOL)
    np.testing.assert_allclose(float(got["final"]), got["step_losses"][-1].mean(),
                               rtol=1e-6)
    band = 2 * FIT["learning_rate"] * FIT["epochs"] * n_batches
    moved = 0.0
    for name, w in want.items():
        g = got[name]
        assert g.dtype == np.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=band, err_msg=name)
        moved = max(moved, float(np.abs(g - start[name]).max()))
    assert moved > FIT["learning_rate"]  # it trained
    assert float(got["exchange"]) > 0


def test_replicated_rows_fit_is_the_single_process_loop_on_global_batches(
        monkeypatch):
    """``rows_are_local=False`` under several processes: every process
    stages the global batches and trains on its slice of each; with
    mirrored peers (each holds process 0's slice) the fit is the
    single-process loop over global batches of that slice twice."""
    init = ttr.init_params_numpy(ttr.TransformerConfig(**FIT), 5)
    monkeypatch.setattr(ttr, "_init_params", lambda cfg, generator, device: init)
    rows = _shard_rows(24, 3)
    cfg = dict(FIT, epochs=2)
    got = ttr.TransformerRecommender(ttr.TransformerConfig(**cfg)).fit(
        mirror(), rows, None)
    assert set(got.timings) >= {"exchange_sec", "stage_sec"}
    # the global batches: 16 rows each (the second padded with zero rows),
    # of which process 0 trains on the first 8 — twice over with mirrors
    padded = np.concatenate([rows, np.zeros((8, rows.shape[1]), np.int32)])
    halves = [padded[b * 16:b * 16 + 8] for b in range(2)]
    twice = np.concatenate([np.concatenate([h, h]) for h in halves])
    want = ttr.TransformerRecommender(ttr.TransformerConfig(**cfg)).fit(
        CPU, twice, None)
    np.testing.assert_allclose(got.step_losses, want.step_losses, rtol=STEP_LOSS_RTOL)
    for a, b in zip(ttr._leaves(got.params), ttr._leaves(want.params)):
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * cfg["learning_rate"] * 4)


# -- (5) the CLI: launch -n 2 eval on a sqlite app ------------------------------

EVAL_MODULE = textwrap.dedent("""
    from incubator_predictionio_tpu_torch.core import EngineParams
    from incubator_predictionio_tpu_torch.templates import recommendation as trec
    from incubator_predictionio_tpu_torch.templates import sequential as tseq


    class RecEval(trec.RecommendationEvaluation):
        def __init__(self):
            super().__init__(app_name="rec", eval_k=2)
            self.engine_params_list = [EngineParams.create(
                data_source=trec.DataSourceParams(app_name="rec", eval_k=2),
                algorithms=[("als", trec.ALSAlgorithmParams(
                    rank=rank, num_iterations=3, batch_size=64))])
                for rank in (4, 8)]


    class SeqEval(tseq.SequentialEvaluation):
        def __init__(self):
            super().__init__(app_name="seq", eval_k=2)
            self.engine_params_list = [EngineParams.create(
                data_source=tseq.DataSourceParams(app_name="seq", max_len=8,
                                                  eval_k=2),
                algorithms=[("transformer", tseq.TransformerAlgorithmParams(
                    app_name="seq", max_len=8, d_model=16, n_heads=2,
                    n_layers=1, batch_size=16, epochs=epochs))])
                for epochs in (1, 2)]
""")


def _eval_app(tmp_path):
    """Both apps' events in one sqlite file, and the environment that
    names it for the launched processes."""
    from incubator_predictionio_tpu_torch.data import event as tevent

    path = str(tmp_path / "pio.db")
    config = {"PIO_STORAGE_SOURCES_SQLITE_TYPE": "sqlite",
              "PIO_STORAGE_SOURCES_SQLITE_PATH": path}
    storage = treg.Storage(config)
    for name in ("rec", "seq"):
        app_id = storage.get_meta_data_apps().insert(tbase.App(0, name))
        storage.get_events().init(app_id)
        storage.get_events().insert_batch(
            [tevent.Event.from_json_dict(d) for d in APPS[name]()], app_id)
    storage.close()
    (tmp_path / "evalmod.py").write_text(EVAL_MODULE)
    env = dict(os.environ)
    env.update(config)
    env.update({"PIO_FS_BASEDIR": str(tmp_path / "fs"), "PYTHONPATH": REPO})
    return env, config


@pytest.mark.parametrize("evaluation", ["RecEval", "SeqEval"])
def test_cli_launch_two_process_eval(tmp_path, evaluation):
    """``launch -n 2 eval``: each process reads its shard and runs the
    data-parallel fits of every fold; both compute the same results, and
    only process 0 writes the one EVALCOMPLETED row."""
    env, config = _eval_app(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "incubator_predictionio_tpu_torch.tools.cli",
         "launch", "-n", "2", "--cpu-devices-per-process", "1",
         "--coordinator-port", str(launcher.free_port()),
         "--timeout", str(LAUNCH_TIMEOUT), "eval", f"evalmod:{evaluation}"],
        capture_output=True, text=True, env=env, cwd=tmp_path,
        timeout=LAUNCH_TIMEOUT + 30)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("Evaluation completed. Instance ID") == 1
    assert "Evaluation completed (secondary process" in out.stdout
    assert out.stdout.count("replica digest") == 2 * 2 * 2  # 2 variants × 2 folds
    finished = [line.split("evaluation finished: ", 1)[1]
                for line in out.stdout.splitlines() if "evaluation finished: " in line]
    assert len(finished) == 2 and finished[0] == finished[1]
    storage = treg.Storage(config)
    try:
        rows = storage.get_meta_data_evaluation_instances().get_all()
        assert [r.status for r in rows] == ["EVALCOMPLETED"]
        res = json.loads(rows[0].evaluator_results_json)
        scores = [r["score"] for r in res["results"]]
        assert len(scores) == 2 and all(np.isfinite(scores))
        assert rows[0].evaluator_results in out.stdout
    finally:
        storage.close()
