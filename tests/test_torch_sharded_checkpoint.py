"""PyTorch port, checkpoints of the sequential transformer's split weights
on the CPU (``utils/checkpoint.py:SplitLeaves``,
``models/transformer.py:checkpoint_layout``): tensor parallelism on
``model``, experts on ``expert`` and stages on ``pipe``, each alone or
beside ``data``, save whole leaves and resume as the reference's orbax
checkpoints do (reference utils/checkpoint.py:108-242, 481-502).

- An interrupted fit (1 epoch, then 2 on the same directory) is bitwise
  the uninterrupted fit on every process, with fp32 and bf16 adam moments;
  the state restored is bitwise what the step holds; a restore that hands
  each member the other's slice breaks that.
- The resumed fit against the JAX package's orbax-resumed fit on its own
  CPU mesh of the same axes, from one initial tree injected into both.
- Across layouts, the reference's outcomes: a tensor-parallel checkpoint
  resumes a replicated one-process fit, an expert-parallel one a
  one-process mixture of experts; a pipelined one (stacked layers) fails a
  one-process fit's check, which warns, deletes the steps and trains
  afresh. Each row holds the JAX package's own outcome beside the port's.
- ``launch -n 2 train --mesh-axes '{"model": 2}'`` with ``checkpointDir``
  through the CLI, 1 epoch then 2: the second run resumes, and a deploy
  answers.

The in-process cases run the processes of a mesh as threads
(tests/test_torch_moe.py's ``ExpertThreadMesh``).

Tolerances, with their reasons: the resumed fits against the JAX
package's are held to the bands of the files that compare the same fits
uninterrupted (a resume changes no arithmetic): tensor parallelism's
``JAX_LOSS_RTOL`` 1e-3 and ``JAX_UPDATE_RTOL`` 0.3
(tests/test_torch_tensor_parallel.py), the experts' ``MESH_LOSS_RTOL``
2e-4 and ``MESH_UPDATE_RTOL`` 0.4 (tests/test_torch_moe.py), the pipe's
``FIT_LOSS_RTOL`` 1e-4 and ``FIT_UPDATE_RTOL`` 0.3
(tests/test_torch_pipeline.py); each loss is the last epoch's mean step
loss, each update ``‖p − p_jax‖ / ‖p_jax − p_0‖`` of the largest leaf.
Everything else is bitwise.
"""

import json
import logging
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from incubator_predictionio_tpu.models import transformer as jtr  # noqa: E402
from incubator_predictionio_tpu.parallel.mesh import MeshContext  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402
from incubator_predictionio_tpu_torch.models import transformer as ttr  # noqa: E402
from incubator_predictionio_tpu_torch.parallel import launcher  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext  # noqa: E402
from incubator_predictionio_tpu_torch.server.query_server import (  # noqa: E402
    ServerConfig,
    load_deployed_engine,
)
from incubator_predictionio_tpu_torch.sharding import degrade  # noqa: E402
from incubator_predictionio_tpu_torch.utils import checkpoint as tckpt  # noqa: E402

from tests import test_torch_moe as tmoe  # noqa: E402
from tests import test_torch_pipeline as tpipe  # noqa: E402
from tests import test_torch_tensor_parallel as ttp  # noqa: E402
from tests.test_torch_dist_procs import _store  # noqa: E402
from tests.test_torch_evaluation import APPS  # noqa: E402

CPU = DeviceContext.create(device="cpu")
LAUNCH_TIMEOUT = 120.0
PORT_LOG = "incubator_predictionio_tpu_torch.utils.checkpoint"
JAX_LOG = "incubator_predictionio_tpu.utils.checkpoint"
RESUMED = "checkpoint: resuming from epoch 1 (of 2)"
FRESH = "restarting fresh"


def _seqs(blank_rows=0, rows=32):
    seqs = ttp._sequences()[:rows]
    seqs[:blank_rows, :3] = 0
    return seqs


#: each mesh: its axes, the config of the file that compares its fit with
#: the JAX package's, its rows, its bands against the JAX fit (loss,
#: update), and how that file draws the biases and norms of the init
MESHES = {
    "model2": ({"model": 2}, ttp._cfg(epochs=2, learning_rate=5e-3), _seqs(),
               (ttp.JAX_LOSS_RTOL, ttp.JAX_UPDATE_RTOL), ttp._random_biases),
    "data2-model2": ({"data": 2, "model": 2},
                     ttp._cfg(epochs=2, learning_rate=5e-3), _seqs(),
                     (ttp.JAX_LOSS_RTOL, ttp.JAX_UPDATE_RTOL),
                     ttp._random_biases),
    "expert2": ({"expert": 2},
                tmoe._cfg(n_experts=4, n_layers=2, epochs=2, learning_rate=5e-3,
                          expert_capacity_factor=0.5), _seqs(6),
                (tmoe.MESH_LOSS_RTOL, tmoe.MESH_UPDATE_RTOL),
                tmoe._random_biases),
    "data2-pipe2": ({"data": 2, "pipe": 2},
                    tpipe._cfg(n_layers=4, pipeline_stages=2,
                               pipeline_microbatches=4, epochs=2,
                               learning_rate=5e-3), _seqs(5, 16),
                    (tpipe.FIT_LOSS_RTOL, tpipe.FIT_UPDATE_RTOL),
                    ttp._random_biases),
}


def _fit(axes, cfg, seqs, **kw):
    """Every process's model of the fit of ``cfg`` (with ``kw``) over
    ``axes``, threads as processes."""
    c = ttr.TransformerConfig(**{**cfg, **kw})
    return tmoe.ExpertThreadMesh(axes).run(
        lambda ctx: ttr.TransformerRecommender(c).fit(ctx, seqs, None))


def _one(cfg, seqs, **kw):
    """The fit of ``cfg`` (with ``kw``) in one process."""
    return ttr.TransformerRecommender(ttr.TransformerConfig(**{**cfg, **kw})).fit(
        CPU, seqs, None)


def _same(a, b) -> bool:
    return a.final_loss == b.final_loss and all(
        np.array_equal(x, y) for x, y in zip(ttr._leaves(a.params),
                                              ttr._leaves(b.params)))


def _bits(leaves) -> list:
    return [(a.shape, a.dtype, a.tobytes())
            for a in (tckpt.leaf_to_numpy(x) for x in leaves)]


@pytest.fixture()
def restored(monkeypatch):
    """Each process's restored state, gathered whole again by its layout
    (a collective: every process restores), as host bytes."""
    got = []
    real = tckpt.TrainCheckpointer.restore

    def spy(self, step=None, like=None):
        state = real(self, step, like)
        if like is not None:
            whole = state if self._layout is None else self._layout.gather(state)
            got.append(_bits(tckpt.state_leaves(whole)))
        return state

    monkeypatch.setattr(tckpt.TrainCheckpointer, "restore", spy)
    return got


def _swapped_cut(monkeypatch):
    """The planted fault: each member cuts the slice of the next member of
    its line (on a line of two, the other's)."""
    real = tckpt.SplitLeaves.cut

    class Next:
        def __init__(self, ctx):
            self.ctx = ctx

        def axis_size(self, axis):
            return self.ctx.axis_size(axis)

        def axis_index(self, axis):
            return (self.ctx.axis_index(axis) + 1) % self.ctx.axis_size(axis)

    def cut(self, whole_leaves, like):
        ctx, self.ctx = self.ctx, Next(self.ctx)
        try:
            return real(self, whole_leaves, like)
        finally:
            self.ctx = ctx

    monkeypatch.setattr(tckpt.SplitLeaves, "cut", cut)


# -- (i) and (iv): interrupted fits against uninterrupted ones -------------

@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_interrupted_fit_is_bitwise_the_uninterrupted_one(mesh, moments,
                                                          restored, tmp_path):
    """1 epoch with ``checkpoint_every`` 1, then 2 epochs on the same
    directory: the second fit logs its resume and ends bitwise where the
    uninterrupted fit of 2 epochs ends, on every process; its step losses
    are the epoch it ran; the state each process restored, gathered whole,
    is bitwise the step's file."""
    axes, cfg, seqs = MESHES[mesh][:3]
    cfg = {**cfg, "adam_moments_dtype": moments}
    d = str(tmp_path / "ck")
    straight = _fit(axes, cfg, seqs)
    _fit(axes, cfg, seqs, epochs=1, checkpoint_dir=d, checkpoint_every=1)
    assert tckpt.TrainCheckpointer(d).all_steps() == [1]
    resumed = _fit(axes, cfg, seqs, checkpoint_dir=d, checkpoint_every=1)
    for got, want in zip(resumed, straight):
        assert _same(got, want)
        np.testing.assert_array_equal(got.step_losses, want.step_losses[1:])
    saved = _bits(tckpt.state_leaves(tckpt.TrainCheckpointer(d).restore(1)))
    assert len(restored) == len(resumed)
    for leaves in restored:
        assert leaves == saved
    assert tckpt.TrainCheckpointer(d).all_steps() == [1, 2]


def test_swapped_slices_break_the_resume(monkeypatch, tmp_path):
    """The planted fault: each member of a ``{"model": 2}`` fit handed the
    other's slice on restore. The resumed fit is no longer the
    uninterrupted one."""
    axes, cfg, seqs = MESHES["model2"][:3]
    d = str(tmp_path / "ck")
    straight = _fit(axes, cfg, seqs)
    _fit(axes, cfg, seqs, epochs=1, checkpoint_dir=d, checkpoint_every=1)
    _swapped_cut(monkeypatch)
    resumed = _fit(axes, cfg, seqs, checkpoint_dir=d, checkpoint_every=1)
    assert not any(_same(got, want) for got, want in zip(resumed, straight))


# -- (ii) and (iii): against the JAX package's orbax checkpoints ------------

@pytest.fixture(scope="module")
def epoch1(tmp_path_factory):
    """Each mesh's first epoch in both packages, made once for the module:
    from one initial tree with random biases and norms, the port's fit
    over threads and the JAX package's on its CPU mesh of the same axes,
    each saving step 1 into its own directory. ``epoch1(mesh)`` returns
    (init, port dir, JAX dir)."""
    made = {}

    def first_epoch(mesh):
        if mesh in made:
            return made[mesh]
        axes, cfg, seqs, _, biases = MESHES[mesh]
        init = biases(ttr.init_params_numpy(ttr.TransformerConfig(**cfg), 5), 7)
        root = tmp_path_factory.mktemp(mesh)
        port, ref = str(root / "port"), str(root / "jax")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jtr, "_jit_init_fn", lambda c: (
                lambda key: jax.tree.map(jnp.asarray, init)))
            mp.setattr(ttr, "_init_params", lambda c, generator, device: init)
            _fit(axes, cfg, seqs, epochs=1, checkpoint_dir=port,
                 checkpoint_every=1)
            n = int(np.prod(list(axes.values())))
            jtr.TransformerRecommender(jtr.TransformerConfig(**{
                **cfg, "epochs": 1, "checkpoint_dir": ref,
                "checkpoint_every": 1})).fit(
                MeshContext.create(axes=axes, devices=jax.devices()[:n]),
                seqs, None)
        made[mesh] = init, port, ref
        return made[mesh]

    return first_epoch


def _copy(src, tmp_path, name):
    dst = str(tmp_path / name)
    shutil.copytree(src, dst)
    return dst


def _messages(caplog, logger, text):
    return [r.getMessage() for r in caplog.records
            if r.name == logger and text in r.getMessage()]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_resumed_fit_matches_the_jax_resumed_fit(mesh, epoch1, tmp_path, caplog):
    """Both packages resume their first epoch's checkpoint on their own
    mesh of the same axes and train the second: both log the resume, and
    the port's fit lies within the band of its file (module docstring) of
    the JAX package's, in loss and in every parameter."""
    init, port, ref = epoch1(mesh)
    axes, cfg, seqs, (loss_rtol, update_rtol), _ = MESHES[mesh]
    n = int(np.prod(list(axes.values())))
    port, ref = _copy(port, tmp_path, "port"), _copy(ref, tmp_path, "jax")
    with caplog.at_level(logging.INFO):
        got = _fit(axes, cfg, seqs, checkpoint_dir=port, checkpoint_every=1)
        want = jtr.TransformerRecommender(jtr.TransformerConfig(**{
            **cfg, "checkpoint_dir": ref, "checkpoint_every": 1})).fit(
            MeshContext.create(axes=axes, devices=jax.devices()[:n]), seqs, None)
    assert len(_messages(caplog, PORT_LOG, RESUMED)) == n
    assert _messages(caplog, JAX_LOG, RESUMED)
    for other in got[1:]:
        assert _same(other, got[0])
    np.testing.assert_allclose(got[0].final_loss, want.final_loss, rtol=loss_rtol)
    assert tpipe._update_rel(got[0].params, want.params, init) <= update_rtol


@pytest.mark.parametrize("mesh", ["data2-pipe2", "expert2", "model2"])
def test_cross_layout_resume_matches_the_reference(mesh, epoch1, tmp_path,
                                                    caplog):
    """The first epoch's checkpoint taken over the mesh, the second epoch
    on one process (one device in the JAX package), as the reference does:
    a tensor-parallel checkpoint resumes the replicated fit, an
    expert-parallel one the one-process mixture of experts, each within
    the band of its file of the JAX package's cross-layout fit; a
    pipelined checkpoint (stacked layers) fails the one-process fit's
    check in both packages, which warn, delete the steps and train afresh:
    the port's fit is bitwise a fresh one."""
    _, port, ref = epoch1(mesh)
    axes, cfg, seqs, (loss_rtol, _), _ = MESHES[mesh]
    one = {**cfg, "tensor_parallel": False, "checkpoint_every": 1}
    port, ref = _copy(port, tmp_path, "port"), _copy(ref, tmp_path, "jax")
    degrade.reset()
    with caplog.at_level(logging.INFO):
        got = _one(one, seqs, checkpoint_dir=port)
        want = jtr.TransformerRecommender(jtr.TransformerConfig(**{
            **one, "checkpoint_dir": ref})).fit(
            MeshContext.create(devices=jax.devices()[:1]), seqs, None)
    degrade.reset()
    if mesh == "data2-pipe2":
        for logger in (PORT_LOG, JAX_LOG):
            assert not _messages(caplog, logger, RESUMED)
            (warning,) = _messages(caplog, logger, FRESH)
            assert "checkpoint restore from" in warning
        assert _same(got, _one(one, seqs, checkpoint_every=0))
        # the stale stacked steps went; the fresh fit saved its own
        ck = tckpt.TrainCheckpointer(port)
        assert ck.all_steps() == [1, 2]
        assert isinstance(ck.restore(1)["params"], list)
        return
    for logger in (PORT_LOG, JAX_LOG):
        assert _messages(caplog, logger, RESUMED)
        assert not _messages(caplog, logger, FRESH)
    assert got.step_losses.shape[0] == 1  # the epoch this call ran
    np.testing.assert_allclose(got.final_loss, want.final_loss, rtol=loss_rtol)


# -- (v): the CLI --------------------------------------------------------------

def test_cli_launch_tensor_parallel_train_resumes(tmp_path):
    """``launch -n 2 train --mesh-axes '{"model": 2}'`` of the sequential
    template with ``tensorParallel`` and ``checkpointDir``: 1 epoch, then 2
    on the same directory; every process of the second run logs the
    resume, the primary's step files are the whole leaves, and the
    deployed model answers."""
    env, config = _store(tmp_path, "seq", APPS["seq"]())
    ck = tmp_path / "ck"

    def train(epochs):
        variant = tmp_path / f"engine-{epochs}.json"
        variant.write_text(json.dumps({
            "id": "tp", "version": "1",
            "engineFactory": "incubator_predictionio_tpu_torch.templates."
                             "sequential.SequentialEngine",
            "datasource": {"params": {"appName": "seq", "maxLen": 8}},
            "algorithms": [{"name": "transformer", "params": {
                "maxLen": 8, "dModel": 16, "nHeads": 2, "nLayers": 1,
                "batchSize": 16, "epochs": epochs, "tensorParallel": True,
                "checkpointDir": str(ck), "checkpointEvery": 1}}]}))
        out = subprocess.run(
            [sys.executable, "-m", "incubator_predictionio_tpu_torch.tools.cli",
             "launch", "-n", "2", "--cpu-devices-per-process", "1",
             "--coordinator-port", str(launcher.free_port()),
             "--timeout", str(LAUNCH_TIMEOUT), "train", "-v", str(variant),
             "--mesh-axes", '{"model": 2}'],
            capture_output=True, text=True, env=env,
            timeout=LAUNCH_TIMEOUT + 30)
        assert out.returncode == 0, out.stdout + out.stderr
        return variant, out.stdout

    _, first = train(1)
    assert RESUMED not in first
    variant, second = train(2)
    assert second.count(RESUMED) == 2, second
    assert second.count("tensor-parallel fit: process") == 2
    saved = tckpt.TrainCheckpointer(str(ck)).restore(2)
    assert {tuple(t.shape) for t in saved["params"]} >= {(16, 16), (16, 64),
                                                        (64, 16), (64,)}
    storage = treg.Storage(config)
    try:
        insts = storage.get_meta_data_engine_instances().get_all()
        assert [i.status for i in insts] == ["COMPLETED", "COMPLETED"]
        deployed = load_deployed_engine(ServerConfig(engine_variant=str(variant)),
                                        storage, ctx=CPU, warmup=False)
        assert deployed.models[0].params["layers"][0]["wq"].shape == (16, 16)
        algo = deployed.algorithms[0]
        algo._levents = type("Reads", (), {"find_by_entity": lambda *a, **k: []})()
        res = deployed.predict({"recentItems": ["i1", "i2", "i3"], "num": 3})
        assert len(res.item_scores) == 3
        assert all(np.isfinite(s.score) for s in res.item_scores)
    finally:
        storage.close()
