"""PyTorch port, tensor parallelism of the sequential transformer on the
CPU: Megatron's weight split over the ``model`` axis
(``models/transformer.py``: ``shard_params``, ``TensorParallel``,
``gather_params``, the fit), as counterparts of tests/test_tensor_parallel.py,
and ``launch -n 2 train --mesh-axes '{"model": 2}'`` through the CLI, then
deploy and query.

The in-process cases run the processes of a mesh as threads
(:class:`ThreadMesh`): each thread's context meets the others' at a
barrier in every collective and combines the objects of its axis line in
axis order — what gloo's collectives compute, without the transport. The
launch runs real gloo processes through ``parallel/launcher.py``.

Tolerances, with their reasons:
- a column-parallel then a row-parallel fp32 product against the
  replicated one, forward and the input's gradient: 1e-5 (rtol and atol;
  the sum over the model axis reorders the contraction's fp32 sums).
- the tensor-parallel forward against the JAX package's ``_forward`` of
  ``_place_params_tensor_sharded`` params (and of the replicated params),
  the biases and norms random (so a mis-sliced ``b1`` or a ``b2`` added on
  every shard shows): 5e-2, the reference's own band
  (test_tensor_parallel.py:53-67): each row-parallel partial product
  rounds to bf16 before the sum over ``model``, where the replicated
  product rounds once.
- step losses of a tensor-parallel fit against the replicated fit from
  the same initial parameters: 2e-2 relative, for the same roundings
  carried through the adam steps.
- the tensor-parallel fit against the JAX package's on its own mesh of
  the same axes, from the same initial parameters (biases and norms
  random): each epoch's mean step loss within 1e-3 relative (readings
  1.0e-5 to 1.7e-4), and every parameter leaf within 0.3 of the JAX fit's
  update from the init, ``‖p − p_jax‖ / ‖p_jax − p_0‖`` (readings 0.070
  and 0.148: adam's first steps move by about ``lr·sign(g)``, so an
  element whose gradient is near 0 may step either way in either
  package).
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading

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
from incubator_predictionio_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.ring import (  # noqa: E402
    causal_attention_reference,
)
from incubator_predictionio_tpu_torch.server.query_server import (  # noqa: E402
    ServerConfig,
    load_deployed_engine,
)
from incubator_predictionio_tpu_torch.sharding import degrade  # noqa: E402

from tests.test_torch_dist_procs import _store  # noqa: E402
from tests.test_torch_evaluation import APPS  # noqa: E402

CPU = DeviceContext.create(device="cpu")
EXACT_TOL = 1e-5
FORWARD_TOL = 5e-2
STEP_LOSS_RTOL = 2e-2
JAX_LOSS_RTOL = 1e-3
JAX_UPDATE_RTOL = 0.3
LAUNCH_TIMEOUT = 120.0


def _cfg(**kw):
    base = dict(vocab_size=64, max_len=8, d_model=16, n_heads=4, n_layers=2,
                batch_size=16, epochs=2, seed=0, attention="local",
                tensor_parallel=True)
    base.update(kw)
    return base


class ThreadMesh:
    """The processes of a mesh over ``axes`` as threads of this process,
    on the CPU. Every thread makes the same collectives in the same order
    (the fit's code is the same on every process); each meets the others
    at a barrier, and takes the objects of its line along the named axis
    (every thread's with no axis), in axis order."""

    def __init__(self, axes: dict):
        self.n = int(np.prod(list(axes.values())))
        self.axes = tmesh.resolve_axes(axes, self.n)
        self._barrier = threading.Barrier(self.n, timeout=120)
        self._slots = [None] * self.n

    def _line(self, index, axis):
        if axis is None:
            return list(range(self.n))
        if axis not in dict(self.axes):
            return [index]
        return next(line for line in tmesh.axis_lines(self.axes, axis)
                    if index in line)

    def _meet(self, index, obj, axis, combine):
        self._slots[index] = obj
        self._barrier.wait()
        out = combine([self._slots[r] for r in self._line(index, axis)])
        self._barrier.wait()  # every thread has combined the slots
        return out

    def context(self, index: int):
        group = self

        def total(parts):
            out = parts[0].clone()
            for q in parts[1:]:
                out = out + q
            return out

        class Member(DeviceContext):
            def allgather_obj(self, obj, axis=None):
                return group._meet(index, obj, axis, list)

            def all_gather(self, t, axis=None):
                return group._meet(index, t.contiguous(), axis, torch.stack)

            def all_reduce_sum(self, t, axis=None):
                return group._meet(index, t, axis, total)

            def ppermute(self, t, axis, shift=1, cyclic=True):
                # what the member ``shift`` places back on the line sent
                def take(parts):
                    line = group._line(index, axis)
                    src = line.index(index) - shift
                    if cyclic:
                        return parts[src % len(line)].clone()
                    return (parts[src].clone() if 0 <= src < len(line)
                            else torch.zeros_like(t))

                return group._meet(index, t.contiguous(), axis, take)

        return Member(torch.device("cpu"), index, self.n, "threads",
                      self.axes)

    def run(self, fn):
        results, errors = [None] * self.n, [None] * self.n

        def body(i):
            try:
                results[i] = fn(self.context(i))
            except BaseException as e:  # noqa: BLE001 - raised below
                errors[i] = e
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(i,))
                   for i in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for e in errors:
            if e is not None and not isinstance(e, threading.BrokenBarrierError):
                raise e
        for e in errors:
            if e is not None:
                raise e
        return results


def test_column_row_placement_is_exact_fp32():
    """The Megatron pair itself in fp32: a column-parallel projection then
    a row-parallel one, summed over the model axis, is the replicated
    product; the input's gradient, summed by the backward of the first
    of the pair, is the replicated gradient."""
    rng = np.random.default_rng(0)
    d, dh, tp = 16, 64, 4
    x = torch.from_numpy(rng.normal(size=(8, d)).astype(np.float32))
    w1 = torch.from_numpy(rng.normal(size=(d, dh)).astype(np.float32))
    w2 = torch.from_numpy(rng.normal(size=(dh, d)).astype(np.float32))
    xr = x.clone().requires_grad_(True)
    y_rep = torch.tanh(xr @ w1) @ w2
    (y_rep * y_rep).sum().backward()

    def shard(ctx):
        tp_ = ttr.TensorParallel(ctx)
        n = dh // tp
        xs = x.clone().requires_grad_(True)
        a = tp_.copy(xs)
        y = tp_.reduce(torch.tanh(a @ w1[:, tp_.rank * n:(tp_.rank + 1) * n])
                       @ w2[tp_.rank * n:(tp_.rank + 1) * n])
        (y * y).sum().backward()
        return y.detach(), xs.grad

    for y, g in ThreadMesh({"model": tp}).run(shard):
        torch.testing.assert_close(y, y_rep.detach(), rtol=EXACT_TOL,
                                   atol=EXACT_TOL)
        torch.testing.assert_close(g, xr.grad, rtol=EXACT_TOL, atol=EXACT_TOL)


def _jax_params(cfg):
    return jax.device_get(jtr._init_params(jax.random.key(0),
                                           jtr.TransformerConfig(**cfg)))


def _random_biases(params, seed):
    """``params`` (a numpy tree) with every bias and layer norm drawn at
    random (the init's are zeros and ones, under which a bias added on
    every shard, or one cut on the wrong dim, cannot show)."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.array, params)

    def draw(shape, base):
        return (base + 0.2 * rng.standard_normal(shape)).astype(np.float32)

    for norm in [out["ln_f"]] + [layer[n] for layer in out["layers"]
                                 for n in ("ln1", "ln2")]:
        norm["g"], norm["b"] = draw(norm["g"].shape, 1.0), draw(norm["b"].shape, 0.0)
    for layer in out["layers"]:
        layer["b1"], layer["b2"] = (draw(layer["b1"].shape, 0.0),
                                    draw(layer["b2"].shape, 0.0))
    return out


def _tp_forward(cfg, host, tokens, positions, axes):
    tcfg = ttr.TransformerConfig(**cfg)

    def forward(ctx):
        tp = ttr.TensorParallel(ctx)
        net = ttr.TransformerNet(ttr.shard_params(host, tp.rank, tp.size),
                                 tcfg, "cpu", trainable=True, tp=tp)
        with torch.no_grad():
            return net(torch.from_numpy(tokens), torch.from_numpy(positions),
                       causal_attention_reference).numpy(), net

    return ThreadMesh(axes).run(forward)


def test_sharded_forward_matches_the_jax_package():
    """The forward over 4 shards against the JAX package's ``_forward`` of
    its ``_place_params_tensor_sharded`` params on the ``{"data": 2,
    "model": 4}`` mesh, and of the replicated params; the biases and norms
    random."""
    cfg = _cfg()
    host = _random_biases(_jax_params(cfg), 7)
    jcfg = jtr.TransformerConfig(**cfg)
    placed = jtr._place_params_tensor_sharded(
        MeshContext.create(axes={"data": 2, "model": 4}), host)
    tokens = np.asarray(jax.random.randint(jax.random.key(1), (8, 8), 1, 64),
                        np.int64)
    positions = np.broadcast_to(np.arange(8), (8, 8)).astype(np.int64)
    h_jax_tp, _ = jax.jit(lambda p: jtr._forward(
        p, jnp.asarray(tokens), jnp.asarray(positions), jcfg))(placed)
    h_jax_rep, _ = jtr._forward(host, jnp.asarray(tokens),
                                jnp.asarray(positions), jcfg)
    got = _tp_forward(cfg, host, tokens, positions, {"model": 4})
    for h, _ in got:
        assert h.shape == (8, 8, 16) and np.isfinite(h).all()
        np.testing.assert_allclose(h, np.asarray(h_jax_tp), rtol=FORWARD_TOL,
                                   atol=FORWARD_TOL)
        np.testing.assert_allclose(h, np.asarray(h_jax_rep), rtol=FORWARD_TOL,
                                   atol=FORWARD_TOL)
        np.testing.assert_array_equal(h, got[0][0])  # every shard's output


def test_weights_are_actually_distributed():
    """Each process holds 1/tp of the heads and FFN features (the memory
    point of tensor parallelism), the rest whole."""
    cfg = _cfg()
    host = _jax_params(cfg)
    tokens = np.ones((2, 8), np.int64)
    positions = np.broadcast_to(np.arange(8), (2, 8)).astype(np.int64)
    d, dh = cfg["d_model"], 4 * cfg["d_model"]
    for _, net in _tp_forward(cfg, host, tokens, positions, {"model": 4}):
        layer = net.layers[0]
        shapes = {n: tuple(getattr(layer, n).shape)
                  for n in ("wq", "wk", "wv", "wo", "w1", "b1", "w2", "b2")}
        assert shapes == {"wq": (d, d // 4), "wk": (d, d // 4),
                          "wv": (d, d // 4), "wo": (d // 4, d),
                          "w1": (d, dh // 4), "b1": (dh // 4,),
                          "w2": (dh // 4, d), "b2": (d,)}
        assert tuple(net.item_emb.shape) == (64, d)


def _sequences():
    rng = np.random.default_rng(0)
    seqs = np.zeros((32, 9), np.int32)
    for i in range(32):
        start = rng.integers(1, 40)
        seqs[i] = np.arange(start, start + 9) % 63 + 1
    return seqs


@pytest.mark.parametrize("axes", [{"model": 2}, {"data": 2, "model": 2}],
                         ids=["model2", "data2-model2"])
def test_tensor_parallel_training_learns(axes):
    cfg = ttr.TransformerConfig(**_cfg(epochs=30, learning_rate=5e-3))
    seqs = _sequences()
    item_map = {f"i{t}": t for t in range(64)}
    models = ThreadMesh(axes).run(
        lambda ctx: ttr.TransformerRecommender(cfg).fit(ctx, seqs, item_map))
    rep = ttr.TransformerRecommender(dataclasses.replace(
        cfg, tensor_parallel=False)).fit(CPU, seqs, item_map)
    model = models[0]
    assert model.final_loss < 4.0  # ln(63) ≈ 4.14 is chance level
    # the canonical per-layer layout, the same on every process
    assert model.params["layers"][0]["wq"].shape == (16, 16)
    assert model.params["layers"][0]["w1"].shape == (16, 64)
    for other in models[1:]:
        for a, b in zip(ttr._leaves(model.params), ttr._leaves(other.params)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(model.step_losses, rep.step_losses,
                               rtol=STEP_LOSS_RTOL)
    assert set(model.timings) >= {"exchange_sec", "exchange_model_sec"}
    model.prepare_for_serving(CPU)
    scores = ttr.TransformerRecommender.next_item_scores(model, seqs[:2, :-1])
    assert scores.shape == (2, 64) and np.isfinite(scores).all()


@pytest.mark.parametrize("axes", [{"model": 2}, {"data": 2, "model": 2}],
                         ids=["model2", "data2-model2"])
def test_tensor_parallel_fit_matches_the_jax_fit(axes, monkeypatch):
    """The tensor-parallel fit against the JAX package's tensor-parallel
    fit on its mesh of the same axes (the first ``prod(axes)`` of
    tests/conftest.py's 8 CPU devices), both from one initial tree with
    random biases and norms: each epoch's mean step loss (the JAX fit of
    ``e`` epochs reports the e-th epoch's mean) and the parameters."""
    cfg = _cfg(epochs=2, learning_rate=5e-3)
    init = _random_biases(ttr.init_params_numpy(ttr.TransformerConfig(**cfg), 5), 7)
    monkeypatch.setattr(jtr, "_jit_init_fn", lambda c: (
        lambda key: jax.tree.map(jnp.asarray, init)))
    monkeypatch.setattr(ttr, "_init_params", lambda c, generator, device: init)
    seqs = _sequences()
    got = ThreadMesh(axes).run(lambda ctx: ttr.TransformerRecommender(
        ttr.TransformerConfig(**cfg)).fit(ctx, seqs, None))[0]
    mesh = MeshContext.create(
        axes=axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])
    for epochs in (1, 2):
        want = jtr.TransformerRecommender(jtr.TransformerConfig(
            **{**cfg, "epochs": epochs})).fit(mesh, seqs, None)
        np.testing.assert_allclose(got.step_losses[epochs - 1].mean(),
                                   want.final_loss, rtol=JAX_LOSS_RTOL,
                                   err_msg=f"epoch {epochs}")
    jflat, jtree = jax.tree.flatten(jax.tree.map(np.asarray, want.params))
    tflat, ttree = jax.tree.flatten(got.params)
    assert jtree == ttree  # the canonical layout, the reference's tree
    for a, b, p0 in zip(tflat, jflat, jax.tree.flatten(init)[0]):
        assert a.shape == b.shape
        moved = np.linalg.norm((b - p0).astype(np.float64))
        assert moved > 0  # every leaf trained
        assert np.linalg.norm((a - b).astype(np.float64)) <= JAX_UPDATE_RTOL * moved


def test_validations():
    ctx = DeviceContext(torch.device("cpu"), 0, 8, axes={"data": 2, "model": 4})
    rows = np.ones((8, 9), np.int32)
    with pytest.raises(ValueError, match="divisible by the model axis"):
        ttr.TransformerRecommender(ttr.TransformerConfig(**_cfg(n_heads=2))).fit(
            ctx, rows, None)
    ctx4 = DeviceContext(torch.device("cpu"), 0, 8, axes={"model": 2, "pipe": 4})
    with pytest.raises(ValueError, match="not with the pipeline"):
        ttr.TransformerRecommender(ttr.TransformerConfig(**_cfg(
            n_heads=4, n_layers=4, pipeline_stages=4))).fit(ctx4, rows, None)
    # MoE has its own parallel layout: refused, not mis-sharded
    with pytest.raises(ValueError, match="not with the pipeline or MoE"):
        ttr.TransformerRecommender(ttr.TransformerConfig(**_cfg(n_experts=2))).fit(
            ctx, rows, None)


def test_warns_when_mesh_axis_missing(caplog):
    """``tensor_parallel`` on a mesh without a ``model`` axis warns ONCE a
    key and counts every occurrence (sharding/degrade.py), and trains
    replicated."""
    import logging

    degrade.reset()
    seqs = np.ones((8, 9), np.int32)
    cfg = ttr.TransformerConfig(**_cfg(vocab_size=16, n_heads=2, n_layers=1,
                                       batch_size=8, epochs=1))
    with caplog.at_level(
            logging.WARNING,
            logger="incubator_predictionio_tpu_torch.sharding.degrade"):
        ttr.TransformerRecommender(cfg).fit(CPU, seqs, None)
        model = ttr.TransformerRecommender(cfg).fit(CPU, seqs, None)
    warned = [r for r in caplog.records if "no 'model' axis" in r.message]
    assert len(warned) == 1  # once per key, not per fit
    recs = [d for d in degrade.degradations() if d["axis"] == "model"]
    assert len(recs) == 1 and recs[0]["count"] == 2
    assert recs[0]["mesh_axes"] == ["data"]
    assert np.isfinite(model.final_loss)
    degrade.reset()


def test_cli_launch_tensor_parallel_train_then_deploy(tmp_path):
    """``launch -n 2 train --mesh-axes '{"model": 2}'`` of the sequential
    template with ``tensorParallel``: each process logs its slices' shapes,
    process 0 persists the canonical layout, and the deployed model
    answers."""
    env, config = _store(tmp_path, "seq", APPS["seq"]())
    variant = tmp_path / "engine.json"
    variant.write_text(json.dumps({
        "id": "tp", "version": "1",
        "engineFactory": "incubator_predictionio_tpu_torch.templates."
                         "sequential.SequentialEngine",
        "datasource": {"params": {"appName": "seq", "maxLen": 8}},
        "algorithms": [{"name": "transformer", "params": {
            "maxLen": 8, "dModel": 16, "nHeads": 2, "nLayers": 1,
            "batchSize": 16, "epochs": 3, "tensorParallel": True}}]}))
    out = subprocess.run(
        [sys.executable, "-m", "incubator_predictionio_tpu_torch.tools.cli",
         "launch", "-n", "2", "--cpu-devices-per-process", "1",
         "--coordinator-port", str(launcher.free_port()),
         "--timeout", str(LAUNCH_TIMEOUT), "train", "-v", str(variant),
         "--mesh-axes", '{"model": 2}'],
        capture_output=True, text=True, env=env, timeout=LAUNCH_TIMEOUT + 30)
    assert out.returncode == 0, out.stdout + out.stderr
    fits = [line for line in out.stdout.splitlines()
            if "tensor-parallel fit: process" in line]
    assert len(fits) == 2
    for line in fits:
        assert "1 of 2 heads; wq [16, 8], w1 [16, 32], wo [8, 16], w2 [32, 16]" in line
    digests = {line.split("model digest ")[1].split(",")[0] for line in fits}
    assert len(digests) == 1
    storage = treg.Storage(config)
    try:
        (inst,) = storage.get_meta_data_engine_instances().get_all()
        assert inst.status == "COMPLETED"
        deployed = load_deployed_engine(ServerConfig(engine_variant=str(variant)),
                                        storage, ctx=CPU, warmup=False)
        model = deployed.models[0]
        assert model.params["layers"][0]["wq"].shape == (16, 16)
        algo = deployed.algorithms[0]
        algo._levents = type("Reads", (), {"find_by_entity": lambda *a, **k: []})()
        res = deployed.predict({"recentItems": ["i1", "i2", "i3"], "num": 3})
        assert len(res.item_scores) == 3
        assert all(np.isfinite(s.score) for s in res.item_scores)
    finally:
        storage.close()
