"""PyTorch port, pipeline parallelism over the ``pipe`` mesh axis on the
CPU: every test of tests/test_pipeline.py held to the port's GPipe schedule
(``parallel/pipeline.py``, ``models/transformer.py``: ``stage_params``,
``pipeline_grads``, ``pipeline_step``, the fit) on
``ThreadMesh({"data": 2, "pipe": 4})``, against the JAX package's dense
forward and gradients; the port's ``{"data": 2, "pipe": 2}`` fit against
the JAX package's ``{"data": 2, "pipe": 4}`` fit; and ``launch -n 2 train
--mesh-axes '{"pipe": 2}'`` through the CLI, then deploy and query.

The in-process cases run the processes of a mesh as threads
(tests/test_torch_tensor_parallel.py's ``ThreadMesh``).

Tolerances, with their reasons:
- the schedule in fp32 against the sequential stack: 1e-6, the
  reference's (test_pipeline.py:61-62); measured bitwise.
- the pipelined forward against the JAX dense ``_forward``: 5e-2, the
  reference's (test_pipeline.py:77-78): bf16 roundings under other
  fusions; and against the port's own dense forward, bitwise (the same
  ops on the same microbatch rows: each row's sums are its own).
- the pipelined gradients against the JAX dense gradients: 2e-3, the
  reference's (test_pipeline.py:102-109; absolute at these gradients'
  sizes, 5e-6 to 2e-4 a layer's largest: under ``Σ hidden²`` the layers'
  gradients are mostly cancellation, and the port's dense gradients
  differ from the JAX package's by 11-18% of a layer's largest element,
  as the pipelined ones do); against the port's dense gradients of the
  same loss, every leaf within 1e-2 of its max abs (measured at most
  4.2e-3: each microbatch's weight gradient rounds to bf16 before the
  fp32 sum over microbatches, as the reference's scan does).
- remat inside the stages against no remat: 1e-4 / 1e-5, the
  reference's (test_pipeline.py:137-139); measured bitwise.
- the ``{"data": 2, "pipe": 2}`` fit against the JAX ``{"data": 2,
  "pipe": 4}`` fit from one initial tree with random biases and norms:
  each step's loss 1e-4 relative (measured at most 1.37e-5), every
  parameter within 0.3 of the JAX fit's update (measured 0.102; adam's
  first steps move an element by about ``lr·sign(g)``, so a gradient near
  0 may step either way); against the port's one-process fit from the
  same init on the same batches, the bands the card's check uses: loss
  1e-4 relative (measured at most 3.3e-6) and 0.3 of the update (measured
  0.062). A pipeline that counts the logits' part of the shared leaves'
  gradients once a stage (every stage computing the loss, then the sum
  over ``pipe``) misses both (measured 2.98e-4 and 0.488).
"""

import dataclasses
import json
import logging
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from incubator_predictionio_tpu.models import transformer as jtr  # noqa: E402
from incubator_predictionio_tpu.parallel import pipeline as jpipe  # noqa: E402
from incubator_predictionio_tpu.parallel.mesh import MeshContext  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402
from incubator_predictionio_tpu_torch.models import transformer as ttr  # noqa: E402
from incubator_predictionio_tpu_torch.parallel import launcher  # noqa: E402
from incubator_predictionio_tpu_torch.parallel import pipeline as tpipe  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.ring import (  # noqa: E402
    causal_attention_reference,
)
from incubator_predictionio_tpu_torch.server.query_server import (  # noqa: E402
    ServerConfig,
    load_deployed_engine,
)

from tests.test_torch_dist_procs import _store  # noqa: E402
from tests.test_torch_evaluation import APPS  # noqa: E402
from tests.test_torch_tensor_parallel import (  # noqa: E402
    ThreadMesh,
    _random_biases,
    _sequences,
)

CPU = DeviceContext.create(device="cpu")
AXES = {"data": 2, "pipe": 4}
EXACT_TOL = 1e-6
FORWARD_TOL = 5e-2
GRAD_TOL = 2e-3
DENSE_GRAD_TOL = 1e-2
FIT_LOSS_RTOL = 1e-4
FIT_UPDATE_RTOL = 0.3
LAUNCH_TIMEOUT = 120.0


def _cfg(**kw):
    base = dict(vocab_size=64, max_len=8, d_model=16, n_heads=2, n_layers=4,
                batch_size=16, epochs=2, seed=0, attention="local",
                pipeline_stages=4)
    base.update(kw)
    return base


def _inputs(b=8, l=8, vocab=64, seed=1):
    tokens = np.asarray(jax.random.randint(jax.random.key(seed), (b, l), 1, vocab),
                        np.int64)
    return tokens, np.broadcast_to(np.arange(l), (b, l)).astype(np.int64)


def _rows(ctx, b):
    """This process's rows of a batch of ``b``: its data shard's."""
    n = b // ctx.data_size
    return slice(ctx.data_index * n, (ctx.data_index + 1) * n)


def test_stack_layers_matches_the_reference():
    layers = jax.device_get(jtr._init_params(
        jax.random.key(0), jtr.TransformerConfig(**_cfg())))["layers"]
    want = jpipe.stack_layers(layers)
    got = tpipe.stack_layers(layers)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_schedule_is_exact_fp32():
    """test_pipeline.py:41: the M + S − 1 schedule computes exactly the
    sequential stack, with a pure-fp32 layer body, on ``{"data": 2,
    "pipe": 4}`` (each data shard its rows, 4 microbatches)."""
    rng = np.random.default_rng(0)
    n_layers, d = 8, 16
    ws = rng.normal(size=(n_layers, d, d)).astype(np.float32) * 0.2
    bs = rng.normal(size=(n_layers, d)).astype(np.float32)
    h0 = rng.normal(size=(16, 4, d)).astype(np.float32)

    def apply_layer(lp, h):
        return torch.tanh(h @ lp["w"] + lp["b"])

    h_seq = torch.from_numpy(h0)
    for i in range(n_layers):
        h_seq = apply_layer({"w": torch.from_numpy(ws[i]),
                             "b": torch.from_numpy(bs[i])}, h_seq)

    def member(ctx):
        mine = tpipe.stage_slice(n_layers, 4, ctx.axis_index("pipe"))
        layers = [{"w": torch.from_numpy(ws[i]), "b": torch.from_numpy(bs[i])}
                  for i in range(n_layers)[mine]]
        rows = _rows(ctx, 16)
        return rows, tpipe.pipeline_forward(
            layers, torch.from_numpy(h0[rows]), apply_layer, ctx, 4)

    for rows, h in ThreadMesh(AXES).run(member):
        np.testing.assert_allclose(h.numpy(), h_seq[rows].numpy(),
                                   rtol=EXACT_TOL, atol=EXACT_TOL)


def _stage_net(ctx, host, cfg, trainable=False):
    stage = ctx.axis_index("pipe")
    return ttr.TransformerNet(ttr.stage_params(host, stage, ctx.axis_size("pipe")),
                              ttr.TransformerConfig(**cfg), "cpu",
                              trainable=trainable)


def test_pipelined_forward_matches_dense():
    """test_pipeline.py:65: the pipelined transformer ≈ the JAX dense
    forward, and bitwise the port's dense forward."""
    cfg = _cfg()
    host = _random_biases(jax.device_get(jtr._init_params(
        jax.random.key(0), jtr.TransformerConfig(**cfg))), 3)
    tokens, positions = _inputs()
    h_jax, _ = jtr._forward(host, jnp.asarray(tokens), jnp.asarray(positions),
                            jtr.TransformerConfig(**cfg))
    dense = ttr.TransformerNet(host, ttr.TransformerConfig(**cfg), "cpu",
                               trainable=True)
    with torch.no_grad():
        h_dense = dense(torch.from_numpy(tokens), torch.from_numpy(positions),
                        causal_attention_reference).numpy()

    def member(ctx):
        net = _stage_net(ctx, host, cfg, trainable=True)
        rows = _rows(ctx, 8)
        with torch.no_grad():
            t, p = torch.from_numpy(tokens[rows]), torch.from_numpy(positions[rows])
            h0 = ttr._lookup(t, net.item_emb) + ttr._lookup(p, net.pos_emb)
            h = tpipe.pipeline_forward(
                list(net.layers), h0,
                lambda layer, x: layer(x, cfg["n_heads"], causal_attention_reference)[0],
                ctx, 4)
            return rows, ttr._ln(h, net.ln_f.g, net.ln_f.b).numpy()

    for rows, h in ThreadMesh(AXES).run(member):
        np.testing.assert_allclose(h, np.asarray(h_jax)[rows], rtol=FORWARD_TOL,
                                   atol=FORWARD_TOL)
        np.testing.assert_array_equal(h, h_dense[rows])


def _pipe_grads(cfg, host, tokens, positions, axes=AXES):
    """Each process's gradients of ``Σ hidden²`` (its rows) through
    ``pipeline_grads``: ``{name: grad}`` with the stage's layers under
    their canonical index."""
    def member(ctx):
        net = _stage_net(ctx, host, cfg, trainable=True)
        pipe = tpipe.GPipe(ctx, cfg.get("pipeline_microbatches") or 4)
        rows = _rows(ctx, len(tokens))
        ttr.pipeline_grads(net, torch.from_numpy(tokens[rows]),
                           torch.from_numpy(positions[rows]), pipe,
                           lambda hidden: (hidden ** 2).sum(),
                           causal_attention_reference)
        first = tpipe.stage_slice(cfg["n_layers"], pipe.size, pipe.stage).start
        out = {}
        for name, p in net.named_parameters():
            if name.startswith("layers."):
                i, rest = name.split(".", 2)[1:]
                name = f"layers.{first + int(i)}.{rest}"
            out[name] = None if p.grad is None else p.grad.clone()
        return out

    parts = ThreadMesh(axes).run(member)
    total = {}
    for part in parts:
        for name, g in part.items():
            if g is not None:
                total[name] = total[name] + g if name in total else g
    return total


def test_pipelined_gradients_match_dense():
    """test_pipeline.py:82: the gradients of the pipelined loss (the
    schedule's backward, the shared leaves' parts summed over the stages
    and the data shards) equal the dense gradients for every stage's
    weights and the position embedding."""
    cfg = _cfg(n_layers=4)
    host = jax.device_get(jtr._init_params(jax.random.key(0),
                                           jtr.TransformerConfig(**cfg)))
    tokens, positions = _inputs()
    jcfg = jtr.TransformerConfig(**cfg)

    def dense_loss(p):
        h, _ = jtr._forward(p, jnp.asarray(tokens), jnp.asarray(positions), jcfg)
        return jnp.sum(h ** 2)

    g_dense = jax.grad(dense_loss)(host)
    got = _pipe_grads(cfg, host, tokens, positions)
    # the port's dense gradients of the same loss: the schedule's own error
    net = ttr.TransformerNet(host, ttr.TransformerConfig(**cfg), "cpu",
                             trainable=True)
    h = net(torch.from_numpy(tokens), torch.from_numpy(positions),
            causal_attention_reference)
    (h ** 2).sum().backward()
    for name, p in net.named_parameters():
        assert (got[name] - p.grad).abs().max() <= DENSE_GRAD_TOL * p.grad.abs().max()
    for li in (0, 3):
        np.testing.assert_allclose(got[f"layers.{li}.wo"].numpy(),
                                   np.asarray(g_dense["layers"][li]["wo"]),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
    for name, want in (("pos_emb", g_dense["pos_emb"]),
                       ("item_emb", g_dense["item_emb"]),
                       ("ln_f.g", g_dense["ln_f"]["g"])):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def test_remat_composes_with_pipeline():
    """test_pipeline.py:119: remat inside the stages preserves the
    gradients."""
    cfg = _cfg()
    host = jax.device_get(jtr._init_params(jax.random.key(0),
                                           jtr.TransformerConfig(**cfg)))
    tokens, positions = _inputs()
    g0 = _pipe_grads(cfg, host, tokens, positions)
    g1 = _pipe_grads({**cfg, "remat": True}, host, tokens, positions)
    for li in range(4):
        np.testing.assert_allclose(g1[f"layers.{li}.wq"].numpy(),
                                   g0[f"layers.{li}.wq"].numpy(),
                                   rtol=1e-4, atol=1e-5)


def _learn_seqs():
    rng = np.random.default_rng(0)
    seqs = np.zeros((32, 9), np.int32)
    for i in range(32):
        start = rng.integers(1, 40)
        seqs[i] = np.arange(start, start + 9) % 63 + 1
    return seqs


def test_pipeline_training_learns():
    """test_pipeline.py:112: fit over ``{"data": 2, "pipe": 4}``: each
    process holds its stage's layer, the loss beats chance, and the model
    is the canonical layout, served through the dense path."""
    cfg = ttr.TransformerConfig(**_cfg(epochs=30, learning_rate=5e-3,
                                       pipeline_microbatches=4))
    seqs = _learn_seqs()
    item_map = {f"i{t}": t for t in range(64)}
    models = ThreadMesh(AXES).run(
        lambda ctx: ttr.TransformerRecommender(cfg).fit(ctx, seqs, item_map))
    model = models[0]
    assert model.final_loss < 4.0  # ln(63) ≈ 4.14 is chance level
    assert len(model.params["layers"]) == 4  # unstacked for serving
    for other in models[1:]:
        for a, b in zip(ttr._leaves(model.params), ttr._leaves(other.params)):
            np.testing.assert_array_equal(a, b)
    assert model.timings["handoff_sec"] >= 0
    model.prepare_for_serving(CPU)
    scores = ttr.TransformerRecommender.next_item_scores(model, seqs[:2, :-1])
    assert scores.shape == (2, 64) and np.isfinite(scores).all()


def test_indivisible_dataset_is_padded():
    """test_pipeline.py:142: 10 rows with no relation to microbatches ×
    data train: the global batch rounds up to 16, the extra rows zero
    weight."""
    cfg = ttr.TransformerConfig(**_cfg(epochs=2, pipeline_microbatches=4,
                                       batch_size=16))
    seqs = np.random.default_rng(1).integers(1, 40, (10, 9)).astype(np.int32)
    models = ThreadMesh(AXES).run(
        lambda ctx: ttr.TransformerRecommender(cfg).fit(ctx, seqs, None))
    assert np.isfinite(models[0].final_loss)


def test_pipeline_validations(caplog):
    """test_pipeline.py:153's texts, before any collective; without a
    ``pipe`` axis ``pipeline_stages`` warns (the reference's text) and
    trains without pipelining."""
    ctx = DeviceContext(torch.device("cpu"), 0, 8, axes=AXES)
    rows = np.ones((8, 9), np.int32)
    rec = ttr.TransformerRecommender
    with pytest.raises(ValueError, match="must equal the pipe axis"):
        rec(ttr.TransformerConfig(**_cfg(pipeline_stages=2))).fit(ctx, rows, None)
    with pytest.raises(ValueError, match="divide into"):
        rec(ttr.TransformerConfig(**_cfg(n_layers=3))).fit(ctx, rows, None)
    with pytest.raises(ValueError, match="not with ring attention or MoE"):
        rec(ttr.TransformerConfig(**_cfg(n_experts=4))).fit(ctx, rows, None)
    with pytest.raises(ValueError, match="not with ring attention or MoE"):
        rec(ttr.TransformerConfig(**_cfg(attention="ring"))).fit(ctx, rows, None)
    with pytest.raises(ValueError, match=r"batch_size=12 must be a multiple of "
                       r"pipeline_microbatches × data axis \(4 × 2\)"):
        rec(ttr.TransformerConfig(**_cfg(batch_size=12))).fit(
            ctx, rows, None, rows_are_local=True)
    with caplog.at_level(logging.WARNING,
                         logger="incubator_predictionio_tpu_torch.models.transformer"):
        model = rec(ttr.TransformerConfig(**_cfg(
            vocab_size=16, n_layers=2, pipeline_stages=2, epochs=1))).fit(
            CPU, np.ones((8, 9), np.int32), None)
    assert np.isfinite(model.final_loss)
    assert ("pipeline_stages=2 requested but the mesh has no 'pipe' axis "
            "(mesh axes: ('data',)) — training runs without pipeline "
            "parallelism") in caplog.text


def _same_init(monkeypatch, cfg):
    init = _random_biases(ttr.init_params_numpy(ttr.TransformerConfig(**cfg), 5), 7)
    monkeypatch.setattr(jtr, "_jit_init_fn", lambda c: (
        lambda key: jax.tree.map(jnp.asarray, init)))
    monkeypatch.setattr(ttr, "_init_params", lambda c, generator, device: init)
    return init


def _update_rel(got, want, init):
    jflat, jtree = jax.tree.flatten(jax.tree.map(np.asarray, want))
    tflat, ttree = jax.tree.flatten(got)
    assert jtree == ttree  # the canonical layout, the reference's tree
    worst = 0.0
    for a, b, p0 in zip(tflat, jflat, jax.tree.flatten(init)[0]):
        moved = np.linalg.norm((b - p0).astype(np.float64))
        assert moved > 0  # every leaf trained
        worst = max(worst, np.linalg.norm((a - b).astype(np.float64)) / moved)
    return worst


def test_pipe_fit_matches_the_jax_fit_and_one_process(monkeypatch):
    """The port's ``{"data": 2, "pipe": 2}`` fit (threads as processes, 2
    layers a stage, 4 microbatches) against the JAX package's pipelined
    fit on ``{"data": 2, "pipe": 4}`` and against the port's one-process
    fit, from one initial tree with random biases and norms: every step's
    loss, the parameters in the canonical layout, the processes' models
    equal; a planted fault (every stage's shared gradients summed whole)
    misses the update band."""
    cfg = _cfg(n_layers=4, pipeline_stages=2, pipeline_microbatches=4,
               epochs=3, learning_rate=5e-3)
    init = _same_init(monkeypatch, cfg)
    seqs = _sequences()[:16]  # one batch: a step an epoch
    seqs[:5, :3] = 0
    axes = {"data": 2, "pipe": 2}
    models = ThreadMesh(axes).run(lambda ctx: ttr.TransformerRecommender(
        ttr.TransformerConfig(**cfg)).fit(ctx, seqs, None))
    got = models[0]
    for other in models[1:]:
        for a, b in zip(ttr._leaves(got.params), ttr._leaves(other.params)):
            np.testing.assert_array_equal(a, b)
    mesh = MeshContext.create(axes={"data": 2, "pipe": 4}, devices=jax.devices()[:8])
    for epochs in (1, 2, 3):
        want = jtr.TransformerRecommender(jtr.TransformerConfig(
            **{**cfg, "pipeline_stages": 4, "epochs": epochs})).fit(mesh, seqs, None)
        np.testing.assert_allclose(got.step_losses[epochs - 1, 0],
                                   want.final_loss, rtol=FIT_LOSS_RTOL,
                                   err_msg=f"step {epochs}")
    assert _update_rel(got.params, want.params, init) <= FIT_UPDATE_RTOL
    one = ttr.TransformerRecommender(ttr.TransformerConfig(**cfg)).fit(CPU, seqs, None)
    np.testing.assert_allclose(got.step_losses, one.step_losses, rtol=FIT_LOSS_RTOL)
    assert _update_rel(got.params, one.params, init) <= FIT_UPDATE_RTOL
    # the planted fault: the logits' part of the shared leaves' gradients
    # counted once a stage (every stage computing the loss, then the sum
    # over pipe)
    real = ttr.pipeline_grads

    def s_times(net, tokens, positions, pipe, head, attention):
        loss = real(net, tokens, positions, pipe, head, attention)
        if pipe.last:
            for p in (net.item_emb, net.ln_f.g, net.ln_f.b):
                p.grad *= pipe.size
        return loss

    monkeypatch.setattr(ttr, "pipeline_grads", s_times)
    bad = ThreadMesh(axes).run(lambda ctx: ttr.TransformerRecommender(
        ttr.TransformerConfig(**cfg)).fit(ctx, seqs, None))[0]
    assert _update_rel(bad.params, one.params, init) > FIT_UPDATE_RTOL
    assert np.max(np.abs(bad.step_losses - one.step_losses)
                  / one.step_losses) > FIT_LOSS_RTOL


def test_cli_launch_pipe_train_then_deploy(tmp_path):
    """``launch -n 2 train --mesh-axes '{"pipe": 2}'`` of the sequential
    template with ``pipelineStages`` 2: each process logs its stage and
    its layers, both read the same rows, the digests are equal, process 0
    persists the canonical layout, and the deployed model answers."""
    env, config = _store(tmp_path, "seq", APPS["seq"]())
    variant = tmp_path / "engine.json"
    variant.write_text(json.dumps({
        "id": "pipe", "version": "1",
        "engineFactory": "incubator_predictionio_tpu_torch.templates."
                         "sequential.SequentialEngine",
        "datasource": {"params": {"appName": "seq", "maxLen": 8}},
        "algorithms": [{"name": "transformer", "params": {
            "maxLen": 8, "dModel": 16, "nHeads": 2, "nLayers": 2,
            "batchSize": 16, "epochs": 3, "pipelineStages": 2,
            "pipelineMicrobatches": 4}}]}))
    out = subprocess.run(
        [sys.executable, "-m", "incubator_predictionio_tpu_torch.tools.cli",
         "launch", "-n", "2", "--cpu-devices-per-process", "1",
         "--coordinator-port", str(launcher.free_port()),
         "--timeout", str(LAUNCH_TIMEOUT), "train", "-v", str(variant),
         "--mesh-axes", '{"pipe": 2}'],
        capture_output=True, text=True, env=env, timeout=LAUNCH_TIMEOUT + 30)
    assert out.returncode == 0, out.stdout + out.stderr
    fits = sorted(line for line in out.stdout.splitlines()
                  if "pipeline fit: process" in line)
    assert len(fits) == 2
    for k, line in enumerate(fits):
        assert (f"pipe stage {k} of 2, layers [{k}, {k + 1}) of 2; 4 "
                "microbatches of 4 rows") in line
        assert int(re.search(r"\((\d+) bytes a step\)", line)[1]) > 0  # handoffs
    digests = {line.split("model digest ")[1].split(",")[0] for line in fits}
    assert len(digests) == 1
    storage = treg.Storage(config)
    try:
        (inst,) = storage.get_meta_data_engine_instances().get_all()
        assert inst.status == "COMPLETED"
        deployed = load_deployed_engine(ServerConfig(engine_variant=str(variant)),
                                        storage, ctx=CPU, warmup=False)
        model = deployed.models[0]
        assert len(model.params["layers"]) == 2
        assert model.params["layers"][1]["w1"].shape == (16, 64)
        algo = deployed.algorithms[0]
        algo._levents = type("Reads", (), {"find_by_entity": lambda *a, **k: []})()
        res = deployed.predict({"recentItems": ["i1", "i2", "i3"], "num": 3})
        assert len(res.item_scores) == 3
        assert all(np.isfinite(s.score) for s in res.item_scores)
    finally:
        storage.close()
