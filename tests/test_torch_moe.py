"""PyTorch port, the mixture-of-experts transformer on the CPU: the MoE
layer (``models/transformer.py:moe_ffn``) against the JAX package's
``_moe_ffn``, the routing semantics of tests/test_moe.py held to the JAX
package, one step's gradients against ``jax.grad``, and the fit in one
process, data-parallel over ``{"data": 2}`` and expert-parallel over
``{"expert": 2}`` and ``{"data": 2, "expert": 2}`` against the JAX fit on
the same mesh; ``DeviceContext.all_to_all`` over gloo, ``launch -n 2
train`` without axes, and ``launch -n 2 train --mesh-axes '{"expert": 2}'``
through the CLI, then deploy, query, ``batchpredict`` and ``eval``.

The in-process multi-process fits run the processes of a mesh as threads
(:class:`ExpertThreadMesh`, tests/test_torch_tensor_parallel.py's
``ThreadMesh`` with an all-to-all): each thread's context meets the others'
at a barrier in every collective and combines its line's objects in axis
order — what gloo's collectives compute, without the transport.

The multi-process fits run at capacity factor 0.5, where every layer drops
tokens: a process that routed with its local batch's capacity or its own
positions (not the global batch's, as the reference's jit sees it) keeps
other tokens and misses the bands.

Tolerances, with their reasons:
- the MoE layer against ``_moe_ffn`` on the same input: the routing (each
  token's expert and keep) equal, ``y`` bitwise and ``aux`` 1e-6 relative.
  Both packages compute the same bf16 products; the softmax's fp32 sums
  differ in order.
- the forward of a one-expert model against the dense one: 1e-4, the
  reference's own band (tests/test_moe.py:53).
- one step's gradients against ``jax.grad`` of the JAX loss: the loss 1e-5
  relative (measured 0); each leaf within 4e-3 of its max abs, one bf16
  step (2^-8) at the max (measured 1.02e-3, a ``wk``; the dense model
  reads 3.7e-4 in the same case): layer norm and gelu differ by fp32 ulps
  between the packages, and a cotangent rounded to the other neighbouring
  bf16 value moves an element by up to a bf16 step.
- the one-process fit against the JAX fit: every step's loss 1e-4 relative
  (measured at most 1.14e-5, at the third step; the dense fit's padded
  case has the same band), every parameter within 2·lr·steps, as
  tests/test_torch_sequential_training.py.
- the multi-process fits against the JAX fit on the same mesh, from one
  initial tree with random biases and norms: each epoch's mean step loss
  2e-4 relative (measured 1.7e-5 to 4.7e-5; the one-process fit of the
  same case 1.5e-5), every leaf within 0.4 of the JAX fit's update,
  ``‖p − p_jax‖ / ‖p_jax − p_0‖`` (measured 0.227 to 0.237; the
  one-process fit of the same case 0.253, a layer norm's gain: adam's
  first steps move an element by about ``lr·sign(g)``, so an element whose
  gradient is near 0 may step either way in either package, as
  tests/test_torch_tensor_parallel.py says). Faults planted in a copy of
  the port land above both bands' update reading: the capacity of the
  local batch 0.96 to 1.24 (and 4.4e-4 to 7.3e-4 in loss), positions
  counted from 1 0.56 to 0.88, the combine reading the next slot 1.24.
"""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from incubator_predictionio_tpu.models import transformer as jtr  # noqa: E402
from incubator_predictionio_tpu.ops import xent as jxent  # noqa: E402
from incubator_predictionio_tpu.parallel.mesh import MeshContext  # noqa: E402
from incubator_predictionio_tpu_torch import core as tcore  # noqa: E402
from incubator_predictionio_tpu_torch.data.storage import registry as treg  # noqa: E402
from incubator_predictionio_tpu_torch.models import transformer as ttr  # noqa: E402
from incubator_predictionio_tpu_torch.parallel import launcher  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext  # noqa: E402
from incubator_predictionio_tpu_torch.server.query_server import (  # noqa: E402
    ServerConfig,
    load_deployed_engine,
)
from incubator_predictionio_tpu_torch.sharding import degrade  # noqa: E402
from incubator_predictionio_tpu_torch.templates import sequential as tseq  # noqa: E402
from incubator_predictionio_tpu_torch.tools import cli  # noqa: E402

from tests.test_torch_dist_procs import _store  # noqa: E402
from tests.test_torch_evaluation import APPS  # noqa: E402
from tests.test_torch_tensor_parallel import ThreadMesh, _sequences  # noqa: E402

CPU = DeviceContext.create(device="cpu")
AUX_RTOL = 1e-6
DENSE_TOL = 1e-4
GRAD_TOL = 4e-3
LOSS_RTOL = 1e-5
FIT_LOSS_RTOL = 1e-4
MESH_LOSS_RTOL = 2e-4
MESH_UPDATE_RTOL = 0.4
LAUNCH_TIMEOUT = 120.0


def _cfg(**kw):
    base = dict(vocab_size=64, max_len=8, d_model=16, n_heads=2, n_layers=1,
                batch_size=16, epochs=2, seed=0, attention="local")
    base.update(kw)
    return base


def _t(a):
    return torch.from_numpy(np.array(a))


class ExpertThreadMesh(ThreadMesh):
    """:class:`ThreadMesh` whose contexts also exchange rows
    (``all_to_all``): each thread posts its rows and send splits, and takes
    from every process of its line, in axis order, the chunk addressed to
    its place on the line."""

    def context(self, index: int):
        member = super().context(index)
        group = self

        def all_to_all(t, send_splits, recv_splits, axis=None):
            line = group._line(index, axis)
            me = line.index(index)

            def take(posts):
                out = []
                for rows, send in posts:
                    start = int(sum(send[:me]))
                    out.append(rows[start:start + int(send[me])])
                return torch.cat(out)

            got = group._meet(index, (t.contiguous(), list(send_splits)),
                              axis, take)
            assert got.shape[0] == sum(recv_splits)
            return got

        member.all_to_all = all_to_all
        return member


def _random_biases(params, seed):
    """``params`` (a numpy tree) with every bias and layer norm drawn at
    random (the init's are zeros and ones, under which an expert bias on
    the wrong expert, or one cut on the wrong dim, cannot show)."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.array, params)

    def draw(shape, base):
        return (base + 0.2 * rng.standard_normal(shape)).astype(np.float32)

    for norm in [out["ln_f"]] + [layer[n] for layer in out["layers"]
                                 for n in ("ln1", "ln2")]:
        norm["g"], norm["b"] = draw(norm["g"].shape, 1.0), draw(norm["b"].shape, 0.0)
    for layer in out["layers"]:
        for name in ("be1", "be2", "b1", "b2"):
            if name in layer:
                layer[name] = draw(layer[name].shape, 0.0)
    return out


# -- the MoE layer ------------------------------------------------------------

def _layer_case(n_experts, factor, seed, pad_rows=1):
    cfg = _cfg(n_experts=n_experts, expert_capacity_factor=factor)
    params = ttr.init_params_numpy(ttr.TransformerConfig(**cfg), seed)
    layer = _random_biases(params, seed)["layers"][0]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((6, 8, 16)).astype(np.float32)
    tokens = rng.integers(1, 64, (6, 8))
    tokens[:pad_rows, :3] = 0  # left padding
    return cfg, layer, x, tokens


def _port_moe(layer, x, tokens, factor):
    return ttr.moe_ffn(_t(x), _t(tokens != 0), *(_t(layer[k]) for k in (
        "wr", "we1", "be1", "we2", "be2")), factor)


def _jax_routing(layer, x, tokens, cfg):
    """The reference's routing, spelled out from its ``_moe_ffn``
    (transformer.py:146-163): each token's expert and keep."""
    s, e = x.shape[0] * x.shape[1], cfg["n_experts"]
    capacity = max(1, int(cfg["expert_capacity_factor"] * s / e))
    probs = jax.nn.softmax(jtr._bf16_matmul(jnp.asarray(x.reshape(s, -1)),
                                            jnp.asarray(layer["wr"])), -1)
    chosen = jnp.argmax(probs, -1)
    onehot = jax.nn.one_hot(chosen, e) * jnp.asarray(
        tokens.reshape(s) != 0, jnp.float32)[:, None]
    pos = jnp.cumsum(onehot, 0) * onehot - onehot
    keep = ((pos < capacity) * onehot).sum(-1) > 0
    return np.asarray(chosen), np.asarray(keep)


@pytest.mark.parametrize("n_experts,factor", [(4, 1.25), (4, 0.5), (3, 1.0),
                                              (8, 0.25)])
def test_moe_layer_matches_the_jax_layer(n_experts, factor):
    """``moe_ffn`` against the JAX package's ``_moe_ffn`` on the same input
    (random biases, padding, and at the lower factors dropped tokens): the
    routing equal, ``y`` bitwise, ``aux`` within :data:`AUX_RTOL`."""
    cfg, layer, x, tokens = _layer_case(n_experts, factor, n_experts)
    y, aux, (chosen, keep) = _port_moe(layer, x, tokens, factor)
    want_y, want_aux = jtr._moe_ffn(
        jnp.asarray(x), jax.tree.map(jnp.asarray, layer),
        jtr.TransformerConfig(**cfg), None, jnp.asarray(tokens != 0))
    want_chosen, want_keep = _jax_routing(layer, x, tokens, cfg)
    mask = tokens.reshape(-1) != 0
    np.testing.assert_array_equal(chosen.numpy()[mask], want_chosen[mask])
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if factor < 1.0:
        assert 0 < keep.sum() < mask.sum()  # the capacity dropped tokens
    np.testing.assert_array_equal(y.numpy(), np.asarray(want_y))
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=AUX_RTOL)
    dropped = ~keep.numpy().reshape(6, 8)
    assert (y.numpy()[dropped] == 0).all()  # the residual path alone


def test_single_expert_matches_dense():
    """tests/test_moe.py:31 in the port: one expert with the dense FFN's
    weights (every token kept at gate 1.0) computes the dense layer; both
    held to the JAX package's forward of the same trees."""
    cfg_d, cfg_m = _cfg(), _cfg(n_experts=1, expert_capacity_factor=1.0)
    pd = ttr.init_params_numpy(ttr.TransformerConfig(**cfg_d), 0)
    pm = jax.tree.map(np.array, pd)
    for ld, lm in zip(pd["layers"], pm["layers"]):
        for k in ("w1", "b1", "w2", "b2"):
            del lm[k]
        lm.update(wr=np.ones((16, 1), np.float32), we1=ld["w1"][None],
                  be1=ld["b1"][None], we2=ld["w2"][None], be2=ld["b2"][None])
    tokens = np.asarray(jax.random.randint(jax.random.key(1), (4, 8), 1, 64))
    positions = np.broadcast_to(np.arange(8), (4, 8))
    got = {}
    for name, p, c in (("dense", pd, cfg_d), ("moe", pm, cfg_m)):
        net = ttr.TransformerNet(p, ttr.TransformerConfig(**c), "cpu",
                                 trainable=True)
        with torch.no_grad():
            h, aux = net.forward_with_aux(_t(tokens), _t(positions))
        want, want_aux = jtr._forward(jax.tree.map(jnp.asarray, p),
                                      jnp.asarray(tokens), jnp.asarray(positions),
                                      jtr.TransformerConfig(**c))
        np.testing.assert_allclose(h.numpy(), np.asarray(want), rtol=DENSE_TOL,
                                   atol=DENSE_TOL)
        assert float(aux) == pytest.approx(float(want_aux))
        got[name] = (h.numpy(), float(aux))
    np.testing.assert_allclose(got["moe"][0], got["dense"][0], rtol=DENSE_TOL,
                               atol=DENSE_TOL)
    assert got["dense"][1] == 0.0
    assert got["moe"][1] == pytest.approx(1.0)  # E · (1.0 · 1.0)


def test_padding_tokens_do_not_route():
    """tests/test_moe.py:59 in the port: rows of pure padding claim no
    slots and leave the auxiliary loss as it was; both packages alike."""
    cfg = _cfg(n_experts=2, expert_capacity_factor=1.0)
    params = ttr.init_params_numpy(ttr.TransformerConfig(**cfg), 0)
    real = np.asarray(jax.random.randint(jax.random.key(2), (2, 8), 1, 64))
    padded = np.concatenate([real, np.zeros((2, 8), real.dtype)])
    positions = np.broadcast_to(np.arange(8), (4, 8))
    net = ttr.TransformerNet(params, ttr.TransformerConfig(**cfg), "cpu")
    with torch.no_grad():
        _, aux_all = net.forward_with_aux(_t(padded), _t(positions))
        _, aux_real = net.forward_with_aux(_t(real), _t(positions[:2]))
    assert float(aux_all) == pytest.approx(float(aux_real), rel=1e-4)
    for tokens, aux in ((padded, aux_all), (real, aux_real)):
        _, want = jtr._forward(jax.tree.map(jnp.asarray, params),
                               jnp.asarray(tokens),
                               jnp.asarray(positions[:len(tokens)]),
                               jtr.TransformerConfig(**cfg))
        np.testing.assert_allclose(float(aux), float(want), rtol=AUX_RTOL)


def test_capacity_drops_overflow_tokens():
    """tests/test_moe.py:74 in the port: at one slot an expert (factor
    0.01) at most one token an expert is kept, the rest contribute 0 (the
    residual path), the first token of each expert in token order wins;
    the layer's output equal to the JAX package's."""
    cfg = _cfg(n_experts=2, expert_capacity_factor=0.01)
    params = ttr.init_params_numpy(ttr.TransformerConfig(**cfg), 0)
    tokens = np.ones((2, 8), np.int64)
    positions = np.broadcast_to(np.arange(8), (2, 8))
    net = ttr.TransformerNet(params, ttr.TransformerConfig(**cfg), "cpu")
    with torch.no_grad():
        h, aux = net.forward_with_aux(_t(tokens), _t(positions))
    assert np.isfinite(h.numpy()).all() and float(aux) > 0
    layer = params["layers"][0]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    y, _, (chosen, keep) = _port_moe(layer, x, tokens, 0.01)
    assert 1 <= int(keep.sum()) <= 2
    for e in chosen.unique():
        first = int(np.flatnonzero(chosen.numpy() == int(e))[0])
        assert keep[first] and int(keep[chosen == e].sum()) == 1
    want, _ = jtr._moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, layer),
                           jtr.TransformerConfig(**cfg), None,
                           jnp.asarray(tokens != 0))
    np.testing.assert_array_equal(y.numpy(), np.asarray(want))


def test_expert_count_must_divide_axis():
    """tests/test_moe.py:142's text, before any collective."""
    ctx = DeviceContext(torch.device("cpu"), 0, 8, axes={"data": 2, "expert": 4})
    with pytest.raises(ValueError, match="must divide evenly over the expert "
                                         r"axis \(4 devices\)"):
        ttr.TransformerRecommender(ttr.TransformerConfig(**_cfg(n_experts=6))).fit(
            ctx, np.ones((8, 9), np.int32), None)


def test_moe_refusals_keep_the_reference_texts():
    """Tensor parallelism with MoE and the pipeline with MoE raise the
    reference's ValueErrors, before any collective."""
    rows = np.ones((8, 9), np.int32)
    tp = DeviceContext(torch.device("cpu"), 0, 2, axes={"model": 2})
    with pytest.raises(ValueError, match="not with the pipeline or MoE"):
        ttr.TransformerRecommender(ttr.TransformerConfig(**_cfg(
            n_experts=2, tensor_parallel=True))).fit(tp, rows, None)
    pipe = DeviceContext(torch.device("cpu"), 0, 2, axes={"pipe": 2})
    with pytest.raises(ValueError, match="not with ring attention or MoE"):
        ttr.TransformerRecommender(ttr.TransformerConfig(**_cfg(
            n_experts=2, pipeline_stages=2, n_layers=2))).fit(pipe, rows, None)


class _NcclStub:
    """A context whose group is NCCL's, which takes no host tensor: its
    ``all_gather`` asserts that the tensor lies on the context's device
    ("meta" stands in for the card) and returns ``size`` blocks, block k
    filled with k."""

    backend = "nccl"
    device = torch.device("meta")

    def __init__(self, size):
        self.size, self.axes = size, []

    def all_gather(self, t, axis=None):
        assert t.device == self.device, f"a tensor on {t.device} for NCCL"
        self.axes.append(axis)
        return torch.stack([torch.full(t.shape, float(k))
                            for k in range(self.size)])


@pytest.mark.parametrize("axis", ["expert", "model"])
def test_gathers_stage_on_the_context_device(axis):
    """``gather_experts`` and ``gather_params`` hand the collective
    tensors on ``ctx.device`` (an NCCL group rejects host tensors) and join
    the blocks in axis order into the canonical shapes; the other leaves
    stay as they are, ungathered."""
    moe = axis == "expert"
    cfg = ttr.TransformerConfig(**_cfg(n_experts=4 if moe else 0))
    params = ttr.init_params_numpy(cfg, 3)
    split = ttr.EXPERT_LEAVES if moe else ttr.COLUMN_PARALLEL + ttr.ROW_PARALLEL
    ctx = _NcclStub(2)
    if moe:
        got = ttr.gather_experts(ctx, ttr.shard_experts(params, 0, 2))
    else:
        got = ttr.gather_params(ctx, ttr.shard_params(params, 0, 2))
    n = sum(k in split for k in params["layers"][0])
    assert ctx.axes == [axis] * n * cfg.n_layers
    for layer, want in zip(got["layers"], params["layers"]):
        for name, a in layer.items():
            if name not in split:
                assert a is want[name]
                continue
            assert a.shape == want[name].shape
            dim = -1 if name in ttr.COLUMN_PARALLEL else 0
            for k, block in enumerate(np.split(a, 2, axis=dim)):
                assert (block == k).all()
    assert got["item_emb"] is params["item_emb"]


# -- one step, one process --------------------------------------------------

def _jax_loss(cfg):
    jcfg = jtr.TransformerConfig(**cfg)

    def loss(p, tokens, positions, targets, weights):
        h, aux = jtr._forward(p, tokens, positions, jcfg)
        task = jxent.weighted_xent_sum(
            h.reshape(-1, h.shape[-1]), p["item_emb"], targets.reshape(-1),
            weights.reshape(-1)) / jnp.maximum(jnp.sum(weights), 1.0)
        return task + jcfg.router_aux_weight * aux

    return loss


def test_step_gradients_match_jax_grad():
    """One step's loss and gradients (the router's and the experts'
    included) against ``jax.grad`` of the JAX package's loss (its
    ``loss_fn``, transformer.py:285-299) on the same tree and batch, at a
    factor that drops tokens."""
    cfg = _cfg(n_experts=4, expert_capacity_factor=0.75, n_layers=2)
    params = _random_biases(ttr.init_params_numpy(ttr.TransformerConfig(**cfg), 2), 3)
    seqs = _sequences()[:12]
    seqs[:3, :4] = 0
    tokens, targets = seqs[:, :-1], seqs[:, 1:]
    weights = ((targets != 0) & (tokens != 0)).astype(np.float32)
    positions = np.broadcast_to(np.arange(8), tokens.shape)
    batch = [np.ascontiguousarray(a) for a in (tokens, positions, targets, weights)]
    want_loss, want = jax.value_and_grad(_jax_loss(cfg))(
        jax.tree.map(jnp.asarray, params), *map(jnp.asarray, batch))
    net = ttr.TransformerNet(params, ttr.TransformerConfig(**cfg), "cpu",
                             trainable=True)
    tb = [_t(a).long() for a in batch[:3]] + [_t(batch[3])]
    loss = ttr.train_loss(net, *tb, attention=ttr.causal_attention)
    grads = dict(zip([id(p) for p in net._tree_tensors()],
                     torch.autograd.grad(loss, net._tree_tensors())))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_RTOL)
    got_tree = _tree_of(net, {k: v.numpy() for k, v in grads.items()})
    jflat, jtree = jax.tree.flatten(jax.tree.map(np.asarray, want))
    tflat, ttree = jax.tree.flatten(got_tree)
    assert jtree == ttree
    for a, b in zip(tflat, jflat):
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a, b, rtol=0, atol=GRAD_TOL * np.abs(b).max())


def _tree_of(net, by_id):
    """The reference's tree of ``net``'s leaves, each ``by_id[id(leaf)]``."""
    it = iter(by_id[id(t)] for t in net._tree_tensors())

    def norm():
        return {"g": next(it), "b": next(it)}

    out = {"item_emb": next(it), "pos_emb": next(it), "ln_f": norm(), "layers": []}
    for layer in net.layers:
        leaves = {"ln1": norm(), "ln2": norm()}
        leaves.update({n: next(it) for n in ttr.layer_leaf_names(layer.moe)})
        out["layers"].append(leaves)
    return out


@pytest.fixture()
def same_init(monkeypatch):
    """Both packages start from one MoE tree with random biases and norms."""
    def install(cfg):
        init = _random_biases(ttr.init_params_numpy(
            ttr.TransformerConfig(**cfg), 5), 7)
        monkeypatch.setattr(jtr, "_jit_init_fn", lambda c: (
            lambda key: jax.tree.map(jnp.asarray, init)))
        monkeypatch.setattr(ttr, "_init_params",
                            lambda c, generator, device: init)
        return init

    return install


def test_one_process_fit_matches_the_jax_fit(same_init):
    """One batch for 3 epochs from one init: every step's loss and every
    parameter of the port's MoE fit against the JAX package's (one
    device); the degradation recorded, as the reference's."""
    cfg = _cfg(n_experts=4, n_layers=2, epochs=3, learning_rate=1e-3)
    init = same_init(cfg)
    seqs = _sequences()[:16]
    degrade.reset()
    got = ttr.TransformerRecommender(ttr.TransformerConfig(**cfg)).fit(CPU, seqs, None)
    assert [d["axis"] for d in degrade.degradations()] == ["expert"]
    degrade.reset()
    for epochs in (1, 2, 3):
        want = jtr.TransformerRecommender(jtr.TransformerConfig(
            **{**cfg, "epochs": epochs})).fit(MeshContext.create(devices=jax.devices()[:1]),
                                               seqs, None)
        np.testing.assert_allclose(got.step_losses[epochs - 1, 0],
                                   want.final_loss, rtol=FIT_LOSS_RTOL,
                                   err_msg=f"step {epochs}")
    jflat, jtree = jax.tree.flatten(jax.tree.map(np.asarray, want.params))
    tflat, ttree = jax.tree.flatten(got.params)
    assert jtree == ttree
    band = 2 * cfg["learning_rate"] * cfg["epochs"]
    for a, b, p0 in zip(jflat, tflat, jax.tree.flatten(init)[0]):
        np.testing.assert_allclose(b, a, rtol=0, atol=band)
        assert np.abs(b - p0).max() > 0  # every leaf trained


def test_remat_and_checkpoints_give_the_same_fit(same_init, tmp_path):
    """A MoE block recomputed in the backward (``remat``) trains to the same
    bytes; a one-process MoE fit checkpointed each epoch (the plain path)
    too."""
    cfg = _cfg(n_experts=4, n_layers=2, epochs=2)
    same_init(cfg)
    seqs = _sequences()[:16]
    plain = ttr.TransformerRecommender(ttr.TransformerConfig(**cfg)).fit(CPU, seqs, None)
    for extra in ({"remat": True},
                  {"checkpoint_dir": str(tmp_path / "ck"), "checkpoint_every": 1}):
        other = ttr.TransformerRecommender(ttr.TransformerConfig(**cfg, **extra)).fit(
            CPU, seqs, None)
        assert other.final_loss == plain.final_loss
        for a, b in zip(ttr._leaves(other.params), ttr._leaves(plain.params)):
            np.testing.assert_array_equal(a, b)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir())


# -- several processes -------------------------------------------------------

MESHES = [{"data": 2}, {"expert": 2}, {"data": 2, "expert": 2}]


@pytest.mark.parametrize("axes", MESHES, ids=["data2", "expert2", "data2-expert2"])
def test_multi_process_fit_matches_the_jax_fit(axes, same_init):
    """The MoE fit over ``axes`` (threads as processes) against the JAX
    package's fit on its mesh of the same axes (the first ``prod(axes)`` of
    tests/conftest.py's 8 CPU devices), from one initial tree with random
    biases and norms, at capacity factor 0.5: each epoch's mean step loss,
    the parameters in the canonical layout, the processes' models equal;
    on an ``expert`` axis each process holds its half of the experts."""
    cfg = _cfg(n_experts=4, n_layers=2, epochs=2, learning_rate=5e-3,
               expert_capacity_factor=0.5)
    init = same_init(cfg)
    seqs = _sequences()
    seqs[:6, :3] = 0
    n = int(np.prod(list(axes.values())))
    shapes = {}
    real_init = ttr.TransformerNet.__init__

    def spy(self, params, c, device, trainable=False, tp=None, experts=None):
        real_init(self, params, c, device, trainable, tp, experts)
        if experts is not None:
            shapes[experts.ctx.process_index] = (
                experts.first, tuple(self.layers[0].we1.shape),
                tuple(self.layers[0].be2.shape))

    ttr.TransformerNet.__init__ = spy
    try:
        models = ExpertThreadMesh(axes).run(lambda ctx: ttr.TransformerRecommender(
            ttr.TransformerConfig(**cfg)).fit(ctx, seqs, None))
    finally:
        ttr.TransformerNet.__init__ = real_init
    ep = axes.get("expert", 1)
    assert len(shapes) == n
    for rank, (first, we1, be2) in shapes.items():
        assert we1 == (4 // ep, 16, 64) and be2 == (4 // ep, 16)
        coord = rank % ep if ep > 1 else 0
        assert first == coord * (4 // ep)
    got = models[0]
    for other in models[1:]:
        for a, b in zip(ttr._leaves(got.params), ttr._leaves(other.params)):
            np.testing.assert_array_equal(a, b)
    mesh = MeshContext.create(axes=axes, devices=jax.devices()[:n])
    for epochs in (1, 2):
        want = jtr.TransformerRecommender(jtr.TransformerConfig(
            **{**cfg, "epochs": epochs})).fit(mesh, seqs, None)
        np.testing.assert_allclose(got.step_losses[epochs - 1].mean(),
                                   want.final_loss, rtol=MESH_LOSS_RTOL,
                                   err_msg=f"epoch {epochs}")
    jflat, jtree = jax.tree.flatten(jax.tree.map(np.asarray, want.params))
    tflat, ttree = jax.tree.flatten(got.params)
    assert jtree == ttree  # the canonical layout, the reference's tree
    for a, b, p0 in zip(tflat, jflat, jax.tree.flatten(init)[0]):
        assert a.shape == b.shape
        moved = np.linalg.norm((b - p0).astype(np.float64))
        assert moved > 0
        assert np.linalg.norm((a - b).astype(np.float64)) <= MESH_UPDATE_RTOL * moved


def _a2a_worker(rank, port, out):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    try:
        ctx = DeviceContext(torch.device("cpu"), rank, 2, "gloo",
                            {"expert": 2})
        send = [[2, 3], [1, 0]][rank]
        recv = [[2, 1], [3, 0]][rank]
        rows = (torch.arange(sum(send) * 4, dtype=torch.float32).reshape(-1, 4)
                + 100 * rank).to(torch.bfloat16)
        got = ctx.all_to_all(rows, send, recv, axis="expert")
        out.put((rank, got.dtype == torch.bfloat16, got.float().tolist()))
    finally:
        dist.destroy_process_group()


def test_all_to_all_over_gloo():
    """``DeviceContext.all_to_all`` between two gloo processes: uneven and
    empty splits, bf16 rows, in axis order; one process is a copy; splits
    that do not cover the rows raise."""
    import torch.multiprocessing as mp

    queue = mp.get_context("spawn").SimpleQueue()
    port = launcher.free_port()
    mp.start_processes(_a2a_worker, args=(port, queue), nprocs=2,
                       start_method="spawn")
    got = dict((r, (bf, rows)) for r, bf, rows in (queue.get(), queue.get()))
    r0 = [[float(4 * i + j) for j in range(4)] for i in range(5)]
    r1 = [[float(100 + j) for j in range(4)]]
    assert got[0] == (True, r0[:2] + r1)
    assert got[1] == (True, r0[2:5])
    t = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(CPU.all_to_all(t, [3], [3]), t)
    with pytest.raises(ValueError, match="splits"):
        CPU.all_to_all(t, [2], [2])


def test_cli_launch_expert_parallel_train_then_deploy(tmp_path):
    """``launch -n 2 train --mesh-axes '{"expert": 2}'`` of the sequential
    template with ``numExperts`` 4: each process logs its two experts and
    their shapes and the all-to-all's bytes, the digests are equal, process
    0 persists the canonical layout, and the deployed model answers; then
    ``batchpredict`` on it and ``eval`` of a MoE variant through the CLI."""
    env, config = _store(tmp_path, "seq", APPS["seq"]())
    variant = tmp_path / "engine.json"
    variant.write_text(json.dumps({
        "id": "moe", "version": "1",
        "engineFactory": "incubator_predictionio_tpu_torch.templates."
                         "sequential.SequentialEngine",
        "datasource": {"params": {"appName": "seq", "maxLen": 8}},
        "algorithms": [{"name": "transformer", "params": {
            "maxLen": 8, "dModel": 16, "nHeads": 2, "nLayers": 2,
            "batchSize": 16, "epochs": 3, "numExperts": 4}}]}))
    out = subprocess.run(
        [sys.executable, "-m", "incubator_predictionio_tpu_torch.tools.cli",
         "launch", "-n", "2", "--cpu-devices-per-process", "1",
         "--coordinator-port", str(launcher.free_port()),
         "--timeout", str(LAUNCH_TIMEOUT), "train", "-v", str(variant),
         "--mesh-axes", '{"expert": 2}'],
        capture_output=True, text=True, env=env, timeout=LAUNCH_TIMEOUT + 30)
    assert out.returncode == 0, out.stdout + out.stderr
    fits = [line for line in out.stdout.splitlines()
            if "expert-parallel fit: process" in line]
    assert len(fits) == 2
    for k, line in enumerate(sorted(fits)):
        assert (f"experts [{2 * k}, {2 * k + 2}) of 4; we1 [2, 16, 64], "
                "be1 [2, 64], we2 [2, 64, 16], be2 [2, 16]") in line
        assert int(line.split("(")[3].split(" bytes")[0]) > 0  # all-to-all bytes
    digests = {line.split("model digest ")[1].split(",")[0] for line in fits}
    assert len(digests) == 1
    storage = treg.Storage(config)
    try:
        (inst,) = storage.get_meta_data_engine_instances().get_all()
        assert inst.status == "COMPLETED"
        deployed = load_deployed_engine(ServerConfig(engine_variant=str(variant)),
                                        storage, ctx=CPU, warmup=False)
        model = deployed.models[0]
        assert model.params["layers"][0]["we1"].shape == (4, 16, 64)
        assert model.serving_info()["n_experts"] == 4
        algo = deployed.algorithms[0]
        algo._levents = type("Reads", (), {"find_by_entity": lambda *a, **k: []})()
        res = deployed.predict({"recentItems": ["i1", "i2", "i3"], "num": 3})
        assert len(res.item_scores) == 3
        assert all(np.isfinite(s.score) for s in res.item_scores)
        # the other workflow verbs with numExperts, in this process on the
        # same store: batchpredict on the persisted model, eval of a MoE
        # variant (one-process fits of each fold)
        queries = tmp_path / "q.json"
        queries.write_text("\n".join(json.dumps(
            {"recentItems": [f"i{j}", f"i{j + 1}"], "num": 2}) for j in range(5)))
        prev = treg.use_storage(storage)
        try:
            assert cli.main(["batchpredict", "--input", str(queries), "--output",
                             str(tmp_path / "p.json"), "-v", str(variant),
                             "--device", "cpu"]) == 0
            assert cli.main(["eval", f"{__name__}:MoEEvaluation",
                             "--device", "cpu"]) == 0
        finally:
            treg.use_storage(prev)
        lines = (tmp_path / "p.json").read_text().splitlines()
        assert len(lines) == 5
        assert all(len(json.loads(x)["itemScores"]) == 2 for x in lines)
        (evaluation,) = storage.get_meta_data_evaluation_instances().get_all()
        assert evaluation.status == "EVALCOMPLETED"
        assert "HitRate@K" in evaluation.evaluator_results
    finally:
        storage.close()


def test_cli_launch_data_parallel_moe_train(tmp_path):
    """``launch -n 2 train`` without axes (``{"data": 2}``) of the
    sequential template with ``numExperts`` 4, real gloo processes: each
    holds every expert, the routing the global batch's (its counts
    all-gathered), the replicas equal, the degradation warned once in each
    process, and the persisted model the canonical layout."""
    env, config = _store(tmp_path, "seq", APPS["seq"]())
    variant = tmp_path / "engine.json"
    variant.write_text(json.dumps({
        "id": "moe-dp", "version": "1",
        "engineFactory": "incubator_predictionio_tpu_torch.templates."
                         "sequential.SequentialEngine",
        "datasource": {"params": {"appName": "seq", "maxLen": 8}},
        "algorithms": [{"name": "transformer", "params": {
            "maxLen": 8, "dModel": 16, "nHeads": 2, "nLayers": 1,
            "batchSize": 16, "epochs": 2, "numExperts": 4}}]}))
    out = subprocess.run(
        [sys.executable, "-m", "incubator_predictionio_tpu_torch.tools.cli",
         "launch", "-n", "2", "--cpu-devices-per-process", "1",
         "--coordinator-port", str(launcher.free_port()),
         "--timeout", str(LAUNCH_TIMEOUT), "train", "-v", str(variant)],
        capture_output=True, text=True, env=env, timeout=LAUNCH_TIMEOUT + 30)
    assert out.returncode == 0, out.stdout + out.stderr
    fits = [line for line in out.stdout.splitlines()
            if "data-parallel fit: process" in line]
    assert len(fits) == 2
    assert len({line.split("replica digest ")[1].split(",")[0] for line in fits}) == 1
    assert out.stdout.count("n_experts=4 requested but the mesh has no 'expert' axis") == 2
    storage = treg.Storage(config)
    try:
        (inst,) = storage.get_meta_data_engine_instances().get_all()
        deployed = load_deployed_engine(ServerConfig(engine_variant=str(variant)),
                                        storage, ctx=CPU, warmup=False)
        assert inst.status == "COMPLETED"
        assert deployed.models[0].params["layers"][0]["we1"].shape == (4, 16, 64)
    finally:
        storage.close()


class MoEEvaluation(tseq.SequentialEvaluation):
    """SequentialEvaluation on the launch test's ``seq`` app with one
    mixture-of-experts variant, 2 folds."""

    def __init__(self):
        super().__init__(app_name="seq", eval_k=2)
        self.engine_params_list = [tcore.EngineParams.create(
            data_source=tseq.DataSourceParams(app_name="seq", max_len=8, eval_k=2),
            algorithms=[("transformer", tseq.TransformerAlgorithmParams(
                app_name="seq", max_len=8, d_model=16, n_layers=1, epochs=2,
                batch_size=16, num_experts=4))])]


def test_expert_parallel_training_learns():
    """tests/test_moe.py:86 in the port: over ``{"data": 2, "expert": 2}``
    the successor structure is learned below chance level."""
    cfg = ttr.TransformerConfig(**_cfg(n_experts=4, epochs=30, learning_rate=5e-3))
    model = ExpertThreadMesh({"data": 2, "expert": 2}).run(
        lambda ctx: ttr.TransformerRecommender(cfg).fit(
            ctx, _sequences(), {f"i{t}": t for t in range(64)}))[0]
    assert np.isfinite(model.final_loss)
    assert model.final_loss < 4.0  # ln(63) ≈ 4.14 is chance level
    model.prepare_for_serving(CPU)
    scores = ttr.TransformerRecommender.next_item_scores(model, _sequences()[:2, :-1])
    assert scores.shape == (2, 64) and np.isfinite(scores).all()
    assert dataclasses.asdict(model.config)["n_experts"] == 4
