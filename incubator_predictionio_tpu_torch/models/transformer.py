"""Sequential-recommendation transformer — training and serving.

Counterpart of ``incubator_predictionio_tpu/models/transformer.py``
(SASRec/Transformer4Rec-style: a causal transformer over left-padded
session item sequences, next-item logits tied to the item embedding):
:class:`TransformerConfig`, the dense forward (``_ln``, ``_bf16_matmul``,
``_apply_layer``, ``_forward``, ``_serve_scores``) as one
:class:`TransformerNet` that serves (bf16 buffers) and trains (fp32
parameters), :class:`TransformerModel` and :class:`TransformerRecommender`
(``fit``, ``next_item_scores``). A training step is forward →
``ops/xent.py:weighted_xent_sum`` → backward through the attention
kernels' backwards → ``utils/optim.py`` adam (optax's); with
``checkpoint_dir`` the epochs run in chunks through
``utils/checkpoint.py:checkpointed_epochs``. Under several processes the
fit is data-parallel (:func:`train_step` over the global batch's
denominator, one all-reduce of the gradients a step), and its checkpoints
take the plain multi-process path (the primary writes, every process
waits). With ``tensor_parallel`` on a ``model`` mesh axis the fit is
Megatron's (reference :347-372, :542-581): each process holds its slice
of the column-parallel projections (``wq``, ``wk``, ``wv``, ``w1``, ``b1``,
split on the output dim, so its ``n_heads / tp`` heads and its share of
the FFN features) and of the row-parallel ones (``wo``, ``w2``, split on
the input dim), everything else replicated (:func:`shard_params`);
:class:`TensorParallel`'s pair of autograd functions puts one all-reduce
over ``model`` after each row-parallel projection in the forward and one
before each column-parallel input in the backward; the gradients are
all-reduced over ``data`` only; at the end the slices are gathered back
to the canonical per-layer layout (:func:`gather_params`), so persistence,
deploy and serving are unchanged. MoE, ring attention, pipeline
parallelism and tensor parallelism with checkpoints are the rest of the
parallel-axes slice (ROADMAP.md Queue 1, item 4.5) and raise until then.

Numerics follow the reference: every matmul rounds both operands and the
product to bf16 (``_bf16_matmul``), so served scores are bf16 values and
ties are common; layer norm has eps 1e-6 and the population variance;
``gelu`` is the tanh approximation (``jax.nn.gelu``'s default); left
padding is NOT masked (pad tokens attend and are attended to, at absolute
positions), exactly as in the reference.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from incubator_predictionio_tpu_torch.ops.xent import weighted_xent_sum
from incubator_predictionio_tpu_torch.parallel.mesh import (
    CollectiveClock,
    DeviceContext,
    check_replicas,
)
from incubator_predictionio_tpu_torch.parallel.ring import causal_attention
from incubator_predictionio_tpu_torch.utils.optim import adam_init, adam_update

logger = logging.getLogger(__name__)

#: what raises in the training options this slice does not port
SHARDING_SLICE = ("the parallel-axes slice of the PyTorch port (ROADMAP.md "
                  "Queue 1, item 4.5: the expert axis with MoE, the seq "
                  "axis, the pipe axis, tensor parallelism with checkpoints)")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Copy of the reference's config (transformer.py:44), every field, so a
    variant or a persisted config binds unchanged. Of the parallelism
    fields, ``tensor_parallel`` is ported; the others wait for the rest
    of the parallel-axes slice (ROADMAP.md Queue 1, item 4.5)."""

    vocab_size: int = 1024        # items + 1 (0 is padding)
    max_len: int = 64
    d_model: int = 64
    n_heads: int = 2
    n_layers: int = 2
    learning_rate: float = 1e-3
    batch_size: int = 256
    epochs: int = 10
    seed: int = 0
    attention: str = "auto"       # "auto" | "local" | "ring"
    n_experts: int = 0
    expert_capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2
    pipeline_stages: int = 0
    pipeline_microbatches: int = 0
    remat: bool = False
    adam_moments_dtype: str = "float32"
    tensor_parallel: bool = False
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    checkpoint_keep: int = 3


def init_params_numpy(cfg: TransformerConfig, seed: int) -> dict:
    """A dense parameter pytree at the reference's init scales
    (transformer.py:84 ``_init_params``: normal × 0.02 for the embeddings,
    × fan_in^-0.5 for the projections, ones/zeros for the norms and
    biases), drawn from ``numpy.random.default_rng(seed)`` — random
    weights for smoke runs and tests, the same arrays for both packages."""
    rng = np.random.default_rng(seed)
    d, dh = cfg.d_model, cfg.d_model * 4

    def init(shape, scale):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(scale))

    def norm():
        return {"g": np.ones(d, np.float32), "b": np.zeros(d, np.float32)}

    params = {"item_emb": init((cfg.vocab_size, d), 0.02),
              "pos_emb": init((cfg.max_len, d), 0.02),
              "ln_f": norm(), "layers": []}
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "ln1": norm(),
            "wq": init((d, d), d ** -0.5), "wk": init((d, d), d ** -0.5),
            "wv": init((d, d), d ** -0.5), "wo": init((d, d), d ** -0.5),
            "ln2": norm(),
            "w1": init((d, dh), d ** -0.5), "b1": np.zeros(dh, np.float32),
            "w2": init((dh, d), dh ** -0.5), "b2": np.zeros(d, np.float32),
        })
    return params


def _init_params(cfg: TransformerConfig, generator: torch.Generator,
                 device) -> dict:
    """transformer.py:84 ``_init_params``, dense: the reference's tree and
    init scales (normal × 0.02 for the embeddings, × fan_in^-0.5 for the
    projections, ones/zeros for the norms and biases), drawn from
    ``generator`` on ``device`` in the reference's key order."""
    d, dh = cfg.d_model, cfg.d_model * 4

    def init(shape, scale):
        return torch.randn(shape, generator=generator, device=device) * scale

    def norm():
        return {"g": torch.ones(d, device=device),
                "b": torch.zeros(d, device=device)}

    params = {"item_emb": init((cfg.vocab_size, d), 0.02),
              "pos_emb": init((cfg.max_len, d), 0.02),
              "ln_f": norm(), "layers": []}
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "ln1": norm(),
            "wq": init((d, d), d ** -0.5), "wk": init((d, d), d ** -0.5),
            "wv": init((d, d), d ** -0.5), "wo": init((d, d), d ** -0.5),
            "ln2": norm(),
            "w1": init((d, dh), d ** -0.5), "b1": torch.zeros(dh, device=device),
            "w2": init((dh, d), dh ** -0.5), "b2": torch.zeros(d, device=device),
        })
    return params


def _ln(x, g, b):
    """transformer.py:123: ``(x - mean) · rsqrt(var + 1e-6) · g + b`` with
    the population variance."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + 1e-6) * g + b


def _bf16_matmul(x, w):
    """transformer.py:129: both operands and the product in bf16 (the
    product accumulates in fp32 and rounds once), upcast to fp32. The cast
    of ``w`` is a no-op for the serving net's bf16 buffers."""
    return torch.matmul(x.to(torch.bfloat16), w.to(torch.bfloat16)).float()


def _put(module: nn.Module, name: str, a, device, trainable: bool,
         dtype=torch.float32) -> None:
    """An fp32 ``nn.Parameter`` when training, else a buffer in ``dtype``."""
    t = torch.as_tensor(a).to(device=device, dtype=torch.float32)
    if trainable:
        module.register_parameter(name, nn.Parameter(t.clone()))
    else:
        module.register_buffer(name, t.to(dtype))


class _Norm(nn.Module):
    """A layer norm's ``{"g", "b"}``."""

    def __init__(self, p: dict, device, trainable: bool):
        super().__init__()
        _put(self, "g", p["g"], device, trainable)
        _put(self, "b", p["b"], device, trainable)


_LAYER_MATRICES = ("wq", "wk", "wv", "wo", "w1", "w2")


class _Layer(nn.Module):
    """One dense transformer block's weights, the reference's
    ``layers[i]`` dict and names. Serving keeps them as buffers, the
    projections pre-rounded to bf16 (``_bf16_matmul`` rounds them on every
    call; rounding once at deploy gives the same values); training keeps
    fp32 parameters."""

    def __init__(self, layer: dict, device, trainable: bool = False):
        super().__init__()
        self.ln1 = _Norm(layer["ln1"], device, trainable)
        self.ln2 = _Norm(layer["ln2"], device, trainable)
        for name in _LAYER_MATRICES:
            _put(self, name, layer[name], device, trainable, torch.bfloat16)
        _put(self, "b1", layer["b1"], device, trainable)
        _put(self, "b2", layer["b2"], device, trainable)

    def forward(self, h, n_heads: int, attention: Callable,
                tp: Optional["TensorParallel"] = None):
        """transformer.py:196 ``_apply_layer``, the dense branch. With
        ``tp`` the block holds its slices (:func:`shard_params`): its
        ``n_heads / tp`` heads attend, the row-parallel products are
        summed over the ``model`` axis, and ``b2`` is added once, after
        that sum."""
        b, l, d = h.shape
        dh = d // n_heads
        x = _ln(h, self.ln1.g, self.ln1.b)
        if tp is not None:
            x = tp.copy(x)
            n_heads //= tp.size
        q = _bf16_matmul(x, self.wq).reshape(b, l, n_heads, dh)
        k = _bf16_matmul(x, self.wk).reshape(b, l, n_heads, dh)
        v = _bf16_matmul(x, self.wv).reshape(b, l, n_heads, dh)
        att = attention(q, k, v)
        o = _bf16_matmul(att.reshape(b, l, n_heads * dh), self.wo)
        h = h + (o if tp is None else tp.reduce(o))
        x = _ln(h, self.ln2.g, self.ln2.b)
        if tp is not None:
            x = tp.copy(x)
        x = F.gelu(_bf16_matmul(x, self.w1) + self.b1, approximate="tanh")
        y = _bf16_matmul(x, self.w2)
        return h + (y if tp is None else tp.reduce(y)) + self.b2


#: Megatron's placement (reference transformer.py:347-372): split on the
#: output dim (column parallel) and on the input dim (row parallel)
COLUMN_PARALLEL = ("wq", "wk", "wv", "w1", "b1")
ROW_PARALLEL = ("wo", "w2")


class _CopyToModel(torch.autograd.Function):
    """Megatron's ``f``: identity forward, the gradient all-reduced over
    ``model`` backward (before a column-parallel projection, whose input
    every process of the model line holds)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's ``g``: the partial products all-reduced over ``model``
    forward, identity backward (after a row-parallel projection)."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class TensorParallel:
    """The ``model`` line of a tensor-parallel fit: its size, this
    process's coordinate on it, and Megatron's pair of autograd functions
    over it (:meth:`copy`, :meth:`reduce`), their all-reduces timed by
    ``clock``."""

    def __init__(self, ctx, clock: Optional[CollectiveClock] = None):
        self.ctx = ctx
        self.size = ctx.axis_size("model")
        self.rank = ctx.axis_index("model")
        self.clock = clock

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        def run():
            return self.ctx.all_reduce_sum(t.contiguous(), axis="model")

        return run() if self.clock is None else self.clock.time(run)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToModel.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromModel.apply(x, self)


def shard_params(params: dict, shard: int, tp: int) -> dict:
    """Process ``shard``'s slice of a parameter tree under ``tp``-way
    tensor parallelism (the reference's
    ``_place_params_tensor_sharded``): the column-parallel leaves cut on
    their last dim, the row-parallel ones on their first, the rest whole."""
    def cut(name, a):
        if name in COLUMN_PARALLEL:
            n = a.shape[-1] // tp
            return a[..., shard * n:(shard + 1) * n]
        if name in ROW_PARALLEL:
            n = a.shape[0] // tp
            return a[shard * n:(shard + 1) * n]
        return a

    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: cut(k, v) for k, v in layer.items()}
                     for layer in params["layers"]]
    return out


def gather_params(ctx, params: dict) -> dict:
    """The canonical tree from every process's slices
    (:func:`shard_params`): each split leaf all-gathered over ``model``
    and joined in axis order (a collective), the rest as they are."""
    def join(name, a):
        if name not in COLUMN_PARALLEL + ROW_PARALLEL:
            return a
        parts = ctx.all_gather(torch.from_numpy(np.ascontiguousarray(a)),
                               axis="model").numpy()
        return np.concatenate(list(parts),
                              axis=-1 if name in COLUMN_PARALLEL else 0)

    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: join(k, v) for k, v in layer.items()}
                     for layer in params["layers"]]
    return out


#: rows a block of :func:`_scan_rows`: one product with a ``[64, 64]``
#: lower-triangular matrix of ones sums each block's prefixes
SCAN_BLOCK = 64


def _scan_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums down the rows of ``x`` ``[n, d]``, in one
    fixed order on every device and every run: within blocks of
    :data:`SCAN_BLOCK` rows, one batched product with the lower-triangular
    matrix of ones; the blocks' totals scanned the same way and added to
    the following blocks. (``torch.cumsum`` on the card sums in an order
    that varies from run to run.)"""
    n, d = x.shape
    c = SCAN_BLOCK
    nb = -(-n // c)
    if nb * c != n:
        x = torch.cat([x, x.new_zeros(nb * c - n, d)])
    tri = torch.ones(c, c, dtype=x.dtype, device=x.device).tril_()
    q = torch.matmul(tri, x.reshape(nb, c, d))
    if nb > 1:
        q[1:] += _scan_rows(q[:, -1])[:-1, None]
    return q.reshape(nb * c, d)[:n]


def _segment_sum_sorted(idx: torch.Tensor, rows: torch.Tensor, n: int
                       ) -> torch.Tensor:
    """``[n, d]``: the sum of ``rows`` ``[S, d]`` at each of ``idx`` ``[S]``,
    the same bytes every run. The indices are sorted stably, the rows
    summed down that order in float64 (:func:`_scan_rows`), and each
    index's sum taken as the difference of two prefixes (float64 leaves
    that difference well inside float32's rounding) and rounded to the
    rows' dtype; every row of an index writes that index's one sum, so
    which duplicate lands last does not matter. No host sync, no atomics."""
    keys, order = torch.sort(idx, stable=True)
    prefix = _scan_rows(rows.index_select(0, order).double())
    end = torch.searchsorted(keys, keys, right=True) - 1
    start = torch.searchsorted(keys, keys)
    before = torch.where((start > 0)[:, None],
                         prefix[(start - 1).clamp(min=0)], 0.0)
    out = rows.new_zeros((n, rows.shape[1]))
    out[keys] = (prefix[end] - before).to(rows.dtype)
    return out


class _Lookup(torch.autograd.Function):
    """``F.embedding`` whose backward is :func:`_segment_sum_sorted`.
    ``F.embedding``'s own backward on the card gave two runs of one
    training step different position-embedding gradients (each position
    repeats once a row); this one sums alike every run."""

    @staticmethod
    def forward(ctx, idx, table):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return F.embedding(idx, table)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return None, _segment_sum_sorted(idx.reshape(-1),
                                        g.reshape(-1, g.shape[-1]), ctx.rows)


def _lookup(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` at ``idx``: :class:`_Lookup` when a gradient
    is wanted, else ``F.embedding``."""
    if table.requires_grad and torch.is_grad_enabled():
        return _Lookup.apply(idx, table)
    return F.embedding(idx, table)


class TransformerNet(nn.Module):
    """The dense layer stack on one explicit device: buffers to serve, or
    (``trainable=True``) fp32 parameters to train. ``params`` is the
    reference's tree, of numpy arrays or tensors."""

    def __init__(self, params: dict, cfg: TransformerConfig, device,
                 trainable: bool = False,
                 tp: Optional[TensorParallel] = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp  # set: ``params`` are this process's slices
        _put(self, "item_emb", params["item_emb"], device, trainable)
        _put(self, "pos_emb", params["pos_emb"], device, trainable)
        self.ln_f = _Norm(params["ln_f"], device, trainable)
        self.layers = nn.ModuleList(_Layer(p, device, trainable)
                                    for p in params["layers"])
        if not trainable:
            self.register_buffer("item_emb_bf16", self.item_emb.to(torch.bfloat16))

    def forward(self, tokens, positions, attention: Callable = causal_attention):
        """transformer.py:218 ``_forward``: tokens, positions ``[B, L]``
        int → hidden ``[B, L, D]`` fp32 after the final norm. With
        ``cfg.remat`` and a gradient wanted, each block recomputes its
        activations in the backward (``jax.checkpoint``, :225-229). The
        lookups are :func:`_lookup`: its backward sums the rows of a
        repeated index (the padding token, every position) as one sorted
        float64 scan, the same bytes every run, where indexing's backward
        walks a repeated index's rows one by one."""
        h = _lookup(tokens, self.item_emb) + _lookup(positions, self.pos_emb)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                h = checkpoint(layer, h, self.cfg.n_heads, attention,
                               self.tp, use_reentrant=False)
            else:
                h = layer(h, self.cfg.n_heads, attention, self.tp)
        return _ln(h, self.ln_f.g, self.ln_f.b)

    def serve_scores(self, tokens, attention: Callable = causal_attention):
        """transformer.py:624 ``_serve_scores``: the newest (last) position's
        hidden state against the tied item embedding → ``[B, vocab]`` fp32
        (bf16 values). ``attention`` is the attention function; the default
        is the serving one, and a check may pass the plain version."""
        b, l = tokens.shape
        positions = torch.arange(l, device=tokens.device).expand(b, l)
        last = self.forward(tokens, positions, attention)[:, -1, :]
        return _bf16_matmul(last, self.item_emb_bf16.T)

    def params_numpy(self) -> dict:
        """The weights as the reference's tree of fp32 numpy arrays (one
        device-to-host copy of the whole model)."""
        flat = torch.cat([t.detach().float().reshape(-1)
                          for t in self._tree_tensors()]).cpu().numpy()
        arrays, off = [], 0
        for t in self._tree_tensors():
            arrays.append(flat[off:off + t.numel()].reshape(tuple(t.shape)).copy())
            off += t.numel()
        it = iter(arrays)

        def norm():
            return {"g": next(it), "b": next(it)}

        out = {"item_emb": next(it), "pos_emb": next(it), "ln_f": norm(),
               "layers": []}
        for _ in self.layers:
            layer = {"ln1": norm(), "ln2": norm()}
            layer.update({n: next(it) for n in (*_LAYER_MATRICES, "b1", "b2")})
            out["layers"].append(layer)
        return out

    def _tree_tensors(self) -> list:
        out = [self.item_emb, self.pos_emb, self.ln_f.g, self.ln_f.b]
        for layer in self.layers:
            out += [layer.ln1.g, layer.ln1.b, layer.ln2.g, layer.ln2.b]
            out += [getattr(layer, n) for n in (*_LAYER_MATRICES, "b1", "b2")]
        return out


def train_loss(net: TransformerNet, tokens, positions, targets, weights,
               attention: Callable = causal_attention, denom=None):
    """transformer.py:285 ``loss_fn``, dense: ``Σ w·xent / max(Σw, 1)``
    over the tied item embedding (the router's auxiliary loss is 0 without
    experts). ``denom`` replaces ``max(Σw, 1)``: a data-parallel step
    divides its local sum by the global batch's."""
    h = net(tokens, positions, attention)
    loss_sum = weighted_xent_sum(h.reshape(-1, h.shape[-1]), net.item_emb,
                                 targets.reshape(-1), weights.reshape(-1))
    if denom is None:
        denom = torch.clamp(weights.sum(), min=1.0)
    return loss_sum / denom


def train_step(net: TransformerNet, opt_state, batch, lr: float,
               attention: Callable = causal_attention, denom=None,
               all_reduce: Optional[Callable] = None):
    """One step (transformer.py:306 ``step``): loss, gradients, adam in
    place. ``batch`` is (tokens, positions, targets, weights) on the net's
    device. Returns the loss as a device scalar — no host sync. A
    data-parallel step passes the global batch's ``denom`` and
    ``all_reduce``, which sums the flattened gradients over the processes
    (the gradient of the global batch, the same bytes on every replica)."""
    params = list(net.parameters())
    loss = train_loss(net, *batch, attention=attention, denom=denom)
    grads = torch.autograd.grad(loss, params)
    if all_reduce is not None:
        flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]))
        grads = [g.view_as(p) for g, p in
                 zip(flat.split([p.numel() for p in params]), params)]
    adam_update(params, grads, opt_state, lr)
    return loss.detach()


def _leaves(tree):
    """The arrays of a parameter tree (dicts and lists) in its order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@dataclasses.dataclass
class TransformerModel:
    """Parameters (the reference's pytree as a dict of numpy arrays), the
    item map (id ↔ token, token 0 = padding) and the config. The arrays are
    what persists (the port's pickler turns tensors into numpy, so a
    pickled module would not come back as one); ``prepare_for_serving``
    builds the :class:`TransformerNet` on the serving device."""

    params: dict
    item_map: object
    config: TransformerConfig
    _net: Optional[TransformerNet] = dataclasses.field(
        default=None, repr=False, compare=False)

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_net"] = None  # serving state is rebuilt at deploy
        return state

    @property
    def device(self) -> Optional[torch.device]:
        return None if self._net is None else self._net.item_emb.device

    def prepare_for_serving(self, ctx: DeviceContext) -> "TransformerModel":
        """Build the layer stack on ``ctx.device``; on a card, build (or
        load) the attention kernels now, so that no query pays for nvcc."""
        if self.config.n_experts:
            raise NotImplementedError(
                f"serving a mixture-of-experts transformer (n_experts="
                f"{self.config.n_experts}) is not ported yet (ROADMAP.md "
                "Queue 1, item 4.5: expert parallelism and MoE serving)")
        if ctx.device.type == "cuda":
            from incubator_predictionio_tpu_torch.ops import _build

            _build.library("attention")
        self._net = TransformerNet(self.params, self.config, ctx.device)
        return self

    def warmup(self, max_batch: int = 64) -> int:
        """One forward at batch 1 at deploy (the card's first matmul
        initialises its libraries); returns the number of dispatches."""
        TransformerRecommender.next_item_scores(
            self, np.zeros((1, self.config.max_len), np.int32))
        return 1

    def serving_info(self) -> dict:
        return {"path": "device-params",
                "device": str(self.device),
                "vocab": self.config.vocab_size,
                "max_len": self.config.max_len}


class TransformerRecommender:
    def __init__(self, config: TransformerConfig):
        self.config = config

    def _tensor_parallel(self, ctx: DeviceContext) -> bool:
        """Whether the fit is tensor-parallel, with the reference's checks
        and texts (transformer.py:542-565): ``tensor_parallel`` on a mesh
        without a ``model`` axis records a degradation (once a key) and
        trains replicated; on one, the heads and the FFN hidden dim must
        split evenly over it, and neither the pipeline nor MoE may be
        asked for."""
        cfg = self.config
        engaged = cfg.tensor_parallel and ctx.axis_size_or("model") > 1
        if cfg.tensor_parallel and not engaged:
            from incubator_predictionio_tpu_torch.sharding.degrade import (
                record_axis_degradation,
            )

            record_axis_degradation(
                "transformer.tp", "model", "tensor_parallel",
                ctx.axis_names, "weights stay replicated")
        if engaged:
            tp = ctx.axis_size("model")
            if cfg.n_heads % tp or (4 * cfg.d_model) % tp:
                raise ValueError(
                    f"tensor parallelism needs n_heads ({cfg.n_heads}) and "
                    f"the FFN hidden dim ({4 * cfg.d_model}) divisible by "
                    f"the model axis ({tp})")
            if cfg.pipeline_stages or cfg.n_experts:
                raise ValueError(
                    "tensor parallelism composes with dp/sp, not with the "
                    "pipeline or MoE placements")
        return engaged

    def _refuse_unported(self, tensor_parallel: bool):
        cfg = self.config
        unported = [
            (cfg.attention == "ring", "ring attention (attention='ring')"),
            (cfg.n_experts > 0, f"mixture-of-experts (n_experts={cfg.n_experts})"),
            (cfg.pipeline_stages > 0,
             f"pipeline parallelism (pipeline_stages={cfg.pipeline_stages})"),
            (tensor_parallel and bool(cfg.checkpoint_dir)
             and cfg.checkpoint_every > 0,
             "tensor parallelism with checkpoints (checkpoint_dir)"),
        ]
        for hit, what in unported:
            if hit:
                raise NotImplementedError(
                    f"TransformerRecommender.fit: {what} is not ported yet; "
                    f"it comes with {SHARDING_SLICE}")

    def fit(self, ctx: DeviceContext, sequences: np.ndarray, item_map,
            rows_are_local: bool = False) -> TransformerModel:
        """transformer.py:423 ``fit`` on ``ctx.device``. sequences: ``[N,
        max_len+1]`` int token rows (0-padded on the left), each row a
        session; position t predicts position t+1. Batches are the rows in
        order (zero-weight zero rows pad the last), staged on the device
        once; one host sync for the whole fit (the final loss) without
        checkpoints, a save after every ``checkpoint_every`` epochs with
        them.

        ``ctx.process_count > 1``: data-parallel over the context's process
        group. ``rows_are_local=True``: the rows are only THIS process's
        session shard (tokens already global), staged by
        ``parallel/staging.py`` (reference :470-493; the resampled padding
        rows' weights zeroed); otherwise every process holds every row,
        stages the global batches and takes its slice of each. Each step
        runs forward and backward on the local batch over the GLOBAL
        batch's weight sum (gathered once at staging), so the processes'
        gradients sum to the single-process gradient of the global batch;
        one all-reduce of the flattened gradients, then the same adam on
        every replica. The replicas are proven equal at the end
        (:func:`~incubator_predictionio_tpu_torch.parallel.mesh.check_replicas`).
        The data-parallel axis is the mesh's ``data`` axis: the processes
        of a ``model`` line hold the same batches. With
        ``tensor_parallel`` on a ``model`` axis they split the weights
        (module docstring; :meth:`_tensor_parallel`)."""
        cfg = self.config
        tensor_parallel = self._tensor_parallel(ctx)
        self._refuse_unported(tensor_parallel)
        multi = ctx.process_count > 1
        dp = ctx.data_size > 1  # gradients all-reduced over the data axis
        sequences = np.asarray(sequences)
        tokens, targets = sequences[:, :-1], sequences[:, 1:]
        weights = (targets != 0).astype(np.float32) * (tokens != 0).astype(np.float32)
        n, l = tokens.shape
        if l != cfg.max_len:
            raise ValueError(f"sequences must be max_len+1 = {cfg.max_len + 1} wide")
        dev = ctx.device
        t_stage = time.perf_counter()
        if multi and rows_are_local:
            from incubator_predictionio_tpu_torch.parallel.staging import (
                stage_sharded_batches,
            )

            (tb, yb, wb), w_pad, _ = stage_sharded_batches(
                ctx, (tokens.astype(np.int32), targets.astype(np.int32),
                      weights), cfg.batch_size, cfg.seed)
            tb, yb = tb.long(), yb.long()
            # padding rows were resampled from real rows: zero their loss
            # weight through the staging weight column (:493)
            wb = wb * w_pad[..., None]
            staged_real = int(w_pad.sum())
        else:
            global_batch = ctx.pad_to_batch_multiple(min(cfg.batch_size, max(n, 1)))
            n_batches = max(1, -(-n // global_batch))
            pad = n_batches * global_batch - n
            cols = slice(None)
            if dp:  # the global batches' slice on the data axis
                b_local = global_batch // ctx.data_size
                cols = slice(ctx.data_index * b_local,
                             (ctx.data_index + 1) * b_local)

            def stage(a, dtype):
                a = np.concatenate([a, np.zeros((pad, l), a.dtype)])
                a = a.reshape(n_batches, global_batch, l)[:, cols]
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

            tb, yb = stage(tokens, torch.int64), stage(targets, torch.int64)
            wb = stage(weights, torch.float32)
            staged_real = None
        n_batches, b_rows = tb.shape[0], tb.shape[1]
        positions = torch.arange(l, device=dev).expand(b_rows, l)
        # each global batch's loss denominator, max(Σ w, 1), once: a sum of
        # 0/1 weights, exact in fp32 in any order
        denoms = (ctx.all_reduce_sum(wb.sum((1, 2)), axis="data")
                  .clamp(min=1.0) if dp else None)
        t_stage = time.perf_counter() - t_stage

        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        init = _init_params(cfg, generator, dev)
        clock = CollectiveClock(dev)
        tp_clock = CollectiveClock(dev)
        tp = None
        if tensor_parallel:  # every process draws the whole init, keeps its slice
            tp = TensorParallel(ctx, tp_clock)
            init = shard_params(init, tp.rank, tp.size)
        net = TransformerNet(init, cfg, dev, trainable=True, tp=tp)
        del init
        params = list(net.parameters())
        opt_state = adam_init(params, cfg.adam_moments_dtype)
        chunks = []  # [epochs, n_batches] step losses of each chunk run

        def all_reduce(t):
            return clock.time(lambda: ctx.all_reduce_sum(t, axis="data"))

        def train_epochs(p, o, n_epochs):
            # p is `params`: a restore copies into the net's own tensors
            losses = torch.zeros((n_epochs, n_batches), device=dev)
            for epoch in range(n_epochs):
                for i in range(n_batches):
                    losses[epoch, i] = train_step(
                        net, o, (tb[i], positions, yb[i], wb[i]),
                        cfg.learning_rate,
                        denom=denoms[i] if dp else None,
                        all_reduce=all_reduce if dp else None)
            if dp:  # the global step losses: the local ones summed once
                losses = clock.time(
                    lambda: ctx.all_reduce_sum(losses, axis="data"))
            chunks.append(losses)
            # the mean of the last epoch's step losses (transformer.py:314)
            return p, o, losses[-1].mean()

        from incubator_predictionio_tpu_torch.utils.checkpoint import (
            checkpointed_epochs,
        )

        t_train = time.perf_counter()
        # chunks of checkpoint_every epochs, resumed from checkpoint_dir's
        # latest step (transformer.py:587-596, which passes no dist hooks:
        # a multi-process fit, supervised or not, takes the plain path)
        _, _, loss = checkpointed_epochs(
            cfg.checkpoint_dir, cfg.checkpoint_every, cfg.checkpoint_keep,
            cfg.epochs, params, opt_state, train_epochs, ctx=ctx)
        final_loss = float(loss) if loss is not None else math.nan  # a sync
        t_train = time.perf_counter() - t_train
        t_gather = time.perf_counter()
        params = net.params_numpy()
        digest = None
        if tensor_parallel:
            # the replicated leaves equal on every process, each slice on
            # its data line; then the canonical layout from the slices
            split = [layer[k] for layer in params["layers"]
                     for k in COLUMN_PARALLEL + ROW_PARALLEL]
            whole = [a for a in _leaves(params)
                     if not any(a is b for b in split)]
            check_replicas(ctx, split, axis="data")
            check_replicas(ctx, whole)
            params = gather_params(ctx, params)
            digest = check_replicas(ctx, list(_leaves(params)))
        elif multi:
            digest = check_replicas(ctx, list(_leaves(params)))
        model = TransformerModel(params, item_map, cfg)
        model.final_loss = final_loss
        # the epochs this call ran (a resumed fit skips the restored ones)
        model.step_losses = (torch.cat(chunks).cpu().numpy() if chunks
                             else np.zeros((0, n_batches), np.float32))
        model.timings = {"train_sec": round(t_train, 4),
                         "gather_sec": round(time.perf_counter() - t_gather, 4)}
        if multi:
            exchange = clock.seconds() + tp_clock.seconds()
            n_steps = sum(len(c) for c in chunks) * n_batches  # epochs run
            model.timings.update(stage_sec=round(t_stage, 4),
                                 exchange_sec=round(exchange, 4))
            from incubator_predictionio_tpu_torch.ops.attention import (
                KERNEL_WRAPPERS,
            )

            peak = (torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else 0)
            launches = json.dumps({w.__name__: w.launches
                                   for w in KERNEL_WRAPPERS})
            if tensor_parallel:
                layer = net.layers[0]
                model.timings["exchange_model_sec"] = round(
                    tp_clock.seconds(), 4)
                logger.info(
                    "tensor-parallel fit: process %d of %d at %s (backend "
                    "%s, %s): %d of %d heads; wq %s, w1 %s, wo %s, w2 %s; %d "
                    "steps of %d local rows; stage %.3f s, train %.3f s, "
                    "exchange model %.3f ms a step, data %.3f ms a step; "
                    "loss %.6f; model digest %s, equal on every process; "
                    "peak device memory %d bytes; attention launches %s",
                    ctx.process_index, ctx.process_count,
                    json.dumps({n: ctx.axis_index(n) for n in ctx.axis_names}),
                    ctx.backend, dev, cfg.n_heads // tp.size, cfg.n_heads,
                    list(layer.wq.shape), list(layer.w1.shape),
                    list(layer.wo.shape), list(layer.w2.shape), n_steps,
                    b_rows, t_stage, t_train,
                    tp_clock.seconds() / max(n_steps, 1) * 1e3,
                    clock.seconds() / max(n_steps, 1) * 1e3, final_loss,
                    digest, peak, launches)
            else:
                logger.info(
                    "data-parallel fit: process %d of %d (backend %s, %s): "
                    "%d steps of %d local rows; stage %.3f s, train %.3f s, "
                    "exchange %.3f ms a step; loss %.6f; replica digest %s, "
                    "equal on every process; staged %d rows (%s real); peak "
                    "device memory %d bytes; attention launches %s",
                    ctx.process_index, ctx.process_count, ctx.backend, dev,
                    n_steps, b_rows, t_stage, t_train,
                    exchange / max(n_steps, 1) * 1e3, final_loss, digest,
                    n_batches * b_rows,
                    staged_real if staged_real is not None else "all", peak,
                    launches)
        return model

    @staticmethod
    def next_item_scores(model: TransformerModel, history_tokens: np.ndarray,
                         attention: Callable = causal_attention) -> np.ndarray:
        """history_tokens: ``[B, max_len]`` (left-padded) → ``[B, vocab]``
        fp32 scores. ``attention`` as in :meth:`TransformerNet.serve_scores`."""
        net = model._net
        if net is None:
            raise RuntimeError("TransformerModel.prepare_for_serving(ctx) "
                               "must run before scoring")
        tokens = torch.from_numpy(np.ascontiguousarray(history_tokens, np.int64))
        with torch.inference_mode():
            scores = net.serve_scores(tokens.to(model.device), attention)
            return scores.cpu().numpy()
