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
deploy and serving are unchanged.

With ``n_experts`` a layer's FFN is the reference's Switch-style top-1
mixture of experts (:func:`moe_ffn`, reference :133-193): the router's
bf16 logits, an fp32 softmax, each real token sent to its argmax expert
up to the capacity ``max(1, int(factor · S / E))`` of the global batch's
S tokens, in token order; the overflow and the padding fall through on
the residual. The dispatch and the combine are one-to-one row moves
(:class:`_Rows`), so their backwards repeat no index and need no atomics.
Under several processes the routing is the global batch's
(:class:`ExpertParallel`): one all-gather of each process's per-expert
counts a layer gives every process its tokens' global positions, the
capacity's drops and the auxiliary loss's statistics. With an ``expert``
mesh axis (reference :375-392) the members of an expert line split each
local batch by rows and each holds ``E / ep`` of the experts and their
adam moments (:func:`shard_experts`); the kept tokens' rows go to their
expert's owner and back by two all-to-alls over ``expert`` a layer
(:class:`_AllToAll`, whose backward is the reverse exchange); the
experts' gradients are summed over ``data``, the other leaves' over
``data`` and ``expert``; at the end the experts are gathered back to the
canonical layout (:func:`gather_experts`).

With ring attention (reference :416-421: ``attention="ring"``, or
``"auto"`` on a ``seq`` axis larger than 1) the members of a ``seq`` line
each hold one chunk of every row's positions and run every layer's
attention through
:func:`~incubator_predictionio_tpu_torch.parallel.ring.ring_attention_sharded`
(:class:`SeqRing` times its rotations); the embeddings, norms and FFN are
position-wise and stay local; the parameters are replicated along ``seq``,
so their gradients are summed over ``data`` and ``seq`` (a mixture of
experts with the ring raises: the reference cannot place it either). On a
``pipe`` axis (reference :236-265, :324-335) each member holds its stage's
contiguous layers (:func:`stage_params`) and :func:`pipeline_step` runs
the GPipe schedule of ``parallel/pipeline.py``; the stages' layers are
gathered back to the canonical layout at the end (:func:`gather_stages`).
A fit whose weights are split (tensor, expert or pipe) checkpoints whole
leaves, its slices gathered over their axis (:func:`checkpoint_layout`,
reference :587-596 and its orbax global arrays): a tensor- or
expert-parallel checkpoint is the state the one-process fit of the same
config saves, and resumes it; a pipelined one holds the stacked layers
(reference ``stack_layers``), which a fit without the pipeline refuses
and trains afresh.

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
from incubator_predictionio_tpu_torch.parallel.pipeline import (
    GPipe,
    backward_with,
    stack_layers,
    stage_slice,
)
from incubator_predictionio_tpu_torch.parallel.ring import (
    causal_attention,
    ring_attention_sharded,
)
from incubator_predictionio_tpu_torch.utils.optim import adam_init, adam_update

logger = logging.getLogger(__name__)

@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Copy of the reference's config (transformer.py:44), every field, so a
    variant or a persisted config binds unchanged. Every parallelism field
    is ported, with checkpoints."""

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
    """A parameter pytree at the reference's init scales
    (transformer.py:84 ``_init_params``: normal × 0.02 for the embeddings,
    × fan_in^-0.5 for the projections, ones/zeros for the norms and
    biases; with ``n_experts`` each layer's router and experts in place of
    the dense FFN), drawn from ``numpy.random.default_rng(seed)`` — random
    weights for smoke runs and tests, the same arrays for both packages."""
    rng = np.random.default_rng(seed)

    def init(shape, scale):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(scale))

    return _param_tree(cfg, init, lambda shape: np.zeros(shape, np.float32),
                       lambda shape: np.ones(shape, np.float32))


def _init_params(cfg: TransformerConfig, generator: torch.Generator,
                 device) -> dict:
    """transformer.py:84 ``_init_params``: the reference's tree and init
    scales (normal × 0.02 for the embeddings, × fan_in^-0.5 for the
    projections, ones/zeros for the norms and biases), drawn from
    ``generator`` on ``device`` in the reference's key order."""
    def init(shape, scale):
        return torch.randn(shape, generator=generator, device=device) * scale

    return _param_tree(cfg, init, lambda shape: torch.zeros(shape, device=device),
                       lambda shape: torch.ones(shape, device=device))


def _param_tree(cfg: TransformerConfig, init, zeros, ones) -> dict:
    """The reference's tree (transformer.py:84-120) with ``init(shape,
    scale)`` drawing the random leaves in its key order: the embeddings,
    then each layer's ``wq wk wv wo`` and its FFN's ``w1 w2`` (dense) or
    ``wr we1 we2`` (``n_experts``: the router ``[d, E]``, the experts
    ``[E, d, 4d]`` and ``[E, 4d, d]``, their biases ``[E, 4d]``, ``[E,
    d]``)."""
    d, dh = cfg.d_model, cfg.d_model * 4

    def norm():
        return {"g": ones(d), "b": zeros(d)}

    params = {"item_emb": init((cfg.vocab_size, d), 0.02),
              "pos_emb": init((cfg.max_len, d), 0.02),
              "ln_f": norm(), "layers": []}
    for _ in range(cfg.n_layers):
        layer = {
            "ln1": norm(),
            "wq": init((d, d), d ** -0.5), "wk": init((d, d), d ** -0.5),
            "wv": init((d, d), d ** -0.5), "wo": init((d, d), d ** -0.5),
            "ln2": norm(),
        }
        e = cfg.n_experts
        if e:
            layer.update({
                "wr": init((d, e), d ** -0.5),
                "we1": init((e, d, dh), d ** -0.5), "be1": zeros((e, dh)),
                "we2": init((e, dh, d), dh ** -0.5), "be2": zeros((e, d)),
            })
        else:
            layer.update({
                "w1": init((d, dh), d ** -0.5), "b1": zeros(dh),
                "w2": init((dh, d), dh ** -0.5), "b2": zeros(d),
            })
        params["layers"].append(layer)
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
#: a mixture-of-experts layer's projections (reference transformer.py:103-111)
_MOE_MATRICES = ("wq", "wk", "wv", "wo", "wr", "we1", "we2")
#: the leaves whose first dim is the expert: split over an ``expert`` axis
EXPERT_LEAVES = ("we1", "be1", "we2", "be2")


def layer_leaf_names(moe: bool) -> tuple[str, ...]:
    """A layer's projections and biases, dense or mixture-of-experts, in
    the order the nets keep them (after its two norms)."""
    return (*_MOE_MATRICES, "be1", "be2") if moe else (*_LAYER_MATRICES, "b1", "b2")


class _Layer(nn.Module):
    """One transformer block's weights, the reference's ``layers[i]`` dict
    and names: a dense FFN (``w1 b1 w2 b2``) or a mixture of experts (``wr
    we1 be1 we2 be2``; the expert leaves may be this process's slice).
    Serving keeps them as buffers, the projections pre-rounded to bf16
    (``_bf16_matmul`` rounds them on every call; rounding once at deploy
    gives the same values); training keeps fp32 parameters."""

    def __init__(self, layer: dict, device, trainable: bool = False,
                 index: int = 0):
        super().__init__()
        self.index = index
        self.moe = "we1" in layer
        self.ln1 = _Norm(layer["ln1"], device, trainable)
        self.ln2 = _Norm(layer["ln2"], device, trainable)
        names = layer_leaf_names(self.moe)
        for name in names[:-2]:
            _put(self, name, layer[name], device, trainable, torch.bfloat16)
        for name in names[-2:]:
            _put(self, name, layer[name], device, trainable)

    def forward(self, h, n_heads: int, attention: Callable,
                tp: Optional["TensorParallel"] = None, mask=None,
                capacity_factor: float = 1.25,
                experts: Optional["ExpertParallel"] = None):
        """transformer.py:196 ``_apply_layer``: ``(h, aux)``, ``aux`` the
        router's auxiliary loss (None for a dense block). With ``tp`` the
        block holds its slices (:func:`shard_params`): its ``n_heads / tp``
        heads attend, the row-parallel products are summed over the
        ``model`` axis, and ``b2`` is added once, after that sum. A
        mixture-of-experts block routes the real tokens (``mask``) through
        :func:`moe_ffn`, over ``experts`` when the routing spans processes."""
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
        if self.moe:
            y, aux, _ = moe_ffn(x, mask, self.wr, self.we1, self.be1, self.we2,
                                self.be2, capacity_factor, experts,
                                index=self.index)
            return h + y, aux
        if tp is not None:
            x = tp.copy(x)
        x = F.gelu(_bf16_matmul(x, self.w1) + self.b1, approximate="tanh")
        y = _bf16_matmul(x, self.w2)
        return h + (y if tp is None else tp.reduce(y)) + self.b2, None


class _Rows(torch.autograd.Function):
    """A one-to-one move of rows: ``_Rows.apply(src, idx, n)`` scatters
    (``out = zeros(n, ...)``, ``out[idx] = src``) and ``_Rows.apply(src,
    idx, None)`` gathers (``src[idx]``); each one's backward is the other
    on the gradient. No index repeats but a discarded dump row's, so the
    backwards need no accumulation: the same bytes every run, no atomics
    (a MoE layer's dispatch and combine)."""

    @staticmethod
    def forward(ctx, src, idx, n):
        ctx.save_for_backward(idx)
        ctx.scatter, ctx.rows = n is not None, src.shape[0]
        if n is None:
            return src[idx]
        out = src.new_zeros((n, *src.shape[1:]))
        out[idx] = src
        return out

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        if ctx.scatter:
            return g[idx], None, None
        out = g.new_zeros((ctx.rows, *g.shape[1:]))
        out[idx] = g
        return out, None, None


class _AllToAll(torch.autograd.Function):
    """Rows exchanged over the ``expert`` axis (:meth:`ExpertParallel.all_to_all`);
    the backward sends each row's gradient back the way it came."""

    @staticmethod
    def forward(ctx, t, experts, send, recv):
        ctx.experts, ctx.send, ctx.recv = experts, send, recv
        return experts.all_to_all(t, send, recv)

    @staticmethod
    def backward(ctx, g):
        return ctx.experts.all_to_all(g, ctx.recv, ctx.send), None, None, None


class ExpertParallel:
    """The routing of a mixture-of-experts fit over several processes.

    The global batch's tokens are in the order the reference's jit sees
    them: the data shards' local batches in data order (the order
    ``stage_sharded_batches`` builds), each split by rows over its expert
    line in axis order (member ``i`` of ``ep`` takes rows ``[i·b/ep,
    (i+1)·b/ep)``), each member's rows in row-major token order.
    :meth:`gather_counts` gathers every process's per-expert counts of real
    tokens in that order (over ``data``, then ``expert``: the processes of
    a ``model`` line hold the same rows and stay apart). This process holds
    experts ``[first, first + local)`` (all of them without an ``expert``
    axis); :meth:`all_to_all` moves rows over its expert line, timed by
    ``clock``, the bytes it sends to the other members counted in
    ``bytes``; ``count_clock`` times the counts' gathers. ``tokens`` is the
    global batch's token count, the capacity's S."""

    def __init__(self, ctx, n_experts: int, tokens: int,
                 clock: Optional[CollectiveClock] = None,
                 count_clock: Optional[CollectiveClock] = None):
        self.ctx = ctx
        self.size = ctx.axis_size_or("expert")  # divides n_experts (the fit checks)
        self.rank = ctx.axis_index("expert")
        self.local = n_experts // self.size
        self.first = self.rank * self.local
        self.tokens = tokens
        self.order = ctx.data_index * self.size + self.rank
        self.clock, self.count_clock = clock, count_clock
        self.bytes = 0
        #: layer index -> (kept, dropped) tokens of the global batch in the
        #: last forward over an expert axis (the fit's log line)
        self.stats: dict = {}

    def _timed(self, clock, fn):
        return fn() if clock is None else clock.time(fn)

    def gather_counts(self, counts: torch.Tensor) -> torch.Tensor:
        """``[processes, E]``: every rows-holding process's ``counts``
        ``[E]``, in token order (row :attr:`order` is this process's)."""
        def run():
            t = self.ctx.all_gather(counts, axis="data")
            return self.ctx.all_gather(t, axis="expert")  # [ep, dp, E]

        return self._timed(self.count_clock, run).transpose(0, 1).reshape(
            -1, counts.shape[0])

    def all_to_all(self, t: torch.Tensor, send, recv) -> torch.Tensor:
        # the bytes sent to the other members (its own rows stay)
        self.bytes += ((sum(send) - send[self.rank]) * t[0:1].numel()
                       * t.element_size())
        return self._timed(self.clock, lambda: self.ctx.all_to_all(
            t, send, recv, axis="expert"))

    def plan(self, table: np.ndarray, capacity: int) -> dict:
        """The all-to-alls of one layer from the gathered counts ``table``
        ``[processes, E]`` (token order): with ``off`` the tokens of expert
        e routed before a process's and ``kept = clip(capacity − off, 0,
        count)`` its tokens that fit, this process sends its kept rows
        ordered by expert then token (``base[e]`` the first row of expert
        e), and receives from each member j of its expert line the kept
        rows of its own experts, which land at slots ``e_local·C + off +
        0, 1, …`` of ``expert_in`` — no size needs exchanging."""
        off = np.cumsum(table, 0) - table
        kept = np.clip(capacity - off, 0, table)
        mine = kept[self.order]
        line = [self.order - self.rank + j for j in range(self.size)]
        owned = slice(self.first, self.first + self.local)
        slots = [el * capacity + off[t, self.first + el]
                 + np.arange(kept[t, self.first + el])
                 for t in line for el in range(self.local)]
        return {"base": np.cumsum(mine) - mine,
                "send": [int(mine[j * self.local:(j + 1) * self.local].sum())
                         for j in range(self.size)],
                "recv": [int(kept[t, owned].sum()) for t in line],
                "slots": np.concatenate(slots).astype(np.int64),
                "kept": int(kept.sum()), "dropped": int((table - kept).sum())}


def _experts_out(expert_in, we1, be1, we2, be2) -> torch.Tensor:
    """The experts on their slots, ``expert_in`` ``[E, C, d]`` bf16 →
    ``[E·C, d]`` bf16: ``gelu(expert_in·we1 + be1)·we2 + be2``, each
    product over bf16 operands rounded to bf16 (reference :179-184)."""
    hidden = F.gelu(_bf16_matmul(expert_in, we1) + be1[:, None, :],
                    approximate="tanh")
    out = _bf16_matmul(hidden, we2) + be2[:, None, :]
    return out.to(torch.bfloat16).reshape(-1, out.shape[-1])


def _route(x, wr):
    """The router (reference :150-152): the fp32 softmax over the bf16
    logits ``x·wr`` ``[S, E]``, and each token's expert, the first maximum
    (as ``jnp.argmax``)."""
    probs = torch.softmax(_bf16_matmul(x, wr), dim=-1)
    return probs, torch.argmax(probs, dim=-1)


def moe_ffn(x, token_mask, wr, we1, be1, we2, be2, capacity_factor: float,
            experts: Optional[ExpertParallel] = None, index: int = 0):
    """transformer.py:133 ``_moe_ffn``: x ``[B, L, d]`` → ``(y [B, L, d],
    aux, (chosen, keep))``, the reference's values without its ``[S, E,
    C]`` one-hot tensors. ``token_mask`` ``[B, L]`` (True = a real token)
    keeps the padding out of the router. Each real token goes to the
    argmax of its fp32 softmax over the bf16 router logits (the first
    maximum, as ``jnp.argmax``), at its position among the tokens of that
    expert in token order (an int64 running count); a position below the
    capacity ``max(1, int(factor · S / E))`` keeps it. Slot ``(e, pos)``
    receives ``bf16(x)``; the experts run on their ``[E, C, d]`` slots
    (empty slots zero, as the reference's einsum leaves them); a kept
    token's output is ``bf16(bf16(gate) · bf16(out[slot]))``, the one
    non-zero term of the reference's combine, and 0 otherwise. ``aux`` is
    ``E · Σ_e frac_e · mean_prob_e`` over the real tokens (Switch
    Transformer's eq. 4-6).

    Without ``experts`` the batch is the whole batch (one device: serving,
    where a query's answer depends on the batch it is served with, as in
    the reference, since the capacity does). With ``experts`` the routing
    is the global batch's: S is ``experts.tokens``; the positions start
    after the tokens of the processes before this one in token order;
    ``aux`` is this process's share, ``E · Σ_e frac_e · Σ_local probs_e /
    n_real``, so that the shares sum to the global value and their
    gradients to its gradient; with an ``expert`` axis the kept rows go to
    their expert's owner and back by two all-to-alls. ``we1 be1 we2 be2``
    are the experts this process holds; ``index`` is the layer's (the
    kept and dropped counts of :attr:`ExpertParallel.stats`)."""
    b, l, d = x.shape
    e = wr.shape[1]
    s = b * l
    xf = x.reshape(s, d)
    probs, chosen = _route(xf, wr)
    mask = token_mask.reshape(s)
    # each expert's running count down the tokens, an int64 scan along the
    # rows of [E, S]: down the 8 columns of [S, E] it took 5.5 of a layer's
    # 10 device ms on the H100 (forward and backward, batch 64)
    running = torch.cumsum((F.one_hot(chosen, e) * mask[:, None]).T.contiguous(), 1)
    counts = running[:, -1]
    local = running.gather(0, chosen[None, :])[0] - 1
    gate = probs.gather(1, chosen[:, None])[:, 0]
    if experts is None:
        table, order, s_all = counts[None], 0, s
    else:
        table, order, s_all = experts.gather_counts(counts), experts.order, experts.tokens
    capacity = max(1, int(capacity_factor * s_all / e))
    before = table[:order].sum(0)
    pos = before[chosen] + local
    keep = mask & (pos < capacity)
    xb = xf.to(torch.bfloat16)
    if experts is None or experts.size == 1:
        # every expert here: slots straight from the positions, no host sync
        n_slots = e * capacity
        slot = torch.where(keep, chosen * capacity + pos, n_slots)  # dump
        expert_in = _Rows.apply(xb, slot, n_slots + 1)[:n_slots]
        out = _experts_out(expert_in.view(e, capacity, d), we1, be1, we2, be2)
        rows = _Rows.apply(torch.cat([out, out.new_zeros(1, d)]), slot, None)
    else:
        plan = experts.plan(table.cpu().numpy(), capacity)
        experts.stats[index] = (plan["kept"], plan["dropped"])
        n_send = sum(plan["send"])
        base = torch.from_numpy(plan["base"]).to(x.device)
        row = torch.where(keep, base[chosen] + local, n_send)  # dump
        slots = torch.from_numpy(plan["slots"]).to(x.device)
        sent = _Rows.apply(xb, row, n_send + 1)[:n_send]
        got = _AllToAll.apply(sent, experts, plan["send"], plan["recv"])
        n_slots = experts.local * capacity
        expert_in = _Rows.apply(got, slots, n_slots)
        out = _experts_out(expert_in.view(experts.local, capacity, d),
                           we1, be1, we2, be2)
        back = _AllToAll.apply(_Rows.apply(out, slots, None), experts,
                               plan["recv"], plan["send"])
        rows = _Rows.apply(torch.cat([back, back.new_zeros(1, d)]), row, None)
    gate_b = gate.to(torch.bfloat16).float()
    y = (gate_b[:, None] * rows.float()).to(torch.bfloat16).float()
    # the load-balancing loss over the real tokens (reference :187-192)
    n_real = torch.clamp(table.sum().float(), min=1.0)
    frac = table.sum(0).float() / n_real
    mean_prob = (probs * mask[:, None].float()).sum(0) / n_real
    aux = e * torch.sum(frac * mean_prob)
    return y.reshape(b, l, d), aux, (chosen, keep)


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


def _gather_host(ctx, a: np.ndarray, axis: str) -> np.ndarray:
    """``[size, *a.shape]``: the host array ``a`` of every process of this
    process's ``axis`` line, in axis order. The gather runs on
    ``ctx.device``: an NCCL group takes no host tensor."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(ctx.device)
    return ctx.all_gather(t, axis=axis).cpu().numpy()


def gather_params(ctx, params: dict) -> dict:
    """The canonical tree from every process's slices
    (:func:`shard_params`): each split leaf all-gathered over ``model``
    and joined in axis order (a collective), the rest as they are."""
    def join(name, a):
        if name not in COLUMN_PARALLEL + ROW_PARALLEL:
            return a
        return np.concatenate(list(_gather_host(ctx, a, "model")),
                              axis=-1 if name in COLUMN_PARALLEL else 0)

    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: join(k, v) for k, v in layer.items()}
                     for layer in params["layers"]]
    return out


def shard_experts(params: dict, shard: int, ep: int) -> dict:
    """Process ``shard``'s experts under an ``ep``-way ``expert`` axis (the
    reference's ``_place_params_expert_sharded``, :375-392): each expert
    leaf (:data:`EXPERT_LEAVES`) cut on its first dim, the rest whole."""
    def cut(name, a):
        if name not in EXPERT_LEAVES:
            return a
        n = a.shape[0] // ep
        return a[shard * n:(shard + 1) * n]

    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: cut(k, v) for k, v in layer.items()}
                     for layer in params["layers"]]
    return out


def gather_experts(ctx, params: dict) -> dict:
    """The canonical tree from every process's experts
    (:func:`shard_experts`): each expert leaf all-gathered over ``expert``
    and joined in axis order (a collective), the rest as they are."""
    def join(name, a):
        if name not in EXPERT_LEAVES:
            return a
        return np.concatenate(list(_gather_host(ctx, a, "expert")), axis=0)

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
    """The layer stack on one explicit device: buffers to serve, or
    (``trainable=True``) fp32 parameters to train. ``params`` is the
    reference's tree, of numpy arrays or tensors; with ``tp`` its split
    leaves are this process's slices (:func:`shard_params`), with
    ``experts`` an expert axis's process's experts (:func:`shard_experts`)
    and the routing over the processes (:class:`ExpertParallel`)."""

    def __init__(self, params: dict, cfg: TransformerConfig, device,
                 trainable: bool = False,
                 tp: Optional[TensorParallel] = None,
                 experts: Optional[ExpertParallel] = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp  # set: ``params`` are this process's slices
        self.experts = experts
        _put(self, "item_emb", params["item_emb"], device, trainable)
        _put(self, "pos_emb", params["pos_emb"], device, trainable)
        self.ln_f = _Norm(params["ln_f"], device, trainable)
        self.layers = nn.ModuleList(_Layer(p, device, trainable, i)
                                    for i, p in enumerate(params["layers"]))
        if not trainable:
            self.register_buffer("item_emb_bf16", self.item_emb.to(torch.bfloat16))

    def forward(self, tokens, positions, attention: Callable = causal_attention):
        """transformer.py:218 ``_forward``: tokens, positions ``[B, L]``
        int → hidden ``[B, L, D]`` fp32 after the final norm
        (:meth:`forward_with_aux` without the auxiliary loss)."""
        return self.forward_with_aux(tokens, positions, attention)[0]

    def forward_with_aux(self, tokens, positions,
                         attention: Callable = causal_attention):
        """transformer.py:218 ``_forward``: ``(hidden, aux)``, ``aux`` the
        routers' auxiliary losses summed over the layers (0 without
        experts); the blocks are :meth:`blocks`. The lookups are
        :func:`_lookup`: its backward sums the rows of a repeated index
        (the padding token, every position) as one sorted float64 scan, the
        same bytes every run, where indexing's backward walks a repeated
        index's rows one by one. Pad tokens (token 0) do not route
        (reference :223)."""
        h = _lookup(tokens, self.item_emb) + _lookup(positions, self.pos_emb)
        mask = tokens != 0 if self.cfg.n_experts else None
        h, aux = self.blocks(h, attention, mask)
        return _ln(h, self.ln_f.g, self.ln_f.b), aux

    def blocks(self, h, attention: Callable = causal_attention, mask=None):
        """The net's layers on ``h`` ``[B, L, D]`` → ``(h, aux)``: every
        block, or a pipeline stage's (:func:`stage_params`). With
        ``cfg.remat`` and a gradient wanted, each block recomputes its
        activations in the backward (reference :225-229, :251-253)."""
        remat = self.cfg.remat and torch.is_grad_enabled()
        aux = h.new_zeros(())
        for layer in self.layers:
            args = (h, self.cfg.n_heads, attention, self.tp, mask,
                    self.cfg.expert_capacity_factor, self.experts)
            if remat:
                h, a = checkpoint(layer, *args, use_reentrant=False)
            else:
                h, a = layer(*args)
            if a is not None:
                aux = aux + a
        return h, aux

    def serve_scores(self, tokens, attention: Callable = causal_attention):
        """transformer.py:624 ``_serve_scores``: the newest (last) position's
        hidden state against the tied item embedding → ``[B, vocab]`` fp32
        (bf16 values). ``attention`` is the attention function; the default
        is the serving one, and a check may pass the plain version. A
        mixture-of-experts model routes over the served batch (its
        capacity is the batch's), as the reference's does."""
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
        for layer in self.layers:
            leaves = {"ln1": norm(), "ln2": norm()}
            leaves.update({n: next(it) for n in layer_leaf_names(layer.moe)})
            out["layers"].append(leaves)
        return out

    def _tree_tensors(self) -> list:
        out = [self.item_emb, self.pos_emb, self.ln_f.g, self.ln_f.b]
        for layer in self.layers:
            out += [layer.ln1.g, layer.ln1.b, layer.ln2.g, layer.ln2.b]
            out += [getattr(layer, n) for n in layer_leaf_names(layer.moe)]
        return out

    def expert_params(self) -> list:
        """The experts' leaves (:data:`EXPERT_LEAVES`) of every layer."""
        return [getattr(layer, n) for layer in self.layers if layer.moe
                for n in EXPERT_LEAVES]


def train_loss(net: TransformerNet, tokens, positions, targets, weights,
               attention: Callable = causal_attention, denom=None):
    """transformer.py:285 ``loss_fn``: ``Σ w·xent / max(Σw, 1)`` over the
    tied item embedding plus ``router_aux_weight`` × the routers'
    auxiliary loss (0 without experts). ``denom`` replaces ``max(Σw, 1)``:
    a data-parallel step divides its local sum by the global batch's (and
    adds its share of the auxiliary loss, :func:`moe_ffn`)."""
    h, aux = net.forward_with_aux(tokens, positions, attention)
    loss_sum = weighted_xent_sum(h.reshape(-1, h.shape[-1]), net.item_emb,
                                 targets.reshape(-1), weights.reshape(-1))
    if denom is None:
        denom = torch.clamp(weights.sum(), min=1.0)
    loss = loss_sum / denom
    if net.cfg.n_experts:
        loss = loss + net.cfg.router_aux_weight * aux
    return loss


def train_step(net: TransformerNet, opt_state, batch, lr: float,
               attention: Callable = causal_attention, denom=None,
               all_reduce: Optional[Callable] = None,
               expert_all_reduce: Optional[Callable] = None):
    """One step (transformer.py:306 ``step``): loss, gradients, adam in
    place. ``batch`` is (tokens, positions, targets, weights) on the net's
    device. Returns the loss as a device scalar — no host sync. A
    data-parallel step passes the global batch's ``denom`` and
    ``all_reduce``, which sums the flattened gradients over the processes
    (the gradient of the global batch, the same bytes on every replica);
    an expert-parallel one also ``expert_all_reduce``, which sums the
    experts' gradients (each process's own experts) apart from the rest."""
    params = list(net.parameters())
    loss = train_loss(net, *batch, attention=attention, denom=denom)
    grads = list(torch.autograd.grad(loss, params))
    if all_reduce is not None:
        split = ({id(p) for p in net.expert_params()}
                 if expert_all_reduce is not None else set())
        for fn, idx in ((all_reduce, [i for i, p in enumerate(params)
                                      if id(p) not in split]),
                        (expert_all_reduce, [i for i, p in enumerate(params)
                                             if id(p) in split])):
            if not idx:
                continue
            flat = fn(torch.cat([grads[i].reshape(-1) for i in idx]))
            for i, g in zip(idx, flat.split([params[i].numel() for i in idx])):
                grads[i] = g.view_as(params[i])
    adam_update(params, grads, opt_state, lr)
    return loss.detach()


def stage_params(params: dict, stage: int, n_stages: int) -> dict:
    """Pipeline stage ``stage``'s tree (the reference's
    ``_place_params_pipe_sharded``, :324-335): its contiguous
    ``n_layers / n_stages`` layers and the shared leaves."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = params["layers"][stage_slice(
        len(params["layers"]), n_stages, stage)]
    return out


def gather_stages(ctx, params: dict) -> dict:
    """The canonical tree from every stage's (:func:`stage_params`): each
    stage's layers all-gathered over ``pipe`` and listed in stage order (a
    collective; the reference's ``_unstack_layers``), the rest as they are."""
    out = {k: v for k, v in params.items() if k != "layers"}
    per = [{k: _gather_host_tree(ctx, v) for k, v in layer.items()}
           for layer in params["layers"]]
    n_stages = ctx.axis_size("pipe")
    out["layers"] = [_index_tree(layer, s) for s in range(n_stages)
                     for layer in per]
    return out


def _gather_host_tree(ctx, tree):
    if isinstance(tree, dict):
        return {k: _gather_host_tree(ctx, v) for k, v in tree.items()}
    return _gather_host(ctx, tree, "pipe")


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def checkpoint_layout(ctx, net: TransformerNet, tensor_parallel: bool,
                      expert_parallel: bool, pipelined: bool):
    """The layout of a fit's checkpoints whose weights are split
    (``utils/checkpoint.py:SplitLeaves``), None when every process holds
    the whole state. Tensor parallelism: :data:`COLUMN_PARALLEL` on their
    last dim and :data:`ROW_PARALLEL` on their first over ``model``, as
    :func:`shard_params` cuts them; experts: :data:`EXPERT_LEAVES` on their
    first dim over ``expert``, as :func:`shard_experts` cuts them; the
    rest whole, so the whole state is the one-process fit's. A pipeline:
    the reference's stacked layers (``stack_layers``, one ``[n_layers,
    …]`` leaf a layer name; each stage's :func:`stage_params` layers its
    rows over ``pipe``) beside the whole shared leaves."""
    from incubator_predictionio_tpu_torch.utils.checkpoint import SplitLeaves

    names = [n.split(".") for n, _ in net.named_parameters()]
    if pipelined:
        return SplitLeaves(
            ctx, lambda path: ("pipe", 0) if path[0] == "layers" else None,
            view=lambda leaves: _stacked(names, leaves),
            unview=lambda tree: _unstacked(names, tree))
    if not (tensor_parallel or expert_parallel):
        return None

    def split(name, p):
        leaf = name[-1] if name[0] == "layers" else None
        if tensor_parallel and leaf in COLUMN_PARALLEL:
            return "model", p.dim() - 1
        if tensor_parallel and leaf in ROW_PARALLEL:
            return "model", 0
        if expert_parallel and leaf in EXPERT_LEAVES:
            return "expert", 0
        return None

    splits = [split(n, p) for n, p in zip(names, net.parameters())]
    return SplitLeaves(ctx, lambda path: splits[path[0]])


def _stacked(names: list, leaves: list) -> dict:
    """The parameter list ``leaves`` (named ``names``, split on the dots)
    as the reference's stacked tree: the layers through ``stack_layers``,
    the other leaves at their own keys."""
    out, layers = {}, {}
    for name, leaf in zip(names, leaves):
        if name[0] == "layers":
            _nest(layers.setdefault(int(name[1]), {}), name[2:], leaf)
        else:
            _nest(out, name, leaf)
    out["layers"] = stack_layers([layers[i] for i in sorted(layers)])
    return out


def _unstacked(names: list, tree: dict) -> list:
    """:func:`_stacked`'s inverse: the parameter list from the tree."""
    out = []
    for name in names:
        layer = name[0] == "layers"
        leaf = tree
        for k in (["layers", *name[2:]] if layer else name):
            leaf = leaf[k]
        out.append(leaf[int(name[1])] if layer else leaf)
    return out


def _nest(tree: dict, keys, leaf) -> None:
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = leaf


def pipeline_grads(net: TransformerNet, tokens, positions, pipe,
                   head: Callable, attention: Callable = causal_attention):
    """The forward and backward of one batch through a pipeline (reference
    :236-265) on this process's stage ``net`` (:func:`stage_params`):
    stage 0 embeds the batch, :class:`~incubator_predictionio_tpu_torch.parallel.pipeline.GPipe`
    runs the stages' layers on its microbatches, and the last stage, which
    holds the hidden states, takes the final norm and ``head(hidden) ->
    loss`` over the whole local batch, then its backward; the schedule's
    backward brings the gradient back to stage 0, which backpropagates it
    into the embeddings. The parameters' ``.grad`` hold this stage's
    gradients after it: the embeddings and the final norm stay outside the
    pipeline, whole on every stage, and each stage's gradients of them are
    only the parts it computed (the item table's lookup at stage 0, its
    logits at the last stage; None elsewhere). Returns the loss on the last
    stage, 0 on the others."""
    b, l = tokens.shape
    if pipe.stage == 0:
        h0 = _lookup(tokens, net.item_emb) + _lookup(positions, net.pos_emb)
    else:  # only the shape: the inputs arrive from the previous stage
        h0 = torch.empty((b, l, net.cfg.d_model), device=tokens.device)
    outs = pipe.forward(h0, lambda x: net.blocks(x, attention)[0])
    loss, grads_out = torch.zeros((), device=tokens.device), None
    if pipe.last:
        h = torch.cat(outs).detach().requires_grad_(True)
        loss = head(_ln(h, net.ln_f.g, net.ln_f.b))
        loss.backward()
        grads_out = list(h.grad.split(b // pipe.m))
    g0 = pipe.backward(grads_out)
    if pipe.stage == 0:
        backward_with(h0, g0)
    return loss.detach()


def pipeline_step(net: TransformerNet, opt_state, batch, lr: float, pipe,
                  denom, stage_all_reduce: Callable,
                  shared_all_reduce: Callable,
                  attention: Callable = causal_attention):
    """One step of a pipelined fit (reference :285-306):
    :func:`pipeline_grads` with the loss over the global batch's ``denom``;
    the shared leaves' gradients (the embeddings and the final norm, each
    stage's parts) summed over ``pipe`` and ``data`` by
    ``shared_all_reduce``, the stage's layers' over ``data`` by
    ``stage_all_reduce``; then the same adam. Returns the loss on the last
    stage, 0 on the others, as a device scalar."""
    tokens, positions, targets, weights = batch
    params = list(net.parameters())
    for p in params:
        p.grad = None
    d = net.cfg.d_model

    def head(hidden):
        return weighted_xent_sum(hidden.reshape(-1, d), net.item_emb,
                                 targets.reshape(-1), weights.reshape(-1)) / denom

    loss = pipeline_grads(net, tokens, positions, pipe, head, attention)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    for p in params:
        p.grad = None
    shared = {id(p) for p in (net.item_emb, net.pos_emb, net.ln_f.g, net.ln_f.b)}
    for fn, idx in ((shared_all_reduce, [i for i, p in enumerate(params)
                                         if id(p) in shared]),
                    (stage_all_reduce, [i for i, p in enumerate(params)
                                        if id(p) not in shared])):
        flat = fn(torch.cat([grads[i].reshape(-1) for i in idx]))
        for i, g in zip(idx, flat.split([params[i].numel() for i in idx])):
            grads[i] = g.view_as(params[i])
    adam_update(params, grads, opt_state, lr)
    return loss


class SeqRing:
    """The ``seq`` line of a ring-attention fit as the ring sees its mesh
    (:func:`~incubator_predictionio_tpu_torch.parallel.ring.ring_attention`
    reads ``axis_size_or``, ``axis_index`` and ``ppermute``): each K/V
    rotation, forward and backward, timed by ``clock`` and its bytes sent
    counted in :attr:`bytes`."""

    def __init__(self, ctx, clock: CollectiveClock):
        self.ctx, self.clock = ctx, clock
        self.bytes = 0
        self.axis_names = ctx.axis_names

    def axis_size_or(self, name, default=1):
        return self.ctx.axis_size_or(name, default)

    def axis_index(self, name):
        return self.ctx.axis_index(name)

    def ppermute(self, t, axis, shift=1, cyclic=True):
        self.bytes += t.numel() * t.element_size()
        return self.clock.time(lambda: self.ctx.ppermute(t, axis, shift, cyclic))


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
        """Build the layer stack on ``ctx.device`` (a mixture of experts'
        tables as bf16 buffers there too, every expert); on a card, build
        (or load) the attention kernels now, so that no query pays for
        nvcc."""
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
                "max_len": self.config.max_len,
                "n_experts": self.config.n_experts}


class TransformerRecommender:
    def __init__(self, config: TransformerConfig):
        self.config = config

    def _use_ring(self, ctx: DeviceContext) -> bool:
        """transformer.py:416: ring attention for ``"ring"``, never for
        ``"local"``, and for ``"auto"`` on a ``seq`` axis larger than 1."""
        if self.config.attention == "ring":
            return True
        if self.config.attention == "local":
            return False
        return ctx.axis_size_or("seq") > 1

    def _use_pipeline(self, ctx: DeviceContext, use_ring: bool) -> bool:
        """Whether the fit is pipelined, with the reference's checks and
        texts (transformer.py:437-458): ``pipeline_stages`` on a mesh
        without a ``pipe`` axis warns and trains without pipelining; on
        one, the stage count must be the axis's size and divide the
        layers, and neither ring attention nor MoE may be asked for."""
        cfg = self.config
        use = bool(cfg.pipeline_stages) and "pipe" in ctx.axis_names
        if cfg.pipeline_stages and not use:
            logger.warning(
                "pipeline_stages=%d requested but the mesh has no 'pipe' "
                "axis (mesh axes: %s) — training runs without pipeline "
                "parallelism", cfg.pipeline_stages, ctx.axis_names)
        if use:
            if cfg.pipeline_stages != ctx.axis_size("pipe"):
                raise ValueError(
                    f"pipeline_stages={cfg.pipeline_stages} must equal the "
                    f"pipe axis size ({ctx.axis_size('pipe')})")
            if cfg.n_layers % cfg.pipeline_stages:
                raise ValueError(
                    f"n_layers={cfg.n_layers} must divide into "
                    f"{cfg.pipeline_stages} pipeline stages")
            if use_ring or cfg.n_experts:
                raise ValueError(
                    "pipeline parallelism composes with dp (and local "
                    "attention), not with ring attention or MoE")
        return use

    def _tensor_parallel(self, ctx: DeviceContext, use_pipeline: bool) -> bool:
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
            if use_pipeline or cfg.n_experts:
                raise ValueError(
                    "tensor parallelism composes with dp/sp, not with the "
                    "pipeline or MoE placements")
        return engaged

    def _expert_parallel(self, ctx: DeviceContext) -> int:
        """How many processes the experts split over, with the reference's
        checks and texts (transformer.py:526-541): ``n_experts`` on a mesh
        without an ``expert`` axis records a degradation (once a key) and
        keeps the experts replicated (1); on one, ``n_experts`` must split
        evenly over it. 1 also for a dense model."""
        cfg = self.config
        if not cfg.n_experts:
            return 1
        if "expert" not in ctx.axis_names:
            from incubator_predictionio_tpu_torch.sharding.degrade import (
                record_axis_degradation,
            )

            record_axis_degradation(
                "transformer.moe", "expert", f"n_experts={cfg.n_experts}",
                ctx.axis_names, "expert tables stay replicated")
            return 1
        ep = ctx.axis_size("expert")
        if cfg.n_experts % ep:
            raise ValueError(
                f"n_experts={cfg.n_experts} must divide evenly over the "
                f"expert axis ({ep} devices)")
        return ep

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
        of a ``model``, ``expert``, ``seq`` or ``pipe`` line hold the same
        batches. With ``tensor_parallel`` on a ``model`` axis they split the
        weights (module docstring; :meth:`_tensor_parallel`). With
        ``n_experts`` the routing is the global batch's; on an ``expert``
        axis the members of a line split each local batch by rows and the
        experts between them (module docstring; :meth:`_expert_parallel`).
        With ring attention (:meth:`_use_ring`; whole rows only, as the
        reference) the members of a ``seq`` line split the positions: each
        stages its chunk of every row and runs every layer's attention
        through the ring (reference :505-514); the position-wise rest stays
        local, and the gradients are summed over ``data`` and ``seq``. On a
        ``pipe`` axis (:meth:`_use_pipeline`) each member holds its stage's
        layers and :func:`pipeline_step` runs the GPipe schedule on
        ``pipeline_microbatches`` (default: the stage count) microbatches
        of the local batch; the stages' layers are gathered back to the
        canonical layout at the end (:func:`gather_stages`)."""
        cfg = self.config
        use_ring = self._use_ring(ctx)
        use_pipeline = self._use_pipeline(ctx, use_ring)
        pipe_m = cfg.pipeline_microbatches or cfg.pipeline_stages
        ep = self._expert_parallel(ctx)
        tensor_parallel = self._tensor_parallel(ctx, use_pipeline)
        if use_ring and cfg.n_experts:
            # the reference cannot place it either: its fit fails in
            # placement (DuplicateSpecError, PartitionSpec(None, 'seq',
            # 'seq')) on {"seq": 2} and {"seq": 2, "expert": 2}
            raise NotImplementedError(
                "TransformerRecommender.fit: a mixture of experts with ring "
                "attention (a 'seq' axis) is not ported: the reference "
                "refuses it too, its placement raising DuplicateSpecError "
                "(PartitionSpec(None, 'seq', 'seq'))")
        if use_ring and "seq" not in ctx.axis_names:
            # the reference's sharding raises here (a PartitionSpec over an
            # axis the mesh lacks): ValueError, naming the axis
            raise ValueError(
                f"attention='ring' shards the sequence over the mesh's 'seq' "
                f"axis, which the mesh lacks (mesh axes {list(ctx.axis_names)})")
        multi = ctx.process_count > 1
        if multi and rows_are_local:
            if use_ring:
                # the reference's refusal and text (transformer.py:467-474)
                raise ValueError(
                    "rows_are_local training does not compose with ring "
                    "(sequence-parallel) attention; use attention='local'")
            if use_pipeline and cfg.batch_size % (pipe_m * ctx.data_size):
                raise ValueError(
                    f"batch_size={cfg.batch_size} must be a multiple of "
                    f"pipeline_microbatches × data axis "
                    f"({pipe_m} × {ctx.data_size})")
        dp = ctx.data_size > 1  # gradients all-reduced over the data axis
        split = ep > 1  # the expert line's members split the local batch
        seq = ctx.axis_size_or("seq") if use_ring else 1
        pp = ctx.axis_size("pipe") if use_pipeline else 1
        sequences = np.asarray(sequences)
        tokens, targets = sequences[:, :-1], sequences[:, 1:]
        weights = (targets != 0).astype(np.float32) * (tokens != 0).astype(np.float32)
        n, l = tokens.shape
        if l != cfg.max_len:
            raise ValueError(f"sequences must be max_len+1 = {cfg.max_len + 1} wide")
        if l % seq:
            raise ValueError(
                f"max_len={l} must divide over the seq axis ({seq} devices)")
        # this process's chunk of the positions (all of them off a ring)
        lc = l // seq
        c0 = ctx.axis_index("seq") * lc if seq > 1 else 0
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
            if use_pipeline:
                # the schedule needs batch % (microbatches × data) == 0;
                # round up, the extra rows zero-weight padding (:498-502)
                mult = pipe_m * ctx.data_size
                global_batch = -(-global_batch // mult) * mult
            n_batches = max(1, -(-n // global_batch))
            pad = n_batches * global_batch - n
            cols = slice(None)
            if dp:  # the global batches' slice on the data axis
                b_local = global_batch // ctx.data_size
                cols = slice(ctx.data_index * b_local,
                             (ctx.data_index + 1) * b_local)

            def stage(a, dtype):
                a = np.concatenate([a, np.zeros((pad, l), a.dtype)])
                a = a.reshape(n_batches, global_batch, l)[:, cols, c0:c0 + lc]
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

            tb, yb = stage(tokens, torch.int64), stage(targets, torch.int64)
            wb = stage(weights, torch.float32)
            staged_real = None
        n_batches, b_rows = tb.shape[0], tb.shape[1]
        # an expert line's member i takes rows [i·b/ep, (i+1)·b/ep)
        member = ctx.axis_index("expert") if split else 0
        lo, hi = member * b_rows // ep, (member + 1) * b_rows // ep
        positions = torch.arange(c0, c0 + lc, device=dev).expand(hi - lo, lc)
        # the axes whose processes hold other rows or positions: each
        # global batch's loss sums over them (and a replicated leaf's
        # gradients; a pipeline's shared leaves add 'pipe')
        row_axes = [a for a, on in (("data", dp), ("expert", split),
                                    ("seq", seq > 1)) if on]
        reduce = bool(row_axes) or pp > 1  # sums over processes

        def sum_over(t, axes):
            for a in axes:
                t = ctx.all_reduce_sum(t, axis=a)
            return t

        # each global batch's loss denominator, max(Σ w, 1), once: a sum of
        # 0/1 weights, exact in fp32 in any order
        denoms = (sum_over(wb.sum((1, 2)), [a for a in row_axes if a != "expert"])
                  .clamp(min=1.0) if reduce or use_pipeline else None)
        t_stage = time.perf_counter() - t_stage

        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        init = _init_params(cfg, generator, dev)
        clock = CollectiveClock(dev)
        tp_clock = CollectiveClock(dev)
        a2a_clock, count_clock = CollectiveClock(dev), CollectiveClock(dev)
        p2p_clock = CollectiveClock(dev)  # the ring's rotations, the pipe's handoffs
        tp = experts = ring = pipe = None
        attention = causal_attention
        if tensor_parallel:  # every process draws the whole init, keeps its slice
            tp = TensorParallel(ctx, tp_clock)
            init = shard_params(init, tp.rank, tp.size)
        if cfg.n_experts and multi:  # the global batch's routing
            experts = ExpertParallel(ctx, cfg.n_experts,
                                     b_rows * ctx.data_size * l, a2a_clock,
                                     count_clock)
            if split:
                init = shard_experts(init, experts.rank, ep)
        if use_ring:
            ring = SeqRing(ctx, p2p_clock)

            def attention(q, k, v):
                return ring_attention_sharded(q, k, v, ring)
        if use_pipeline:
            pipe = GPipe(ctx, pipe_m, "pipe", p2p_clock)
            init = stage_params(init, pipe.stage, pp)
        net = TransformerNet(init, cfg, dev, trainable=True, tp=tp,
                             experts=experts)
        del init
        params = list(net.parameters())
        opt_state = adam_init(params, cfg.adam_moments_dtype)
        chunks = []  # [epochs, n_batches] step losses of each chunk run

        def all_reduce(t):
            # over every process with rows or positions of its own
            return clock.time(lambda: sum_over(t, row_axes))

        def all_reduce_experts(t):  # each expert's replicas: the data line
            return clock.time(lambda: ctx.all_reduce_sum(t, axis="data")) if dp else t

        def all_reduce_shared(t):  # a pipeline's embeddings and final norm
            return clock.time(lambda: sum_over(t, row_axes + ["pipe"]))

        def train_epochs(p, o, n_epochs):
            # p is `params`: a restore copies into the net's own tensors
            losses = torch.zeros((n_epochs, n_batches), device=dev)
            for epoch in range(n_epochs):
                for i in range(n_batches):
                    batch = (tb[i, lo:hi], positions, yb[i, lo:hi], wb[i, lo:hi])
                    if pipe is not None:
                        losses[epoch, i] = pipeline_step(
                            net, o, batch, cfg.learning_rate, pipe,
                            denoms[i], all_reduce, all_reduce_shared)
                        continue
                    losses[epoch, i] = train_step(
                        net, o, batch, cfg.learning_rate, attention=attention,
                        denom=denoms[i] if reduce else None,
                        all_reduce=all_reduce if reduce else None,
                        expert_all_reduce=all_reduce_experts if split else None)
            if reduce:  # the global step losses: the local ones summed once
                losses = sum_over(losses, row_axes + (["pipe"] if pp > 1 else []))
            chunks.append(losses)
            # the mean of the last epoch's step losses (transformer.py:314)
            return p, o, losses[-1].mean()

        from incubator_predictionio_tpu_torch.utils.checkpoint import (
            checkpointed_epochs,
        )

        t_train = time.perf_counter()
        # chunks of checkpoint_every epochs, resumed from checkpoint_dir's
        # latest step (transformer.py:587-596, which passes no dist hooks:
        # a multi-process fit, supervised or not, takes the plain path);
        # split weights are saved whole, gathered over their axis
        _, _, loss = checkpointed_epochs(
            cfg.checkpoint_dir, cfg.checkpoint_every, cfg.checkpoint_keep,
            cfg.epochs, params, opt_state, train_epochs, ctx=ctx,
            layout=checkpoint_layout(ctx, net, tensor_parallel, split,
                                     use_pipeline))
        final_loss = float(loss) if loss is not None else math.nan  # a sync
        t_train = time.perf_counter() - t_train
        t_gather = time.perf_counter()
        params = net.params_numpy()
        digest = None
        if tensor_parallel or split or use_pipeline:
            # the replicated leaves equal on every process, each slice on
            # its data line; then the canonical layout from the slices
            if use_pipeline:
                sliced = list(_leaves(params["layers"]))
            else:
                names = COLUMN_PARALLEL + ROW_PARALLEL if tensor_parallel else EXPERT_LEAVES
                sliced = [layer[k] for layer in params["layers"] for k in names]
            whole = [a for a in _leaves(params)
                     if not any(a is b for b in sliced)]
            check_replicas(ctx, sliced, axis="data")
            check_replicas(ctx, whole)
            params = (gather_stages(ctx, params) if use_pipeline
                      else gather_params(ctx, params) if tensor_parallel
                      else gather_experts(ctx, params))
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
            exchange = (clock.seconds() + tp_clock.seconds() + a2a_clock.seconds()
                        + count_clock.seconds() + p2p_clock.seconds())
            n_steps = sum(len(c) for c in chunks) * n_batches  # epochs run
            per_step = 1e3 / max(n_steps, 1)  # ms a step from seconds
            model.timings.update(stage_sec=round(t_stage, 4),
                                 exchange_sec=round(exchange, 4))
            from incubator_predictionio_tpu_torch.ops.attention import (
                KERNEL_WRAPPERS,
            )

            peak = (torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else 0)
            launches = json.dumps({w.__name__: w.launches
                                   for w in KERNEL_WRAPPERS})
            coords = json.dumps({a: ctx.axis_index(a) for a in ctx.axis_names})
            if split:
                layer = net.layers[0]
                model.timings["all_to_all_sec"] = round(a2a_clock.seconds(), 4)
                stats = [[int(x) for x in experts.stats[i]]
                         for i in sorted(experts.stats)]
                logger.info(
                    "expert-parallel fit: process %d of %d at %s (backend "
                    "%s, %s): experts [%d, %d) of %d; we1 %s, be1 %s, we2 %s, "
                    "be2 %s; %d steps of %d rows a member (local batch %d); "
                    "stage %.3f s, train %.3f s, all-to-all %.3f ms a step "
                    "(%d bytes a step), counts %.3f ms a step, data "
                    "all-reduce %.3f ms a step; kept and dropped tokens a "
                    "layer in the last step %s; loss %.6f; model digest %s, "
                    "equal on every process; peak device memory %d bytes; "
                    "attention launches %s",
                    ctx.process_index, ctx.process_count, coords,
                    ctx.backend, dev, experts.first,
                    experts.first + experts.local, cfg.n_experts,
                    list(layer.we1.shape), list(layer.be1.shape),
                    list(layer.we2.shape), list(layer.be2.shape), n_steps,
                    hi - lo, b_rows, t_stage, t_train,
                    a2a_clock.seconds() * per_step,
                    experts.bytes // max(n_steps, 1),
                    count_clock.seconds() * per_step,
                    clock.seconds() * per_step, json.dumps(stats),
                    final_loss, digest, peak, launches)
            elif tensor_parallel:
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
                    ctx.process_index, ctx.process_count, coords,
                    ctx.backend, dev, cfg.n_heads // tp.size, cfg.n_heads,
                    list(layer.wq.shape), list(layer.w1.shape),
                    list(layer.wo.shape), list(layer.w2.shape), n_steps,
                    b_rows, t_stage, t_train, tp_clock.seconds() * per_step,
                    clock.seconds() * per_step, final_loss,
                    digest, peak, launches)
            elif ring is not None:
                model.timings.update(rotation_sec=round(p2p_clock.seconds(), 4),
                                     rotation_bytes=ring.bytes)
                logger.info(
                    "ring-attention fit: process %d of %d at %s (backend %s, "
                    "%s): positions [%d, %d) of %d; %d steps of %d local "
                    "rows; stage %.3f s, train %.3f s, rotation %.3f ms a "
                    "step (%d bytes a step), gradients %.3f ms a step; loss "
                    "%.6f; model digest %s, equal on every process; peak "
                    "device memory %d bytes; attention launches %s",
                    ctx.process_index, ctx.process_count, coords, ctx.backend,
                    dev, c0, c0 + lc, l, n_steps, b_rows, t_stage, t_train,
                    p2p_clock.seconds() * per_step,
                    ring.bytes // max(n_steps, 1), clock.seconds() * per_step,
                    final_loss, digest, peak, launches)
            elif pipe is not None:
                k = cfg.n_layers // pp
                model.timings.update(handoff_sec=round(p2p_clock.seconds(), 4),
                                     handoff_bytes=pipe.bytes)
                logger.info(
                    "pipeline fit: process %d of %d at %s (backend %s, %s): "
                    "pipe stage %d of %d, layers [%d, %d) of %d; %d "
                    "microbatches of %d rows; %d steps of %d local rows; "
                    "stage %.3f s, train %.3f s, handoff %.3f ms a step (%d "
                    "bytes a step), gradients %.3f ms a step; loss %.6f; "
                    "model digest %s, equal on every process; peak device "
                    "memory %d bytes; attention launches %s",
                    ctx.process_index, ctx.process_count, coords, ctx.backend,
                    dev, pipe.stage, pp, pipe.stage * k, (pipe.stage + 1) * k,
                    cfg.n_layers, pipe_m, b_rows // pipe_m, n_steps, b_rows,
                    t_stage, t_train, p2p_clock.seconds() * per_step,
                    pipe.bytes // max(n_steps, 1), clock.seconds() * per_step,
                    final_loss, digest, peak, launches)
            else:
                logger.info(
                    "data-parallel fit: process %d of %d (backend %s, %s): "
                    "%d steps of %d local rows; stage %.3f s, train %.3f s, "
                    "exchange %.3f ms a step; loss %.6f; replica digest %s, "
                    "equal on every process; staged %d rows (%s real); peak "
                    "device memory %d bytes; attention launches %s",
                    ctx.process_index, ctx.process_count, ctx.backend, dev,
                    n_steps, b_rows, t_stage, t_train, exchange * per_step,
                    final_loss, digest, n_batches * b_rows,
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
