"""Sequential-recommendation transformer — the serving side.

Counterpart of ``incubator_predictionio_tpu/models/transformer.py``
(SASRec/Transformer4Rec-style: a causal transformer over left-padded
session item sequences, next-item logits tied to the item embedding). This
slice ports what serving runs: :class:`TransformerConfig`, the dense
forward (``_ln``, ``_bf16_matmul``, ``_apply_layer``, ``_forward``,
``_serve_scores``), :class:`TransformerModel` and
``TransformerRecommender.next_item_scores``. Training (``fit``, the K4/K5
backward kernels, ``ops/xent.py``, adam) is the sequential training slice
(ROADMAP.md Queue 1, item 1); MoE serving and ring attention come with
the sharding slice (item 4).

Numerics follow the reference: every matmul rounds both operands and the
product to bf16 (``_bf16_matmul``), so served scores are bf16 values and
ties are common; layer norm has eps 1e-6 and the population variance;
``gelu`` is the tanh approximation (``jax.nn.gelu``'s default); left
padding is NOT masked (pad tokens attend and are attended to, at absolute
positions), exactly as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext
from incubator_predictionio_tpu_torch.parallel.ring import causal_attention

#: what raises in the stages this slice does not port
TRAINING_SLICE = ("the sequential training slice of the PyTorch port "
                  "(ROADMAP.md Queue 1, item 1: fit, the K4/K5 backward "
                  "kernels, ops/xent.py, adam)")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Copy of the reference's config (transformer.py:44), every field, so a
    variant or a persisted config binds unchanged. Serving reads the model
    shape; the training, parallelism and checkpoint fields wait for their
    slices."""

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


def _ln(x, g, b):
    """transformer.py:123: ``(x - mean) · rsqrt(var + 1e-6) · g + b`` with
    the population variance."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + 1e-6) * g + b


def _bf16_matmul(x, w_bf16):
    """transformer.py:129: both operands and the product in bf16 (the
    product accumulates in fp32 and rounds once), upcast to fp32. The
    weight arrives already in bf16."""
    return torch.matmul(x.to(torch.bfloat16), w_bf16).float()


class _Layer(nn.Module):
    """One dense transformer block's weights (the reference's ``layers[i]``
    dict): projections kept in bf16 (``_bf16_matmul`` rounds them on every
    call; rounding once at deploy gives the same values), norms and biases
    in fp32. Buffers, not parameters: serving computes no gradient."""

    def __init__(self, layer: dict, device: torch.device):
        super().__init__()

        def put(name, a, dtype=torch.float32):
            self.register_buffer(name, torch.as_tensor(
                np.asarray(a, np.float32)).to(device=device, dtype=dtype))

        for name in ("wq", "wk", "wv", "wo", "w1", "w2"):
            put(name, layer[name], torch.bfloat16)
        put("ln1_g", layer["ln1"]["g"])
        put("ln1_b", layer["ln1"]["b"])
        put("ln2_g", layer["ln2"]["g"])
        put("ln2_b", layer["ln2"]["b"])
        put("b1", layer["b1"])
        put("b2", layer["b2"])

    def forward(self, h, n_heads: int, attention: Callable):
        """transformer.py:196 ``_apply_layer``, the dense branch."""
        b, l, d = h.shape
        dh = d // n_heads
        x = _ln(h, self.ln1_g, self.ln1_b)
        q = _bf16_matmul(x, self.wq).reshape(b, l, n_heads, dh)
        k = _bf16_matmul(x, self.wk).reshape(b, l, n_heads, dh)
        v = _bf16_matmul(x, self.wv).reshape(b, l, n_heads, dh)
        att = attention(q, k, v)
        h = h + _bf16_matmul(att.reshape(b, l, d), self.wo)
        x = _ln(h, self.ln2_g, self.ln2_b)
        x = F.gelu(_bf16_matmul(x, self.w1) + self.b1, approximate="tanh")
        return h + _bf16_matmul(x, self.w2) + self.b2


class TransformerNet(nn.Module):
    """The served layer stack on one explicit device."""

    def __init__(self, params: dict, cfg: TransformerConfig,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(device)

        self.register_buffer("item_emb", t(params["item_emb"]))
        self.register_buffer("item_emb_bf16", self.item_emb.to(torch.bfloat16))
        self.register_buffer("pos_emb", t(params["pos_emb"]))
        self.register_buffer("lnf_g", t(params["ln_f"]["g"]))
        self.register_buffer("lnf_b", t(params["ln_f"]["b"]))
        self.layers = nn.ModuleList(_Layer(p, device) for p in params["layers"])

    def forward(self, tokens, positions, attention: Callable = causal_attention):
        """transformer.py:218 ``_forward``: tokens, positions ``[B, L]``
        int → hidden ``[B, L, D]`` fp32 after the final norm."""
        h = self.item_emb[tokens] + self.pos_emb[positions]
        for layer in self.layers:
            h = layer(h, self.cfg.n_heads, attention)
        return _ln(h, self.lnf_g, self.lnf_b)

    def serve_scores(self, tokens, attention: Callable = causal_attention):
        """transformer.py:624 ``_serve_scores``: the newest (last) position's
        hidden state against the tied item embedding → ``[B, vocab]`` fp32
        (bf16 values). ``attention`` is the attention function; the default
        is the serving one, and a check may pass the plain version."""
        b, l = tokens.shape
        positions = torch.arange(l, device=tokens.device).expand(b, l)
        last = self.forward(tokens, positions, attention)[:, -1, :]
        return _bf16_matmul(last, self.item_emb_bf16.T)


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
                "Queue 1, item 4: expert parallelism and MoE serving)")
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

    def fit(self, ctx, sequences, item_map, rows_are_local: bool = False):
        raise NotImplementedError(
            f"TransformerRecommender.fit is ported by {TRAINING_SLICE}")

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
