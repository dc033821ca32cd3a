"""MLP classifier — the classification template's model, trained on the card.

Counterpart of ``incubator_predictionio_tpu/models/mlp.py`` (the NaiveBayes
replacement of the reference classification template,
NaiveBayesAlgorithm.scala:36-60): a bf16 MLP with fp32 parameters and
optax's adam (``utils/optim.py:adam_update``).

- :class:`MLPNet` keeps the reference's casts (``_forward``, :52-59): the
  input, weights and biases to bf16; each hidden layer ``relu(h @ w + b)``
  in bf16 — the product rounded to bf16 once, then the bias added in bf16
  (never fused into an fp32 ``addmm``); the logits widened to fp32.
- :meth:`MLPClassifier.fit`: numpy normalization (``mean``, ``std +
  1e-8``); the rows padded to whole batches with weight-0 rows and staged on
  the device once; the same batch order every epoch, with no shuffle; the
  weighted softmax cross-entropy ``sum(l·w) / max(sum(w), 1)``; one adam
  step a batch; the last epoch's mean loss is ``final_loss`` (one host sync
  a fit).
- The init draws from an explicit ``torch.Generator`` at He scale
  (``N(0, 2 / d_in)``, zero biases); the reference draws from
  ``jax.random.key(seed)``, so the two packages' inits differ in values
  (the tests carry JAX parameters across with ``convert.py`` and
  monkeypatch :func:`init_params`).
- :class:`MLPModel` pickles host numpy parameters only; its resident
  :class:`MLPNet` (``_net``) is built on the serving device by
  ``prepare_for_serving(ctx)`` (a fit leaves the trained one there) and is
  dropped from the pickled state.

The per-process path (``rows_are_local`` with more than one process)
raises until the sharding slice (ROADMAP.md Queue 1, item 4).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from incubator_predictionio_tpu_torch.models.two_tower import SHARDING_SLICE
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    hidden_dims: tuple[int, ...] = (128, 128)
    learning_rate: float = 1e-3
    batch_size: int = 256
    epochs: int = 50
    seed: int = 0


def init_params(gen: torch.Generator, dims: list[int], device
                ) -> list[dict[str, torch.Tensor]]:
    """He-scaled fp32 weights ``[d_in, d_out]`` from ``gen`` (on the
    generator's device), zero biases, moved to ``device``."""
    layers = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                        device=gen.device) * math.sqrt(2.0 / d_in)
        layers.append({"w": w.to(device),
                       "b": torch.zeros(d_out, dtype=torch.float32, device=device)})
    return layers


class MLPNet(torch.nn.Module):
    """The MLP over fp32 parameters ``[{"w": [d_in, d_out], "b": [d_out]},
    …]`` with the reference forward's bf16 casts."""

    def __init__(self, params: list[dict[str, torch.Tensor]]):
        super().__init__()
        self.weights = torch.nn.ParameterList(
            torch.nn.Parameter(p["w"].detach().clone()) for p in params)
        self.biases = torch.nn.ParameterList(
            torch.nn.Parameter(p["b"].detach().clone()) for p in params)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bf16 = torch.bfloat16
        h = x.to(bf16)
        last = len(self.weights) - 1
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            # the bf16 product is rounded once; the bias is a bf16 add after it
            h = torch.matmul(h, w.to(bf16)) + b.to(bf16)
            if i < last:
                h = torch.relu(h)
        return h.to(torch.float32)

    def host_params(self) -> list[dict[str, np.ndarray]]:
        return [{"w": w.detach().cpu().numpy().copy(),
                 "b": b.detach().cpu().numpy().copy()}
                for w, b in zip(self.weights, self.biases)]


def weighted_xent(logits: torch.Tensor, y: torch.Tensor, w: torch.Tensor
                  ) -> torch.Tensor:
    """``sum(l·w) / max(sum(w), 1)`` of the per-row softmax cross-entropy
    with integer labels (optax's ``softmax_cross_entropy_with_integer_
    labels``), fp32."""
    losses = F.cross_entropy(logits, y, reduction="none")
    return (losses * w).sum() / torch.clamp(w.sum(), min=1.0)


@dataclasses.dataclass
class MLPModel:
    """Trained model: parameters (host numpy) + normalization + label
    vocabulary. ``_net`` is the resident module (derived; never pickled)."""

    params: list[dict[str, np.ndarray]]
    mean: np.ndarray
    std: np.ndarray
    classes: list  # index -> original label value
    config: MLPConfig

    _net = None

    def prepare_for_serving(self, ctx: Optional[DeviceContext] = None
                            ) -> "MLPModel":
        """The parameters onto ``ctx.device`` (the card unless the caller
        passes another context), once; per-query calls then move only the
        feature rows."""
        ctx = ctx or DeviceContext.create()
        params = [{k: torch.from_numpy(np.asarray(v, np.float32)).to(ctx.device)
                   for k, v in layer.items()} for layer in self.params]
        self._net = MLPNet(params).requires_grad_(False).eval()
        return self

    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items() if k != "_net"}

    def warmup(self, max_batch: int = 64) -> int:
        """A forward of one row and of ``max_batch`` rows at deploy, so no
        live query pays for the device libraries' first use."""
        for b in (1, max(1, max_batch)):
            MLPClassifier.logits(self, np.zeros((b, len(self.mean)), np.float32))
        return 2

    def serving_info(self) -> dict:
        """Status-page observability (see TwoTowerModel.serving_info)."""
        dev = None
        if self._net is not None:
            dev = str(next(self._net.parameters()).device)
        return {"path": "device-params", "classes": len(self.classes),
                "device": dev}


class MLPClassifier:
    def __init__(self, config: MLPConfig = MLPConfig()):
        self.config = config

    # -- training ---------------------------------------------------------
    def fit(
        self,
        ctx: DeviceContext,
        x: np.ndarray,
        y: np.ndarray,
        rows_are_local: bool = False,
    ) -> MLPModel:
        """Train on ``ctx.device`` from :func:`init_params`' seeded init
        (the tests monkeypatch it to inject the JAX package's)."""
        cfg = self.config
        if rows_are_local and ctx.process_count > 1:
            raise NotImplementedError(
                "MLPClassifier.fit over per-process rows comes with "
                f"{SHARDING_SLICE}")
        dev = ctx.device
        n, d = x.shape
        classes, y_idx = np.unique(y, return_inverse=True)
        mean = x.mean(axis=0)
        std = x.std(axis=0) + 1e-8
        xn = ((x - mean) / std).astype(np.float32)
        xb, yb, wb = stage_batches(xn, y_idx, cfg.batch_size, ctx, dev)
        dims = [d, *cfg.hidden_dims, len(classes)]
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        net = MLPNet(init_params(gen, dims, dev))
        loss = train_epochs(net, xb, yb, wb, cfg.learning_rate, cfg.epochs)
        model = MLPModel(net.host_params(), mean, std, classes.tolist(), cfg)
        model._net = net.requires_grad_(False).eval()
        model.final_loss = float(loss)  # the one sync
        return model

    # -- inference --------------------------------------------------------
    @staticmethod
    def logits(model: MLPModel, x: np.ndarray) -> np.ndarray:
        if model._net is None:
            model.prepare_for_serving()
        xn = ((x - model.mean) / model.std).astype(np.float32)
        dev = next(model._net.parameters()).device
        with torch.no_grad():
            return model._net(torch.from_numpy(xn).to(dev)).cpu().numpy()

    @staticmethod
    def predict(model: MLPModel, x: np.ndarray) -> np.ndarray:
        idx = MLPClassifier.logits(model, x).argmax(axis=-1)
        return np.asarray([model.classes[i] for i in idx])


def stage_batches(xn: np.ndarray, y_idx: np.ndarray, batch_size: int,
                  ctx: DeviceContext, device):
    """Pad to a whole number of batches (weight-0 rows) and stage on
    ``device`` as ``[n_batches, batch, ...]``: the reference's single-process
    staging (mlp.py:159-176)."""
    n, d = xn.shape
    batch = min(batch_size, ctx.pad_to_batch_multiple(n))
    batch = ctx.pad_to_batch_multiple(batch)
    n_batches = max(1, (n + batch - 1) // batch)
    pad = n_batches * batch - n
    xp = np.concatenate([xn, np.zeros((pad, d), np.float32)])
    yp = np.concatenate([y_idx.astype(np.int64), np.zeros(pad, np.int64)])
    wp = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])

    def stage(a):
        return torch.from_numpy(a.reshape(n_batches, batch, *a.shape[1:])).to(device)

    return stage(xp), stage(yp), stage(wp)


def train_step(net: MLPNet, opt_state, bx, by, bw, lr: float) -> torch.Tensor:
    """One adam step on one batch; returns the batch's loss (on the
    device, detached)."""
    from incubator_predictionio_tpu_torch.utils.optim import adam_update

    params = list(net.parameters())
    loss = weighted_xent(net(bx), by, bw)
    grads = torch.autograd.grad(loss, params)
    adam_update([p.data for p in params], grads, opt_state, lr)
    return loss.detach()


def train_epochs(net: MLPNet, xb, yb, wb, lr: float, epochs: int
                 ) -> torch.Tensor:
    """``epochs`` passes over the staged batches in order (the reference's
    ``lax.scan`` per epoch), one adam state for the fit; returns the last
    epoch's mean loss as a device scalar (``inf`` with no epoch)."""
    from incubator_predictionio_tpu_torch.utils.optim import adam_init

    state = adam_init([p.data for p in net.parameters()])
    loss = torch.tensor(float("inf"), device=xb.device)
    for _ in range(epochs):
        total = torch.zeros((), dtype=torch.float32, device=xb.device)
        for bx, by, bw in zip(xb, yb, wb):
            total += train_step(net, state, bx, by, bw, lr)
        loss = total / xb.shape[0]
    return loss
