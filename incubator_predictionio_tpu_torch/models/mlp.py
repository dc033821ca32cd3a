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

Under several processes the fit is data-parallel (reference mlp.py:119-205,
the transformer's pattern, ``models/transformer.py``): every process steps
on its share of each global batch over the global batch's weight sum, one
all-reduce of the flattened gradients a step, the same adam on every
replica, and :func:`~incubator_predictionio_tpu_torch.parallel.mesh.check_replicas`
at the end.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from incubator_predictionio_tpu_torch.parallel.mesh import (
    CollectiveClock,
    DeviceContext,
    check_replicas,
)

logger = logging.getLogger(__name__)


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


def weighted_xent(logits: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                  denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sum(l·w) / max(sum(w), 1)`` of the per-row softmax cross-entropy
    with integer labels (optax's ``softmax_cross_entropy_with_integer_
    labels``), fp32. ``denom`` replaces ``max(sum(w), 1)``: a data-parallel
    step divides its local sum by the global batch's."""
    losses = F.cross_entropy(logits, y, reduction="none")
    if denom is None:
        denom = torch.clamp(w.sum(), min=1.0)
    return (losses * w).sum() / denom


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
        (the tests monkeypatch it to inject the JAX package's).

        ``ctx.process_count > 1``: data-parallel over the context's process
        group (mlp.py:119-205). ``rows_are_local=True``: (x, y) are only
        THIS process's entity-disjoint shard; the classes are the sorted
        union of the shards' labels, the normalization the global moments
        from the shards' ``(n, Σx, Σx²)`` in float64 (``var = max(Σx²/n −
        mean², 0)``, not the one-process ``x.std()``), and the rows are
        staged by ``parallel/staging.py``. Otherwise every process holds
        every row, stages the global batches as one process does and takes
        its slice of each on the data axis. Each step runs forward and
        backward on the local batch over the global batch's weight sum
        (gathered once at staging), one all-reduce of the flattened
        gradients, then the same adam on every replica; the replicas are
        proven equal at the end."""
        cfg = self.config
        multi = ctx.process_count > 1
        dev = ctx.device
        n, d = x.shape
        t_stage = time.perf_counter()
        staged_real = None
        if multi and rows_are_local:
            from incubator_predictionio_tpu_torch.data.sharded import (
                global_sum,
                union_label_set,
            )
            from incubator_predictionio_tpu_torch.parallel.staging import (
                stage_sharded_batches,
            )

            classes = np.asarray(union_label_set(ctx, y.tolist()))
            cls_index = {c: i for i, c in enumerate(classes.tolist())}
            y_idx = np.asarray([cls_index[v] for v in y.tolist()], np.int32)
            # the global feature moments from the shards' (n, Σx, Σx²)
            n_g, sx, sxx = global_sum(
                ctx, (n, x.sum(axis=0, dtype=np.float64),
                      (x.astype(np.float64) ** 2).sum(axis=0)))
            mean = (sx / max(n_g, 1)).astype(x.dtype)
            var = np.maximum(sxx / max(n_g, 1) - mean.astype(np.float64) ** 2, 0.0)
            std = (np.sqrt(var) + 1e-8).astype(x.dtype)
            xn = ((x - mean) / std).astype(np.float32)
            (xb, yb), wb, _ = stage_sharded_batches(
                ctx, (xn, y_idx), cfg.batch_size, cfg.seed, n_global=n_g)
            yb = yb.long()
            staged_real = int(wb.sum())
        else:
            classes, y_idx = np.unique(y, return_inverse=True)
            mean = x.mean(axis=0)
            std = x.std(axis=0) + 1e-8
            xn = ((x - mean) / std).astype(np.float32)
            xb, yb, wb = stage_batches(xn, y_idx, cfg.batch_size, ctx, dev)
        # each global batch's loss denominator, max(Σ w, 1), once: a sum of
        # 0/1 weights, exact in fp32 in any order
        denoms = (ctx.all_reduce_sum(wb.sum(1)).clamp(min=1.0)
                  if multi else None)
        t_stage = time.perf_counter() - t_stage
        dims = [d, *cfg.hidden_dims, len(classes)]
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        net = MLPNet(init_params(gen, dims, dev))
        clock = CollectiveClock(dev)
        t_train = time.perf_counter()
        loss = train_epochs(
            net, xb, yb, wb, cfg.learning_rate, cfg.epochs, denoms=denoms,
            all_reduce=(lambda t: clock.time(lambda: ctx.all_reduce_sum(t)))
            if multi else None)
        if multi:  # the local shares of the step losses summed once
            loss = clock.time(lambda: ctx.all_reduce_sum(loss))
        final_loss = float(loss)  # the one sync
        t_train = time.perf_counter() - t_train
        params = net.host_params()
        model = MLPModel(params, mean, std, classes.tolist(), cfg)
        model._net = net.requires_grad_(False).eval()
        model.final_loss = final_loss
        if multi:
            digest = check_replicas(
                ctx, [a for layer in params for a in layer.values()])
            n_steps = cfg.epochs * xb.shape[0]
            exchange = clock.seconds()
            peak = (torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else 0)
            logger.info(
                "data-parallel fit: process %d of %d (backend %s, %s): %d "
                "steps of %d local rows; stage %.3f s, train %.3f s, "
                "exchange %.3f ms a step; loss %.6f; replica digest %s, equal "
                "on every process; staged %d rows (%s real); peak device "
                "memory %d bytes", ctx.process_index, ctx.process_count,
                ctx.backend, dev, n_steps, xb.shape[1], t_stage, t_train,
                exchange / max(n_steps, 1) * 1e3, final_loss, digest,
                xb.shape[0] * xb.shape[1],
                staged_real if staged_real is not None else "all", peak)
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
    """Pad to a whole number of global batches (weight-0 rows) and stage on
    ``device`` as ``[n_batches, batch, ...]``: the reference's staging of
    replicated rows (mlp.py:159-176). Under several processes each keeps
    its slice of every global batch on the data axis."""
    n, d = xn.shape
    batch = min(batch_size, ctx.pad_to_batch_multiple(n))
    batch = ctx.pad_to_batch_multiple(batch)
    n_batches = max(1, (n + batch - 1) // batch)
    pad = n_batches * batch - n
    xp = np.concatenate([xn, np.zeros((pad, d), np.float32)])
    yp = np.concatenate([y_idx.astype(np.int64), np.zeros(pad, np.int64)])
    wp = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    b_local = batch // ctx.process_count
    cols = slice(ctx.process_index * b_local, (ctx.process_index + 1) * b_local)

    def stage(a):
        a = a.reshape(n_batches, batch, *a.shape[1:])[:, cols]
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return stage(xp), stage(yp), stage(wp)


def train_step(net: MLPNet, opt_state, bx, by, bw, lr: float, denom=None,
               all_reduce: Optional[Callable] = None) -> torch.Tensor:
    """One adam step on one batch; returns the batch's loss (on the
    device, detached). A data-parallel step passes the global batch's
    ``denom`` and ``all_reduce``, which sums the flattened gradients over
    the processes (the gradient of the global batch, the same bytes on
    every replica)."""
    from incubator_predictionio_tpu_torch.utils.optim import adam_update

    params = list(net.parameters())
    loss = weighted_xent(net(bx), by, bw, denom)
    grads = torch.autograd.grad(loss, params)
    if all_reduce is not None:
        flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]))
        grads = [g.view_as(p) for g, p in
                 zip(flat.split([p.numel() for p in params]), params)]
    adam_update([p.data for p in params], grads, opt_state, lr)
    return loss.detach()


def train_epochs(net: MLPNet, xb, yb, wb, lr: float, epochs: int,
                 denoms=None, all_reduce: Optional[Callable] = None
                 ) -> torch.Tensor:
    """``epochs`` passes over the staged batches in order (the reference's
    ``lax.scan`` per epoch), one adam state for the fit; returns the last
    epoch's mean loss as a device scalar (``inf`` with no epoch). A
    data-parallel fit passes each global batch's ``denoms`` and the
    gradients' ``all_reduce`` (:func:`train_step`); its loss is then this
    process's share of the mean."""
    from incubator_predictionio_tpu_torch.utils.optim import adam_init

    state = adam_init([p.data for p in net.parameters()])
    loss = torch.tensor(float("inf"), device=xb.device)
    for _ in range(epochs):
        total = torch.zeros((), dtype=torch.float32, device=xb.device)
        for i, (bx, by, bw) in enumerate(zip(xb, yb, wb)):
            total += train_step(net, state, bx, by, bw, lr,
                                None if denoms is None else denoms[i],
                                all_reduce)
        loss = total / xb.shape[0]
    return loss
