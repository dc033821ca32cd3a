"""Incremental embedding-row trainer: gather → adam step → scatter.

Counterpart of ``incubator_predictionio_tpu/streaming/trainer.py``
(``DeltaTrainer``, ``FoldResult``, ``PoisonEvent``, ``fused_fold_mode``).
Folding a batch of live events touches only the embedding rows the batch
names: gather the touched user/item rows, run the adam math of the full
trainer (fp32), scatter the updated rows back into a **sparse working
state** (row overlays + per-row adam moments) that the updater persists
with its cursor, so a crash replays the uncommitted batch onto the same
state.

- **Absolute rows out.** A fold returns the post-step values of every row
  it touched; deltas compose by overwrite and replay is idempotent.
- **Per-row adam moments.** A row's step count advances only when the row
  trains (the sparse-adam convention).
- **Cold-start rows.** Events naming entities outside the vocab train the
  hash-bucket rows (``PIO_COLDSTART_MODE=hash``) or are counted skipped.
- **Poison events dead-letter.** An event the fold cannot interpret raises
  ``PoisonEvent``; the updater diverts it to the dead-letter file.

The trainer has a ``device`` (CUDA unless the caller names another). Its
micro-batch adam step runs where ``PIO_STREAM_FUSED`` says, as in the
reference: ``auto`` (the default) and ``1`` the host fused pass
(``ops/sparse_update.py`` ``fused_adam_rows``), ``0`` the per-row loop,
and ``device`` kernel K3 on the trainer's device
(``fused_adam_rows_device``). Each fold's phases (assemble / compute /
gather, seconds) go to the profiler's ``stream.fold`` buckets
(``obs/profile.py``), as in the reference; the last fold's are also kept
in :attr:`DeltaTrainer.last_phases`.
"""

from __future__ import annotations

import dataclasses
import os
import time as _time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from incubator_predictionio_tpu_torch.data.event import Event, epoch_micros
from incubator_predictionio_tpu_torch.obs import profile as _profile
from incubator_predictionio_tpu_torch.ops import sparse_update
from incubator_predictionio_tpu_torch.streaming import stream_metrics
from incubator_predictionio_tpu_torch.streaming.coldstart import (
    ColdStartBuckets,
    coldstart_mode,
)


def fused_fold_mode() -> str:
    """``PIO_STREAM_FUSED``: ``auto`` | ``1`` | ``0`` | ``device``.

    ``auto`` and ``1`` step each touched-row micro-batch through the host
    fused pass (bitwise the per-row loop), whatever the trainer's device,
    ``0`` keeps the per-row reference loop, and ``device`` runs kernel K3
    on the trainer's device."""
    val = os.environ.get("PIO_STREAM_FUSED", "auto").strip().lower()
    if val not in ("auto", "1", "0", "device"):
        raise ValueError(
            f"PIO_STREAM_FUSED={val!r} (want auto|1|0|device)")
    return val


class PoisonEvent(ValueError):
    """An event the fold can never interpret — dead-letter it, don't retry."""


@dataclasses.dataclass
class FoldResult:
    """One batch's outcome: rows touched (absolute values), bookkeeping."""

    user_rows: dict[int, np.ndarray]
    item_rows: dict[int, np.ndarray]
    cold_user_rows: dict[int, np.ndarray]
    cold_item_rows: dict[int, np.ndarray]
    n_folded: int = 0
    n_skipped: int = 0       # unknown entities with cold-start off
    n_ignored: int = 0       # event names outside the training signal
    max_event_time_us: int = 0


class DeltaTrainer:
    """Sparse online trainer over one base model's tables.

    ``base_*`` arrays are read-only references to the deployed model's host
    tables; all mutation happens in the overlay dicts. ``micro_batch``
    bounds the vectorized step size — events fold in arrival order, so the
    result is deterministic given (state, events)."""

    def __init__(
        self,
        user_emb: np.ndarray, user_bias: np.ndarray,
        item_emb: np.ndarray, item_bias: np.ndarray,
        mean: float,
        user_index: dict, item_index: dict,
        learning_rate: float = 3e-2,
        reg: float = 1e-4,
        event_names: Sequence[str] = ("rate", "buy"),
        value_property: str = "rating",
        default_values: Optional[dict] = None,
        coldstart: Optional[ColdStartBuckets] = None,
        micro_batch: int = 256,
        device: Union[str, torch.device, None] = None,
    ):
        self.device = torch.device("cuda" if device is None else device)
        self._base = {
            "u": (np.asarray(user_emb, np.float32),
                  np.asarray(user_bias, np.float32)),
            "i": (np.asarray(item_emb, np.float32),
                  np.asarray(item_bias, np.float32)),
        }
        self.rank = self._base["u"][0].shape[1]
        self.mean = float(mean)
        self.user_index = user_index
        self.item_index = item_index
        self.lr = float(learning_rate)
        self.reg = float(reg)
        self.event_names = tuple(event_names)
        self.value_property = value_property
        self.default_values = dict(default_values or {"buy": 4.0})
        self.micro_batch = max(1, micro_batch)
        mode = coldstart_mode()
        if coldstart is None and mode == "hash":
            coldstart = ColdStartBuckets.build(self.rank)
        self.coldstart = coldstart
        # sparse working state: key -> np arrays. Keys are ("u"|"i", idx)
        # for table rows, ("cu"|"ci", bucket) for cold-start rows.
        self.rows: dict[tuple, np.ndarray] = {}
        self.m: dict[tuple, np.ndarray] = {}
        self.v: dict[tuple, np.ndarray] = {}
        self.t: dict[tuple, int] = {}
        self.n_folded = 0
        #: seconds of the last fold's phases: event translation
        #: (assemble), micro-batch adam steps (compute), touched-row
        #: copy-out (gather)
        self.last_phases: dict[str, float] = {}

    # -- state persistence (rides the updater's atomic state commit) ------
    def to_state(self) -> dict:
        return {
            "rows": self.rows, "m": self.m, "v": self.v, "t": self.t,
            "n_folded": self.n_folded,
            "coldstart": self.coldstart,
        }

    def load_state(self, state: dict) -> None:
        self.rows = state["rows"]
        self.m = state["m"]
        self.v = state["v"]
        self.t = state["t"]
        self.n_folded = state["n_folded"]
        if state.get("coldstart") is not None:
            self.coldstart = state["coldstart"]

    # -- row access -------------------------------------------------------
    def current_row(self, key: tuple) -> np.ndarray:
        """Current fused ``[rank+1]`` row (overlay, else base/cold init)."""
        row = self.rows.get(key)
        if row is not None:
            return row
        kind, idx = key
        if kind in ("u", "i"):
            emb, bias = self._base[kind]
            return np.concatenate([emb[idx], [bias[idx]]]).astype(np.float32)
        cs = self.coldstart
        if cs is None:
            raise KeyError(f"cold-start row {key} without coldstart mode")
        return (cs.user_rows[idx] if kind == "cu"
                else cs.item_rows[idx]).astype(np.float32)

    # -- event translation ------------------------------------------------
    def _rating_of(self, event: Event) -> float:
        props = event.properties or {}
        if self.value_property in props:
            v = props[self.value_property]
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise PoisonEvent(
                    f"event {event.event_id}: property "
                    f"{self.value_property!r}={v!r} is not numeric")
            v = float(v)
            if not np.isfinite(v):
                raise PoisonEvent(
                    f"event {event.event_id}: non-finite rating {v!r}")
            return v
        if event.event in self.default_values:
            return float(self.default_values[event.event])
        return 0.0  # assemble_triples' missing_value convention

    def _keys_of(self, event: Event) -> Optional[tuple[tuple, tuple]]:
        """(user_key, item_key) for a trainable event, or None to skip."""
        if event.target_entity_id is None:
            raise PoisonEvent(
                f"event {event.event_id}: {event.event!r} without a "
                "target entity")
        uidx = self.user_index.get(event.entity_id)
        iidx = self.item_index.get(event.target_entity_id)
        cs = self.coldstart
        if uidx is None:
            if cs is None:
                return None
            ukey = ("cu", cs.user_bucket(event.entity_id))
        else:
            ukey = ("u", int(uidx))
        if iidx is None:
            if cs is None:
                return None
            ikey = ("ci", cs.item_bucket(event.target_entity_id))
        else:
            ikey = ("i", int(iidx))
        return ukey, ikey

    # -- the fold ---------------------------------------------------------
    def fold(self, events: Sequence[Event]) -> tuple[FoldResult, list[Event]]:
        """Fold a batch of events into the working state. Returns the
        touched-row result and the list of poison events (dead-letter
        candidates) — the good events still fold; one bad apple never
        blocks the batch."""
        t_phase = _time.perf_counter()
        triples: list[tuple[tuple, tuple, float, int]] = []
        poison: list[Event] = []
        skipped = ignored = 0
        max_t_us = 0
        for e in events:
            if e.event not in self.event_names:
                ignored += 1
                continue
            try:
                keys = self._keys_of(e)
                if keys is None:
                    skipped += 1
                    continue
                rating = self._rating_of(e)
            except PoisonEvent:
                poison.append(e)
                continue
            max_t_us = max(max_t_us, epoch_micros(e.event_time))
            triples.append((keys[0], keys[1], rating, 0))
        t_assemble, t_phase = _time.perf_counter() - t_phase, _time.perf_counter()
        touched: set[tuple] = set()
        for lo in range(0, len(triples), self.micro_batch):
            batch = triples[lo:lo + self.micro_batch]
            touched.update(self._step(batch))
        self.n_folded += len(triples)
        # no fence needed: under PIO_STREAM_FUSED=device each micro-batch's
        # K3 rows come back through the staged host copy inside _step
        # (fused_adam_rows_device waits for it), so the kernel's time is
        # already in compute when the clock is read
        t_compute, t_phase = _time.perf_counter() - t_phase, _time.perf_counter()
        result = FoldResult(
            user_rows={}, item_rows={}, cold_user_rows={}, cold_item_rows={},
            n_folded=len(triples), n_skipped=skipped, n_ignored=ignored,
            max_event_time_us=max_t_us,
        )
        dest = {"u": result.user_rows, "i": result.item_rows,
                "cu": result.cold_user_rows, "ci": result.cold_item_rows}
        for key in touched:
            dest[key[0]][key[1]] = self.rows[key].copy()
        # the profiler's phases: event translation (assemble), micro-batch
        # adam steps (compute), touched-row copy-out (gather)
        self.last_phases = {
            "assemble": t_assemble, "compute": t_compute,
            "gather": _time.perf_counter() - t_phase,
        }
        _profile.record_phases("stream.fold", self.last_phases)
        return result, poison

    def _step(self, batch: list[tuple[tuple, tuple, float, int]]) -> set:
        """One micro-batch SGD/adam step — the numpy mirror of the full
        trainer's loss (models/two_tower.py ``_train_epochs``): squared
        error on (dot + biases) against mean-centered ratings, L2 on the
        embedding parts, gradients averaged over the batch, per-row adam."""
        if not batch:
            return set()
        b = len(batch)
        k = self.rank
        ukeys = [t[0] for t in batch]
        ikeys = [t[1] for t in batch]
        urows = np.stack([self.current_row(key) for key in ukeys])
        irows = np.stack([self.current_row(key) for key in ikeys])
        ratings = np.asarray([t[2] for t in batch], np.float32) - self.mean
        ue, bu = urows[:, :k], urows[:, k]
        ie, bi = irows[:, :k], irows[:, k]
        pred = np.einsum("bk,bk->b", ue, ie) + bu + bi
        err = pred - ratings
        denom = float(b)
        # d(mse)/d(pred) = 2 err / denom; l2 adds 2 reg emb / denom
        gp = (2.0 * err / denom)[:, None]
        g_u = np.concatenate(
            [gp * ie + (2.0 * self.reg / denom) * ue, gp], axis=1)
        g_i = np.concatenate(
            [gp * ue + (2.0 * self.reg / denom) * ie, gp], axis=1)
        # duplicate rows in one batch accumulate their gradients first
        # (matching a dense scatter-add), then take ONE adam step
        grads: dict[tuple, np.ndarray] = {}
        for key, g in zip(ukeys, g_u):
            acc = grads.get(key)
            grads[key] = g.copy() if acc is None else acc + g
        for key, g in zip(ikeys, g_i):
            acc = grads.get(key)
            grads[key] = g.copy() if acc is None else acc + g
        mode = fused_fold_mode()
        if mode == "0":
            # per-row reference loop — the bitwise oracle of the fused paths
            for key, g in grads.items():
                self._adam(key, g)
        else:
            self._fused_adam(grads, device=(mode == "device"))
        return set(grads)

    def _fused_adam(self, grads: dict[tuple, np.ndarray],
                    device: bool = False) -> None:
        """Fused gather→adam→scatter over the micro-batch's touched rows:
        ONE stacked gather on the host, one vectorized adam (the host pass,
        or kernel K3 on the trainer's device with one copy each way when
        ``device``), one scatter back into the working state."""
        keys = list(grads)
        d = self.rank + 1
        rows = np.stack([self.current_row(key) for key in keys]).astype(
            np.float32, copy=False)
        m = np.stack([
            self.m[key] if key in self.m else np.zeros(d, np.float32)
            for key in keys])
        v = np.stack([
            self.v[key] if key in self.v else np.zeros(d, np.float32)
            for key in keys])
        g = np.stack([grads[key] for key in keys]).astype(
            np.float32, copy=False)
        t_new = np.asarray([self.t.get(key, 0) + 1 for key in keys],
                           np.int64)
        if device:
            rows, m, v = sparse_update.fused_adam_rows_device(
                rows, m, v, g, t_new, self.lr, device=self.device)
        else:
            rows, m, v = sparse_update.fused_adam_rows(
                rows, m, v, g, t_new, self.lr)
        for j, key in enumerate(keys):
            # .copy(): detach each row from the batch stack so the working
            # state never keeps whole micro-batch buffers alive per key
            self.rows[key] = rows[j].copy()
            self.m[key] = m[j].copy()
            self.v[key] = v[j].copy()
            self.t[key] = int(t_new[j])
        stream_metrics.FUSED_STEPS.inc()

    def _adam(self, key: tuple, g: np.ndarray,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
        """Per-row adam, the ``utils/optim.adam_apply`` math element-wise
        (fp32 moments; bias correction by this ROW's step count)."""
        row = self.current_row(key).astype(np.float32, copy=True)
        m = self.m.get(key)
        v = self.v.get(key)
        if m is None:
            m = np.zeros_like(row)
            v = np.zeros_like(row)
        t = self.t.get(key, 0) + 1
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * (g * g)
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        row -= self.lr * (m / bc1) / (np.sqrt(v / bc2) + eps)
        self.rows[key] = row
        self.m[key] = m
        self.v[key] = v
        self.t[key] = t
