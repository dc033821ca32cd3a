"""Sharded serving: per-shard top-k + cross-shard merge over the local cards.

Counterpart of ``incubator_predictionio_tpu/sharding/serve.py``. The
reference runs its sharded serving in one process over that process's
local devices (its ``_serve_mesh``, serve.py:284-293, is the first
``n_shards`` of ``jax.devices()``); so does the port: shard ``s`` lives on
``devices[s]``, the first ``n_shards`` local cards (or ``n_shards`` entries
of the CPU), and retrieval runs where the rows live:

- **Device-exact** (:class:`ShardedServing` with device state): each
  shard's item block stays resident on its card as a ``[rank,
  rows_per_shard]`` bf16-rounded column block. A batch runs, on every
  shard's own card, the single-device exact scoring expression of
  ``models/two_tower.py`` (``_exact_scores``) on that shard's columns and a
  local top-k of ``kl = min(k, rows_per_shard)``; only the ``[b, kl]``
  ids and scores cross to the first card, where one top-k merges them and
  one device→host copy returns ids and scores together. Every shard's work
  is queued before the first wait, so the cards score at the same time.
- **Host-exact** (per-shard numpy blocks): the reference's CPU-parity
  twin — the same per-shard slice math, bitwise the single-host numpy
  path (and the JAX package's host-sharded answers).
- **Sharded two-stage** (per-shard :class:`~incubator_predictionio_tpu_torch.
  serving.ann.IVFIndex`): each shard clusters ONLY its local rows and
  prunes with its own centroids — kernel K2 on its card in device mode, on
  the model's device in host mode; the cross-shard merge reranks the
  surviving candidates. Any shard that cannot cover the requested top-k
  with finite-scored candidates falls the whole batch back to the
  sharded-exact path (counted).
- **Streaming deltas** route to the owning shard
  (:meth:`ShardedServing.with_row_updates`): only the owner's block (and
  its IVF staleness overlay) is rebuilt; other shards' tensors are shared
  with the receiver, which is never mutated.

Merge semantics: per-shard candidates arrive best-first per shard (the
port's ``_top_k``, ``lax.top_k``'s order), concatenated in ascending
global-row order, so score ties resolve to the lowest global id, as
``lax.top_k`` does on the full score row; padded rows (``-inf`` base mask,
highest ids) are never returned.

Env knobs (the reference's, docs/configuration.md): ``PIO_SHARD_SERVE`` =
``auto`` (shard when the simulated HBM budget says one card can't hold the
catalog) | ``1`` (always; host models get virtual shards) | ``0`` (never);
``PIO_SHARD_SERVE_SHARDS`` overrides the shard count.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from incubator_predictionio_tpu_torch.serving.topk import merge_topk
from incubator_predictionio_tpu_torch.obs import profile as _profile
from incubator_predictionio_tpu_torch.sharding import shard_metrics as M
from incubator_predictionio_tpu_torch.sharding.table import (
    ShardSpec,
    array_model_shards,
    hbm_budget,
)

#: How many serving shards the CPU offers. The reference counts
#: ``len(jax.devices())``, and its tier-1 forces 8 host devices on the CPU
#: backend (``--xla_force_host_platform_device_count=8``,
#: tests/conftest.py:15-18), so its multi-shard device code runs there; the
#: port's CPU has the same 8, and its tests run the same code.
CPU_SERVE_DEVICES = 8


def local_device_count(device_type: str) -> int:
    """Local devices of ``device_type`` a serving process can shard over:
    the cards on CUDA, :data:`CPU_SERVE_DEVICES` on the CPU."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    return CPU_SERVE_DEVICES


# -- mode selection ----------------------------------------------------------

def serve_mode() -> str:
    """``PIO_SHARD_SERVE``: ``auto`` | ``on`` | ``off``."""
    raw = os.environ.get("PIO_SHARD_SERVE", "auto").strip().lower()
    mode = {"auto": "auto", "1": "on", "on": "on", "force": "on",
            "0": "off", "off": "off"}.get(raw)
    if mode is None:
        raise ValueError(
            f"PIO_SHARD_SERVE={raw!r} (want auto|1|0)")
    return mode


def forced_shards() -> Optional[int]:
    raw = os.environ.get("PIO_SHARD_SERVE_SHARDS", "").strip()
    if not raw:
        return None
    n = int(raw)
    return n if n > 1 else None


def requested_shards(n_items: int, rank: int, tables=None,
                     device_type: str = "cuda") -> int:
    """How many shards serving should use for this model right now
    (0/1 = stay on the single-device paths).

    ``auto`` engages only when the layout already says sharded or the
    simulated HBM budget says the single-card serving residency does not
    fit; ``on`` engages whenever more than one shard is realizable (forced
    count, or one per local device)."""
    mode = serve_mode()
    if mode == "off":
        return 0
    ndev = local_device_count(device_type)
    forced = forced_shards()
    if mode == "on":
        # at least 2: virtual host shards don't need devices, and "always"
        # must mean always — a single-device box still gets the sharded
        # host twin (device tables clamp to the device count at build)
        return forced or max(ndev, 2)
    # auto
    if tables is not None and "ie" in tables:
        if array_model_shards(tables["ie"]) > 1:
            return forced or max(ndev, 1)
    budget = hbm_budget()
    if budget is not None:
        one = ShardSpec("ie", n_items, rank + 1, 1)
        if one.shard_table_bytes() > budget:
            return forced or max(ndev, 1)
    return 0


def shard_build_key(n_local: int, shard: int) -> dict:
    """Per-shard IVF build key: the global build key at the shard's local
    catalog size, seed decorrelated per shard (two shards' k-means should
    not mirror each other's clustering noise)."""
    from incubator_predictionio_tpu_torch.serving import ann

    key = ann.build_key(n_local)
    key["n_items"] = n_local
    key["seed"] = int(key["seed"]) * 1000 + shard
    key["shard"] = shard
    return key


def build_or_reuse_shard_ivf(spec: ShardSpec, rows_fn,
                             persisted: Optional[list] = None) -> list:
    """One IVF partition per shard over its LOCAL rows; a persisted shard
    index whose build key still matches is rehydrated (one O(shard) pull)
    instead of re-clustered. ``rows_fn(s) -> (item_emb, item_bias)`` pulls
    one shard's real rows — callers bound peak host memory to a shard."""
    from incubator_predictionio_tpu_torch.serving import ann

    out = []
    for s in range(spec.n_shards):
        lo, hi = spec.shard_bounds(s)
        n_local = hi - lo
        if n_local <= 0:
            out.append(None)
            continue
        key = shard_build_key(n_local, s)
        idx = None
        if persisted is not None and s < len(persisted) \
                and persisted[s] is not None and persisted[s].matches(key):
            idx = persisted[s]
            if not idx.hydrated:
                idx.rehydrate(*rows_fn(s))
        if idx is None:
            idx = ann.build_ivf(*rows_fn(s), key=key)
        out.append(idx)
    return out


def _pull_device_shard_rows(spec: ShardSpec, shard: int, tables,
                            ) -> tuple[np.ndarray, np.ndarray]:
    """ONE shard's real ``(item_emb, item_bias)`` pulled from the resident
    tables — the bounded-peak alternative to a full-table copy (behind both
    the train-time and the deploy-time per-shard pulls)."""
    k = spec.width - 1
    lo, hi = spec.shard_bounds(shard)
    tp = tables["ie"][lo:hi].cpu().numpy()
    return (np.ascontiguousarray(tp[:, :k], dtype=np.float32),
            np.ascontiguousarray(tp[:, k], dtype=np.float32))


def model_shard_rows(model, spec: ShardSpec):
    """``rows_fn(s)`` over a model's item side — host slices when the
    towers are host numpy, per-shard device pulls (never the full table)
    when they are device-resident."""

    def rows(s: int):
        if model.item_emb is not None:
            lo, hi = spec.shard_bounds(s)
            return (np.asarray(model.item_emb[lo:hi], np.float32),
                    np.asarray(model.item_bias[lo:hi], np.float32))
        return _pull_device_shard_rows(spec, s, model._tables)

    return rows


def model_device_type(model) -> str:
    """The device type a model serves on: its serving device once
    prepared, else its resident tables', else the card (the port's entry
    points run on the card unless the caller asks for the CPU)."""
    if model._device is not None:
        return torch.device(model._device).type
    if model._tables is not None:
        return model._tables["ie"].device.type
    return "cuda"


def serving_shards_for(model, host_max_elements: Optional[int] = None,
                       ) -> int:
    """How many shards SERVING will use for this model under the current
    env (0 = the single-device paths). The ONE engage decision — shared by
    ``_prepare_scoring``, the train-time per-shard IVF build and the
    deploy-time restore — so the layouts they pick cannot disagree."""
    from incubator_predictionio_tpu_torch.models.two_tower import (
        HOST_SERVE_MAX_ELEMENTS,
    )

    tables = model._tables if model.device_resident else None
    s = requested_shards(model.n_items, model.config.rank, tables,
                         model_device_type(model))
    if s <= 1:
        return 0
    host_max = (HOST_SERVE_MAX_ELEMENTS if host_max_elements is None
                else host_max_elements)
    small = model.n_items * (model.config.rank + 1) <= host_max
    if small and serve_mode() != "on":
        return 0
    return s


def restore_shards(n_items: int, rank: int, trained_shards: int = 1,
                   device_type: str = "cuda") -> int:
    """Shard count a deploy RESTORE targets (0 = one-device restore).
    ``trained_shards`` comes from the persisted :class:`ShardSpec` record.
    Forced counts clamp to the local devices, as ``_build_sharded`` does:
    a persisted model must redeploy under the same env that served it
    in-process."""
    mode = serve_mode()
    if mode == "off":
        return 0
    ndev = local_device_count(device_type)
    s = min(forced_shards() or ndev, ndev)
    if s <= 1:
        return 0
    if mode == "on":
        return s
    from incubator_predictionio_tpu_torch.models.two_tower import (
        HOST_SERVE_MAX_ELEMENTS,
    )

    if n_items * (rank + 1) <= HOST_SERVE_MAX_ELEMENTS:
        return 0
    if trained_shards > 1:
        return s
    budget = hbm_budget()
    if budget is not None and ShardSpec(
            "ie", n_items, rank + 1, 1).shard_table_bytes() > budget:
        return s
    return 0


def train_time_shard_ivf(model, persisted: Optional[list] = None,
                         ) -> Optional[list]:
    """Per-shard IVF build at TRAIN time for a model that will serve
    sharded — persistence runs right after training, so the clustering
    ships with the model and redeploys skip the per-shard re-cluster.
    Returns None when sharded serving would not engage."""
    s = serving_shards_for(model)
    if s <= 1:
        return None
    spec = ShardSpec("ie", model.n_items, model.config.rank + 1, s)
    return build_or_reuse_shard_ivf(
        spec, model_shard_rows(model, spec), persisted)


# -- device state ------------------------------------------------------------

@dataclasses.dataclass
class _DeviceShards:
    """Resident per-shard serving state; shard ``s`` lives on
    ``devices[s]``."""

    devices: list          # torch.device per shard
    item_t: list           # [rank, rps] bf16-rounded (two_tower._catalog_t)
    bias: list             # [rps] f32
    base_mask: list        # [rps] f32: 0 real rows, -inf padding
    users: list            # [u_rps, rank+1] f32 fused user rows
    n_p: int               # padded catalog columns (n_shards × rps)
    u_p: int


def _serve_devices(n_shards: int, device: torch.device) -> list:
    """The devices of ``n_shards`` serving shards: on CUDA the first
    ``n_shards`` local cards (one shard serves from ``device`` itself);
    on the CPU ``n_shards`` entries of the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n_shards
    if n_shards == 1:
        return [device]
    ndev = torch.cuda.device_count()
    if n_shards > ndev:
        raise ValueError(
            f"{n_shards} device shards requested but only {ndev} "
            f"local devices exist (PIO_SHARD_SERVE_SHARDS)")
    return [torch.device("cuda", i) for i in range(n_shards)]


def _build_device_shards(tables, spec_items: ShardSpec,
                         spec_users: ShardSpec, rank: int,
                         devices: list) -> _DeviceShards:
    """Derive the per-shard serving tensors from the resident tables —
    device-to-device copies only, the tables never visit the host. Only
    the real rows are read, so tables padded to a larger multiple (trained
    over more shards than serving uses) re-pad to the serve layout."""
    from incubator_predictionio_tpu_torch.models.two_tower import _catalog_t

    rps, u_rps = spec_items.rows_per_shard, spec_users.rows_per_shard
    item_t, bias, base, users = [], [], [], []
    for s, dev in enumerate(devices):
        lo, hi = spec_items.shard_bounds(s)
        blk = tables["ie"][lo:hi].to(dev)
        ct = _catalog_t(blk[:, :rank])
        t = torch.zeros(rank, rps, dtype=ct.dtype, device=dev)
        t[:, : hi - lo] = ct
        b = torch.zeros(rps, dtype=torch.float32, device=dev)
        b[: hi - lo] = blk[:, rank]
        m = torch.zeros(rps, dtype=torch.float32, device=dev)
        m[hi - lo:] = -torch.inf
        lo, hi = spec_users.shard_bounds(s)
        u = torch.zeros(u_rps, rank + 1, dtype=torch.float32, device=dev)
        u[: hi - lo] = tables["ue"][lo:hi].to(dev)
        item_t.append(t)
        bias.append(b)
        base.append(m)
        users.append(u)
    return _DeviceShards(devices=list(devices), item_t=item_t, bias=bias,
                         base_mask=base, users=users,
                         n_p=spec_items.padded_rows,
                         u_p=spec_users.padded_rows)


# -- host state --------------------------------------------------------------

@dataclasses.dataclass
class _HostBlock:
    lo: int
    hi: int
    item_t: np.ndarray   # [rank, hi-lo] f32
    bias: np.ndarray     # [hi-lo] f32


def _host_blocks_from(item_emb: np.ndarray, item_bias: np.ndarray,
                      spec: ShardSpec) -> list[_HostBlock]:
    item_t = np.asarray(item_emb, np.float32).T
    bias = np.asarray(item_bias, np.float32)
    out = []
    for s in range(spec.n_shards):
        lo, hi = spec.shard_bounds(s)
        out.append(_HostBlock(lo, hi, item_t[:, lo:hi], bias[lo:hi]))
    return out


def _stacked(rows_dict: dict, spec: ShardSpec, width: int,
             ) -> tuple[np.ndarray, np.ndarray]:
    """Delta rows as sorted ids + ``[n, width]`` rows; raises on a
    wrong-width or out-of-range row."""
    ids = np.asarray(sorted(int(i) for i in rows_dict), np.int64)
    rows = np.stack([np.asarray(rows_dict[int(i)], np.float32)
                     for i in ids])
    if rows.shape[1] != width:
        raise ValueError(
            f"delta row width {rows.shape[1]} != {width}")
    for i in ids:
        spec.owner_of(int(i))  # raises on out-of-range
    return ids, rows


# -- the facade --------------------------------------------------------------

class ShardedServing:
    """Per-shard retrieval state for one model: exact engine (device or
    host blocks) + optional per-shard IVF. Read-only after build (streaming
    updates return a NEW instance via :meth:`with_row_updates`)."""

    def __init__(self, spec_items: ShardSpec, spec_users: ShardSpec,
                 mean: float, serve_k: int,
                 device: Optional[_DeviceShards] = None,
                 blocks: Optional[list[_HostBlock]] = None,
                 ivf: Optional[list] = None):
        self.spec = spec_items
        self.spec_users = spec_users
        self.mean = float(mean)
        self.serve_k = int(serve_k)
        self.device = device
        self.blocks = blocks
        self.ivf = ivf

    # -- construction ------------------------------------------------------
    @staticmethod
    def build_device(tables, n_users: int, n_items: int, rank: int,
                     mean: float, serve_k: int, n_shards: int,
                     device=None) -> "ShardedServing":
        """Device shards from the resident fused ``tables``; ``device`` (the
        model's, by default the tables') picks CUDA cards or the CPU."""
        device = tables["ie"].device if device is None else device
        spec_i = ShardSpec("ie", n_items, rank + 1, n_shards)
        spec_u = ShardSpec("ue", n_users, rank + 1, n_shards)
        dev = _build_device_shards(tables, spec_i, spec_u, rank,
                                   _serve_devices(n_shards, device))
        return ShardedServing(spec_i, spec_u, mean, serve_k, device=dev)

    @staticmethod
    def build_host(item_emb: np.ndarray, item_bias: np.ndarray,
                   n_users: int, mean: float, serve_k: int, n_shards: int,
                   ) -> "ShardedServing":
        rank = int(np.asarray(item_emb).shape[1])
        spec_i = ShardSpec("ie", int(np.asarray(item_emb).shape[0]),
                           rank + 1, n_shards)
        spec_u = ShardSpec("ue", n_users, rank + 1, n_shards)
        blocks = _host_blocks_from(item_emb, item_bias, spec_i)
        return ShardedServing(spec_i, spec_u, mean, serve_k, blocks=blocks)

    @property
    def n_shards(self) -> int:
        return self.spec.n_shards

    @property
    def rank(self) -> int:
        return self.spec.width - 1

    # -- shard row access --------------------------------------------------
    def shard_rows(self, shard: int, tables=None,
                   ) -> tuple[np.ndarray, np.ndarray]:
        """ONE shard's real ``(item_emb, item_bias)`` on host — the
        bounded-peak alternative to a full-table copy (per-shard IVF builds
        pull shard-at-a-time; peak host bytes = one shard)."""
        if self.blocks is not None:
            b = self.blocks[shard]
            return np.ascontiguousarray(b.item_t.T), np.asarray(b.bias)
        return _pull_device_shard_rows(self.spec, shard, tables)

    def _device_user_rows(self, uidx: np.ndarray) -> torch.Tensor:
        """The fused ``[len(uidx), rank+1]`` user rows on the first shard's
        device, gathered on each owner's device (batch-sized traffic)."""
        dev = self.device
        d0 = dev.devices[0]
        u_rps = self.spec_users.rows_per_shard
        owners = uidx // u_rps
        present = np.unique(owners)
        if len(present) == 1:
            s = int(present[0])
            local = torch.from_numpy(uidx - s * u_rps).to(dev.devices[s])
            return dev.users[s].index_select(0, local).to(d0, non_blocking=True)
        out = torch.empty(len(uidx), self.rank + 1, dtype=torch.float32,
                          device=d0)
        for s in present.tolist():
            pos = np.flatnonzero(owners == s)
            local = torch.from_numpy(uidx[pos] - s * u_rps).to(dev.devices[s])
            rows = dev.users[s].index_select(0, local).to(d0, non_blocking=True)
            out.index_copy_(0, torch.from_numpy(pos).to(d0), rows)
        return out

    def user_rows(self, model, user_idx) -> tuple[np.ndarray, np.ndarray]:
        """Host ``(q [b, rank], user_bias [b])`` for the given users —
        a batch-sized pull when the towers are device-resident."""
        uidx = np.asarray(user_idx, np.int64)
        if model.user_emb is not None:
            return (np.asarray(model.user_emb, np.float32)[uidx],
                    np.asarray(model.user_bias, np.float32)[uidx])
        rows = self._device_user_rows(uidx).cpu().numpy()
        return (np.ascontiguousarray(rows[:, : self.rank]),
                np.ascontiguousarray(rows[:, self.rank]))

    # -- per-shard IVF -----------------------------------------------------
    def ensure_ivf(self, model=None, persisted: Optional[list] = None,
                   ) -> list:
        """Build — or rehydrate a persisted — per-shard IVF partition set.
        Each shard clusters only ITS rows (shard-at-a-time host pulls on
        device models: peak host memory is one shard, never the table).
        Each index's coarse stage runs on its shard's card in device mode,
        on the model's device in host mode (kernel K2 on a CUDA device)."""
        if self.ivf is not None:
            return self.ivf
        tables = getattr(model, "_tables", None) if model is not None else None
        self.ivf = build_or_reuse_shard_ivf(
            self.spec, lambda s: self.shard_rows(s, tables), persisted)
        self._place_ivf(getattr(model, "_device", None))
        return self.ivf

    def _place_ivf(self, model_device) -> None:
        for s, idx in enumerate(self.ivf):
            if idx is None:
                continue
            if self.device is not None:
                idx.device = self.device.devices[s]
            elif model_device is not None:
                idx.device = torch.device(model_device)

    # -- search ------------------------------------------------------------
    def search_exact(self, model, user_idx, num: int,
                     exclude=None, row_mask=None, events=None,
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Per-shard exact top-k + merge. ``events`` (a dict, device mode
        on CUDA) receives each shard's and the merge's start/end CUDA
        events, for callers that time the cards."""
        t0 = time.perf_counter()
        if self.device is not None:
            res = self._search_device(user_idx, num, exclude, row_mask,
                                      events)
        else:
            q, ub = self.user_rows(model, user_idx)
            res = self._search_host(q, ub, num, exclude, row_mask)
        M.TOPK_SEC.observe(time.perf_counter() - t0)
        M.SHARD_BATCHES.inc()
        return res

    def _search_device(self, user_idx, num, exclude, row_mask,
                       events=None):
        from incubator_predictionio_tpu_torch.models.two_tower import (
            _row_mask_pad_buffer,
            serve_bucket,
        )
        from incubator_predictionio_tpu_torch.utils import jitstats

        dev = self.device
        t_phase = time.perf_counter()
        d0 = dev.devices[0]
        rps, k_rank = self.spec.rows_per_shard, self.rank
        b = len(user_idx)
        bucket = serve_bucket(max(b, 1))
        k = self.serve_k if 0 < num <= self.serve_k else num
        k = min(k, self.spec.n_rows)
        kl = min(k, rps)
        uidx = np.zeros(bucket, np.int64)
        uidx[:b] = np.asarray(user_idx, np.int64)
        q = self._device_user_rows(uidx)
        m = None
        if exclude is not None and len(exclude):
            m = np.zeros(dev.n_p, np.float32)
            m[np.asarray(exclude, np.int64)] = -np.inf
        rm = None
        if row_mask is not None:
            rm = _row_mask_pad_buffer(bucket, dev.n_p)
            rm[:b, : row_mask.shape[1]] = row_mask
        M.MERGE_FANIN.observe(self.n_shards * kl)
        # the host-side masks and the query rows reach every card first
        # (a pageable upload waits for its card's stream): the scoring
        # queued below then never waits behind a copy
        inputs = []
        for s, d in enumerate(dev.devices):
            mask = dev.base_mask[s]
            if m is not None:
                mask = mask + torch.from_numpy(m[s * rps:(s + 1) * rps]).to(d)
            rms = None
            if rm is not None:
                rms = torch.from_numpy(rm[:, s * rps:(s + 1) * rps]).to(d)
            inputs.append((q.to(d, non_blocking=True), mask, rms))
        # phase edge (reference serve.py:593-596): the masks' and query
        # rows' uploads are h2d; each card's own stream, never the whole
        # device
        _profile.fence(inputs)
        t_h2d, t_phase = time.perf_counter() - t_phase, time.perf_counter()
        with jitstats.dispatch_timer((
            "two_tower_topk_sharded", self.n_shards, bucket, k,
            self.spec.n_rows, rm is not None,
        )):
            packed = self._score_shards(inputs, k, kl, events)
            # phase edge: the per-card scoring, local top-k, candidate
            # moves and merge are compute (the merged tensor depends on
            # every card's work); the host copy after it is gather
            _profile.fence(packed)
            t_compute, t_phase = (time.perf_counter() - t_phase,
                                  time.perf_counter())
            packed = packed.cpu().numpy()
        _profile.record_phases("shard.search", {
            "h2d": t_h2d, "compute": t_compute,
            "gather": time.perf_counter() - t_phase,
        })
        scores_h = packed[:, :k].view(np.float32)
        idx_h = packed[:, k:].astype(np.int64)
        return idx_h[:b, :num], scores_h[:b, :num]

    def _score_shards(self, inputs, k, kl, events):
        """Queue every shard's scoring and local top-k on its own card, then
        the cross-shard merge on the first card; returns the merged
        ``[bucket, 2k]`` int32 tensor (scores' bits, then ids), on the
        device."""
        from incubator_predictionio_tpu_torch.models.two_tower import (
            _exact_scores,
            _top_k,
        )

        dev = self.device
        d0 = dev.devices[0]
        rps, k_rank = self.spec.rows_per_shard, self.rank
        timed = events is not None and d0.type == "cuda"
        cand_v, cand_i = [], []
        # every shard's work is queued on its own card's current stream
        # before anything waits: the cards score at the same time
        for s, (d, (qs, mask, rms)) in enumerate(zip(dev.devices, inputs)):
            if timed:
                ev = events.setdefault(s, (torch.cuda.Event(enable_timing=True),
                                           torch.cuda.Event(enable_timing=True)))
                ev[0].record(torch.cuda.current_stream(d))
            # the single-device _topk_scores expression on this shard's
            # columns: the same ops, dtypes and order
            scores = _exact_scores(qs[:, :k_rank].to(torch.bfloat16),
                                   qs[:, k_rank], dev.item_t[s], dev.bias[s],
                                   self.mean, mask, rms)
            v, i = _top_k(scores, kl)
            i = i + s * rps
            if timed:
                ev[1].record(torch.cuda.current_stream(d))
            # the only cross-card traffic: [b, kl] scores + ids per shard
            cand_v.append(v.to(d0, non_blocking=True))
            cand_i.append(i.to(d0, non_blocking=True))
        if timed:
            ev = events.setdefault("merge", (torch.cuda.Event(enable_timing=True),
                                             torch.cuda.Event(enable_timing=True)))
            ev[0].record(torch.cuda.current_stream(d0))
        if len(cand_v) == 1:
            # one shard: its local top-k (kl = k) is the answer
            v, idx = cand_v[0], cand_i[0]
        else:
            # shard-major candidate order == ascending global-id blocks
            # (ties resolve like a top-k over the full score row)
            v, pos = _top_k(torch.cat(cand_v, 1), k)
            idx = torch.cat(cand_i, 1).gather(1, pos)
        # ONE device→host copy for both results: the scores' bits and the
        # ids ride together as int32 columns
        packed = torch.cat([v.view(torch.int32), idx.to(torch.int32)], dim=1)
        if timed:
            ev[1].record(torch.cuda.current_stream(d0))
        return packed

    def _search_host(self, q, ub, num, exclude, row_mask):
        """Per-shard numpy blocks + serial-parity merge — bitwise the
        single-host numpy path for distinct scores."""
        b = q.shape[0]
        num = min(num, self.spec.n_rows)
        if num <= 0 or b == 0:
            return (np.zeros((b, 0), np.int64), np.zeros((b, 0), np.float32))
        excl_sorted = None
        if exclude is not None and len(exclude):
            excl_sorted = np.sort(np.asarray(exclude, np.int64))
        ids_parts, sc_parts = [], []
        t_phase = time.perf_counter()
        row = np.arange(b)[:, None]
        for blk in self.blocks:
            n_s = blk.hi - blk.lo
            if n_s <= 0:
                continue
            # the _recommend_batch_host expression on this column slice
            scores = q @ blk.item_t + blk.bias[None, :] + ub[:, None] \
                + self.mean
            if excl_sorted is not None:
                a, z = np.searchsorted(excl_sorted, (blk.lo, blk.hi))
                local = excl_sorted[a:z] - blk.lo
                if len(local):
                    scores[:, local] = -np.inf
            if row_mask is not None:
                scores += row_mask[:, blk.lo:blk.hi]
            kl = min(num, n_s)
            part = np.argpartition(-scores, kl - 1, axis=1)[:, :kl]
            order = np.argsort(-scores[row, part], axis=1)
            top = np.take_along_axis(part, order, 1)
            ids_parts.append(top + blk.lo)
            sc_parts.append(scores[row, top])
        cand_ids = np.concatenate(ids_parts, axis=1)
        cand_sc = np.concatenate(sc_parts, axis=1)
        M.MERGE_FANIN.observe(cand_ids.shape[1])
        t0 = time.perf_counter()
        idx, scores = merge_topk(cand_ids, cand_sc, num)
        M.MERGE_SEC.observe(time.perf_counter() - t0)
        _profile.record_phases("shard.search", {
            "compute": t0 - t_phase, "merge": time.perf_counter() - t0,
        })
        return idx, scores

    def search_ivf(self, q, ub, num: int, exclude=None, row_mask=None,
                   ) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """Composed two-stage over shards: each shard prunes its LOCAL
        partitions and reranks its candidates with the exact math; the
        cross-shard merge reranks the union. Returns None (fall back to
        sharded-exact) when any shard under-covers — same conservative
        contract as the single-device two-stage path."""
        b = q.shape[0]
        num = min(num, self.spec.n_rows)
        if num <= 0 or b == 0:
            return (np.zeros((b, 0), np.int64), np.zeros((b, 0), np.float32))
        excl_sorted = None
        if exclude is not None and len(exclude):
            excl_sorted = np.sort(np.asarray(exclude, np.int64))
        ids_parts, sc_parts = [], []
        t_phase = time.perf_counter()
        for s, idx_s in enumerate(self.ivf):
            lo, hi = self.spec.shard_bounds(s)
            n_s = hi - lo
            if n_s <= 0 or idx_s is None:
                continue
            k_s = min(num, n_s)
            local_excl = None
            if excl_sorted is not None:
                a, z = np.searchsorted(excl_sorted, (lo, hi))
                seg = excl_sorted[a:z] - lo
                local_excl = seg if len(seg) else None
            local_rm = row_mask[:, lo:hi] if row_mask is not None else None
            res = idx_s.search(q, ub, self.mean, k_s,
                               exclude=local_excl, row_mask=local_rm)
            if res is None:
                M.SHARD_FALLBACKS.inc()
                return None
            ids_parts.append(res[0] + lo)
            sc_parts.append(res[1])
        if not ids_parts:
            M.SHARD_FALLBACKS.inc()
            return None
        cand_ids = np.concatenate(ids_parts, axis=1)
        cand_sc = np.concatenate(sc_parts, axis=1)
        if cand_ids.shape[1] < num:
            # even the union can't fill the answer — exact sees more
            M.SHARD_FALLBACKS.inc()
            return None
        M.MERGE_FANIN.observe(cand_ids.shape[1])
        t0 = time.perf_counter()
        idx, scores = merge_topk(cand_ids, cand_sc, num)
        M.MERGE_SEC.observe(time.perf_counter() - t0)
        # the per-shard searches run host code around the coarse kernel,
        # whose scores come back as host arrays: no fence
        _profile.record_phases("shard.search", {
            "compute": t0 - t_phase, "merge": time.perf_counter() - t0,
        })
        M.SHARD_BATCHES.inc()
        return idx, scores

    # -- streaming deltas --------------------------------------------------
    def with_row_updates(self, user_rows: Optional[dict],
                         item_rows: Optional[dict]) -> "ShardedServing":
        """A NEW ShardedServing with delta rows applied on their OWNING
        shard; untouched shards share tensors with the receiver (which may
        be live — never mutated)."""
        new = ShardedServing(self.spec, self.spec_users, self.mean,
                             self.serve_k, device=self.device,
                             blocks=self.blocks, ivf=self.ivf)
        width = self.rank + 1
        if item_rows:
            ids, rows = _stacked(item_rows, self.spec, width)
            M.DELTA_ROUTED.inc(len(ids))
            if new.blocks is not None:
                new.blocks = self._updated_blocks(ids, rows)
            if new.device is not None:
                new.device = self._updated_device_items(ids, rows)
            if new.ivf is not None:
                new.ivf = self._updated_ivf(ids, rows)
        if user_rows and self.device is not None:
            ids, rows = _stacked(user_rows, self.spec_users, width)
            M.DELTA_ROUTED.inc(len(ids))
            new.device = self._updated_device_users(new.device, ids, rows)
        if item_rows and new.ivf is not None and new.blocks is not None:
            # host-block mode can re-cluster past the stale threshold
            # immediately (the blocks already hold the current f32 rows);
            # device mode rebuilds via rebuild_stale_ivf(model) once the
            # caller has the updated tables in hand
            new.rebuild_stale_ivf()
        return new

    def rebuild_stale_ivf(self, model=None) -> None:
        """Re-cluster any shard whose IVF staleness overlay exceeds
        ``PIO_STREAM_STALE_REBUILD_FRAC`` — the per-shard twin of the
        single-device rebuild; without it a long stream of deltas grows the
        overlay to O(shard) and every pruned query rescans it. Only call on
        a freshly-updated instance (mutates ``self.ivf`` in place)."""
        from incubator_predictionio_tpu_torch.serving import ann

        if not self.ivf or not ann.two_stage_enabled(self.spec.n_rows):
            return
        frac = float(os.environ.get("PIO_STREAM_STALE_REBUILD_FRAC", "0.25"))
        tables = getattr(model, "_tables", None) if model is not None else None
        for s, idx in enumerate(self.ivf):
            if idx is not None and idx.stale_fraction > frac:
                lo, hi = self.spec.shard_bounds(s)
                self.ivf[s] = ann.build_ivf(
                    *self.shard_rows(s, tables),
                    key=shard_build_key(hi - lo, s))
                self.ivf[s].device = idx.device

    def _updated_blocks(self, ids, rows) -> list[_HostBlock]:
        owners = ids // self.spec.rows_per_shard
        out = list(self.blocks)
        k = self.rank
        for s in np.unique(owners):
            blk = self.blocks[int(s)]
            sel = owners == s
            local = ids[sel] - blk.lo
            item_t = np.array(blk.item_t, copy=True)
            bias = np.array(blk.bias, copy=True)
            item_t[:, local] = rows[sel, :k].T
            bias[local] = rows[sel, k]
            out[int(s)] = _HostBlock(blk.lo, blk.hi, item_t, bias)
        return out

    def _updated_device_items(self, ids, rows) -> _DeviceShards:
        """Clones of the owning shards' item blocks with the rows
        scattered in (bf16-rounded as at build); the others are shared."""
        from incubator_predictionio_tpu_torch.models.two_tower import _catalog_t

        dev = self.device
        rps, k = self.spec.rows_per_shard, self.rank
        owners = ids // rps
        item_t, bias = list(dev.item_t), list(dev.bias)
        for s in np.unique(owners).tolist():
            d = dev.devices[s]
            sel = owners == s
            local = torch.from_numpy(ids[sel] - s * rps).to(d)
            r = torch.from_numpy(rows[sel]).to(d)
            item_t[s] = item_t[s].clone()
            item_t[s][:, local] = _catalog_t(r[:, :k])
            bias[s] = bias[s].clone()
            bias[s][local] = r[:, k]
        return dataclasses.replace(dev, item_t=item_t, bias=bias)

    def _updated_device_users(self, dev, ids, rows) -> _DeviceShards:
        """Clones of the owning shards' user blocks with the rows set."""
        u_rps = self.spec_users.rows_per_shard
        owners = ids // u_rps
        users = list(dev.users)
        for s in np.unique(owners).tolist():
            d = dev.devices[s]
            sel = owners == s
            users[s] = users[s].clone()
            users[s][torch.from_numpy(ids[sel] - s * u_rps).to(d)] = \
                torch.from_numpy(rows[sel]).to(d)
        return dataclasses.replace(dev, users=users)

    def _updated_ivf(self, ids, rows) -> list:
        owners = ids // self.spec.rows_per_shard
        out = list(self.ivf)
        k = self.rank
        for s in np.unique(owners):
            s = int(s)
            if out[s] is None:
                continue
            lo, _hi = self.spec.shard_bounds(s)
            sel = owners == s
            out[s] = out[s].with_updated_rows(
                ids[sel] - lo, rows[sel, :k], rows[sel, k])
        return out

    # -- reporting ---------------------------------------------------------
    def info(self) -> dict:
        kl = min(max(self.serve_k, 1), self.spec.rows_per_shard)
        ivf_stats = None
        if self.ivf is not None:
            ivf_stats = [i.stats() if i is not None else None
                         for i in self.ivf]
        live = [s for s in (ivf_stats or []) if s]
        return {
            "n_shards": self.n_shards,
            "mode": "device" if self.device is not None else "host",
            "devices": ([str(d) for d in self.device.devices]
                        if self.device is not None else None),
            "items": self.spec.to_dict(),
            "users": self.spec_users.to_dict(),
            "merge_fanin": int(self.n_shards * kl),
            "serve_k": self.serve_k,
            "hbm_budget": hbm_budget(),
            "ivf": ivf_stats,
            # per-shard rerank storage: int8 vs fp32 and the bytes saved by
            # the quantized layout, summed over live shard indexes
            "quantized": bool(live and all(s["quantized"] for s in live)),
            "rerank_bytes": sum(s["rerank_bytes"] for s in live),
            "rerank_bytes_saved": sum(s["bytes_saved"] for s in live),
        }
