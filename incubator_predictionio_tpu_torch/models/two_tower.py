"""Two-tower matrix factorization — training and serving.

Counterpart of ``incubator_predictionio_tpu/models/two_tower.py``: the model
container, its training (:meth:`TwoTowerMF.fit`), its serving preparation
and warmup, and top-k retrieval over the catalog (``TwoTowerMF.recommend``
/ ``recommend_batch``).

Training is the reference's ``fit`` and ``_train_epochs`` on one device:
triples are permuted, padded with weight-0 rows and user-sorted per batch
in numpy (:func:`_sort_batches_by_entity`), staged on the device once, and
every step gathers rows (the bias is the last column of each table), takes
the weighted MSE + L2 with the embedding parts rounded to bf16, scatters
the gradients into dense table gradients and runs the reference's dense
adam (``utils/optim.py:adam_apply``) over every row. The backward is
written out (:func:`_loss_and_grads`) with the casts JAX's autodiff puts
in: the prediction's and the embeddings' cotangents are rounded to bf16.
Large catalogs stay device-resident after the fit (``gather="auto"``, as
the reference): the model then holds its fused tables on the card
(``_tables``) and serving state is derived device-to-device.

Three serving paths, chosen as in the reference:

- catalogs up to :data:`HOST_SERVE_MAX_ELEMENTS` table elements score in
  host numpy (:func:`_recommend_batch_host`);
- larger catalogs go device-resident on the model's ``torch.device``: bf16
  tables scored by a fp32 matmul (:func:`_topk_scores`), or, with
  ``quantize=True``, the int8 catalog scored by kernel K1 of
  ``ops/retrieval.py`` (:func:`_topk_quantized`);
- with two-stage retrieval enabled (``serving/ann.py``) the IVF index
  prunes first, and its coarse stage runs kernel K2 on a CUDA device.

Streaming deltas land through :meth:`TwoTowerModel.with_row_updates`
(build-beside: a NEW model over copied host tables, the IVF index
overlaid with the moved rows; a device-resident model pulls its tables to
the host once first, as the reference does). Mid-training checkpoints run
through ``utils/checkpoint.py:checkpointed_epochs`` in chunks of
``checkpoint_every`` epochs. Sharded serving comes with the sharding slice
(ROADMAP.md Queue 1, item 4).

Multi-process training is the reference's data-parallel fit over one
``torch.distributed`` group, every process holding a replica of the
tables. Each process stages its own rows (:meth:`TwoTowerMF._stage_local`
for an entity-sharded read); global batch b is the concatenation, in
process order, of every process's local batch b. The global row indices
and each batch's weight sum (the denominator) are gathered once at
staging (:func:`_gather_batches`); a step computes the loss terms and row
gradients of the process's own rows (:func:`_row_grads`), all-gathers the
rows (``DeviceContext.all_gather``), scatters every process's rows into
the dense table gradients in a fixed order (:func:`_scatter_rows`: a
sorted scatter on the card) and runs the dense adam on its replica
(:func:`_train_epochs_dp`). The stacked per-step losses are summed across
processes once an epoch. The fit ends by comparing a digest of every
replica's tables, and raises if any differs.

Tie order: the device paths answer what ``lax.top_k`` answers — among
equal scores the lowest indices are taken and come first, -inf entries
(masked items) included — though ``torch.topk`` promises no order among
equal scores (:func:`_top_k` repairs it on the device). The padded columns
of the int8 catalog are sliced off before top-k, so a padded id can never
be returned (the reference keeps them at -inf, above every real index).
The host path keeps the reference's numpy code and its order.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Optional, Union

import numpy as np
import torch

from incubator_predictionio_tpu_torch.parallel.mesh import (
    CollectiveClock,
    check_replicas,
)

DeviceLike = Union[str, torch.device, None]

logger = logging.getLogger(__name__)


#: what raises in the training options this slice does not port
SHARDING_SLICE = ("the sharding slice of the PyTorch port (ROADMAP.md "
                  "Queue 1, item 4)")


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    """The reference's config (two_tower.py:41-65), every field.
    ``implicit_negatives`` is carried only: the reference's ``fit`` never
    reads it."""

    rank: int = 32                  # ALS "rank" (ALSAlgorithm.scala params)
    learning_rate: float = 3e-2
    reg: float = 1e-4               # ALS "lambda"
    epochs: int = 20                # ALS "numIterations"
    batch_size: int = 8192          # global batch
    implicit_negatives: int = 0
    seed: int = 0
    # mid-training checkpoints (utils/checkpoint.py); 0 = off
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    checkpoint_keep: int = 3
    # adam moment STORAGE dtype ("float32" | "bfloat16"); the math is fp32
    adam_moments_dtype: str = "float32"
    # after the fit: "host" pulls the tables to numpy, "device" keeps them
    # resident; "auto" keeps them when the CATALOG exceeds
    # HOST_SERVE_MAX_ELEMENTS, the criterion serving uses
    gather: str = "auto"


#: Micro-batch bucket ladder for serving: every request batch is padded up to
#: the next bucket, so the device sees a handful of shapes. Beyond the
#: largest bucket, batches round up to a multiple of it.
SERVE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)

#: Catalogs with ≤ this many table elements (rows × columns) serve from HOST
#: numpy instead of the device.
HOST_SERVE_MAX_ELEMENTS = 2_000_000

#: Per-row rule masks are DENSE [batch, n_items] f32, so the row-mask path
#: (and its deploy-time warmup) is limited to batches where that mask stays
#: ≤ this many elements (32 MB f32).
ROW_MASK_MAX_ELEMENTS = 8_000_000


def serve_bucket(b: int) -> int:
    """Smallest bucket ≥ ``b`` (multiples of the top bucket past the ladder)."""
    for s in SERVE_BUCKETS:
        if b <= s:
            return s
    top = SERVE_BUCKETS[-1]
    return ((b + top - 1) // top) * top


def _resolve_device(device: DeviceLike) -> torch.device:
    """The serving device: CUDA unless the caller names another."""
    return torch.device("cuda" if device is None else device)


@dataclasses.dataclass
class TwoTowerModel:
    """user/item factor tables + biases + global mean.

    Two residency modes, as in the reference:

    - **host**: ``user_emb``/``item_emb``/biases are host numpy and pickle
      into MODELDATA;
    - **device** (``TwoTowerConfig.gather="device"``, or "auto" with a
      large catalog): the fused tables stay on the card in ``_tables``
      (``{"ue": [n_users, k+1], "ie": [n_items, k+1]}`` fp32 tensors) and
      the host fields are None until :meth:`ensure_host`. Persistence goes
      through ``RecModel.save`` (``torch.save`` of the tables).

    Serving buffers (``_device_*``, ``_host_items``) are derived by
    :meth:`prepare_for_serving` and never pickle; the IVF index is host
    numpy and rides default pickling.
    """

    user_emb: Optional[np.ndarray] = None    # [n_users, k]
    item_emb: Optional[np.ndarray] = None    # [n_items, k]
    user_bias: Optional[np.ndarray] = None   # [n_users]
    item_bias: Optional[np.ndarray] = None   # [n_items]
    mean: float = 0.0
    config: TwoTowerConfig = dataclasses.field(default_factory=TwoTowerConfig)

    _tables = None  # device-resident fused tables (device mode)
    _n_users = 0  # row counts in device mode
    _n_items = 0
    _device = None  # torch.device the device buffers live on
    # (item_embᵀ as bf16-rounded fp32 [k, n], item_bias, zero mask)
    _device_items = None
    _device_items_q = None  # int8-quantized catalog (kernel K1)
    _device_users = None  # (user_emb bf16, user_bias f32)
    _host_items = None  # small-catalog host fast path (item_embᵀ, item_bias)
    _serve_k = 0  # top-k the device path computes when num fits under it
    _ivf = None  # two-stage retrieval index (serving/ann.py), host numpy

    @property
    def device_resident(self) -> bool:
        return self._tables is not None

    def ensure_host(self) -> "TwoTowerModel":
        """Materialize the host numpy views of a device-resident model (one
        full-table device→host copy; only consumers that need host arrays,
        such as default pickling, land here)."""
        if self.user_emb is not None or self._tables is None:
            return self
        k = self.config.rank
        ue = self._tables["ue"][: self._n_users].cpu().numpy()
        ie = self._tables["ie"][: self._n_items].cpu().numpy()
        self.user_emb = np.ascontiguousarray(ue[:, :k])
        self.user_bias = np.ascontiguousarray(ue[:, k])
        self.item_emb = np.ascontiguousarray(ie[:, :k])
        self.item_bias = np.ascontiguousarray(ie[:, k])
        return self

    def __getstate__(self):
        # default pickling always ships host arrays; device handles and
        # serving buffers never serialize — deploy rebuilds them
        self.ensure_host()
        return {k: v for k, v in self.__dict__.items()
                if k not in ("_tables", "_device", "_device_items",
                             "_device_items_q", "_device_users",
                             "_host_items")}

    def prepare_for_serving(
        self, quantize: bool = False, serve_k: int = 128,
        host_max_elements: Optional[int] = None, build_index: bool = True,
        device: DeviceLike = None,
    ) -> "TwoTowerModel":
        """Make serving state resident for the query hot path.

        Catalogs up to :data:`HOST_SERVE_MAX_ELEMENTS` serve from host
        numpy; bigger ones go resident on ``device`` (CUDA unless the caller
        names another), int8 row-quantized and scored by kernel K1 when
        ``quantize``. ``serve_k`` fixes the top-k the device path computes
        for every ``num ≤ serve_k``. When two-stage retrieval is enabled for
        this catalog (``PIO_RETRIEVAL_MODE``) this also builds — or reuses,
        when a persisted index's build key still matches — the IVF
        partition, and hands it ``device`` for its coarse stage."""
        self._device = _resolve_device(device)
        self._prepare_scoring(quantize, serve_k, host_max_elements)
        if build_index:
            self._prepare_index()
        return self

    def _prepare_index(self) -> None:
        """Build/reuse the two-stage IVF partition (serving/ann.py)."""
        from incubator_predictionio_tpu_torch.serving import ann

        if not ann.two_stage_enabled(self.n_items):
            return
        key = ann.build_key(self.n_items)
        if self._ivf is None or not self._ivf.matches(key):
            self._ivf = ann.build_ivf(*self._host_item_table(), key=key)
        elif not self._ivf.hydrated:
            self._ivf.rehydrate(*self._host_item_table())
        self._ivf.device = self._device

    def _host_item_table(self) -> tuple[np.ndarray, np.ndarray]:
        """Host ``(item_emb, item_bias)`` as float32. A device-resident
        model pulls its item table alone, each call (``ensure_host`` would
        also pull the user table and take the model off its
        device-to-device serving preparation)."""
        if self.item_emb is not None:
            return (np.asarray(self.item_emb, np.float32),
                    np.asarray(self.item_bias, np.float32))
        k = self.config.rank
        ie = self._tables["ie"][: self._n_items].cpu().numpy()
        return (np.ascontiguousarray(ie[:, :k]),
                np.ascontiguousarray(ie[:, k]))

    def _prepare_scoring(
        self, quantize: bool = False, serve_k: int = 128,
        host_max_elements: Optional[int] = None,
    ) -> "TwoTowerModel":
        self._serve_k = min(serve_k, self.n_items)
        # re-preparation switches paths cleanly: clear every serving buffer
        self._host_items = None
        self._device_items = None
        self._device_items_q = None
        self._device_users = None
        host_max = (HOST_SERVE_MAX_ELEMENTS if host_max_elements is None
                    else host_max_elements)
        # host check first: ``quantize`` applies to device-resident catalogs
        if self.n_items * (self.config.rank + 1) <= host_max:
            self.ensure_host()  # no-op unless device mode on a small catalog
            self._host_items = (
                np.ascontiguousarray(np.asarray(self.item_emb, np.float32).T),
                np.asarray(self.item_bias, np.float32),
            )
            return self
        dev = self._device
        if self.device_resident and self.user_emb is None:
            # device→device: slice and cast the resident fused tables
            k = self.config.rank
            ue = self._tables["ue"].to(dev)
            ie = self._tables["ie"].to(dev)
            self._device_users = (
                ue[: self._n_users, :k].to(torch.bfloat16),
                ue[: self._n_users, k].contiguous(),
            )
            item_emb = ie[: self._n_items, :k].contiguous()
            item_bias = ie[: self._n_items, k].contiguous()
        else:
            self._device_users = (
                torch.from_numpy(np.asarray(self.user_emb, np.float32)).to(dev)
                .to(torch.bfloat16),
                torch.from_numpy(np.asarray(self.user_bias, np.float32)).to(dev),
            )
            item_emb = torch.from_numpy(
                np.asarray(self.item_emb, np.float32)).to(dev)
            item_bias = torch.from_numpy(
                np.asarray(self.item_bias, np.float32)).to(dev)
        if quantize:
            from incubator_predictionio_tpu_torch.ops.retrieval import (
                quantize_catalog_device,
            )

            # quantized on the serving device (bitwise quantize_rows)
            self._device_items_q = quantize_catalog_device(item_emb, item_bias)
        else:
            # bf16 rounding kept in fp32 storage: the product then runs as
            # one fp32 matmul whose products are exact, like the
            # reference's bf16 dot with fp32 accumulation
            self._device_items = (
                item_emb.T.contiguous().to(torch.bfloat16).float(),
                item_bias,
                torch.zeros(self.n_items, dtype=torch.float32, device=dev),
            )
        return self

    def warmup(self, max_batch: int = 64) -> int:
        """Dispatch every serving batch bucket up to ``max_batch`` once at
        deploy time, as the reference does to compile its executables: here
        it loads the CUDA kernels, initializes the card's libraries and
        faults the buffers in, so no live query pays for it. Returns the
        number of buckets warmed (0 on the host fast path)."""
        if self._device_users is None and self._host_items is None:
            self.prepare_for_serving()
        from incubator_predictionio_tpu_torch.serving import ann

        n = 0
        if self._ivf is not None and ann.two_stage_enabled(self.n_items):
            # prime the two-stage path too
            k = min(max(self._serve_k, 1), self.n_items)
            TwoTowerMF.recommend_batch(self, np.zeros(1, np.int32), k)
            if (self._ivf.quantized and self._ivf.device is not None
                    and self._ivf.device.type == "cuda"):
                # the int8 coarse kernel pads queries to power-of-two
                # buckets (serving/ann._probe_cuda): run each bucket once
                seen = {8}
                for b in SERVE_BUCKETS:
                    if b > max(1, max_batch):
                        break
                    bp = 1 << max(3, (b - 1).bit_length())
                    if bp in seen:
                        continue
                    seen.add(bp)
                    TwoTowerMF.recommend_batch(
                        self, np.zeros(b, np.int32), k)
                    n += 1
        if self._host_items is not None:
            return 0  # pure-numpy serving path
        for b in SERVE_BUCKETS:
            if b > max(1, max_batch):
                break
            # _force_exact: the exact path is the two-stage fallback
            TwoTowerMF.recommend_batch(
                self, np.zeros(b, np.int32), self._serve_k or 1,
                _force_exact=True,
            )
            # the rule-filtered variant, only where serving would use it
            # (a [b, n] mask beyond ROW_MASK_MAX_ELEMENTS is never built)
            if b * self.n_items <= ROW_MASK_MAX_ELEMENTS:
                TwoTowerMF.recommend_batch(
                    self, np.zeros(b, np.int32), self._serve_k or 1,
                    row_mask=np.zeros((b, self.n_items), np.float32),
                    _force_exact=True,
                )
            n += 1
        return n

    @property
    def n_items(self) -> int:
        return self._n_items if self.item_emb is None else self.item_emb.shape[0]

    @property
    def n_users(self) -> int:
        return self._n_users if self.user_emb is None else self.user_emb.shape[0]

    @property
    def prepared(self) -> bool:
        """Whether :meth:`prepare_for_serving` has built the scoring state."""
        return (self._device_items is not None
                or self._device_items_q is not None
                or self._host_items is not None)

    def with_row_updates(
        self,
        user_rows: Optional[dict] = None,
        item_rows: Optional[dict] = None,
    ) -> "TwoTowerModel":
        """A NEW model with the given fused ``[rank+1]`` rows scattered in
        — the streaming delta-apply primitive.

        Build-beside semantics: the receiver (possibly the live serving
        model) is never mutated; the tables are copied, rows assigned, and
        the caller swaps the new model in. As in the reference (:481), a
        device-resident receiver first pulls its tables to the host once
        (:meth:`ensure_host`), so the new model is a host model. It is
        unprepared: serving it runs :meth:`prepare_for_serving` again,
        which uploads (and on a CUDA device quantizes) the whole catalog
        anew.

        Item rows that moved are overlaid on the IVF index
        (:meth:`serving.ann.IVFIndex.with_updated_rows`); past
        ``PIO_STREAM_STALE_REBUILD_FRAC`` of the catalog stale, the index is
        re-clustered from the updated table instead."""
        self.ensure_host()
        if self.user_emb is None:
            # neither host nor resident tables: the reference's sharded
            # layout (its _with_row_updates_sharded, :529)
            raise NotImplementedError(
                f"delta apply on a sharded model comes with {SHARDING_SLICE}")
        k = self.config.rank
        new = TwoTowerModel(
            user_emb=np.array(self.user_emb, np.float32, copy=True),
            item_emb=np.array(self.item_emb, np.float32, copy=True),
            user_bias=np.array(self.user_bias, np.float32, copy=True),
            item_bias=np.array(self.item_bias, np.float32, copy=True),
            mean=self.mean,
            config=self.config,
        )

        def scatter(emb, bias, rows, n):
            for idx, row in rows.items():
                idx = int(idx)
                if not (0 <= idx < n):
                    raise ValueError(f"delta row index {idx} outside "
                                     f"[0, {n})")
                row = np.asarray(row, np.float32)
                if row.shape != (k + 1,):
                    raise ValueError(
                        f"delta row shape {row.shape} != ({k + 1},)")
                emb[idx] = row[:k]
                bias[idx] = row[k]

        if user_rows:
            scatter(new.user_emb, new.user_bias, user_rows, new.n_users)
        if item_rows:
            scatter(new.item_emb, new.item_bias, item_rows, new.n_items)
        if self._ivf is not None:
            if item_rows:
                new._ivf = self._updated_index(new, item_rows)
            else:
                new._ivf = self._ivf  # shared read-only: nothing moved
        return new

    def _updated_index(self, new: "TwoTowerModel", item_rows: dict):
        """Overlay the moved item rows on the shared IVF index, or rebuild
        past the staleness threshold."""
        import os

        from incubator_predictionio_tpu_torch.serving import ann

        ids = np.asarray(sorted(int(i) for i in item_rows), np.int64)
        rows = np.stack([np.asarray(item_rows[int(i)], np.float32)
                         for i in ids])
        k = self.config.rank
        overlaid = self._ivf.with_updated_rows(ids, rows[:, :k], rows[:, k])
        frac = float(os.environ.get("PIO_STREAM_STALE_REBUILD_FRAC", "0.25"))
        if overlaid.stale_fraction > frac and ann.two_stage_enabled(
                new.n_items):
            return ann.build_ivf(
                np.asarray(new.item_emb, np.float32),
                np.asarray(new.item_bias, np.float32),
                key=ann.build_key(new.n_items))
        return overlaid

    def serving_info(self) -> dict:
        """Which serving path this model runs (status-page observability)."""
        if self._device_items_q is not None:
            path = "device-int8"  # kernel K1 when "device" is CUDA
        elif self._device_items is not None:
            path = "device-bf16"
        elif self._host_items is not None:
            path = "host-numpy"
        else:
            path = "unprepared"
        from incubator_predictionio_tpu_torch.serving import ann

        two_stage = self._ivf is not None and ann.two_stage_enabled(self.n_items)
        return {"path": path, "serve_k": self._serve_k,
                "catalog_rows": self.n_items,
                "device": None if self._device is None else str(self._device),
                "device_resident": self.device_resident,
                "retrieval_mode": "two_stage" if two_stage else "exact",
                "index": self._ivf.stats() if self._ivf is not None else None}


class TwoTowerMF:
    def __init__(self, config: TwoTowerConfig = TwoTowerConfig()):
        self.config = config

    def fit(
        self,
        ctx,
        users: np.ndarray,     # [n] int32 user indices
        items: np.ndarray,     # [n] int32 item indices
        ratings: np.ndarray,   # [n] float32
        n_users: int,
        n_items: int,
        rows_are_local: bool = False,
    ) -> TwoTowerModel:
        """two_tower.py:677 ``fit`` on ``ctx.device``: stage the batches
        once, run ``epochs × n_batches`` steps (in chunks of
        ``checkpoint_every`` epochs with a checkpoint after each when
        ``checkpoint_dir`` is set, resuming from its latest step), keep the
        tables resident or pull them to the host (``gather``).
        ``final_loss`` is the last epoch's mean loss: the one host sync of
        the fit without checkpoints. ``timings`` has the
        reference's four phases (``stage_sec``, ``init_sec``, ``train_sec``,
        ``gather_sec``), and ``exchange_sec`` in a multi-process fit.

        ``ctx.process_count > 1``: the data-parallel fit over the context's
        process group (module docstring). ``rows_are_local=True``: the
        triples are only THIS process's entity-disjoint shard (indices
        already global), staged by :meth:`_stage_local` (reference
        :685-703); otherwise every process holds every triple, stages the
        global batches and takes its slice of each. The tables come back to
        the host (the primary persists them)."""
        cfg = self.config
        n = len(users)
        if not (len(items) == len(ratings) == n):
            raise ValueError("users/items/ratings must be equal length")
        dev = ctx.device
        multi = ctx.process_count > 1
        if multi and cfg.checkpoint_dir:
            raise NotImplementedError(
                "TwoTowerMF.fit: mid-training checkpoints of a multi-process "
                f"fit (member-slice checkpoints) come with {SHARDING_SLICE}")

        t_stage = time.perf_counter()
        if multi and rows_are_local:
            ub, ib, rb, wb, mean = self._stage_local(
                ctx, np.asarray(users), np.asarray(items), np.asarray(ratings))
        else:
            ub, ib, rb, wb, mean = _stage_batches(
                cfg, np.asarray(users), np.asarray(items), np.asarray(ratings),
                ctx.pad_to_batch_multiple)
            if multi:  # the global arrays' slice on the data axis
                b_local = ub.shape[1] // ctx.process_count
                cols = slice(ctx.process_index * b_local,
                             (ctx.process_index + 1) * b_local)
                ub, ib, rb, wb = (np.ascontiguousarray(a[:, cols])
                                  for a in (ub, ib, rb, wb))
        ub, ib, rb, wb = (torch.from_numpy(a).to(dev) for a in (ub, ib, rb, wb))
        if multi:
            gub, gib, denoms = _gather_batches(ctx, ub, ib, wb)
        _sync(dev)
        t_stage = time.perf_counter() - t_stage

        from incubator_predictionio_tpu_torch.utils.optim import adam_tree_init

        t_init = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        tables = list(_init_tables(cfg, n_users, n_items, dev, gen))
        state = adam_tree_init(tables, cfg.adam_moments_dtype)
        grads = [torch.empty_like(t) for t in tables]
        _sync(dev)
        t_init = time.perf_counter() - t_init

        from incubator_predictionio_tpu_torch.utils.checkpoint import (
            checkpointed_epochs,
        )

        clock = CollectiveClock(dev)

        def train(p, o, n):
            if multi:
                return p, o, _train_epochs_dp(
                    ctx, p, grads, o, ub, ib, rb, wb, gub, gib, denoms,
                    cfg.learning_rate, cfg.reg, n, clock)
            return p, o, _train_epochs(p, grads, o, ub, ib, rb, wb,
                                       cfg.learning_rate, cfg.reg, n)

        t_train = time.perf_counter()
        # chunks of checkpoint_every epochs with a save after each, resumed
        # from checkpoint_dir's latest step (two_tower.py:772-780)
        tables, state, loss = checkpointed_epochs(
            cfg.checkpoint_dir, cfg.checkpoint_every, cfg.checkpoint_keep,
            cfg.epochs, tables, state, train)
        loss = np.inf if loss is None else float(loss)  # the one sync
        t_train = time.perf_counter() - t_train
        n_steps = cfg.epochs * int(ub.shape[0])
        del grads, state, ub, ib, rb, wb

        t_gather = time.perf_counter()
        # auto keys on the unpadded CATALOG size, the criterion
        # prepare_for_serving uses to pick host or device serving;
        # multi-process runs keep the host gather (reference :799-803): the
        # primary alone persists
        keep_device = cfg.gather == "device" or (
            cfg.gather == "auto"
            and n_items * (cfg.rank + 1) > HOST_SERVE_MAX_ELEMENTS)
        if keep_device and multi:
            keep_device = False
        k = cfg.rank
        if keep_device:
            model = TwoTowerModel(mean=mean, config=cfg)
            model._tables = {"ue": tables[0], "ie": tables[1]}
            model._n_users = n_users
            model._n_items = n_items
            model._device = dev
        else:
            ue, ie = (t.cpu().numpy() for t in tables)
            digest = check_replicas(ctx, (ue, ie)) if multi else None
            model = TwoTowerModel(
                user_emb=ue[:n_users, :k], item_emb=ie[:n_items, :k],
                user_bias=ue[:n_users, k], item_bias=ie[:n_items, k],
                mean=mean, config=cfg)
        t_gather = time.perf_counter() - t_gather
        model.final_loss = loss
        model.timings = {
            "stage_sec": round(t_stage, 4),
            "init_sec": round(t_init, 4),
            "train_sec": round(t_train, 4),
            "gather_sec": round(t_gather, 4),
        }
        if multi:
            exchange = clock.seconds()
            model.timings["exchange_sec"] = round(exchange, 4)
            peak = (torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else 0)
            logger.info(
                "data-parallel fit: process %d of %d (backend %s, %s): %d "
                "steps of %d local rows; stage %.3f s, train %.3f s, "
                "exchange %.3f ms a step; loss %.6f; replica digest %s, equal "
                "on every process; peak device memory %d bytes",
                ctx.process_index, ctx.process_count,
                ctx.backend, dev, n_steps, int(gub.shape[1]) // ctx.process_count,
                t_stage, t_train, exchange / max(n_steps, 1) * 1e3, loss,
                digest, peak)
        return model

    def _stage_local(self, ctx, users, items, ratings):
        """Per-process batch staging for entity-sharded input rows
        (reference :855-905), in numpy: one metadata exchange of (row
        count, rating sum), the global mean in float64 Python, the global
        batch a multiple of the process count, the permutation and padding
        from ``default_rng(seed + process_index)``, an all-padding shard
        when this process has no rows, and each local batch user-sorted.
        Returns ``(ub, ib, rb, wb, mean)``: ``[n_batches, b_local]`` arrays,
        ``b_local = global batch / process_count``."""
        cfg = self.config
        n_local = len(users)
        procs = ctx.process_count
        stats = ctx.allgather_obj(
            (n_local, float(np.asarray(ratings, np.float64).sum())))
        n_global = sum(s[0] for s in stats)
        mean = (sum(s[1] for s in stats) / n_global) if n_global else 0.0
        global_batch = ctx.pad_to_batch_multiple(
            min(cfg.batch_size, max(n_global, 1)))
        if global_batch % procs:
            raise ValueError(
                f"global batch {global_batch} not divisible by "
                f"{procs} processes")
        b_local = global_batch // procs
        n_batches = max(
            1, max((s[0] + b_local - 1) // b_local for s in stats))
        n_pad = n_batches * b_local
        rng = np.random.default_rng(cfg.seed + ctx.process_index)
        if n_local:
            order = np.concatenate([
                rng.permutation(n_local),
                rng.integers(0, n_local, n_pad - n_local),
            ])
        else:
            order = np.zeros(n_pad, np.int64)  # all-padding shard
            users = np.zeros(1, np.int32)
            items = np.zeros(1, np.int32)
            ratings = np.zeros(1, np.float32)
        w = np.concatenate([
            np.ones(n_local, np.float32),
            np.zeros(n_pad - n_local, np.float32),
        ])
        order, w = _sort_batches_by_entity(
            order, w, np.asarray(users, np.int32), n_batches, b_local)

        def stage(a, dtype):
            return np.ascontiguousarray(
                np.asarray(a, dtype)[order].reshape(n_batches, b_local))

        return (
            stage(users, np.int32),
            stage(items, np.int32),
            stage(np.asarray(ratings, np.float32) - mean, np.float32),
            np.ascontiguousarray(w.reshape(n_batches, b_local)),
            mean,
        )

    # -- scoring ----------------------------------------------------------
    @staticmethod
    def recommend(
        model: TwoTowerModel,
        user_idx: int,
        num: int,
        exclude: Optional[np.ndarray] = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top-``num`` (item indices, scores) for one user; ``exclude``
        masks item indices with -inf before top-k."""
        idx, scores = TwoTowerMF.recommend_batch(
            model, np.asarray([user_idx], np.int32), num, exclude
        )
        return idx[0], scores[0]

    @staticmethod
    def recommend_batch(
        model: TwoTowerModel,
        user_idx: np.ndarray,
        num: int,
        exclude: Optional[np.ndarray] = None,
        row_mask: Optional[np.ndarray] = None,
        _force_exact: bool = False,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized top-k over the full catalog for a batch of users.

        The user batch pads to a :data:`SERVE_BUCKETS` bucket and the top-k
        size is the model's ``serve_k`` whenever ``num`` fits under it. The
        user-row gather runs on the device. ``exclude`` masks one shared
        item-index set for the whole batch; ``row_mask`` is a ``[b,
        n_items]`` f32 additive mask (0 keep / -inf drop) giving every query
        its own filter in the same dispatch (kernel K1 carries it on the
        quantized path). Returns numpy ``[b, num]`` indices and scores."""
        num = min(num, model.n_items)  # k cannot exceed the catalog
        if num <= 0:
            return (np.zeros((len(user_idx), 0), np.int64),
                    np.zeros((len(user_idx), 0), np.float32))
        if not model.prepared:
            model.prepare_for_serving()
        if row_mask is not None and row_mask.shape != (len(user_idx), model.n_items):
            raise ValueError(
                f"row_mask shape {row_mask.shape} != "
                f"(batch, n_items) {(len(user_idx), model.n_items)}")
        if model._ivf is not None and not _force_exact:
            from incubator_predictionio_tpu_torch.serving import ann

            if ann.two_stage_enabled(model.n_items):
                res = _recommend_batch_two_stage(
                    model, user_idx, num, exclude, row_mask)
                if res is not None:
                    return res
                # fewer candidates than num survived the probe — the exact
                # path below answers
        if model._host_items is not None:
            return _recommend_batch_host(model, user_idx, num, exclude, row_mask)
        dev = model._device
        b = len(user_idx)
        bucket = serve_bucket(max(b, 1))
        k = model._serve_k if 0 < num <= model._serve_k else num
        uidx = np.zeros(bucket, np.int64)
        uidx[:b] = np.asarray(user_idx, np.int64)
        uidx_t = torch.from_numpy(uidx).to(dev)
        ue_tab, ub_tab = model._device_users
        quantized = model._device_items_q is not None
        if quantized:
            items_q, scales, bias, base_mask = model._device_items_q
        else:
            item_t, item_b, base_mask = model._device_items
        mask = base_mask
        if exclude is not None and len(exclude):
            m = np.zeros(base_mask.shape[0], np.float32)
            m[np.asarray(exclude, np.int64)] = -np.inf
            mask = mask + torch.from_numpy(m).to(dev)
        rmask = None
        if row_mask is not None:
            # pad rows to the batch bucket and columns to the (quantized)
            # catalog padding; padded columns are already -inf in base_mask
            n_cols = int(mask.shape[0])
            rm = _row_mask_pad_buffer(bucket, n_cols)
            rm[:b, : row_mask.shape[1]] = row_mask
            rmask = torch.from_numpy(rm).to(dev)
        if quantized:
            idx, scores = _topk_quantized(
                uidx_t, ue_tab, ub_tab, items_q, scales, bias, mask, rmask,
                model.mean, k, model.n_items)
        else:
            idx, scores = _topk_scores(
                uidx_t, ue_tab, ub_tab, item_t, item_b, model.mean, mask,
                rmask, k)
        # ONE device→host copy for both results: the scores' bits and the
        # indices ride together as int32 columns
        packed = torch.cat([scores.view(torch.int32), idx.to(torch.int32)],
                           dim=1).cpu().numpy()
        scores_h = packed[:, :k].view(np.float32)
        idx_h = packed[:, k:].astype(np.int64)
        return idx_h[:b, :num], scores_h[:b, :num]


#: Per-thread [bucket, n_cols] row-mask pad buffers: recommend_batch copies
#: the padded mask to the device before returning, so each serving thread
#: recycles one scratch buffer per shape. Thread-local because serving
#: overlaps batches across threads.
_ROW_MASK_SCRATCH = threading.local()


def _row_mask_pad_buffer(bucket: int, n_cols: int) -> np.ndarray:
    """A zeroed, reusable ``[bucket, n_cols]`` f32 pad buffer."""
    cache = getattr(_ROW_MASK_SCRATCH, "cache", None)
    if cache is None:
        cache = _ROW_MASK_SCRATCH.cache = {}
    buf = cache.get((bucket, n_cols))
    if buf is None:
        if len(cache) >= 16:  # many models/shapes in one process: tests
            cache.clear()
        buf = cache[(bucket, n_cols)] = np.zeros((bucket, n_cols), np.float32)
    else:
        buf.fill(0.0)
    return buf


def _recommend_batch_two_stage(
    model: TwoTowerModel,
    user_idx: np.ndarray,
    num: int,
    exclude: Optional[np.ndarray] = None,
    row_mask: Optional[np.ndarray] = None,
) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """Coarse IVF pruning + exact rerank (serving/ann.py). Returns None when
    the probe can't cover ``num`` candidates — the caller's exact path
    answers."""
    if not model._ivf.hydrated:
        model._ivf.rehydrate(*model._host_item_table())
    uidx = np.asarray(user_idx, np.int64)
    if model.user_emb is None:
        # device-resident: copy the batch's user rows, not the table (the
        # reference pulls the whole table here, ensure_host)
        k = model.config.rank
        ue = model._tables["ue"]
        rows = ue[torch.from_numpy(uidx).to(ue.device)].cpu().numpy()
        q, ub = np.ascontiguousarray(rows[:, :k]), np.ascontiguousarray(rows[:, k])
    else:
        q = np.asarray(model.user_emb, np.float32)[uidx]
        ub = np.asarray(model.user_bias, np.float32)[uidx]
    return model._ivf.search(
        q, ub, model.mean, num, exclude=exclude, row_mask=row_mask)


def _recommend_batch_host(
    model: TwoTowerModel,
    user_idx: np.ndarray,
    num: int,
    exclude: Optional[np.ndarray] = None,
    row_mask: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Small-catalog top-k in host numpy: one [b, k] @ [k, n] GEMM +
    argpartition (the reference's code, unchanged)."""
    item_t, item_b = model._host_items
    ue = np.asarray(model.user_emb, np.float32)[user_idx]
    ub = np.asarray(model.user_bias, np.float32)[user_idx]
    scores = ue @ item_t + item_b[None, :] + ub[:, None] + model.mean
    if exclude is not None and len(exclude):
        scores[:, np.asarray(exclude, np.int64)] = -np.inf
    if row_mask is not None:
        scores += row_mask
    k = min(num, scores.shape[1])
    part = np.argpartition(-scores, k - 1, axis=1)[:, :k]
    row = np.arange(scores.shape[0])[:, None]
    ordr = np.argsort(-scores[row, part], axis=1)
    idx = part[row, ordr]
    return idx, scores[row, idx]


def _sort_batches_by_entity(
    order: np.ndarray, w: np.ndarray, entities: np.ndarray,
    n_batches: int, batch: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Sort each batch's rows by entity (user) index, at staging
    (two_tower.py:1128). Batch composition, and so the math, is unchanged;
    only the order within a batch, so the user-table gather and its
    scatter-add walk the table quasi-sequentially. ``w`` rides along so
    padding rows keep weight 0. The argsort is stable."""
    o2 = order.reshape(n_batches, batch)
    keys = entities[o2] if len(entities) else o2
    srt = np.argsort(keys, axis=1, kind="stable")
    return (
        np.take_along_axis(o2, srt, 1).reshape(-1),
        np.take_along_axis(w.reshape(n_batches, batch), srt, 1).reshape(-1),
    )


def _stage_batches(cfg: TwoTowerConfig, users, items, ratings,
                   pad_to_batch_multiple=lambda n: n):
    """The reference's single-process staging (two_tower.py:705-728), in
    numpy: ``[n_batches, batch]`` arrays of user indices, item indices,
    centred ratings and weights (1 for a triple, 0 for a padding row drawn
    with ``rng.integers``), and the mean rating. The permutation and the
    padding come from ``default_rng(cfg.seed)``, so they are the
    reference's, bitwise."""
    n = len(users)
    mean = float(ratings.mean()) if n else 0.0
    global_batch = pad_to_batch_multiple(min(cfg.batch_size, max(n, 1)))
    n_batches = max(1, (n + global_batch - 1) // global_batch)
    n_pad = n_batches * global_batch
    rng = np.random.default_rng(cfg.seed)
    perm = rng.permutation(n)
    pad_idx = rng.integers(0, max(n, 1), n_pad - n)
    order = np.concatenate([perm, pad_idx])
    w = np.concatenate(
        [np.ones(n, np.float32), np.zeros(n_pad - n, np.float32)])
    order, w = _sort_batches_by_entity(
        order, w, np.asarray(users, np.int32), n_batches, global_batch)

    def stage(a, dtype):
        a = np.asarray(a, dtype)[order] if len(a) == n else np.asarray(a, dtype)
        return np.ascontiguousarray(a.reshape(n_batches, global_batch))

    return (stage(users, np.int32), stage(items, np.int32),
            stage(ratings.astype(np.float32) - mean, np.float32),
            np.ascontiguousarray(w.reshape(n_batches, global_batch)), mean)


def _init_tables(cfg: TwoTowerConfig, n_users: int, n_items: int,
                 device, generator: torch.Generator):
    """The initial fused tables ``(ue, ie)``, ``[max(n, 1), rank+1]`` fp32
    on ``device`` — the one-device counterpart of the reference's
    ``sharding/table.py:ShardedTable.init_train`` (:247-270): columns
    ``:rank`` normal × ``1/sqrt(rank)`` from ``generator`` (users first,
    then items), the bias column zero. The draws are torch's, not
    ``jax.random``'s: tests inject the reference's tables here."""
    scale = float(1.0 / np.sqrt(cfg.rank))
    out = []
    for n in (n_users, n_items):
        t = torch.zeros(max(n, 1), cfg.rank + 1, dtype=torch.float32,
                        device=device)
        t[:, : cfg.rank] = torch.randn(
            max(n, 1), cfg.rank, generator=generator, device=device,
            dtype=torch.float32) * scale
        out.append(t)
    return tuple(out)


def _sync(device) -> None:
    """A phase fence: the card's queued work bills to the phase that
    queued it."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _row_grads(tables, bu, bi, br, bw, reg: float, denom: torch.Tensor):
    """The loss of one batch's rows (two_tower.py:1159-1178) over the
    denominator ``denom`` (``max(Σ w, 1)`` of the whole batch) and their
    row gradients: ``(rows_u, rows_i, loss)``, ``[B, rank+1]`` each (the
    embedding part's gradient, then the bias's) and a 0-d tensor.

    Forward, as the reference: rows gathered with the bias in the last
    column; the embedding parts rounded to bf16; their products (exact in
    fp32) summed in fp32 and the sum rounded to bf16 — what XLA computes
    for ``jnp.sum(ue * ie)`` of bf16 arrays, which keeps the product's
    precision inside the fusion and rounds the sum's bf16 result; ``pred =
    dot + user bias + item bias``; ``loss = Σ w·(pred − r)² / denom +
    reg·(Σ ue² + Σ ie²) / denom`` over the bf16-rounded rows, the
    weight-0 padding rows included in the L2 sum.

    Backward, as JAX's autodiff of it: ``dpred = (w / denom)·(2·diff)``
    in fp32; the product's cotangent ``bf16(dpred)``; each embedding's
    cotangent ``dprod·other`` (bf16) plus the L2 term's ``bf16((reg /
    denom)·(2·row))``, added in bf16; then widened to fp32, and the bias
    column ``dpred``."""
    ue_t, ie_t = tables
    k = ue_t.shape[1] - 1
    gu = ue_t.index_select(0, bu)
    gi = ie_t.index_select(0, bi)
    ub = gu[:, :k].to(torch.bfloat16)
    ib = gi[:, :k].to(torch.bfloat16)
    ubf, ibf = ub.float(), ib.float()
    dot = (ubf * ibf).sum(-1).to(torch.bfloat16).float()
    diff = dot + gu[:, k] + gi[:, k] - br
    mse = (diff * diff * bw).sum() / denom
    l2 = reg * ((ubf * ubf).sum() + (ibf * ibf).sum()) / denom
    loss = mse + l2
    inv = 1.0 / denom
    dpred = (inv * bw) * (2.0 * diff)
    dprod = dpred.to(torch.bfloat16)[:, None]
    c = reg * inv
    dub = (((2.0 * ubf) * c).to(torch.bfloat16) + dprod * ib).float()
    dib = (((2.0 * ibf) * c).to(torch.bfloat16) + dprod * ub).float()
    for rows, d_emb in ((gu, dub), (gi, dib)):
        rows[:, :k] = d_emb  # the gathered rows are scratch now
        rows[:, k] = dpred
    return gu, gi, loss


def _scatter_rows(grad: torch.Tensor, idx: torch.Tensor,
                  rows: torch.Tensor) -> None:
    """Zero ``grad`` and sum ``rows`` into it at ``idx``, each row's
    duplicates in one fixed order, so that every run, and every replica of
    a data-parallel fit, sums alike. On the card that is
    ``index_put_(accumulate=True)``: it sorts the indices (stably) and sums
    each row's duplicates in that order. (``index_add_`` adds with atomics
    there, in an order that varies from run to run; it makes a step at
    rec-train's shape 1.9% faster, ``launch_ab.py``.) On the CPU it is
    ``index_add_``, which adds the rows one after another in index order,
    while ``index_put_``'s accumulation is parallel there (atomic adds
    across threads)."""
    grad.zero_()
    if grad.device.type == "cuda":
        grad.index_put_((idx.long(),), rows, accumulate=True)
    else:
        grad.index_add_(0, idx, rows)


def _loss_and_grads(tables, grads, bu, bi, br, bw, reg: float) -> torch.Tensor:
    """The loss of one batch and its gradient, written into ``grads``
    (dense, table-shaped; overwritten): :func:`_row_grads` over the batch's
    own ``max(Σ w, 1)``, scattered by :func:`_scatter_rows`. Returns the
    loss as a 0-d device tensor."""
    gu, gi, loss = _row_grads(tables, bu, bi, br, bw, reg,
                              bw.sum().clamp(min=1.0))
    _scatter_rows(grads[0], bu, gu)
    _scatter_rows(grads[1], bi, gi)
    return loss


def _train_epochs(tables, grads, state, ub, ib, rb, wb, lr: float,
                  reg: float, n_epochs: int) -> Optional[torch.Tensor]:
    """two_tower.py:1149 ``_train_epochs``: ``n_epochs`` passes over the
    staged batches, each step :func:`_loss_and_grads` then the dense adam
    (``utils/optim.py:adam_apply``), in place on ``tables`` and ``state``.
    Returns the last epoch's mean loss as a 0-d device tensor (None for no
    epochs); nothing in the loop waits for the card."""
    from incubator_predictionio_tpu_torch.utils.optim import adam_apply

    last = None
    for epoch in range(n_epochs):
        losses = []
        for b in range(ub.shape[0]):
            losses.append(_loss_and_grads(tables, grads, ub[b], ib[b],
                                          rb[b], wb[b], reg))
            adam_apply(tables, grads, state, lr)
        if epoch == n_epochs - 1:
            last = torch.stack(losses).mean()
    return last


def _gather_batches(ctx, ub, ib, wb):
    """The global batches' row indices ``[n_batches, P·b_local]`` (int64)
    and denominators ``max(Σ w, 1)`` (``[n_batches]`` fp32), gathered once
    at staging: global batch b is every process's local batch b in process
    order (``make_array_from_process_local_data``'s layout)."""
    nb = ub.shape[0]
    gub, gib, gwb = (ctx.all_gather(a).transpose(0, 1).reshape(nb, -1)
                     for a in (ub, ib, wb))
    return gub.long(), gib.long(), gwb.sum(1).clamp(min=1.0)


def _train_epochs_dp(ctx, tables, grads, state, ub, ib, rb, wb, gub, gib,
                     denoms, lr: float, reg: float, n_epochs: int,
                     clock: CollectiveClock) -> Optional[torch.Tensor]:
    """The data-parallel ``_train_epochs`` of one process: each step the row
    gradients of its own rows over the global denominator, one all-gather
    of them (``[P, b_local, 2·(rank+1)]``), every process's rows scattered
    in process order by the fixed-order scatter, the dense adam on
    this replica. The losses of an epoch are summed across processes once,
    at its end; the last epoch's mean is returned as a 0-d tensor."""
    from incubator_predictionio_tpu_torch.utils.optim import adam_apply

    k1 = tables[0].shape[1]
    last = None
    for epoch in range(n_epochs):
        losses = []
        for b in range(ub.shape[0]):
            gu, gi, loss = _row_grads(tables, ub[b], ib[b], rb[b], wb[b],
                                      reg, denoms[b])
            rows = clock.time(lambda: ctx.all_gather(torch.cat((gu, gi), 1)))
            rows = rows.reshape(-1, 2 * k1)
            _scatter_rows(grads[0], gub[b], rows[:, :k1])
            _scatter_rows(grads[1], gib[b], rows[:, k1:])
            adam_apply(tables, grads, state, lr)
            losses.append(loss)
        if epoch == n_epochs - 1:
            last = clock.time(
                lambda: ctx.all_reduce_sum(torch.stack(losses))).mean()
    return last


def _topk_quantized(uidx, ue_tab, ub_tab, items_q, scales, bias, mask,
                    row_mask, mean, num, n_items):
    """Quantized catalog scoring through K1 (its plain version for CPU
    tensors), then ``+ user bias + mean`` and top-k over the real columns.
    The bias and mean are added in place on the kernel's output (the
    reference allocates a new array per op; the order of additions is the
    same)."""
    from incubator_predictionio_tpu_torch.ops.retrieval import (
        score_catalog_quantized,
    )

    q = ue_tab[uidx].float()  # bf16 rows widen exactly
    scores = score_catalog_quantized(q, items_q, scales, bias, mask, row_mask)
    scores.add_(ub_tab[uidx][:, None]).add_(mean)
    values, indices = _top_k(scores[:, :n_items], num)
    return indices, values


def _topk_scores(uidx, ue_tab, ub_tab, item_t, item_b, mean, mask, row_mask,
                 num):
    """bf16 exact scoring: the gathered bf16 user rows times the bf16-rounded
    catalog in one fp32 matmul (exact products, fp32 sums), then the
    reference's epilogue order: + item bias + user bias + mean + mask."""
    scores = (
        ue_tab[uidx].float() @ item_t
        + item_b[None, :]
        + ub_tab[uidx][:, None]
        + mean
        + mask[None, :]
    )
    if row_mask is not None:
        scores = scores + row_mask
    values, indices = _top_k(scores, num)
    return indices, values


def _top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` of each row of ``scores`` [B, N]: (values,
    indices) of the ``k`` largest, by score descending, then index
    ascending; where entries tie at the k-th score, the lowest indices are
    the ones taken. ``torch.topk`` finds the k-th score but leaves open
    which tied entries it takes and in what order. So a second top-k over
    an int32 key takes the k: every entry above the k-th score (key
    ``2N - index``), then the entries equal to it (``N - index``, the
    lowest index first; 0 elsewhere), each group in index order; a stable
    sort by score descending orders them. On the device, with no
    synchronisation: the caller's one copy to the host stays the only
    one."""
    n = scores.shape[1]
    kth = torch.topk(scores, k, dim=1)[0][:, -1:]
    rank = torch.arange(n, 0, -1, dtype=torch.int32, device=scores.device)
    key = torch.where(scores > kth, rank + n, torch.where(scores == kth, rank, 0))
    idx = torch.topk(key, k, dim=1)[1]
    values, order = scores.gather(1, idx).sort(dim=1, descending=True, stable=True)
    return values, idx.gather(1, order)
