"""Two-tower matrix factorization — the serving side.

Counterpart of ``incubator_predictionio_tpu/models/two_tower.py``: the model
container, its serving preparation and warmup, and top-k retrieval over the
catalog (``TwoTowerMF.recommend`` / ``recommend_batch``). Three serving
paths, chosen as in the reference:

- catalogs up to :data:`HOST_SERVE_MAX_ELEMENTS` table elements score in
  host numpy (:func:`_recommend_batch_host`);
- larger catalogs go device-resident on the model's ``torch.device``: bf16
  tables scored by a fp32 matmul (:func:`_topk_scores`), or, with
  ``quantize=True``, the int8 catalog scored by kernel K1 of
  ``ops/retrieval.py`` (:func:`_topk_quantized`);
- with two-stage retrieval enabled (``serving/ann.py``) the IVF index
  prunes first, and its coarse stage runs kernel K2 on a CUDA device.

Streaming deltas land through :meth:`TwoTowerModel.with_row_updates`
(build-beside: a NEW model over copied tables, the IVF index overlaid with
the moved rows). Training (``fit``) and sharded serving come in later
slices (ROADMAP.md).

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
import threading
from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    """Serving needs the rank; the streaming fold reads the learning rate
    and the L2 weight. The reference's other training fields come with the
    training slice."""

    rank: int = 32                  # ALS "rank" (ALSAlgorithm.scala params)
    learning_rate: float = 3e-2
    reg: float = 1e-4               # ALS "lambda"


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
    """user/item factor tables + biases + global mean, as host numpy.

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

    _device = None  # torch.device the device buffers live on
    # (item_embᵀ as bf16-rounded fp32 [k, n], item_bias, zero mask)
    _device_items = None
    _device_items_q = None  # int8-quantized catalog (kernel K1)
    _device_users = None  # (user_emb bf16, user_bias f32)
    _host_items = None  # small-catalog host fast path (item_embᵀ, item_bias)
    _serve_k = 0  # top-k the device path computes when num fits under it
    _ivf = None  # two-stage retrieval index (serving/ann.py), host numpy

    def __getstate__(self):
        # device handles and serving buffers never serialize — deploy
        # rebuilds them
        return {k: v for k, v in self.__dict__.items()
                if k not in ("_device", "_device_items", "_device_items_q",
                             "_device_users", "_host_items")}

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
        """Host ``(item_emb, item_bias)`` as float32."""
        return (np.asarray(self.item_emb, np.float32),
                np.asarray(self.item_bias, np.float32))

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
            self._host_items = (
                np.ascontiguousarray(np.asarray(self.item_emb, np.float32).T),
                np.asarray(self.item_bias, np.float32),
            )
            return self
        dev = self._device
        self._device_users = (
            torch.from_numpy(np.asarray(self.user_emb, np.float32)).to(dev)
            .to(torch.bfloat16),
            torch.from_numpy(np.asarray(self.user_bias, np.float32)).to(dev),
        )
        item_emb = torch.from_numpy(np.asarray(self.item_emb, np.float32)).to(dev)
        item_bias = torch.from_numpy(np.asarray(self.item_bias, np.float32)).to(dev)
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
        return self.item_emb.shape[0]

    @property
    def n_users(self) -> int:
        return self.user_emb.shape[0]

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
        the caller swaps the new model in. The new model is unprepared:
        serving it runs :meth:`prepare_for_serving` again, which uploads
        (and on a CUDA device quantizes) the whole catalog anew.

        Item rows that moved are overlaid on the IVF index
        (:meth:`serving.ann.IVFIndex.with_updated_rows`); past
        ``PIO_STREAM_STALE_REBUILD_FRAC`` of the catalog stale, the index is
        re-clustered from the updated table instead."""
        if self.user_emb is None:
            raise NotImplementedError(
                "delta apply on a sharded model comes with the sharding "
                "slice of the PyTorch port (ROADMAP.md Queue 1, item 4)")
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
                "retrieval_mode": "two_stage" if two_stage else "exact",
                "index": self._ivf.stats() if self._ivf is not None else None}


class TwoTowerMF:
    def __init__(self, config: TwoTowerConfig = TwoTowerConfig()):
        self.config = config

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
