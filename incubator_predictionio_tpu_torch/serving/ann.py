"""Two-stage retrieval: trained IVF coarse pruning + exact candidate rerank.

Counterpart of ``incubator_predictionio_tpu/serving/ann.py``. The index is
host numpy as in the reference, built with the same seeds, so the same
catalog gives the same partition:

- **Build** (deploy time, :func:`build_ivf`): k-means over the item
  embeddings *augmented with the item bias as an extra coordinate*; members
  are laid out contiguously per partition (CSR: ``member_ids`` +
  ``offsets``).
- **Coarse stage**: score the ``[C]`` centroids per query and keep the
  top-``nprobe`` partitions. With int8 storage (the default) the query and
  centroid rows are quantized and scored int8×int8→int32 with one fp32
  rescale. When the index has been given a CUDA device
  (:attr:`IVFIndex.device`) that scoring is kernel K2 of
  ``ops/retrieval.py`` on a resident copy of the padded centroid table
  (:meth:`IVFIndex._probe_cuda`, the reference's ``_probe_tpu``); on the CPU
  it is the exact host twin. Both give the same scores bit for bit.
- **Rerank stage**: int8×int8→int32 member scores with one rescale per
  candidate, grouped by partition across the batch, in host numpy.

Rule filters (``exclude`` / ``row_mask``) land on the rerank scores in
candidate-index space after the gather. Mode selection reads the
reference's knobs (``PIO_RETRIEVAL_MODE`` = ``exact`` | ``two_stage`` |
``auto`` and the rest below; docs/configuration.md). The reference's
metrics counters are not ported yet.

Streaming staleness: a delta deploy moves item rows after the index was
built. :meth:`IVFIndex.with_updated_rows` returns a view of the index with
the moved rows' CURRENT values overlaid; :meth:`IVFIndex.search` rescores
every gathered stale candidate from the overlay in fp32 (the other
candidates keep their int8 rerank scores) and appends the stale ids the
probe missed, so a pruned probe never serves a pre-update embedding.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from incubator_predictionio_tpu_torch.serving.topk import topk_row

#: Rows per chunk for the full-catalog assignment pass at build time — keeps
#: the [chunk, C] distance buffer bounded regardless of catalog size.
ASSIGN_CHUNK = 131_072


# -- env knobs ---------------------------------------------------------------

def retrieval_mode() -> str:
    """``PIO_RETRIEVAL_MODE``: ``exact`` | ``two_stage`` | ``auto``."""
    mode = os.environ.get("PIO_RETRIEVAL_MODE", "auto").strip().lower()
    if mode not in ("exact", "two_stage", "auto"):
        raise ValueError(
            f"PIO_RETRIEVAL_MODE={mode!r} (want exact|two_stage|auto)")
    return mode


def min_items() -> int:
    return int(os.environ.get("PIO_RETRIEVAL_MIN_ITEMS", "100000"))


def two_stage_enabled(n_items: int) -> bool:
    """Whether a catalog of ``n_items`` should serve two-stage right now."""
    mode = retrieval_mode()
    if mode == "two_stage":
        return True
    return mode == "auto" and n_items >= min_items()


def default_partitions(n_items: int) -> int:
    """√N partitions, clamped — the classic IVF sizing."""
    if n_items <= 0:
        return 1
    c = int(round(np.sqrt(n_items)))
    return max(1, min(c, max(1, n_items // 4), 65_536))


def resolved_partitions(n_items: int) -> int:
    c = int(os.environ.get("PIO_RETRIEVAL_PARTITIONS", "0"))
    return c if c > 0 else default_partitions(n_items)


def resolved_nprobe(n_partitions: int) -> int:
    """√C probes by default, clamped to the partition count."""
    p = int(os.environ.get("PIO_RETRIEVAL_NPROBE", "0"))
    if p <= 0:
        p = max(1, int(round(np.sqrt(n_partitions))))
    return min(p, n_partitions)


def quantize_enabled() -> bool:
    """int8 rerank storage is the default; ``PIO_RETRIEVAL_QUANTIZE=0``
    opts a deployment back onto the fp32 exact-math rerank."""
    return os.environ.get("PIO_RETRIEVAL_QUANTIZE", "1") != "0"


def quant_coarse_enabled(index_quantized: bool) -> bool:
    """``PIO_RETRIEVAL_QUANT_COARSE``: ``auto`` | ``1`` | ``0`` — whether the
    coarse stage scores int8×int8→int32 (requires a quantized index)."""
    val = os.environ.get("PIO_RETRIEVAL_QUANT_COARSE", "auto").strip().lower()
    if val not in ("auto", "1", "0"):
        raise ValueError(
            f"PIO_RETRIEVAL_QUANT_COARSE={val!r} (want auto|1|0)")
    if not index_quantized:
        return False
    return val != "0"


def build_key(n_items: int) -> dict:
    """Everything that invalidates a built index when it changes — a
    persisted index whose key still matches is reused instead of rebuilt."""
    return {
        "n_items": n_items,
        "n_partitions": resolved_partitions(n_items),
        "quantize": quantize_enabled(),
        "kmeans_iters": int(os.environ.get("PIO_RETRIEVAL_KMEANS_ITERS", "6")),
        "train_sample": int(
            os.environ.get("PIO_RETRIEVAL_TRAIN_SAMPLE", "65536")),
        "seed": int(os.environ.get("PIO_RETRIEVAL_SEED", "0")),
    }


# -- the index ---------------------------------------------------------------

@dataclasses.dataclass
class IVFIndex:
    """Trained partition of the catalog + member-order rerank tables.

    ``centroids`` is ``[C, D+1]`` — the last column is the partition's mean
    item bias. Members are stored sorted by partition:
    ``member_ids[offsets[p]:offsets[p+1]]`` are partition ``p``'s catalog
    indices, and ``emb_m``/``bias_m`` (or ``emb_q``/``scales_m`` when
    quantized) hold the matching rows contiguously. Read-only after build.
    Pickles slim (the clustering only), so a persisted model redeploys
    without re-clustering; ``device`` is set by whoever serves the index
    and never pickles.
    """

    centroids: np.ndarray        # [C, D+1] f32 (last col = mean member bias)
    member_ids: np.ndarray       # [N] int32, partition-sorted catalog indices
    offsets: np.ndarray          # [C+1] int64 partition boundaries
    bias_m: np.ndarray           # [N] f32 item bias in member order
    key: dict                    # build_key() this index was built under
    emb_m: Optional[np.ndarray] = None     # [N, D] f32 (fp32 rerank mode)
    emb_q: Optional[np.ndarray] = None     # [N, D] int8 (quantized mode)
    scales_m: Optional[np.ndarray] = None  # [N] f32 dequant scales
    build_seconds: float = 0.0
    #: where the coarse stage runs: a CUDA device → kernel K2
    device: Optional[torch.device] = None
    # -- streaming staleness overlay ---------------------------------------
    # Rows a delta deploy updated AFTER this index was built: the k-means
    # assignment and the member-order rerank tables (shared with older
    # deployed models) hold their PRE-update embeddings; the overlay keeps
    # the current rows (see the module docstring).
    stale_ids: Optional[np.ndarray] = None      # sorted int64 catalog ids
    stale_emb: Optional[np.ndarray] = None      # [S, D] f32 current rows
    stale_bias: Optional[np.ndarray] = None     # [S] f32 current biases

    @property
    def n_partitions(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_items(self) -> int:
        return self.member_ids.shape[0]

    @property
    def quantized(self) -> bool:
        return self.emb_q is not None

    def matches(self, key: dict) -> bool:
        return self.key == key

    # -- persistence -------------------------------------------------------

    def __post_init__(self):
        self._rehydrate_lock = threading.Lock()
        self._cent_quant = None
        self._cent_device = None
        self._probe_lock = threading.Lock()
        self._probe_stage = None

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_rehydrate_lock", None)
        state.pop("_cent_quant", None)
        state.pop("_cent_device", None)
        state.pop("_probe_lock", None)
        state.pop("_probe_stage", None)
        state["device"] = None
        for k in ("emb_m", "emb_q", "scales_m", "bias_m"):
            state[k] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._rehydrate_lock = threading.Lock()
        self._cent_quant = None
        self._cent_device = None
        self._probe_lock = threading.Lock()
        self._probe_stage = None

    def _coarse_quant(self) -> tuple[np.ndarray, np.ndarray]:
        """Lazy ``(cent_q [C, D] int8, cent_scales [C] f32)`` — the quantized
        twin of the centroid embedding columns (the mean-bias column stays
        fp32 and is added after the rescale)."""
        cq = self._cent_quant
        if cq is None:
            with self._rehydrate_lock:
                cq = self._cent_quant
                if cq is None:
                    from incubator_predictionio_tpu_torch.ops.retrieval import (
                        quantize_rows,
                    )

                    q8, scales = quantize_rows(
                        np.asarray(self.centroids[:, :-1], np.float32))
                    cq = self._cent_quant = (q8, scales)
        return cq

    @property
    def hydrated(self) -> bool:
        """Whether the rerank tables are resident (False right after
        unpickling — :meth:`rehydrate` before :meth:`search`)."""
        return self.bias_m is not None and (
            self.emb_m is not None or self.emb_q is not None)

    def rehydrate(self, item_emb: np.ndarray,
                  item_bias: np.ndarray) -> "IVFIndex":
        """Rebuild the member-order rerank tables after unpickling
        (``bias_m`` is assigned last: :attr:`hydrated` requires it)."""
        if self.hydrated:
            return self
        with self._rehydrate_lock:
            if self.hydrated:
                return self
            order = self.member_ids.astype(np.int64)
            emb_m = np.ascontiguousarray(
                np.asarray(item_emb, np.float32)[order])
            bias_m = np.ascontiguousarray(
                np.asarray(item_bias, np.float32)[order])
            if self.key.get("quantize"):
                from incubator_predictionio_tpu_torch.ops.retrieval import (
                    quantize_rows,
                )

                self.emb_q, self.scales_m = quantize_rows(emb_m)
            else:
                self.emb_m = emb_m
            self.bias_m = bias_m
        return self

    # -- streaming staleness ----------------------------------------------
    @property
    def stale_count(self) -> int:
        return 0 if self.stale_ids is None else int(len(self.stale_ids))

    @property
    def stale_fraction(self) -> float:
        n = self.n_items
        return (self.stale_count / n) if n else 0.0

    def with_updated_rows(self, ids: np.ndarray, emb_rows: np.ndarray,
                          bias_rows: np.ndarray) -> "IVFIndex":
        """A NEW index view with ``ids``' current rows overlaid. The big
        arrays (centroids, member layout, rerank tables) are shared with
        this index, which keeps serving its own view untouched. The view is
        a ``dataclasses.replace``: it keeps ``device`` and drops the cached
        device copy of the centroids, which the next probe uploads again."""
        ids = np.asarray(ids, np.int64)
        emb_rows = np.asarray(emb_rows, np.float32).reshape(len(ids), -1)
        bias_rows = np.asarray(bias_rows, np.float32).reshape(len(ids))
        merged: dict[int, tuple[np.ndarray, float]] = {}
        if self.stale_ids is not None:
            for i, sid in enumerate(self.stale_ids):
                merged[int(sid)] = (self.stale_emb[i], float(self.stale_bias[i]))
        for i, sid in enumerate(ids):
            merged[int(sid)] = (emb_rows[i], float(bias_rows[i]))
        order = np.asarray(sorted(merged), np.int64)
        return dataclasses.replace(
            self,
            stale_ids=order,
            stale_emb=np.stack([merged[int(s)][0] for s in order]).astype(
                np.float32),
            stale_bias=np.asarray(
                [merged[int(s)][1] for s in order], np.float32),
        )

    def _apply_stale_overlay(
        self, ids: np.ndarray, scores: np.ndarray, qrow: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Rescore gathered stale candidates from the overlay and append
        the stale ids this probe missed (pre-bias score space)."""
        s_ids = self.stale_ids
        pos = np.minimum(np.searchsorted(s_ids, ids), len(s_ids) - 1)
        hit = s_ids[pos] == ids
        if hit.any():
            sel = pos[hit]
            scores[hit] = self.stale_emb[sel] @ qrow + self.stale_bias[sel]
        present = np.zeros(len(s_ids), bool)
        present[pos[hit]] = True
        missing = ~present
        if missing.any():
            add_scores = (self.stale_emb[missing] @ qrow
                          + self.stale_bias[missing])
            ids = np.concatenate([ids, s_ids[missing]])
            scores = np.concatenate([scores, add_scores])
        return ids, scores

    def stats(self) -> dict:
        """Partition-shape summary for status pages."""
        sizes = np.diff(self.offsets)
        mean = float(sizes.mean()) if len(sizes) else 0.0
        n = self.n_items
        d = self.centroids.shape[1] - 1
        fp32_bytes = n * d * 4
        rerank_bytes = (n * d + n * 4) if self.quantized else fp32_bytes
        return {
            "n_partitions": int(self.n_partitions),
            "n_items": int(self.n_items),
            "partition_size_min": int(sizes.min()) if len(sizes) else 0,
            "partition_size_mean": round(mean, 1),
            "partition_size_max": int(sizes.max()) if len(sizes) else 0,
            "empty_partitions": int((sizes == 0).sum()),
            "quantized": self.quantized,
            "quant_coarse": quant_coarse_enabled(self.quantized),
            "coarse_device": None if self.device is None else str(self.device),
            "rerank_bytes": int(rerank_bytes),
            "bytes_saved": int(fp32_bytes - rerank_bytes),
            "default_nprobe": resolved_nprobe(self.n_partitions),
            "build_seconds": round(self.build_seconds, 2),
            "stale_rows": self.stale_count,
        }

    # -- search -----------------------------------------------------------

    def probe(self, q: np.ndarray, nprobe: int,
              q_quant: Optional[tuple] = None) -> np.ndarray:
        """Top-``nprobe`` partition ids per query row (``[B, nprobe]``).

        With ``q_quant`` (the ``(q_q int8, q_scales f32)`` pair from
        ``quantize_rows``) the centroid scores run int8×int8→int32 with one
        fp32 rescale: kernel K2 when the index has a CUDA device, else the
        exact host twin; the fp32 mean-member-bias column is added after the
        rescale either way."""
        if q_quant is not None:
            q_q, q_scales = q_quant
            if self.device is not None and self.device.type == "cuda":
                coarse = self._probe_cuda(q_q, q_scales)
            else:
                from incubator_predictionio_tpu_torch.ops.retrieval import (
                    int8_matmul_exact,
                )

                cent_q, cent_scales = self._coarse_quant()
                coarse = (int8_matmul_exact(q_q, cent_q)
                          * (q_scales[:, None] * cent_scales[None, :])
                          + self.centroids[:, -1][None, :])
        else:
            coarse = (q @ self.centroids[:, :-1].T
                      + self.centroids[:, -1][None, :])
        if nprobe >= self.n_partitions:
            return np.tile(np.arange(self.n_partitions), (len(q), 1))
        return np.argpartition(-coarse, nprobe - 1, axis=1)[:, :nprobe]

    def _probe_cuda(self, q_q: np.ndarray, q_scales: np.ndarray) -> np.ndarray:
        """Coarse scores through kernel K2 on a resident device copy of the
        padded quantized centroid table. The batch pads to a power-of-two
        bucket (≥ 8), as the reference's ``_probe_tpu`` does, and its
        queries and scales cross to the card packed in one pinned host
        buffer, in one copy; one copy brings the scores back. Centroid
        padding carries -inf bias and can never win a probe slot."""
        from incubator_predictionio_tpu_torch.ops.retrieval import (
            pack_probe_queries,
            pad_centroids,
            probe_bucket,
            probe_packed_bytes,
            score_centroids_quantized,
            unpack_probe_queries,
        )
        from incubator_predictionio_tpu_torch.utils import jitstats

        dev = self._cent_device
        if dev is None:
            # outside the lock: _coarse_quant takes it too (the reference's
            # _probe_tpu calls it under the lock and deadlocks on the first
            # probe of a fresh index)
            cent_q, cent_scales = self._coarse_quant()
            with self._rehydrate_lock:
                dev = self._cent_device
                if dev is None:
                    cq, cs, cb = pad_centroids(
                        cent_q, cent_scales,
                        np.asarray(self.centroids[:, -1], np.float32))
                    dev = self._cent_device = tuple(
                        torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                        for v in (cq, cs, cb))
        cq, cs, cb = dev
        b, d = q_q.shape
        nbytes = probe_packed_bytes(b, d)
        # the pinned staging buffer is reused, grown on demand: held until
        # the scores are back (the copy down synchronizes, so the copy up
        # has finished with it)
        with self._probe_lock:
            stage = self._probe_stage
            if stage is None or stage.numel() < nbytes:
                stage = self._probe_stage = torch.empty(
                    1 << (nbytes - 1).bit_length(), dtype=torch.uint8,
                    pin_memory=self.device.type == "cuda")
            # the reference's dispatch key (ann.py:475): a first probe of
            # each bucket books its wall time
            with jitstats.dispatch_timer(
                    ("ivf_coarse_int8", probe_bucket(b), int(cq.shape[0]))):
                packed = pack_probe_queries(q_q, q_scales, stage)
                packed = packed.to(self.device, non_blocking=True)
                out = score_centroids_quantized(
                    *unpack_probe_queries(packed, b, d), cq, cs, cb)
                # whole leading rows: one contiguous copy down
                out = out[:b].cpu().numpy()
            return out[:, : self.n_partitions]

    def _int8_partition_scores(
        self, probe: np.ndarray, q_quant: tuple,
    ) -> dict[int, "Iterator[np.ndarray]"]:
        """int8×int8→int32 rerank scores for every probed partition, grouped
        by partition across the batch (one ``[probers, members]`` GEMM per
        partition). Returns ``{partition: row-iterator}`` yielding that
        partition's score rows in ascending query order, rescaled and with
        the member bias applied."""
        from incubator_predictionio_tpu_torch.ops.retrieval import (
            INT8_EXACT_MAX_RANK,
            int8_matmul_exact,
        )

        q_q, q_scales = q_quant
        flat = probe.ravel()
        order = np.argsort(flat, kind="stable")  # stable ⇒ ascending query
        qidx = order // probe.shape[1]
        sflat = flat[order]
        bounds = np.flatnonzero(np.diff(sflat)) + 1
        starts = np.concatenate(([0], bounds))
        ends = np.concatenate((bounds, [len(sflat)]))
        exact_f32 = q_q.shape[1] <= INT8_EXACT_MAX_RANK
        qf = q_q.astype(np.float32 if exact_f32 else np.float64)
        emb_q, offsets = self.emb_q, self.offsets
        scales_m, bias_m = self.scales_m, self.bias_m
        out: dict[int, Iterator[np.ndarray]] = {}
        for a, e in zip(starts.tolist(), ends.tolist()):
            p = int(sflat[a])
            lo, hi = int(offsets[p]), int(offsets[p + 1])
            if hi == lo:
                continue
            who = qidx[a:e]
            if exact_f32:
                acc = qf[who] @ emb_q[lo:hi].astype(np.float32).T
            else:
                acc = int8_matmul_exact(q_q[who], emb_q[lo:hi])
            acc *= q_scales[who][:, None] * scales_m[lo:hi][None, :]
            acc += bias_m[lo:hi][None, :]
            out[p] = iter(acc)
        return out

    def search(
        self,
        q: np.ndarray,               # [B, D] f32 user vectors
        user_bias: np.ndarray,       # [B] f32
        mean: float,
        num: int,
        nprobe: Optional[int] = None,
        exclude: Optional[np.ndarray] = None,
        row_mask: Optional[np.ndarray] = None,
    ) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """Two-stage top-``num``: ``(idx [B, num] int64, scores [B, num]
        f32)`` with the exact path's score semantics, or ``None`` when some
        row's probed partitions hold fewer than ``num`` raw candidates — or
        fewer than ``num`` that survive the rule filters with a finite score
        (the caller then answers from the exact path)."""
        b = q.shape[0]
        if num <= 0:
            return (np.zeros((b, 0), np.int64), np.zeros((b, 0), np.float32))
        if b == 0:
            return (np.zeros((0, num), np.int64), np.zeros((0, num), np.float32))
        nprobe = resolved_nprobe(self.n_partitions) if nprobe is None \
            else min(max(1, nprobe), self.n_partitions)
        q_quant = None
        if self.quantized:
            from incubator_predictionio_tpu_torch.ops.retrieval import (
                quantize_rows,
            )

            # one per-row query quantization serves BOTH stages
            q_quant = quantize_rows(np.asarray(q, np.float32))
        int8_coarse = q_quant is not None and quant_coarse_enabled(True)
        probe = self.probe(q, nprobe, q_quant=q_quant if int8_coarse else None)
        counts = np.diff(self.offsets)[probe].sum(axis=1)
        if int(counts.min()) < num:
            return None
        excl_sorted = None
        if exclude is not None and len(exclude):
            excl_sorted = np.sort(np.asarray(exclude, np.int64))
        part_scores = None
        if q_quant is not None:
            part_scores = self._int8_partition_scores(probe, q_quant)
        out_idx = np.empty((b, num), np.int64)
        out_scores = np.empty((b, num), np.float32)
        for r in range(b):
            parts = np.sort(probe[r])  # ordered slices walk memory forward
            cnt = int(counts[r])
            ids = np.empty(cnt, np.int32)
            scores = np.empty(cnt, np.float32)
            qrow = q[r]
            pos = 0
            bnds = self.offsets[parts].tolist()
            ubnds = self.offsets[parts + 1].tolist()
            for p, lo, hi in zip(parts.tolist(), bnds, ubnds):
                m = hi - lo
                if not m:
                    continue
                ids[pos:pos + m] = self.member_ids[lo:hi]
                if part_scores is not None:
                    scores[pos:pos + m] = next(part_scores[p])
                else:
                    scores[pos:pos + m] = \
                        self.emb_m[lo:hi] @ qrow + self.bias_m[lo:hi]
                pos += m
            if self.stale_ids is not None and len(self.stale_ids):
                ids, scores = self._apply_stale_overlay(ids, scores, qrow)
            scores += user_bias[r] + mean
            if excl_sorted is not None:
                pos = np.minimum(np.searchsorted(excl_sorted, ids),
                                 len(excl_sorted) - 1)
                scores[excl_sorted[pos] == ids] = -np.inf
            if row_mask is not None:
                scores += row_mask[r, ids]
            top = topk_row(scores, num)
            if not np.isfinite(scores[top[-1]]):
                return None  # a masked item would fill a slot: exact path
            out_idx[r] = ids[top]
            out_scores[r] = scores[top]
        return out_idx, out_scores


# -- build -------------------------------------------------------------------

def _assign(x: np.ndarray, cent: np.ndarray,
            chunk: int = ASSIGN_CHUNK) -> np.ndarray:
    """Nearest-centroid (euclidean) assignment, chunked over rows."""
    half = 0.5 * np.einsum("cd,cd->c", cent, cent)
    out = np.empty(len(x), np.int32)
    for lo in range(0, len(x), chunk):
        d = x[lo:lo + chunk] @ cent.T
        d -= half[None, :]
        out[lo:lo + chunk] = np.argmax(d, axis=1)
    return out


def _kmeans(x: np.ndarray, c: int, iters: int,
            rng: np.random.Generator) -> np.ndarray:
    """Lloyd's k-means on (a sample of) the augmented rows; empty clusters
    reseed from random rows so every centroid stays live."""
    cent = x[rng.choice(len(x), size=c, replace=False)].copy()
    d = x.shape[1]
    for _ in range(iters):
        a = _assign(x, cent)
        counts = np.bincount(a, minlength=c).astype(np.float64)
        for j in range(d):
            cent[:, j] = np.bincount(a, weights=x[:, j], minlength=c)
        live = counts > 0
        cent[live] /= counts[live, None]
        n_dead = int((~live).sum())
        if n_dead:
            cent[~live] = x[rng.choice(len(x), size=n_dead, replace=False)]
    return cent


def build_ivf(item_emb: np.ndarray, item_bias: np.ndarray,
              key: Optional[dict] = None) -> IVFIndex:
    """Cluster the catalog and lay out the member-order rerank tables:
    k-means on a bounded sample plus one full-catalog assignment pass."""
    n, d = item_emb.shape
    key = dict(key if key is not None else build_key(n))
    if key.get("n_items") != n:
        key["n_items"] = n
    rng = np.random.default_rng(key["seed"])
    c = min(key["n_partitions"], max(1, n))
    t0 = time.perf_counter()
    item_emb = np.asarray(item_emb, np.float32)
    item_bias = np.asarray(item_bias, np.float32)
    aug = np.concatenate([item_emb, item_bias[:, None]], axis=1)
    sample = min(int(key["train_sample"]), n)
    train = aug if sample >= n else \
        aug[rng.choice(n, size=sample, replace=False)]
    c = min(c, len(train))  # can't seed more centroids than training rows
    cent = _kmeans(train, c, int(key["kmeans_iters"]), rng)
    assign = _assign(aug, cent)
    order = np.argsort(assign, kind="stable")
    sizes = np.bincount(assign, minlength=c)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    emb_m = np.ascontiguousarray(item_emb[order])
    index = IVFIndex(
        centroids=cent,
        member_ids=order.astype(np.int32),
        offsets=offsets,
        bias_m=np.ascontiguousarray(item_bias[order]),
        key=key,
    )
    if key["quantize"]:
        from incubator_predictionio_tpu_torch.ops.retrieval import quantize_rows

        index.emb_q, index.scales_m = quantize_rows(emb_m)
    else:
        index.emb_m = emb_m
    index.build_seconds = time.perf_counter() - t0
    return index
