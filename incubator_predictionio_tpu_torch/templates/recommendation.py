"""Recommendation template — training and serving.

Counterpart of ``incubator_predictionio_tpu/templates/recommendation.py``
(the scala-parallel-recommendation template): the query and result types,
:class:`TrainingData`, ``DataSource.read_training`` (rate and buy events
from the event store, the latest event of a pair wins, a buy without a
rating counts ``buy_rating``), ``DataSource.read_eval`` (k folds over the
rating triples, each fold's train set re-indexed to its own vocabularies),
``ALSAlgorithm.train`` (two-tower MF on the card, ``models/two_tower.py``),
:class:`RecModel` with its persistence and serving preparation,
``ALSAlgorithm.predict`` / ``batch_predict``, :class:`RecommendationEngine`
and the evaluation: :class:`PrecisionAtK`, :class:`PositiveCount`,
:class:`RecommendationEvaluation` (reference Evaluation.scala:62-106).
Under several processes ``read_training`` reads this process's entity
shard (``_read_sharded``), ``read_eval`` folds it
(``_read_eval_sharded``), and the fit is data-parallel.

Query ``{"user": U, "num": N, "blackList": [...]}`` → PredictedResult
``{"itemScores": [{"item": I, "score": S}, …]}``; an unknown user gets the
reference's empty answer, or with ``PIO_COLDSTART_MODE=hash`` an answer
from its cold-start bucket row (``streaming/coldstart.py``). Streaming
deltas land through :meth:`RecModel.apply_delta`.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Sequence

import numpy as np

from incubator_predictionio_tpu_torch.core import (
    Engine,
    EngineFactory,
    EngineParams,
    EngineParamsGenerator,
    Evaluation,
    FirstServing,
    IdentityPreparator,
    MetricEvaluator,
    OptionAverageMetric,
    PAlgorithm,
    Params,
    PDataSource,
    PersistentModel,
    SanityCheck,
)
from incubator_predictionio_tpu_torch.data.bimap import BiMap
from incubator_predictionio_tpu_torch.data.store import PEventStore
from incubator_predictionio_tpu_torch.models.two_tower import (
    ROW_MASK_MAX_ELEMENTS,
    TwoTowerConfig,
    TwoTowerMF,
    TwoTowerModel,
    serve_bucket,
)
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext

logger = logging.getLogger(__name__)


# -- queries / results ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Query:
    user: str
    num: int = 10
    # blacklist-items variant: never return these
    black_list: Optional[tuple[str, ...]] = None


@dataclasses.dataclass(frozen=True)
class ItemScore:
    item: str
    score: float


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    item_scores: tuple[ItemScore, ...] = ()


# -- data source ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = "recommendation"
    eval_k: Optional[int] = None
    eval_queries_per_fold: int = 100
    buy_rating: float = 4.0  # implicit weight of a "buy" (DataSource.scala:61)
    seed: int = 42
    event_names: tuple[str, ...] = ("rate", "buy")
    default_ratings: Optional[dict[str, float]] = None

    def rating_defaults(self) -> dict[str, float]:
        """Implicit ratings of events without a ``rating`` property."""
        if self.default_ratings is not None:
            return {k: float(v) for k, v in self.default_ratings.items()}
        return {"buy": self.buy_rating}


@dataclasses.dataclass
class TrainingData(SanityCheck):
    """Rating triples, columnar-indexed (the RDD[Rating] counterpart):
    vocabularies of distinct ids plus int32 index arrays into them, the
    layout :meth:`PEventStore.assemble_triples` produces."""

    user_idx: np.ndarray    # [n] int32 into user_vocab
    item_idx: np.ndarray    # [n] int32 into item_vocab
    ratings: np.ndarray     # [n] float32
    user_vocab: np.ndarray  # [U] str
    item_vocab: np.ndarray  # [I] str
    # multi-process sharded read: rows are THIS process's entity shard only
    # (vocabularies and indices are global); n_rows_global is the job total
    rows_are_local: bool = False
    n_rows_global: Optional[int] = None

    def sanity_check(self) -> None:
        total = (
            self.n_rows_global if self.n_rows_global is not None
            else len(self.ratings)
        )
        if total == 0:
            raise ValueError("TrainingData is empty (no rate/buy events found)")


class DataSource(PDataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        super().__init__(params)
        self._store = PEventStore()

    def _read(self) -> TrainingData:
        # latest event of a (user, item) pair wins (dedup=True); "buy" implies
        # a fixed rating, "rate" carries it in properties (DataSource.scala:45-77)
        user_vocab, item_vocab, user_idx, item_idx, ratings = (
            self._store.assemble_triples(
                self.params.app_name,
                entity_type="user",
                event_names=tuple(self.params.event_names),
                target_entity_type="item",
                value_property="rating",
                default_values=self.params.rating_defaults(),
                dedup=True,
            )
        )
        return TrainingData(user_idx, item_idx, ratings, user_vocab, item_vocab)

    def read_training(self, ctx: DeviceContext) -> TrainingData:
        from incubator_predictionio_tpu_torch.data.sharded import data_shard

        if data_shard(ctx)[1] > 1:
            return self._read_sharded(ctx)
        return self._read()

    def _read_sharded(self, ctx: DeviceContext) -> TrainingData:
        """Per-process entity-disjoint read (reference recommendation.py:
        153-196; its counterpart: RDD partition reads, JDBCPEvents.scala:91):
        each process reads ~1/P of the store instead of replicating it.
        A shard is a data coordinate: the processes of one ``model`` line
        read the same shard (``data/sharded.py:data_shard``).

        Users are entity-sharded, so the global user vocabulary is the
        concatenation of the per-shard vocabularies (one offset exchange).
        Item ids cross shards, so the global item vocabulary is the
        first-seen union over shards in process order (one vocabulary-sized
        allgather, never event-sized)."""
        import time

        from incubator_predictionio_tpu_torch.data.sharded import (
            concat_vocab,
            data_shard,
            global_row_count,
            union_vocab,
        )

        t0 = time.perf_counter()
        pid, procs = data_shard(ctx)
        uv, iv, ui, ii, vals = self._store.assemble_triples(
            self.params.app_name,
            entity_type="user",
            event_names=tuple(self.params.event_names),
            target_entity_type="item",
            value_property="rating",
            default_values=self.params.rating_defaults(),
            dedup=True,
            n_shards=procs,
            shard_index=pid,
        )
        user_vocab, user_offset = concat_vocab(ctx, uv)
        item_vocab, item_remap = union_vocab(ctx, iv)
        n_rows_global = global_row_count(ctx, len(vals))
        logger.info(
            "sharded read: %d of %d rows (shard %d/%d), %d local users, "
            "%d global users, %d global items in %.3f s",
            len(vals), n_rows_global, pid, procs, len(uv),
            len(user_vocab), len(item_vocab), time.perf_counter() - t0,
        )
        return TrainingData(
            ui + np.int32(user_offset),
            item_remap[ii] if len(ii) else ii,
            vals, user_vocab, item_vocab,
            rows_are_local=True, n_rows_global=n_rows_global,
        )

    def read_eval(self, ctx: DeviceContext):
        """k-fold split over rating triples (reference DataSource.scala:83-…,
        recommendation.py:197-237): a held-out fold becomes (Query(user),
        ActualResult(ratings)) per user. Each fold's TrainingData is
        re-indexed against the fold's own vocab, so held-out-only users stay
        unknown at predict time (the reference builds its BiMaps per fold
        from train data only)."""
        k = self.params.eval_k
        if not k:
            return []
        if ctx.process_count > 1:
            return self._read_eval_sharded(ctx, k)
        td = self._read()
        n = len(td.ratings)
        rng = np.random.default_rng(self.params.seed)
        fold_of = rng.integers(0, k, n)
        folds = []
        for fold in range(k):
            train_mask = fold_of != fold
            test_mask = ~train_mask
            train = _subset(td, train_mask)
            qa = self._fold_qa(td, test_mask)
            folds.append((train, {"fold": fold}, qa))
        return folds

    def _fold_qa(self, td: TrainingData, test_mask: np.ndarray):
        """Held-out positives grouped per user → (Query, ActualResult) pairs."""
        per_user: dict[str, list[tuple[str, float]]] = {}
        for u, i, r in zip(td.user_vocab[td.user_idx[test_mask]],
                           td.item_vocab[td.item_idx[test_mask]],
                           td.ratings[test_mask]):
            per_user.setdefault(u, []).append((i, float(r)))
        return [
            (Query(user=u, num=self.params.eval_queries_per_fold),
             ActualResult(tuple(ItemRating(i, r) for i, r in pairs)))
            for u, pairs in per_user.items()
        ]

    def _read_eval_sharded(self, ctx: DeviceContext, k: int):
        """recommendation.py:239-290: each process reads its entity shard
        (``_read_sharded``), fold membership is a stable hash of the (user,
        item) pair (no coordination), each fold's vocabularies are
        fold-local (users entity-disjoint: ``concat_vocab``; items cross
        shards: ``union_vocab``), the fold's train rows stay local
        (``rows_are_local``), and the (small) held-out pairs are
        allgathered in process order, so that every process evaluates the
        same query set with the same (replicated) model."""
        import zlib

        from incubator_predictionio_tpu_torch.data.sharded import (
            concat_vocab,
            data_shard,
            gather_data,
            global_row_count,
            union_vocab,
        )

        td = self._read_sharded(ctx)  # local rows, global vocabularies
        u_str = td.user_vocab[td.user_idx]
        i_str = td.item_vocab[td.item_idx]
        fold_of = np.asarray([
            zlib.crc32(f"{self.params.seed}|{u}|{i}".encode()) % k
            for u, i in zip(u_str, i_str)
        ], np.int64) if len(u_str) else np.zeros(0, np.int64)
        folds = []
        for fold in range(k):
            train_mask = fold_of != fold
            test_mask = ~train_mask
            # fold-local vocabularies (collective, vocabulary-sized)
            keep_u = np.unique(td.user_idx[train_mask])
            keep_i = np.unique(td.item_idx[train_mask])
            user_vocab, user_offset = concat_vocab(ctx, td.user_vocab[keep_u])
            item_vocab, item_remap = union_vocab(ctx, td.item_vocab[keep_i])
            remap_u = np.full(len(td.user_vocab), -1, np.int32)
            remap_u[keep_u] = user_offset + np.arange(len(keep_u), dtype=np.int32)
            remap_i = np.full(len(td.item_vocab), -1, np.int32)
            remap_i[keep_i] = item_remap
            n_global = global_row_count(ctx, int(train_mask.sum()))
            train = TrainingData(
                remap_u[td.user_idx[train_mask]],
                remap_i[td.item_idx[train_mask]],
                td.ratings[train_mask],
                user_vocab, item_vocab,
                rows_are_local=True, n_rows_global=n_global,
            )
            local_qa = self._fold_qa(td, test_mask)
            parts = gather_data(ctx, [
                (q.user, q.num, [(ir.item, ir.rating) for ir in a.ratings])
                for q, a in local_qa])
            qa = [
                (Query(user=u, num=num),
                 ActualResult(tuple(ItemRating(i, r) for i, r in pairs)))
                for part in parts for u, num, pairs in part
            ]
            logger.info(
                "sharded eval fold %d of %d: %d of %d train rows (shard "
                "%d/%d), %d held-out queries, query digest %s", fold, k,
                int(train_mask.sum()), n_global, *data_shard(ctx), len(qa),
                query_digest(parts))
            folds.append((train, {"fold": fold}, qa))
        return folds


def query_digest(parts) -> str:
    """A digest of a sharded fold's gathered held-out queries (every
    process's ``(user, num, [(item, rating), …])`` list, in process order):
    the processes of one evaluation log the same one."""
    import hashlib

    return hashlib.blake2b(repr(parts).encode(), digest_size=8).hexdigest()


def _subset(td: TrainingData, mask: np.ndarray) -> TrainingData:
    """Rows where ``mask`` — re-indexed against a vocab of only the ids that
    survive, so absent ids are genuinely unknown to the trained model."""
    u, i, r = td.user_idx[mask], td.item_idx[mask], td.ratings[mask]
    keep_u = np.unique(u)
    keep_i = np.unique(i)
    remap_u = np.full(len(td.user_vocab), -1, np.int32)
    remap_u[keep_u] = np.arange(len(keep_u), dtype=np.int32)
    remap_i = np.full(len(td.item_vocab), -1, np.int32)
    remap_i[keep_i] = np.arange(len(keep_i), dtype=np.int32)
    return TrainingData(
        remap_u[u], remap_i[i], r, td.user_vocab[keep_u], td.item_vocab[keep_i]
    )


@dataclasses.dataclass(frozen=True)
class ItemRating:
    item: str
    rating: float


@dataclasses.dataclass(frozen=True)
class ActualResult:
    """Held-out positives for one user (reference ActualResult)."""

    ratings: tuple[ItemRating, ...]


# -- algorithm --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    """Named after the reference's params (rank/numIterations/lambda/seed)."""

    rank: int = 32
    num_iterations: int = 20
    lambda_: float = 1e-4
    learning_rate: float = 3e-2
    batch_size: int = 8192
    seed: Optional[int] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    gather: str = "auto"


@dataclasses.dataclass
class RecModel(PersistentModel):
    """TwoTowerModel + id vocabularies (reference ALSModel: factors + BiMaps).

    Persistence (PersistentModel SPI): host models fall back to default
    MODELDATA pickling (``save`` returns False). Device-resident models
    write their fused tables with ``torch.save`` from the card, plus a
    pickled sidecar (config, mean, row counts, BiMaps, IVF index, the shard
    layout record and per-shard IVF partitions, cold-start rows: the
    reference's ``sidecar.pkl`` keys) under
    ``utils/fs.subdir("device_models")/<model_id>``; ``load`` restores the
    tables straight onto ``ctx.device``, and sharded serving places its
    shards from there device to device. The reference writes an orbax
    checkpoint there instead."""

    mf: TwoTowerModel
    user_map: BiMap
    item_map: BiMap

    @staticmethod
    def _device_dir(model_id: str) -> str:
        import os

        from incubator_predictionio_tpu_torch.utils.fs import subdir

        return os.path.join(subdir("device_models"), model_id)

    def save(self, model_id: str, params: Params, ctx: DeviceContext) -> bool:
        if not self.mf.device_resident:
            return False  # host model → default MODELDATA pickling
        import os
        import pickle

        import torch

        from incubator_predictionio_tpu_torch.utils.fs import atomic_write_bytes

        d = self._device_dir(model_id)
        os.makedirs(d, exist_ok=True)
        # a retrain reuses the instance id: both files are replaced whole
        torch.save(dict(self.mf._tables), os.path.join(d, "tables.pt.tmp"))
        os.replace(os.path.join(d, "tables.pt.tmp"), os.path.join(d, "tables.pt"))
        meta = {
            "config": self.mf.config,
            "mean": self.mf.mean,
            "n_users": self.mf._n_users,
            "n_items": self.mf._n_items,
            "table_rows": {k: int(v.shape[0])
                           for k, v in self.mf._tables.items()},
            "user_map": self.user_map,
            "item_map": self.item_map,
            # two-stage retrieval index (host numpy; built at train end when
            # the catalog qualifies, else None)
            "ivf": self.mf._ivf,
            # sharded layout record + per-shard IVF partitions: a sharded
            # redeploy skips the per-shard re-cluster
            "shard_spec": self.mf._shard_spec,
            "shard_ivf": self.mf._shard_ivf,
            "coldstart": getattr(self, "coldstart", None),
        }
        atomic_write_bytes(os.path.join(d, "sidecar.pkl"), pickle.dumps(meta))
        return True

    @classmethod
    def load(cls, model_id: str, params: Params, ctx: DeviceContext) -> "RecModel":
        import os
        import pickle

        import torch

        from incubator_predictionio_tpu_torch.sharding import (
            serve as shard_serve,
        )

        d = cls._device_dir(model_id)
        with open(os.path.join(d, "sidecar.pkl"), "rb") as f:
            meta = pickle.load(f)
        # the restore layout (reference :430-438): with more than one
        # serving shard the tables still land on ctx.device, and the
        # deploy's prepare places each shard on its card device to device —
        # never through a full-table host copy
        trained = (meta.get("shard_spec") or {}).get("ie")
        serve_shards = shard_serve.restore_shards(
            meta["n_items"], meta["config"].rank,
            trained.n_shards if trained is not None else 1,
            device_type=ctx.device.type)
        tables = torch.load(os.path.join(d, "tables.pt"),
                            map_location=ctx.device, weights_only=True)
        for k, rows in meta["table_rows"].items():
            if tuple(tables[k].shape) != (rows, meta["config"].rank + 1):
                raise ValueError(f"persisted table {k} has shape "
                                 f"{tuple(tables[k].shape)}; the sidecar says "
                                 f"{rows} rows of rank {meta['config'].rank} + 1")
        mf = TwoTowerModel(mean=meta["mean"], config=meta["config"])
        mf._tables = tables
        mf._n_users = meta["n_users"]
        mf._n_items = meta["n_items"]
        mf._device = ctx.device
        mf._ivf = meta.get("ivf")
        mf._shard_spec = meta.get("shard_spec")
        mf._shard_ivf = meta.get("shard_ivf")
        model = cls(mf, meta["user_map"], meta["item_map"])
        model.coldstart = meta.get("coldstart")
        model.restore_shards = serve_shards
        if serve_shards > 1:
            logger.info("restore %s: %d serving shards over %s", model_id,
                        serve_shards, ctx.device.type)
        return model

    def prepare_for_serving(self, ctx: DeviceContext) -> "RecModel":
        # on a CUDA device the catalog is int8-quantized on the card and
        # scored by kernel K1 (the reference quantizes when its platform is
        # "tpu"); a sharded layout ignores ``quantize``, as the reference's.
        # A delta-applied sharded model arrives prepared: its shards were
        # rebuilt beside the live ones by with_row_updates
        if self.mf._sharded is not None:
            return self
        self.mf.prepare_for_serving(quantize=ctx.device.type == "cuda",
                                    device=ctx.device)
        return self

    def warmup(self, max_batch: int = 64) -> int:
        """Dispatch every serving batch bucket once (called at deploy)."""
        return self.mf.warmup(max_batch)

    def serving_info(self) -> dict:
        return self.mf.serving_info()

    def shard_info(self) -> dict:
        """Shard layout + HBM estimates (the ``shards`` verb)."""
        return self.mf.shard_info()

    # -- streaming deltas -------------------------------------------------
    def apply_delta(self, delta) -> "RecModel":
        """Build-beside application of a streaming delta: a NEW RecModel
        with the delta's absolute rows scattered into copied tables (and
        cold-start bucket rows merged); the receiver is never mutated. The
        id maps are shared: a delta never grows the vocabulary."""
        mf = self.mf.with_row_updates(delta.user_rows, delta.item_rows)
        cs = getattr(self, "coldstart", None)
        if delta.cold_user_rows or delta.cold_item_rows:
            from incubator_predictionio_tpu_torch.streaming.coldstart import (
                ColdStartBuckets,
            )

            cs = (cs.copy() if cs is not None
                  else ColdStartBuckets.build(self.mf.config.rank))
            for rows, table in ((delta.cold_user_rows, cs.user_rows),
                                (delta.cold_item_rows, cs.item_rows)):
                for b, row in rows.items():
                    b = int(b)
                    if not (0 <= b < table.shape[0]):
                        raise ValueError(
                            f"cold-start bucket {b} outside "
                            f"[0, {table.shape[0]}) — set "
                            "PIO_COLDSTART_BUCKETS identically on the "
                            "updater and every replica")
                    table[b] = np.asarray(row, np.float32)
        new = RecModel(mf, self.user_map, self.item_map)
        new.coldstart = cs
        return new

    def coldstart_buckets(self):
        """The hash-bucket cold-start rows when ``PIO_COLDSTART_MODE=hash``,
        else None. Deterministic build; delta deploys overwrite them with
        trained values."""
        from incubator_predictionio_tpu_torch.streaming.coldstart import (
            ColdStartBuckets,
            coldstart_mode,
        )

        if coldstart_mode() != "hash":
            return None
        cs = getattr(self, "coldstart", None)
        if cs is None:
            cs = self.coldstart = ColdStartBuckets.build(self.mf.config.rank)
        return cs

    def _cold_item_table(self):
        """Cached host (item_emb, item_bias) for cold-start scoring."""
        cached = getattr(self, "_cold_items_cache", None)
        if cached is None:
            cached = self.mf._host_item_table()
            self._cold_items_cache = cached
        return cached

    def __getstate__(self):
        # the cold-item-table cache is derived state; never serialize it
        return {k: v for k, v in self.__dict__.items()
                if k != "_cold_items_cache"}


class ALSAlgorithm(PAlgorithm):
    """MLlib ALS slot (ALSAlgorithm.scala:50-93) filled by two-tower MF."""

    params_class = ALSAlgorithmParams
    serving_thread_safe = True  # read-only served tensors; per-thread scratch
    query_cls = Query

    def train(self, ctx: DeviceContext, pd: TrainingData) -> RecModel:
        p = self.params
        if p.num_iterations > 30:
            # parity with the reference guardrail (ALSAlgorithm.scala:44-48)
            logger.warning(
                "ALSAlgorithmParams.num_iterations = %d > 30: long schedules "
                "rarely help MF; consider lowering", p.num_iterations,
            )
        user_map = BiMap({u: i for i, u in enumerate(pd.user_vocab)})
        item_map = BiMap({t: i for i, t in enumerate(pd.item_vocab)})
        cfg = TwoTowerConfig(
            rank=p.rank,
            learning_rate=p.learning_rate,
            reg=p.lambda_,
            epochs=p.num_iterations,
            batch_size=p.batch_size,
            seed=p.seed if p.seed is not None else 0,
            checkpoint_dir=p.checkpoint_dir,
            checkpoint_every=p.checkpoint_every,
            gather=p.gather,
        )
        mf = TwoTowerMF(cfg).fit(
            ctx,
            pd.user_idx,
            pd.item_idx,
            pd.ratings,
            n_users=len(user_map),
            n_items=len(item_map),
            rows_are_local=pd.rows_are_local,
        )
        # two-stage retrieval: cluster the catalog here when it qualifies,
        # so the index persists with the model and deploys reuse it
        mf._prepare_index()
        return RecModel(mf, user_map, item_map)

    @staticmethod
    def _banned(model: RecModel, query: Query) -> set[int]:
        """Known-catalog indices of the query's blackList; unknown ids are
        ignored like the reference's flatten."""
        return {
            idx for b in (query.black_list or ())
            if (idx := model.item_map.get(b)) is not None
        }

    @staticmethod
    def _coldstart_predict(model: RecModel, query: Query,
                           banned: set[int]) -> PredictedResult:
        """Unknown-user answer from the hash-bucket cold-start row
        (``PIO_COLDSTART_MODE=hash``): score the catalog with the user's
        bucket embedding in host numpy. Known users never take this path."""
        cs = model.coldstart_buckets()
        if cs is None:
            # reference behavior: unknown user → empty itemScores
            return PredictedResult()
        row = cs.user_rows[cs.user_bucket(query.user)]
        k = model.mf.config.rank
        item_emb, item_bias = model._cold_item_table()
        scores = item_emb @ row[:k] + item_bias + row[k] + model.mf.mean
        if banned:
            scores = scores.copy()
            scores[np.fromiter(banned, np.int64)] = -np.inf
        num = min(query.num, len(scores))
        if num <= 0:
            return PredictedResult()
        part = np.argpartition(-scores, num - 1)[:num]
        order = part[np.argsort(-scores[part])]
        inv = model.item_map.inverse()
        return PredictedResult(tuple(
            ItemScore(inv[int(i)], float(scores[i]))
            for i in order if np.isfinite(scores[i])
        ))

    def predict(self, model: RecModel, query: Query) -> PredictedResult:
        uidx = model.user_map.get(query.user)
        if uidx is None:
            # unknown user → cold-start bucket row when enabled, else the
            # reference's empty result
            return self._coldstart_predict(
                model, query, self._banned(model, query))
        banned = self._banned(model, query)
        idx, scores = TwoTowerMF.recommend(
            model.mf, uidx, query.num,
            exclude=np.fromiter(banned, np.int64) if banned else None)
        inv = model.item_map.inverse()
        return PredictedResult(tuple(
            ItemScore(inv[int(i)], float(s))
            for i, s in zip(idx, scores) if int(i) not in banned
        ))

    def batch_predict(
        self, model: RecModel, queries: Sequence[tuple[int, Query]]
    ) -> list[tuple[int, PredictedResult]]:
        if not queries:
            return []
        known = [(qi, q) for qi, q in queries if q.user in model.user_map]
        # unknown users: cold-start bucket scoring when enabled, else the
        # reference's empty result
        out: list[tuple[int, PredictedResult]] = [
            (qi, self._coldstart_predict(model, q, self._banned(model, q)))
            for qi, q in queries if q.user not in model.user_map
        ]
        if known:
            banned = [self._banned(model, q) for _, q in known]
            uidx = np.asarray([model.user_map[q.user] for _, q in known], np.int32)
            inv = model.item_map.inverse()
            n_items = model.mf.n_items
            # gate on the BUCKET the dispatch will pad to — the same
            # criterion warmup uses
            if any(banned) and serve_bucket(len(known)) * n_items <= ROW_MASK_MAX_ELEMENTS:
                # per-query blacklists ride as a [B, n] row mask into the
                # single scoring dispatch (kernel K1 on the quantized path)
                num = max(q.num for _, q in known)
                row_mask = np.zeros((len(known), n_items), np.float32)
                for r, b in enumerate(banned):
                    if b:
                        row_mask[r, np.fromiter(b, np.int64)] = -np.inf
                idx, scores = TwoTowerMF.recommend_batch(
                    model.mf, uidx, num, row_mask=row_mask)
                for (qi, q), row_idx, row_scores in zip(known, idx, scores):
                    out.append((qi, PredictedResult(tuple(
                        ItemScore(inv[int(i)], float(s))
                        for i, s in zip(row_idx, row_scores) if np.isfinite(s)
                    )[: q.num])))
            else:
                # huge catalogs (or no blacklists at all): over-fetch a few
                # extra columns and drop banned rows host-side
                num = max(q.num + len(b) for (_, q), b in zip(known, banned))
                idx, scores = TwoTowerMF.recommend_batch(model.mf, uidx, num)
                for (qi, q), b, row_idx, row_scores in zip(
                        known, banned, idx, scores):
                    out.append((qi, PredictedResult(tuple(
                        ItemScore(inv[int(i)], float(s))
                        for i, s in zip(row_idx, row_scores)
                        if int(i) not in b and np.isfinite(s)
                    )[: q.num])))
        return out


# -- metrics (reference Evaluation.scala:62-106) ----------------------------

class PrecisionAtK(OptionAverageMetric):
    """Fraction of top-k recommendations that are relevant (rating ≥ threshold).
    None (skipped) when the user has no relevant held-out items."""

    def __init__(self, k: int = 10, rating_threshold: float = 2.0):
        self.k = k
        self.rating_threshold = rating_threshold

    @property
    def header(self) -> str:
        return f"Precision@K (k={self.k}, threshold={self.rating_threshold})"

    def calculate_qpa(self, q: Query, p: PredictedResult, a: ActualResult):
        positives = {r.item for r in a.ratings if r.rating >= self.rating_threshold}
        if not positives:
            # precision undefined without positives (Evaluation.scala:43-46)
            return None
        tp = sum(1 for s in p.item_scores[: self.k] if s.item in positives)
        return tp / min(self.k, len(positives))  # Evaluation.scala:49


class PositiveCount(OptionAverageMetric):
    """Average number of relevant held-out items per query (diagnostic,
    reference Evaluation.scala:53-60)."""

    def __init__(self, rating_threshold: float = 2.0):
        self.rating_threshold = rating_threshold

    @property
    def header(self) -> str:
        return f"PositiveCount (threshold={self.rating_threshold})"

    def calculate_qpa(self, q, p, a: ActualResult):
        return float(sum(1 for r in a.ratings if r.rating >= self.rating_threshold))


# -- engine / evaluation ----------------------------------------------------

class RecommendationEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            DataSource,
            IdentityPreparator,
            {"als": ALSAlgorithm, "": ALSAlgorithm},
            FirstServing,
        )


class RecommendationEvaluation(Evaluation, EngineParamsGenerator):
    """Precision@K evaluation with a small rank/iterations grid
    (reference Evaluation.scala + EngineParamsList)."""

    def __init__(self, app_name: str = "recommendation", eval_k: int = 3):
        self.engine = RecommendationEngine().apply()
        self.evaluator = MetricEvaluator(
            metric=PrecisionAtK(k=10, rating_threshold=2.0),
            other_metrics=[PositiveCount(rating_threshold=2.0)],
        )
        self.engine_params_list = [
            EngineParams.create(
                data_source=DataSourceParams(app_name=app_name, eval_k=eval_k),
                algorithms=[("als", ALSAlgorithmParams(rank=rank, num_iterations=it))],
            )
            for rank in (16, 32)
            for it in (10, 20)
        ]
