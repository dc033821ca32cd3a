"""RecommendedUser template — training and serving.

Counterpart of ``incubator_predictionio_tpu/templates/recommended_user.py``
(examples/scala-parallel-similarproduct/recommended-user/): recommend USERS
to follow, from user→user "follow" events.

- DataSource reads user ``$set`` events plus "follow" user→user events
  (DataSource.scala:55-85);
- ALSAlgorithm runs implicit MF over (follower, followedUser) pairs on the
  card and keeps the followed-side factor matrix (ALSAlgorithm.scala:104-124
  ``ALS.trainImplicit`` → ``m.productFeatures``);
- Query {"users": […], "num": N, "whiteList"?, "blackList"?} → top-N
  similar users by the SUM of cosine similarities against every query
  user's vector, excluding the query users themselves, keeping scores > 0
  (ALSAlgorithm.scala:127-185).

Scoring is the item-similarity path (``templates/_similarity.py``): one
bf16 ``[q, k] × [k, n]`` product over the L2-normalized followed-user
table on the serving device, plus an additive -inf filter mask. Under
several processes each reads its follower shard of the follow events and
the fit is data-parallel (``data/sharded.py``, ``models/two_tower.py``).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional, Sequence

import numpy as np

from incubator_predictionio_tpu_torch.core import (
    Engine,
    EngineFactory,
    FirstServing,
    IdentityPreparator,
    PAlgorithm,
    Params,
    PDataSource,
    SanityCheck,
)
from incubator_predictionio_tpu_torch.data.bimap import BiMap
from incubator_predictionio_tpu_torch.data.sharded import (
    global_row_count,
    union_label_set,
)
from incubator_predictionio_tpu_torch.data.store import PEventStore
from incubator_predictionio_tpu_torch.models.negative_sampling import (
    sample_negatives,
)
from incubator_predictionio_tpu_torch.models.two_tower import (
    TwoTowerConfig,
    TwoTowerMF,
)
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext
from incubator_predictionio_tpu_torch.serving import (
    ban_rows,
    grouped_topk,
    whitelist_vec,
)
from incubator_predictionio_tpu_torch.templates._similarity import (
    device_catalog,
    l2_normalize,
    sim_scores,
    sim_scores_stacked,
)
from incubator_predictionio_tpu_torch.templates._similarity import warmup as sim_warmup

logger = logging.getLogger(__name__)


# -- query / result ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Query:
    users: tuple[str, ...]
    num: int = 10
    white_list: Optional[tuple[str, ...]] = None
    black_list: Optional[tuple[str, ...]] = None


@dataclasses.dataclass(frozen=True)
class SimilarUserScore:
    user: str
    score: float


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    similar_user_scores: tuple[SimilarUserScore, ...] = ()


# -- data source ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = "recommendeduser"


@dataclasses.dataclass
class TrainingData(SanityCheck):
    users: BiMap                 # user id ↔ index (followers and followed share it)
    follow_u: np.ndarray         # [n_follows] follower idx
    follow_t: np.ndarray         # [n_follows] followed idx
    # multi-process sharded read: follow rows are THIS process's follower
    # shard only (the BiMap is global); n_follows_global is the job-wide count
    rows_are_local: bool = False
    n_follows_global: Optional[int] = None

    def sanity_check(self) -> None:
        if len(self.users) == 0:
            raise ValueError("no users found ($set events on entityType 'user')")
        n = (self.n_follows_global if self.n_follows_global is not None
             else len(self.follow_u))
        if n == 0:
            raise ValueError("no follow events found")


class DataSource(PDataSource):
    """DataSource.scala:40-86 — users + follow events."""

    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        super().__init__(params)
        self._store = PEventStore()

    def read_training(self, ctx: DeviceContext) -> TrainingData:
        """recommended_user.py:109-150. Under several processes each reads
        its follower shard of the follow events (``find_sharded``); the
        vocabulary is the ``$set`` users ∪ the union of the shards' event
        users (followed ids can live outside this follower shard)."""
        t0 = time.perf_counter()
        app = self.params.app_name
        procs, pid = ctx.process_count, ctx.process_index
        sharded = procs > 1
        user_props = self._store.aggregate_properties(app, "user")
        if sharded:
            events = self._store.find_sharded(
                app, procs, entity_type="user", event_names=("follow",))[pid]
        else:
            events = self._store.find(
                app, entity_type="user", event_names=("follow",),
                target_entity_type="user")
        follows: list[tuple[str, str]] = []
        local_users: set[str] = set()
        for e in events:
            if e.target_entity_type != "user" or e.target_entity_id is None:
                continue
            local_users.add(e.entity_id)
            local_users.add(e.target_entity_id)
            follows.append((e.entity_id, e.target_entity_id))
        user_ids = set(user_props.keys())
        n_follows_global = None
        if sharded:
            user_ids |= set(union_label_set(ctx, local_users))
            n_follows_global = global_row_count(ctx, len(follows))
            logger.info("sharded read: %d of %d rows (shard %d/%d) in %.3f s",
                        len(follows), n_follows_global, pid, procs,
                        time.perf_counter() - t0)
        else:
            user_ids |= local_users
        users = BiMap.string_int(sorted(user_ids))
        return TrainingData(
            users=users,
            follow_u=users.lookup_array([u for u, _ in follows]),
            follow_t=users.lookup_array([t for _, t in follows]),
            rows_are_local=sharded,
            n_follows_global=n_follows_global,
        )


# -- model + algorithm ------------------------------------------------------

@dataclasses.dataclass
class SimilarUserModel:
    """L2-normalized followed-user vectors (the reference keeps
    ``productFeatures`` — ALSAlgorithm.scala:119-124)."""

    user_vecs: np.ndarray        # [n_users, k] L2-normalized
    user_map: BiMap

    _device_vt = None

    def prepare_for_serving(self, ctx: Optional[DeviceContext] = None
                            ) -> "SimilarUserModel":
        """The ``[k, n]`` followed-user matrix onto ``ctx.device`` (the card
        unless the caller passes another context); derived state, never
        pickled."""
        ctx = ctx or DeviceContext.create()
        self._device_vt = device_catalog(self.user_vecs, ctx.device)
        return self

    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items() if k != "_device_vt"}

    def warmup(self, max_batch: int = 64) -> int:
        """One product at every serving bucket (called at deploy)."""
        if self._device_vt is None:
            self.prepare_for_serving()
        return sim_warmup(self._device_vt)

    def serving_info(self) -> dict:
        dev = self._device_vt.device if self._device_vt is not None else None
        return {"path": "device-bf16", "catalog_rows": len(self.user_map),
                "device": str(dev)}


@dataclasses.dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    rank: int = 16
    num_iterations: int = 20
    learning_rate: float = 3e-2
    negatives_per_positive: int = 4
    seed: Optional[int] = None


class ALSAlgorithm(PAlgorithm):
    """Implicit MF over follow pairs; cosine-sum scoring
    (ALSAlgorithm.scala:104-185)."""

    params_class = ALSAlgorithmParams
    serving_thread_safe = True  # read-only served tensors and arrays
    query_cls = Query

    def train(self, ctx: DeviceContext, pd: TrainingData) -> SimilarUserModel:
        p = self.params
        rng = np.random.default_rng(p.seed if p.seed is not None else 0)
        pos_u, pos_t = pd.follow_u, pd.follow_t
        neg_u, neg_t = sample_negatives(
            pos_u, pos_t, len(pd.users), p.negatives_per_positive, rng)
        mf = TwoTowerMF(TwoTowerConfig(
            rank=p.rank, epochs=p.num_iterations, learning_rate=p.learning_rate,
            batch_size=8192, seed=p.seed if p.seed is not None else 0,
        )).fit(
            ctx,
            np.concatenate([pos_u, neg_u]),
            np.concatenate([pos_t, neg_t]),
            np.concatenate([np.ones(len(pos_u), np.float32),
                            np.zeros(len(neg_u), np.float32)]),
            len(pd.users), len(pd.users),
            rows_are_local=pd.rows_are_local,
        )
        # followed-side tower = the reference's productFeatures
        # (cosine model is a host build: materialize if device-resident)
        mf.ensure_host()
        return SimilarUserModel(
            user_vecs=l2_normalize(mf.item_emb),
            user_map=pd.users,
        )

    def predict(self, model: SimilarUserModel, query: Query) -> PredictedResult:
        known = [model.user_map[u] for u in query.users if u in model.user_map]
        if not known:
            logger.info("no feature vectors for query users %s", query.users)
            return PredictedResult()
        if model._device_vt is None:
            model.prepare_for_serving()
        mask = self._filter_mask(model, query)
        qvecs = model.user_vecs[np.asarray(known)]
        scores = sim_scores(qvecs, model._device_vt, mask)
        num = min(query.num, len(scores))
        if num <= 0:  # degenerate query, not a catalog dump
            return PredictedResult()
        top = np.argpartition(-scores, num - 1)[:num]
        top = top[np.argsort(-scores[top])]
        inv = model.user_map.inverse()
        # score > 0 cut is reference behavior for THIS variant: "keep
        # similarUsers with score > 0" (ALSAlgorithm.scala:160)
        return PredictedResult(tuple(
            SimilarUserScore(inv[int(i)], float(scores[i]))
            for i in top if np.isfinite(scores[i]) and scores[i] > 0
        ))

    @staticmethod
    def _filter_mask(model: SimilarUserModel, query: Query) -> np.ndarray:
        """-inf mask: whitelist/blacklist + query-user self-exclusion
        (isCandidateSimilarUser, ALSAlgorithm.scala:200-230) — vectorized
        ``lookup_array`` scatters (serving/masks.py)."""
        n = len(model.user_map)
        mask = np.zeros(n, np.float32)
        if query.white_list is not None:
            mask += whitelist_vec(model.user_map, query.white_list)
        ban_rows(mask, model.user_map, query.black_list)
        # never recommend the query users themselves
        ban_rows(mask, model.user_map, query.users)
        return mask

    def batch_predict(self, model, queries):
        """Batched serving: one stacked scoring product for the whole
        coalesced batch (equal per row to the serial path where the device
        sums every M alike — see ``sim_scores_stacked``), vectorized [B, n]
        masks, axis-wise top-k
        per ``num`` group, and the serial score>0 cut per row."""
        queries = list(queries)
        if not queries:
            return []
        if model._device_vt is None:
            model.prepare_for_serving()
        qs = [q for _, q in queries]
        known = [
            np.asarray([model.user_map[u] for u in q.users
                        if u in model.user_map], np.int64)
            for q in qs
        ]
        results: list[PredictedResult] = [PredictedResult()] * len(qs)
        live = [b for b, k in enumerate(known) if len(k)]
        if live:
            masks = np.stack([self._filter_mask(model, qs[b]) for b in live])
            counts = [len(known[b]) for b in live]
            qvecs = model.user_vecs[np.concatenate([known[b] for b in live])]
            scored = sim_scores_stacked(qvecs, counts, model._device_vt, masks)
            inv = model.user_map.inverse()
            n = scored.shape[1]
            for r, (idx_row, score_row) in enumerate(grouped_topk(
                    scored, [min(qs[b].num, n) for b in live])):
                keep = np.isfinite(score_row) & (score_row > 0)
                results[live[r]] = PredictedResult(tuple(
                    SimilarUserScore(inv[int(i)], float(v))
                    for i, v, k in zip(idx_row, score_row, keep) if k
                ))
        return [(qi, results[b]) for b, (qi, _) in enumerate(queries)]


class RecommendedUserEngine(EngineFactory):
    """Engine.scala:41-48."""

    def apply(self) -> Engine:
        return Engine(
            DataSource,
            IdentityPreparator,
            {"als": ALSAlgorithm, "": ALSAlgorithm},
            {"": FirstServing},
        )
