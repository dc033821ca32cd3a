"""E-commerce recommendation template — training and serving.

Counterpart of ``incubator_predictionio_tpu/templates/ecommerce.py``
(examples/scala-parallel-ecommercerecommendation/.../ECommAlgorithm.scala:79-597):

- trains implicit MF on view (+ optional buy) events — two-tower MF on the
  card with sampled negatives — and keeps per-item popularity counts
  (``trainDefault`` :211);
- query-time business rules: category filter, whitelist/blacklist,
  **unavailable items** read live from the event store ("constraint"
  ``$set`` events, latest wins :150-180; through a TTL single-flight cache,
  ``serving/cache.py``), and unseen-only filtering of the user's view/buy
  history (:429-470);
- prediction fallbacks: predictKnownUser (:429) → predictSimilar from the
  user's recent views (:505) → predictDefault popularity (:475).

The live reads ride the port's :class:`LEventStore`. Scoring is host
numpy, as in the reference: the serial and the batched paths run the same
BLAS call chain per query, so their scores are bitwise equal. Under
several processes each reads its user shard of the events, the buy counts
are summed over the processes (popularity is global) and the fit is
data-parallel (``data/sharded.py``, ``models/two_tower.py``).
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
    global_sum,
    union_label_set,
)
from incubator_predictionio_tpu_torch.data.store import LEventStore, PEventStore
from incubator_predictionio_tpu_torch.models.negative_sampling import (
    sample_negatives,
)
from incubator_predictionio_tpu_torch.models.two_tower import (
    ROW_MASK_MAX_ELEMENTS,
    TwoTowerConfig,
    TwoTowerMF,
    TwoTowerModel,
)
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext
from incubator_predictionio_tpu_torch.serving import (
    HasCategoryIndex,
    TTLCache,
    ban_rows,
    constraint_ttl_sec,
    grouped_topk,
    whitelist_vec,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Query:
    user: str
    num: int = 10
    categories: Optional[tuple[str, ...]] = None
    white_list: Optional[tuple[str, ...]] = None
    black_list: Optional[tuple[str, ...]] = None


@dataclasses.dataclass(frozen=True)
class ItemScore:
    item: str
    score: float


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    item_scores: tuple[ItemScore, ...] = ()


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = "ecommerce"
    # train-with-rate-event variant: which events count as view/buy signal,
    # and the implicit buy weight (examples/scala-parallel-
    # ecommercerecommendation/train-with-rate-event)
    view_event_names: tuple[str, ...] = ("view",)
    buy_event_names: tuple[str, ...] = ("buy",)
    buy_weight: float = 2.0


@dataclasses.dataclass
class TrainingData(SanityCheck):
    users: BiMap
    items: BiMap
    categories: dict[str, tuple[str, ...]]
    u_idx: np.ndarray       # [n] interaction user idx (views + buys)
    i_idx: np.ndarray       # [n] interaction item idx
    weight: np.ndarray      # [n] 1.0 view / buy_weight buy
    buy_counts: np.ndarray  # [n_items] popularity (always global)
    # multi-process sharded read: interaction rows are THIS process's user
    # shard only (BiMaps/indices/buy_counts are global)
    rows_are_local: bool = False
    n_rows_global: Optional[int] = None

    def sanity_check(self) -> None:
        if len(self.items) == 0:
            raise ValueError("no items found ($set events on entityType 'item')")
        total = (self.n_rows_global if self.n_rows_global is not None
                 else len(self.u_idx))
        if total == 0:
            raise ValueError("no view/buy events found")


class DataSource(PDataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        super().__init__(params)
        self._store = PEventStore()

    def read_training(self, ctx: DeviceContext) -> TrainingData:
        """ecommerce.py:118-175. Under several processes each reads its user
        shard of the events (``find_sharded``); the user vocabulary is the
        sorted union of the shards' users, and the buy counts are summed
        over the processes in process order (popularity is global)."""
        t0 = time.perf_counter()
        app = self.params.app_name
        procs, pid = ctx.process_count, ctx.process_index
        sharded = procs > 1
        item_props = self._store.aggregate_properties(app, "item")
        items = BiMap.string_int(item_props.keys())
        categories = {
            iid: tuple(pm.get("categories") or ()) for iid, pm in item_props.items()
        }
        inter_u, inter_i, weight = [], [], []
        buy_counts = np.zeros(len(items), np.int64)
        user_ids = set()
        view_names = tuple(self.params.view_event_names)
        buy_names = tuple(self.params.buy_event_names)
        wanted = (*view_names, *buy_names)
        if sharded:
            events = self._store.find_sharded(
                app, procs, entity_type="user", event_names=wanted)[pid]
        else:
            events = self._store.find(
                app, entity_type="user", event_names=wanted,
                target_entity_type="item",
            )
        for e in events:
            if e.target_entity_type != "item" or e.target_entity_id not in items:
                continue
            user_ids.add(e.entity_id)
            inter_u.append(e.entity_id)
            inter_i.append(e.target_entity_id)
            is_view = e.event in view_names
            weight.append(1.0 if is_view else self.params.buy_weight)
            if not is_view:
                buy_counts[items[e.target_entity_id]] += 1
        n_rows_global = None
        if sharded:
            user_ids = set(union_label_set(ctx, user_ids))
            buy_counts = global_sum(ctx, buy_counts)  # popularity is global
            n_rows_global = global_row_count(ctx, len(inter_u))
            logger.info(
                "sharded read: %d of %d rows (shard %d/%d) in %.3f s",
                len(inter_u), n_rows_global, pid, procs,
                time.perf_counter() - t0)
        users = BiMap.string_int(sorted(user_ids))  # sorted: set order is hash-seed dependent
        return TrainingData(
            users=users,
            items=items,
            categories=categories,
            u_idx=users.lookup_array(inter_u),
            i_idx=items.lookup_array(inter_i),
            weight=np.asarray(weight, np.float32),
            buy_counts=buy_counts,
            rows_are_local=sharded,
            n_rows_global=n_rows_global,
        )


@dataclasses.dataclass(frozen=True)
class ECommAlgorithmParams(Params):
    """(ECommAlgorithm.scala ECommAlgorithmParams: appName, unseenOnly,
    seenEvents, similarEvents, rank, numIterations, lambda, seed)"""

    app_name: str = "ecommerce"
    unseen_only: bool = True
    seen_events: tuple[str, ...] = ("buy", "view")
    similar_events: tuple[str, ...] = ("view",)
    rank: int = 16
    num_iterations: int = 20
    learning_rate: float = 3e-2
    negatives_per_positive: int = 4
    seed: Optional[int] = None


@dataclasses.dataclass
class ECommModel(HasCategoryIndex):
    mf: TwoTowerModel
    user_map: BiMap
    item_map: BiMap
    categories: dict[str, tuple[str, ...]]
    popularity: np.ndarray  # [n_items] buy counts
    item_vecs_norm: np.ndarray  # L2-normalized item factors for predictSimilar

    def prepare_for_serving(self, ctx: Optional[DeviceContext] = None
                            ) -> "ECommModel":
        # build_index=False: this template scores through its own
        # mask-compiled host path, never TwoTowerMF.recommend_batch — a
        # two-stage retrieval index would be dead weight at deploy
        ctx = ctx or DeviceContext.create()
        self.mf.prepare_for_serving(build_index=False, device=ctx.device)
        self.category_index()
        return self

    def serving_info(self) -> dict:
        return self.mf.serving_info()


class ECommAlgorithm(PAlgorithm):
    params_class = ECommAlgorithmParams
    serving_thread_safe = True  # read-only served arrays
    query_cls = Query

    def __init__(self, params: ECommAlgorithmParams):
        super().__init__(params)
        self._levents = LEventStore()
        # TTL + single-flight cache over the per-query constraint read
        # (``PIO_SERVING_CONSTRAINT_TTL_MS=0`` restores the reference's
        # read-per-query semantics; tests swap in a FakeClock-backed cache)
        self._constraint_cache = TTLCache(constraint_ttl_sec())

    def train(self, ctx: DeviceContext, pd: TrainingData) -> ECommModel:
        p = self.params
        rng = np.random.default_rng(p.seed if p.seed is not None else 0)
        k = p.negatives_per_positive
        neg_u, neg_i = sample_negatives(pd.u_idx, pd.i_idx, len(pd.items), k, rng)
        users = np.concatenate([pd.u_idx, neg_u])
        items = np.concatenate([pd.i_idx, neg_i])
        ratings = np.concatenate([pd.weight, np.zeros(len(neg_u), np.float32)])
        mf = TwoTowerMF(TwoTowerConfig(
            rank=p.rank, epochs=p.num_iterations, learning_rate=p.learning_rate,
            batch_size=8192, seed=p.seed if p.seed is not None else 0,
        )).fit(ctx, users, items, ratings, len(pd.users), len(pd.items),
               rows_are_local=pd.rows_are_local)
        mf.ensure_host()  # similarity sidecar + host predict path need numpy
        norm = mf.item_emb / (np.linalg.norm(mf.item_emb, axis=1, keepdims=True) + 1e-9)
        return ECommModel(
            mf=mf,
            user_map=pd.users,
            item_map=pd.items,
            categories=pd.categories,
            popularity=pd.buy_counts.astype(np.float32),
            item_vecs_norm=norm,
        )

    # -- live event-store reads (serving time) ----------------------------
    def _unavailable_items(self) -> set[str]:
        """Latest "constraint/unavailableItems" ``$set`` wins
        (ECommAlgorithm.scala:150-180) — read through the TTL single-flight
        cache, so a query storm costs one storage read per TTL window."""
        return self._constraint_cache.get(
            "unavailableItems", self._read_unavailable_items)

    def _read_unavailable_items(self) -> set[str]:
        try:
            events = list(self._levents.find_by_entity(
                self.params.app_name, "constraint", "unavailableItems",
                event_names=("$set",), limit=1, latest=True,
            ))
        except ValueError:
            return set()
        if not events:
            return set()
        return set(events[0].properties.get("items") or ())

    def _seen_items(self, user: str) -> set[str]:
        """User's view/buy history (ECommAlgorithm.scala:429-470)."""
        try:
            return {
                e.target_entity_id
                for e in self._levents.find_by_entity(
                    self.params.app_name, "user", user,
                    event_names=tuple(self.params.seen_events),
                    target_entity_type="item",
                )
                if e.target_entity_id
            }
        except ValueError:
            return set()

    def _recent_similar_items(self, user: str, limit: int = 10) -> list[str]:
        """User's recent view targets for predictSimilar (:505-530)."""
        try:
            return [
                e.target_entity_id
                for e in self._levents.find_by_entity(
                    self.params.app_name, "user", user,
                    event_names=tuple(self.params.similar_events),
                    target_entity_type="item", limit=limit, latest=True,
                )
                if e.target_entity_id
            ]
        except ValueError:
            return []

    def _recent_similar_items_batch(
        self, users: Sequence[str], limit: int = 10,
    ) -> dict[str, list[str]]:
        """Batched :meth:`_recent_similar_items` for a batch's unknown users."""
        try:
            by_user = self._levents.find_by_entities(
                self.params.app_name, "user", users,
                event_names=tuple(self.params.similar_events),
                target_entity_type="item", limit_per_entity=limit,
                latest=True,
            )
        except ValueError:
            return {}
        return {
            u: [e.target_entity_id for e in evs if e.target_entity_id]
            for u, evs in by_user.items()
        }

    def _histories_batch(
        self, users: Sequence[str], unknown: Sequence[str], limit: int = 10,
    ) -> tuple[dict[str, set[str]], dict[str, list[str]]]:
        """ONE union read serving both per-user derivations: seen-items
        (every user) and the unknown users' recent views. The event-name
        union covers both reads' filters, and filtering a latest-first
        stream by event name preserves each name-subset's order, so the
        derived results equal the dedicated :meth:`_seen_items` /
        :meth:`_recent_similar_items` reads exactly — one storage round
        trip instead of two per batch."""
        seen_names = tuple(self.params.seen_events)
        similar_names = tuple(self.params.similar_events)
        try:
            by_user = self._levents.find_by_entities(
                self.params.app_name, "user", users,
                event_names=tuple(dict.fromkeys((*seen_names, *similar_names))),
                target_entity_type="item", latest=True,
            )
        except ValueError:
            return {}, {}
        seen = {
            u: {e.target_entity_id for e in evs
                if e.event in seen_names and e.target_entity_id}
            for u, evs in by_user.items()
        }
        recent: dict[str, list[str]] = {}
        for u in unknown:
            matching = [e for e in by_user.get(u, ())
                        if e.event in similar_names][:limit]
            recent[u] = [e.target_entity_id for e in matching
                         if e.target_entity_id]
        return seen, recent

    # -- masking ----------------------------------------------------------
    @staticmethod
    def _rule_mask(model: ECommModel, query: Query) -> np.ndarray:
        """[n] additive -inf mask for the query-carried filters (whitelist,
        blacklist, categories) — vectorized index scatters over the compiled
        :class:`CategoryIndex` (serving/masks.py) instead of the seed's
        per-item Python loops. ONE implementation shared verbatim by the
        serial path and the batched per-batch memo, so a new filter added
        here reaches both (the parity contract's single source of truth);
        the read-dependent filters (unavailable, seen) compose on top."""
        n = len(model.item_map)
        mask = np.zeros(n, np.float32)
        if query.white_list is not None:
            mask += whitelist_vec(model.item_map, query.white_list)
        ban_rows(mask, model.item_map, query.black_list)
        if query.categories is not None:
            mask += model.category_index().allow_vec(query.categories)
        return mask

    def _mask(self, model: ECommModel, query: Query) -> np.ndarray:
        """The serial path's full mask: query rules + live store reads."""
        mask = self._rule_mask(model, query)
        ban_rows(mask, model.item_map, tuple(self._unavailable_items()))
        if self.params.unseen_only:
            ban_rows(mask, model.item_map, tuple(self._seen_items(query.user)))
        return mask

    # -- prediction -------------------------------------------------------
    def predict(self, model: ECommModel, query: Query) -> PredictedResult:
        mask = self._mask(model, query)
        uidx = model.user_map.get(query.user)
        if uidx is not None:
            scores = (
                model.mf.user_emb[uidx] @ model.mf.item_emb.T
                + model.mf.item_bias + model.mf.user_bias[uidx] + model.mf.mean
            )
        else:
            recent = [model.item_map[i] for i in self._recent_similar_items(query.user)
                      if i in model.item_map]
            if recent:
                logger.info("unknown user %s: predictSimilar from %d recent views",
                            query.user, len(recent))
                qv = model.item_vecs_norm[np.asarray(recent)]
                scores = (qv @ model.item_vecs_norm.T).sum(axis=0)
            else:
                logger.info("unknown user %s: predictDefault popularity", query.user)
                scores = model.popularity.copy()
        scores = scores + mask
        num = min(query.num, len(scores))
        if num <= 0:  # degenerate query, not a catalog dump
            return PredictedResult()
        top = np.argpartition(-scores, num - 1)[:num]
        top = top[np.argsort(-scores[top])]
        inv = model.item_map.inverse()
        return PredictedResult(tuple(
            ItemScore(inv[int(i)], float(scores[i]))
            for i in top if np.isfinite(scores[i])
        ))

    def batch_predict(self, model, queries):
        """Vectorized batch serving: a coalesced micro-batch costs O(1) live
        store reads and one vectorized pass per stage instead of the serial
        path's O(B) reads and O(B × catalog) Python.

        - **reads**: one TTL-cached constraint read + ONE batched
          ``find_by_entities`` for every user's seen history (+ one more for
          unknown users' recent views) — the serial path pays 2 reads/query;
        - **masks**: [B, N] assembled from compiled category rows and
          ``lookup_array`` scatters;
        - **scores**: each known user's row goes through the *same* BLAS
          call chain as the serial path (bitwise-identical scores — the
          parity tests' contract; a stacked GEMM's rows differ in final ulps
          from the per-query GEMV), then ONE axis-wise top-k per ``num``
          group replaces per-query selection. Unknown users take the (rare)
          similar/popularity fallback exactly like the serial path.
        """
        queries = list(queries)
        if not queries:
            return []
        qs = [q for _, q in queries]
        n = len(model.item_map)
        # -- O(1) live reads for the whole batch --------------------------
        unavailable = tuple(self._unavailable_items())
        seen_by_user: dict[str, set[str]] = {}
        unknown = list(dict.fromkeys(
            q.user for q in qs if model.user_map.get(q.user) is None))
        if self.params.unseen_only:
            # one union read covers seen-items AND unknown users' recent
            # views (query users include the unknown ones)
            users = list(dict.fromkeys(q.user for q in qs))
            seen_by_user, recent_by_user = self._histories_batch(
                users, unknown)
        else:
            recent_by_user = (
                self._recent_similar_items_batch(unknown) if unknown else {})
        if unknown:
            logger.info("batch of %d: %d unknown users take the "
                        "similar/popularity fallback", len(qs), len(unknown))
        # -- [chunk, N] mask + scores + axis-wise top-k -------------------
        # rule masks (whitelist/blacklist/categories) memoized per distinct
        # filter tuple — live traffic repeats a handful of filters per batch;
        # the shared unavailable-items vector is built once. Every component
        # is {0, -inf}, so composing by addition matches the serial path's
        # scatter order exactly. The dense scored buffer is capped at
        # ROW_MASK_MAX_ELEMENTS (the device path's bound) by chunking the
        # batch — a deep micro-batch over a huge catalog must not balloon
        # host memory to O(B × N); chunking changes no result.
        unavail_vec = np.zeros(n, np.float32)
        ban_rows(unavail_vec, model.item_map, unavailable)
        rule_cache: dict = {}
        inv = model.item_map.inverse()
        ue, ub = model.mf.user_emb, model.mf.user_bias
        ie_t, ib = model.mf.item_emb.T, model.mf.item_bias
        results: list[Optional[PredictedResult]] = [None] * len(qs)
        chunk = max(1, ROW_MASK_MAX_ELEMENTS // max(n, 1))
        for start in range(0, len(qs), chunk):
            rows = range(start, min(start + chunk, len(qs)))
            scored = np.empty((len(rows), n), np.float32)
            for r, b in enumerate(rows):
                q = qs[b]
                # wire-bound queries carry filter fields as LISTS
                # (bind_query does not coerce JSON arrays) — normalize to
                # tuples or the cache key is unhashable and every filtered
                # live batch crashes out of the vectorized path
                key = tuple(
                    tuple(f) if f is not None else None
                    for f in (q.white_list, q.black_list, q.categories))
                rules = rule_cache.get(key)
                if rules is None:
                    rules = rule_cache[key] = self._rule_mask(model, q)
                mask = rules + unavail_vec
                if self.params.unseen_only:
                    ban_rows(mask, model.item_map,
                             seen_by_user.get(q.user, ()))
                uidx = model.user_map.get(q.user)
                if uidx is not None:
                    scores = ue[uidx] @ ie_t + ib + ub[uidx] + model.mf.mean
                else:
                    recent = [model.item_map[i]
                              for i in recent_by_user.get(q.user, [])
                              if i in model.item_map]
                    if recent:
                        qv = model.item_vecs_norm[np.asarray(recent)]
                        scores = (qv @ model.item_vecs_norm.T).sum(axis=0)
                    else:
                        scores = model.popularity.copy()
                scored[r] = scores + mask
            for r, (idx_row, score_row) in enumerate(grouped_topk(
                    scored, [min(qs[b].num, n) for b in rows])):
                finite = np.isfinite(score_row)
                results[start + r] = PredictedResult(tuple(
                    ItemScore(inv[int(i)], float(v))
                    for i, v, f in zip(idx_row, score_row, finite) if f
                ))
        return [(qi, results[b]) for b, (qi, _) in enumerate(queries)]


class ECommerceEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            DataSource,
            IdentityPreparator,
            {"ecomm": ECommAlgorithm, "": ECommAlgorithm},
            FirstServing,
        )
