"""SimilarProduct template — training and serving.

Counterpart of ``incubator_predictionio_tpu/templates/similarproduct.py``
(examples/scala-parallel-similarproduct/multi-events-multi-algos/):

- ``DataSource.read_training`` reads users/items ``$set`` events (items
  carry ``categories``) plus "view" and "like"/"dislike" user→item events;
- three algorithms behind one engine: implicit MF on views
  (ALSAlgorithm.scala:61-135 ``ALS.trainImplicit``; here two-tower MF on
  the card with sampled negatives), item co-occurrence counts
  (CooccurrenceAlgorithm.scala:51-133) and signed MF on like/dislike
  (LikeAlgorithm.scala);
- Query {"items": […], "num": N, "categories"?, "categoryBlackList"?,
  "whiteList"?, "blackList"?} → items similar to the query items, filtered;
- Serving sums scores per item across algorithms (multi-algo serving).

On the card: the MF fit (``models/two_tower.py``), the cosine product of
serving (``templates/_similarity.py``: the L2-normalized catalog is put on
the serving device by ``ItemSimModel.prepare_for_serving`` and never
pickled) and the co-occurrence count ``Uᵀ U`` (:func:`_cooccur`: the
reference's RDD self-join, CooccurrenceAlgorithm.scala:87, as one product).
Masks, top-k and the co-occurrence lists are host numpy, as in the
reference. Under several processes each reads its user shard of the
events (the catalog replicated), the fits are data-parallel, and the
co-occurrence counts are summed over the processes (``data/sharded.py``).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional, Sequence

import numpy as np
import torch

from incubator_predictionio_tpu_torch.core import (
    Engine,
    EngineFactory,
    IdentityPreparator,
    LServing,
    PAlgorithm,
    Params,
    PDataSource,
    SanityCheck,
)
from incubator_predictionio_tpu_torch.data.bimap import BiMap
from incubator_predictionio_tpu_torch.data.sharded import (
    data_shard,
    global_row_count,
    global_sum,
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
    HasCategoryIndex,
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
    items: tuple[str, ...]
    num: int = 10
    categories: Optional[tuple[str, ...]] = None
    category_black_list: Optional[tuple[str, ...]] = None
    white_list: Optional[tuple[str, ...]] = None
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
    app_name: str = "similarproduct"
    # train-with-rate-event variant: treat other events (e.g. "rate") as view
    # signal (examples/scala-parallel-similarproduct/train-with-rate-event)
    view_event_names: tuple[str, ...] = ("view",)


@dataclasses.dataclass
class TrainingData(SanityCheck):
    users: BiMap                       # user id ↔ index
    items: BiMap                       # item id ↔ index
    categories: dict[str, tuple[str, ...]]   # item id → categories
    view_u: np.ndarray                 # [n_views] user idx
    view_i: np.ndarray                 # [n_views] item idx
    like_u: np.ndarray                 # [n_likes] user idx
    like_i: np.ndarray                 # [n_likes] item idx
    like_sign: np.ndarray              # [n_likes] +1 like / -1 dislike
    # multi-process sharded read: event rows are THIS process's user shard
    # only (BiMaps and indices are global); *_global are job-wide counts
    rows_are_local: bool = False
    n_views_global: Optional[int] = None
    n_likes_global: Optional[int] = None

    def sanity_check(self) -> None:
        if len(self.items) == 0:
            raise ValueError("no items found ($set events on entityType 'item')")
        n_views = (self.n_views_global if self.n_views_global is not None
                   else len(self.view_u))
        n_likes = (self.n_likes_global if self.n_likes_global is not None
                   else len(self.like_u))
        if n_views == 0 and n_likes == 0:
            raise ValueError("no view/like events found")


class DataSource(PDataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        super().__init__(params)
        self._store = PEventStore()

    def read_training(self, ctx: DeviceContext) -> TrainingData:
        """similarproduct.py:126-195. Under several processes each reads
        its user shard of the events (``find_sharded``); the catalog and
        the ``$set`` users stay replicated reads, and the user vocabulary
        is the ``$set`` users ∪ the union of the shards' event users (one
        vocabulary-sized allgather)."""
        t0 = time.perf_counter()
        app = self.params.app_name
        pid, procs = data_shard(ctx)
        sharded = procs > 1
        # item properties → catalog + categories (DataSource.scala itemsRDD)
        item_props = self._store.aggregate_properties(app, "item")
        items = BiMap.string_int(item_props.keys())
        categories = {
            iid: tuple(pm.get("categories") or ()) for iid, pm in item_props.items()
        }
        user_props = self._store.aggregate_properties(app, "user")
        view_events, like_u, like_i, like_sign = [], [], [], []
        local_users: set[str] = set()
        view_names = tuple(self.params.view_event_names)
        wanted = (*view_names, "like", "dislike")
        if sharded:
            events = self._store.find_sharded(
                app, procs, entity_type="user", event_names=wanted)[pid]
        else:
            events = self._store.find(
                app, entity_type="user", event_names=wanted,
                target_entity_type="item",
            )
        for e in events:
            if e.target_entity_type != "item":
                continue
            local_users.add(e.entity_id)
            if e.target_entity_id not in items:
                continue  # events referencing unknown items are dropped
            if e.event in view_names:
                view_events.append((e.entity_id, e.target_entity_id))
            else:
                like_u.append(e.entity_id)
                like_i.append(e.target_entity_id)
                like_sign.append(1.0 if e.event == "like" else -1.0)
        user_ids = set(user_props.keys())
        n_views_global = n_likes_global = None
        if sharded:
            user_ids |= set(union_label_set(ctx, local_users))
            n_views_global = global_row_count(ctx, len(view_events))
            n_likes_global = global_row_count(ctx, len(like_u))
            logger.info(
                "sharded read: %d of %d rows (shard %d/%d) in %.3f s",
                len(view_events) + len(like_u),
                n_views_global + n_likes_global, pid, procs,
                time.perf_counter() - t0)
        else:
            user_ids |= local_users
        users = BiMap.string_int(sorted(user_ids))  # sorted: set order is hash-seed dependent
        view_u = users.lookup_array([u for u, _ in view_events])
        view_i = items.lookup_array([i for _, i in view_events])
        return TrainingData(
            users=users,
            items=items,
            categories=categories,
            view_u=view_u,
            view_i=view_i,
            like_u=users.lookup_array(like_u),
            like_i=items.lookup_array(like_i),
            like_sign=np.asarray(like_sign, np.float32),
            rows_are_local=sharded,
            n_views_global=n_views_global,
            n_likes_global=n_likes_global,
        )


# -- shared model + filtering ----------------------------------------------

@dataclasses.dataclass
class ItemSimModel(HasCategoryIndex):
    """Normalized item vectors + catalog metadata for similarity scoring.
    ``prepare_for_serving`` puts the ``[k, n]`` catalog on the serving
    device (``_device_vt``); it is derived state and never pickles."""

    item_vecs: np.ndarray            # [n_items, k] L2-normalized
    item_map: BiMap
    categories: dict[str, tuple[str, ...]]

    _device_vt = None

    def prepare_for_serving(self, ctx: Optional[DeviceContext] = None
                            ) -> "ItemSimModel":
        """The catalog onto ``ctx.device`` (the card unless the caller
        passes another context) and the category index compiled."""
        ctx = ctx or DeviceContext.create()
        self._device_vt = device_catalog(self.item_vecs, ctx.device)
        self.category_index()
        return self

    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items() if k != "_device_vt"}

    def warmup(self, max_batch: int = 64) -> int:
        """One product at every serving bucket (called at deploy)."""
        if self._device_vt is None:
            self.prepare_for_serving()
        return sim_warmup(self._device_vt)

    def serving_info(self) -> dict:
        """Status-page observability (see TwoTowerModel.serving_info)."""
        dev = self._device_vt.device if self._device_vt is not None else None
        return {"path": "device-bf16", "catalog_rows": len(self.item_map),
                "device": str(dev)}


def _category_mask(model, query: Query) -> np.ndarray:
    """-inf mask implementing whitelist/blacklist/category filters + query-item
    exclusion (reference isCandidateItem, ALSAlgorithm.scala:200-230) —
    vectorized scatters over the model's compiled :class:`CategoryIndex`
    instead of the seed's two per-item loops over the whole catalog. Works
    for any model exposing ``item_map`` + ``category_index()``."""
    cat_index = model.category_index()
    n = len(model.item_map)
    mask = np.zeros(n, np.float32)
    if query.white_list is not None:
        mask += whitelist_vec(model.item_map, query.white_list)
    ban_rows(mask, model.item_map, query.black_list)
    if query.categories is not None:
        mask += cat_index.allow_vec(query.categories)
    if query.category_black_list is not None:
        mask += cat_index.ban_vec(query.category_black_list)
    ban_rows(mask, model.item_map, query.items)  # exclude the query items
    return mask


def _topk_result(scores: np.ndarray, num: int, inv) -> PredictedResult:
    """Serial top-k: selection, ordering and finiteness filter — the oracle
    the batched axis-wise form must match row for row."""
    num = min(num, len(scores))
    if num <= 0:  # degenerate query, not a catalog dump
        return PredictedResult()
    top = np.argpartition(-scores, num - 1)[:num]
    top = top[np.argsort(-scores[top])]
    return PredictedResult(tuple(
        ItemScore(inv[int(i)], float(scores[i]))
        for i in top if np.isfinite(scores[i])
    ))


def _similar_items(model: ItemSimModel, query: Query) -> PredictedResult:
    known = [model.item_map[i] for i in query.items if i in model.item_map]
    if not known:
        return PredictedResult()
    if model._device_vt is None:
        model.prepare_for_serving()
    qvecs = model.item_vecs[np.asarray(known)]
    scores = sim_scores(qvecs, model._device_vt, _category_mask(model, query))
    return _topk_result(scores, query.num, model.item_map.inverse())


def _similar_items_batch(
    model: ItemSimModel, queries: Sequence[tuple[int, Query]],
) -> list[tuple[int, PredictedResult]]:
    """Batched :func:`_similar_items`: every query's vectors stack into ONE
    scoring product (`sim_scores_stacked` — equal per row to the serial
    call on the CPU; on an H100 cuBLAS sums another M in another order, and
    a row may differ by one bf16 ulp), masks assemble as [B, n] vectorized
    scatters, and top-k
    runs axis-wise per ``num`` group. Queries with no known items return
    empty results exactly like the serial path."""
    queries = list(queries)
    if not queries:
        return []
    if model._device_vt is None:
        model.prepare_for_serving()
    qs = [q for _, q in queries]
    known = [
        np.asarray([model.item_map[i] for i in q.items
                    if i in model.item_map], np.int64)
        for q in qs
    ]
    results: list[PredictedResult] = [PredictedResult()] * len(qs)
    live = [b for b, k in enumerate(known) if len(k)]
    if live:
        masks = np.stack([_category_mask(model, qs[b]) for b in live])
        counts = [len(known[b]) for b in live]
        qvecs = model.item_vecs[np.concatenate([known[b] for b in live])]
        scored = sim_scores_stacked(qvecs, counts, model._device_vt, masks)
        inv = model.item_map.inverse()
        n = scored.shape[1]
        for r, (idx_row, score_row) in enumerate(grouped_topk(
                scored, [min(qs[b].num, n) for b in live])):
            finite = np.isfinite(score_row)
            results[live[r]] = PredictedResult(tuple(
                ItemScore(inv[int(i)], float(v))
                for i, v, f in zip(idx_row, score_row, finite) if f
            ))
    return [(qi, results[b]) for b, (qi, _) in enumerate(queries)]


# -- algorithms -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    rank: int = 16
    num_iterations: int = 20
    learning_rate: float = 3e-2
    negatives_per_positive: int = 4
    seed: Optional[int] = None


class ALSAlgorithm(PAlgorithm):
    """Implicit MF on view events (ALSAlgorithm.scala:61-135
    ``ALS.trainImplicit``) via two-tower towers + sampled negatives."""

    params_class = ALSAlgorithmParams
    serving_thread_safe = True  # read-only served tensors and arrays
    query_cls = Query

    def train(self, ctx: DeviceContext, pd: TrainingData) -> ItemSimModel:
        p = self.params
        rng = np.random.default_rng(p.seed if p.seed is not None else 0)
        pos_u, pos_i = pd.view_u, pd.view_i
        k = p.negatives_per_positive
        neg_u, neg_i = sample_negatives(pos_u, pos_i, len(pd.items), k, rng)
        users = np.concatenate([pos_u, neg_u])
        items = np.concatenate([pos_i, neg_i])
        ratings = np.concatenate([
            np.ones(len(pos_u), np.float32), np.zeros(len(neg_u), np.float32)
        ])
        mf = TwoTowerMF(TwoTowerConfig(
            rank=p.rank, epochs=p.num_iterations, learning_rate=p.learning_rate,
            batch_size=8192, seed=p.seed if p.seed is not None else 0,
        )).fit(ctx, users, items, ratings, len(pd.users), len(pd.items),
               rows_are_local=pd.rows_are_local)
        mf.ensure_host()  # cosine model is a host build
        return ItemSimModel(
            item_vecs=l2_normalize(mf.item_emb),
            item_map=pd.items,
            categories=pd.categories,
        )

    def predict(self, model: ItemSimModel, query: Query) -> PredictedResult:
        return _similar_items(model, query)

    def batch_predict(self, model, queries):
        return _similar_items_batch(model, queries)


class LikeAlgorithm(ALSAlgorithm):
    """Signed MF on like/dislike (LikeAlgorithm.scala: like=+1, dislike=-1;
    later event for the same (user, item) wins in the reference — here all
    signals contribute, which is the same MF objective up to weighting)."""

    def train(self, ctx: DeviceContext, pd: TrainingData) -> ItemSimModel:
        p = self.params
        n_likes = (pd.n_likes_global if pd.n_likes_global is not None
                   else len(pd.like_u))
        if n_likes == 0:
            raise ValueError("LikeAlgorithm requires like/dislike events")
        mf = TwoTowerMF(TwoTowerConfig(
            rank=p.rank, epochs=p.num_iterations, learning_rate=p.learning_rate,
            batch_size=8192, seed=p.seed if p.seed is not None else 0,
        )).fit(ctx, pd.like_u, pd.like_i, pd.like_sign,
               len(pd.users), len(pd.items),
               rows_are_local=pd.rows_are_local)
        mf.ensure_host()  # cosine model is a host build
        return ItemSimModel(
            item_vecs=l2_normalize(mf.item_emb),
            item_map=pd.items,
            categories=pd.categories,
        )


@dataclasses.dataclass(frozen=True)
class CooccurrenceAlgorithmParams(Params):
    n: int = 20  # top co-occurring items kept per item (CooccurrenceAlgorithm.scala:27)


@dataclasses.dataclass
class CooccurrenceModel(HasCategoryIndex):
    top_cooccurrences: dict[int, list[tuple[int, int]]]  # item → [(item, count)]
    item_map: BiMap
    categories: dict[str, tuple[str, ...]]

    def prepare_for_serving(self, ctx: Optional[DeviceContext] = None
                            ) -> "CooccurrenceModel":
        self.category_index()
        return self


class CooccurrenceAlgorithm(PAlgorithm):
    """Item co-view counts (CooccurrenceAlgorithm.scala:51-133). The RDD
    self-join becomes Uᵀ U on the card: U is the binary user×item view
    matrix, so one product yields every pairwise co-count. Over sharded
    rows (similarproduct.py:407-417) each process counts its user shard's
    co-views, rounded to bf16 as one process's counts are, and the
    processes' matrices are summed in process order: users are
    entity-disjoint, so the global counts are the plain sum."""

    params_class = CooccurrenceAlgorithmParams
    serving_thread_safe = True  # read-only served arrays
    query_cls = Query

    def train(self, ctx: DeviceContext, pd: TrainingData) -> CooccurrenceModel:
        n_users, n_items = len(pd.users), len(pd.items)
        cooc = _cooccur(pd.view_u, pd.view_i, n_users, n_items, ctx.device)
        if pd.rows_are_local:
            t0 = time.perf_counter()
            cooc = global_sum(ctx, cooc)
            logger.info(
                "co-occurrence: the processes' [%d, %d] count matrices "
                "summed (%d bytes a process) in %.3f s", n_items, n_items,
                cooc.nbytes, time.perf_counter() - t0)
        np.fill_diagonal(cooc, 0)
        top_n = self.params.n
        top: dict[int, list[tuple[int, int]]] = {}
        for i in range(n_items):
            row = cooc[i]
            nz = np.nonzero(row)[0]
            if len(nz) == 0:
                continue
            order = nz[np.argsort(-row[nz])][:top_n]
            top[i] = [(int(j), int(row[j])) for j in order]
        return CooccurrenceModel(top, pd.items, pd.categories)

    def predict(self, model: CooccurrenceModel, query: Query) -> PredictedResult:
        counts: dict[int, int] = {}
        for qi in query.items:
            idx = model.item_map.get(qi)
            if idx is None:
                continue
            for j, c in model.top_cooccurrences.get(idx, ()):
                counts[j] = counts.get(j, 0) + c
        mask = _category_mask(model, query)
        scored = [
            (j, c) for j, c in counts.items() if np.isfinite(mask[j])
        ]
        scored.sort(key=lambda t: -t[1])
        inv = model.item_map.inverse()
        return PredictedResult(tuple(
            ItemScore(inv[j], float(c)) for j, c in scored[: query.num]
        ))

    def batch_predict(self, model, queries):
        return [(i, self.predict(model, q)) for i, q in queries]


def _cooccur(view_u: np.ndarray, view_i: np.ndarray, n_users: int,
             n_items: int, device) -> np.ndarray:
    """Every pairwise co-count, ``Uᵀ U``, as the reference's ``_cooccur``
    computes it (bf16 operands, fp32 sums, the result rounded to bf16): U
    is built on ``device`` from the index pairs (de-duplicated views are
    1). Its 0/1 entries are exact in any float type, so the product runs in
    fp32 (exact integer sums below 2^24 users) and is rounded to bf16
    (nearest even) once — bitwise the reference's counts. Returns a host
    fp32 [n_items, n_items] array."""
    u = torch.zeros((n_users, n_items), dtype=torch.float32, device=device)
    if len(view_u):
        u[torch.from_numpy(np.asarray(view_u, np.int64)).to(device),
          torch.from_numpy(np.asarray(view_i, np.int64)).to(device)] = 1.0
    cooc = torch.matmul(u.T, u).to(torch.bfloat16).to(torch.float32)
    del u
    return cooc.cpu().numpy()


# -- serving ----------------------------------------------------------------

class Serving(LServing):
    """Multi-algo: sum scores per item across algorithm outputs
    (multi-events-multi-algos Serving.scala: standardize-free sum variant)."""

    def serve(self, query: Query, predictions: Sequence[PredictedResult]) -> PredictedResult:
        combined: dict[str, float] = {}
        for pred in predictions:
            for s in pred.item_scores:
                combined[s.item] = combined.get(s.item, 0.0) + s.score
        top = sorted(combined.items(), key=lambda t: -t[1])[: query.num]
        return PredictedResult(tuple(ItemScore(i, sc) for i, sc in top))


class SimilarProductEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            DataSource,
            IdentityPreparator,
            {"als": ALSAlgorithm, "cooccurrence": CooccurrenceAlgorithm,
             "likealgo": LikeAlgorithm, "": ALSAlgorithm},
            {"": Serving},
        )
