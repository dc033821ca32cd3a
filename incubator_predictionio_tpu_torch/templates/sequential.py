"""Sequential recommender template — training and serving.

Counterpart of ``incubator_predictionio_tpu/templates/sequential.py``
(next-item prediction with a Transformer4Rec-style causal transformer): the
query and result types, :func:`encode_session`, :class:`TrainingData`,
``DataSource._collect_sessions`` (each user's ``view``/``buy`` items in
event-time order, from the event store), ``_build_fold`` (sessions → token
space and left-padded rows), ``read_training``, ``read_eval`` (k folds by a
stable user hash), ``TransformerAlgorithm.train`` / ``predict`` /
``batch_predict``, :class:`SequentialEngine` and the evaluation:
:class:`HitRateAtK`, :class:`SequentialEvaluation`.

Query ``{"recentItems": [...], "num": N}`` scores the next item after an
explicit session; ``{"user": U, "num": N}`` reads the user's latest
``max_len`` ``recent_events`` from the event store (``LEventStore``) and
scores the next item after them. Either answers ``{"itemScores": [{"item":
I, "score": S}, …]}``, never a history item; a session with no known item
(a user the store does not know) gets the reference's empty answer.
Under several processes each process reads its user shard, the token space
is the union over the processes, and the fit is data-parallel
(``models/transformer.py``).
"""

from __future__ import annotations

import dataclasses
import logging
import zlib
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
)
from incubator_predictionio_tpu_torch.data.bimap import BiMap
from incubator_predictionio_tpu_torch.data.sharded import (
    data_shard,
    gather_data,
    global_row_count,
    union_vocab,
)
from incubator_predictionio_tpu_torch.data.store import LEventStore, PEventStore
from incubator_predictionio_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerModel,
    TransformerRecommender,
)
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext

logger = logging.getLogger(__name__)

# -- queries / results ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Query:
    user: Optional[str] = None
    recent_items: Optional[tuple[str, ...]] = None
    num: int = 10


@dataclasses.dataclass(frozen=True)
class ItemScore:
    item: str
    score: float


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    item_scores: tuple[ItemScore, ...] = ()


@dataclasses.dataclass(frozen=True)
class ActualResult:
    """Held-out next item of one session (eval ground truth)."""

    next_item: str


def encode_session(items: Sequence[str], item_map: BiMap, width: int) -> np.ndarray:
    """Copy of ``incubator_predictionio_tpu/templates/sequential.py:encode_session``
    (:100): left-pad a session's tokens to ``width`` (newest item last);
    unknown items are dropped."""
    tokens = [item_map[i] for i in items if i in item_map][-width:]
    out = np.zeros(width, np.int32)
    if tokens:
        out[-len(tokens):] = tokens
    return out


# -- data source ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = "sequential"
    max_len: int = 32
    events: tuple[str, ...] = ("view", "buy")
    eval_k: Optional[int] = None
    eval_num: int = 10


@dataclasses.dataclass
class TrainingData:
    """sequential.py:85: ``sequences`` ``[n, max_len+1]`` int32 tokens,
    0-padded on the left; ``item_map`` item id → token (1-based, 0 is
    padding); ``rows_are_local`` / ``n_rows_global`` describe a
    multi-process sharded read (this process's user shard; the item map
    and tokens are global)."""

    sequences: np.ndarray
    item_map: BiMap
    rows_are_local: bool = False
    n_rows_global: Optional[int] = None

    def sanity_check(self) -> None:
        total = (self.n_rows_global if self.n_rows_global is not None
                 else len(self.sequences))
        if total == 0:
            raise ValueError("no sessions found")


class DataSource(PDataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        super().__init__(params)
        self._store = PEventStore()

    def _collect_sessions(self, ctx: DeviceContext) -> tuple[dict[str, list[str]], bool]:
        """sequential.py:116-137: user → ordered item list, from every
        ``events`` event of a user on an item (event-time ordered), for
        this process's user shard (``find_sharded``; sessions are per-user
        and users are entity-sharded, so a session never splits across
        processes). Returns (sessions, sharded)."""
        p = self.params
        pid, procs = data_shard(ctx)
        sharded = procs > 1
        sessions: dict[str, list[str]] = {}
        if sharded:
            events = self._store.find_sharded(
                p.app_name, procs, entity_type="user",
                event_names=tuple(p.events))[pid]
        else:
            events = self._store.find(
                p.app_name, entity_type="user", event_names=tuple(p.events),
                target_entity_type="item",
            )
        for e in events:
            if e.target_entity_type != "item":
                continue
            sessions.setdefault(e.entity_id, []).append(e.target_entity_id)
        return sessions, sharded

    def _build_fold(self, ctx: DeviceContext, sessions_list: list[list[str]],
                    sharded: bool) -> TrainingData:
        """sequential.py:139-171: the token space from the sessions in
        first-seen order (token 0 reserved for padding; ``sharded``: the
        first-seen union over the processes' vocabularies in process order,
        one vocabulary-sized allgather), and one row per session of at
        least 2 items, left-padded to ``max_len + 1``."""
        base = BiMap.string_int([i for items in sessions_list for i in items])
        n_rows_global = None
        if sharded:
            vocab, _ = union_vocab(ctx, list(base))
            base = BiMap({v: i for i, v in enumerate(vocab.tolist())})
        item_map = BiMap({k: v + 1 for k, v in base.items()})
        width = self.params.max_len + 1
        rows = [encode_session(items, item_map, width)
                for items in sessions_list if len(items) >= 2]
        if sharded:
            n_rows_global = global_row_count(ctx, len(rows))
            logger.info("sharded read: %d of %d rows (shard %d/%d)",
                        len(rows), n_rows_global, *data_shard(ctx))
        # a launched read's rows are the process's (reference :170: every
        # process of a launch, whatever its mesh axes); the processes of a
        # model, expert, seq or pipe line read the same data shard
        return TrainingData(
            sequences=np.stack(rows) if rows else np.zeros((0, width), np.int32),
            item_map=item_map,
            rows_are_local=sharded or ctx.process_count > 1,
            n_rows_global=n_rows_global)

    def read_training(self, ctx: DeviceContext) -> TrainingData:
        """sequential.py:174: the sessions from the event store, folded
        into the token space and rows."""
        sessions, sharded = self._collect_sessions(ctx)
        return self._build_fold(ctx, list(sessions.values()), sharded)

    def read_eval(self, ctx: DeviceContext):
        """sequential.py:178-224: k-fold next-item evaluation. Sessions split
        by a stable user hash; a held-out session of at least 3 items becomes
        (Query(recentItems=prefix), ActualResult(last item)). Fold
        vocabularies come from the fold's TRAIN sessions only, so unseen
        items stay genuinely unknown. Sharded: each process folds its own
        users, and the held-out queries are allgathered in process order,
        so that every process evaluates the same global query set."""
        k = self.params.eval_k
        if not k:
            return []
        p = self.params
        sessions, sharded = self._collect_sessions(ctx)
        # fold assignment computed ONCE per user, not re-hashed per fold
        fold_of = {
            user: zlib.crc32(f"{p.app_name}|{user}".encode()) % k
            for user in sessions
        }
        folds = []
        for fold in range(k):
            train_sessions, held = [], []
            for user, items in sessions.items():
                if fold_of[user] == fold:
                    held.append(items)
                else:
                    train_sessions.append(items)
            td = self._build_fold(ctx, train_sessions, sharded)
            local_qa = [
                (Query(recent_items=tuple(items[:-1]), num=p.eval_num),
                 ActualResult(items[-1]))
                for items in held if len(items) >= 3
            ]
            if sharded:
                parts = gather_data(ctx, [
                    (list(q.recent_items), q.num, a.next_item)
                    for q, a in local_qa
                ])
                qa = [
                    (Query(recent_items=tuple(r), num=num), ActualResult(nx))
                    for part in parts for r, num, nx in part
                ]
            else:
                qa = local_qa
            folds.append((td, {"fold": fold}, qa))
        return folds


# -- algorithm --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TransformerAlgorithmParams(Params):
    """The reference's params (sequential.py:228), every field, so its
    variants bind unchanged."""

    app_name: str = "sequential"
    max_len: int = 32
    d_model: int = 64
    n_heads: int = 2
    n_layers: int = 2
    learning_rate: float = 1e-3
    batch_size: int = 256
    epochs: int = 10
    seed: int = 0
    attention: str = "auto"  # "auto" | "local" | "ring"
    num_experts: int = 0
    pipeline_stages: int = 0
    pipeline_microbatches: int = 0
    remat: bool = False
    tensor_parallel: bool = False
    recent_events: tuple[str, ...] = ("view", "buy")
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0


class TransformerAlgorithm(PAlgorithm):
    params_class = TransformerAlgorithmParams
    serving_thread_safe = True  # read-only served tensors, one forward a call
    query_cls = Query

    def __init__(self, params: TransformerAlgorithmParams):
        super().__init__(params)
        self._levents = LEventStore()

    def train(self, ctx: DeviceContext, pd: TrainingData) -> TransformerModel:
        """sequential.py:264: the config from the params and the token
        space, then ``TransformerRecommender.fit`` on ``ctx.device``. The
        model comes back ready to score there (its serving net built, as
        the MLP and naive Bayes fits leave theirs), so that evaluation's
        ``batch_predict`` can score a fold's model as the reference's can;
        the persisted form drops the net."""
        p = self.params
        cfg = TransformerConfig(
            vocab_size=len(pd.item_map) + 1,
            max_len=p.max_len,
            d_model=p.d_model,
            n_heads=p.n_heads,
            n_layers=p.n_layers,
            learning_rate=p.learning_rate,
            batch_size=p.batch_size,
            epochs=p.epochs,
            seed=p.seed,
            attention=p.attention,
            n_experts=p.num_experts,
            pipeline_stages=p.pipeline_stages,
            pipeline_microbatches=p.pipeline_microbatches,
            remat=p.remat,
            tensor_parallel=p.tensor_parallel,
            checkpoint_dir=p.checkpoint_dir,
            checkpoint_every=p.checkpoint_every,
        )
        model = TransformerRecommender(cfg).fit(
            ctx, pd.sequences, pd.item_map, rows_are_local=pd.rows_are_local)
        return model.prepare_for_serving(ctx)

    def _history(self, query: Query, model: TransformerModel) -> list[str]:
        if query.recent_items is not None:
            return list(query.recent_items)
        if query.user is None:
            return []
        # sequential.py:289-303: the user's latest max_len events, newest
        # last; an app the store does not know answers empty
        try:
            events = list(self._levents.find_by_entity(
                self.params.app_name, "user", query.user,
                event_names=tuple(self.params.recent_events),
                target_entity_type="item",
                limit=model.config.max_len, latest=True,
            ))
        except ValueError:
            return []
        return [e.target_entity_id for e in reversed(events) if e.target_entity_id]

    def predict(self, model: TransformerModel, query: Query) -> PredictedResult:
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(
        self, model: TransformerModel, queries: Sequence[tuple[int, Query]]
    ) -> list[tuple[int, PredictedResult]]:
        """One forward for the whole batch (sequential.py:308-338); each
        ``user`` query reads its history from the event store first."""
        if not queries:
            return []
        histories = [self._history(q, model) for _, q in queries]
        rows = np.stack([
            encode_session(h, model.item_map, model.config.max_len)
            for h in histories
        ])
        scores = TransformerRecommender.next_item_scores(model, rows)
        inv = model.item_map.inverse()
        out = []
        for (qi, q), h, row_scores in zip(queries, histories, scores):
            if not any(i in model.item_map for i in h):
                out.append((qi, PredictedResult()))  # cold session
                continue
            s = row_scores.copy()
            s[0] = -np.inf  # padding token
            for i in h:     # exclude history items
                tok = model.item_map.get(i)
                if tok is not None:
                    s[tok] = -np.inf
            num = min(q.num, len(s) - 1)
            top = np.argpartition(-s, num - 1)[:num]
            top = top[np.argsort(-s[top])]
            out.append((qi, PredictedResult(tuple(
                ItemScore(inv[int(t)], float(s[t]))
                for t in top if np.isfinite(s[t])
            ))))
        return out


class SequentialEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            DataSource,
            IdentityPreparator,
            {"transformer": TransformerAlgorithm, "": TransformerAlgorithm},
            FirstServing,
        )


# -- evaluation -------------------------------------------------------------

class HitRateAtK(OptionAverageMetric):
    """Fraction of held-out sessions whose true next item appears in the
    top-k (sequential.py:353-369; the serving path's unseen-only policy
    applies, so repeat-item sessions count as misses)."""

    def __init__(self, k: int = 10):
        self.k = k

    @property
    def header(self) -> str:
        return f"HitRate@K (k={self.k})"

    def calculate_qpa(self, q: Query, p: PredictedResult, a: ActualResult):
        if not p.item_scores:
            return 0.0  # cold/unknown-vocab session: a miss, not a skip
        return 1.0 if a.next_item in {
            s.item for s in p.item_scores[: self.k]} else 0.0


class SequentialEvaluation(Evaluation, EngineParamsGenerator):
    """HitRate@10 over a small schedule grid (sequential.py:372-391)."""

    def __init__(self, app_name: str = "sequential", eval_k: int = 3):
        self.engine = SequentialEngine().apply()
        self.evaluator = MetricEvaluator(metric=HitRateAtK(k=10))
        self.engine_params_list = [
            EngineParams.create(
                data_source=DataSourceParams(app_name=app_name, eval_k=eval_k),
                algorithms=[("transformer", TransformerAlgorithmParams(
                    app_name=app_name, d_model=32, n_layers=1,
                    epochs=epochs, learning_rate=lr, batch_size=64))],
            )
            for epochs in (10, 30)
            for lr in (1e-3, 5e-3)
        ]
