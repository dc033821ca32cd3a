"""Sequential recommender template — the serving side.

Counterpart of ``incubator_predictionio_tpu/templates/sequential.py``
(next-item prediction with a Transformer4Rec-style causal transformer): the
query and result types, :func:`encode_session`,
``TransformerAlgorithm.predict`` / ``batch_predict`` and
:class:`SequentialEngine`. Training comes with the sequential training
slice (ROADMAP.md Queue 1, item 1) and reading events with the events DAO
(item 3); until then a model reaches the port through ``convert.py``.

Query ``{"recentItems": [...], "num": N}`` scores the next item after an
explicit session → ``{"itemScores": [{"item": I, "score": S}, …]}``, never
a history item; a session with no known item gets the reference's empty
answer. ``{"user": U}`` queries read the user's recent events from the
event store in the reference; the port has no event store yet, so they
raise ``NotImplementedError`` (ROADMAP.md) — never an empty answer.
"""

from __future__ import annotations

import dataclasses
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
)
from incubator_predictionio_tpu_torch.data.bimap import BiMap
from incubator_predictionio_tpu_torch.models.transformer import (
    TRAINING_SLICE,
    TransformerModel,
    TransformerRecommender,
)
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext

#: what reads events in the reference, not ported yet
EVENTS_DAO = ("the events DAO of the PyTorch port (ROADMAP.md Queue 1, "
              "item 3)")
#: why a ``{"user": U}`` query raises
USER_QUERIES = ("a {\"user\": U} query reads the user's recent events from "
                f"the event store (LEventStore), which waits for {EVENTS_DAO}; "
                "send {\"recentItems\": [...]} instead")


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


class DataSource(PDataSource):
    params_class = DataSourceParams

    def read_training(self, ctx: DeviceContext):
        raise NotImplementedError(
            f"sequential DataSource.read_training reads events: it waits "
            f"for {EVENTS_DAO}")


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

    def train(self, ctx: DeviceContext, pd) -> TransformerModel:
        raise NotImplementedError(
            f"TransformerAlgorithm.train is ported by {TRAINING_SLICE}")

    def _history(self, query: Query, model: TransformerModel) -> list[str]:
        if query.recent_items is not None:
            return list(query.recent_items)
        if query.user is None:
            return []
        raise NotImplementedError(USER_QUERIES)

    def predict(self, model: TransformerModel, query: Query) -> PredictedResult:
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(
        self, model: TransformerModel, queries: Sequence[tuple[int, Query]]
    ) -> list[tuple[int, PredictedResult]]:
        """One forward for the whole batch (sequential.py:308-338). A
        ``user`` query raises before the forward; the query server then
        answers the batch's queries one by one, so it fails alone."""
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
