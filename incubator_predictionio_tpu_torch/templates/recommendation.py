"""Recommendation template — the serving side.

Counterpart of ``incubator_predictionio_tpu/templates/recommendation.py``
(the scala-parallel-recommendation template): the query and result types,
:class:`RecModel` with its serving preparation, ``ALSAlgorithm.predict`` /
``batch_predict`` and :class:`RecommendationEngine`. Reading events and
training come with the training slice (ROADMAP.md Queue 1 item 3); until
then a model reaches the port through ``convert.py``.

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
    FirstServing,
    IdentityPreparator,
    PAlgorithm,
    Params,
    PDataSource,
    PersistentModel,
)
from incubator_predictionio_tpu_torch.data.bimap import BiMap
from incubator_predictionio_tpu_torch.models.two_tower import (
    ROW_MASK_MAX_ELEMENTS,
    TwoTowerMF,
    TwoTowerModel,
    serve_bucket,
)
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext

logger = logging.getLogger(__name__)

#: what raises in the stages this slice does not port
_TRAINING_SLICE = ("the training slice of the PyTorch port (ROADMAP.md "
                   "Queue 1, item 3: two_tower fit, sqlite storage, the "
                   "CLI train verb)")


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


class DataSource(PDataSource):
    params_class = DataSourceParams

    def read_training(self, ctx: DeviceContext):
        raise NotImplementedError(
            f"DataSource.read_training is ported by {_TRAINING_SLICE}")


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

    Host models persist through default MODELDATA pickling (``save`` returns
    False); the reference's device-resident orbax path comes with the
    training slice."""

    mf: TwoTowerModel
    user_map: BiMap
    item_map: BiMap

    def save(self, model_id: str, params: Params, ctx: DeviceContext) -> bool:
        return False  # host model → default MODELDATA pickling

    def prepare_for_serving(self, ctx: DeviceContext) -> "RecModel":
        # on a CUDA device the catalog is int8-quantized on the card and
        # scored by kernel K1 (the reference quantizes when its platform is
        # "tpu")
        self.mf.prepare_for_serving(quantize=ctx.device.type == "cuda",
                                    device=ctx.device)
        return self

    def warmup(self, max_batch: int = 64) -> int:
        """Dispatch every serving batch bucket once (called at deploy)."""
        return self.mf.warmup(max_batch)

    def serving_info(self) -> dict:
        return self.mf.serving_info()

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

    def train(self, ctx: DeviceContext, pd) -> RecModel:
        raise NotImplementedError(
            f"ALSAlgorithm.train is ported by {_TRAINING_SLICE}")

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


# -- engine -----------------------------------------------------------------

class RecommendationEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            DataSource,
            IdentityPreparator,
            {"als": ALSAlgorithm, "": ALSAlgorithm},
            FirstServing,
        )
