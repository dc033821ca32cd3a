"""Classification template — training and serving.

Counterpart of ``incubator_predictionio_tpu/templates/classification.py``
(:56-355, :384-395; the scala-parallel-classification counterpart): the
DataSource reads ``$set`` events on "user" entities carrying numeric
feature properties plus a label property (DataSource.scala reads attr0-2 +
"plan"), queries carry a feature vector and get a predicted label back.

The flagship algorithm is the MLP (``models/mlp.py``) trained on the card;
the "add-algorithm" variant of the reference example is mirrored by
:class:`NaiveBayesAlgorithm` (Gaussian NB over the numeric features: the
fit's segment sums and the scoring pass run as torch ops on the card) plus
:class:`VoteServing` (majority vote across algorithms). ``read_eval``, the
metrics and the Evaluations come with the evaluation slice (ROADMAP.md
Queue 1, item 5 part 4); sharded reads and fits with the sharding slice
(item 4).
"""

from __future__ import annotations

import dataclasses
import math
from collections import Counter
from typing import Optional, Sequence

import numpy as np
import torch

from incubator_predictionio_tpu_torch.core import (
    Engine,
    EngineFactory,
    FirstServing,
    IdentityPreparator,
    LServing,
    P2LAlgorithm,
    Params,
    PDataSource,
    SanityCheck,
)
from incubator_predictionio_tpu_torch.data.store import PEventStore
from incubator_predictionio_tpu_torch.models.mlp import (
    MLPClassifier,
    MLPConfig,
    MLPModel,
)
from incubator_predictionio_tpu_torch.models.two_tower import SHARDING_SLICE
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext

#: what raises in the evaluation paths this slice does not port
EVALUATION_SLICE = ("the evaluation slice of the PyTorch port (ROADMAP.md "
                    "Queue 1, item 5 part 4)")


# -- data source ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = "classification"
    attrs: tuple[str, ...] = ("attr0", "attr1", "attr2")
    label: str = "plan"
    eval_k: Optional[int] = None  # k-fold eval (read_eval) comes with item 5 part 4


@dataclasses.dataclass
class TrainingData(SanityCheck):
    """Columnar features/labels (the RDD[LabeledPoint] counterpart)."""

    x: np.ndarray  # [n, d] float32
    y: np.ndarray  # [n] labels (original values)
    # multi-process sharded reads come with the sharding slice
    rows_are_local: bool = False
    n_rows_global: Optional[int] = None

    def sanity_check(self) -> None:
        total = (self.n_rows_global if self.n_rows_global is not None
                 else len(self.x))
        if total == 0:
            raise ValueError("TrainingData is empty (no labeled entities found)")
        if not np.isfinite(self.x).all():
            raise ValueError("TrainingData contains non-finite features")


@dataclasses.dataclass(frozen=True)
class Query:
    features: tuple[float, ...]


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    label: object
    scores: Optional[dict] = None


class DataSource(PDataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        super().__init__(params)
        self._store = PEventStore()

    def _read(self, n_shards: Optional[int] = None,
              shard_index: int = 0) -> TrainingData:
        props = self._store.aggregate_properties(
            self.params.app_name,
            "user",
            required=[*self.params.attrs, self.params.label],
            n_shards=n_shards,
            shard_index=shard_index,
        )
        xs, ys = [], []
        for pm in props.values():
            xs.append([float(pm.get(a)) for a in self.params.attrs])
            ys.append(pm.get(self.params.label))
        return TrainingData(
            np.asarray(xs, np.float32).reshape(len(xs), len(self.params.attrs)),
            np.asarray(ys),
        )

    def read_training(self, ctx: DeviceContext) -> TrainingData:
        if ctx.process_count > 1:
            return self._read_sharded(ctx)
        return self._read()

    def _read_sharded(self, ctx: DeviceContext) -> TrainingData:
        raise NotImplementedError(
            "classification DataSource: per-process entity-sharded reads "
            f"come with {SHARDING_SLICE}")

    def read_eval(self, ctx: DeviceContext):
        raise NotImplementedError(
            f"classification DataSource.read_eval comes with {EVALUATION_SLICE}")


# -- algorithm --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLPAlgorithmParams(Params):
    hidden_dims: tuple[int, ...] = (128, 128)
    learning_rate: float = 1e-2
    batch_size: int = 256
    epochs: int = 50
    seed: int = 0


class MLPAlgorithm(P2LAlgorithm):
    """NaiveBayes → MLP (cites NaiveBayesAlgorithm.scala:36-60 for the slot
    it fills, not the math)."""

    params_class = MLPAlgorithmParams
    serving_thread_safe = True  # read-only served tensors
    query_cls = Query

    def _config(self) -> MLPConfig:
        p = self.params
        return MLPConfig(
            hidden_dims=tuple(p.hidden_dims),
            learning_rate=p.learning_rate,
            batch_size=p.batch_size,
            epochs=p.epochs,
            seed=p.seed,
        )

    def train(self, ctx: DeviceContext, pd: TrainingData) -> MLPModel:
        return MLPClassifier(self._config()).fit(
            ctx, pd.x, pd.y, rows_are_local=pd.rows_are_local)

    def predict(self, model: MLPModel, query: Query) -> PredictedResult:
        x = np.asarray([query.features], np.float32)
        logits = MLPClassifier.logits(model, x)[0]
        probs = np.exp(logits - logits.max())
        probs /= probs.sum()
        best = int(logits.argmax())
        return PredictedResult(
            label=model.classes[best],
            scores={str(c): float(p) for c, p in zip(model.classes, probs)},
        )

    def batch_predict(
        self, model: MLPModel, queries: Sequence[tuple[int, Query]]
    ) -> list[tuple[int, PredictedResult]]:
        if not queries:
            return []
        x = np.asarray([q.features for _, q in queries], np.float32)
        labels = MLPClassifier.predict(model, x)
        return [(i, PredictedResult(label=l)) for (i, _), l in zip(queries, labels)]


# -- second algorithm: Gaussian naive Bayes (the "add-algorithm" variant) ---

@dataclasses.dataclass(frozen=True)
class NaiveBayesAlgorithmParams(Params):
    var_smoothing: float = 1e-6
    seed: int = 0  # unused (closed-form fit); kept for params-surface parity


@dataclasses.dataclass
class NaiveBayesModel:
    classes: np.ndarray   # [c] original label values
    means: np.ndarray     # [c, d]
    variances: np.ndarray # [c, d]
    log_priors: np.ndarray  # [c]

    _device = None  # (means, variances, log_priors) on the serving device

    def prepare_for_serving(self, ctx: Optional[DeviceContext] = None
                            ) -> "NaiveBayesModel":
        """The class statistics onto ``ctx.device`` (the card unless the
        caller passes another context); derived, never pickled."""
        ctx = ctx or DeviceContext.create()
        self._device = tuple(
            torch.from_numpy(np.asarray(a, np.float32)).to(ctx.device)
            for a in (self.means, self.variances, self.log_priors))
        return self

    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items() if k != "_device"}

    def warmup(self, max_batch: int = 64) -> int:
        """One scoring pass at deploy (the device libraries' first use)."""
        if self._device is None:
            self.prepare_for_serving()
        _nb_loglik(torch.zeros((max(1, max_batch), self.means.shape[1]),
                               device=self._device[0].device), *self._device)
        return 1

    def serving_info(self) -> dict:
        dev = str(self._device[0].device) if self._device is not None else None
        return {"path": "device-nb", "classes": len(self.classes), "device": dev}


def _nb_fit(x: torch.Tensor, y_idx: torch.Tensor, n_classes: int,
            smoothing: float):
    """Per-class counts, means and variances as segment sums
    (``index_add_``; on the card its atomics sum in no fixed order)."""
    ones = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    counts = torch.zeros(n_classes, dtype=torch.float32, device=x.device)
    counts.index_add_(0, y_idx, ones)
    sums = torch.zeros((n_classes, x.shape[1]), dtype=torch.float32,
                       device=x.device)
    means = sums.index_add_(0, y_idx, x) / counts[:, None]
    # variance as mean squared deviation (E[x²]−E[x]² cancels catastrophically
    # in float32 for large-magnitude/small-spread features), floored at the
    # smoothing so constant columns stay positive
    dev = x - means[y_idx]
    ssd = torch.zeros_like(sums).index_add_(0, y_idx, dev * dev)
    variances = torch.clamp(ssd / counts[:, None], min=smoothing)
    log_priors = torch.log(counts / counts.sum())
    return means, variances, log_priors


def _nb_loglik(x: torch.Tensor, means: torch.Tensor, variances: torch.Tensor,
               log_priors: torch.Tensor) -> torch.Tensor:
    # [b, 1, d] against [c, d]: full Gaussian log-likelihood per class
    quad = (x[:, None, :] - means[None]) ** 2 / variances[None]
    ll = -0.5 * (torch.log(2.0 * math.pi * variances)[None] + quad).sum(-1)
    return ll + log_priors[None, :]


class NaiveBayesAlgorithm(P2LAlgorithm):
    """Second algorithm of the reference add-algorithm example
    (examples/scala-parallel-classification/add-algorithm/): MLlib NaiveBayes
    there; Gaussian NB over the numeric feature columns here, with the
    closed-form fit and the scoring pass both running as torch ops on the
    card."""

    params_class = NaiveBayesAlgorithmParams
    serving_thread_safe = True  # read-only served tensors
    query_cls = Query

    def train(self, ctx: DeviceContext, pd: TrainingData) -> NaiveBayesModel:
        if pd.rows_are_local and ctx.process_count > 1:
            return self._train_sharded(ctx, pd)
        classes, y_idx = np.unique(pd.y, return_inverse=True)
        dev = ctx.device
        stats = _nb_fit(
            torch.from_numpy(np.asarray(pd.x, np.float32)).to(dev),
            torch.from_numpy(y_idx.astype(np.int64)).to(dev),
            len(classes), self.params.var_smoothing,
        )
        means, variances, log_priors = (t.cpu().numpy() for t in stats)
        model = NaiveBayesModel(classes=classes, means=means,
                                variances=variances, log_priors=log_priors)
        model._device = stats
        return model

    def _train_sharded(self, ctx: DeviceContext, pd: TrainingData) -> NaiveBayesModel:
        raise NotImplementedError(
            f"NaiveBayesAlgorithm over per-process rows comes with {SHARDING_SLICE}")

    def _scores(self, model: NaiveBayesModel, x: np.ndarray) -> np.ndarray:
        if model._device is None:
            model.prepare_for_serving()
        means = model._device[0]
        return _nb_loglik(torch.from_numpy(np.asarray(x, np.float32)).to(means.device),
                          *model._device).cpu().numpy()

    def predict(self, model: NaiveBayesModel, query: Query) -> PredictedResult:
        ll = self._scores(model, np.asarray([query.features], np.float32))[0]
        probs = np.exp(ll - ll.max())
        probs /= probs.sum()
        return PredictedResult(
            label=model.classes[int(ll.argmax())],
            scores={str(c): float(p) for c, p in zip(model.classes, probs)},
        )

    def batch_predict(
        self, model: NaiveBayesModel, queries: Sequence[tuple[int, Query]]
    ) -> list[tuple[int, PredictedResult]]:
        if not queries:
            return []
        x = np.asarray([q.features for _, q in queries], np.float32)
        ll = self._scores(model, x)
        return [
            (i, PredictedResult(label=model.classes[int(row.argmax())]))
            for (i, _), row in zip(queries, ll)
        ]


class VoteServing(LServing):
    """Majority vote over per-algorithm labels; ties go to the first
    algorithm's answer (the reference example's serving combines multiple
    algorithm outputs — LServing.serve sees one P per algorithm)."""

    def serve(self, query: Query, predictions: Sequence[PredictedResult]) -> PredictedResult:
        if not predictions:
            raise ValueError("no predictions to serve")
        votes = Counter(p.label for p in predictions)
        top = max(votes.values())
        for p in predictions:  # first algorithm wins ties
            if votes[p.label] == top:
                return p
        raise AssertionError("unreachable")


# -- engine factory ---------------------------------------------------------

class ClassificationEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            DataSource,
            IdentityPreparator,
            {"mlp": MLPAlgorithm, "nb": NaiveBayesAlgorithm, "": MLPAlgorithm},
            {"first": FirstServing, "vote": VoteServing, "": FirstServing},
        )
