"""Classification template — training and serving.

Counterpart of ``incubator_predictionio_tpu/templates/classification.py``
(the scala-parallel-classification counterpart): the
DataSource reads ``$set`` events on "user" entities carrying numeric
feature properties plus a label property (DataSource.scala reads attr0-2 +
"plan"), queries carry a feature vector and get a predicted label back.

The flagship algorithm is the MLP (``models/mlp.py``) trained on the card;
the "add-algorithm" variant of the reference example is mirrored by
:class:`NaiveBayesAlgorithm` (Gaussian NB over the numeric features: the
fit's segment sums and the scoring pass run as torch ops on the card) plus
:class:`VoteServing` (majority vote across algorithms). ``read_eval``
makes k folds by row position, :class:`Accuracy` and :class:`Precision`
score them, and :class:`AccuracyEvaluation`, :class:`PrecisionEvaluation`
and :class:`CompleteEvaluation` wire them up (the add-algorithm example's
Evaluation.scala, PrecisionEvaluation.scala, CompleteEvaluation.scala).
Under several processes each process reads its user shard
(``_read_sharded``), the MLP fit is data-parallel and the naive Bayes fit
sums the shards' class moments on the host (``_train_sharded``).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from collections import Counter
from typing import Optional, Sequence

import numpy as np
import torch

from incubator_predictionio_tpu_torch.core import (
    AverageMetric,
    Engine,
    EngineFactory,
    EngineParams,
    EngineParamsGenerator,
    Evaluation,
    FirstServing,
    IdentityPreparator,
    LServing,
    MetricEvaluator,
    OptionAverageMetric,
    P2LAlgorithm,
    Params,
    PDataSource,
    SanityCheck,
)
from incubator_predictionio_tpu_torch.data.sharded import (
    data_shard,
    global_row_count,
    global_sum,
    union_label_set,
)
from incubator_predictionio_tpu_torch.data.store import PEventStore
from incubator_predictionio_tpu_torch.models.mlp import (
    MLPClassifier,
    MLPConfig,
    MLPModel,
)
from incubator_predictionio_tpu_torch.models.two_tower import _scatter_rows
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext

logger = logging.getLogger(__name__)

# -- data source ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = "classification"
    attrs: tuple[str, ...] = ("attr0", "attr1", "attr2")
    label: str = "plan"
    eval_k: Optional[int] = None


@dataclasses.dataclass
class TrainingData(SanityCheck):
    """Columnar features/labels (the RDD[LabeledPoint] counterpart)."""

    x: np.ndarray  # [n, d] float32
    y: np.ndarray  # [n] labels (original values)
    # multi-process sharded read: rows are THIS process's entity shard only;
    # n_rows_global is the job-wide count
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
        if data_shard(ctx)[1] > 1:
            return self._read_sharded(ctx)
        return self._read()

    def _read_sharded(self, ctx: DeviceContext) -> TrainingData:
        """classification.py:127-139: each process folds the ``$set``
        events of 1/P of the users (property snapshots are per-entity, so a
        shard's fold is exact; reference counterpart: RDD partition reads)."""
        t0 = time.perf_counter()
        pid, procs = data_shard(ctx)
        td = self._read(n_shards=procs, shard_index=pid)
        n_global = global_row_count(ctx, len(td.x))
        logger.info(
            "sharded read: %d of %d rows (shard %d/%d) in %.3f s",
            len(td.x), n_global, pid, procs, time.perf_counter() - t0)
        return TrainingData(td.x, td.y, rows_are_local=True,
                            n_rows_global=n_global)

    def read_eval(self, ctx: DeviceContext):
        """k-fold split by row position (reference readEval pattern,
        classification.py:142-159)."""
        k = self.params.eval_k
        if not k:
            return []
        td = self._read()
        fold_of = np.arange(len(td.y)) % k
        folds = []
        for fold in range(k):
            train_mask = fold_of != fold
            test_mask = ~train_mask
            train = TrainingData(td.x[train_mask], td.y[train_mask])
            qa = [
                (Query(tuple(map(float, row))), label)
                for row, label in zip(td.x[test_mask], td.y[test_mask])
            ]
            folds.append((train, {"fold": fold}, qa))
        return folds


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
    """classification.py:231 ``_nb_fit``: per-class counts, means and
    variances as segment sums, each segment's rows in one fixed order
    (``models/two_tower.py:_scatter_rows``: a sorted ``index_put_`` on the
    card, so that every fit there sums alike; ``index_add_`` on the CPU)."""
    ones = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    counts = ones.new_empty(n_classes)
    _scatter_rows(counts, y_idx, ones)
    sums = x.new_empty((n_classes, x.shape[1]))
    _scatter_rows(sums, y_idx, x)
    means = sums / counts[:, None]
    # variance as mean squared deviation (E[x²]−E[x]² cancels catastrophically
    # in float32 for large-magnitude/small-spread features), floored at the
    # smoothing so constant columns stay positive
    dev = x - means[y_idx]
    ssd = torch.empty_like(sums)
    _scatter_rows(ssd, y_idx, dev * dev)
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
        """classification.py:279-310: the closed-form fit from the
        processes' summed per-class moments, in float64 on the host, in two
        passes (the means first, then the squared deviations against the
        global means), so the E[x²]−E[x]² cancellation the one-process fit
        avoids stays avoided; the classes are the sorted union of the
        shards' labels, the priors from the global counts."""
        classes = np.asarray(union_label_set(ctx, pd.y.tolist()))
        cls_index = {c: i for i, c in enumerate(classes.tolist())}
        y_idx = np.asarray([cls_index[v] for v in pd.y.tolist()], np.int64)
        c, d = len(classes), pd.x.shape[1] if pd.x.ndim == 2 else 0
        counts = np.zeros(c, np.float64)
        np.add.at(counts, y_idx, 1.0)
        sx = np.zeros((c, d), np.float64)
        np.add.at(sx, y_idx, pd.x.astype(np.float64))
        counts, sx = global_sum(ctx, (counts, sx))
        means = sx / np.maximum(counts[:, None], 1.0)
        dev = pd.x.astype(np.float64) - means[y_idx]
        ssd = np.zeros((c, d), np.float64)
        np.add.at(ssd, y_idx, dev * dev)
        ssd = global_sum(ctx, ssd)
        variances = np.maximum(
            ssd / np.maximum(counts[:, None], 1.0), self.params.var_smoothing)
        log_priors = np.log(counts / counts.sum())
        return NaiveBayesModel(
            classes=classes,
            means=means.astype(np.float32),
            variances=variances.astype(np.float32),
            log_priors=log_priors.astype(np.float32),
        )

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


# -- metric -----------------------------------------------------------------

class Accuracy(AverageMetric):
    """(reference AccuracyMetric in the classification template's Evaluation)"""

    def calculate_qpa(self, q, p: PredictedResult, a) -> float:
        return 1.0 if p.label == a else 0.0


class Precision(OptionAverageMetric):
    """Per-label precision (PrecisionEvaluation.scala:25-45): scored only
    where the PREDICTED label is the target — true positive 1.0, false
    positive 0.0, everything else skipped (None)."""

    def __init__(self, label):
        self.label = label

    @property
    def header(self) -> str:
        return f"Precision(label = {self.label})"

    def calculate_qpa(self, q, p: PredictedResult, a):
        if p.label != self.label:
            return None  # unrelated to this label's precision
        return 1.0 if p.label == a else 0.0


# -- engine factory ---------------------------------------------------------

class ClassificationEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            DataSource,
            IdentityPreparator,
            {"mlp": MLPAlgorithm, "nb": NaiveBayesAlgorithm, "": MLPAlgorithm},
            {"first": FirstServing, "vote": VoteServing, "": FirstServing},
        )


# -- evaluations (Evaluation.scala / PrecisionEvaluation.scala /
#    CompleteEvaluation.scala in the add-algorithm example) -----------------

def _classification_grid(app_name: str, eval_k: int):
    return [
        EngineParams.create(
            data_source=DataSourceParams(app_name=app_name, eval_k=eval_k),
            algorithms=[("mlp", MLPAlgorithmParams(
                hidden_dims=dims, learning_rate=lr, epochs=60))],
        )
        for dims in ((16,), (32, 32))
        for lr in (1e-2, 3e-2)
    ]


class AccuracyEvaluation(Evaluation, EngineParamsGenerator):
    """engineMetric = (ClassificationEngine(), Accuracy()) over a small
    MLP grid (Evaluation.scala:36-41 + EngineParamsList)."""

    def __init__(self, app_name: str = "classification", eval_k: int = 3):
        self.engine = ClassificationEngine().apply()
        self.evaluator = MetricEvaluator(metric=Accuracy())
        self.engine_params_list = _classification_grid(app_name, eval_k)


class PrecisionEvaluation(Evaluation, EngineParamsGenerator):
    """engineMetric = (ClassificationEngine(), Precision(label=1.0))
    (PrecisionEvaluation.scala:42-44)."""

    def __init__(self, app_name: str = "classification", eval_k: int = 3,
                 label=1.0):
        self.engine = ClassificationEngine().apply()
        self.evaluator = MetricEvaluator(metric=Precision(label=label))
        self.engine_params_list = _classification_grid(app_name, eval_k)


class CompleteEvaluation(Evaluation, EngineParamsGenerator):
    """Accuracy + per-label precisions, winner recorded to best.json
    (CompleteEvaluation.scala:24-30: otherMetrics = Precision(0/1/2),
    outputPath = "best.json")."""

    def __init__(self, app_name: str = "classification", eval_k: int = 3,
                 labels=(0.0, 1.0, 2.0), output_path: str = "best.json"):
        self.engine = ClassificationEngine().apply()
        self.evaluator = MetricEvaluator(
            metric=Accuracy(),
            other_metrics=[Precision(label=lb) for lb in labels],
            output_path=output_path,
        )
        self.engine_params_list = _classification_grid(app_name, eval_k)
