"""DASE stage SPI, controller API and evaluation DSL of the port
(counterpart of ``incubator_predictionio_tpu/core``)."""

from incubator_predictionio_tpu_torch.core.base import (
    BaseAlgorithm,
    BaseDataSource,
    BaseEngine,
    BaseEvaluator,
    BaseEvaluatorResult,
    BasePreparator,
    BaseServing,
    SanityCheck,
)
from incubator_predictionio_tpu_torch.core.controller import (
    AverageServing,
    Engine,
    EngineFactory,
    EngineParams,
    FirstServing,
    IdentityPreparator,
    LAlgorithm,
    LDataSource,
    LPreparator,
    LServing,
    P2LAlgorithm,
    PAlgorithm,
    PDataSource,
    PersistentModel,
    PersistentModelManifest,
    PPreparator,
    WorkflowParams,
    resolve_engine_factory,
    variant_from_file,
)
from incubator_predictionio_tpu_torch.core.evaluator import (
    EngineParamsGenerator,
    Evaluation,
    MetricEvaluator,
    MetricEvaluatorResult,
)
from incubator_predictionio_tpu_torch.core.metric import (
    AverageMetric,
    Metric,
    OptionAverageMetric,
    OptionStdevMetric,
    StdevMetric,
    SumMetric,
    ZeroMetric,
)
from incubator_predictionio_tpu_torch.utils.params import EmptyParams, Params

__all__ = [
    "AverageMetric", "AverageServing", "BaseAlgorithm", "BaseDataSource",
    "BaseEngine", "BaseEvaluator", "BaseEvaluatorResult", "BasePreparator",
    "BaseServing", "EmptyParams", "Engine", "EngineFactory", "EngineParams",
    "EngineParamsGenerator", "Evaluation", "FirstServing",
    "IdentityPreparator", "LAlgorithm", "LDataSource", "LPreparator",
    "LServing", "Metric", "MetricEvaluator", "MetricEvaluatorResult",
    "OptionAverageMetric", "OptionStdevMetric", "P2LAlgorithm", "PAlgorithm",
    "PDataSource", "PPreparator", "Params", "PersistentModel",
    "PersistentModelManifest", "SanityCheck", "StdevMetric", "SumMetric",
    "WorkflowParams", "ZeroMetric", "resolve_engine_factory",
    "variant_from_file",
]
