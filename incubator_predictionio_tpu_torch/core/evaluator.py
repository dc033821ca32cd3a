"""Evaluation DSL: Evaluation, EngineParamsGenerator, MetricEvaluator.

Copy of ``incubator_predictionio_tpu/core/evaluator.py`` (controller/
Evaluation.scala:34, EngineParamsGenerator.scala:30,
MetricEvaluator.scala:64-263). An ``Evaluation`` wires an engine to a metric
(+ optional secondary metrics); ``MetricEvaluator`` scores every EngineParams
variant, ranks by the primary metric, and records the winner (best.json).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Optional, Sequence

from incubator_predictionio_tpu_torch.core.base import BaseEvaluator, BaseEvaluatorResult
from incubator_predictionio_tpu_torch.core.controller import Engine, EngineParams, WorkflowParams
from incubator_predictionio_tpu_torch.core.metric import Metric
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext
from incubator_predictionio_tpu_torch.utils.params import params_to_json_dict

logger = logging.getLogger(__name__)


class EngineParamsGenerator:
    """Grid/list of EngineParams variants to tune over
    (controller/EngineParamsGenerator.scala:30)."""

    engine_params_list: Sequence[EngineParams] = ()


@dataclasses.dataclass
class MetricScores:
    score: float
    other_scores: tuple[float, ...] = ()


@dataclasses.dataclass
class MetricEvaluatorResult(BaseEvaluatorResult):
    """(MetricEvaluator.scala:64)"""

    best_score: MetricScores = dataclasses.field(default_factory=lambda: MetricScores(float("nan")))
    best_engine_params: Optional[EngineParams] = None
    best_idx: int = 0
    metric_header: str = ""
    other_metric_headers: tuple[str, ...] = ()
    engine_params_scores: list[tuple[EngineParams, MetricScores]] = dataclasses.field(
        default_factory=list
    )

    def _ep_dict(self, ep: EngineParams) -> dict[str, Any]:
        return {
            "dataSourceParams": [ep.data_source_params[0],
                                 params_to_json_dict(ep.data_source_params[1])],
            "preparatorParams": [ep.preparator_params[0],
                                 params_to_json_dict(ep.preparator_params[1])],
            "algorithmParamsList": [
                [n, params_to_json_dict(p)] for n, p in ep.algorithm_params_list
            ],
            "servingParams": [ep.serving_params[0],
                              params_to_json_dict(ep.serving_params[1])],
        }

    def to_one_liner(self) -> str:
        return f"[{self.best_score.score:.4f}] {self.metric_header}"

    def to_json(self) -> str:
        return json.dumps(
            {
                "metricHeader": self.metric_header,
                "otherMetricHeaders": list(self.other_metric_headers),
                "bestScore": self.best_score.score,
                "bestIdx": self.best_idx,
                "bestEngineParams": (
                    self._ep_dict(self.best_engine_params)
                    if self.best_engine_params is not None
                    else None
                ),
                "results": [
                    {"engineParams": self._ep_dict(ep),
                     "score": ms.score,
                     "otherScores": list(ms.other_scores)}
                    for ep, ms in self.engine_params_scores
                ],
            },
            indent=2,
        )

    def to_html(self) -> str:
        rows = "".join(
            f"<tr><td>{ms.score:.6f}</td><td><pre>{json.dumps(self._ep_dict(ep), indent=1)}"
            f"</pre></td></tr>"
            for ep, ms in self.engine_params_scores
        )
        return (
            f"<h3>{self.metric_header}</h3><p>best: {self.best_score.score:.6f} "
            f"(variant {self.best_idx})</p><table border=1>"
            f"<tr><th>score</th><th>engine params</th></tr>{rows}</table>"
        )


class MetricEvaluator(BaseEvaluator):
    """Scores variants, picks the best by the primary metric
    (MetricEvaluator.evaluateBase, MetricEvaluator.scala:218)."""

    def __init__(
        self,
        metric: Metric,
        other_metrics: Sequence[Metric] = (),
        output_path: Optional[str] = None,
    ):
        super().__init__()
        self.metric = metric
        self.other_metrics = list(other_metrics)
        self.output_path = output_path  # best.json target (saveEngineJson :193)

    def evaluate(
        self,
        ctx: DeviceContext,
        evaluation: "Evaluation",
        engine_eval_data_set: Sequence[tuple[EngineParams, Any]],
        params: WorkflowParams,
    ) -> MetricEvaluatorResult:
        scores: list[tuple[EngineParams, MetricScores]] = []
        for ep, eval_data in engine_eval_data_set:
            ms = MetricScores(
                self.metric.calculate(ctx, eval_data),
                tuple(m.calculate(ctx, eval_data) for m in self.other_metrics),
            )
            logger.info("variant score: %s", ms.score)
            scores.append((ep, ms))
        if not scores:
            raise ValueError("no engine params variants were evaluated")
        def rank_key(t):
            score = t[1][1].score
            # NaN-safe: an undefined score (e.g. an Option metric that
            # skipped every row) must never beat a defined one — max()
            # would otherwise keep a leading NaN because `x > nan` is
            # always False
            if score != score:
                return float("-inf")
            return score if self.metric.is_larger_better else -score

        best_idx, (best_ep, best_ms) = max(enumerate(scores), key=rank_key)
        result = MetricEvaluatorResult(
            best_score=best_ms,
            best_engine_params=best_ep,
            best_idx=best_idx,
            metric_header=self.metric.header,
            other_metric_headers=tuple(m.header for m in self.other_metrics),
            engine_params_scores=scores,
        )
        if self.output_path:
            os.makedirs(os.path.dirname(os.path.abspath(self.output_path)), exist_ok=True)
            with open(self.output_path, "w") as f:
                json.dump(
                    {"bestEngineParams": result._ep_dict(best_ep), "score": best_ms.score},
                    f,
                    indent=2,
                )
            logger.info("best engine params written to %s", self.output_path)
        return result


class Evaluation:
    """Binds an engine to an evaluator (controller/Evaluation.scala:34).

    Subclass and set ``engine_metric = (engine, metric)`` (the reference DSL)
    or set ``engine`` + ``evaluator`` directly."""

    engine: Optional[Engine] = None
    evaluator: Optional[MetricEvaluator] = None

    _engine_metric: Optional[tuple[Engine, Metric]] = None

    @property
    def engine_metric(self):
        return self._engine_metric

    @engine_metric.setter
    def engine_metric(self, value: tuple[Engine, Metric]):
        engine, metric = value
        self._engine_metric = value
        self.engine = engine
        self.evaluator = MetricEvaluator(metric)

    def engine_metrics(self, engine: Engine, metric: Metric,
                       other_metrics: Sequence[Metric] = (),
                       output_path: Optional[str] = None) -> None:
        """``engineMetrics = (engine, metric, otherMetrics)`` form."""
        self.engine = engine
        self.evaluator = MetricEvaluator(metric, other_metrics, output_path)
