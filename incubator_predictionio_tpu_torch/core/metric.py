"""Metric hierarchy for evaluation (controller/Metric.scala:39-269).

Copy of ``incubator_predictionio_tpu/core/metric.py``. Metrics score
``[(EI, [(Q, P, A)])]`` eval output with numpy on the host, in float64, as
the reference does: eval result sets are query-sized, not training-sized,
and never need the card. ``compare`` semantics (larger is better by
default) are preserved.
"""

from __future__ import annotations

import abc
import math
from typing import Generic, Optional, Sequence

import numpy as np

from incubator_predictionio_tpu_torch.core.base import A, EI, P, Q
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext

EvalDataSet = Sequence[tuple]  # [(EI, [(Q, P, A)])]


class Metric(abc.ABC, Generic[EI, Q, P, A]):
    """(Metric.scala:39). Subclasses define ``calculate``; ``is_larger_better``
    drives variant ranking."""

    is_larger_better: bool = True

    @abc.abstractmethod
    def calculate(self, ctx: DeviceContext, eval_data: EvalDataSet) -> float: ...

    def compare(self, a: float, b: float) -> int:
        if math.isclose(a, b, rel_tol=0.0, abs_tol=0.0) or a == b:
            return 0
        better = a > b if self.is_larger_better else a < b
        return 1 if better else -1

    @property
    def header(self) -> str:
        return type(self).__name__


class QPAMetric(Metric[EI, Q, P, A]):
    """Base for metrics computed per (Q, P, A) row then reduced."""

    @abc.abstractmethod
    def calculate_qpa(self, q: Q, p: P, a: A) -> Optional[float]: ...

    def _scores(self, eval_data: EvalDataSet) -> np.ndarray:
        vals = [
            s
            for _, qpas in eval_data
            for q, p, a in qpas
            if (s := self.calculate_qpa(q, p, a)) is not None
        ]
        return np.asarray(vals, dtype=np.float64)


class AverageMetric(QPAMetric[EI, Q, P, A]):
    """Mean of per-row scores (Metric.scala:99). ``calculate_qpa`` must return
    a float (None is an error here; use OptionAverageMetric to skip rows)."""

    def calculate(self, ctx: DeviceContext, eval_data: EvalDataSet) -> float:
        scores = self._scores(eval_data)
        n = sum(len(qpas) for _, qpas in eval_data)
        if len(scores) != n:
            raise ValueError(
                f"AverageMetric got {n - len(scores)} None scores; "
                "use OptionAverageMetric for skippable rows"
            )
        return float(scores.mean()) if len(scores) else float("nan")


class OptionAverageMetric(QPAMetric[EI, Q, P, A]):
    """Mean over rows with a defined score (Metric.scala:124)."""

    def calculate(self, ctx: DeviceContext, eval_data: EvalDataSet) -> float:
        scores = self._scores(eval_data)
        return float(scores.mean()) if len(scores) else float("nan")


class StdevMetric(QPAMetric[EI, Q, P, A]):
    """Population stdev of scores (Metric.scala:151)."""

    def calculate(self, ctx: DeviceContext, eval_data: EvalDataSet) -> float:
        scores = self._scores(eval_data)
        return float(scores.std()) if len(scores) else float("nan")


class OptionStdevMetric(StdevMetric[EI, Q, P, A]):
    """(Metric.scala:178) — same as StdevMetric; None rows already skipped."""


class SumMetric(QPAMetric[EI, Q, P, A]):
    """Sum of scores (Metric.scala:205)."""

    def calculate(self, ctx: DeviceContext, eval_data: EvalDataSet) -> float:
        return float(self._scores(eval_data).sum())


class ZeroMetric(Metric[EI, Q, P, A]):
    """Always 0 — placeholder (Metric.scala:234)."""

    def calculate(self, ctx: DeviceContext, eval_data: EvalDataSet) -> float:
        return 0.0
