"""Base DASE SPI — the six stage types plus instantiation.

Counterpart of ``incubator_predictionio_tpu/core/base.py``. The execution
context is a :class:`~incubator_predictionio_tpu_torch.parallel.mesh.DeviceContext`
(``ctx``) where the reference passes a ``MeshContext``. Type parameters
follow the reference's naming: TD training data, EI evaluation info, PD
prepared data, Q query, P prediction, A actual.
"""

from __future__ import annotations

import abc
from typing import Any, Generic, Optional, Sequence, Type, TypeVar

from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext
from incubator_predictionio_tpu_torch.utils.params import EmptyParams, Params

TD = TypeVar("TD")
EI = TypeVar("EI")
PD = TypeVar("PD")
Q = TypeVar("Q")
P = TypeVar("P")
A = TypeVar("A")
M = TypeVar("M")  # model


class AbstractDoer:
    """Common base for all stage implementations (core/AbstractDoer.scala:29).
    Stage classes are constructed with exactly one argument: their params."""

    params_class: Optional[Type[Params]] = None

    def __init__(self, params: Params = EmptyParams()):
        self.params = params


def doer(cls: Type[AbstractDoer], params: Params) -> AbstractDoer:
    """Instantiate a stage from its class + params (Doer, AbstractDoer.scala:41-66)."""
    return cls(params)


class SanityCheck(abc.ABC):
    """Opt-in hook: TD/PD/models implementing this get checked after each
    stage (controller/SanityCheck.scala:30; enforcement Engine.scala:650-706)."""

    @abc.abstractmethod
    def sanity_check(self) -> None:
        """Raise on inconsistent data."""


class BaseDataSource(AbstractDoer, Generic[TD, EI, Q, A]):
    """(core/BaseDataSource.scala:43-55)"""

    @abc.abstractmethod
    def read_training(self, ctx: DeviceContext) -> TD: ...

    def read_eval(self, ctx: DeviceContext) -> list[tuple[TD, EI, list[tuple[Q, A]]]]:
        """Eval folds: (training data, eval info, labeled (query, actual) set)."""
        return []


class BasePreparator(AbstractDoer, Generic[TD, PD]):
    """(core/BasePreparator.scala:40)"""

    @abc.abstractmethod
    def prepare(self, ctx: DeviceContext, td: TD) -> PD: ...


class BaseAlgorithm(AbstractDoer, Generic[PD, M, Q, P]):
    """(core/BaseAlgorithm.scala:69-126)"""

    #: Declare True when ``predict``/``batch_predict`` tolerate concurrent
    #: calls from several threads; the query server overlaps dispatches only
    #: when every deployed algorithm declares it.
    serving_thread_safe: bool = False

    @abc.abstractmethod
    def train(self, ctx: DeviceContext, pd: PD) -> M: ...

    @abc.abstractmethod
    def predict(self, model: M, query: Q) -> P: ...

    def batch_predict(self, model: M, queries: Sequence[tuple[int, Q]]) -> list[tuple[int, P]]:
        """Bulk scoring. Default: loop; P-flavored algorithms override."""
        return [(i, self.predict(model, q)) for i, q in queries]

    def make_persistent_model(self, ctx: DeviceContext, model_id: str, model: M):
        """The model's persisted form (BaseAlgorithm.makePersistentModel):
        the model itself (pickled into MODELDATA), a
        ``PersistentModelManifest`` (it saved itself), or None (retrained at
        deploy)."""
        return model

    def query_class(self) -> Optional[type]:
        """Query type for JSON binding, if the algorithm declares one."""
        return getattr(self, "query_cls", None)


class BaseServing(AbstractDoer, Generic[Q, P]):
    """(core/BaseServing.scala:41-53)"""

    def supplement(self, query: Q) -> Q:
        return query

    @abc.abstractmethod
    def serve(self, query: Q, predictions: Sequence[P]) -> P: ...


class BaseEngine(abc.ABC, Generic[TD, EI, Q, P, A]):
    """(core/BaseEngine.scala:49-95)"""

    @abc.abstractmethod
    def train(self, ctx: DeviceContext, engine_params, params) -> list[Any]: ...

    @abc.abstractmethod
    def eval(
        self, ctx: DeviceContext, engine_params, params
    ) -> list[tuple[EI, list[tuple[Q, P, A]]]]: ...

    def batch_eval(
        self, ctx: DeviceContext, engine_params_list, params
    ) -> list[tuple[Any, list[tuple[EI, list[tuple[Q, P, A]]]]]]:
        """Evaluate a list of EngineParams variants (BaseEngine.batchEval :82)."""
        return [(ep, self.eval(ctx, ep, params)) for ep in engine_params_list]


class BaseEvaluatorResult:
    """(core/BaseEvaluator.scala:60-73)"""

    def to_one_liner(self) -> str:
        return ""

    def to_html(self) -> str:
        return ""

    def to_json(self) -> str:
        return ""

    #: When True, the workflow does not write an EvaluationInstance row
    #: (BaseEvaluator.scala noSave flag).
    no_save: bool = False


R = TypeVar("R", bound=BaseEvaluatorResult)


class BaseEvaluator(AbstractDoer, Generic[EI, Q, P, A, R]):
    """(core/BaseEvaluator.scala:52-58)"""

    @abc.abstractmethod
    def evaluate(
        self,
        ctx: DeviceContext,
        evaluation,
        engine_eval_data_set: list[tuple[Any, list[tuple[EI, list[tuple[Q, P, A]]]]]],
        params,
    ) -> R: ...
