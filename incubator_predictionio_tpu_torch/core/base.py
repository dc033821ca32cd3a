"""Base DASE SPI — the stage types the deploy path instantiates.

Counterpart of ``incubator_predictionio_tpu/core/base.py``. The execution
context is a :class:`~incubator_predictionio_tpu_torch.parallel.mesh.DeviceContext`
(``ctx``) where the reference passes a ``MeshContext``. The evaluator SPI
comes with the evaluation slice (ROADMAP.md Queue 1, item 5).
"""

from __future__ import annotations

import abc
from typing import Generic, Optional, Sequence, Type, TypeVar

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
