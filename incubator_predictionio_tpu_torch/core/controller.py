"""Controller API — the deploy surface template authors see.

Counterpart of ``incubator_predictionio_tpu/core/controller.py``: the stage
flavors, the PersistentModel SPI, :class:`EngineParams`, :class:`Engine`
(``train`` with the sanity checks and :class:`WorkflowParams`,
``models_for_persistence``, ``prepare_deploy``, ``serving_and_algorithms``,
``engine_params_from_variant``), :class:`EngineFactory` and the import-path
resolution of factories. Evaluation comes with ROADMAP.md Queue 1, item 5
part 4.

Flavors (the reference's P / L / P2L stages, controller.py:88-147): a P
stage's data and model may live on the card; an L stage works on host
objects; a P2L algorithm trains on the card and keeps a host model (the
classification MLP).
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import Any, Callable, Generic, Sequence, Union

from incubator_predictionio_tpu_torch.core.base import (
    A,
    BaseAlgorithm,
    BaseDataSource,
    BasePreparator,
    BaseServing,
    EI,
    M,
    SanityCheck,
    P,
    PD,
    Q,
    TD,
    doer,
)
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext
from incubator_predictionio_tpu_torch.utils.params import (
    EmptyParams,
    Params,
    params_from_json,
)

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Workflow params and sanity checks
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WorkflowParams:
    """(workflow/WorkflowParams.scala:29-45)"""

    batch: str = ""
    verbose: int = 0
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False


class StopAfterReadInterruption(Exception):
    """Raised when --stop-after-read is requested (Engine.scala:664-668)."""


class StopAfterPrepareInterruption(Exception):
    """Raised when --stop-after-prepare is requested (Engine.scala:680-684)."""


def _sanity_check(obj: Any, label: str, params: WorkflowParams) -> None:
    if params.skip_sanity_check:
        return
    if isinstance(obj, SanityCheck):
        logger.info("sanity check: %s", label)
        obj.sanity_check()


# ---------------------------------------------------------------------------
# Stage flavors
# ---------------------------------------------------------------------------

class PDataSource(BaseDataSource[TD, EI, Q, A]):
    """Parallel data source (controller/PDataSource.scala:37)."""


class LDataSource(BaseDataSource[TD, EI, Q, A]):
    """Local data source (controller/LDataSource.scala:38)."""


class PPreparator(BasePreparator[TD, PD]):
    """(controller/PPreparator.scala:33)"""


class LPreparator(BasePreparator[TD, PD]):
    """(controller/LPreparator.scala:36)"""


class IdentityPreparator(BasePreparator[TD, TD]):
    """Pass-through preparator (controller/IdentityPreparator.scala:32)."""

    def prepare(self, ctx: DeviceContext, td: TD) -> TD:
        return td


class PAlgorithm(BaseAlgorithm[PD, M, Q, P]):
    """Parallel algorithm (controller/PAlgorithm.scala:47); must override
    ``batch_predict`` with a vectorized path."""

    def batch_predict(self, model: M, queries: Sequence[tuple[int, Q]]) -> list[tuple[int, P]]:
        raise NotImplementedError(
            "PAlgorithm requires a vectorized batch_predict for evaluation"
        )


class LAlgorithm(BaseAlgorithm[PD, M, Q, P]):
    """Local algorithm (controller/LAlgorithm.scala:45)."""


class P2LAlgorithm(BaseAlgorithm[PD, M, Q, P]):
    """Train on the card, keep a local (host) model
    (controller/P2LAlgorithm.scala:46)."""


class LServing(BaseServing[Q, P]):
    """(controller/LServing.scala:30)"""


class FirstServing(LServing[Q, P]):
    """Serve the first algorithm's prediction (controller/LFirstServing.scala:28)."""

    def serve(self, query: Q, predictions: Sequence[P]) -> P:
        return predictions[0]


class AverageServing(LServing[Q, float]):
    """Average numeric predictions (controller/LAverageServing.scala:28)."""

    def serve(self, query: Q, predictions: Sequence[float]) -> float:
        return sum(predictions) / len(predictions)


# ---------------------------------------------------------------------------
# Persistent model SPI
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PersistentModelManifest:
    """Marker persisted in place of the model blob when the model saved itself
    (workflow/PersistentModelManifest.scala:21)."""

    class_path: str  # "module:ClassName" import path


class PersistentModel:
    """Custom model persistence SPI (controller/PersistentModel.scala:67-100).

    ``save`` returning False falls back to default pickling; a model that
    saves itself also provides a classmethod ``load(model_id, params, ctx)``."""

    def save(self, model_id: str, params: Params, ctx: DeviceContext) -> bool:
        raise NotImplementedError

    @classmethod
    def load(cls, model_id: str, params: Params, ctx: DeviceContext) -> "PersistentModel":
        raise NotImplementedError


def class_path(cls: type) -> str:
    return f"{cls.__module__}:{cls.__qualname__}"


def load_class(path: str) -> type:
    """Import a "module:Qualified.Name" (or dotted) path."""
    import importlib

    module_name, _, qualname = path.partition(":")
    if not qualname:
        module_name, _, qualname = path.rpartition(".")
    obj: Any = importlib.import_module(module_name)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


# ---------------------------------------------------------------------------
# EngineParams
# ---------------------------------------------------------------------------

NamedParams = tuple[str, Params]


def _named(p: Union[Params, NamedParams, None]) -> NamedParams:
    if p is None:
        return ("", EmptyParams())
    if isinstance(p, tuple):
        return p
    return ("", p)


@dataclasses.dataclass(frozen=True)
class EngineParams:
    """Named parameters for every stage (controller/EngineParams.scala:35)."""

    data_source_params: NamedParams = ("", EmptyParams())
    preparator_params: NamedParams = ("", EmptyParams())
    algorithm_params_list: tuple[NamedParams, ...] = ()
    serving_params: NamedParams = ("", EmptyParams())

    @staticmethod
    def create(
        data_source: Union[Params, NamedParams, None] = None,
        preparator: Union[Params, NamedParams, None] = None,
        algorithms: Sequence[Union[Params, NamedParams]] = (),
        serving: Union[Params, NamedParams, None] = None,
    ) -> "EngineParams":
        return EngineParams(
            data_source_params=_named(data_source),
            preparator_params=_named(preparator),
            algorithm_params_list=tuple(_named(a) for a in algorithms),
            serving_params=_named(serving),
        )


ClassMap = dict[str, type]


def _class_map(spec: Union[type, dict[str, type]]) -> ClassMap:
    if isinstance(spec, dict):
        return dict(spec)
    return {"": spec}


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class Engine(Generic[TD, EI, Q, P, A]):
    """Four class-maps chained into train/deploy flows
    (controller/Engine.scala:82-88)."""

    def __init__(
        self,
        data_source_class_map: Union[type, ClassMap],
        preparator_class_map: Union[type, ClassMap],
        algorithm_class_map: Union[type, ClassMap],
        serving_class_map: Union[type, ClassMap],
    ):
        self.data_source_class_map = _class_map(data_source_class_map)
        self.preparator_class_map = _class_map(preparator_class_map)
        self.algorithm_class_map = _class_map(algorithm_class_map)
        self.serving_class_map = _class_map(serving_class_map)

    def _pick(self, class_map: ClassMap, name: str, stage: str) -> type:
        if name not in class_map:
            raise KeyError(
                f"engine has no {stage} named {name!r}; available: {sorted(class_map)}"
            )
        return class_map[name]

    def _instantiate(self, engine_params: EngineParams):
        ds_name, ds_params = engine_params.data_source_params
        prep_name, prep_params = engine_params.preparator_params
        serv_name, serv_params = engine_params.serving_params
        data_source = doer(self._pick(self.data_source_class_map, ds_name, "datasource"), ds_params)
        preparator = doer(self._pick(self.preparator_class_map, prep_name, "preparator"), prep_params)
        algo_list = engine_params.algorithm_params_list or (("", EmptyParams()),)
        algorithms = [
            doer(self._pick(self.algorithm_class_map, name, "algorithm"), params)
            for name, params in algo_list
        ]
        serving = doer(self._pick(self.serving_class_map, serv_name, "serving"), serv_params)
        return data_source, preparator, algorithms, serving

    def train(
        self,
        ctx: DeviceContext,
        engine_params: EngineParams,
        params: WorkflowParams = WorkflowParams(),
    ) -> list[Any]:
        """read → prepare → train each algorithm, with the sanity checks
        and the stop-after flags (object Engine.train, Engine.scala:623-712)."""
        data_source, preparator, algorithms, _ = self._instantiate(engine_params)
        td = data_source.read_training(ctx)
        _sanity_check(td, "training data", params)
        if params.stop_after_read:
            raise StopAfterReadInterruption()
        pd = preparator.prepare(ctx, td)
        _sanity_check(pd, "prepared data", params)
        if params.stop_after_prepare:
            raise StopAfterPrepareInterruption()
        models = []
        for i, algo in enumerate(algorithms):
            logger.info("training algorithm %d/%d: %s", i + 1, len(algorithms),
                        type(algo).__name__)
            model = algo.train(ctx, pd)
            _sanity_check(model, f"model[{i}]", params)
            models.append(model)
        return models

    def models_for_persistence(
        self,
        ctx: DeviceContext,
        models: Sequence[Any],
        instance_id: str,
        engine_params: EngineParams,
    ) -> list[Any]:
        """Each model's persisted form (Engine.makeSerializableModels,
        Engine.scala:284): a :class:`PersistentModel` that saves itself
        leaves a manifest, the others their ``make_persistent_model``."""
        _, _, algorithms, _ = self._instantiate(engine_params)
        out = []
        for i, (algo, model) in enumerate(zip(algorithms, models)):
            if isinstance(model, PersistentModel):
                if model.save(f"{instance_id}_{i}", algo.params, ctx):
                    out.append(PersistentModelManifest(class_path(type(model))))
                    continue
            out.append(algo.make_persistent_model(ctx, f"{instance_id}_{i}", model))
        return out

    def prepare_deploy(
        self,
        ctx: DeviceContext,
        engine_params: EngineParams,
        persisted_models: Sequence[Any],
        instance_id: str,
    ) -> list[Any]:
        """Persisted forms → live models (Engine.prepareDeploy, Engine.scala:198-258)."""
        _, _, algorithms, _ = self._instantiate(engine_params)
        retrain_needed = any(m is None for m in persisted_models)
        retrained: list[Any] = []
        if retrain_needed:
            logger.warning(
                "some models are not persistable; retraining at deploy "
                "(reference tradeoff Engine.scala:210-232)"
            )
            retrained = self.train(ctx, engine_params)
        out = []
        for i, (algo, persisted) in enumerate(zip(algorithms, persisted_models)):
            if isinstance(persisted, PersistentModelManifest):
                model_cls = load_class(persisted.class_path)
                out.append(model_cls.load(f"{instance_id}_{i}", algo.params, ctx))
            elif persisted is None:
                out.append(retrained[i])
            else:
                out.append(persisted)
        return out

    def serving_and_algorithms(self, engine_params: EngineParams):
        """Instantiated (algorithms, serving) for the query path (CreateServer)."""
        _, _, algorithms, serving = self._instantiate(engine_params)
        return algorithms, serving

    def engine_params_from_variant(self, variant: dict[str, Any]) -> EngineParams:
        """Variant JSON → EngineParams (Engine.jValueToEngineParams :355)."""
        def stage_params(key: str, class_map: ClassMap) -> NamedParams:
            spec = variant.get(key)
            if spec is None:
                return ("", EmptyParams())
            name = spec.get("name", "")
            cls = self._pick(class_map, name, key)
            return (name, params_from_json(getattr(cls, "params_class", None), spec.get("params")))

        algo_specs = variant.get("algorithms")
        if algo_specs is None:
            algos: tuple[NamedParams, ...] = ()
        else:
            algos = tuple(
                (
                    spec.get("name", ""),
                    params_from_json(
                        getattr(
                            self._pick(self.algorithm_class_map, spec.get("name", ""), "algorithm"),
                            "params_class",
                            None,
                        ),
                        spec.get("params"),
                    ),
                )
                for spec in algo_specs
            )
        return EngineParams(
            data_source_params=stage_params("datasource", self.data_source_class_map),
            preparator_params=stage_params("preparator", self.preparator_class_map),
            algorithm_params_list=algos,
            serving_params=stage_params("serving", self.serving_class_map),
        )


class EngineFactory:
    """Template entry point (controller/EngineFactory.scala:31). Subclass and
    implement ``apply``; the variant JSON's ``engineFactory`` key names this
    class (or a plain callable) by import path."""

    def apply(self) -> Engine:
        raise NotImplementedError

    def __call__(self) -> Engine:
        return self.apply()


def resolve_engine_factory(path: str) -> Callable[[], Engine]:
    """Import an engineFactory path → zero-arg callable returning an Engine
    (WorkflowUtils.getEngine, WorkflowUtils.scala:53-118)."""
    obj = load_class(path)
    if isinstance(obj, type):
        inst = obj()
        if isinstance(inst, EngineFactory):
            return inst
        if isinstance(inst, Engine):
            return lambda: inst
        raise TypeError(f"{path} instantiates {type(inst)}, not an Engine/EngineFactory")
    if isinstance(obj, EngineFactory) or callable(obj):
        return obj
    raise TypeError(f"{path} is not an engine factory")


def variant_from_file(path: str) -> dict[str, Any]:
    """Load an engine-variant JSON file (engine.json)."""
    with open(path) as f:
        return json.load(f)
