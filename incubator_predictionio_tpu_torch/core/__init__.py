"""DASE stage SPI and controller API of the port (counterpart of
``incubator_predictionio_tpu/core``)."""

from incubator_predictionio_tpu_torch.core.base import (
    BaseAlgorithm,
    BaseDataSource,
    BasePreparator,
    BaseServing,
    SanityCheck,
)
from incubator_predictionio_tpu_torch.core.controller import (
    Engine,
    EngineFactory,
    EngineParams,
    FirstServing,
    IdentityPreparator,
    LServing,
    PAlgorithm,
    PDataSource,
    PersistentModel,
    PersistentModelManifest,
    WorkflowParams,
    resolve_engine_factory,
    variant_from_file,
)
from incubator_predictionio_tpu_torch.utils.params import EmptyParams, Params

__all__ = [
    "BaseAlgorithm", "BaseDataSource", "BasePreparator", "BaseServing",
    "EmptyParams", "Engine", "EngineFactory", "EngineParams", "FirstServing",
    "IdentityPreparator", "LServing", "PAlgorithm", "PDataSource", "Params",
    "PersistentModel", "PersistentModelManifest", "SanityCheck",
    "WorkflowParams", "resolve_engine_factory", "variant_from_file",
]
