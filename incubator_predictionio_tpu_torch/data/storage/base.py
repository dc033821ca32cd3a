"""Storage contracts the deploy path reads: engine instances and model blobs.

Counterpart of ``incubator_predictionio_tpu/data/storage/base.py``, cut to
:class:`EngineInstance`, :class:`Model`, :class:`EngineInstancesStore`,
:class:`ModelsStore` and :class:`StorageClient`. The event store, the other
metadata DAOs and their dump/load contract come with the training slice
(ROADMAP.md).
"""

from __future__ import annotations

import abc
import datetime as _dt
from dataclasses import dataclass, field
from typing import Any, Optional


class StorageError(Exception):
    """Raised on backend failures (reference StorageException)."""


@dataclass(frozen=True)
class EngineInstance:
    """One train run's metadata (EngineInstances.scala:35-50)."""
    id: str
    status: str  # INIT | TRAINING | COMPLETED | FAILED
    start_time: _dt.datetime
    end_time: Optional[_dt.datetime]
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str
    batch: str = ""
    env: dict[str, str] = field(default_factory=dict)
    mesh_conf: dict[str, Any] = field(default_factory=dict)
    data_source_params: str = "{}"
    preparator_params: str = "{}"
    algorithms_params: str = "[]"
    serving_params: str = "{}"


@dataclass(frozen=True)
class Model:
    """Opaque serialized model blob (Models.scala:33)."""
    id: str
    models: bytes


class EngineInstancesStore(abc.ABC):
    """(EngineInstances.scala:55-95)"""

    @abc.abstractmethod
    def insert(self, instance: EngineInstance) -> str:
        """Insert; empty id → auto-generate. Returns the id."""

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EngineInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> list[EngineInstance]: ...

    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> Optional[EngineInstance]:
        """Most recent COMPLETED instance for the (id, version, variant) triple
        (EngineInstances.scala:82)."""
        cands = [
            i
            for i in self.get_all()
            if i.status == "COMPLETED"
            and i.engine_id == engine_id
            and i.engine_version == engine_version
            and i.engine_variant == engine_variant
        ]
        return max(cands, key=lambda i: i.start_time, default=None)


class ModelsStore(abc.ABC):
    """(Models.scala:43-60)"""

    @abc.abstractmethod
    def insert(self, model: Model) -> None: ...

    @abc.abstractmethod
    def get(self, model_id: str) -> Optional[Model]: ...


class StorageClient(abc.ABC):
    """One configured backend instance; provides whichever DAOs it supports
    and raises :class:`NotImplementedError` for the rest."""

    def __init__(self, config: dict[str, str]):
        self.config = config

    def engine_instances(self) -> EngineInstancesStore:
        raise NotImplementedError(f"{type(self).__name__} does not serve METADATA")

    def models(self) -> ModelsStore:
        raise NotImplementedError(f"{type(self).__name__} does not serve MODELDATA")

    def close(self) -> None:
        pass
