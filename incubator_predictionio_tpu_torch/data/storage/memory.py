"""In-memory storage backend for the deploy path.

Counterpart of ``incubator_predictionio_tpu/data/storage/memory.py``, cut to
the engine-instance and model repositories (``MemEngineInstances``,
``MemModels``) that deploy reads.
"""

from __future__ import annotations

import dataclasses
import threading
import uuid
from typing import Optional

from incubator_predictionio_tpu_torch.data.storage.base import (
    EngineInstance,
    EngineInstancesStore,
    Model,
    ModelsStore,
    StorageClient,
)


class MemEngineInstances(EngineInstancesStore):
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._instances: dict[str, EngineInstance] = {}

    def insert(self, instance: EngineInstance) -> str:
        instance_id = instance.id or uuid.uuid4().hex
        with self._lock:
            self._instances[instance_id] = dataclasses.replace(
                instance, id=instance_id)
        return instance_id

    def get(self, instance_id: str) -> Optional[EngineInstance]:
        return self._instances.get(instance_id)

    def get_all(self) -> list[EngineInstance]:
        return list(self._instances.values())

    def update(self, instance: EngineInstance) -> bool:
        with self._lock:
            if instance.id not in self._instances:
                return False
            self._instances[instance.id] = instance
            return True

    def delete(self, instance_id: str) -> bool:
        with self._lock:
            return self._instances.pop(instance_id, None) is not None


class MemModels(ModelsStore):
    def __init__(self) -> None:
        self._models: dict[str, Model] = {}

    def insert(self, model: Model) -> None:
        self._models[model.id] = model

    def get(self, model_id: str) -> Optional[Model]:
        return self._models.get(model_id)

    def delete(self, model_id: str) -> bool:
        return self._models.pop(model_id, None) is not None


class MemoryStorageClient(StorageClient):
    """Serves the METADATA and MODELDATA repositories from process memory."""

    def __init__(self, config: dict[str, str]):
        super().__init__(config)
        self._engine_instances = MemEngineInstances()
        self._models = MemModels()

    def engine_instances(self) -> EngineInstancesStore:
        return self._engine_instances

    def models(self) -> ModelsStore:
        return self._models
