"""Storage layer of the port (counterpart of
``incubator_predictionio_tpu/data/storage``): the memory backend of the
engine-instance and model repositories, and the sqlite backend of all
three repositories."""

from incubator_predictionio_tpu_torch.data.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EngineInstancesStore,
    Model,
    ModelsStore,
    StorageClient,
    StorageError,
)
from incubator_predictionio_tpu_torch.data.storage.registry import (
    Storage,
    get_storage,
    use_storage,
)

__all__ = [
    "AccessKey", "App", "Channel", "EngineInstance", "EngineInstancesStore",
    "Model", "ModelsStore",
    "Storage", "StorageClient", "StorageError", "get_storage", "use_storage",
]
