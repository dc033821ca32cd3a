"""Core workflow — drives one train run.

Counterpart of ``incubator_predictionio_tpu/core/workflow/core_workflow.py``
(reference workflow/CoreWorkflow.scala:45-102, CleanupFunctions.scala:42-65)
cut to training: :class:`CleanupFunctions` and :func:`run_train`. The run
happens in-process on a :class:`DeviceContext` (the card unless the caller
passes another); failed runs are marked FAILED, as in the JAX package.
Evaluation comes with ROADMAP.md Queue 1, item 5 part 4.
"""

from __future__ import annotations

import datetime as _dt
import logging
import traceback
from dataclasses import replace
from typing import Callable, Optional

from incubator_predictionio_tpu_torch.core.controller import (
    Engine,
    EngineParams,
    WorkflowParams,
)
from incubator_predictionio_tpu_torch.data.storage.base import (
    EngineInstance,
    Model,
)
from incubator_predictionio_tpu_torch.data.storage.registry import (
    Storage,
    get_storage,
)
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext
from incubator_predictionio_tpu_torch.utils.serialization import serialize_model

logger = logging.getLogger(__name__)


class CleanupFunctions:
    """Global finally-block hooks (CleanupFunctions.scala:42-65)."""

    _fns: list[Callable[[], None]] = []

    @classmethod
    def add(cls, fn: Callable[[], None]) -> None:
        cls._fns.append(fn)

    @classmethod
    def run(cls) -> None:
        for fn in cls._fns:
            try:
                fn()
            except Exception:  # noqa: BLE001 - cleanup must not mask the run error
                logger.exception("cleanup function failed")

    @classmethod
    def clear(cls) -> None:
        cls._fns.clear()


def _now() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


def run_train(
    engine: Engine,
    engine_params: EngineParams,
    engine_instance: EngineInstance,
    params: WorkflowParams = WorkflowParams(),
    storage: Optional[Storage] = None,
    ctx: Optional[DeviceContext] = None,
) -> str:
    """Train, persist the models into MODELDATA, mark the instance
    COMPLETED (CoreWorkflow.runTrain, CoreWorkflow.scala:45-102). Returns
    the instance id."""
    storage = storage or get_storage()
    instances = storage.get_meta_data_engine_instances()
    ctx = ctx or DeviceContext.create()
    instance_id = engine_instance.id or instances.insert(engine_instance)
    if engine_instance.id:
        instances.update(engine_instance)
    try:
        models = engine.train(ctx, engine_params, params)
        persisted = engine.models_for_persistence(
            ctx, models, instance_id, engine_params)
        blob = serialize_model(persisted)
        storage.get_model_data_models().insert(Model(instance_id, blob))
        inst = instances.get(instance_id)
        instances.update(replace(inst, status="COMPLETED", end_time=_now()))
        logger.info("training finished: instance %s (%d bytes of models)",
                    instance_id, len(blob))
        return instance_id
    except Exception:
        inst = instances.get(instance_id)
        if inst is not None:
            instances.update(replace(inst, status="FAILED", end_time=_now()))
        logger.error("training failed:\n%s", traceback.format_exc())
        raise
    finally:
        CleanupFunctions.run()
