"""CreateWorkflow — the entry point behind ``pio train``.

Counterpart of ``incubator_predictionio_tpu/core/workflow/create_workflow.py``
(reference workflow/CreateWorkflow.scala:136-281), for training:
:class:`WorkflowConfig` and :func:`create_workflow` read the variant, build
the engine and its :class:`EngineInstance`, and run :func:`run_train` on a
:class:`DeviceContext` (the card unless ``WorkflowConfig.device`` names
another). Evaluation raises until ROADMAP.md Queue 1, item 5.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import logging
import os
from typing import Optional

from incubator_predictionio_tpu_torch.core.controller import (
    Engine,
    WorkflowParams,
    resolve_engine_factory,
    variant_from_file,
)
from incubator_predictionio_tpu_torch.core.workflow.core_workflow import run_train
from incubator_predictionio_tpu_torch.data.storage.base import EngineInstance
from incubator_predictionio_tpu_torch.data.storage.registry import (
    Storage,
    storage_env_vars,
)
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class WorkflowConfig:
    """Flags of the CreateWorkflow main (CreateWorkflow.scala:77-134).
    ``device`` takes the place of the reference's mesh flags: None is the
    card, ``"cpu"`` runs on the CPU."""

    engine_variant: str = "engine.json"  # path to variant JSON
    engine_id: Optional[str] = None
    engine_version: Optional[str] = None
    evaluation_class: Optional[str] = None  # evaluation raises until item 5
    batch: str = ""
    verbose: bool = False
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False
    device: Optional[str] = None


def _workflow_params(config: WorkflowConfig) -> WorkflowParams:
    return WorkflowParams(
        batch=config.batch,
        verbose=3 if config.verbose else 0,
        skip_sanity_check=config.skip_sanity_check,
        stop_after_read=config.stop_after_read,
        stop_after_prepare=config.stop_after_prepare,
    )


def create_workflow(config: WorkflowConfig, storage: Optional[Storage] = None,
                    ctx: Optional[DeviceContext] = None) -> str:
    """Run a train; returns the engine instance id."""
    if config.evaluation_class:
        raise NotImplementedError(
            "evaluation is not ported yet; it comes with the other templates "
            "(ROADMAP.md Queue 1, item 5)")
    return _run_train(config, storage, ctx)


def _run_train(config: WorkflowConfig, storage: Optional[Storage],
               ctx: Optional[DeviceContext]) -> str:
    variant = variant_from_file(config.engine_variant)
    factory_path = variant.get("engineFactory")
    if not factory_path:
        raise ValueError(f"{config.engine_variant} has no engineFactory key")
    engine = resolve_engine_factory(factory_path)()
    if not isinstance(engine, Engine):
        raise TypeError(f"engineFactory {factory_path} did not produce an Engine")
    engine_params = engine.engine_params_from_variant(variant)
    instance = EngineInstance(
        id="",
        status="INIT",
        start_time=_dt.datetime.now(_dt.timezone.utc),
        end_time=None,
        engine_id=config.engine_id or variant.get("id", "default"),
        engine_version=config.engine_version or variant.get("version", "1"),
        engine_variant=os.path.abspath(config.engine_variant),
        engine_factory=factory_path,
        batch=config.batch,
        env=storage_env_vars(),
        data_source_params=_stage_json(variant, "datasource"),
        preparator_params=_stage_json(variant, "preparator"),
        algorithms_params=json.dumps(variant.get("algorithms", [])),
        serving_params=_stage_json(variant, "serving"),
    )
    logger.info("training %s (factory %s)", instance.engine_id, factory_path)
    ctx = ctx or DeviceContext.create(config.device)
    return run_train(engine, engine_params, instance, _workflow_params(config),
                     storage=storage, ctx=ctx)


def _stage_json(variant: dict, key: str) -> str:
    return json.dumps(variant.get(key, {}).get("params", {}) if variant.get(key) else {})
