"""CreateWorkflow — the entry point behind ``pio train`` / ``pio eval``.

Counterpart of ``incubator_predictionio_tpu/core/workflow/create_workflow.py``
(reference workflow/CreateWorkflow.scala:136-281): :class:`WorkflowConfig`
and :func:`create_workflow`. A train reads the variant, builds the engine
and its :class:`EngineInstance` and runs :func:`run_train`; an evaluation
loads the Evaluation and its EngineParamsGenerator by class path, wraps a
plain :class:`Engine` in :class:`FastEvalEngine` (the reference's default)
and runs :func:`run_evaluation`. Both run on a :class:`DeviceContext`: the
card unless ``WorkflowConfig.device`` names another. ``distributed=True``
joins the multi-process job the ``PIO_DIST_*`` variables describe (the
``launch`` verb sets them); a train or an evaluation then runs on every
process and only process 0 writes storage (secondaries return
``"<secondary>"``). ``mesh_axes`` names the mesh axes over those
processes (``{"data": 2, "model": 2}``); a train stores the request on
its engine instance's ``mesh_conf``, as the reference does
(:func:`_mesh_conf`, reference create_workflow.py:53-67).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import logging
import os
from typing import Any, Optional

from incubator_predictionio_tpu_torch.core.controller import (
    Engine,
    WorkflowParams,
    load_class,
    resolve_engine_factory,
    variant_from_file,
)
from incubator_predictionio_tpu_torch.core.evaluator import (
    EngineParamsGenerator,
    Evaluation,
)
from incubator_predictionio_tpu_torch.core.workflow.core_workflow import (
    run_evaluation,
    run_train,
)
from incubator_predictionio_tpu_torch.data.storage.base import (
    EngineInstance,
    EvaluationInstance,
)
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
    evaluation_class: Optional[str] = None
    engine_params_generator_class: Optional[str] = None
    batch: str = ""
    verbose: bool = False
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False
    device: Optional[str] = None
    # prefix-memoized tuning evals (FastEvalEngine.scala is the default
    # machinery behind `pio eval`; --no-fast-eval opts out)
    fast_eval: bool = True
    distributed: bool = False  # join a torch.distributed job (launch verb)
    mesh_axes: Optional[dict[str, int]] = None  # replaces --master/spark conf


def _mesh_conf(config: WorkflowConfig) -> dict[str, Any]:
    """WorkflowConfig mesh flags → the mesh_conf dict train and eval share."""
    mesh_conf: dict[str, Any] = {}
    if config.mesh_axes:
        mesh_conf["axes"] = config.mesh_axes
    if config.distributed:
        mesh_conf["distributed"] = True
    return mesh_conf


def _context(config: WorkflowConfig) -> DeviceContext:
    """The run's context: ``config.device``, joined to the launched job
    when ``distributed``, over the requested axes."""
    return DeviceContext.from_conf(_mesh_conf(config) or None, config.device)


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
    """Dispatch a train or evaluation run; returns the instance id."""
    if config.evaluation_class:
        return _run_eval(config, storage, ctx)
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
        mesh_conf=_mesh_conf(config),
        data_source_params=_stage_json(variant, "datasource"),
        preparator_params=_stage_json(variant, "preparator"),
        algorithms_params=json.dumps(variant.get("algorithms", [])),
        serving_params=_stage_json(variant, "serving"),
    )
    logger.info("training %s (factory %s)", instance.engine_id, factory_path)
    ctx = ctx or _context(config)
    # the fault-tolerant mesh's seam (reference create_workflow.py:119-121)
    from incubator_predictionio_tpu_torch.distributed.context import (
        maybe_wrap_distributed,
    )

    ctx = maybe_wrap_distributed(ctx)
    return run_train(engine, engine_params, instance, _workflow_params(config),
                     storage=storage, ctx=ctx)


def _run_eval(config: WorkflowConfig, storage: Optional[Storage],
              ctx: Optional[DeviceContext]) -> str:
    evaluation_obj = load_class(config.evaluation_class)
    evaluation = evaluation_obj() if isinstance(evaluation_obj, type) else evaluation_obj
    if not isinstance(evaluation, Evaluation):
        raise TypeError(f"{config.evaluation_class} is not an Evaluation")
    if config.engine_params_generator_class:
        gen_obj = load_class(config.engine_params_generator_class)
        generator = gen_obj() if isinstance(gen_obj, type) else gen_obj
    elif isinstance(evaluation, EngineParamsGenerator):
        generator = evaluation  # an Evaluation with EngineParamsGenerator mixed in
    else:
        raise ValueError("evaluation requires an EngineParamsGenerator")
    if (config.fast_eval and evaluation.engine is not None
            and type(evaluation.engine) is Engine):
        # tuning evals share pipeline prefixes across variants: memoize
        # datasource/prepare/train per distinct params prefix
        # (FastEvalEngine.scala:46-313 is the reference's default machinery);
        # imported here so that importing the CLI imports no training stack
        from incubator_predictionio_tpu_torch.core.fast_eval import FastEvalEngine

        evaluation.engine = FastEvalEngine.from_engine(evaluation.engine)
    instance = EvaluationInstance(
        id="",
        status="INIT",
        start_time=_dt.datetime.now(_dt.timezone.utc),
        end_time=None,
        evaluation_class=config.evaluation_class,
        engine_params_generator_class=config.engine_params_generator_class or "",
        batch=config.batch,
        env=storage_env_vars(),
    )
    # under launch every process evaluates (sharded read_eval, the held-out
    # queries allgathered, data-parallel fits); only process 0 writes
    ctx = ctx or _context(config)
    instance_id, _ = run_evaluation(
        evaluation,
        list(generator.engine_params_list),
        instance,
        _workflow_params(config),
        storage=storage,
        ctx=ctx,
    )
    return instance_id


def _stage_json(variant: dict, key: str) -> str:
    return json.dumps(variant.get(key, {}).get("params", {}) if variant.get(key) else {})
