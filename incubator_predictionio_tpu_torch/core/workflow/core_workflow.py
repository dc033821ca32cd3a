"""Core workflow — drives one train or evaluation run.

Counterpart of ``incubator_predictionio_tpu/core/workflow/core_workflow.py``
(reference workflow/CoreWorkflow.scala:45-165, CleanupFunctions.scala:42-65):
:class:`CleanupFunctions`, :func:`run_train` and :func:`run_evaluation`.
The run happens in-process on a :class:`DeviceContext` (the card unless the
caller passes another); failed runs are marked FAILED (EVALFAILED), as in
the JAX package.
"""

from __future__ import annotations

import datetime as _dt
import logging
import traceback
from dataclasses import replace
from typing import Callable, Optional, Sequence

from incubator_predictionio_tpu_torch.core.controller import (
    Engine,
    EngineParams,
    WorkflowParams,
)
from incubator_predictionio_tpu_torch.core.evaluator import Evaluation
from incubator_predictionio_tpu_torch.data.storage.base import (
    EngineInstance,
    EvaluationInstance,
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
    the instance id.

    In a multi-process job every process trains (the collectives need all
    of them), but only process 0 touches storage — the single-Spark-driver
    role (``DeviceContext.is_primary``); secondaries return
    ``"<secondary>"``. The context is stopped at the end (a multi-process
    context leaves its process group)."""
    storage = storage or get_storage()
    instances = storage.get_meta_data_engine_instances()
    ctx = ctx or DeviceContext.create()
    primary = ctx.is_primary
    if primary:
        instance_id = engine_instance.id or instances.insert(engine_instance)
        if engine_instance.id:
            instances.update(engine_instance)
    else:
        instance_id = engine_instance.id or "<secondary>"
    try:
        models = engine.train(ctx, engine_params, params)
        hooks = getattr(ctx, "dist_hooks", None)
        if hooks is not None:  # a supervised member: no collective follows
            hooks.collectives_done()
        if primary:
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
        if primary:
            inst = instances.get(instance_id)
            if inst is not None:
                instances.update(replace(inst, status="FAILED", end_time=_now()))
        logger.error("training failed:\n%s", traceback.format_exc())
        raise
    finally:
        CleanupFunctions.run()
        ctx.stop()


def run_evaluation(
    evaluation: Evaluation,
    engine_params_list: Sequence[EngineParams],
    evaluation_instance: EvaluationInstance,
    params: WorkflowParams = WorkflowParams(),
    storage: Optional[Storage] = None,
    ctx: Optional[DeviceContext] = None,
):
    """Evaluate all variants, store results on the instance
    (CoreWorkflow.runEvaluation :104-165 + EvaluationWorkflow.scala:34).
    Returns (instance_id, evaluator result)."""
    if evaluation.engine is None or evaluation.evaluator is None:
        raise ValueError("Evaluation must define engine and evaluator (engine_metric=…)")
    storage = storage or get_storage()
    ctx = ctx or DeviceContext.create()
    # multi-process eval: every process computes (identical query set,
    # replicated models → identical metrics); only the primary writes rows
    primary = ctx.is_primary
    instances = storage.get_meta_data_evaluation_instances()
    if primary:
        instance_id = evaluation_instance.id or instances.insert(evaluation_instance)
        if evaluation_instance.id:
            instances.update(evaluation_instance)
    else:
        instance_id = "<secondary>"
    try:
        eval_data_set = evaluation.engine.batch_eval(ctx, list(engine_params_list), params)
        result = evaluation.evaluator.evaluate(ctx, evaluation, eval_data_set, params)
        if primary:
            inst = instances.get(instance_id)
            if not result.no_save:
                instances.update(
                    replace(
                        inst,
                        status="EVALCOMPLETED",
                        end_time=_now(),
                        evaluator_results=result.to_one_liner(),
                        evaluator_results_html=result.to_html(),
                        evaluator_results_json=result.to_json(),
                    )
                )
        logger.info("evaluation finished: %s", result.to_one_liner())
        return instance_id, result
    except Exception:
        if primary:
            inst = instances.get(instance_id)
            if inst is not None:
                instances.update(replace(inst, status="EVALFAILED", end_time=_now()))
        raise
    finally:
        CleanupFunctions.run()
        ctx.stop()
