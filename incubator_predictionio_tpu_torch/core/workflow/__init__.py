"""Train, evaluation and batch-prediction workflow of the port (counterpart
of ``incubator_predictionio_tpu/core/workflow``)."""

from incubator_predictionio_tpu_torch.core.workflow.batch_predict import (
    BatchPredictConfig,
    part_path,
    run_batch_predict,
)
from incubator_predictionio_tpu_torch.core.workflow.core_workflow import (
    CleanupFunctions,
    run_evaluation,
    run_train,
)
from incubator_predictionio_tpu_torch.core.workflow.create_workflow import (
    WorkflowConfig,
    create_workflow,
)

__all__ = [
    "BatchPredictConfig",
    "CleanupFunctions",
    "WorkflowConfig",
    "create_workflow",
    "part_path",
    "run_batch_predict",
    "run_evaluation",
    "run_train",
]
