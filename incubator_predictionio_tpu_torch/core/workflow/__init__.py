"""Train and evaluation workflow of the port (counterpart of
``incubator_predictionio_tpu/core/workflow``): ``run_train``,
``run_evaluation`` and ``create_workflow``."""
