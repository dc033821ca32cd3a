"""Train workflow of the port (counterpart of
``incubator_predictionio_tpu/core/workflow``): ``run_train`` and
``create_workflow``."""
