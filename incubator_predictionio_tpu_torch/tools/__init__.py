"""Operator tools of the port (counterpart of ``incubator_predictionio_tpu/tools``)."""
