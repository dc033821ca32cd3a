"""Counterpart of ``incubator_predictionio_tpu/resilience``: the WAL frame
format the streaming dead letters use, and the injectable clock the
distributed tier waits on."""
