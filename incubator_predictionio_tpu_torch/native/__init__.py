"""The PIOLOG01 event-log codec (counterpart of
``incubator_predictionio_tpu/native``; the C++ scanner is not ported)."""
