"""Multi-device sample distribution (port of ``luminary_tpu/parallel``)."""
