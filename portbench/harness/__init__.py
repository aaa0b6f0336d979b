"""The benchmark's general code: the cell spec, the run of one cell, the
traffic generator, the trace's reduction, the reference and the
comparison. Whatever belongs to one configuration, traffic mix or metric
lies in ``configs/``, ``scenes/``, ``traffic/`` and ``metrics/``."""
