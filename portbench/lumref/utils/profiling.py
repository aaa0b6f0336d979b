"""The stage marks of ``render/wavefront.py``.

The reference is never profiled, so a stage opens nothing: the benchmark
reads the program's own stages (``harness/trace.py``)."""

from __future__ import annotations


class StageRanges:
    """``stage(name)`` marks where a stage begins; a no-op here."""

    def __enter__(self):
        return self

    def __call__(self, name: str) -> None:
        pass

    def __exit__(self, *exc):
        return False
