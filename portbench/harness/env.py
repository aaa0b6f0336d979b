"""The process's environment, set before PyTorch is imported: the build and
kernel caches in fixed directories of the checkout's ``build/``, and the
checkout on the import path for the program."""

from __future__ import annotations

import os
import sys

from .spec import BENCH_DIR, ROOT


def prepare() -> None:
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    for p in (ROOT, BENCH_DIR):
        if p not in sys.path:
            sys.path.insert(0, p)
