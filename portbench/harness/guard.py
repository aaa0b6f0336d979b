"""The check that the run loaded neither JAX nor the JAX package.

Modules are compared by their whole top-level name (the part before the
first dot): the port's package name begins with the JAX package's.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "luminary_tpu"})


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)
