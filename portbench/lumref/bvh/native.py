"""ctypes bridge to the native C++ BVH builder.

Compiles bvh/cpp/bvh_builder.cpp on first use (g++, into the checkout's
gitignored ``build/portbench/bvh/`` directory, never next to the source) and exposes
:func:`build_wide_native`, the 16-wide build the scene pack uses. A missing
toolchain or a failed build raises: there is no other builder to fall back
to, since the port's tables must match the reference's native tree word for
word.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from ..utils.log import info_message

_SRC = os.path.join(os.path.dirname(__file__), "cpp", "bvh_builder.cpp")
# the checkout's build/portbench/bvh, apart from the program's build/bvh
_BUILD = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))),
    "build", "portbench", "bvh")
_LIB = os.path.join(_BUILD, "libbvh.so")

_lock = threading.Lock()
_lib = None


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            os.makedirs(_BUILD, exist_ok=True)
            # build beside the target and rename: parallel test workers
            # may race to build the same library
            tmp = "%s.%d.tmp" % (_LIB, os.getpid())
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, _LIB)
            info_message("built native BVH builder: %s", _LIB)
        lib = ctypes.CDLL(_LIB)
        lib.lum_build_wide.restype = ctypes.c_int
        lib.lum_build_wide.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return _lib


def build_wide_native(corners: np.ndarray, flat_tris: int = 112):
    """Native direct 16-wide build — BVH2 + quality collapse in one C++ pass
    (bvh/cpp/bvh_builder.cpp lum_build_wide). Returns a WideBVH with
    leaf_rows left empty (filled by pack_leaf_rows); raises if the build
    fails.

    flat_tris: subtrees at or below this triangle count are flattened into
    one node of SAH-boundary leaf blocks (kills the thin-node tail the
    greedy python collapse produces). 112 measured best on the tree-tier
    bench (28/56/112/224 sweep, tools logs round 3).
    """
    lib = _load()
    from .wide import WIDE_LEAF, WideBVH

    corners = np.ascontiguousarray(corners, dtype=np.float32)
    t = int(corners.shape[0])
    node_cap = max(t // 4 + 16, 16)
    order_cap = (2 * t + 4 * WIDE_LEAF) // WIDE_LEAF * WIDE_LEAF + WIDE_LEAF
    node_rows = np.zeros((node_cap, 128), np.float32)
    tri_order = np.full((order_cap,), -1, np.int32)
    out_nodes = ctypes.c_int(0)
    out_blocks = ctypes.c_int(0)
    out_depth = ctypes.c_int(0)
    rc = lib.lum_build_wide(
        corners.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        t, int(flat_tris),
        node_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        tri_order.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        node_cap, order_cap,
        ctypes.byref(out_nodes), ctypes.byref(out_blocks),
        ctypes.byref(out_depth),
    )
    if rc != 0:
        raise RuntimeError("native wide BVH build failed (rc=%d)" % rc)
    m, blocks = out_nodes.value, out_blocks.value
    return WideBVH(
        node_rows=node_rows[:m].copy(),
        leaf_rows=np.zeros((blocks, 128), np.float32),
        tri_order=tri_order[: blocks * WIDE_LEAF].copy(),
        depth=int(out_depth.value),
        num_nodes=m,
        num_blocks=blocks,
    )

