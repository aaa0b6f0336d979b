"""Ray-triangle intersection (port of ``luminary_tpu/ops/intersect.py``).

Möller-Trumbore in the precomputed (v0, e1, e2) form over broadcastable
:class:`Vec3` component bundles. The CUDA walk (``csrc/traverse_wide.cu``)
repeats this arithmetic in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from .vec import Vec3, cross, dot

# Distance returned for misses (reference uses FLT_MAX the same way).
MISS_DIST = float(np.float32(3.0e38))


def ray_triangle(origin: Vec3, direction: Vec3, v0: Vec3, e1: Vec3, e2: Vec3,
                 t_min: float = 1e-4):
    """Returns (t, u, v, hit) with t=MISS_DIST on miss; backfaces count."""
    pvec = cross(direction, e2)
    det = dot(e1, pvec)
    parallel = torch.abs(det) < 1e-12
    inv_det = torch.reciprocal(torch.where(parallel, 1.0, det))
    tvec = origin - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(direction, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = (~parallel) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
    return torch.where(hit, t, MISS_DIST), u, v, hit
