"""Shared sampling helpers for the integrator (port of
``luminary_tpu/ops/wavefront_utils.py``; the wavefront sort key is not
ported)."""

from __future__ import annotations

import numpy as np
import torch

from .random import RandomTarget, random_2d
from .sky import SUN_COS_MAX
from .vec import Vec3, normalize, orthonormal_basis


def sample_sun_direction(sun_dir: Vec3, pixel_id, sample_id, depth,
                         bn=None) -> Vec3:
    """Uniform direction in the solar cone."""
    r2 = random_2d(RandomTarget.LIGHT_SUN, pixel_id, sample_id, depth, bn=bn)
    cos_t = 1.0 - r2[..., 0] * (1.0 - SUN_COS_MAX)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * np.pi * r2[..., 1]
    t, b = orthonormal_basis(sun_dir)
    a1 = torch.cos(phi) * sin_t
    a2 = torch.sin(phi) * sin_t
    return normalize(Vec3(
        t.x * a1 + b.x * a2 + sun_dir.x * cos_t,
        t.y * a1 + b.y * a2 + sun_dir.y * cos_t,
        t.z * a1 + b.z * a2 + sun_dir.z * cos_t,
    ))
