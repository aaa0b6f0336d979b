"""Shared sampling helpers for the integrator and the wavefront sort key
(port of ``luminary_tpu/ops/wavefront_utils.py``)."""

from __future__ import annotations

import numpy as np
import torch

from .random import RandomTarget, random_2d
from .sky import SUN_COS_MAX
from .vec import Vec3, normalize, orthonormal_basis, rdiv


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


def _spread3(x: torch.Tensor) -> torch.Tensor:
    """The low 8 bits of x spread to every 3rd bit (a Morton interleave)."""
    x = x & 0xFF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def ray_sort_key(origin: Vec3, direction: Vec3, active, bounds) -> torch.Tensor:
    """Coherence sort key of the wavefront, a u32 word in an int64 tensor
    (ascending): dead lanes last (bit 30), then the direction octant (bits
    27-29), then a 24-bit Morton code of the origin quantised to 8 bits per
    axis over the scene bounds ``[lo x3, hi x3]``. Sorted, neighbouring rays
    walk nearly the same tree path and dead lanes gather at the end."""
    inv = rdiv(255.0, torch.clamp(bounds[3:6] - bounds[0:3], min=1e-6))

    def q(c, lo, s):
        return torch.clamp((c - lo) * s, 0.0, 255.0).to(torch.int64)

    m = ((_spread3(q(origin.x, bounds[0], inv[0])) << 2)
         | (_spread3(q(origin.y, bounds[1], inv[1])) << 1)
         | _spread3(q(origin.z, bounds[2], inv[2])))
    octant = (((direction.x < 0).to(torch.int64) << 2)
              | ((direction.y < 0).to(torch.int64) << 1)
              | (direction.z < 0).to(torch.int64))
    dead = (~active).to(torch.int64)
    return (dead << 30) | (octant << 27) | (m >> 3)
