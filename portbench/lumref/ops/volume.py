"""Participating media (port of ``luminary_tpu/ops/volume.py``): height
fog, a homogeneous medium filling y < height, with analog (closed-form)
distance sampling, the Henyey-Greenstein phase and its sampling and the
transmittance of shadow segments; and ocean water below the mean surface,
with Jerlov absorption per segment, scatter-only analog tracking and the
molecular/particle phase mixture.

The media's parameters are host floats holding float32 values; every scalar
expression the reference evaluates in float32 is evaluated here in
``np.float32`` first, so that lanes compare bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .random import RandomTarget, random_1d, random_2d
from .vec import Vec3, normalize, orthonormal_basis, rdiv, sdiv

# Density unit scale: a reference fog density of 1.0 is a light haze over
# ~500 m.
_FOG_DENSITY_SCALE = 0.002
_F32 = np.float32


@dataclass
class DeviceFog:
    active: bool
    sigma_t: float  # extinction (1/m)
    scatter_albedo: float
    height: float  # fog top (world y)
    max_dist: float  # lateral extent along a ray
    g: float  # HG anisotropy

    @property
    def on(self) -> bool:
        """Whether any lane can collide: an active fog of positive density."""
        return bool(self.active) and self.sigma_t > 0.0


def pack_fog(fog) -> DeviceFog:
    """Fog entity → DeviceFog; the droplet diameter (µm) sets the
    anisotropy (bigger droplets scatter forward)."""
    g = _F32(0.3) + _F32(0.25) * np.log10(_F32(max(fog.droplet_diameter, 0.1)))
    return DeviceFog(
        active=bool(fog.active),
        sigma_t=float(_F32(fog.density * _FOG_DENSITY_SCALE)),
        scatter_albedo=float(_F32(0.98)),
        height=float(_F32(fog.height)),
        max_dist=float(_F32(fog.dist)),
        g=float(np.clip(g, _F32(0.0), _F32(0.9))),
    )


def hg_phase(cos_theta: torch.Tensor, g: float) -> torch.Tensor:
    g = _F32(g)
    g2 = g * g
    base = torch.clamp(float(_F32(1.0) + g2) - float(_F32(2.0) * g) * cos_theta,
                       min=1e-6)
    return rdiv(float(_F32(1.0) - g2), 4.0 * math.pi * torch.pow(base, 1.5))


def sample_hg_direction(w_in: Vec3, g: float, pixel_id, sample_id, depth,
                        bn=None) -> Vec3:
    """Sample the HG phase about the propagation direction ``w_in``."""
    r2 = random_2d(RandomTarget.VOLUME_PHASE, pixel_id, sample_id, depth, bn=bn)
    r0, r1 = r2[..., 0], r2[..., 1]
    g = _F32(g)
    if abs(g) < 1e-3:
        cos_t = 1.0 - 2.0 * r0
    else:
        sq = rdiv(float(_F32(1.0) - g * g),
                  float(_F32(1.0) - g) + float(_F32(2.0) * g) * r0)
        cos_t = (float(_F32(1.0) + g * g) - sq * sq) / float(_F32(2.0) * g)
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * r1
    t, b = orthonormal_basis(w_in)
    a1 = torch.cos(phi) * sin_t
    a2 = torch.sin(phi) * sin_t
    return normalize(Vec3(
        t.x * a1 + b.x * a2 + w_in.x * cos_t,
        t.y * a1 + b.y * a2 + w_in.y * cos_t,
        t.z * a1 + b.z * a2 + w_in.z * cos_t,
    ))


def fog_segment(fog: DeviceFog, origin: Vec3, direction: Vec3, t_limit):
    """Overlap [t0, t1] of each ray with the fog slab, clamped to
    [0, t_limit] (a float or an [N] tensor); t1 <= t0 where there is none."""
    oy, dy = origin.y, direction.y
    if not isinstance(t_limit, torch.Tensor):
        t_limit = torch.full_like(oy, float(t_limit))
    dy_safe = torch.where(torch.abs(dy) < 1e-9, 1e-9, dy)
    t_plane = (fog.height - oy) / dy_safe
    inside = oy < fog.height
    t0 = torch.where(inside, 0.0, torch.where(dy < 0.0, t_plane, math.inf))
    t1 = torch.where(inside, torch.where(dy > 0.0, t_plane, t_limit), t_limit)
    t0 = torch.minimum(torch.clamp(t0, min=0.0), t_limit)
    t1 = torch.minimum(torch.clamp(torch.minimum(t1, fog.max_dist + t0), min=0.0),
                       t_limit)
    if not fog.on:
        t1 = torch.zeros_like(t1)
    return t0, t1


def fog_transmittance(fog: DeviceFog, origin: Vec3, direction: Vec3, dist):
    """exp(-sigma_t * overlap) along a (shadow) segment."""
    t0, t1 = fog_segment(fog, origin, direction, dist)
    return torch.exp(-fog.sigma_t * torch.clamp(t1 - t0, min=0.0))


def sample_fog_collision(fog: DeviceFog, origin: Vec3, direction: Vec3,
                         t_surface, pixel_id, sample_id, depth):
    """Analog distance sampling in the fog overlap → (collided bool [N],
    t: the collision distance where collided, else t_surface)."""
    t0, t1 = fog_segment(fog, origin, direction, t_surface)
    r = random_1d(RandomTarget.VOLUME_DISTANCE, pixel_id, sample_id, depth)
    free_path = (-torch.log(torch.clamp(1.0 - r, min=1e-10))
                 / max(fog.sigma_t, 1e-10))
    t_s = t0 + free_path
    collision = (t1 > t0) & (t_s < t1)
    return collision, torch.where(collision, t_s, t_surface)


@dataclass
class DeviceWater:
    """Ocean water below ``height`` (Jerlov RGB absorption, gray scattering
    and the phase mixture weight) and the surface parameters the analytic
    ocean and the caustic sampler read."""

    active: bool
    absorb: tuple  # (r, g, b) absorption 1/m
    scatter: float  # scattering 1/m
    mol_weight: float  # molecular (g = 0) share of the phase mixture
    height: float  # mean surface y
    amplitude: float
    frequency: float
    ior: float
    caustics_scale: float  # connection-disk scale


# Molecular share of the phase mixture per Jerlov type: clear oceanic
# water scatters mostly molecularly, turbid coastal water by particles.
JERLOV_MOLECULAR_WEIGHT = {
    0: 0.93, 1: 0.44, 2: 0.06, 3: 0.007, 4: 0.003,
    5: 0.005, 6: 0.003, 7: 0.001, 8: 0.0, 9: 0.0,
}
WATER_PARTICLE_G = 0.924


def pack_water(ocean) -> DeviceWater:
    from .procedural import JERLOV_COEFFS

    absorb, scatter = JERLOV_COEFFS[int(ocean.water_type)]
    return DeviceWater(
        active=bool(ocean.active),
        absorb=tuple(float(_F32(a)) for a in absorb),
        scatter=float(_F32(scatter)),
        mol_weight=float(_F32(JERLOV_MOLECULAR_WEIGHT[int(ocean.water_type)])),
        height=float(_F32(ocean.height)),
        amplitude=float(_F32(ocean.amplitude)),
        frequency=float(_F32(ocean.frequency)),
        ior=float(_F32(ocean.refractive_index)),
        caustics_scale=float(_F32(getattr(ocean, "caustics_domain_scale", 0.5))),
    )


def water_segment(water: DeviceWater, origin: Vec3, direction: Vec3, dist):
    """Overlap [t0, t1] of each segment with the water half-space (below
    the mean plane), clamped to [0, dist]; t1 = t0 without water."""
    oy, dy = origin.y, direction.y
    if not isinstance(dist, torch.Tensor):
        dist = torch.full_like(oy, float(dist))
    dy_safe = torch.where(torch.abs(dy) < 1e-9, 1e-9, dy)
    t_plane = (water.height - oy) / dy_safe
    inside = oy < water.height
    t0 = torch.where(inside, 0.0, torch.where(dy < 0.0, t_plane, math.inf))
    t1 = torch.where(inside, torch.where(dy > 0.0, t_plane, dist), dist)
    t0 = torch.minimum(torch.clamp(t0, min=0.0), dist)
    t1 = torch.minimum(torch.clamp(t1, min=0.0), dist)
    if not water.active:
        t1 = t0
    return t0, t1


def water_transmittance(water: DeviceWater, origin: Vec3, direction: Vec3,
                        dist, with_scatter: bool = False):
    """exp(-sigma_a * overlap) of each segment with the water → (tr, tg,
    tb). ``with_scatter`` folds in the scattering extinction too: the full
    transmittance of an NEE shadow segment under water in-scattering (a
    traveled segment must not: its collisions are sampled)."""
    t0, t1 = water_segment(water, origin, direction, dist)
    overlap = torch.clamp(t1 - t0, min=0.0)
    s = _F32(water.scatter) if with_scatter else _F32(0.0)
    return tuple(torch.exp(-float(_F32(a) + s) * overlap) for a in water.absorb)


def sample_water_collision(water: DeviceWater, origin: Vec3, direction: Vec3,
                           t_surface, pixel_id, sample_id, depth, bn=None):
    """Analog scattering-distance sampling in the water overlap (sub-stream
    depth + 64, disjoint from the fog's) → (collided bool [N], t: the
    collision distance where collided, else t_surface)."""
    t0, t1 = water_segment(water, origin, direction, t_surface)
    r = random_1d(RandomTarget.VOLUME_DISTANCE, pixel_id, sample_id, depth + 64,
                  bn=bn)
    free_path = sdiv(-torch.log(torch.clamp(1.0 - r, min=1e-10)),
                     max(water.scatter, 1e-10))
    t_s = t0 + free_path
    collision = (t1 > t0) & (t_s < t1) & (water.scatter > 0.0)
    return collision, torch.where(collision, t_s, t_surface)


def hg_phase_const(cos_theta: torch.Tensor, g: float) -> torch.Tensor:
    """HG phase of a constant (Python float) anisotropy, its constants
    folded in float64 as the reference folds them."""
    g2 = g * g
    base = torch.clamp((1.0 + g2) - (2.0 * g) * cos_theta, min=1e-6)
    return rdiv(1.0 - g2, 4.0 * math.pi * torch.pow(base, 1.5))


def ocean_phase(cos_theta: torch.Tensor, water: DeviceWater) -> torch.Tensor:
    """The water phase: molecular (HG g = 0) and particle (HG g = 0.924)
    mixture."""
    m = _F32(water.mol_weight)
    return (float(m) * hg_phase_const(cos_theta, 0.0)
            + float(_F32(1.0) - m) * hg_phase_const(cos_theta, WATER_PARTICLE_G))


def sample_ocean_phase_direction(w_in: Vec3, water: DeviceWater, pixel_id,
                                 sample_id, depth, bn=None) -> Vec3:
    """Sample the water phase mixture about the propagation direction: pick
    the component by its weight, then draw its HG cosine."""
    r_choice = random_1d(RandomTarget.VOLUME_PHASE, pixel_id, sample_id,
                         depth + 64, bn=bn)
    r2 = random_2d(RandomTarget.VOLUME_PHASE, pixel_id, sample_id, depth + 128,
                   bn=bn)
    r0, r1 = r2[..., 0], r2[..., 1]
    molecular = r_choice < water.mol_weight
    g = torch.where(molecular, 1e-3, WATER_PARTICLE_G)
    sq = (1.0 - g * g) / (1.0 - g + 2.0 * g * r0)
    cos_t = (1.0 + g * g - sq * sq) / (2.0 * g)
    cos_t = torch.where(molecular, 1.0 - 2.0 * r0, cos_t)
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * r1
    t, b = orthonormal_basis(w_in)
    a1 = torch.cos(phi) * sin_t
    a2 = torch.sin(phi) * sin_t
    return normalize(Vec3(
        t.x * a1 + b.x * a2 + w_in.x * cos_t,
        t.y * a1 + b.y * a2 + w_in.y * cos_t,
        t.z * a1 + b.z * a2 + w_in.z * cos_t,
    ))
