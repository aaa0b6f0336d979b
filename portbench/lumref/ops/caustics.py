"""Ocean sun caustics (port of ``luminary_tpu/ops/caustics.py``): for an
underwater vertex x, RIS over K candidate points P on the wavy surface,
drawn uniformly in a disk around the flat-interface refraction point and
resampled by a smooth alignment x Fresnel target; the winner contributes
where x→P, refracted into air at the wave normal, lands in the solar disc.
The integrator pairs it with two shadow segments (x→P and P→sun) and
suppresses the BSDF path's disc hit after an upward ocean refraction.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .procedural import ocean_height_normal
from .random import RandomTarget, random_2d
from .sky import SUN_COS_RADIUS
from .vec import Vec3, sdiv

_F32 = np.float32
# smooth RIS target width: exp(-(1 - align) / TAU), a ~2.5 degree basin
_TAU = 1e-3
# the smallest normal float32: the reference runs with subnormals flushed to
# zero (the TPU, and XLA's CPU backend), and the target's exponential
# reaches the subnormal range for alignments near 0.9
_FLT_MIN = float(np.finfo(np.float32).tiny)


def _pow5(x):
    """x ** 5 as the reference's integer power evaluates it: x * (x²)²."""
    x2 = x * x
    return x * (x2 * x2)


def _refract_up(wx, wy, wz, nx, ny, nz, eta_rel: float):
    """Refract a water-side direction (toward the surface) into air;
    eta_rel = n_water / n_air → (tx, ty, tz, valid)."""
    c1 = torch.clamp(wx * nx + wy * ny + wz * nz, -1.0, 1.0)
    eta2 = float(_F32(eta_rel) * _F32(eta_rel))
    sin2_2 = eta2 * torch.clamp(1.0 - c1 * c1, min=0.0)
    valid = (sin2_2 < 1.0) & (c1 > 0.0)
    c2 = torch.sqrt(torch.clamp(1.0 - sin2_2, min=0.0))
    k = c2 - eta_rel * c1
    tx = eta_rel * wx + k * nx
    ty = eta_rel * wy + k * ny
    tz = eta_rel * wz + k * nz
    inv = torch.reciprocal(torch.sqrt(torch.clamp(tx * tx + ty * ty + tz * tz,
                                                  min=1e-12)))
    return tx * inv, ty * inv, tz * inv, valid


def _fresnel_t(tx, ty, tz, nx, ny, nz, r0: float):
    """Schlick transmittance on the air side."""
    cos_air = torch.clamp(tx * nx + ty * ny + tz * nz, 0.0, 1.0)
    return 1.0 - (r0 + (1.0 - r0) * _pow5(1.0 - cos_air))


def sample_caustic_connection(water, sun_v: Vec3, x: Vec3, pixel_id,
                              sample_id, depth: int, k_samples: int):
    """RIS over ``k_samples`` surface points for underwater vertices x →
    (P, u: unit x→P, dist, weight, valid), each [N]. ``weight`` is the
    whole area-measure factor Ft cos_geo / dist² x pi R² x sum(p̂) /
    (K p̂_winner) where the winner refracts into the disc; the caller
    multiplies f(x, u), the sun's radiance, the water's transmittance and
    the visibility. Square roots and divisions are IEEE on every device
    (``1 / sqrt``, ``sdiv``), so that the card picks the CPU's winners."""
    n = x.x.shape[0]
    dev = x.x.device
    eta = water.ior
    eta2 = float(_F32(eta) * _F32(eta))
    # the flat-interface refracted sun direction sets the disk's centre
    sy = torch.clamp(sun_v.y, 1e-3, 1.0)
    sin_air2 = torch.clamp(1.0 - sy * sy, min=0.0)
    sin_w2 = sdiv(sin_air2, eta2)
    cos_w = torch.sqrt(torch.clamp(1.0 - sin_w2, min=0.0))
    sh = torch.sqrt(torch.clamp(sun_v.x * sun_v.x + sun_v.z * sun_v.z, min=1e-12))
    hx_s, hz_s = sun_v.x / sh, sun_v.z / sh
    w_depth = torch.clamp(water.height - x.y, min=0.05)
    tan_w = torch.sqrt(sin_w2) / torch.clamp(cos_w, min=1e-3)
    cx = x.x + hx_s * tan_w * w_depth
    cz = x.z + hz_s * tan_w * w_depth
    r_disk = (water.caustics_scale * w_depth
              + float(_F32(4.0) * _F32(water.amplitude)) + 0.5)
    pdf_a_inv = math.pi * r_disk * r_disk  # 1 / pdf_A
    r0 = _F32(_F32(eta) - _F32(1.0)) / _F32(_F32(eta) + _F32(1.0))
    r0 = float(r0 * r0)

    wsum = torch.zeros(n, dtype=torch.float32, device=dev)
    sel_phat, sel_px, sel_pz = wsum, wsum, wsum
    for k in range(k_samples):
        r2 = random_2d(RandomTarget.OCEAN_CAUSTICS, pixel_id, sample_id,
                       depth * 32 + k)
        rr = r_disk * torch.sqrt(torch.clamp(r2[..., 0], 1e-6, 1.0))
        ph = 2.0 * math.pi * r2[..., 1]
        px = cx + rr * torch.cos(ph)
        pz = cz + rr * torch.sin(ph)
        py, (nx, ny, nz) = ocean_height_normal(water, px, pz)
        dx, dy_, dz = px - x.x, py - x.y, pz - x.z
        inv_d = torch.reciprocal(torch.sqrt(
            torch.clamp(dx * dx + dy_ * dy_ + dz * dz, min=1e-8)))
        tx, ty, tz, ok = _refract_up(dx * inv_d, dy_ * inv_d, dz * inv_d,
                                     nx, ny, nz, eta)
        align = tx * sun_v.x + ty * sun_v.y + tz * sun_v.z
        ft = _fresnel_t(tx, ty, tz, nx, ny, nz, r0)
        phat = torch.where(
            ok, ft * torch.exp(sdiv(-(1.0 - torch.clamp(align, -1.0, 1.0)), _TAU)),
            0.0)
        phat = torch.where(phat < _FLT_MIN, 0.0, phat)
        wsum = wsum + phat
        if k == 0:
            take = phat > 0.0
        else:
            rpick = random_2d(RandomTarget.OCEAN_CAUSTICS, pixel_id, sample_id,
                              depth * 32 + k + 16384)[..., 0]
            take = (rpick * wsum < phat) & (phat > 0.0)
        sel_phat = torch.where(take, phat, sel_phat)
        sel_px = torch.where(take, px, sel_px)
        sel_pz = torch.where(take, pz, sel_pz)

    # the winner's exact terms
    py, (nx, ny, nz) = ocean_height_normal(water, sel_px, sel_pz)
    dx, dy_, dz = sel_px - x.x, py - x.y, sel_pz - x.z
    dist = torch.sqrt(torch.clamp(dx * dx + dy_ * dy_ + dz * dz, min=1e-8))
    inv_d = 1.0 / dist
    u = Vec3(dx * inv_d, dy_ * inv_d, dz * inv_d)
    tx, ty, tz, ok = _refract_up(u.x, u.y, u.z, nx, ny, nz, eta)
    align = tx * sun_v.x + ty * sun_v.y + tz * sun_v.z
    aligned = ok & (align >= SUN_COS_RADIUS)
    ft = _fresnel_t(tx, ty, tz, nx, ny, nz, r0)
    cos_geo = torch.abs(u.x * nx + u.y * ny + u.z * nz)
    valid = aligned & (wsum > 0.0) & (sel_phat > 0.0)
    weight = torch.where(
        valid,
        ft * cos_geo * inv_d * inv_d * pdf_a_inv * wsum
        / (k_samples * torch.clamp(sel_phat, min=1e-20)),
        0.0)
    return Vec3(sel_px, py, sel_pz), u, dist, weight, valid
