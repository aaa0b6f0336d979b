"""Sky radiance evaluation (port of ``luminary_tpu/ops/sky.py``; DEFAULT,
HDRI and CONSTANT_COLOR modes).

The DEFAULT atmosphere (and the HDRI map: the baked atmosphere with moon,
stars and clouds folded in, or a user's image) is stored at pack time as a
lat-long map of bilinear-quad rows; a miss is one kernel-A row gather plus
a lerp. The solar disc stays analytic; in DEFAULT mode moon and stars are
procedural. The stars follow the rounding of the reference's compiled
code (glibc's ``sinf``/``cosf`` and a fused dot: see
:func:`_stars_radiance_plain`); on the card they are one kernel
(``csrc/shading.cu`` ``lum_stars``), the lane's grid cell included. Aerial
perspective reads one 128-column distance-curve row per lane, also through
kernel A. Environment NEE draws a cell of the map by its alias row and a
direction uniformly inside it.

Spectral rendering: the DEFAULT atmosphere is also baked at the 8 sky bands
into 32-column quad rows, fetched through kernel A the same way; HDRI,
user and constant skies uplift their RGB radiance to each hero wavelength.
"""

from __future__ import annotations

import numpy as np
import torch

from .atmosphere import AERIAL_D_MAX, AERIAL_D_MIN, AERIAL_ND, AERIAL_NS, AERIAL_NU
from .libm import cosf, sinf
from .random import M32
from .rowops import gather_planar
from .spectral import sample_spectrum_bands, uplift
from .vec import Vec3, dot as vdot, fma32, normalize, sdiv, sqrt_rn

MOON_ANGULAR_RADIUS = 0.00452
MOON_COS_RADIUS = 0.999989786
MOON_ALBEDO = 0.12
STARS_GRID = 64

SUN_COS_RADIUS = 0.99998869
SUN_ANGULAR_RADIUS = 0.004675
_SUN_SOLID_ANGLE = 6.87e-5
SUN_IRRADIANCE = 1.25
SUN_RADIANCE = SUN_IRRADIANCE / _SUN_SOLID_ANGLE

# f32 evaluations of the reference's jnp constants (bit-identical to them)
SUN_COS_MAX = float(np.cos(np.float32(SUN_ANGULAR_RADIUS)))
SUN_SOLID_ANGLE = float(np.float32(2.0 * np.pi)
                        * (np.float32(1.0) - np.float32(SUN_COS_MAX)))
_AERIAL_LOG_SPAN = float(np.log(np.float32(AERIAL_D_MAX / AERIAL_D_MIN)))
_TWO_PI = 2.0 * np.pi


def sun_dir_vec(sky) -> Vec3:
    return Vec3(sky.sun_dir[0], sky.sun_dir[1], sky.sun_dir[2])


def sample_env_rows(sky, d: Vec3):
    """Bilinear lat-long fetch from the quad-row env layout: one row gather
    carries the 2x2 footprint. Returns (r, g, b)."""
    h = float(sky.env_h)
    w = float(sky.env_w)
    wi = int(sky.env_w)
    theta = torch.arccos(torch.clamp(d.y, -1.0, 1.0))
    phi = torch.atan2(d.z, d.x) % _TWO_PI
    fy = torch.clamp(theta * (1.0 / np.pi) * h - 0.5, 0.0, h - 1.001)
    fx = phi * (0.5 / np.pi) * w - 0.5
    x0f = torch.floor(fx)
    x0 = x0f.to(torch.int32) % wi
    y0 = torch.clamp(fy.to(torch.int32), 0, int(sky.env_h) - 2)
    wy = fy - y0.to(torch.float32)
    wx = fx - x0f
    r0 = gather_planar(sky.env_rows, y0 * wi + x0)  # [16, N]
    one_wx = 1.0 - wx
    one_wy = 1.0 - wy

    def lerp(c):
        top = r0[c] * one_wx + r0[c + 4] * wx
        bot = r0[c + 8] * one_wx + r0[c + 12] * wx
        return top * one_wy + bot * wy

    return lerp(0), lerp(1), lerp(2)


def sample_env_spec_rows(sky, d: Vec3) -> torch.Tensor:
    """Bilinear fetch of the 8-band env from its quad rows (bands at (y,
    x), (y, x+1), (y+1, x), (y+1, x+1)): one kernel-A row gather of 32
    columns per lane. Returns planar bands [8, N]."""
    h = float(sky.env_spec_h)
    w = float(sky.env_spec_w)
    wi = int(sky.env_spec_w)
    theta = torch.arccos(torch.clamp(d.y, -1.0, 1.0))
    phi = torch.atan2(d.z, d.x) % _TWO_PI
    fy = torch.clamp(theta * (1.0 / np.pi) * h - 0.5, 0.0, h - 1.001)
    fx = phi * (0.5 / np.pi) * w - 0.5
    x0f = torch.floor(fx)
    x0 = x0f.to(torch.int32) % wi
    y0 = torch.clamp(fy.to(torch.int32), 0, int(sky.env_spec_h) - 2)
    wy = fy - y0.to(torch.float32)
    wx = fx - x0f
    r0 = gather_planar(sky.env_spec_rows, y0 * wi + x0)  # [32, N]
    top = r0[0:8] * (1.0 - wx) + r0[8:16] * wx
    bot = r0[16:24] * (1.0 - wx) + r0[24:32] * wx
    return top * (1.0 - wy) + bot * wy


def _hash_u32(x):
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & M32
    x = x ^ (x >> 16)
    return x


def _hash01(x):
    return _hash_u32(x).to(torch.float32) * (1.0 / 4294967296.0)


def stars_radiance(sky, d: Vec3, fused: bool = True):
    """Procedural star field on a lat-long hash grid → (r, g, b) [N];
    ``fused``: the dot rounded as the reference's compiled integrator
    rounds it, else op by op as its eager HDRI bake does (see
    :func:`_stars_radiance_plain`). On the card one launch of
    ``csrc/shading.cu`` ``lum_stars``; elsewhere
    :func:`_stars_radiance_plain`. Both give the same bits."""
    return _stars_radiance_plain(sky, d, fused)




def _star_cell(sky, d: Vec3):
    """The lane's grid cell (gx, gy) and the cell's hash h0 (the plain
    version of ``lum_stars``' ``star_cell``)."""
    u = torch.atan2(d.z, d.x) * (0.5 / np.pi) + 0.5
    v = torch.arccos(torch.clamp(d.y, -1.0, 1.0)) * (1.0 / np.pi)
    gx = torch.clamp((u * STARS_GRID).to(torch.int32), 0, STARS_GRID - 1)
    gy = torch.clamp((v * STARS_GRID).to(torch.int32), 0, STARS_GRID - 1)
    cell = (gy * STARS_GRID + gx).to(torch.int64) & M32
    seed = int(sky.stars_seed) & M32
    return gx, gy, _hash_u32(((cell * 0x9E3779B9) + seed) & M32)


def _stars_p(sky) -> float:
    """The probability that a cell holds a star, as a float32 value."""
    return float(np.float32(min(max(float(np.float32(sky.stars_count)
                                          / np.float32(STARS_GRID * STARS_GRID)),
                                    0.0), 1.0)))


def _stars_radiance_plain(sky, d: Vec3, fused: bool = True):
    """Plain version of :func:`stars_radiance`. A star is a Gaussian of
    3e-4 rad, and its angle comes from ``1 - cos``, so one ulp of the cosine
    moves its glow by ~30 %: the star direction takes glibc's ``sinf`` /
    ``cosf``, as the reference's compiled code does, and the cosine, where
    ``fused``, XLA's contraction of the reference's dot in its compiled
    integrator, fma(z, z', fma(y, y', x x')); its eager HDRI bake rounds the
    dot op by op (its square root is correctly rounded)."""
    gx, gy, h0 = _star_cell(sky, d)
    present = _hash01(h0) < _stars_p(sky)
    su = (gx.to(torch.float32) + _hash01((h0 + 1) & M32)) / STARS_GRID
    sv = (gy.to(torch.float32) + _hash01((h0 + 2) & M32)) / STARS_GRID
    phi = (su - 0.5) * _TWO_PI
    theta = sv * np.pi
    sin_t = sinf(theta)
    sd = Vec3(cosf(phi) * sin_t, cosf(theta), sinf(phi) * sin_t)
    cos_d = torch.clamp(fma32(d.z, sd.z, fma32(d.y, sd.y, d.x * sd.x)) if fused
                        else vdot(d, sd), -1.0, 1.0)
    ang = sqrt_rn(torch.clamp(2.0 * (1.0 - cos_d), min=0.0))
    radius = 3e-4 * (0.5 + _hash01((h0 + 3) & M32))
    glow = torch.exp(-(ang * ang) / torch.clamp(2.0 * radius * radius, min=1e-12))
    h4 = _hash01((h0 + 4) & M32)
    h4sq = h4 * h4
    brightness = (0.2 + 0.8 * (h4sq * h4sq)) * sky.stars_intensity
    i = torch.where(present, glow * brightness, 0.0)
    warm = _hash01((h0 + 5) & M32)
    return i * (0.8 + 0.4 * warm), i, i * (1.2 - 0.4 * warm)


def moon_radiance(sky, d: Vec3):
    """Sun-lit moon disc with procedural crater mottling."""
    md = Vec3(sky.moon_dir[0], sky.moon_dir[1], sky.moon_dir[2])
    cos_m = vdot(d, md)
    in_disc = cos_m >= MOON_COS_RADIUS
    up = torch.where(torch.abs(sky.moon_dir[1]) < 0.99, 1.0, 0.0)
    tx = normalize(Vec3(
        -md.z * up,
        md.z * (1.0 - up),
        md.x * up - md.y * (1.0 - up),
    ))
    ty = Vec3(
        md.y * tx.z - md.z * tx.y,
        md.z * tx.x - md.x * tx.z,
        md.x * tx.y - md.y * tx.x,
    )
    lx = vdot(d, tx) / MOON_ANGULAR_RADIUS
    ly = vdot(d, ty) / MOON_ANGULAR_RADIUS
    r2 = torch.clamp(lx * lx + ly * ly, 0.0, 1.0)
    lz = torch.sqrt(1.0 - r2)
    n = Vec3(
        tx.x * lx + ty.x * ly - md.x * lz,
        tx.y * lx + ty.y * ly - md.y * lz,
        tx.z * lx + ty.z * ly - md.z * lz,
    )
    lambert = torch.clamp(vdot(n, sun_dir_vec(sky)), min=0.0)
    cell = ((lx * 8.0 + sky.moon_tex_offset).to(torch.int32) * 37
            + (ly * 8.0).to(torch.int32) * 101).to(torch.int64) & M32
    mottle = 0.7 + 0.3 * _hash01(cell)
    radiance = torch.where(
        in_disc, lambert * mottle * (MOON_ALBEDO / np.pi) * SUN_IRRADIANCE, 0.0)
    return radiance, in_disc


def sky_radiance(sky, direction: Vec3, include_sun: bool = True) -> Vec3:
    """Environment radiance for escaping rays → RGB Vec3 of [N] channels."""
    d = direction
    if int(sky.mode) == 2:
        c = sky.constant_color
        return Vec3(c[0].expand(d.x.shape), c[1].expand(d.x.shape),
                    c[2].expand(d.x.shape))
    r, g, b = sample_env_rows(sky, d)
    cos_sun = vdot(d, sun_dir_vec(sky))
    in_disc = cos_sun >= SUN_COS_RADIUS
    center = torch.clamp((cos_sun - SUN_COS_RADIUS) / (1.0 - SUN_COS_RADIUS), 0.0, 1.0)
    limb = torch.where(in_disc, 0.3 + 0.7 * torch.sqrt(center), 0.0)
    disc = limb * float(bool(include_sun))
    r = r + disc * sky.sun_disc_radiance[0]
    g = g + disc * sky.sun_disc_radiance[1]
    b = b + disc * sky.sun_disc_radiance[2]

    if int(sky.mode) != 0:  # an HDRI map holds its moon and stars
        return Vec3(r, g, b)
    moon, in_moon = moon_radiance(sky, d)
    sr, sg, sb = stars_radiance(sky, d)
    block = in_moon | in_disc
    sr = torch.where(block, 0.0, sr)
    sg = torch.where(block, 0.0, sg)
    sb = torch.where(block, 0.0, sb)
    return Vec3(r + (moon + sr), g + (moon + sg), b + (moon + sb))


def has_spectral_bake(sky) -> bool:
    """Whether the sky carries the 8-band bake (a DEFAULT sky packed for
    spectral rendering; the dummy table has one row)."""
    return int(sky.env_spec_rows.shape[0]) > 1


def sky_radiance_spectral(sky, direction: Vec3, lam3):
    """Environment radiance at the three hero wavelengths, without the solar
    disc (the integrator pairs the disc with the sun strategy): the 8-band
    bake where it exists, else the uplifted RGB map; DEFAULT skies add the
    uplifted stars and the moon, constant skies are their uplifted colour.
    Returns a 3-tuple of [N]."""
    d = direction
    mode = int(sky.mode)
    if mode == 2:
        c = sky.constant_color
        return tuple(uplift(c[0], c[1], c[2], lam).expand(d.x.shape)
                     for lam in lam3)
    if has_spectral_bake(sky):
        bands = sample_env_spec_rows(sky, d)
        dome = tuple(sample_spectrum_bands(bands, lam) for lam in lam3)
    else:
        r, g, b = sample_env_rows(sky, d)
        dome = tuple(uplift(r, g, b, lam) for lam in lam3)
    if mode != 0:  # an HDRI map holds its moon and stars
        return dome
    moon, in_moon = moon_radiance(sky, d)
    sr, sg, sb = stars_radiance(sky, d)
    block = in_moon | (vdot(d, sun_dir_vec(sky)) >= SUN_COS_RADIUS)
    sr = torch.where(block, 0.0, sr)
    sg = torch.where(block, 0.0, sg)
    sb = torch.where(block, 0.0, sb)
    return tuple(dome[j] + (uplift(sr, sg, sb, lam) + moon)
                 for j, lam in enumerate(lam3))


def sun_radiance_spectral(sky, lam3):
    """Solar-disc radiance at the hero wavelengths: the banded spectrum of
    the 8-band bake where it exists, else the uplifted RGB disc; zero for
    constant skies."""
    on = 0.0 if int(sky.mode) == 2 else 1.0
    if has_spectral_bake(sky):
        return tuple(sample_spectrum_bands(sky.sun_disc_spec, lam) * on
                     for lam in lam3)
    c = sky.sun_disc_radiance
    return tuple(uplift(c[0], c[1], c[2], lam) * on for lam in lam3)


def aerial_fetch(sky, direction: Vec3, dist):
    """Aerial perspective → ((transmittance rgb), (inscatter rgb)) for view
    segments of ``dist`` km: one kernel-A row gather per lane, the distance
    curve lerped in registers."""
    mu = torch.clamp(direction.y, -1.0, 1.0)
    mi = torch.clamp(((mu + 1.0) * 0.5 * AERIAL_NU).to(torch.int32), 0, AERIAL_NU - 1)
    sx, sz = sky.sun_dir[0], sky.sun_dir[2]
    az_v = torch.atan2(direction.z, direction.x)
    az_s = torch.atan2(sz, sx)
    rel = (az_v - az_s) % _TWO_PI
    si = torch.clamp((rel * (AERIAL_NS / _TWO_PI)).to(torch.int32), 0, AERIAL_NS - 1)
    row = gather_planar(sky.aerial_rows, mi * AERIAL_NS + si)  # [128, N]
    logr = torch.log(torch.clamp(dist, AERIAL_D_MIN, AERIAL_D_MAX) / AERIAL_D_MIN)
    t = logr / _AERIAL_LOG_SPAN * (AERIAL_ND - 1)
    k0 = torch.clamp(t.to(torch.int32), 0, AERIAL_ND - 2)
    w = (t - k0.to(torch.float32))[None, :]
    ks = torch.arange(AERIAL_ND, dtype=torch.int32, device=dist.device)[:, None]
    sel0 = (ks == k0[None, :]).to(torch.float32)
    sel1 = (ks == (k0 + 1)[None, :]).to(torch.float32)
    sel = sel0 * (1.0 - w) + sel1 * w  # [ND, N]

    def curve(base):
        return tuple(
            torch.sum(row[base + c:base + 3 * AERIAL_ND:3] * sel, dim=0)
            for c in range(3))

    fade = torch.clamp(dist / AERIAL_D_MIN, 0.0, 1.0)
    ins = tuple(c * fade for c in curve(0))
    tr = tuple(1.0 + (c - 1.0) * fade for c in curve(48))
    return tr, ins


def sample_env_direction(sky, pixel_id, sample_id, depth, bn=None):
    """Draw a direction toward the environment by cell importance: one
    alias-row lookup picks a lat-long cell (``RandomTarget.LIGHT_AMBIENT``
    sub-stream 2 depth), the direction is uniform in its solid angle
    (sub-stream 2 depth + 1) → (dir Vec3, pdf per steradian [N])."""
    from .random import RandomTarget, random_2d

    k = sky.env_alias_rows.shape[0]
    ch, cw = float(sky.env_ch), float(sky.env_cw)
    r = random_2d(RandomTarget.LIGHT_AMBIENT, pixel_id, sample_id, 2 * depth,
                  bn=bn)
    idx = torch.clamp((r[..., 0] * k).to(torch.int32), max=k - 1)
    row = sky.env_alias_rows[idx.long()]  # [N, 8]
    take_alias = r[..., 1] >= row[:, 0]
    cell = torch.where(take_alias, row[:, 3], row[:, 1]).view(torch.int32)
    pdf_sr = torch.where(take_alias, row[:, 4], row[:, 2])
    cy = torch.div(cell, int(sky.env_cw), rounding_mode="floor").to(torch.float32)
    cx = torch.remainder(cell, int(sky.env_cw)).to(torch.float32)
    j = random_2d(RandomTarget.LIGHT_AMBIENT, pixel_id, sample_id, 2 * depth + 1,
                  bn=bn)
    phi = sdiv(cx + j[..., 0], cw) * _TWO_PI
    ct0 = torch.cos(sdiv(cy, ch) * np.pi)
    ct1 = torch.cos(sdiv(cy + 1.0, ch) * np.pi)
    ct = ct0 + (ct1 - ct0) * j[..., 1]
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    return Vec3(torch.cos(phi) * st, ct, torch.sin(phi) * st), pdf_sr


def env_pdf(sky, d: Vec3) -> torch.Tensor:
    """The pdf per steradian with which sample_env_direction draws ``d``
    (the MIS counterpart of BSDF rays that escape to the sky)."""
    ch, cw = int(sky.env_ch), int(sky.env_cw)
    theta = torch.arccos(torch.clamp(d.y, -1.0, 1.0))
    phi = torch.atan2(d.z, d.x) % _TWO_PI
    cy = torch.clamp((theta * (1.0 / np.pi) * float(ch)).to(torch.int32), 0, ch - 1)
    cx = torch.clamp((phi * (0.5 / np.pi) * float(cw)).to(torch.int32), 0, cw - 1)
    return sky.env_cell_pdf[(cy * cw + cx).long()]


def sun_solid_angle_radiance(sky) -> torch.Tensor:
    """Mean solar-disc radiance used by NEE (zero for constant skies)."""
    return sky.sun_disc_radiance * (0.0 if int(sky.mode) == 2 else 1.0)
