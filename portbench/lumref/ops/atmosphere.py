"""Physical sky: spherical single-scattering atmosphere with a multiscatter
approximation, transmittance LUT and bakes (port of
``luminary_tpu/ops/atmosphere.py``).

Everything here is plain PyTorch run once at pack time on the scene's device:
the transmittance and multiscatter LUTs, the lat-long environment bake and
the aerial-perspective distance-curve rows. Units are kilometres. Every
LUT and bake is generic in its channel count: RGB, or the 8 sky bands of
spectral rendering (``atmo_params_from_sky(..., spectral=True)``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import math3
from .spectral import ozone_beta_bands, rayleigh_beta_bands
from .vec import rdiv

EARTH_RADIUS = 6371.0
ATMO_HEIGHT = 100.0
ATMO_RADIUS = EARTH_RADIUS + ATMO_HEIGHT

BETA_RAYLEIGH = np.asarray([5.802e-3, 13.558e-3, 33.1e-3])
BETA_MIE_SCATTER = 3.996e-3
BETA_MIE_ABSORB = 4.4e-4
BETA_OZONE_ABS = np.asarray([0.650e-3, 1.881e-3, 0.085e-3])

TRANSMITTANCE_W, TRANSMITTANCE_H = 256, 64
MULTISCATTER_RES = 32

AERIAL_NU = 16   # view zenith bins
AERIAL_NS = 8    # sun-relative azimuth bins
AERIAL_ND = 16   # log distance knots
AERIAL_D_MIN = 0.02   # km
AERIAL_D_MAX = 64.0   # km


class AtmoParams(NamedTuple):
    """Atmosphere parameters: float32 tensors, [C] for the spectra (C = 3
    RGB channels or the 8 sky bands)."""

    beta_r: torch.Tensor
    beta_ms: torch.Tensor
    beta_ma: torch.Tensor
    beta_o: torch.Tensor
    base_density: torch.Tensor
    rayleigh_density: torch.Tensor
    mie_density: torch.Tensor
    ozone_density: torch.Tensor
    rayleigh_falloff: torch.Tensor
    mie_falloff: torch.Tensor
    ozone_layer_thickness: torch.Tensor
    ozone_absorption: torch.Tensor
    multiscattering_factor: torch.Tensor
    ground_visibility: torch.Tensor
    mie_g: torch.Tensor


def _f32(v, device):
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def atmo_params_from_sky(sky, device, spectral: bool = False) -> AtmoParams:
    """The Sky entity's atmosphere on ``device``: RGB spectra, or with
    ``spectral`` the Rayleigh and ozone spectra at the 8 sky bands."""
    g = torch.clamp(
        0.5 + 0.2 * torch.log10(torch.clamp(_f32(sky.mie_diameter, device), min=0.1)),
        0.2, 0.95)
    return AtmoParams(
        beta_r=_f32(rayleigh_beta_bands() if spectral else BETA_RAYLEIGH, device),
        beta_ms=_f32(BETA_MIE_SCATTER, device),
        beta_ma=_f32(BETA_MIE_ABSORB, device),
        beta_o=_f32(ozone_beta_bands() if spectral else BETA_OZONE_ABS, device),
        base_density=_f32(sky.base_density, device),
        rayleigh_density=_f32(sky.rayleigh_density, device),
        mie_density=_f32(sky.mie_density, device),
        ozone_density=_f32(sky.ozone_density, device),
        rayleigh_falloff=_f32(sky.rayleigh_falloff, device),
        mie_falloff=_f32(sky.mie_falloff, device),
        ozone_layer_thickness=_f32(sky.ozone_layer_thickness, device),
        ozone_absorption=_f32(1.0 if sky.ozone_absorption else 0.0, device),
        multiscattering_factor=_f32(sky.multiscattering_factor, device),
        ground_visibility=_f32(sky.ground_visibility, device),
        mie_g=g,
    )


def _densities(p: AtmoParams, h):
    """(rayleigh, mie, ozone) relative densities at height h (km)."""
    h = torch.clamp(h, min=0.0)
    d_r = p.base_density * p.rayleigh_density * torch.exp(-h / p.rayleigh_falloff)
    d_m = p.base_density * p.mie_density * torch.exp(-h / p.mie_falloff)
    d_o = (
        p.base_density
        * p.ozone_density
        * p.ozone_absorption
        * torch.clamp(1.0 - torch.abs(h - 25.0)
                      / torch.clamp(p.ozone_layer_thickness, min=1e-3), min=0.0)
    )
    return d_r, d_m, d_o


def _ray_sphere_exit(o, d, radius):
    b = math3.dot(o, d)
    c = math3.dot(o, o) - radius * radius
    disc = torch.clamp(b * b - c, min=0.0)
    return -b + torch.sqrt(disc)


def _ray_sphere_entry(o, d, radius):
    b = math3.dot(o, d)
    c = math3.dot(o, o) - radius * radius
    disc = b * b - c
    hit = disc >= 0.0
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    return torch.where(hit & (t > 0.0), t, float("inf"))


def _fracs(steps: int, device):
    return (torch.arange(steps, dtype=torch.float32, device=device) + 0.5) / steps


def optical_depth(p: AtmoParams, origin, direction, dist, steps: int = 32):
    """∫ extinction along [0, dist]; origin planet-centred (km), [..., 3]."""
    dt = dist / steps
    tau = torch.zeros(origin.shape[:-1] + (p.beta_r.shape[0],),
                      device=origin.device)
    for frac in _fracs(steps, origin.device):
        pos = origin + direction * (frac * dist)[..., None]
        h = math3.length(pos) - EARTH_RADIUS
        d_r, d_m, d_o = _densities(p, h)
        ext = (p.beta_r * d_r[..., None]
               + (p.beta_ms + p.beta_ma) * d_m[..., None]
               + p.beta_o * d_o[..., None])
        tau = tau + ext * dt[..., None]
    return tau


def transmittance_to_space(p: AtmoParams, height, cos_zenith, steps: int = 40):
    zeros = torch.zeros_like(height)
    o = torch.stack([zeros, height + EARTH_RADIUS, zeros], dim=-1)
    sin_z = torch.sqrt(torch.clamp(1.0 - cos_zenith ** 2, min=0.0))
    d = torch.stack([sin_z, cos_zenith, zeros], dim=-1)
    dist = _ray_sphere_exit(o, d, ATMO_RADIUS)
    return torch.exp(-optical_depth(p, o, d, dist, steps))


def build_transmittance_lut(p: AtmoParams) -> torch.Tensor:
    """[H, W, 3] LUT over (height, cos_zenith)."""
    dev = p.beta_r.device
    hs = torch.linspace(0.0, ATMO_HEIGHT, TRANSMITTANCE_H, device=dev)
    mus = torch.linspace(-0.3, 1.0, TRANSMITTANCE_W, device=dev)
    hh, mm = torch.meshgrid(hs, mus, indexing="ij")
    return transmittance_to_space(p, hh.reshape(-1), mm.reshape(-1)).reshape(
        TRANSMITTANCE_H, TRANSMITTANCE_W, p.beta_r.shape[0])


def _bilinear(lut, hi, mi, n_h, n_m):
    h0 = torch.clamp(hi.to(torch.int32), 0, n_h - 2).long()
    m0 = torch.clamp(mi.to(torch.int32), 0, n_m - 2).long()
    fh = (hi - h0)[..., None]
    fm = (mi - m0)[..., None]
    return (lut[h0, m0] * (1 - fh) * (1 - fm)
            + lut[h0 + 1, m0] * fh * (1 - fm)
            + lut[h0, m0 + 1] * (1 - fh) * fm
            + lut[h0 + 1, m0 + 1] * fh * fm)


def sample_transmittance_lut(lut, height, cos_zenith):
    """Bilinear fetch from the (height, mu) LUT."""
    hi = torch.clamp(height / ATMO_HEIGHT, 0.0, 1.0) * (TRANSMITTANCE_H - 1)
    mi = torch.clamp((cos_zenith + 0.3) / 1.3, 0.0, 1.0) * (TRANSMITTANCE_W - 1)
    return _bilinear(lut, hi, mi, TRANSMITTANCE_H, TRANSMITTANCE_W)


def sample_multiscatter_lut(lut, height, cos_sun_zenith):
    hi = torch.clamp(height / ATMO_HEIGHT, 0.0, 1.0) * (MULTISCATTER_RES - 1)
    mi = torch.clamp((cos_sun_zenith + 1.0) / 2.0, 0.0, 1.0) * (MULTISCATTER_RES - 1)
    return _bilinear(lut, hi, mi, MULTISCATTER_RES, MULTISCATTER_RES)


def _rayleigh_phase(c):
    return 3.0 / (16.0 * np.pi) * (1.0 + c * c)


def _hg_phase(c, g):
    g2 = g * g
    return (1.0 - g2) / (4.0 * np.pi * torch.pow(1.0 + g2 - 2.0 * g * c, 1.5))


def _horizon_mu(r):
    q = rdiv(EARTH_RADIUS, torch.clamp(r, min=EARTH_RADIUS))
    return -torch.sqrt(torch.clamp(1.0 - q * q, min=0.0))


def single_scatter(p: AtmoParams, t_lut, origin, direction, sun_dir,
                   sun_irradiance, steps: int = 40, multiscatter_lut=None):
    """In-scattered radiance along view rays to the atmosphere boundary (or
    the ground) → (radiance [..., 3], view transmittance [..., 3])."""
    dist_space = _ray_sphere_exit(origin, direction, ATMO_RADIUS)
    dist_ground = _ray_sphere_entry(origin, direction, EARTH_RADIUS)
    hits_ground = torch.isfinite(dist_ground)
    dist = torch.where(hits_ground, dist_ground, dist_space)

    cos_theta = math3.dot(direction, sun_dir)
    ph_r = _rayleigh_phase(cos_theta)[..., None]
    ph_m = _hg_phase(cos_theta, p.mie_g)[..., None]

    dt = dist / steps
    c = p.beta_r.shape[0]
    tau_acc = torch.zeros(origin.shape[:-1] + (c,), device=origin.device)
    radiance = torch.zeros_like(tau_acc)
    for frac in _fracs(steps, origin.device):
        pos = origin + direction * (frac * dist)[..., None]
        r = math3.length(pos)
        h = r - EARTH_RADIUS
        d_r, d_m, d_o = _densities(p, h)
        ext = (p.beta_r * d_r[..., None]
               + (p.beta_ms + p.beta_ma) * d_m[..., None]
               + p.beta_o * d_o[..., None])
        seg_tau = ext * dt[..., None]
        t_view = torch.exp(-(tau_acc + 0.5 * seg_tau))
        cos_sun_zen = math3.dot(pos, sun_dir) / torch.clamp(r, min=1e-6)
        t_sun = sample_transmittance_lut(t_lut, h, cos_sun_zen)
        lit = (cos_sun_zen > _horizon_mu(r)).to(torch.float32)[..., None]
        scat_r = p.beta_r * d_r[..., None]
        scat_m = p.beta_ms * d_m[..., None]
        inscatter = (scat_r * ph_r + scat_m * ph_m) * t_sun * lit
        if multiscatter_lut is not None:
            ms = sample_multiscatter_lut(multiscatter_lut, h, cos_sun_zen)
            inscatter = inscatter + (scat_r + scat_m) * ms * p.multiscattering_factor
        radiance = radiance + inscatter * t_view * dt[..., None] * sun_irradiance
        tau_acc = tau_acc + seg_tau
    t_view_total = torch.exp(-tau_acc)

    ground_pos = origin + direction * dist[..., None]
    g_up = math3.normalize(ground_pos)
    g_cos = torch.clamp(math3.dot(g_up, sun_dir), min=0.0)
    g_t_sun = sample_transmittance_lut(t_lut, torch.zeros_like(dist),
                                       math3.dot(g_up, sun_dir))
    ground_albedo = 0.25
    ground = (hits_ground[..., None] * (ground_albedo / np.pi)
              * g_cos[..., None] * g_t_sun * t_view_total * sun_irradiance)
    return radiance + ground, t_view_total


def build_multiscatter_lut(p: AtmoParams, t_lut) -> torch.Tensor:
    """Hillaire Psi_ms on a 32² grid over (height, sun cos zenith)."""
    dev = p.beta_r.device
    res = MULTISCATTER_RES
    hs = torch.linspace(0.0, ATMO_HEIGHT, res, device=dev)
    mus = torch.linspace(-1.0, 1.0, res, device=dev)
    hh, mm = torch.meshgrid(hs, mus, indexing="ij")
    h_flat = hh.reshape(-1)
    mu_flat = mm.reshape(-1)

    nd = 8
    i = (torch.arange(nd, dtype=torch.float32, device=dev) + 0.5) / nd
    phi = 2.0 * np.pi * i
    cos_t = 1.0 - 2.0 * i
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t ** 2, min=0.0))
    dirs = torch.stack(
        [sin_t[:, None] * torch.cos(phi)[None, :],
         cos_t[:, None].expand(nd, nd),
         sin_t[:, None] * torch.sin(phi)[None, :]], dim=-1).reshape(-1, 3)

    e = h_flat.shape[0]
    k = dirs.shape[0]
    zeros = torch.zeros_like(h_flat)
    o = torch.stack([zeros, torch.ones_like(h_flat) * (EARTH_RADIUS + h_flat),
                     zeros], dim=-1)
    sun = torch.stack([torch.sqrt(torch.clamp(1.0 - mu_flat ** 2, min=0.0)),
                       mu_flat, zeros], dim=-1)
    rad, _ = single_scatter(
        p, t_lut, o[:, None, :].expand(e, k, 3), dirs[None].expand(e, k, 3),
        sun[:, None, :].expand(e, k, 3), 1.0, steps=16, multiscatter_lut=None)
    l2 = torch.mean(rad, dim=1)  # [E, 3]
    d_r, d_m, _ = _densities(p, h_flat)
    mb = torch.mean(p.beta_r)
    f = torch.clamp(
        (mb * d_r + p.beta_ms * d_m)
        / torch.clamp(mb * d_r + (p.beta_ms + p.beta_ma) * d_m + 1e-9, min=1e-9)
        * 0.7, 0.0, 0.95)
    vals = l2 / (1.0 - f)[:, None]
    return vals.reshape(res, res, p.beta_r.shape[0])


def latlong_dirs(height: int, width: int, device) -> torch.Tensor:
    """Texel-centre directions of a lat-long map → [H*W, 3] (y up)."""
    v = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) / height
    u = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) / width
    theta = v * np.pi
    phi = u * 2.0 * np.pi
    st = torch.sin(theta)[:, None]
    return torch.stack(
        [(st * torch.cos(phi)[None, :]).expand(height, width),
         torch.cos(theta)[:, None].expand(height, width),
         (st * torch.sin(phi)[None, :]).expand(height, width)],
        dim=-1).reshape(-1, 3)


def bake_sky_envmap(p: AtmoParams, t_lut, ms_lut, observer_height, sun_dir,
                    sun_irradiance, width: int = 512, height: int = 256,
                    steps: int = 40) -> torch.Tensor:
    """Lat-long environment map of the sky (no solar disc) → [H, W, 3]."""
    dirs = latlong_dirs(height, width, sun_dir.device)
    o = torch.tensor([0.0, 1.0, 0.0], device=sun_dir.device) * (
        EARTH_RADIUS + observer_height)
    rad, _ = single_scatter(
        p, t_lut, o.expand(dirs.shape), dirs, sun_dir.expand(dirs.shape),
        sun_irradiance, steps=steps, multiscatter_lut=ms_lut)
    return rad.reshape(height, width, p.beta_r.shape[0])


def bake_aerial_rows(p: AtmoParams, t_lut, ms_lut, observer_height, sun_dir,
                     sun_irradiance) -> torch.Tensor:
    """Aerial-perspective rows [NU*NS, 128]: cols 0:48 inscattered RGB at 16
    log-spaced distances, cols 48:96 transmittance RGB at the same knots."""
    dev = sun_dir.device
    mus = (torch.arange(AERIAL_NU, dtype=torch.float32, device=dev) + 0.5) / AERIAL_NU * 2.0 - 1.0
    azs = (torch.arange(AERIAL_NS, dtype=torch.float32, device=dev) + 0.5) / AERIAL_NS * 2.0 * np.pi
    sx, sy, sz = sun_dir[0], sun_dir[1], sun_dir[2]
    s_h = torch.sqrt(torch.clamp(sx * sx + sz * sz, min=1e-12))
    fx, fz = sx / s_h, sz / s_h
    mu_g, az_g = torch.meshgrid(mus, azs, indexing="ij")
    mu_f = mu_g.reshape(-1)
    az_f = az_g.reshape(-1)
    sin_t = torch.sqrt(torch.clamp(1.0 - mu_f ** 2, min=0.0))
    hx = torch.cos(az_f) * fx - torch.sin(az_f) * fz
    hz = torch.cos(az_f) * fz + torch.sin(az_f) * fx
    dirs = torch.stack([sin_t * hx, mu_f, sin_t * hz], dim=-1)

    r = dirs.shape[0]
    o = torch.tensor([0.0, 1.0, 0.0], device=dev) * (EARTH_RADIUS + observer_height)
    o_b = o.expand(r, 3)
    sun_b = torch.stack([sx, sy, sz]).expand(r, 3)

    dists = torch.exp(torch.linspace(
        float(np.log(np.float32(AERIAL_D_MIN))), float(np.log(np.float32(AERIAL_D_MAX))),
        AERIAL_ND, device=dev))
    cos_theta = math3.dot(dirs, sun_b)
    ph_r = _rayleigh_phase(cos_theta)[..., None]
    ph_m = _hg_phase(cos_theta, p.mie_g)[..., None]

    sub = 4
    tau = torch.zeros((r, 3), device=dev)
    rad = torch.zeros((r, 3), device=dev)
    rows = torch.zeros((r, 128), device=dev)
    d_prev = torch.zeros((), device=dev)
    for k in range(AERIAL_ND):
        d_k = dists[k]
        seg = (d_k - d_prev) / sub
        for s_i in range(sub):
            t_mid = d_prev + (s_i + 0.5) * seg
            pos = o_b + dirs * t_mid
            rr = math3.length(pos)
            h = rr - EARTH_RADIUS
            d_r, d_m, d_o = _densities(p, h)
            ext = (p.beta_r * d_r[..., None]
                   + (p.beta_ms + p.beta_ma) * d_m[..., None]
                   + p.beta_o * d_o[..., None])
            t_view = torch.exp(-(tau + 0.5 * ext * seg))
            cos_sun_zen = math3.dot(pos, sun_b) / torch.clamp(rr, min=1e-6)
            t_sun = sample_transmittance_lut(t_lut, h, cos_sun_zen)
            lit = (cos_sun_zen > _horizon_mu(rr)).to(torch.float32)[..., None]
            scat_r = p.beta_r * d_r[..., None]
            scat_m = p.beta_ms * d_m[..., None]
            inscatter = (scat_r * ph_r + scat_m * ph_m) * t_sun * lit
            ms = sample_multiscatter_lut(ms_lut, h, cos_sun_zen)
            inscatter = inscatter + (scat_r + scat_m) * ms * p.multiscattering_factor
            rad = rad + inscatter * t_view * seg * sun_irradiance
            tau = tau + ext * seg
        rows[:, 3 * k:3 * k + 3] = rad
        rows[:, 48 + 3 * k:48 + 3 * k + 3] = torch.exp(-tau)
        d_prev = d_k
    return rows
