"""Physical lens camera (port of ``luminary_tpu/ops/camera_physical.py``):
primary rays traced element by element through a lens stack, with Abbe
dispersion.

The default prescription is generated: a cemented achromatic doublet for
the requested focal length (crown K9-like and flint F2-like glasses, the
classic thin-lens achromat split). Each lane traces one wavelength when the
camera's own spectral switch is on (the d-line otherwise); its throughput
becomes RGB through the analytic CIE 1931 fits. A ray dies where it misses
an element's sphere, falls outside its clear aperture or is totally
internally reflected; its weight is then 0.

Lens space: the optical axis is +z, the sensor sits at z = -image_plane
distance behind the rear vertex (z = 0); rays leave toward -z in camera
space, as the thin-lens model's do. The prescription is a handful of 0-d
and ``[K]`` float32 tensors on the render device, so every scalar step
rounds in float32 as the reference's does; square roots are correctly
rounded (``sqrt_rn``), as the reference's are, because the trace through
a wide stop amplifies an ulp.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .random import RandomTarget, random_1d, random_2d
from .vec import Vec3, normalize_rn, quaternion_apply_v, rdiv, sdiv, sqrt_rn

# Fraunhofer lines (micrometres) of the Abbe-number dispersion
_LAMBDA_D = 0.5876
_LAMBDA_F = 0.4861
_LAMBDA_C = 0.6563
_DISP_NORM = 1.0 / (1.0 / _LAMBDA_F**2 - 1.0 / _LAMBDA_C**2)
_INV_LD2 = 1.0 / _LAMBDA_D**2


class DevicePhysicalCamera(NamedTuple):
    """A packed lens prescription: float32 tensors (0-d unless noted)."""

    radius: torch.Tensor  # [K] sphere radius (signed; 0 = planar/stop)
    vertex: torch.Tensor  # [K] vertex z (lens units, mm)
    clear_radius: torch.Tensor  # [K] clear semi-diameter
    ior: torch.Tensor  # [K+1] design ior of the medium before interface i
    abbe: torch.Tensor  # [K+1] Abbe number (0 = no dispersion)
    sensor_z: torch.Tensor  # negative: behind the rear vertex
    sensor_half_w: torch.Tensor  # mm
    aperture_radius: torch.Tensor  # mm, at the front element
    spectral: torch.Tensor  # bool


def achromat_prescription(focal_length_m: float, aperture_diameter_m: float):
    """A cemented achromatic doublet for the given focal length: crown
    (n1, V1) and flint (n2, V2) with powers P1 = P V1 / (V1 - V2) and
    P2 = -P V2 / (V1 - V2), so that the focal shift cancels between the F
    and C lines; an equi-convex crown shares its rear radius with the
    flint. Returns (interfaces [K, 3], media [K+1, 2]) in millimetres."""
    f = focal_length_m * 1000.0  # mm
    n1, v1 = 1.5168, 64.17  # crown (BK7-class)
    n2, v2 = 1.6200, 36.37  # flint (F2-class)
    p = 1.0 / f
    p1 = p * v1 / (v1 - v2)
    p2 = -p * v2 / (v1 - v2)
    r1 = 2.0 * (n1 - 1.0) / p1  # equi-convex crown: R1 = -R2
    r2 = -r1
    # the flint's rear radius from its lensmaker equation, front radius R2
    r3 = 1.0 / (1.0 / r2 - p2 / (n2 - 1.0))
    clear = max(aperture_diameter_m * 1000.0 * 0.5, 1.0) * 1.25
    t1, t2 = clear * 0.45, clear * 0.25  # element thicknesses
    interfaces = np.asarray(
        [
            [r3, 0.0, clear],        # rear flint surface (nearest the sensor)
            [r2, t2, clear],         # cemented interface
            [r1, t2 + t1, clear],    # front crown surface
        ],
        np.float32,
    )
    media = np.asarray(
        [
            [1.0, 0.0],   # air (sensor side)
            [n2, v2],     # flint
            [n1, v1],     # crown
            [1.0, 0.0],   # air (world side)
        ],
        np.float32,
    )
    return interfaces, media


def pack_physical_camera(camera, device) -> DevicePhysicalCamera:
    """The camera's physical parameters → DevicePhysicalCamera on
    ``device`` (an explicit ``interfaces`` / ``media`` prescription on the
    parameters is taken as is, else the generated achromat)."""
    p = camera.physical
    interfaces = getattr(p, "interfaces", None)
    media = getattr(p, "media", None)
    if interfaces is None or media is None:
        ap = p.aperture_diameter if p.aperture_diameter > 0 else 0.01
        interfaces, media = achromat_prescription(p.focal_length, ap)
    interfaces = np.asarray(interfaces, np.float32).reshape(-1, 3)
    media = np.asarray(media, np.float32).reshape(-1, 2)
    k = interfaces.shape[0]
    if media.shape[0] != k + 1:
        raise ValueError("a lens prescription needs K+1 media for K interfaces")
    sensor_z = -abs(p.image_plane_distance) * 1000.0

    def t(v, dtype=np.float32):
        return torch.as_tensor(np.array(v, dtype), device=device)

    return DevicePhysicalCamera(
        radius=t(interfaces[:, 0]),
        vertex=t(interfaces[:, 1]),
        clear_radius=t(interfaces[:, 2]),
        ior=t(media[:, 0]),
        abbe=t(media[:, 1]),
        sensor_z=t(sensor_z),
        sensor_half_w=t(p.sensor_width * 1000.0 * 0.5),
        aperture_radius=t((p.aperture_diameter if p.aperture_diameter > 0
                           else 0.01) * 1000.0 * 0.5),
        spectral=t(bool(p.use_spectral_rendering), np.bool_),
    )


def _ior_at(n_d, abbe, lam_um):
    """Design ior + Abbe number → ior at the wavelength (a Cauchy-style
    model normalised to n_F - n_C = (n_d - 1) / V)."""
    dn = torch.where(
        abbe > 0.0,
        (n_d - 1.0) / torch.clamp(abbe, min=1e-3)
        * (rdiv(1.0, lam_um * lam_um) - _INV_LD2) * _DISP_NORM,
        0.0,
    )
    return n_d + dn


def cie_fit_xyz(lam_nm):
    """Analytic CIE 1931 colour matching fits (Wyman-Sloan-Shirley 2013)."""

    def g(x, mu, s1, s2):
        t = (x - mu) * torch.where(x < mu, 1.0 / s1, 1.0 / s2)
        return torch.exp(-0.5 * t * t)

    x = (1.056 * g(lam_nm, 599.8, 37.9, 31.0)
         + 0.362 * g(lam_nm, 442.0, 16.0, 26.7)
         - 0.065 * g(lam_nm, 501.1, 20.4, 26.2))
    y = (0.821 * g(lam_nm, 568.8, 46.9, 40.5)
         + 0.286 * g(lam_nm, 530.9, 16.3, 31.1))
    z = (1.217 * g(lam_nm, 437.0, 11.8, 36.0)
         + 0.681 * g(lam_nm, 459.0, 26.0, 13.8))
    return x, y, z


def xyz_to_rgb(x, y, z):
    """CIE XYZ → linear sRGB."""
    r = 3.2406 * x - 1.5372 * y - 0.4986 * z
    g = -0.9689 * x + 1.8758 * y + 0.0415 * z
    b = 0.0557 * x - 0.2040 * y + 1.0570 * z
    return r, g, b


def _refract_sphere(o: Vec3, d: Vec3, radius, vertex, clear_r, eta_i, eta_t):
    """Intersect and refract at one spherical interface on the optical axis
    (a planar one, radius 0, refracts about the axis) → (o', d', alive)."""
    planar = torch.abs(radius) < 1e-6
    r_safe = torch.where(planar, 1.0, radius)
    cz = vertex + r_safe  # the sphere's centre on the axis

    # the sphere's vertex-side root: -sq for R > 0, +sq otherwise
    ocz = o.z - cz
    b = o.x * d.x + o.y * d.y + ocz * d.z
    c = o.x * o.x + o.y * o.y + ocz * ocz - r_safe * r_safe
    disc = b * b - c
    ok = disc > 0.0
    sq = sqrt_rn(torch.clamp(disc, min=0.0))
    t_sph = torch.where(r_safe > 0.0, -b - sq, -b + sq)
    t_pln = (vertex - o.z) / torch.where(torch.abs(d.z) < 1e-9, 1e-9, d.z)
    t = torch.where(planar, t_pln, t_sph)
    ok = torch.where(planar, t_pln > 1e-6, ok & (t_sph > 1e-6))

    hx = o.x + d.x * t
    hy = o.y + d.y * t
    hz = o.z + d.z * t
    ok = ok & (hx * hx + hy * hy <= clear_r * clear_r)

    # the normal, flipped against the ray
    inv_r = rdiv(1.0, r_safe)
    nx = torch.where(planar, 0.0, hx * inv_r)
    ny = torch.where(planar, 0.0, hy * inv_r)
    nz = torch.where(planar, -1.0, (hz - cz) * inv_r)
    ndd = nx * d.x + ny * d.y + nz * d.z
    s = torch.where(ndd > 0.0, -1.0, 1.0)
    nx, ny, nz = nx * s, ny * s, nz * s
    cos_i = -(nx * d.x + ny * d.y + nz * d.z)

    eta = eta_i / eta_t
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t > 1.0
    cos_t = sqrt_rn(torch.clamp(1.0 - sin2_t, 0.0, 1.0))
    k = eta * cos_i - cos_t
    dx = eta * d.x + k * nx
    dy = eta * d.y + k * ny
    dz = eta * d.z + k * nz
    alive = ok & ~tir
    return Vec3(hx, hy, hz), normalize_rn(Vec3(dx, dy, dz)), alive


def generate_physical_camera_rays(cam, phys: DevicePhysicalCamera, width: int,
                                  height: int, pixel_x, pixel_y, pixel_id,
                                  sample_id):
    """Primary rays through the lens stack → (origin, direction, (wr, wg,
    wb) throughput weight [N]); dead rays (vignetted or TIR) weigh 0."""
    # the sensor point (mm, lens space): x right, y up, at sensor_z
    jr = random_2d(RandomTarget.CAMERA_JITTER, pixel_id, sample_id)
    half_w = phys.sensor_half_w
    step = sdiv(2.0 * half_w, float(width))
    sx = half_w - step * (pixel_x.to(torch.float32) + jr[..., 0])
    sy = -(step * height * 0.5) + step * (pixel_y.to(torch.float32) + jr[..., 1])
    o = Vec3(sx, sy, phys.sensor_z.expand(sx.shape))

    # aim at a point drawn on the rear element's clear aperture
    ra = random_2d(RandomTarget.LENS, pixel_id, sample_id)
    ang = ra[..., 0] * (2.0 * math.pi)
    rad = sqrt_rn(ra[..., 1]) * torch.minimum(phys.aperture_radius,
                                                 phys.clear_radius[0])
    ax = torch.cos(ang) * rad
    ay = torch.sin(ang) * rad
    d = normalize_rn(Vec3(ax - o.x, ay - o.y,
                       -phys.sensor_z * torch.ones_like(o.x)))

    # one wavelength per lane (the camera's spectral switch) or the d-line
    lam_u = random_1d(RandomTarget.WAVELENGTH, pixel_id, sample_id)
    lam_nm = 380.0 + lam_u * 320.0
    spectral = phys.spectral
    lam_um = torch.where(spectral, lam_nm * 1e-3, _LAMBDA_D)

    alive = torch.ones(sx.shape, dtype=torch.bool, device=sx.device)
    for i in range(phys.radius.shape[0]):
        eta_i = _ior_at(phys.ior[i], phys.abbe[i], lam_um)
        eta_t = _ior_at(phys.ior[i + 1], phys.abbe[i + 1], lam_um)
        o2, d2, ok = _refract_sphere(o, d, phys.radius[i], phys.vertex[i],
                                     phys.clear_radius[i], eta_i, eta_t)
        o = Vec3(torch.where(ok, o2.x, o.x), torch.where(ok, o2.y, o.y),
                 torch.where(ok, o2.z, o.z))
        d = Vec3(torch.where(ok, d2.x, d.x), torch.where(ok, d2.y, d.y),
                 torch.where(ok, d2.z, d.z))
        alive = alive & ok

    # the single-wavelength estimate → RGB by the CIE fits (Y-normalised:
    # the pdf is uniform over 320 nm, and a flat spectrum integrates to 1)
    cx, cy, cz = cie_fit_xyz(lam_nm)
    scale = 320.0 / 106.857  # ∫ ȳ dλ of the fit
    wr_s, wg_s, wb_s = xyz_to_rgb(cx * scale, cy * scale, cz * scale)
    one = torch.ones_like(cx)
    wr = torch.where(spectral, wr_s, one)
    wg = torch.where(spectral, wg_s, one)
    wb = torch.where(spectral, wb_s, one)
    live = alive.to(torch.float32)
    wr, wg, wb = wr * live, wg * live, wb * live

    # lens space → camera space (x right, y up, looking down -z; the lens
    # axis +z points into the scene) → world space
    cs = cam.camera_scale
    o_cam = Vec3(o.x * 0.001 * cs, o.y * 0.001 * cs, -o.z * 0.001 * cs)
    d_cam = Vec3(d.x, d.y, -d.z)
    qw, qx, qy, qz = cam.rotation_q.unbind(0)
    o_w = quaternion_apply_v(qw, qx, qy, qz, o_cam)
    d_w = quaternion_apply_v(qw, qx, qy, qz, d_cam)
    origin = Vec3(o_w.x + cam.pos[0], o_w.y + cam.pos[1], o_w.z + cam.pos[2])
    return origin, normalize_rn(d_w), (wr, wg, wb)
