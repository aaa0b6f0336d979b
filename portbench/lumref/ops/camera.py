"""Thin-lens camera rays (port of ``luminary_tpu/ops/camera.py``).

Sensor plane at +Z looking down -Z in camera space, fov is the sensor
half-width at z=1, aperture and focal distances in millimetre lens units,
one subpixel jitter per sample shared by all pixels. A camera with
``use_physical_camera`` also packs its lens prescription (``phys``), and
the integrator then traces its primary rays through the lens stack
(``ops/camera_physical.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .camera_physical import pack_physical_camera
from .random import RandomTarget, quasi_2d, random_1d, random_2d
from .vec import (Vec3, fma32, normalize_fused, quaternion_apply_v, rdiv,
                  sdiv)

CAMERA_COMMON_SCALE = 0.001
CAMERA_COMMON_INV_SCALE = 1.0 / CAMERA_COMMON_SCALE


class DeviceCamera(NamedTuple):
    """Packed camera state: float32 tensors (0-d unless noted)."""

    pos: torch.Tensor  # f32 [3]
    rotation_q: torch.Tensor  # f32 [4] quaternion [w,x,y,z]
    fov: torch.Tensor
    aperture_size: torch.Tensor
    aperture_blade_count: torch.Tensor  # i32
    aperture_shape_bladed: torch.Tensor  # bool
    object_distance: torch.Tensor
    camera_scale: torch.Tensor
    phys: object = None  # DevicePhysicalCamera | None (lens-stack mode)


def pack_camera(camera, device=None) -> DeviceCamera:
    """Scene Camera entity → DeviceCamera on ``device`` (with the lens
    prescription when the camera is physical); None means the card, and
    raises without one."""
    device = resolve_device(device)
    rx, ry, rz = (float(v) * 0.5 for v in camera.rotation)
    cr, sr, cp, sp, cy, sy = (
        np.cos(rx), np.sin(rx), np.cos(ry), np.sin(ry), np.cos(rz), np.sin(rz)
    )
    q = np.asarray(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        np.float32,
    )

    def t(v, dtype=np.float32):
        return torch.as_tensor(np.asarray(v, dtype), device=device)

    return DeviceCamera(
        pos=t(camera.pos),
        rotation_q=t(q),
        fov=t(camera.thin_lens.fov),
        aperture_size=t(camera.thin_lens.aperture_size),
        aperture_blade_count=t(max(camera.aperture_blade_count, 3), np.int32),
        aperture_shape_bladed=t(int(camera.aperture_shape) == 1, np.bool_),
        object_distance=t(camera.object_distance),
        camera_scale=t(camera.camera_scale),
        phys=(pack_physical_camera(camera, device)
              if camera.use_physical_camera else None),
    )


def _sample_aperture(cam: DeviceCamera, pixel_id, sample_id, bn=None) -> Vec3:
    """Aperture point in lens units; weight forced to 1 like the reference."""
    r = random_2d(RandomTarget.LENS, pixel_id, sample_id, bn=bn)
    r0, r1 = r[..., 0], r[..., 1]
    aperture = cam.aperture_size * CAMERA_COMMON_INV_SCALE

    alpha = r0 * (2.0 * np.pi)
    beta = torch.sqrt(r1) * aperture
    round_x = torch.cos(alpha) * beta
    round_y = torch.sin(alpha) * beta

    blades = cam.aperture_blade_count.to(torch.float32)
    blade = torch.floor(
        random_1d(RandomTarget.LENS_BLADE, pixel_id, sample_id, bn=bn) * blades
    )
    a = torch.sqrt(r0)
    u = 1.0 - a
    v = a * r1
    step = rdiv(2.0 * np.pi, blades)
    a1 = step * blade
    a2 = step * (blade + 1.0)
    bladed_x = (torch.sin(a1) * u + torch.sin(a2) * v) * aperture
    bladed_y = (torch.cos(a1) * u + torch.cos(a2) * v) * aperture

    open_ap = cam.aperture_size > 0.0
    x = torch.where(open_ap, torch.where(cam.aperture_shape_bladed, bladed_x,
                                         round_x), 0.0)
    y = torch.where(open_ap, torch.where(cam.aperture_shape_bladed, bladed_y,
                                         round_y), 0.0)
    return Vec3(x, y, torch.zeros_like(x))


def generate_camera_rays(cam: DeviceCamera, width: int, height: int,
                         pixel_x, pixel_y, pixel_id, sample_id, bn=None):
    """Thin-lens primary rays → (origin, direction) Vec3s in world space.
    On the card one launch of ``csrc/shading.cu`` ``lum_camera_ray`` after
    the random numbers; elsewhere :func:`_camera_ray_plain`."""
    # [1, 2] for one sample id, [N, 2] for per-lane ids (the benchmark's
    # reference renders several samples in one wavefront)
    jitter = quasi_2d(
        RandomTarget.CAMERA_JITTER,
        torch.zeros((1,), dtype=torch.int64, device=pixel_x.device), sample_id,
    )
    aperture_point = _sample_aperture(cam, pixel_id, sample_id, bn=bn)
    return _camera_ray_plain(cam, width, height, pixel_x, pixel_y, jitter,
                             aperture_point)


_F32_INV_SCALE = float(np.float32(CAMERA_COMMON_INV_SCALE))
_F32_SCALE = float(np.float32(CAMERA_COMMON_SCALE))


def _camera_ray_plain(cam: DeviceCamera, width: int, height: int, pixel_x,
                      pixel_y, jitter, aperture_point: Vec3):
    """Plain PyTorch version of :func:`generate_camera_rays` after its
    random numbers (``jitter`` [1, 2] or [N, 2], the aperture point).

    The direction is rounded as the reference's compiled code rounds it:
    XLA's CPU back end contracts each product that has one use into the add
    or subtract that consumes it (fma32), here the sensor point, both
    normalizations, the aperture offset and the rotation. So the rays of a
    closed aperture equal the reference's bit for bit."""
    jx, jy = jitter[..., 0], jitter[..., 1]
    step = sdiv(2.0 * cam.fov, width)
    vfov = step * height * 0.5
    sx = fma32(-step, pixel_x.to(torch.float32) + jx, cam.fov)
    sy = fma32(step, pixel_y.to(torch.float32) + jy, -vfov)
    sensor = Vec3(sx, sy, torch.ones_like(sx))

    to_focal = normalize_fused(-sensor)
    focal_len = torch.clamp(cam.object_distance * CAMERA_COMMON_INV_SCALE,
                            min=0.01)
    scale = -focal_len / to_focal.z

    direction = normalize_fused(Vec3(
        fma32(to_focal.x, scale, -aperture_point.x),
        fma32(to_focal.y, scale, -aperture_point.y),
        to_focal.z * scale - aperture_point.z))

    qw, qx, qy, qz = cam.rotation_q.unbind(0)
    origin = quaternion_apply_v(qw, qx, qy, qz, aperture_point)
    s = cam.camera_scale * CAMERA_COMMON_SCALE
    origin = Vec3(
        origin.x * s + cam.pos[0],
        origin.y * s + cam.pos[1],
        origin.z * s + cam.pos[2],
    )
    direction = _rotate_fused(qw, qx, qy, qz, direction)
    return origin, direction


def _rotate_fused(qw, qx, qy, qz, v: Vec3) -> Vec3:
    """:func:`quaternion_apply_v` with the reference's compiled rounding:
    the dot products, the cross product and the three-term sum contracted
    as XLA's CPU code contracts them."""
    dot_uv = fma32(qz, v.z, fma32(qx, v.x, qy * v.y))
    k2 = fma32(qw, qw, -fma32(qz, qz, fma32(qx, qx, qy * qy)))
    k3 = 2.0 * qw
    c = Vec3(fma32(qy, v.z, -(qz * v.y)), fma32(qz, v.x, -(qx * v.z)),
             fma32(qx, v.y, -(qy * v.x)))
    return Vec3(*(fma32(k3, ci, fma32(k2, vi, (2.0 * ui) * dot_uv))
                  for ui, vi, ci in ((qx, v.x, c.x), (qy, v.y, c.y), (qz, v.z, c.z))))
