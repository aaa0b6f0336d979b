"""Procedural volumetric clouds (port of ``luminary_tpu/ops/clouds.py``):
three layers (low, mid, top) of value-noise FBM density, raymarched for sky
misses (and folded into the HDRI bake) with a short sun-shadow march per
step and a dual-lobe Henyey-Greenstein phase; a coarse march of the sun
segment gives cloud shadows on surfaces.

The lattice hash is the reference's ``fract(sin(h) * 43758.5453)``, in
which one ulp of h gives a new hash value. The port rounds h as the
reference's compiled code does (see ``value_noise3``): plain in its shadow
march and cloud shadows, fused multiply-adds in the step of its march. The
sin is the one the compiled code calls, glibc's ``sinf`` (``ops/libm.py``),
the same on the card and the CPU. On equal inputs the march then agrees
with the reference's compiled march lane by lane (tests/test_torch_clouds.py).

On the card :func:`cloud_march` and :func:`cloud_sun_transmittance` are
kernels (``csrc/clouds.cu``): one thread walks a lane's whole march, or a
point's shadow march through every layer, with each density evaluation in
registers. Their plain versions, which the CPU takes, are
:func:`_cloud_march_plain` and :func:`_cloud_sun_transmittance_plain`. The
plain march keeps the reference's step loops as loops where they carry
state (the transmittance and radiance of a march). The densities a march
reads do not depend on that state, so each layer's densities (every step,
and every shadow step of every step) are evaluated as stacked tensors,
over the lanes in blocks of at most CLOUD_BLOCK elements; each element is
the reference's expression, and the shadow optical depths are summed in the
reference's order. Work whose result the reference multiplies by zero is
skipped, which changes no value: lanes that cross less than 1e-3 of a
layer, and the shadow march of steps without density.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .libm import sinf
from .vec import Vec3, dot as vdot, fma32, sdiv
from .volume import hg_phase_const

_F32 = np.float32
SIGMA = 0.004  # extinction per density unit per metre
# the largest stacked [steps, lanes] density evaluation of a march
CLOUD_BLOCK = 1 << 23


@dataclass
class DeviceClouds:
    """Cloud parameters as float32 values in host floats (per-layer
    tuples of three: low, mid, top)."""

    active: bool
    height_min: tuple
    height_max: tuple
    coverage: tuple
    coverage_min: tuple
    density: float
    shape_scale: float
    detail_scale: float
    weather_scale: float
    offset: tuple  # (x, z)
    seed: float  # noise offset


def pack_clouds(cloud) -> DeviceClouds:
    layers = (cloud.low, cloud.mid, cloud.top)

    def f(v):
        return float(_F32(v))

    return DeviceClouds(
        active=bool(cloud.active and any(l.active for l in layers)),
        height_min=tuple(f(l.height_min) for l in layers),
        height_max=tuple(f(l.height_max) for l in layers),
        coverage=tuple(f(l.coverage) for l in layers),
        coverage_min=tuple(f(l.coverage_min) for l in layers),
        density=f(cloud.density),
        shape_scale=f(cloud.noise_shape_scale),
        detail_scale=f(cloud.noise_detail_scale),
        weather_scale=f(cloud.noise_weather_scale),
        offset=(f(cloud.offset_x), f(cloud.offset_z)),
        seed=f(cloud.seed % 1024),
    )


def active_layer_indices(cloud) -> tuple:
    """The active layers' indices (0 low, 1 mid, 2 top), () when off."""
    if not cloud.active:
        return ()
    return tuple(i for i, l in enumerate((cloud.low, cloud.mid, cloud.top))
                 if l.active)


# lattice corner offsets of a trilinear lookup, in the reference's order
_CORNERS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
            (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))


def _hash3(px, py, pz, fused: bool, flat: bool = False):
    """``fract(sin(h) * 43758.5453)`` of h = px * 127.1 + py * 311.7 + pz *
    74.7, rounded as the reference's compiled code rounds it (see
    ``value_noise3``)."""
    if fused:
        h = fma32(pz, 74.7, fma32(px, 127.1, py * 311.7))
        if flat:
            # py is the constant 0 here: the compiled code drops the y term
            # and fuses fma(px, 127.1, pz * 74.7) instead
            h = torch.where(py == 0.0, fma32(px, 127.1, pz * 74.7), h)
    else:
        h = px * 127.1 + py * 311.7 + pz * 74.7
    # the reference's compiled sin is glibc's sinf (ops/libm.py), the same
    # on the card and the CPU
    s = sinf(h)
    return torch.abs(torch.remainder(s * 43758.5453, 1.0))


def value_noise3(p: Vec3, fused: bool = False, flat: bool = False) -> torch.Tensor:
    """Trilinear value noise at positions of any shape; the eight corner
    hashes are one stacked evaluation.

    One ulp of the hash's argument h gives a new hash, so h must be rounded
    as the reference rounds it. Op by op, h is ``(px * 127.1 + py * 311.7)
    + pz * 74.7`` with every product and sum rounded (``fused`` False: the
    reference's eager ops, and its compiled shadow march and cloud
    shadows). In the step of its compiled march, XLA's CPU code contracts
    it into fma(pz, 74.7, fma(px, 127.1, py * 311.7)) (``fused`` True);
    where p.y is the constant 0 (``flat``: the weather FBM's first octave)
    the y term of the corners at lattice y 0 is folded away and the
    contraction is fma(px, 127.1, pz * 74.7)."""
    ix, iy, iz = torch.floor(p.x), torch.floor(p.y), torch.floor(p.z)
    fx, fy, fz = p.x - ix, p.y - iy, p.z - iz
    wx = fx * fx * (3.0 - 2.0 * fx)
    wy = fy * fy * (3.0 - 2.0 * fy)
    wz = fz * fz * (3.0 - 2.0 * fz)
    shape = (8,) + (1,) * ix.dim()
    off = torch.tensor(_CORNERS, dtype=torch.float32, device=ix.device)
    c = _hash3(ix[None] + off[:, 0].view(shape), iy[None] + off[:, 1].view(shape),
               iz[None] + off[:, 2].view(shape), fused, flat)
    x00 = c[0] + (c[1] - c[0]) * wx
    x10 = c[2] + (c[3] - c[2]) * wx
    x01 = c[4] + (c[5] - c[4]) * wx
    x11 = c[6] + (c[7] - c[6]) * wx
    y0 = x00 + (x10 - x00) * wy
    y1 = x01 + (x11 - x01) * wy
    return y0 + (y1 - y0) * wz


def fbm3(p: Vec3, octaves: int = 3, fused: bool = False,
         flat: bool = False) -> torch.Tensor:
    """FBM of ``octaves`` octaves of value noise; ``flat``: p.y is the
    constant 0 (see ``value_noise3``)."""
    total = None
    amp, norm = 0.5, 0.0
    for o in range(octaves):
        s, b = 2.0 ** o, 17.31 * o
        v = amp * value_noise3(Vec3(p.x * s + b, p.y * s + b, p.z * s + b),
                               fused, flat and o == 0)
        total = v if total is None else total + v
        norm += amp
        amp *= 0.5
    return sdiv(total, norm)


def cloud_density(cl: DeviceClouds, pos: Vec3, layer: int = 0,
                  fused: bool = False) -> torch.Tensor:
    """Density in [0, 1] (times the cloud density) at positions of any
    shape in layer ``layer``: a coverage, height-gradient and detail-erosion
    stack of three FBMs (``fused``: see ``value_noise3``)."""
    lo, hi = cl.height_min[layer], cl.height_max[layer]
    h01 = torch.clamp(sdiv(pos.y - lo, float(max(_F32(hi) - _F32(lo), _F32(1e-3)))),
                      0.0, 1.0)
    grad = (torch.clamp(h01 * 4.0, 0.0, 1.0)
            * torch.clamp((1.0 - h01) * 2.5, 0.0, 1.0))
    p = Vec3(pos.x + cl.offset[0], pos.y + cl.seed, pos.z + cl.offset[1])
    ws = float(_F32(0.0004) * _F32(cl.weather_scale))
    weather = fbm3(Vec3(p.x * ws, torch.zeros_like(p.y), p.z * ws), octaves=3,
                   fused=fused, flat=True)
    ss = float(_F32(0.0015) * _F32(cl.shape_scale))
    base = fbm3(Vec3(p.x * ss, p.y * ss, p.z * ss), octaves=4, fused=fused)
    ds = float(_F32(0.009) * _F32(cl.detail_scale))
    detail = fbm3(Vec3(p.x * ds, p.y * ds, p.z * ds), octaves=2, fused=fused)
    coverage = torch.clamp(torch.clamp(weather * cl.coverage[layer],
                                       min=cl.coverage_min[layer]), max=2.0)
    d = base * grad * coverage - 0.55
    d = d - detail * 0.15
    return torch.clamp(d * 4.0, 0.0, 1.0) * cl.density


def _layer_span(cl: DeviceClouds, origin: Vec3, direction: Vec3, layer: int):
    dy = direction.y
    dy_safe = torch.where(torch.abs(dy) < 1e-7, 1e-7, dy)
    t_lo = (cl.height_min[layer] - origin.y) / dy_safe
    t_hi = (cl.height_max[layer] - origin.y) / dy_safe
    t0 = torch.clamp(torch.minimum(t_lo, t_hi), min=0.0)
    return t0, torch.maximum(torch.maximum(t_lo, t_hi), t0)


def _lanes(x, a, b):
    return x[a:b] if x.dim() else x


def cloud_march(cl: DeviceClouds, origin: Vec3, direction: Vec3, sun_dir: Vec3,
                sun_radiance, sky_ambient, steps: int = 48,
                shadow_steps: int = 4, layers: tuple = (0,)):
    """March the layers ``layers`` (composited low → mid → top) → ((r, g, b)
    in-scattered radiance, transmittance), each [N]. Per step: the sun
    through a short shadow march with the dual-lobe HG phase and a powder
    term, plus 0.3 of the sky ambient. On the card one launch of
    ``csrc/clouds.cu`` ``lum_cloud_march`` a layer; elsewhere
    :func:`_cloud_march_plain`. Both give the same bits."""
    return _cloud_march_plain(cl, origin, direction, sun_dir, sun_radiance,
                              sky_ambient, steps, shadow_steps, layers)




def _layer_steps(steps: int, layer: int) -> int:
    return max(steps // (1 + (layer == 2)), 8)  # thin cirrus: fewer


def _step_length(span: torch.Tensor, steps: int) -> torch.Tensor:
    """The march's step length: the compiled reference multiplies by the
    float32 reciprocal of the step count where its code divides."""
    return span * float(_F32(1.0 / steps))


def _march_phase(direction: Vec3, sun_dir: Vec3) -> torch.Tensor:
    """The march's dual-lobe HG phase: forward 0.65 and backward -0.25,
    weighted 0.5 each."""
    cos_sun = vdot(direction, sun_dir)
    return (hg_phase_const(cos_sun, 0.65) * 0.5
            + hg_phase_const(cos_sun, -0.25) * (1.0 - 0.5))


def _shadow_offsets(cl: DeviceClouds, layer: int, shadow_steps: int):
    """The shadow march's offsets along the sun and its step length, as
    float32 values in host floats."""
    shadow_len = _F32(cl.height_max[layer]) - _F32(cl.height_min[layer])
    shadow_len = _F32(shadow_len * _F32(0.5))
    offs = [float(_F32(_F32(k + 0.5) * shadow_len) / _F32(shadow_steps))
            for k in range(shadow_steps)]
    return offs, float(shadow_len / _F32(shadow_steps))


def _cloud_march_plain(cl, origin: Vec3, direction: Vec3, sun_dir: Vec3,
                       sun_radiance, sky_ambient, steps: int, shadow_steps: int,
                       layers: tuple):
    n = origin.x.shape[0]
    dev = origin.x.device
    rr_tot = torch.zeros(n, dtype=torch.float32, device=dev)
    rg_tot, rb_tot = rr_tot.clone(), rr_tot.clone()
    trans_tot = torch.ones(n, dtype=torch.float32, device=dev)
    for layer in layers:
        lsteps = _layer_steps(steps, layer)
        lr, lg, lb, lt = (torch.empty(n, dtype=torch.float32, device=dev)
                          for _ in range(4))
        block = max(CLOUD_BLOCK // (lsteps * (1 + shadow_steps)), 1)
        for a in range(0, n, block):
            b = min(a + block, n)
            (lr[a:b], lg[a:b], lb[a:b]), lt[a:b] = _march_one_layer(
                cl, Vec3(*(c[a:b] for c in origin)),
                Vec3(*(c[a:b] for c in direction)), sun_dir, sun_radiance,
                tuple(_lanes(c, a, b) for c in sky_ambient), lsteps,
                shadow_steps, layer)
        rr_tot = rr_tot + trans_tot * lr
        rg_tot = rg_tot + trans_tot * lg
        rb_tot = rb_tot + trans_tot * lb
        trans_tot = trans_tot * lt
    return (rr_tot, rg_tot, rb_tot), trans_tot


class _Clouds(ctypes.Structure):
    """``struct Clouds`` of ``csrc/clouds.cu``."""

    _fields_ = [(k, ctypes.c_float * 3) for k in (
        "height_min", "height_max", "height_span", "coverage", "coverage_min")] + [
        (k, ctypes.c_float) for k in (
            "density", "offset_x", "offset_z", "seed", "weather_scale",
            "shape_scale", "detail_scale")]


def _clouds_struct(cl: DeviceClouds) -> _Clouds:
    """The cloud parameters as ``cloud_density`` forms them, in float32."""
    f3 = ctypes.c_float * 3
    span = [float(max(_F32(hi) - _F32(lo), _F32(1e-3)))
            for lo, hi in zip(cl.height_min, cl.height_max)]
    return _Clouds(
        f3(*cl.height_min), f3(*cl.height_max), f3(*span), f3(*cl.coverage),
        f3(*cl.coverage_min), cl.density, cl.offset[0], cl.offset[1], cl.seed,
        float(_F32(0.0004) * _F32(cl.weather_scale)),
        float(_F32(0.0015) * _F32(cl.shape_scale)),
        float(_F32(0.009) * _F32(cl.detail_scale)))


def _operands(vals, dev, n: int):
    """Kernel operands → (the tensors to keep alive, pointers, strides in
    elements): float32 ``[n]`` lanes, or one value every lane shares (a host
    float or a one-element tensor, stride 0)."""
    keep, ptrs, strides = [], [], []
    for v in vals:
        if not isinstance(v, torch.Tensor):
            v = torch.tensor(float(v), dtype=torch.float32, device=dev)
        if v.device != dev or v.dtype != torch.float32:
            raise RuntimeError("clouds: a %s operand on %s, launch on %s"
                               % (v.dtype, v.device, dev))
        if v.numel() == 1:
            v = v.reshape(())
        elif v.shape != (n,):
            raise RuntimeError("clouds: operand of shape %s, lanes %d"
                               % (tuple(v.shape), n))
        keep.append(v)
        ptrs.append(v.data_ptr())
        strides.append(v.stride(0) if v.dim() else 0)
    return keep, ptrs, strides


def _march_one_layer(cl, origin: Vec3, direction: Vec3, sun_dir: Vec3,
                     sun_radiance, sky_ambient, steps: int, shadow_steps: int,
                     layer: int):
    t0, t1 = _layer_span(cl, origin, direction, layer)
    span = t1 - t0
    rr = torch.zeros_like(t0)
    rg, rb = rr.clone(), rr.clone()
    transmittance = torch.ones_like(t0)
    # a lane whose span through the layer is under 1e-3 sees density 0 at
    # every step: radiance 0, transmittance 1
    live = torch.nonzero(span > 1e-3).flatten()
    if live.numel() == 0:
        return (rr, rg, rb), transmittance
    o, d = Vec3(*(c[live] for c in origin)), Vec3(*(c[live] for c in direction))
    t0, span = t0[live], span[live]
    amb = tuple(c[live] if c.dim() else c for c in sky_ambient)
    dt = _step_length(span, steps)
    phase = _march_phase(d, sun_dir)
    offs, c_sh = _shadow_offsets(cl, layer, shadow_steps)
    # every step's position [S, B] and its density, t and the position
    # rounded once each as the compiled reference's step fuses them
    i = torch.arange(steps, dtype=torch.float32, device=t0.device)[:, None]
    t = fma32(i + 0.5, dt[None], t0[None])
    pos = Vec3(*(fma32(dc[None], t, oc[None]) for oc, dc in zip(o, d)))
    # the step's density with the fused hash, the shadow march's plain
    dens = cloud_density(cl, pos, layer, fused=True)
    # the shadow march's optical depth, summed in step order, where the
    # step has density (elsewhere its light is weighted by 0)
    lit_at = torch.nonzero(dens.reshape(-1) > 0.0).flatten()
    p_lit = [c.reshape(-1)[lit_at] for c in pos]
    sd = cloud_density(cl, Vec3(*(torch.stack([c + s_ * o_ for o_ in offs])
                                  for c, s_ in zip(p_lit, sun_dir))), layer)
    tau_lit = torch.zeros_like(lit_at, dtype=torch.float32)
    for k in range(shadow_steps):
        tau_lit = tau_lit + sd[k]
    tau = torch.zeros_like(dens).reshape(-1)
    tau[lit_at] = tau_lit
    tau = tau.view_as(dens)
    lr = torch.zeros_like(t0)
    lg, lb = lr.clone(), lr.clone()
    tr = torch.ones_like(t0)
    for s_ in range(steps):
        d_s = dens[s_]
        ext = d_s * SIGMA * dt
        sun_t = torch.exp(-tau[s_] * SIGMA * c_sh)
        powder = 1.0 - torch.exp(-d_s * 2.0)
        lit = phase * sun_t * powder
        w = tr * ext
        lr = lr + (sun_radiance[0] * lit + amb[0] * 0.3) * w
        lg = lg + (sun_radiance[1] * lit + amb[1] * 0.3) * w
        lb = lb + (sun_radiance[2] * lit + amb[2] * 0.3) * w
        tr = tr * torch.exp(-ext)
    rr[live], rg[live], rb[live], transmittance[live] = lr, lg, lb, tr
    return (rr, rg, rb), transmittance


def cloud_sun_transmittance(cl: DeviceClouds, pos: Vec3, sun_dir: Vec3,
                            layers: tuple = (0,), steps: int = 3) -> torch.Tensor:
    """Sun transmittance through the layers from surface points (cloud
    shadows): a coarse fixed-step density march per layer → [N] in [0, 1].
    On the card one launch of ``csrc/clouds.cu`` ``lum_cloud_shadow``;
    elsewhere :func:`_cloud_sun_transmittance_plain`. Both give the same
    bits."""
    return _cloud_sun_transmittance_plain(cl, pos, sun_dir, layers, steps)




def _cloud_sun_transmittance_plain(cl: DeviceClouds, pos: Vec3, sun_dir: Vec3,
                                   layers: tuple, steps: int) -> torch.Tensor:
    n = pos.x.shape[0]
    out = torch.ones_like(pos.x)
    i = torch.arange(steps, dtype=torch.float32, device=pos.x.device)[:, None]
    block = max(CLOUD_BLOCK // steps, 1)
    for a in range(0, n, block):
        p = Vec3(*(c[a:a + block] for c in pos))
        trans = torch.ones_like(p.x)
        for layer in layers:
            t0, t1 = _layer_span(cl, p, sun_dir, layer)
            span = torch.clamp(t1 - t0, min=0.0)
            dt = sdiv(span, steps)
            t = t0[None] + (i + 0.5) * dt[None]
            sp = Vec3(*(c[None] + sd * t for c, sd in zip(p, sun_dir)))
            dens = cloud_density(cl, sp, layer)
            tau = torch.zeros_like(p.x)
            for s in range(steps):
                tau = tau + dens[s]
            trans = trans * torch.exp(-tau * SIGMA * dt)
        out[a:a + block] = trans
    return out
