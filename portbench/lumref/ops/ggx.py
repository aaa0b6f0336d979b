"""GGX microfacet BSDF: sampling, evaluation, energy compensation (port of
``luminary_tpu/ops/ggx.py``).

Bounded-VNDF reflection sampling, Smith height-correlated masking,
dielectric/conductor Fresnel and the Turquin-style multiscatter gain from the
directional-albedo LUT (``data/ggx_energy_lut.npy``, read by path). The LUT
fetch is one bilinear-quad row gather through kernel A.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .rowops import gather_planar
from .libm import cosf, sinf
from .vec import Vec3, fma32, normalize_fused, sqrt_rn

MIN_ROUGHNESS = 0.025
_LUT_RES = 32
_INV_098 = float(np.float32(1.0) / np.float32(0.98))
_LUT_PATH = os.path.join(
    os.path.dirname(__file__), "..", "data", "ggx_energy_lut.npy")


def roughness_to_alpha(roughness: torch.Tensor) -> torch.Tensor:
    r = torch.clamp(roughness, min=MIN_ROUGHNESS)
    return r * r


# Products that the reference's compiled code contracts into the add that
# consumes them are rounded once (fma32), as in sample_vndf_bounded below.

def ggx_ndf(alpha, cos_h):
    a2 = alpha * alpha
    c2 = cos_h * cos_h
    d = fma32(c2, a2 - 1.0, 1.0)
    return a2 / torch.clamp(np.pi * d * d, min=1e-12)


def _smith_lambda(alpha, cos_t):
    c2 = torch.clamp(cos_t * cos_t, 1e-8, 1.0)
    t2 = (1.0 - c2) / c2
    return 0.5 * (sqrt_rn(fma32(alpha * alpha, t2, 1.0)) - 1.0)


def smith_g1(alpha, cos_t):
    return 1.0 / (1.0 + _smith_lambda(alpha, cos_t))


def smith_g2(alpha, cos_o, cos_i):
    """Height-correlated Smith masking-shadowing."""
    return 1.0 / (1.0 + _smith_lambda(alpha, cos_o) + _smith_lambda(alpha, cos_i))


def sample_vndf_bounded(wo_l: Vec3, alpha, r2) -> Vec3:
    """Bounded VNDF sampling of the GGX half-vector (Eto & Tokuyoshi 2023),
    rounded as the reference's compiled code rounds it: each product that
    XLA's CPU code contracts into its sum (fma32), correctly rounded square
    roots and glibc's sinf / cosf (``ops/libm.py``)."""
    wo_std = normalize_fused(Vec3(wo_l.x * alpha, wo_l.y * alpha, wo_l.z))
    alpha_c = torch.clamp(alpha, max=1.0)
    s = 1.0 + sqrt_rn(torch.clamp(fma32(wo_l.x, wo_l.x, wo_l.y * wo_l.y), min=0.0))
    a2 = alpha_c * alpha_c
    s2 = s * s
    k = (1.0 - a2) * s2 / fma32(a2 * wo_l.z, wo_l.z, s2)

    b = torch.where(wo_l.z > 0.0, k * wo_std.z, wo_std.z)
    phi = 2.0 * np.pi * r2[..., 0]
    z = fma32(1.0 - r2[..., 1], 1.0 + b, -b)
    sin_t = sqrt_rn(torch.clamp(fma32(-z, z, 1.0), 0.0, 1.0))
    cx = fma32(sin_t, cosf(phi), wo_std.x)
    cy = fma32(sin_t, sinf(phi), wo_std.y)
    cz = z + wo_std.z
    return normalize_fused(Vec3(cx * alpha, cy * alpha, torch.clamp(cz, min=0.0)))


def sample_vndf(wo_l: Vec3, alpha, r2) -> Vec3:
    """Standard Smith-VNDF half-vector sampling (Heitz 2018), rounded as the
    reference's compiled code rounds it (see sample_vndf_bounded)."""
    v = normalize_fused(Vec3(wo_l.x * alpha, wo_l.y * alpha, wo_l.z))
    lensq = fma32(v.x, v.x, v.y * v.y)
    # the compiled code's rsqrt is the x86 estimate refined by two Newton
    # steps, which depends on the machine: the port takes the correctly
    # rounded value (through float64)
    inv = torch.rsqrt(torch.clamp(lensq, min=1e-20).to(torch.float64)).to(
        torch.float32)
    big = lensq > 1e-12
    zero = torch.zeros_like(v.x)
    t1 = Vec3(torch.where(big, -v.y * inv, 1.0),
              torch.where(big, v.x * inv, zero),
              zero)
    t2 = Vec3(
        fma32(v.y, t1.z, -(v.z * t1.y)),
        fma32(v.z, t1.x, -(v.x * t1.z)),
        fma32(v.x, t1.y, -(v.y * t1.x)),
    )
    r = sqrt_rn(torch.clamp(r2[..., 0], 0.0, 1.0))
    phi = 2.0 * np.pi * r2[..., 1]
    p1 = r * cosf(phi)
    p2 = r * sinf(phi)
    s = 0.5 * (1.0 + v.z)
    q = fma32(-p1, p1, 1.0)  # 1 - p1 p1
    p2 = fma32(1.0 - s, sqrt_rn(torch.clamp(q, min=0.0)), s * p2)
    pz = sqrt_rn(torch.clamp(fma32(-p2, p2, q), min=0.0))
    nh = Vec3(*(fma32(pz, vc, fma32(p1, a, p2 * b))
                for a, b, vc in zip(t1, t2, v)))
    return normalize_fused(Vec3(nh.x * alpha, nh.y * alpha,
                                torch.clamp(nh.z, min=1e-6)))


def vndf_bounded_pdf(wo_l: Vec3, wi_l: Vec3, alpha):
    """PDF of sample_vndf_bounded over wi (reflected solid angle)."""
    h = normalize_fused(wo_l + wi_l)
    a2_ = alpha * alpha
    d = fma32(h.z * h.z, a2_ - 1.0, 1.0)
    den = torch.clamp(np.pi * d * d, min=1e-12)
    aix = alpha * wo_l.x
    aiy = alpha * wo_l.y
    len2 = fma32(aix, aix, aiy * aiy)
    t = sqrt_rn(fma32(wo_l.z, wo_l.z, len2))
    alpha_c = torch.clamp(alpha, max=1.0)
    s = 1.0 + sqrt_rn(torch.clamp(fma32(wo_l.x, wo_l.x, wo_l.y * wo_l.y), min=0.0))
    a2 = alpha_c * alpha_c
    s2 = s * s
    k = (1.0 - a2) * s2 / fma32(a2 * wo_l.z, wo_l.z, s2)
    # the compiled code folds ndf / (2 x) = (a2 / den) / (2 x) into
    # a2 / (den 2 x)
    pdf_upper = a2_ / (den * (2.0 * fma32(k, wo_l.z, t)))
    pdf_lower = a2_ / den * (t - wo_l.z) / fma32(2.0, len2, 1e-12)
    return torch.where(wo_l.z >= 0.0, pdf_upper, pdf_lower)


def fresnel_schlick(f0, cos_t):
    m = torch.clamp(1.0 - cos_t, 0.0, 1.0)
    m5 = (m * m) * (m * m) * m
    return fma32(1.0 - f0, m5, f0)


def fresnel_dielectric(cos_i, eta):
    """Exact unpolarized dielectric Fresnel; eta = n_transmit / n_incident."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = fma32(-cos_i, cos_i, 1.0) / torch.clamp(eta * eta, min=1e-8)
    tir = sin2_t >= 1.0
    cos_t = sqrt_rn(torch.clamp(1.0 - sin2_t, 0.0, 1.0))
    rs = fma32(-eta, cos_t, cos_i) / torch.clamp(fma32(eta, cos_t, cos_i), min=1e-8)
    rp = fma32(eta, cos_i, -cos_t) / torch.clamp(fma32(eta, cos_i, cos_t), min=1e-8)
    f = 0.5 * fma32(rs, rs, rp * rp)
    return torch.where(tir, 1.0, f)


@functools.lru_cache(maxsize=1)
def ggx_energy_lut() -> np.ndarray:
    """E(mu_o, roughness) on a 32x32 grid: the reference's precomputed
    single-scatter directional albedo, read from the repository's data."""
    arr = np.load(_LUT_PATH).astype(np.float32)
    if arr.shape != (_LUT_RES, _LUT_RES):
        raise ValueError("ggx_energy_lut.npy must be 32x32, got %s" % (arr.shape,))
    arr.setflags(write=False)
    return arr


def ggx_energy_quad() -> np.ndarray:
    """Bilinear-quad rows: row i*RES+j holds (E[i,j], E[i+1,j], E[i,j+1],
    E[i+1,j+1]) so one interpolated fetch is one row gather."""
    lut = ggx_energy_lut()
    i1 = np.minimum(np.arange(_LUT_RES) + 1, _LUT_RES - 1)
    quad = np.stack(
        [lut, lut[i1, :], lut[:, i1], lut[i1][:, i1]], axis=-1
    ).reshape(-1, 4)
    return quad.astype(np.float32)


def energy_compensation_gain(quad: torch.Tensor, cos_o, roughness):
    """(1-E)/E from the LUT quad rows ``quad`` [RES*RES, 4] (device table
    from :func:`ggx_energy_quad`) — one kernel-A gather per call."""
    # the compiled code multiplies by the float32 reciprocal of 0.98
    mu_i = torch.clamp((cos_o - 0.02) * _INV_098, 0.0, 1.0) * (_LUT_RES - 1)
    r_i = torch.clamp(roughness, 0.0, 1.0) * (_LUT_RES - 1)
    i0 = torch.clamp(mu_i.to(torch.int32), 0, _LUT_RES - 2)
    j0 = torch.clamp(r_i.to(torch.int32), 0, _LUT_RES - 2)
    fi, fj = mu_i - i0, r_i - j0
    q = gather_planar(quad, i0 * _LUT_RES + j0)  # [4, N]
    e = fma32(q[3] * fi, fj, fma32(q[2] * (1 - fi), fj, fma32(
        q[1] * fi, 1 - fj, q[0] * (1 - fi) * (1 - fj))))
    return (1.0 - e) / e


def ggx_reflect_parts(quad, wo_l: Vec3, wi_l: Vec3, alpha, f0_rgb, roughness):
    """The specular lobe (the reference's ``ggx_reflect_eval``) before its
    last product: ((Fresnel r, g, b), the rest of the value·cos, pdf), the
    value being Fresnel x rest (multiscatter included; zero below the
    horizon). The caller adds the diffuse lobe and contracts that product
    into its sum, as the reference's compiled code does."""
    cos_o = wo_l.z
    cos_i = wi_l.z
    valid = (cos_o > 0.0) & (cos_i > 0.0)
    h = normalize_fused(wo_l + wi_l)
    cos_h = torch.clamp(h.z, 0.0, 1.0)
    cos_oh = torch.clamp(fma32(wo_l.z, h.z, fma32(wo_l.x, h.x, wo_l.y * h.y)),
                         0.0, 1.0)
    d = ggx_ndf(alpha, cos_h)
    g2 = smith_g2(alpha, cos_o, cos_i)
    base = d * g2 / torch.clamp(4.0 * cos_o, min=1e-8)
    f0r, f0g, f0b = f0_rgb
    f0_avg = (f0r + f0g + f0b) * (1.0 / 3.0)
    gain = energy_compensation_gain(quad, cos_o, roughness)
    comp = fma32(f0_avg, gain, 1.0)
    scale = torch.where(valid, base * comp, 0.0)
    fres = tuple(fresnel_schlick(f0, cos_oh) for f0 in (f0r, f0g, f0b))
    pdf = vndf_bounded_pdf(wo_l, wi_l, alpha)
    return fres, scale, torch.where(valid, pdf, 0.0)


def diffuse_eval(wi_l: Vec3, kd_rgb):
    """Lambert lobe·cos: kd/π · cos_i, pdf = cos_i/π."""
    cos_i = torch.clamp(wi_l.z, min=0.0)
    w = cos_i * (1.0 / np.pi)
    kr, kg, kb = kd_rgb
    return (kr * w, kg * w, kb * w), w

