"""Jendersie-d'Eon approximate Mie phase function for droplets (port of
``luminary_tpu/ops/phase.py``).

J. Jendersie and E. d'Eon, "An Approximate Mie Scattering Function for Fog
and Cloud Rendering", SIGGRAPH 2023 Talks: a two-lobe mix of
Henyey-Greenstein and Draine phase functions whose parameters are fitted
functions of the droplet diameter (micrometres). The particle tier scatters
by it (bounce = ``je_sample_direction``, weight = the particle albedo).

The diameter is a host constant: ``je_params`` evaluates the fits in
float64 on the host, and every constant expression below is formed in
float64 exactly as the reference forms it, then meets the float32 lanes as
one float32 rounding (as a Python float folded into a JAX expression does).
Divisions by a lane value go through ``rdiv`` and divisions of a lane value
by a host constant through ``sdiv``, one IEEE division each, as in the
reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .vec import Vec3, normalize, rdiv, sdiv, sqrt_rn


def je_params(diameter: float) -> tuple[float, float, float, float]:
    """(g_hg, g_d, alpha, w_d): the paper's table-3 diameter fits."""
    d = float(diameter)
    if 5.0 <= d <= 50.0:
        g_hg = math.exp(-0.0990567 / (d - 1.67154))
        g_d = math.exp(-(2.20679 / (d + 3.91029)) - 0.428934)
        alpha = math.exp(3.62489 - (8.29288 / (d + 5.52825)))
        w_d = math.exp(-(0.599085 / (d - 0.641583)) - 0.665888)
    elif 1.5 <= d < 5.0:
        g_hg = 0.0604931 * math.log(math.log(d)) + 0.940256
        g_d = 0.500411 - (
            0.081287 / (-2.0 * math.log(d) + math.tan(math.log(d)) + 1.27551))
        alpha = 7.30354 * math.log(d) + 6.31675
        w_d = 0.026914 * (
            math.log(d)
            - math.cos(5.68947 * (math.log(math.log(d)) - 0.0292149))
        ) + 0.376475
    elif 0.1 <= d < 1.5:
        ld = math.log(d)
        g_hg = 0.862 - 0.143 * ld * ld
        g_d = 0.379685 * math.cos(
            1.19692 * math.cos(
                ((ld - 0.238604) * (ld + 1.00667))
                / (0.507522 - 0.15677 * ld))
            + 1.37932 * ld + 0.0625835) + 0.344213
        alpha = 250.0
        w_d = 0.146209 * math.cos(3.38707 * ld + 2.11193) + 0.316072 \
            + 0.0778917 * ld
    else:  # d < 0.1: the Rayleigh-adjacent regime
        g_hg = 13.8 * d * d
        g_d = 1.1456 * d * math.sin(9.29044 * d)
        alpha = 250.0
        w_d = 0.252977 - 312.983 * (d ** 4.3)
    return g_hg, g_d, alpha, w_d


def hg_phase_g(cos_angle: torch.Tensor, g: float) -> torch.Tensor:
    g2 = g * g
    denom = (1.0 + g2) - (2.0 * g) * cos_angle
    return rdiv(1.0 - g2, 4.0 * math.pi * denom
                * torch.sqrt(torch.clamp(denom, min=1e-12)))


def draine_phase(cos_angle: torch.Tensor, g: float, alpha: float) -> torch.Tensor:
    return hg_phase_g(cos_angle, g) * sdiv(
        1.0 + alpha * cos_angle * cos_angle,
        1.0 + (alpha / 3.0) * (1.0 + 2.0 * g * g))


def je_phase(cos_angle: torch.Tensor, diameter: float) -> torch.Tensor:
    """Phase value (1/sr) at scattering cosine ``cos_angle``."""
    g_hg, g_d, alpha, w_d = je_params(diameter)
    return ((1.0 - w_d) * hg_phase_g(cos_angle, g_hg)
            + w_d * draine_phase(cos_angle, g_d, alpha))


def _hg_sample_cos(g: float, r: torch.Tensor) -> torch.Tensor:
    if abs(g) < 1e-4:
        return 1.0 - 2.0 * r
    g2 = g * g
    t = rdiv(1.0 - g2, (1.0 - g) + (2.0 * g) * r)
    return sdiv((1.0 + g2) - t * t, 2.0 * g)


# the float32 rounding of 1/3: the reference's cube root is XLA's, a float32
# pow(|x|, 1/3) with this exponent (not the correctly rounded root)
_THIRD_F32 = float(np.float32(1.0 / 3.0))


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root as the reference takes it, |x|^(float32 1/3) with the
    sign of x, evaluated in float64 and rounded once."""
    x64 = x.to(torch.float64)
    return (torch.sign(x64) * torch.abs(x64).pow(_THIRD_F32)).to(x.dtype)


def _draine_sample_cos(g: float, alpha: float, r: torch.Tensor) -> torch.Tensor:
    """Exact Draine inversion (the paper supplement's closed form). Its sums
    cancel badly in float32, so an ulp of a root moves the cosine by up to
    ~0.05: the roots are rounded as the reference's are."""
    g2 = g * g
    g4 = g2 * g2
    t0 = alpha - alpha * g2
    t1 = alpha * g4 - alpha
    t2 = -3.0 * (4.0 * (g4 - g2) + t1 * (1.0 + g2))
    t3 = g * (2.0 * r - 1.0)
    t4 = (3.0 * g2) * (1.0 + t3) + alpha * (
        2.0 + g2 * (1.0 + (1.0 + 2.0 * g2) * t3))
    t5 = t0 * ((t1 * t2) + t4 * t4) + (t1 * t1 * t1)
    t6 = t0 * 4.0 * (g4 - g2)
    t7 = _cbrt(t5 + sqrt_rn(torch.clamp(t5 * t5 - (t6 * t6 * t6), min=0.0)))
    t8 = 2.0 * sdiv((t1 + rdiv(t6, t7)) + t7, t0)
    t9 = sqrt_rn(torch.clamp((6.0 * (1.0 + g2)) + t8, min=0.0))
    h = sqrt_rn(torch.clamp(
        ((6.0 * (1.0 + g2)) - t8) + (8.0 * t4) / (t0 * t9), min=0.0)) - t9
    return torch.clamp(
        0.5 * g + ((1.0 / (2.0 * g)) - (1.0 / (8.0 * g)) * (h * h)),
        -1.0, 1.0)


def je_sample_direction(direction: Vec3, diameter: float, r_dir, r_azi,
                        r_choice) -> Vec3:
    """A scattered direction about ``direction``: perfect importance
    sampling of the two-lobe mix (phase / pdf = 1, so the bounce weight is
    the particle albedo)."""
    g_hg, g_d, alpha, w_d = je_params(diameter)
    cos_d = (_draine_sample_cos(g_d, alpha, r_dir) if abs(g_d) > 1e-4
             else 1.0 - 2.0 * r_dir)
    cos_hg = _hg_sample_cos(g_hg, r_dir)
    cos_a = torch.where(r_choice < w_d, cos_d, cos_hg)
    cos_a = torch.clamp(cos_a, -1.0, 1.0)
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
    phi = 2.0 * math.pi * r_azi
    # orthonormal basis about the propagation direction
    d = normalize(direction)
    sign = torch.where(d.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + d.z)
    b = d.x * d.y * a
    u1 = Vec3(1.0 + sign * d.x * d.x * a, sign * b, -sign * d.x)
    u2 = Vec3(b, sign + d.y * d.y * a, -d.y)
    sc = sin_a * torch.cos(phi)
    ss = sin_a * torch.sin(phi)
    return normalize(Vec3(
        sc * u1.x + ss * u2.x + cos_a * d.x,
        sc * u1.y + ss * u2.y + cos_a * d.y,
        sc * u1.z + ss * u2.z + cos_a * d.z,
    ))
