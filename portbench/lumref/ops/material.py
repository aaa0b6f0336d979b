"""Surface material model: lobe selection, sampling, evaluation (port of
``luminary_tpu/ops/material.py``).

metallic → GGX conductor; opaque dielectric → GGX coat over Lambert, lobe
picked by Fresnel-weighted probability; translucent → rough dielectric
reflect/refract with a 2-deep per-lane IOR medium stack. Values are
premultiplied by |cos θi|; delta lobes report pdf 0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .ggx import (
    diffuse_eval,
    fresnel_dielectric,
    ggx_reflect_parts,
    roughness_to_alpha,
    sample_vndf,
    sample_vndf_bounded,
    smith_g1,
    smith_g2,
)
from .libm import cosf, sinf
from .random import RandomTarget, random_1d, random_2d
from .vec import Vec3, dot, fma32, normalize_fused, sqrt_rn, vwhere


class LaneMaterial(NamedTuple):
    """Material parameters gathered per lane (RGB as channel tensors)."""

    albedo_r: torch.Tensor
    albedo_g: torch.Tensor
    albedo_b: torch.Tensor
    roughness: torch.Tensor
    metallic: torch.Tensor  # 0/1
    ior: torch.Tensor
    translucent: torch.Tensor  # bool
    opacity: torch.Tensor
    thin_walled: torch.Tensor  # bool


# Medium stack: two f16 IOR payloads in one u32 word (held in int64 lanes).

def medium_encode_ior(ior: torch.Tensor) -> torch.Tensor:
    return ior.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF


def _medium_decode(bits16: torch.Tensor) -> torch.Tensor:
    ior = bits16.to(torch.int16).view(torch.float16).to(torch.float32)
    return torch.where(bits16 == 0, 1.0, ior)  # empty slot = vacuum


def medium_top_ior(medium: torch.Tensor) -> torch.Tensor:
    return _medium_decode(medium & 0xFFFF)


def medium_below_ior(medium: torch.Tensor) -> torch.Tensor:
    return _medium_decode((medium >> 16) & 0xFFFF)


def medium_push(medium: torch.Tensor, ior: torch.Tensor) -> torch.Tensor:
    return ((medium << 16) & 0xFFFFFFFF) | medium_encode_ior(ior)


def medium_pop(medium: torch.Tensor) -> torch.Tensor:
    return medium >> 16


class ShadingFrame(NamedTuple):
    """Per-hit shading context shared by the sample and the NEE evals.
    ``quad`` is the device GGX energy table the specular lobe reads."""

    t: Vec3
    b: Vec3
    n: Vec3
    wo_l: Vec3
    alpha: torch.Tensor
    f0_r: torch.Tensor
    f0_g: torch.Tensor
    f0_b: torch.Tensor
    kd_r: torch.Tensor
    kd_g: torch.Tensor
    kd_b: torch.Tensor
    p_spec: torch.Tensor
    quad: torch.Tensor


def _f0_from_ior(ior):
    r = (ior - 1.0) / (ior + 1.0)
    return r * r


# The shading frame and the sampled direction are rounded as the reference's
# compiled code rounds them: XLA's CPU back end contracts each product that
# has one use into the add or subtract that consumes it (fma32). The frame's
# dot products contract as fma(z, z', fma(x, x', y y')), the reflection's as
# fma(z, z', fma(y, y', x x')). A grazing bounce turns an ulp of a sampled
# direction into a new march through the clouds (tests/test_torch_rounding.py).

def _dot_fused(a: Vec3, b: Vec3):
    return fma32(a.z, b.z, fma32(a.x, b.x, a.y * b.y))


def _basis_fused(n: Vec3):
    """:func:`orthonormal_basis` with the reference's compiled rounding."""
    s = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n.z)
    b = n.x * n.y * a
    t = Vec3(fma32(s * n.x * n.x, a, 1.0), s * b, -s * n.x)
    return t, Vec3(b, fma32(n.y * n.y, a, s), -n.y)


def _reflect_fused(v: Vec3, n: Vec3) -> Vec3:
    d = 2.0 * fma32(v.z, n.z, fma32(v.y, n.y, v.x * n.x))
    return Vec3(fma32(-d, n.x, v.x), fma32(-d, n.y, v.y), fma32(-d, n.z, v.z))


def _to_world_fused(fr, v: Vec3) -> Vec3:
    return Vec3(*(fma32(n_, v.z, fma32(t_, v.x, b_ * v.y)) for t_, b_, n_ in
                  zip(fr.t, fr.b, fr.n)))


def _lane_count(v: torch.Tensor) -> int:
    return v.shape[0]


def _frame_ins(fr: ShadingFrame) -> list:
    """The frame's lane operands in csrc/shading.cu's order (FRAME_IN)."""
    return [*fr.t, *fr.b, *fr.n, *fr.wo_l, fr.alpha, fr.f0_r, fr.f0_g, fr.f0_b,
            fr.kd_r, fr.kd_g, fr.kd_b, fr.p_spec]


def _empty(n: int, dev, k: int, dtype=torch.float32) -> list:
    return [torch.empty(n, dtype=dtype, device=dev) for _ in range(k)]


def make_frame(mat: LaneMaterial, ns: Vec3, wo: Vec3,
               quad: torch.Tensor) -> ShadingFrame:
    """The shading frame of each lane: its tangents, the view direction in
    it, the lobes' albedos and the specular lobe's probability. On the card
    one launch of ``csrc/shading.cu`` ``lum_make_frame``; elsewhere
    :func:`_make_frame_plain`."""
    return _make_frame_plain(mat, ns, wo, quad)




def _make_frame_plain(mat: LaneMaterial, ns: Vec3, wo: Vec3,
                      quad: torch.Tensor) -> ShadingFrame:
    """Plain PyTorch version of :func:`make_frame`."""
    t, b = _basis_fused(ns)
    wo_l = Vec3(_dot_fused(wo, t), _dot_fused(wo, b), _dot_fused(wo, ns))
    f0d = _f0_from_ior(mat.ior)
    is_metal = mat.metallic > 0.5
    f0_r = torch.where(is_metal, mat.albedo_r, f0d)
    f0_g = torch.where(is_metal, mat.albedo_g, f0d)
    f0_b = torch.where(is_metal, mat.albedo_b, f0d)
    km = 1.0 - mat.metallic
    kd_r = mat.albedo_r * km
    kd_g = mat.albedo_g * km
    kd_b = mat.albedo_b * km

    cos_o = torch.clamp(wo_l.z, 0.0, 1.0)
    m = 1.0 - cos_o
    m5 = (m * m) * (m * m) * m
    f_avg = (f0_r + f0_g + f0_b) * (1.0 / 3.0)
    fres = fma32(1.0 - f_avg, m5, f_avg)
    kd_lum = (kd_r + kd_g + kd_b) * (1.0 / 3.0)
    p = fres / torch.clamp(fma32(kd_lum, 1.0 - fres, fres), min=1e-6)
    p_spec = torch.where(is_metal, 1.0, torch.clamp(p, 0.05, 0.95))
    return ShadingFrame(t, b, ns, wo_l, roughness_to_alpha(mat.roughness),
                        f0_r, f0_g, f0_b, kd_r, kd_g, kd_b, p_spec, quad)


def _to_local(fr: ShadingFrame, v: Vec3) -> Vec3:
    return Vec3(dot(v, fr.t), dot(v, fr.b), dot(v, fr.n))


def _to_world(fr: ShadingFrame, v: Vec3) -> Vec3:
    return Vec3(
        fr.t.x * v.x + fr.b.x * v.y + fr.n.x * v.z,
        fr.t.y * v.x + fr.b.y * v.y + fr.n.y * v.z,
        fr.t.z * v.x + fr.b.z * v.y + fr.n.z * v.z,
    )


def frame_eval(mat: LaneMaterial, fr: ShadingFrame, roughness, wi: Vec3):
    """((fr,fg,fb) = f·cos, pdf) for an explicit world direction (NEE/MIS).
    Translucent lanes evaluate to zero (delta lobes). On the card one launch
    of ``csrc/shading.cu`` ``lum_frame_eval``; elsewhere
    :func:`_frame_eval_plain`."""
    return _frame_eval_plain(mat, fr, roughness, wi)




def _frame_eval_plain(mat: LaneMaterial, fr: ShadingFrame, roughness, wi: Vec3):
    """Plain PyTorch version of :func:`frame_eval`."""
    wi_l = _to_local(fr, wi)
    f, pdf = _opaque_eval(fr, wi_l, roughness)
    live = ~mat.translucent
    return tuple(torch.where(live, c, 0.0) for c in f), torch.where(live, pdf, 0.0)


def _opaque_eval(fr: ShadingFrame, wi_l: Vec3, roughness):
    """The GGX coat over Lambert: ((r, g, b) value·cos, pdf), the specular
    Fresnel product and the lobe probabilities contracted into their sums
    as the reference's compiled code contracts them."""
    fres, scale, pdf_spec = ggx_reflect_parts(
        fr.quad, fr.wo_l, wi_l, fr.alpha, (fr.f0_r, fr.f0_g, fr.f0_b),
        roughness)
    _, w = diffuse_eval(wi_l, (fr.kd_r, fr.kd_g, fr.kd_b))
    f = tuple(fma32(kd, w, fc * scale)
              for fc, kd in zip(fres, (fr.kd_r, fr.kd_g, fr.kd_b)))
    return f, fma32(1.0 - fr.p_spec, w, fr.p_spec * pdf_spec)


def material_sample(mat: LaneMaterial, fr: ShadingFrame, ns: Vec3, wo: Vec3,
                    pixel_id, sample_id, depth, eta_rel=None, bn=None):
    """Sample an outgoing direction → (wi, weight (r,g,b) = f·cos/pdf, pdf,
    is_delta, transmitted). On the card one launch of ``csrc/shading.cu``
    ``lum_material_sample`` after the random numbers; elsewhere
    :func:`_material_sample_plain`."""
    r_choice = random_1d(RandomTarget.BSDF_CHOICE, pixel_id, sample_id, depth,
                         bn=bn)
    r2 = random_2d(RandomTarget.BSDF_REFLECTION, pixel_id, sample_id, depth,
                   bn=bn)
    eta = eta_rel if eta_rel is not None else mat.ior
    return _material_sample_plain(mat, fr, r_choice, r2, eta)




def _material_sample_plain(mat: LaneMaterial, fr: ShadingFrame, r_choice, r2,
                           eta):
    """Plain PyTorch version of :func:`material_sample` after its random
    numbers (``r_choice`` [N], ``r2`` [N, 2]) and its relative IOR."""
    wo_l = fr.wo_l

    # --- opaque path: specular or diffuse ---
    choose_spec = r_choice < fr.p_spec
    h = sample_vndf_bounded(wo_l, fr.alpha, r2)
    wi_spec_l = _reflect_fused(-wo_l, h)
    phi = 2.0 * np.pi * r2[..., 0]
    sr = sqrt_rn(torch.clamp(r2[..., 1], 0.0, 1.0))
    wi_diff_l = Vec3(
        cosf(phi) * sr,
        sinf(phi) * sr,
        sqrt_rn(torch.clamp(1.0 - r2[..., 1], min=0.0)),
    )
    wi_l = vwhere(choose_spec, wi_spec_l, wi_diff_l)
    f, pdf = _opaque_eval(fr, wi_l, mat.roughness)
    ok = (wi_l.z > 0.0) & (pdf > 1e-10)
    inv_pdf = torch.where(ok, 1.0 / torch.clamp(pdf, min=1e-10), 0.0)
    w_opaque = tuple(c * inv_pdf for c in f)

    # --- translucent path: rough dielectric ---
    ht = sample_vndf(wo_l, fr.alpha, r2)
    # the translucent lobe is rounded by the same rule but not yet bit for
    # bit: the compiled rsqrt in sample_vndf is the x86 estimate refined by
    # Newton steps, and some of this lobe's sites are not found (ROADMAP.md
    # queue 3)
    cos_oh = torch.clamp(_dot_fused(wo_l, ht), 1e-6, 1.0)
    fres = fresnel_dielectric(cos_oh, eta)
    fres = torch.where(mat.thin_walled, 2.0 * fres / (1.0 + fres), fres)
    choose_reflect = r_choice < fres
    wi_refl_l = _reflect_fused(-wo_l, ht)
    inv_eta = 1.0 / torch.clamp(eta, min=1e-6)
    sin2_t = inv_eta * inv_eta * torch.clamp(fma32(-cos_oh, cos_oh, 1.0), min=0.0)
    tir = sin2_t >= 1.0
    cos_t = sqrt_rn(torch.clamp(1.0 - sin2_t, 0.0, 1.0))
    bend = fma32(inv_eta, cos_oh, -cos_t)
    wi_refr_l = Vec3(*(fma32(-w, inv_eta, bend * h_) for w, h_ in zip(wo_l, ht)))
    wi_thin_l = Vec3(-wo_l.x, -wo_l.y, -wo_l.z)
    wi_refr_l = vwhere(mat.thin_walled, wi_thin_l, wi_refr_l)
    choose_reflect = choose_reflect | (tir & ~mat.thin_walled)
    wi_trans_l = vwhere(choose_reflect, wi_refl_l, wi_refr_l)
    g_ratio = smith_g2(
        fr.alpha, torch.abs(wo_l.z), torch.abs(wi_trans_l.z)
    ) / torch.clamp(smith_g1(fr.alpha, torch.abs(wo_l.z)), min=1e-6)
    w_trans = tuple(
        torch.where(choose_reflect, g_ratio, a * g_ratio)
        for a in (mat.albedo_r, mat.albedo_g, mat.albedo_b)
    )
    transmitted = mat.translucent & ~choose_reflect & ~mat.thin_walled

    is_trans = mat.translucent
    wi_l = vwhere(is_trans, wi_trans_l, wi_l)
    weight = tuple(torch.where(is_trans, wt, wo_) for wt, wo_ in zip(w_trans, w_opaque))
    pdf_out = torch.where(is_trans, 0.0, pdf)
    wl2 = wi_l.x * wi_l.x + wi_l.y * wi_l.y + wi_l.z * wi_l.z
    degen = wl2 < 1e-16
    wi_l = vwhere(degen, Vec3.of(0.0, 0.0, 1.0, like=wi_l), wi_l)
    wi = _to_world_fused(fr, normalize_fused(wi_l))
    return wi, weight, pdf_out, is_trans, transmitted
