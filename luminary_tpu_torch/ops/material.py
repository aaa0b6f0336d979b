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
    ggx_reflect_eval,
    roughness_to_alpha,
    sample_vndf,
    sample_vndf_bounded,
    smith_g1,
    smith_g2,
)
from .random import RandomTarget, random_1d, random_2d
from .vec import Vec3, dot, normalize, orthonormal_basis, reflect, vwhere


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


def make_frame(mat: LaneMaterial, ns: Vec3, wo: Vec3,
               quad: torch.Tensor) -> ShadingFrame:
    t, b = orthonormal_basis(ns)
    wo_l = Vec3(dot(wo, t), dot(wo, b), dot(wo, ns))
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
    fres = f_avg + (1.0 - f_avg) * m5
    kd_lum = (kd_r + kd_g + kd_b) * (1.0 / 3.0)
    p = fres / torch.clamp(fres + kd_lum * (1.0 - fres), min=1e-6)
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
    Translucent lanes evaluate to zero (delta lobes)."""
    wi_l = _to_local(fr, wi)
    spec, pdf_spec = ggx_reflect_eval(
        fr.quad, fr.wo_l, wi_l, fr.alpha, (fr.f0_r, fr.f0_g, fr.f0_b),
        roughness)
    diff, pdf_diff = diffuse_eval(wi_l, (fr.kd_r, fr.kd_g, fr.kd_b))
    pdf = fr.p_spec * pdf_spec + (1.0 - fr.p_spec) * pdf_diff
    live = ~mat.translucent
    f = tuple(torch.where(live, s + d, 0.0) for s, d in zip(spec, diff))
    return f, torch.where(live, pdf, 0.0)


def material_sample(mat: LaneMaterial, fr: ShadingFrame, ns: Vec3, wo: Vec3,
                    pixel_id, sample_id, depth, eta_rel=None, bn=None):
    """Sample an outgoing direction → (wi, weight (r,g,b) = f·cos/pdf, pdf,
    is_delta, transmitted)."""
    wo_l = fr.wo_l
    r_choice = random_1d(RandomTarget.BSDF_CHOICE, pixel_id, sample_id, depth,
                         bn=bn)
    r2 = random_2d(RandomTarget.BSDF_REFLECTION, pixel_id, sample_id, depth,
                   bn=bn)

    # --- opaque path: specular or diffuse ---
    choose_spec = r_choice < fr.p_spec
    h = sample_vndf_bounded(wo_l, fr.alpha, r2)
    wi_spec_l = reflect(-wo_l, h)
    phi = 2.0 * np.pi * r2[..., 0]
    sr = torch.sqrt(torch.clamp(r2[..., 1], 0.0, 1.0))
    wi_diff_l = Vec3(
        torch.cos(phi) * sr,
        torch.sin(phi) * sr,
        torch.sqrt(torch.clamp(1.0 - r2[..., 1], min=0.0)),
    )
    wi_l = vwhere(choose_spec, wi_spec_l, wi_diff_l)
    spec, pdf_spec = ggx_reflect_eval(
        fr.quad, wo_l, wi_l, fr.alpha, (fr.f0_r, fr.f0_g, fr.f0_b),
        mat.roughness)
    diff, pdf_diff = diffuse_eval(wi_l, (fr.kd_r, fr.kd_g, fr.kd_b))
    pdf = fr.p_spec * pdf_spec + (1.0 - fr.p_spec) * pdf_diff
    ok = (wi_l.z > 0.0) & (pdf > 1e-10)
    inv_pdf = torch.where(ok, 1.0 / torch.clamp(pdf, min=1e-10), 0.0)
    w_opaque = tuple((s + d) * inv_pdf for s, d in zip(spec, diff))

    # --- translucent path: rough dielectric ---
    eta = eta_rel if eta_rel is not None else mat.ior
    ht = sample_vndf(wo_l, fr.alpha, r2)
    cos_oh = torch.clamp(dot(wo_l, ht), 1e-6, 1.0)
    fres = fresnel_dielectric(cos_oh, eta)
    fres = torch.where(mat.thin_walled, 2.0 * fres / (1.0 + fres), fres)
    choose_reflect = r_choice < fres
    wi_refl_l = reflect(-wo_l, ht)
    inv_eta = 1.0 / torch.clamp(eta, min=1e-6)
    sin2_t = inv_eta * inv_eta * torch.clamp(1.0 - cos_oh * cos_oh, min=0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, 0.0, 1.0))
    wi_refr_l = Vec3(
        -wo_l.x * inv_eta + (inv_eta * cos_oh - cos_t) * ht.x,
        -wo_l.y * inv_eta + (inv_eta * cos_oh - cos_t) * ht.y,
        -wo_l.z * inv_eta + (inv_eta * cos_oh - cos_t) * ht.z,
    )
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
    wi = _to_world(fr, normalize(wi_l))
    return wi, weight, pdf_out, is_trans, transmitted
