"""Many-light sampling: emissive-triangle collection, alias-table selection,
NEE with MIS (port of ``luminary_tpu/ops/lights.py``).

Per-light candidate data comes from one fused-row gather (kernel A): the
alias draw's acceptance probability and both possible 18-column blocks ride
one row of ``light_slot_rows``; a light-tree candidate fetches its block by
dense light index. Small scenes (no shade rows) index the dense tables.

Emitters with a luminance texture carry 16 micro-cell weights over the
sqrt-warp domain of the triangle (``micro_rows``): the sampled point falls in
a cell drawn by weight, and both the true and the nominal MIS pdf gain the
cell factor. With them the fused rows are 69 columns wide (the light's and
its alias partner's weights at cols 37:53 and 53:69).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .random import RandomTarget, random_1d, random_2d
from .rowops import gather_planar, gather_soa
from .vec import Vec3, gather as vgather


@dataclass
class DeviceLights:
    """Alias table over L emissive triangles + per-slot MIS data + the light
    tree (dummy [1, 128] rows when absent) + the micro-cell weights
    ``micro_rows [L, 16]`` (dummy [1, 16] of ones without ``has_micro``).
    Host values: num_lights, total_power, tree_num_nodes, tree_levels,
    has_micro."""

    prob: torch.Tensor
    alias: torch.Tensor
    slot: torch.Tensor
    select_pdf: torch.Tensor
    slot_select_pdf: torch.Tensor
    slot_area: torch.Tensor
    num_lights: int
    total_power: float
    tree_rows: torch.Tensor
    tree_num_nodes: int = 0
    tree_levels: int = 0
    micro_rows: torch.Tensor | None = None
    has_micro: bool = False

    @property
    def has_tree(self) -> bool:
        return self.tree_levels > 0


def build_alias_table(weights: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vose's O(L) alias method (host-side, numpy)."""
    l = len(weights)
    prob = np.zeros(l, np.float32)
    alias = np.zeros(l, np.int32)
    w = weights * l / max(weights.sum(), 1e-20)
    small = [i for i in range(l) if w[i] < 1.0]
    large = [i for i in range(l) if w[i] >= 1.0]
    while small and large:
        s, g = small.pop(), large.pop()
        prob[s] = w[s]
        alias[s] = g
        w[g] = w[g] + w[s] - 1.0
        (small if w[g] < 1.0 else large).append(g)
    for g in large:
        prob[g] = 1.0
    for s in small:
        prob[s] = 1.0
    return prob, alias


def pack_lights_np(tri_v0, tri_e1, tri_e2, material_id, emission,
                   emissive_flags, valid_slot, tex_lum_mean=None,
                   micro_w=None) -> dict:
    """Collect emissive triangles (host numpy) → dict of the DeviceLights
    fields, numpy arrays and host numbers. ``tex_lum_mean`` [P] (a luminance
    map's triangle mean) scales each emitter's selection power;
    ``micro_w`` [P, 16] are its micro-cell weights, kept only where some
    light's weights vary."""
    p = tri_v0.shape[0]
    mat = material_id.astype(np.int64)
    is_light = valid_slot & emissive_flags[mat]
    slots = np.nonzero(is_light)[0].astype(np.int32)

    area = 0.5 * np.linalg.norm(np.cross(tri_e1, tri_e2), axis=-1).astype(np.float32)
    lum = (0.2126 * emission[mat, 0] + 0.7152 * emission[mat, 1]
           + 0.0722 * emission[mat, 2]).astype(np.float32)
    power = area * lum * np.pi  # one-sided diffuse emitter power
    if tex_lum_mean is not None:
        power = power * tex_lum_mean.astype(np.float32)

    slot_select_pdf = np.zeros(p, np.float32)
    if len(slots):
        slots = slots[power[slots] > 0.0]
    if not len(slots):
        return dict(
            prob=np.ones((1,), np.float32), alias=np.zeros((1,), np.int32),
            slot=np.zeros((1,), np.int32), select_pdf=np.zeros((1,), np.float32),
            slot_select_pdf=slot_select_pdf, slot_area=area, num_lights=0,
            total_power=0.0, tree_rows=np.zeros((1, 128), np.float32),
            tree_num_nodes=0, tree_levels=0,
            micro_rows=np.ones((1, 16), np.float32), has_micro=False)
    w = power[slots]
    total = float(w.sum())
    sel = (w / max(total, 1e-20)).astype(np.float32)
    prob, alias = build_alias_table(w.astype(np.float64))
    slot_select_pdf[slots] = sel

    from .light_tree import LIGHT_TREE_MIN_LIGHTS, build_light_tree

    tree_rows = np.zeros((1, 128), np.float32)
    tree_nodes = tree_levels = 0
    if len(slots) >= LIGHT_TREE_MIN_LIGHTS:
        v0s, e1s, e2s = tri_v0[slots], tri_e1[slots], tri_e2[slots]
        tree = build_light_tree(
            centroid=(v0s + (e1s + e2s) / 3.0).astype(np.float32),
            corners=np.stack([v0s, v0s + e1s, v0s + e2s], axis=1).astype(np.float32),
            power=w.astype(np.float32),
            slots=np.arange(len(slots), dtype=np.int32),
        )
        tree_rows = tree.rows
        tree_nodes, tree_levels = tree.num_nodes, tree.levels
    micro_rows, has_micro = np.ones((1, 16), np.float32), False
    if micro_w is not None:
        mr = micro_w[slots].astype(np.float32)  # [L, 16]
        # a uniform map reduces to uniform point sampling at extra cost
        spread = mr.max(axis=1) - mr.min(axis=1)
        if (spread > 1e-3 * mr.max(axis=1)).any():
            micro_rows, has_micro = mr, True
    return dict(
        prob=prob, alias=alias, slot=slots, select_pdf=sel,
        slot_select_pdf=slot_select_pdf, slot_area=area,
        num_lights=int(len(slots)), total_power=float(np.float32(total)),
        tree_rows=tree_rows, tree_num_nodes=int(tree_nodes),
        tree_levels=int(tree_levels), micro_rows=micro_rows,
        has_micro=has_micro)


def lights_to_device(fields: dict, device) -> DeviceLights:
    arrays = ("prob", "alias", "slot", "select_pdf", "slot_select_pdf",
              "slot_area", "tree_rows", "micro_rows")
    kw = {k: (torch.as_tensor(np.array(v, copy=True, order="C"), device=device)
              if k in arrays else v) for k, v in fields.items()}
    return DeviceLights(**kw)


def sample_light_point(lights: DeviceLights, shade_rows, pixel_id, sample_id,
                       depth, geo=None, materials=None, slot=None,
                       pdf_select=None, sel_valid=None, bn=None):
    """Draw one light triangle + a point on it.

    Selection: the alias table, or a caller-drawn candidate in dense
    light-index space (``slot``/``pdf_select``/``sel_valid``, a light-tree
    descent). ``shade_rows`` is the fused light_slot_rows table ([L, 37], or
    [L, 69] with micro weights), or None for small scenes. The point is
    uniform on the triangle, or, with micro weights, uniform in a cell of the
    sqrt-warp domain drawn by weight. Returns (light_slot, point, normal,
    pdf_area, pdf_area_alias, (r, g, b) emission, valid, (b1, b2)).
    """
    from ..render.device_scene import (
        LSR_ALIAS_PROB, LSR_ALIAS_ROW, LSR_AREA, LSR_COLS, LSR_E1, LSR_E2,
        LSR_EMISSION, LSR_FACE_N, LSR_FUSED_COLS, LSR_FUSED_MICRO_COLS,
        LSR_MICRO_ALIAS, LSR_MICRO_OWN, LSR_SELECT_PDF, LSR_SLOT, LSR_V0,
    )

    row = None
    mrow = None  # the candidate's micro weights [16, N], when already fetched
    light_ix = None
    fused_cols = LSR_FUSED_MICRO_COLS if lights.has_micro else LSR_FUSED_COLS
    if slot is None:
        l = lights.prob.shape[0]
        r = random_2d(RandomTarget.LIGHT_TREE, pixel_id, sample_id, depth, bn=bn)
        idx = torch.clamp((r[..., 0] * l).to(torch.int32), max=l - 1)
        if shade_rows is not None and shade_rows.shape[1] >= fused_cols:
            rf = gather_planar(shade_rows, idx)  # [37 | 69, N]
            take_alias = (r[..., 1] >= rf[LSR_ALIAS_PROB])[None, :]
            row = torch.where(
                take_alias, rf[LSR_ALIAS_ROW:LSR_ALIAS_ROW + LSR_COLS],
                rf[0:LSR_COLS])
            pdf_select = row[LSR_SELECT_PDF]
            if lights.has_micro:
                mrow = torch.where(
                    take_alias, rf[LSR_MICRO_ALIAS:LSR_MICRO_ALIAS + 16],
                    rf[LSR_MICRO_OWN:LSR_MICRO_OWN + 16])
        else:
            idx_l = idx.long()
            take_alias = r[..., 1] >= lights.prob[idx_l]
            light_ix = torch.where(take_alias, lights.alias[idx_l], idx)
            pdf_select = lights.select_pdf[light_ix.long()]
    else:
        light_ix = torch.clamp(slot, min=0)

    r2 = random_2d(RandomTarget.LIGHT_TRIANGLE, pixel_id, sample_id, depth, bn=bn)
    r1u, r2u = r2[..., 0], r2[..., 1]
    micro_factor = None
    if lights.has_micro:
        if mrow is None:
            mrow = gather_planar(lights.micro_rows, light_ix)  # [16, N]
        mr = random_1d(RandomTarget.MICROTRIANGLE, pixel_id, sample_id, depth,
                       bn=bn)
        cum = [mrow[0]]
        for c in range(1, 16):  # sequential prefix sums, as the reference
            cum.append(cum[-1] + mrow[c])
        tot = cum[-1]
        thr = mr * tot
        pick = torch.clamp(sum((c <= thr).to(torch.int32) for c in cum), max=15)
        w_c = mrow.gather(0, pick.long()[None])[0]
        ok_m = tot > 0.0
        p_cell = torch.where(ok_m, w_c / torch.clamp(tot, min=1e-30), 1.0)
        ci = torch.div(pick, 4, rounding_mode="floor").to(torch.float32)
        cj = (pick % 4).to(torch.float32)
        r1u = torch.where(ok_m, (ci + r1u) * 0.25, r1u)
        r2u = torch.where(ok_m, (cj + r2u) * 0.25, r2u)
        micro_factor = torch.where(ok_m & (p_cell > 0.0), p_cell * 16.0, 1.0)
    su = torch.sqrt(torch.clamp(r1u, 1e-8, 1.0))
    b1 = 1.0 - su
    b2 = r2u * su
    if shade_rows is not None:
        if row is None:  # tree-candidate path: the 18-col block by dense id
            row = gather_soa(shade_rows, light_ix, LSR_COLS, 1)
        slot = row[LSR_SLOT].contiguous().view(torch.int32)
        v0 = Vec3(row[LSR_V0], row[LSR_V0 + 1], row[LSR_V0 + 2])
        e1 = Vec3(row[LSR_E1], row[LSR_E1 + 1], row[LSR_E1 + 2])
        e2 = Vec3(row[LSR_E2], row[LSR_E2 + 1], row[LSR_E2 + 2])
        n = Vec3(row[LSR_FACE_N], row[LSR_FACE_N + 1], row[LSR_FACE_N + 2])
        emission = (row[LSR_EMISSION], row[LSR_EMISSION + 1],
                    row[LSR_EMISSION + 2])
        area = row[LSR_AREA]
        alias_select = row[LSR_SELECT_PDF]
    else:
        slot = lights.slot[light_ix.long()]
        sl = slot.long()
        v0 = vgather(geo.bvh.tri_v0, sl)
        e1 = vgather(geo.bvh.tri_e1, sl)
        e2 = vgather(geo.bvh.tri_e2, sl)
        n = vgather(geo.face_normal, sl)
        l_mat = geo.material_id[sl].long()
        emission = (materials.emission_r[l_mat], materials.emission_g[l_mat],
                    materials.emission_b[l_mat])
        area = lights.slot_area[sl]
        alias_select = lights.slot_select_pdf[sl]
    point = v0 + e1 * b1 + e2 * b2
    pdf_area = pdf_select / torch.clamp(area, min=1e-12)
    pdf_area_alias = alias_select / torch.clamp(area, min=1e-12)
    if micro_factor is not None:
        # the cell factor enters the true pdf and the nominal MIS pdf alike;
        # the hit side applies the same factor from shade_micro
        pdf_area = pdf_area * micro_factor
        pdf_area_alias = pdf_area_alias * micro_factor
    ok = lights.num_lights > 0
    ok = (sel_valid & ok) if sel_valid is not None else ((pdf_select > 0.0) & ok)
    return slot, point, n, pdf_area, pdf_area_alias, emission, ok, (b1, b2)


def light_pdf_from_row(sel_pdf, area, hit_t, cos_light):
    """Solid-angle pdf NEE would have produced this BSDF-sampled hit."""
    pdf_area = sel_pdf / torch.clamp(area, min=1e-12)
    return pdf_area * hit_t * hit_t / torch.clamp(torch.abs(cos_light), min=1e-8)


def mis_balance(pdf_a, pdf_b):
    """Balance heuristic weight for strategy a."""
    return pdf_a / torch.clamp(pdf_a + pdf_b, min=1e-20)
