"""Many-light sampling: emissive-triangle collection, alias-table selection,
NEE with MIS (port of ``luminary_tpu/ops/lights.py``).

Per-light candidate data comes from one fused-row gather (kernel A): the
alias draw's acceptance probability and both possible 18-column blocks ride
one row of ``light_slot_rows``; a light-tree candidate fetches its block by
dense light index. Small scenes (no shade rows) index the dense tables.
Emission-texture micro weights are not ported (``pack_scene`` refuses them).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .random import RandomTarget, random_2d
from .rowops import gather_planar, gather_soa
from .vec import Vec3, gather as vgather


@dataclass
class DeviceLights:
    """Alias table over L emissive triangles + per-slot MIS data + the light
    tree (dummy [1, 128] rows when absent). Host ints: num_lights,
    tree_num_nodes, tree_levels."""

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
                   emissive_flags, valid_slot) -> dict:
    """Collect emissive triangles (host numpy) → dict of the DeviceLights
    fields, numpy arrays and host numbers."""
    p = tri_v0.shape[0]
    mat = material_id.astype(np.int64)
    is_light = valid_slot & emissive_flags[mat]
    slots = np.nonzero(is_light)[0].astype(np.int32)

    area = 0.5 * np.linalg.norm(np.cross(tri_e1, tri_e2), axis=-1).astype(np.float32)
    lum = (0.2126 * emission[mat, 0] + 0.7152 * emission[mat, 1]
           + 0.0722 * emission[mat, 2]).astype(np.float32)
    power = area * lum * np.pi  # one-sided diffuse emitter power

    slot_select_pdf = np.zeros(p, np.float32)
    if len(slots):
        slots = slots[power[slots] > 0.0]
    if not len(slots):
        return dict(
            prob=np.ones((1,), np.float32), alias=np.zeros((1,), np.int32),
            slot=np.zeros((1,), np.int32), select_pdf=np.zeros((1,), np.float32),
            slot_select_pdf=slot_select_pdf, slot_area=area, num_lights=0,
            total_power=0.0, tree_rows=np.zeros((1, 128), np.float32),
            tree_num_nodes=0, tree_levels=0)
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
    return dict(
        prob=prob, alias=alias, slot=slots, select_pdf=sel,
        slot_select_pdf=slot_select_pdf, slot_area=area,
        num_lights=int(len(slots)), total_power=float(np.float32(total)),
        tree_rows=tree_rows, tree_num_nodes=int(tree_nodes),
        tree_levels=int(tree_levels))


def lights_to_device(fields: dict, device) -> DeviceLights:
    arrays = ("prob", "alias", "slot", "select_pdf", "slot_select_pdf",
              "slot_area", "tree_rows")
    kw = {k: (torch.as_tensor(np.array(v, copy=True, order="C"), device=device)
              if k in arrays else v) for k, v in fields.items()}
    return DeviceLights(**kw)


def sample_light_point(lights: DeviceLights, shade_rows, pixel_id, sample_id,
                       depth, geo=None, materials=None, slot=None,
                       pdf_select=None, sel_valid=None, bn=None):
    """Draw one light triangle + a uniform point on it.

    Selection: the alias table, or a caller-drawn candidate in dense
    light-index space (``slot``/``pdf_select``/``sel_valid``, a light-tree
    descent). ``shade_rows`` is the fused [L, 37] light_slot_rows table, or
    None for small scenes. Returns (light_slot, point, normal, pdf_area,
    pdf_area_alias, (r, g, b) emission, valid, (b1, b2)).
    """
    from ..render.device_scene import (
        LSR_ALIAS_PROB, LSR_ALIAS_ROW, LSR_AREA, LSR_COLS, LSR_E1, LSR_E2,
        LSR_EMISSION, LSR_FACE_N, LSR_FUSED_COLS, LSR_SELECT_PDF, LSR_SLOT,
        LSR_V0,
    )

    row = None
    light_ix = None
    if slot is None:
        l = lights.prob.shape[0]
        r = random_2d(RandomTarget.LIGHT_TREE, pixel_id, sample_id, depth, bn=bn)
        idx = torch.clamp((r[..., 0] * l).to(torch.int32), max=l - 1)
        if shade_rows is not None and shade_rows.shape[1] >= LSR_FUSED_COLS:
            rf = gather_planar(shade_rows, idx)  # [37, N]
            take_alias = (r[..., 1] >= rf[LSR_ALIAS_PROB])[None, :]
            row = torch.where(
                take_alias, rf[LSR_ALIAS_ROW:LSR_ALIAS_ROW + LSR_COLS],
                rf[0:LSR_COLS])
            pdf_select = row[LSR_SELECT_PDF]
        else:
            idx_l = idx.long()
            take_alias = r[..., 1] >= lights.prob[idx_l]
            light_ix = torch.where(take_alias, lights.alias[idx_l], idx)
            pdf_select = lights.select_pdf[light_ix.long()]
    else:
        light_ix = torch.clamp(slot, min=0)

    r2 = random_2d(RandomTarget.LIGHT_TRIANGLE, pixel_id, sample_id, depth, bn=bn)
    r1u, r2u = r2[..., 0], r2[..., 1]
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
