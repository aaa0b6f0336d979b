"""Many-light hierarchy: host-built 16-wide light tree + stochastic descent
(port of ``luminary_tpu/ops/light_tree.py``) — kernel C,
``csrc/light_tree_descend.cu``.

The build is host numpy, the same algorithm as the reference, so the tree
rows compare word for word. The descent draws ONE light per call: each level
picks a child by clamped-distance power times the orientation-cone factor
(floored at CONE_EPS) and multiplies its probability into the pdf. On a CUDA
table the whole descent is one launch of kernel C; on a CPU table it runs
:func:`light_tree_descend_plain`, an eager port of the JAX package's XLA
level body. Both take their per-level uniforms from the caller and sum each
CDF sequentially, child 0 first.

Node row [128]: 0:16 child centre x | 16:32 y | 32:48 z | 48:64 radius |
64:80 subtree power | 80:96 child code (i32 bits) | 96:112 cone axis (oct
uv as 2 x f16) | 112:128 cos of the cone half-angle.
Leaf row [128]: 0:14 light index (i32 bits, -1 pad) | 14:28 power |
28:42 centroid x | 42:56 y | 56:70 z | 70:84 face normal (oct 2 x f16).
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from ..bvh.builder import build_bvh
from ..bvh.wide import _collapse_children
from .random import RandomTarget, random_1d
from .vec import Vec3

INVALID = 0x7FFFFFFF
TREE_LEAF = 14
BRANCH = 16
LIGHT_TREE_MIN_LIGHTS = 64
CONE_EPS = 0.01


def _oct_encode_np(n: np.ndarray) -> np.ndarray:
    """Unit vectors [K, 3] → octahedral uv in [-1, 1]² (numpy)."""
    a = np.abs(n).sum(axis=-1, keepdims=True)
    v = n / np.maximum(a, 1e-12)
    uv = v[..., [0, 2]].copy()
    neg = v[..., 1] < 0.0
    flip = (1.0 - np.abs(uv[..., ::-1])) * np.where(uv >= 0.0, 1.0, -1.0)
    uv[neg] = flip[neg]
    return uv


def _pack_oct_f16(uv: np.ndarray) -> np.ndarray:
    """oct uv [K, 2] → one f32 per vector carrying two f16 halves."""
    h = uv.astype(np.float16).view(np.uint16).astype(np.uint32)
    packed = h[..., 0] | (h[..., 1] << 16)
    return packed.view(np.float32)


def _f16_halves(col: torch.Tensor):
    """f32 words carrying two f16 halves → (lo, hi) float32."""
    bits = col.contiguous().view(torch.int32)
    lo = (bits & 0xFFFF).to(torch.int16)  # wraps to the half's bit pattern
    hi = ((bits >> 16) & 0xFFFF).to(torch.int16)
    return (lo.view(torch.float16).to(torch.float32),
            hi.view(torch.float16).to(torch.float32))


def _unpack_oct_f16(col: torch.Tensor):
    """Inverse of _pack_oct_f16 → unit direction components."""
    u, v = _f16_halves(col)
    y = 1.0 - torch.abs(u) - torch.abs(v)
    neg = y < 0.0
    sx = torch.where(u >= 0.0, 1.0, -1.0)
    sz = torch.where(v >= 0.0, 1.0, -1.0)
    x = torch.where(neg, (1.0 - torch.abs(v)) * sx, u)
    z = torch.where(neg, (1.0 - torch.abs(u)) * sz, v)
    inv = 1.0 / torch.sqrt(torch.clamp(x * x + y * y + z * z, min=1e-12))
    return x * inv, y * inv, z * inv


class LightTree(NamedTuple):
    rows: np.ndarray  # f32 [M+B, 128]
    num_nodes: int
    levels: int  # max node depth (the descent runs levels + 1 steps)


def build_light_tree(centroid: np.ndarray, corners: np.ndarray,
                     power: np.ndarray, slots: np.ndarray) -> LightTree:
    """SAH build over light bounds + 16-wide collapse with per-subtree power
    and orientation-cone aggregation (host numpy, as in the reference)."""
    bvh2 = build_bvh(corners, leaf_size=TREE_LEAF)

    e1 = corners[:, 1] - corners[:, 0]
    e2 = corners[:, 2] - corners[:, 0]
    nrm = np.cross(e1, e2)
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)

    n_blocks = bvh2.num_blocks

    def block_lights(b: int) -> np.ndarray:
        ids = bvh2.tri_order[b * TREE_LEAF: (b + 1) * TREE_LEAF]
        return ids[ids >= 0]

    def cone_union(axes, thetas, weights):
        w = np.maximum(np.asarray(weights, np.float64), 1e-12)
        axis = (np.asarray(axes) * w[:, None]).sum(axis=0)
        ln = np.linalg.norm(axis)
        if ln < 1e-9:
            return np.array([0.0, 1.0, 0.0]), np.pi
        axis = axis / ln
        ang = np.arccos(np.clip(np.asarray(axes) @ axis, -1.0, 1.0))
        theta = float(np.minimum(np.max(ang + np.asarray(thetas)), np.pi))
        return axis, theta

    block_power = np.zeros(n_blocks, np.float64)
    block_axis = np.zeros((n_blocks, 3), np.float64)
    block_theta = np.zeros(n_blocks, np.float64)
    for b in range(n_blocks):
        ids = block_lights(b)
        block_power[b] = power[ids].sum()
        if len(ids):
            block_axis[b], block_theta[b] = cone_union(
                nrm[ids], np.zeros(len(ids)), power[ids])
        else:
            block_axis[b] = (0.0, 1.0, 0.0)
            block_theta[b] = np.pi

    node_power = np.zeros(bvh2.num_nodes, np.float64)
    node_axis = np.zeros((bvh2.num_nodes, 3), np.float64)
    node_theta = np.zeros(bvh2.num_nodes, np.float64)
    node_done = np.zeros(bvh2.num_nodes, bool)

    def subtree_cone(code: int):
        if code == INVALID:
            return 0.0, np.array([0.0, 1.0, 0.0]), 0.0
        if code < 0:
            b = ~code
            return float(block_power[b]), block_axis[b], float(block_theta[b])
        if not node_done[code]:
            p0, a0, t0 = subtree_cone(int(bvh2.child[code, 0]))
            p1, a1, t1 = subtree_cone(int(bvh2.child[code, 1]))
            node_power[code] = p0 + p1
            node_axis[code], node_theta[code] = cone_union(
                [a0, a1], [t0, t1], [p0, p1])
            node_done[code] = True
        return (float(node_power[code]), node_axis[code],
                float(node_theta[code]))

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100000))
    try:
        subtree_cone(0)
    finally:
        sys.setrecursionlimit(old)

    node_rows: list[np.ndarray] = []
    leaf_rows: list[np.ndarray] = []
    pending = [(0, 0)]
    node_rows.append(np.zeros(128, np.float32))
    depth_of = {0: 1}
    max_depth = 1

    def emit_leaf(code2: int) -> int:
        ids = block_lights(~code2)
        row = np.zeros(128, np.float32)
        srow = np.full(TREE_LEAF, -1, np.int32)
        srow[: len(ids)] = slots[ids]
        row[0:14] = srow.view(np.float32)
        row[14: 14 + len(ids)] = power[ids]
        row[28: 28 + len(ids)] = centroid[ids, 0]
        row[42: 42 + len(ids)] = centroid[ids, 1]
        row[56: 56 + len(ids)] = centroid[ids, 2]
        if len(ids):
            row[70: 70 + len(ids)] = _pack_oct_f16(_oct_encode_np(nrm[ids]))
        leaf_rows.append(row)
        return ~(len(leaf_rows) - 1)

    while pending:
        wide_id, node2 = pending.pop()
        entries = _collapse_children(bvh2, node2)
        row = np.zeros(128, np.float32)
        codes = np.full(BRANCH, INVALID, np.int32)
        for k, (code, lo, hi) in enumerate(entries):
            c = 0.5 * (lo + hi)
            row[0 * 16 + k] = c[0]
            row[1 * 16 + k] = c[1]
            row[2 * 16 + k] = c[2]
            row[3 * 16 + k] = 0.5 * float(np.linalg.norm(hi - lo))
            p_sub, c_axis, c_theta = subtree_cone(int(code))
            row[6 * 16 + k] = float(_pack_oct_f16(
                _oct_encode_np(np.asarray([c_axis])))[0])
            row[7 * 16 + k] = float(np.cos(min(c_theta, np.pi)))
            row[4 * 16 + k] = p_sub
            if code < 0:
                codes[k] = emit_leaf(int(code))
            else:
                child_wide = len(node_rows)
                node_rows.append(np.zeros(128, np.float32))
                pending.append((child_wide, int(code)))
                codes[k] = child_wide
                depth_of[child_wide] = depth_of[wide_id] + 1
                max_depth = max(max_depth, depth_of[child_wide])
        row[5 * 16: 6 * 16] = codes.view(np.float32)
        node_rows[wide_id] = row

    if not leaf_rows:  # degenerate: no lights
        leaf_rows.append(np.zeros(128, np.float32))
        leaf_rows[0][0:14] = np.full(TREE_LEAF, -1, np.int32).view(np.float32)

    rows = np.concatenate(
        [np.stack(node_rows), np.stack(leaf_rows)], axis=0
    ).astype(np.float32)
    return LightTree(rows=rows, num_nodes=len(node_rows), levels=max_depth)


def _seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Prefix sum along dim 0, one row after another (the kernel's order)."""
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[0])
    for k in range(x.shape[0]):
        acc = acc + x[k]
        out[k] = acc
    return out


def light_tree_descend_plain(tree_rows: torch.Tensor, num_nodes: int,
                             levels: int, pos: Vec3, rnd: torch.Tensor):
    """Plain PyTorch version of kernel C (the JAX package's XLA level body,
    every level, CDF sums in sequential order). ``rnd`` is [levels+1, N].
    Returns (slot i32 [N], pdf f32 [N], valid bool [N])."""
    dev = tree_rows.device
    rows_i = tree_rows.view(torch.int32)
    px, py, pz = pos.x, pos.y, pos.z
    m = px.shape[0]
    node = torch.zeros(m, dtype=torch.int64, device=dev)
    pdf = torch.ones(m, dtype=torch.float32, device=dev)
    slot = torch.full((m,), -1, dtype=torch.int32, device=dev)
    at_leaf = torch.zeros(m, dtype=torch.bool, device=dev)
    done = torch.zeros(m, dtype=torch.bool, device=dev)
    for lvl in range(levels + 1):
        rowT = tree_rows[node].T  # [128, m]
        rowI = rows_i[node].T
        r = rnd[lvl]

        # --- node interpretation ---
        dx = rowT[0:16] - px[None]
        dy = rowT[16:32] - py[None]
        dz = rowT[32:48] - pz[None]
        rad = rowT[48:64]
        pw = rowT[64:80]
        code16 = rowI[80:96]
        d2 = dx * dx + dy * dy + dz * dz
        imp = pw / torch.maximum(d2, torch.clamp(rad * rad, min=1e-8))
        ax, ay, az = _unpack_oct_f16(rowT[96:112])
        inv_d = 1.0 / torch.sqrt(torch.clamp(d2, min=1e-12))
        cos_t = -(ax * dx + ay * dy + az * dz) * inv_d
        cos_t = torch.clamp(cos_t, -1.0, 1.0)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        cos_o = torch.clamp(rowT[112:128], -1.0, 1.0)
        sin_o = torch.sqrt(torch.clamp(1.0 - cos_o * cos_o, min=0.0))
        c1 = torch.where(cos_t >= cos_o, 1.0, cos_t * cos_o + sin_t * sin_o)
        s1 = torch.sqrt(torch.clamp(1.0 - c1 * c1, min=0.0))
        sin_u = torch.clamp(rad * inv_d, max=1.0)
        cos_u = torch.sqrt(torch.clamp(1.0 - sin_u * sin_u, min=0.0))
        c2 = torch.where(c1 >= cos_u, 1.0, c1 * cos_u + s1 * sin_u)
        imp = imp * torch.clamp(c2, min=CONE_EPS)
        imp = torch.where(code16 == INVALID, 0.0, imp)
        cum = _seq_cumsum(imp)
        tot = cum[-1]
        rt = r * tot
        pick = torch.clamp((cum <= rt[None]).sum(dim=0), max=BRANCH - 1)
        p_c = imp.gather(0, pick[None])[0] / torch.clamp(tot, min=1e-30)
        c_sel = code16.gather(0, pick[None])[0]

        # --- leaf interpretation (the root is always a node) ---
        if lvl == 0:
            ltot = torch.zeros(m, device=dev)
            p_l = torch.zeros(m, device=dev)
            s_sel = torch.zeros(m, dtype=torch.int32, device=dev)
        else:
            lslot = rowI[0:14]
            lpw = rowT[14:28]
            ldx = rowT[28:42] - px[None]
            ldy = rowT[42:56] - py[None]
            ldz = rowT[56:70] - pz[None]
            ld2 = ldx * ldx + ldy * ldy + ldz * ldz
            lnx, lny, lnz = _unpack_oct_f16(rowT[70:84])
            l_inv_d = 1.0 / torch.sqrt(torch.clamp(ld2, min=1e-12))
            l_cos = -(lnx * ldx + lny * ldy + lnz * ldz) * l_inv_d
            l_face = torch.clamp(l_cos, min=CONE_EPS)
            limp = torch.where(lslot >= 0,
                               lpw * l_face / torch.clamp(ld2, min=1e-8), 0.0)
            lcum = _seq_cumsum(limp)
            ltot = lcum[-1]
            lrt = r * ltot
            lpick = torch.clamp((lcum <= lrt[None]).sum(dim=0),
                                max=TREE_LEAF - 1)
            p_l = limp.gather(0, lpick[None])[0] / torch.clamp(ltot, min=1e-30)
            s_sel = lslot.gather(0, lpick[None])[0]

        # --- merge the two interpretations ---
        step_node = ~done & ~at_leaf
        step_leaf = ~done & at_leaf
        ok_node = step_node & (tot > 0.0)
        ok_leaf = step_leaf & (ltot > 0.0)
        pdf = torch.where(ok_node, pdf * p_c, pdf)
        pdf = torch.where(ok_leaf, pdf * p_l, pdf)
        slot = torch.where(ok_leaf, s_sel, slot)
        done = done | step_leaf | (step_node & ~ok_node)
        next_leaf = c_sel < 0
        node = torch.where(
            ok_node,
            torch.where(next_leaf, num_nodes + ~c_sel, c_sel).to(torch.int64),
            node)
        at_leaf = torch.where(ok_node, next_leaf, at_leaf)

    valid = (slot >= 0) & (pdf > 0.0)
    return slot, pdf, valid


_argtypes_set = False


def light_tree_descend(tree_rows: torch.Tensor, num_nodes: int, levels: int,
                       pos: Vec3, rnd: torch.Tensor):
    """Kernel C: one descent per lane from ``pos`` with per-level uniforms
    ``rnd`` [levels+1, N] → (slot i32, pdf f32, valid bool)."""
    return light_tree_descend_plain(tree_rows, num_nodes, levels, pos, rnd)




def level_randoms(levels: int, pixel_id, sample_id, dk: int, n: int,
                  bn=None) -> torch.Tensor:
    """The descent's uniforms: random_1d(LIGHT_TREE_LEVEL, ..., dk*8+lvl)
    for lvl = 0..levels, stacked [levels+1, N]."""
    rs = [random_1d(RandomTarget.LIGHT_TREE_LEVEL, pixel_id, sample_id,
                    dk * 8 + lvl, bn=bn) for lvl in range(levels + 1)]
    return torch.stack([r.expand(n) for r in rs], dim=0)


def sample_light_tree(tree_rows: torch.Tensor, num_nodes: int, levels: int,
                      pos: Vec3, pixel_id, sample_id, dk: int, bn=None):
    """One stochastic descent per lane → (slot i32 [N], pdf_select f32 [N],
    valid bool [N]); pdf_select is the exact probability of the pick."""
    n = pos.x.shape[0]
    rnd = level_randoms(levels, pixel_id, sample_id, dk, n, bn=bn)
    return light_tree_descend(tree_rows, num_nodes, levels, pos, rnd)
