"""BVH traversal, two tiers (port of ``luminary_tpu/ops/traverse.py``) —
kernel B, ``csrc/traverse_wide.cu``.

Scenes up to ``DENSE_MAX_SLOTS`` slots brute-force one ``[T, N]``
Möller-Trumbore tile in plain PyTorch (the JAX package's XLA dense tier).
Larger scenes walk the unified 16-wide node+leaf table
(``bvh/wide.py`` layout): on a CUDA table through kernel B, the same packet
walk with a warp of 32 rays per packet, reading one 32-byte row per ray that
the ``unplanar`` kernel packs from the SoA lanes (``ops/rowops.py``); on a
CPU table through :func:`traverse_wide_plain`, an eager port of the JAX
package's packet walk ``_traverse_wide`` (16 rays per packet). Kernel B's
box test is conservative (:func:`slab_admits` mirrors it); the plain one's,
like the JAX one's, is not. The TPU-only parts of the Pallas walk (XLA-level
row fetch, packet compaction, lockstep shrink phases) have no counterpart.

Cutout triangles (alpha < 1) stay in the closest-hit table, where the
integrator alpha-tests them; occlusion queries walk the shadow table, the
same nodes with those triangles degenerated out of the leaves, and
:func:`trace_transmission` multiplies in their transparency by a dense pass
in plain PyTorch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .intersect import MISS_DIST, ray_triangle
from .rowops import unplanar
from .vec import Vec3

INVALID_CHILD = 0x7FFFFFFF
DENSE_MAX_SLOTS = 128
WIDE_LEAF = 14
BRANCH = 16
PACKET = 16
MAX_STACK = 64  # csrc/traverse_wide.cu MAX_STACK
# csrc/traverse_wide.cu ROBUST_FAR: 1 + 2^-21, the float32 value at or above
# 1 + 2*gamma(3) (Ize, "Robust BVH Ray Traversal", JCGT 2(2), 2013)
ROBUST_FAR = 1.0 + 2.0 ** -21


@dataclass
class DeviceBVH:
    """Unified 16-wide BVH table + leaf-slot-ordered triangle geometry.

    rows f32 [M + B, 128]: node rows then leaf rows. tri_v0/e1/e2: per-slot
    Vec3 tables ([P] each). dense_tris f32 [T, 12] (v0, e1, e2, alpha, pad)
    / dense_slot i32 [T]: the compacted valid slots of small scenes (None
    above 4 x 128 slots). depth (max interior depth) and num_nodes are host
    ints.

    Cutouts (slots of alpha < 1): ``rows_shadow`` is ``rows`` with those
    triangles degenerated out of the leaf rows (the any-hit walk sees opaque
    geometry only) and ``cut_tris`` f32 [Tc, 12 | 44] holds them for the
    transmission pass: v0, e1, e2, alpha, pad, and with a micro-alpha grid
    the 64 u16 cell alphas in 32 words at cols 12:44. Both None without
    cutouts.
    """

    rows: torch.Tensor
    tri_v0: Vec3
    tri_e1: Vec3
    tri_e2: Vec3
    dense_tris: torch.Tensor | None
    dense_slot: torch.Tensor | None
    bounds: torch.Tensor
    depth: int
    num_nodes: int
    rows_shadow: torch.Tensor | None = None
    cut_tris: torch.Tensor | None = None

    @property
    def has_cutouts(self) -> bool:
        return self.cut_tris is not None


class Hit(NamedTuple):
    t: torch.Tensor  # f32 [N] — MISS_DIST on miss
    slot: torch.Tensor  # i32 [N] — leaf-slot index, -1 on miss
    u: torch.Tensor  # f32 [N] barycentric
    v: torch.Tensor  # f32 [N]

    @property
    def valid(self) -> torch.Tensor:
        return self.slot >= 0


def pack_device_bvh(wide, v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                    device, slot_alpha=None, slot_cut_grid=None) -> DeviceBVH:
    """WideBVH (bvh/wide.py) + slot triangles [P, 3] → DeviceBVH on
    ``device`` (numpy packing, one upload per table). ``slot_alpha`` f32 [P]
    (material alpha x mean texture alpha) marks the cutout slots;
    ``slot_cut_grid`` u16 [P, 64] is their 8x8 barycentric-cell mean alpha."""
    from ..bvh.wide import pack_leaf_rows

    wide = pack_leaf_rows(wide, v0, e1, e2)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    def v3(a):
        return Vec3(t(a[..., 0]), t(a[..., 1]), t(a[..., 2]))

    rows_shadow = cut_tris = None
    if slot_alpha is not None and (slot_alpha < 1.0).any():
        cut = slot_alpha < 1.0
        keep = (~cut).astype(np.float32)[:, None]
        shadow = pack_leaf_rows(wide, v0, e1 * keep, e2 * keep)
        rows_shadow = t(np.concatenate([wide.node_rows, shadow.leaf_rows],
                                       axis=0).astype(np.float32))
        ids = np.nonzero(cut)[0]
        tc = (len(ids) + 7) // 8 * 8
        ct = np.zeros((tc, 44 if slot_cut_grid is not None else 12), np.float32)
        ct[:len(ids), 0:3] = v0[ids]
        ct[:len(ids), 3:6] = e1[ids]
        ct[:len(ids), 6:9] = e2[ids]
        ct[:len(ids), 9] = slot_alpha[ids]
        if slot_cut_grid is not None:
            g = np.ascontiguousarray(slot_cut_grid[ids], np.uint16)
            ct[:len(ids), 12:44] = g.view(np.uint32).reshape(len(ids), 32).view(
                np.float32)
        cut_tris = t(ct)

    p = v0.shape[0]
    dense_tris = dense_slot = None
    if p <= 4 * DENSE_MAX_SLOTS:
        valid = np.nonzero(
            (np.abs(e1).sum(-1) > 0) | (np.abs(e2).sum(-1) > 0)
        )[0].astype(np.int32)
        n_t = max(int(valid.shape[0]), 1)
        t_pad = (n_t + 7) // 8 * 8
        dt = np.zeros((t_pad, 12), np.float32)
        dt[:, 9] = 1.0  # padding slots are opaque (and unhittable)
        ds = np.zeros((t_pad,), np.int32)
        if valid.shape[0]:
            dt[:n_t, 0:3] = v0[valid]
            dt[:n_t, 3:6] = e1[valid]
            dt[:n_t, 6:9] = e2[valid]
            dt[:n_t, 9] = slot_alpha[valid] if slot_alpha is not None else 1.0
            ds[:n_t] = valid
        dense_tris, dense_slot = t(dt), t(ds)
    rows = np.concatenate([wide.node_rows, wide.leaf_rows], axis=0)
    corners = np.stack([v0, v0 + e1, v0 + e2], axis=1).reshape(-1, 3)
    bounds = np.concatenate([
        corners.min(axis=0) if p else np.zeros(3, np.float32),
        corners.max(axis=0) if p else np.ones(3, np.float32),
    ]).astype(np.float32)
    return DeviceBVH(
        rows=t(rows.astype(np.float32)),
        tri_v0=v3(v0), tri_e1=v3(e1), tri_e2=v3(e2),
        dense_tris=dense_tris, dense_slot=dense_slot, bounds=t(bounds),
        depth=int(wide.depth), num_nodes=int(wide.num_nodes),
        rows_shadow=rows_shadow, cut_tris=cut_tris,
    )


def _safe_inv(direction: Vec3) -> Vec3:
    """1/d with zero components clamped (no 0*inf NaNs in the slab test)."""

    def f(c):
        return torch.reciprocal(
            torch.where(torch.abs(c) < 1e-20,
                        torch.where(c < 0, -1e-20, 1e-20), c))

    return Vec3(f(direction.x), f(direction.y), f(direction.z))


def slab_admits(lo: Vec3, hi: Vec3, origin: Vec3, inv_dir: Vec3, t_max,
                t_min: float = 1e-4) -> torch.Tensor:
    """Kernel B's box test, elementwise in float32: does the ray meet the box
    [lo, hi] within [t_min, t_max]? ``inv_dir`` is :func:`_safe_inv` of the
    direction. The far distance is widened by ROBUST_FAR before the
    comparison, so the rounding of the test cannot reject a box that holds a
    triangle the ray hits."""
    t1x = (lo.x - origin.x) * inv_dir.x
    t2x = (hi.x - origin.x) * inv_dir.x
    t1y = (lo.y - origin.y) * inv_dir.y
    t2y = (hi.y - origin.y) * inv_dir.y
    t1z = (lo.z - origin.z) * inv_dir.z
    t2z = (hi.z - origin.z) * inv_dir.z
    enter = torch.maximum(
        torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
        torch.clamp(torch.minimum(t1z, t2z), min=t_min))
    leave = torch.minimum(
        torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
        torch.minimum(torch.maximum(t1z, t2z), t_max))
    return enter <= leave * ROBUST_FAR


def _trace_dense(bvh: DeviceBVH, origin: Vec3, direction: Vec3, t_max,
                 any_hit: bool, t_min: float = 1e-4) -> Hit:
    """Brute-force [T, N] Möller-Trumbore over all valid slots."""
    n = origin.x.shape[0]
    o2 = Vec3(origin.x[None, :], origin.y[None, :], origin.z[None, :])
    d2 = Vec3(direction.x[None, :], direction.y[None, :], direction.z[None, :])
    tris = bvh.dense_tris
    tv = Vec3(tris[:, 0:1], tris[:, 1:2], tris[:, 2:3])
    te1 = Vec3(tris[:, 3:4], tris[:, 4:5], tris[:, 5:6])
    te2 = Vec3(tris[:, 6:7], tris[:, 7:8], tris[:, 8:9])

    t, u, v, hit = ray_triangle(o2, d2, tv, te1, te2, t_min=t_min)  # [T, N]
    if any_hit:
        hit = hit & (tris[:, 9:10] >= 1.0)
    t = torch.where(hit, t, MISS_DIST)
    t = torch.where(t <= t_max[None, :], t, MISS_DIST)
    t_best = torch.min(t, dim=0).values
    p = t.shape[0]
    slots_iota = torch.arange(p, dtype=torch.int32, device=t.device)[:, None].expand(p, n)
    at_min = (t == t_best[None, :]) & (t < MISS_DIST)
    slot_best = torch.min(
        torch.where(at_min, slots_iota, INVALID_CHILD), dim=0).values
    found = slot_best != INVALID_CHILD
    winner = slots_iota == torch.where(found, slot_best, -1)[None, :]
    slot_best = torch.where(
        found, bvh.dense_slot[torch.where(found, slot_best, 0).long()], -1)
    u_best = torch.max(torch.where(winner, u, -MISS_DIST), dim=0).values
    v_best = torch.max(torch.where(winner, v, -MISS_DIST), dim=0).values
    t_out = torch.where(found, t_best, MISS_DIST)
    u_best = torch.where(found, u_best, 0.0)
    v_best = torch.where(found, v_best, 0.0)
    return Hit(t=t_out, slot=slot_best.to(torch.int32), u=u_best, v=v_best)


def traverse_wide_plain(rows: torch.Tensor, num_nodes: int, depth: int,
                        origin: Vec3, direction: Vec3, t_max: torch.Tensor,
                        active: torch.Tensor, any_hit: bool,
                        t_min: float = 1e-4, packet: int = PACKET,
                        stats: dict | None = None):
    """Plain PyTorch version of kernel B: an eager port of the JAX package's
    16-ray packet walk (one unified row fetch per packet and step, a short
    stack per packet). Closest hit → :class:`Hit`; any-hit → bool [N].

    ``stats``, when given, receives the ray-level work of the walk:
    ``node_tests`` (live ray × child slab tests) and ``tri_tests`` (live ray
    × leaf triangle tests), from which a run's operation bound is computed.
    """
    dev = rows.device
    rows_i = rows.view(torch.int32)
    m_nodes = int(num_nodes)
    stack_depth = max(int(depth), 1)
    n_in = origin.x.shape[0]
    pad = (-n_in) % packet
    if pad:
        def padv(v):
            return Vec3(
                torch.cat([v.x, torch.zeros(pad, device=dev)]),
                torch.cat([v.y, torch.zeros(pad, device=dev)]),
                torch.cat([v.z, torch.ones(pad, device=dev)]),
            )
        origin = padv(origin)
        direction = padv(direction)
        t_max = torch.cat([t_max, torch.zeros(pad, device=dev)])
        active = torch.cat([active, torch.zeros(pad, dtype=torch.bool, device=dev)])
    n = n_in + pad
    g = n // packet

    def to_pg(x):  # [N] -> [packet, G]
        return x.reshape(g, packet).T

    o_pg = Vec3(to_pg(origin.x), to_pg(origin.y), to_pg(origin.z))
    d_pg = Vec3(to_pg(direction.x), to_pg(direction.y), to_pg(direction.z))
    inv_pg = _safe_inv(d_pg)
    ray_on = to_pg(active)

    inf = float("inf")
    kid = torch.arange(BRANCH, dtype=torch.int32, device=dev)[:, None]
    kid_bit = torch.bitwise_left_shift(torch.ones_like(kid), kid)
    full_mask = (1 << BRANCH) - 1

    fetch = torch.zeros(g, dtype=torch.int64, device=dev)
    fetch_leaf = torch.zeros(g, dtype=torch.bool, device=dev)
    restore = torch.full((g,), full_mask, dtype=torch.int32, device=dev)
    cur_node = torch.zeros(g, dtype=torch.int64, device=dev)
    pend_dist = torch.full((BRANCH, g), inf, device=dev)
    pend_code = torch.zeros((BRANCH, g), dtype=torch.int32, device=dev)
    sp = torch.zeros(g, dtype=torch.int64, device=dev)
    stack_node = torch.zeros((stack_depth, g), dtype=torch.int64, device=dev)
    stack_mask = torch.zeros((stack_depth, g), dtype=torch.int32, device=dev)
    done = ~ray_on.any(dim=0)
    t_best = to_pg(t_max.to(torch.float32)).clone()
    leaf_best = torch.full((packet, g), -1, dtype=torch.int64, device=dev)
    found = torch.zeros((packet, g), dtype=torch.bool, device=dev)
    node_tests = torch.zeros((), dtype=torch.int64, device=dev)
    tri_tests = torch.zeros((), dtype=torch.int64, device=dev)
    ox, oy, oz = o_pg.x[None], o_pg.y[None], o_pg.z[None]
    ix, iy, iz = inv_pg.x[None], inv_pg.y[None], inv_pg.z[None]
    o3 = Vec3(ox, oy, oz)
    d3 = Vec3(d_pg.x[None], d_pg.y[None], d_pg.z[None])

    while not bool(done.all()):
        act = ~done
        f = torch.where(act, fetch, 0)
        rowT = rows[f].T  # [128, G] — the one row fetch of the step
        codes = rows_i[f][:, 96:112].T
        ray_live = ray_on & ~found & act[None, :]

        # --- node interpretation: slab 16 children x packet rays ---
        t1x = (rowT[0:16, None, :] - ox) * ix
        t2x = (rowT[16:32, None, :] - ox) * ix
        t1y = (rowT[32:48, None, :] - oy) * iy
        t2y = (rowT[48:64, None, :] - oy) * iy
        t1z = (rowT[64:80, None, :] - oz) * iz
        t2z = (rowT[80:96, None, :] - oz) * iz
        enter = torch.maximum(
            torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
            torch.clamp(torch.minimum(t1z, t2z), min=t_min))
        leave = torch.minimum(
            torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
            torch.minimum(torch.maximum(t1z, t2z), t_best[None]))
        ok = (enter <= leave) & ray_live[None]
        in_restore = ((restore[None, :] >> kid) & 1) == 1
        if any_hit:
            dist16 = torch.where(ok.any(dim=1), 0.0, inf)
        else:
            dist16 = torch.where(ok, enter, inf).min(dim=1).values
        valid_child = in_restore & (codes != INVALID_CHILD)
        new_dist = torch.where(valid_child, dist16, inf)

        is_node_step = act & ~fetch_leaf
        if stats is not None:
            node_tests += ((ray_live & is_node_step[None, :]).sum(dim=0)
                           * valid_child.sum(dim=0)).sum()
        pend_dist = torch.where(is_node_step[None, :], new_dist, pend_dist)
        pend_code = torch.where(is_node_step[None, :], codes, pend_code)
        cur_node = torch.where(is_node_step, fetch, cur_node)

        # --- leaf interpretation: [14, packet, G] M-T on the same row ---
        tv0 = Vec3(rowT[0:14, None, :], rowT[14:28, None, :],
                   rowT[28:42, None, :])
        te1 = Vec3(rowT[42:56, None, :], rowT[56:70, None, :],
                   rowT[70:84, None, :])
        te2 = Vec3(rowT[84:98, None, :], rowT[98:112, None, :],
                   rowT[112:126, None, :])
        t, _u, _v, tri_hit = ray_triangle(o3, d3, tv0, te1, te2, t_min=t_min)
        leaf_live = ray_live & (act & fetch_leaf)[None, :]
        if stats is not None:
            tri_tests += leaf_live.sum() * WIDE_LEAF
        t = torch.where(tri_hit & leaf_live[None], t, inf)
        t14 = t.min(dim=0).values
        better = t14 < t_best
        t_best = torch.where(better, t14, t_best)
        leaf_best = torch.where(better, fetch[None, :], leaf_best)
        if any_hit:
            found = found | better
            ray_live = ray_live & ~found
            done = done | ~(ray_on & ~found).any(dim=0)
        else:
            t_pack = torch.where(ray_live, t_best, -inf).max(dim=0).values
            pend_dist = torch.where(pend_dist > t_pack[None, :], inf, pend_dist)

        # --- select the nearest pending child ---
        sel_dist, sel = pend_dist.min(dim=0)
        any_pend = sel_dist < inf
        onehot = kid == sel[None, :]
        sel_code = torch.where(onehot, pend_code, 0).sum(dim=0, dtype=torch.int32)
        go = act & any_pend
        pend_dist = torch.where(onehot & go[None, :], inf, pend_dist)

        is_leaf_next = sel_code < 0
        fetch_n = torch.where(is_leaf_next, m_nodes + ~sel_code, sel_code).to(torch.int64)
        remaining = torch.where(pend_dist < inf, kid_bit, 0).sum(
            dim=0, dtype=torch.int32)
        push = go & ~is_leaf_next & (remaining != 0)

        # --- push (shift down; row 0 is the top) ---
        stack_node = torch.where(
            push[None, :], torch.cat([cur_node[None, :], stack_node[:-1]]),
            stack_node)
        stack_mask = torch.where(
            push[None, :], torch.cat([remaining[None, :], stack_mask[:-1]]),
            stack_mask)
        sp = torch.where(push, sp + 1, sp)

        # --- pop (shift up) ---
        can_pop = act & ~any_pend & (sp > 0)
        top_node = stack_node[0]
        top_mask = stack_mask[0]
        stack_node = torch.where(
            can_pop[None, :], torch.cat([stack_node[1:], stack_node[-1:]]),
            stack_node)
        stack_mask = torch.where(
            can_pop[None, :], torch.cat([stack_mask[1:], stack_mask[-1:]]),
            stack_mask)
        sp = torch.where(can_pop, sp - 1, sp)
        done = done | (act & ~any_pend & ~can_pop)

        fetch = torch.where(go, fetch_n, fetch)
        fetch = torch.where(can_pop, top_node, fetch)
        fetch_leaf = torch.where(act, go & is_leaf_next, fetch_leaf)
        restore = torch.where(can_pop, top_mask,
                              torch.full_like(restore, full_mask))

    if stats is not None:
        stats["node_tests"] = int(node_tests)
        stats["tri_tests"] = int(tri_tests)

    def from_pg(x):  # [packet, G] -> [N_in]
        return x.T.reshape(n)[:n_in]

    if any_hit:
        return from_pg(found)

    # Re-intersect the winning leaf row once: triangle index, u, v, slot.
    leaf_out = from_pg(leaf_best)
    valid = leaf_out >= 0
    t_out = torch.where(valid, from_pg(t_best), MISS_DIST)
    rowT2 = rows[torch.where(valid, leaf_out, m_nodes)].T  # [128, N]
    o1 = Vec3(origin.x[:n_in][None], origin.y[:n_in][None],
              origin.z[:n_in][None])
    d1 = Vec3(direction.x[:n_in][None], direction.y[:n_in][None],
              direction.z[:n_in][None])
    tv0 = Vec3(rowT2[0:14], rowT2[14:28], rowT2[28:42])
    te1 = Vec3(rowT2[42:56], rowT2[56:70], rowT2[70:84])
    te2 = Vec3(rowT2[84:98], rowT2[98:112], rowT2[112:126])
    t2, u2, v2, hit2 = ray_triangle(o1, d1, tv0, te1, te2, t_min=t_min)
    t2 = torch.where(hit2, t2, inf)
    k = torch.argmin(t2, dim=0)
    u_out = u2.gather(0, k[None, :])[0]
    v_out = v2.gather(0, k[None, :])[0]
    slot_out = torch.where(valid, (leaf_out - m_nodes) * WIDE_LEAF + k, -1)
    u_out = torch.where(valid, u_out, 0.0)
    v_out = torch.where(valid, v_out, 0.0)
    return Hit(t=t_out, slot=slot_out.to(torch.int32), u=u_out, v=v_out)


_argtypes_set = False


def traverse_wide(rows: torch.Tensor, num_nodes: int, depth: int,
                  origin: Vec3, direction: Vec3, t_max: torch.Tensor,
                  active: torch.Tensor, any_hit: bool,
                  stats: dict | None = None):
    """Kernel B: closest hit (:class:`Hit`) or any hit (bool [N]) of each
    active ray against the unified wide table; inactive rays miss.

    ``stats``, when given, receives the walk's ``node_tests`` (live ray x
    child slab tests) and ``tri_tests`` (live ray x triangle tests): on a
    CUDA table those of the kernel's 32-ray packets (one packet per 32
    lanes, so with one active lane in 32 those of a per-ray walk), on a CPU
    table those of the plain walk's 16-ray packets."""
    return traverse_wide_plain(rows, num_nodes, depth, origin, direction,
                               t_max, active, any_hit, stats=stats)


# launches by (variant, the table's device and data pointer): the main and
# shadow tables


def _full(n, value, dev):
    return torch.full((n,), float(value), dtype=torch.float32, device=dev)


def trace_closest(bvh: DeviceBVH, origin: Vec3, direction: Vec3,
                  t_max=MISS_DIST, active=None) -> Hit:
    """Closest-hit query; lanes with ``active`` False report a miss."""
    n = origin.x.shape[0]
    dev = origin.x.device
    t_max = (_full(n, t_max, dev) if not isinstance(t_max, torch.Tensor)
             else t_max.expand(n))
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    if bvh.tri_v0.x.shape[0] <= DENSE_MAX_SLOTS:
        hit = _trace_dense(bvh, origin, direction, t_max, any_hit=False)
    else:
        hit = traverse_wide(bvh.rows, bvh.num_nodes, bvh.depth, origin,
                            direction, t_max, active, any_hit=False)
    return Hit(t=torch.where(active, hit.t, MISS_DIST),
               slot=torch.where(active, hit.slot, -1), u=hit.u, v=hit.v)


def trace_occluded(bvh: DeviceBVH, origin: Vec3, direction: Vec3, t_max,
                   active=None) -> torch.Tensor:
    """Occlusion query: True where opaque geometry lies within t_max (cutout
    triangles are left to :func:`trace_transmission`); inactive lanes
    report unoccluded."""
    n = origin.x.shape[0]
    dev = origin.x.device
    t_max = (_full(n, t_max, dev) if not isinstance(t_max, torch.Tensor)
             else t_max.expand(n))
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    if (bvh.dense_tris is not None
            and bvh.dense_tris.shape[0] <= DENSE_MAX_SLOTS):
        hit = _trace_dense(bvh, origin, direction, t_max, any_hit=True)
        return active & (hit.slot >= 0)
    rows = bvh.rows_shadow if bvh.rows_shadow is not None else bvh.rows
    return active & traverse_wide(rows, bvh.num_nodes, bvh.depth, origin,
                                  direction, t_max, active, any_hit=True)


# trace_transmission tests every cutout triangle against a block of lanes at
# once; its [Tc, lanes] temporaries hold at most this many elements (each
# a 4-byte word: 256 MB)
TRANSMISSION_BLOCK = 1 << 26


def trace_transmission(bvh: DeviceBVH, origin: Vec3, direction: Vec3, t_max,
                       active=None) -> torch.Tensor:
    """Transparency through cutout geometry: prod(1 - alpha) over the cutout
    triangles each ray crosses within t_max (1 = clear), with alpha the
    triangle's micro-grid cell alpha where it has a grid. Together with
    :func:`trace_occluded` this is the reference's any-hit transparency.
    A dense pass in plain PyTorch (an XLA pass in the JAX package), over the
    active lanes only, in blocks of at most TRANSMISSION_BLOCK elements."""
    n = origin.x.shape[0]
    dev = origin.x.device
    out = torch.ones(n, dtype=torch.float32, device=dev)
    if bvh.cut_tris is None:
        return out
    t_max = (_full(n, t_max, dev) if not isinstance(t_max, torch.Tensor)
             else t_max.expand(n))
    lanes = (torch.nonzero(active).flatten() if active is not None
             else torch.arange(n, device=dev))
    tris = bvh.cut_tris
    tv = Vec3(tris[:, 0:1], tris[:, 1:2], tris[:, 2:3])
    te1 = Vec3(tris[:, 3:4], tris[:, 4:5], tris[:, 5:6])
    te2 = Vec3(tris[:, 6:7], tris[:, 7:8], tris[:, 8:9])
    words = (tris[:, 12:44].contiguous().view(torch.int32).long()
             if tris.shape[1] >= 44 else None)
    step = max(TRANSMISSION_BLOCK // tris.shape[0], 1)
    for a in range(0, lanes.shape[0], step):
        ix = lanes[a:a + step]
        o2 = Vec3(*(c[ix][None, :] for c in origin))
        d2 = Vec3(*(c[ix][None, :] for c in direction))
        t, u, v, hit = ray_triangle(o2, d2, tv, te1, te2, t_min=1e-4)
        within = hit & (t <= t_max[ix][None, :])
        if words is not None:
            # the local mean alpha of the 8x8 barycentric cell crossed
            s_i = torch.clamp((u * 8.0).to(torch.int32), 0, 7)
            t_i = torch.clamp((v * 8.0).to(torch.int32), 0, 7)
            cell = (t_i * 8 + s_i).long()
            w = words.gather(1, cell >> 1)
            alpha = ((w >> ((cell & 1) * 16)) & 0xFFFF).to(torch.float32) / 65535.0
        else:
            alpha = tris[:, 9:10]
        out[ix] = torch.prod(torch.where(within, 1.0 - alpha, 1.0), dim=0)
    return out
