"""BVH2 → 16-wide BVH collapse (host side, numpy).

The reference's dormant CWBVH (reference: src/luminary/device/bvh.c — 8-wide
compressed nodes, disabled behind ``#if 0``) is the inspiration, but the TPU
layout is its own. The driving measurement (v5e): a row gather costs ~11 ns
PER INDEX with the row width nearly free up to 128 floats — so the traversal
must fetch at most ONE 128-wide row per step. That fixes the format:

  * nodes are 16-wide (16 children × 6 bounds = 96 floats + 16 codes = 112
    ≤ 128 — the widest branching factor a single row can carry). Wider nodes
    mean shallower trees → fewer row fetches per ray; the extra slab lanes
    are VPU work, which is nearly free relative to the gather.
  * node rows and leaf rows share ONE unified table (ops/traverse.py
    concatenates them) so every traversal step is exactly one row gather.

Node row layout (f32 [M, 128]):
  cols   0:16   min_x of children 0..15    cols 48:64   max_y
  cols  16:32   max_x                      cols 64:80   min_z
  cols  32:48   min_y                      cols 80:96   max_z
  cols  96:112  child codes (int32 bitcast to f32)
  cols 112:128  zero padding
Child code: >= 0 interior node id; < 0 leaf (~code = block id);
INVALID_CHILD (0x7FFFFFFF) = absent (its AABB is +inf/+inf so slabs miss).

Leaf row layout (f32 [B, 128]): WIDE_LEAF=14 triangles interleaved by field:
  cols 0:14 v0x, 14:28 v0y, 28:42 v0z, 42:56 e1x, 56:70 e1y, 70:84 e1z,
  84:98 e2x, 98:112 e2y, 112:126 e2z, 126:128 zero padding.
14*9 = 126 <= 128, so a leaf gather is exactly one physical (8,128) tile row —
zero padding waste. Padding slots hold degenerate triangles (e1=e2=0).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .builder import BVH2

INVALID_CHILD = np.int32(0x7FFFFFFF)
WIDE_LEAF = 14  # triangles per leaf row (14*9 floats = 126 <= 128 cols)
BRANCH = 16
NODE_COLS = 128


class WideBVH(NamedTuple):
    """Host-side 16-wide BVH (numpy; shipped to device by fast_device_put)."""

    node_rows: np.ndarray  # f32 [M, 128] — see module docstring
    leaf_rows: np.ndarray  # f32 [B, 128]
    tri_order: np.ndarray  # i32 [B * WIDE_LEAF] original tri id per slot, -1 pad
    depth: int  # max interior depth (static: sizes the traversal stack)
    num_nodes: int
    num_blocks: int


def _collapse_children(bvh: BVH2, node: int):
    """Expand a BVH2 node's two children into up to BRANCH (code, min, max)
    by repeatedly replacing the largest-surface-area interior entry with its
    two children (standard SAH-greedy wide collapse)."""
    entries = []  # (code, lo, hi)
    for side in range(2):
        code = int(bvh.child[node, side])
        if code == int(INVALID_CHILD):
            continue
        entries.append((code, bvh.child_min[node, side], bvh.child_max[node, side]))

    def area(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    while len(entries) < BRANCH:
        best, best_a = -1, -1.0
        for i, (code, lo, hi) in enumerate(entries):
            if code >= 0:  # interior — expandable
                a = area(lo, hi)
                if a > best_a:
                    best, best_a = i, a
        if best < 0:
            break
        code, _, _ = entries.pop(best)
        for side in range(2):
            c = int(bvh.child[code, side])
            if c == int(INVALID_CHILD):
                continue
            entries.append((c, bvh.child_min[code, side], bvh.child_max[code, side]))
    return entries


def collapse_wide(bvh: BVH2) -> WideBVH:
    """Collapse a BVH2 into the 16-wide device format.

    Leaf blocks are re-packed from ``bvh.leaf_size`` to WIDE_LEAF slots:
    BVH2 leaves reachable from one collapsed child entry always form one new
    block (the builder is invoked with max_leaf_tris <= WIDE_LEAF so each BVH2
    leaf fits a wide block; multiple small BVH2 leaves are NOT merged — block
    granularity is one BVH2 leaf).
    """
    src_leaf = bvh.leaf_size
    assert src_leaf <= WIDE_LEAF, (
        f"BVH2 leaf_size {src_leaf} exceeds wide leaf capacity {WIDE_LEAF}"
    )

    # Wide node emission: DFS from BVH2 root.
    node_rows: list[np.ndarray] = []
    blocks: list[np.ndarray] = []  # original tri ids per wide block
    # (wide_node_id, bvh2_node_id) pending interior conversions
    pending = [(0, 0)]
    node_rows.append(np.zeros(NODE_COLS, np.float32))
    depth_of = {0: 1}
    max_depth = 1

    def emit_leaf(code: int) -> int:
        block2 = ~code
        ids = bvh.tri_order[block2 * src_leaf : (block2 + 1) * src_leaf]
        ids = ids[ids >= 0]
        blocks.append(ids.astype(np.int32))
        return ~(len(blocks) - 1)

    while pending:
        wide_id, node2 = pending.pop()
        entries = _collapse_children(bvh, node2)
        row = np.zeros(NODE_COLS, np.float32)
        # Absent children: a degenerate box at +inf. With lo == hi == +inf the
        # slab test misses for EVERY ray-direction sign pattern (a +inf/-inf
        # pair would pass when inv_dir > 0: t1=+inf, t2=-inf straddle the
        # interval). The traversal additionally masks on code != INVALID.
        row[0 : 6 * BRANCH] = np.inf
        codes = np.full(BRANCH, INVALID_CHILD, np.int32)
        for k, (code, lo, hi) in enumerate(entries):
            row[0 * BRANCH + k] = lo[0]
            row[1 * BRANCH + k] = hi[0]
            row[2 * BRANCH + k] = lo[1]
            row[3 * BRANCH + k] = hi[1]
            row[4 * BRANCH + k] = lo[2]
            row[5 * BRANCH + k] = hi[2]
            if code < 0:
                codes[k] = emit_leaf(code)
            else:
                child_wide = len(node_rows)
                node_rows.append(np.zeros(NODE_COLS, np.float32))
                pending.append((child_wide, code))
                codes[k] = child_wide
                depth_of[child_wide] = depth_of[wide_id] + 1
                max_depth = max(max_depth, depth_of[child_wide])
        row[6 * BRANCH : 7 * BRANCH] = codes.view(np.float32)
        node_rows[wide_id] = row

    num_blocks = max(len(blocks), 1)
    tri_order = np.full(num_blocks * WIDE_LEAF, -1, np.int32)
    for b, ids in enumerate(blocks):
        tri_order[b * WIDE_LEAF : b * WIDE_LEAF + len(ids)] = ids

    return WideBVH(
        node_rows=np.stack(node_rows),
        leaf_rows=np.zeros((num_blocks, 128), np.float32),  # filled by pack_leaf_rows
        tri_order=tri_order,
        depth=max_depth,
        num_nodes=len(node_rows),
        num_blocks=num_blocks,
    )


# Backward-compatible alias (the 8-wide format this replaced).
collapse_bvh8 = collapse_wide


def pack_leaf_rows(wide: WideBVH, v0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> WideBVH:
    """Fill leaf_rows from slot-ordered triangle data ([P,3] each, P = B*14)."""
    b = wide.num_blocks
    rows = np.zeros((b, 128), np.float32)
    for j, arr in enumerate((v0, e1, e2)):
        for c in range(3):
            rows[:, j * 42 + c * 14 : j * 42 + (c + 1) * 14] = arr[:, c].reshape(b, WIDE_LEAF)
    return wide._replace(leaf_rows=rows)


def refit_wide(wide: WideBVH, v0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> WideBVH:
    """Refit an existing wide topology to MOVED geometry (instance-transform
    updates): recompute child AABBs bottom-up and repack leaf rows, keeping
    tri_order/codes intact. The role of the reference's IAS update path
    (optix_bvh.c instance cache) — a move costs a refit, not an SAH rebuild.

    v0/e1/e2: [P, 3] slot-ordered triangles (same slot order as the build).
    """
    rows = wide.node_rows.copy()
    m = wide.num_nodes
    corners = np.stack([v0, v0 + e1, v0 + e2], axis=1)  # [P, 3, 3]
    # Padding slots are degenerate at v0=0: make them inert for the
    # reduction by collapsing them to their block's first valid corner.
    valid = (np.abs(e1).sum(-1) > 0) | (np.abs(e2).sum(-1) > 0)
    blk = corners.reshape(wide.num_blocks, WIDE_LEAF, 3, 3)
    bval = valid.reshape(wide.num_blocks, WIDE_LEAF)
    big = np.float32(np.inf)
    blk_min = np.where(bval[..., None, None], blk, big).min(axis=(1, 2))
    blk_max = np.where(bval[..., None, None], blk, -big).max(axis=(1, 2))
    empty = ~bval.any(axis=1)
    blk_min[empty] = 0.0
    blk_max[empty] = 0.0

    node_min = np.zeros((m, 3), np.float32)
    node_max = np.zeros((m, 3), np.float32)
    codes_all = rows[:, 6 * BRANCH : 7 * BRANCH].view(np.int32)

    # Level order (parent ids < child ids, but group by depth so each level
    # refits fully vectorized — the python cost is O(depth), not O(nodes)).
    level_of = np.zeros(m, np.int32)
    frontier = np.asarray([0], np.int64)
    levels = [frontier]
    while True:
        cs = codes_all[frontier].reshape(-1)
        nxt = cs[(cs >= 0) & (cs != INVALID_CHILD)].astype(np.int64)
        if nxt.size == 0:
            break
        level_of[nxt] = len(levels)
        levels.append(nxt)
        frontier = nxt

    for ids in reversed(levels):
        codes = codes_all[ids]                       # [K, 16]
        is_leaf = codes < 0
        is_node = (codes >= 0) & (codes != INVALID_CHILD)
        leaf_idx = np.where(is_leaf, ~codes, 0)
        node_idx = np.where(is_node, codes, 0)
        lo = np.where(
            is_leaf[..., None], blk_min[leaf_idx],
            np.where(is_node[..., None], node_min[node_idx], big),
        ).astype(np.float32)                         # [K, 16, 3]
        hi = np.where(
            is_leaf[..., None], blk_max[leaf_idx],
            np.where(is_node[..., None], node_max[node_idx], big),
        ).astype(np.float32)
        for ax in range(3):
            rows[ids, (2 * ax) * BRANCH : (2 * ax + 1) * BRANCH] = lo[..., ax]
            rows[ids, (2 * ax + 1) * BRANCH : (2 * ax + 2) * BRANCH] = hi[..., ax]
        present = (is_leaf | is_node)[..., None]
        node_min[ids] = np.where(present, lo, big).min(axis=1)
        node_max[ids] = np.where(present, hi, -big).max(axis=1)

    out = wide._replace(node_rows=rows)
    return pack_leaf_rows(out, v0, e1, e2)
