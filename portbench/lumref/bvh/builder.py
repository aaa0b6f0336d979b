"""SAH BVH construction.

The reference ships a dormant SBVH builder with spatial splits + 8-wide
compressed nodes (reference: src/luminary/device/bvh.c — disabled behind
``#if 0``; OptiX took over). For TPU that design becomes live again: a host-side
binned-SAH builder producing a flat 2-wide BVH whose leaves are fixed-capacity
triangle blocks, which :mod:`luminary_tpu_torch.bvh.wide` re-packs into the
TPU-friendly wide-node SoA consumed by the traversal kernels.

Builder properties chosen for the TPU traversal (not copied from the
reference):
  * every leaf holds exactly ``leaf_size`` triangle slots (padded with
    degenerate triangles) so device-side leaf loads are uniform gathers;
  * triangles are reordered into leaf order (contiguous leaf ranges);
  * children are stored near-first so the device can push far-then-near.

The scene pack builds its 16-wide tree with the native builder in bvh/cpp;
this numpy BVH2 builds the light tree and the tests' small fixtures.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_NUM_BINS = 16
_TRAVERSAL_COST = 1.0
_INTERSECT_COST = 1.0


@dataclass
class BVH2:
    """Flat 2-wide BVH.

    child_min/max: float32 [M, 2, 3] — AABBs of each node's two children.
    child:        int32   [M, 2] — >= 0: interior node index;
                                    < 0: leaf, block id = ~child;
                                    INVALID (0x7FFFFFFF) for absent child.
    tri_order:    int32 [num_blocks * leaf_size] — original triangle index per
                  leaf slot, -1 for padding slots.
    leaf_size:    slots per leaf block.
    root_min/max: float32 [3] — scene bounds.
    """

    child_min: np.ndarray
    child_max: np.ndarray
    child: np.ndarray
    tri_order: np.ndarray
    leaf_size: int
    root_min: np.ndarray
    root_max: np.ndarray

    INVALID = np.int32(0x7FFFFFFF)

    @property
    def num_nodes(self) -> int:
        return int(self.child.shape[0])

    @property
    def num_blocks(self) -> int:
        return int(self.tri_order.shape[0]) // self.leaf_size


def _surface_area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


def build_bvh(
    corners: np.ndarray,
    leaf_size: int = 4,
    max_leaf_tris: int | None = None,
) -> BVH2:
    """Build a binned-SAH BVH over triangles.

    Args:
      corners: float32 [T, 3, 3] triangle corner positions.
      leaf_size: fixed triangle-slot count per leaf block.
    """
    corners = np.asarray(corners, dtype=np.float32)
    num_tris = corners.shape[0]
    if max_leaf_tris is None:
        max_leaf_tris = leaf_size

    if num_tris == 0:
        z = np.zeros((1, 2, 3), np.float32)
        return BVH2(
            child_min=z.copy(),
            child_max=z.copy(),
            child=np.full((1, 2), BVH2.INVALID, np.int32),
            tri_order=np.full((leaf_size,), -1, np.int32),
            leaf_size=leaf_size,
            root_min=np.zeros(3, np.float32),
            root_max=np.zeros(3, np.float32),
        )

    aabb_min = corners.min(axis=1)
    aabb_max = corners.max(axis=1)
    centroid = 0.5 * (aabb_min + aabb_max)

    # Node storage (grown on demand).
    cap = max(2 * num_tris // max(leaf_size // 2, 1) + 8, 16)
    child_min = np.zeros((cap, 2, 3), np.float32)
    child_max = np.zeros((cap, 2, 3), np.float32)
    child = np.full((cap, 2), BVH2.INVALID, np.int32)
    num_nodes = 1  # root reserved

    leaf_blocks: list[np.ndarray] = []  # each: int32 [<=leaf_size] original tri ids

    def make_leaf(idx: np.ndarray) -> np.int32:
        """Create leaf blocks for `idx`; returns encoded child value(s).

        When idx exceeds leaf_size we split it into multiple blocks chained as
        a tiny interior subtree — callers only see the returned child code.
        """
        if len(idx) <= leaf_size:
            block_id = len(leaf_blocks)
            leaf_blocks.append(idx.astype(np.int32))
            return np.int32(~block_id)
        # Shouldn't happen with the split fallbacks below, but stay safe:
        mid = len(idx) // 2
        node = alloc_node()
        for side, part in enumerate((idx[:mid], idx[mid:])):
            child[node, side] = make_leaf(part)
            child_min[node, side] = aabb_min[part].min(axis=0)
            child_max[node, side] = aabb_max[part].max(axis=0)
        return np.int32(node)

    def alloc_node() -> int:
        nonlocal num_nodes, child_min, child_max, child, cap
        if num_nodes == cap:
            cap *= 2
            child_min = np.concatenate([child_min, np.zeros_like(child_min)])
            child_max = np.concatenate([child_max, np.zeros_like(child_max)])
            child = np.concatenate([child, np.full_like(child, BVH2.INVALID)])
        n = num_nodes
        num_nodes += 1
        return n

    def best_split(idx: np.ndarray):
        """Binned SAH split. Returns (mask_left, cost) or None."""
        c = centroid[idx]
        c_lo, c_hi = c.min(axis=0), c.max(axis=0)
        extent = c_hi - c_lo
        axis = int(np.argmax(extent))
        if extent[axis] <= 1e-12:
            return None
        # Bin triangle centroids along the chosen axis.
        scale = _NUM_BINS * (1.0 - 1e-6) / extent[axis]
        bins = np.minimum(
            ((c[:, axis] - c_lo[axis]) * scale).astype(np.int32), _NUM_BINS - 1
        )
        # Per-bin counts and bounds (vectorized with ufunc.at).
        counts = np.bincount(bins, minlength=_NUM_BINS)
        b_lo = np.full((_NUM_BINS, 3), np.inf, np.float32)
        b_hi = np.full((_NUM_BINS, 3), -np.inf, np.float32)
        np.minimum.at(b_lo, bins, aabb_min[idx])
        np.maximum.at(b_hi, bins, aabb_max[idx])
        # Sweep: left/right cumulative bounds.
        lcnt = np.cumsum(counts)[:-1]
        rcnt = counts.sum() - lcnt
        l_lo = np.minimum.accumulate(b_lo, axis=0)[:-1]
        l_hi = np.maximum.accumulate(b_hi, axis=0)[:-1]
        r_lo = np.minimum.accumulate(b_lo[::-1], axis=0)[::-1][1:]
        r_hi = np.maximum.accumulate(b_hi[::-1], axis=0)[::-1][1:]
        sa_l = _surface_area(l_lo, l_hi)
        sa_r = _surface_area(r_lo, r_hi)
        valid = (lcnt > 0) & (rcnt > 0)
        if not valid.any():
            return None
        cost = np.where(valid, sa_l * lcnt + sa_r * rcnt, np.inf)
        k = int(np.argmin(cost))
        mask_left = bins <= k
        return mask_left, float(cost[k])

    # Iterative top-down build.
    # Work item: (parent_node, side, idx). Root children get parent -1.
    root_lo = aabb_min.min(axis=0)
    root_hi = aabb_max.max(axis=0)

    def build_node(idx: np.ndarray) -> np.int32:
        """Returns child code for the subtree over idx (interior id or leaf)."""
        tree: list[tuple | None] = []  # ("leaf", idx) | ("interior", li, ri)
        next_id = [0]

        def expand(idx_arr) -> int:
            my = next_id[0]
            next_id[0] += 1
            n = len(idx_arr)
            if n <= max_leaf_tris:
                tree.append(("leaf", idx_arr))
                return my
            split = best_split(idx_arr)
            if split is None:
                # Degenerate centroids: median split on largest extent.
                c = centroid[idx_arr]
                axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
                ordering = np.argsort(c[:, axis], kind="stable")
                half = n // 2
                lidx, ridx = idx_arr[ordering[:half]], idx_arr[ordering[half:]]
            else:
                mask_left, _cost = split
                lidx, ridx = idx_arr[mask_left], idx_arr[~mask_left]
            slot = len(tree)
            tree.append(None)  # placeholder
            li = expand(lidx)
            ri = expand(ridx)
            tree[slot] = ("interior", li, ri)
            return my

        # Python recursion depth can exceed for degenerate scenes; raise limit
        # locally instead of converting to a manual stack (clearer, and depth
        # is O(log T) for SAH splits with median fallback).
        import sys

        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 10000))
        try:
            expand(idx)
        finally:
            sys.setrecursionlimit(old)

        # Second pass: emit nodes bottom-up.
        codes: dict[int, np.int32] = {}
        bounds: dict[int, tuple] = {}
        for my in reversed(range(len(tree))):
            kind = tree[my][0]
            if kind == "leaf":
                idx_arr = tree[my][1]
                codes[my] = make_leaf(idx_arr)
                bounds[my] = (aabb_min[idx_arr].min(axis=0), aabb_max[idx_arr].max(axis=0))
            else:
                _, li, ri = tree[my]
                node = alloc_node()
                child[node, 0] = codes[li]
                child[node, 1] = codes[ri]
                child_min[node, 0], child_max[node, 0] = bounds[li]
                child_min[node, 1], child_max[node, 1] = bounds[ri]
                codes[my] = np.int32(node)
                lo = np.minimum(bounds[li][0], bounds[ri][0])
                hi = np.maximum(bounds[li][1], bounds[ri][1])
                bounds[my] = (lo, hi)
        return codes[0]

    all_idx = np.arange(num_tris, dtype=np.int64)
    root_code = build_node(all_idx)

    # Ensure node 0 is the root interior node. If the whole scene is one leaf,
    # synthesize a root whose left child is that leaf.
    if root_code < 0:
        child[0, 0] = root_code
        child[0, 1] = BVH2.INVALID
        child_min[0, 0], child_max[0, 0] = root_lo, root_hi
        child_min[0, 1], child_max[0, 1] = root_lo, root_lo  # empty
    else:
        rc = int(root_code)
        if rc != 0:
            child[0] = child[rc]
            child_min[0] = child_min[rc]
            child_max[0] = child_max[rc]
            # Kill the now-duplicate node so link derivation (parent/sibling
            # threading) sees exactly one parent per child.
            child[rc] = BVH2.INVALID

    # Pack leaf blocks into the padded triangle order array.
    num_blocks = max(len(leaf_blocks), 1)
    tri_order = np.full((num_blocks * leaf_size,), -1, np.int32)
    for b, ids in enumerate(leaf_blocks):
        tri_order[b * leaf_size : b * leaf_size + len(ids)] = ids

    return BVH2(
        child_min=child_min[:num_nodes].copy(),
        child_max=child_max[:num_nodes].copy(),
        child=child[:num_nodes].copy(),
        tri_order=tri_order,
        leaf_size=leaf_size,
        root_min=root_lo.astype(np.float32),
        root_max=root_hi.astype(np.float32),
    )
