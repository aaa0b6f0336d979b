"""Kernel B's plain version (``traverse_wide_plain``) and the dense tier
against ``luminary_tpu/ops/traverse.py``, on the 600-triangle fixture of
``tests/test_traverse_pallas.py`` built by the port's own BVH copy.

Tolerances: slots equal except on lanes whose two nearest candidate hits lie
within 1e-6 relative (exact-t ties may resolve to either triangle); t within
rtol 1e-5 and u, v within atol 1e-5 (the same Möller-Trumbore arithmetic,
but XLA may contract multiply-adds); any-hit flags exactly equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from luminary_tpu.bvh.builder import build_bvh as j_build_bvh
from luminary_tpu.bvh.wide import collapse_bvh8 as j_collapse
from luminary_tpu.ops.traverse import _trace_dense as j_trace_dense
from luminary_tpu.ops.traverse import _traverse_wide as j_traverse_wide
from luminary_tpu.ops.traverse import pack_device_bvh as j_pack_device_bvh
from luminary_tpu.ops.vec import Vec3 as JVec3
from luminary_tpu_torch.bvh.builder import build_bvh
from luminary_tpu_torch.bvh.wide import WIDE_LEAF, collapse_wide
from luminary_tpu_torch.ops import traverse as T
from luminary_tpu_torch.ops.intersect import ray_triangle
from luminary_tpu_torch.ops.vec import Vec3

torch.set_num_threads(1)


def _slot_tris(corners, wide):
    order = wide.tri_order
    valid = order >= 0
    c = corners[np.where(valid, order, 0)]
    v0 = c[:, 0].copy()
    e1 = c[:, 1] - c[:, 0]
    e2 = c[:, 2] - c[:, 0]
    v0[~valid] = 0
    e1[~valid] = 0
    e2[~valid] = 0
    return v0, e1, e2


def _rays(rng, n, spread=20.0):
    origins = (rng.random((n, 3)).astype(np.float32) - 0.5) * spread
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return origins, dirs


@pytest.fixture(scope="module")
def scene600():
    rng = np.random.default_rng(7)
    num_tris = 600
    base = (rng.random((num_tris, 1, 3)) - 0.5) * 10.0
    offs = (rng.random((num_tris, 3, 3)) - 0.5) * 0.6
    corners = (base + offs).astype(np.float32)
    wide = collapse_wide(build_bvh(corners, leaf_size=WIDE_LEAF))
    tris = _slot_tris(corners, wide)
    bvh = T.pack_device_bvh(wide, *tris, device="cpu")
    j_wide = j_collapse(j_build_bvh(corners, leaf_size=WIDE_LEAF))
    j_bvh = jax.device_put(j_pack_device_bvh(j_wide, *_slot_tris(corners, j_wide)))
    n = 2048
    origins, dirs = _rays(rng, n)
    act = rng.random(n) > 0.1
    return dict(corners=corners, bvh=bvh, j_bvh=j_bvh, origins=origins,
                dirs=dirs, act=act, tris=tris)


def _tv(a):
    return Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _jv(a):
    return JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _mt64(tris, origins, dirs):
    """Möller-Trumbore of every ray against every slot in float64:
    (t, u, v, not parallel), each [rays, slots]."""
    v0, e1, e2 = (t.astype(np.float64) for t in tris)
    o = origins.astype(np.float64)[:, None]
    d = dirs.astype(np.float64)[:, None]
    p = np.cross(d, e2[None])
    det = (e1[None] * p).sum(-1)
    ok = np.abs(det) > 1e-12
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    tv = o - v0[None]
    u = (tv * p).sum(-1) * inv
    q = np.cross(tv, e1[None])
    v = (d * q).sum(-1) * inv
    t = (e2[None] * q).sum(-1) * inv
    return t, u, v, ok


def _tie_lanes(tris, origins, dirs, rel=1e-6):
    """Lanes whose nearest two triangle hits lie within `rel` of each other
    (brute force in float64)."""
    t, u, v, ok = _mt64(tris, origins, dirs)
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-4)
    t = np.sort(np.where(hit, t, np.inf), axis=1)
    with np.errstate(invalid="ignore"):
        gap = np.where(np.isfinite(t[:, 1]), t[:, 1] - t[:, 0], np.inf)
    return gap <= rel * np.abs(t[:, 0])


def _edge_lanes(tris, origins, dirs, eps=1e-5):
    """Lanes that meet some triangle's plane in front of the origin within
    `eps` (barycentric, float64) of the triangle's border: there the float32
    Möller-Trumbore verdict is the rounding's, and XLA's fused multiply-adds
    round otherwise than PyTorch's separate products and sums."""
    t, u, v, ok = _mt64(tris, origins, dirs)
    border = np.minimum(np.minimum(u, v), 1.0 - u - v)
    return (ok & (np.abs(border) <= eps) & (t > 1e-4)).any(axis=1)


def test_bvh_rows_bit_identical(scene600):
    """The port's builder copy + pack give the reference's table, word for
    word (node codes included)."""
    assert np.array_equal(np.asarray(scene600["j_bvh"].rows).view(np.int32),
                          scene600["bvh"].rows.numpy().view(np.int32))
    assert scene600["bvh"].depth == scene600["j_bvh"].depth
    assert scene600["bvh"].num_nodes == scene600["j_bvh"].num_nodes


def test_closest_hit_matches_reference(scene600):
    s = scene600
    n = s["origins"].shape[0]
    ref = j_traverse_wide(s["j_bvh"], _jv(s["origins"]), _jv(s["dirs"]),
                          jnp.full((n,), 3e38, jnp.float32), any_hit=False,
                          active=jnp.asarray(s["act"]))
    stats = {}
    got = T.traverse_wide_plain(
        s["bvh"].rows, s["bvh"].num_nodes, s["bvh"].depth, _tv(s["origins"]),
        _tv(s["dirs"]), torch.full((n,), 3e38), torch.as_tensor(s["act"]),
        any_hit=False, stats=stats)
    ties = _tie_lanes(s["tris"], s["origins"], s["dirs"])
    slot_ref, slot = np.asarray(ref.slot), got.slot.numpy()
    assert ((slot_ref == slot) | ties).all()
    assert (slot >= 0).sum() > 20  # the fixture really hits
    keep = ~ties & (slot >= 0)
    np.testing.assert_allclose(got.t.numpy()[keep], np.asarray(ref.t)[keep],
                               rtol=1e-5)
    np.testing.assert_allclose(got.u.numpy()[keep], np.asarray(ref.u)[keep], atol=1e-5)
    np.testing.assert_allclose(got.v.numpy()[keep], np.asarray(ref.v)[keep], atol=1e-5)
    assert stats["node_tests"] > 0 and stats["tri_tests"] > 0


@pytest.mark.parametrize("t_max", [5.0, 3e38])
def test_any_hit_matches_reference(scene600, t_max):
    s = scene600
    n = s["origins"].shape[0]
    ref = j_traverse_wide(s["j_bvh"], _jv(s["origins"]), _jv(s["dirs"]),
                          jnp.full((n,), t_max, jnp.float32), any_hit=True,
                          active=jnp.asarray(s["act"]))
    got = T.traverse_wide_plain(
        s["bvh"].rows, s["bvh"].num_nodes, s["bvh"].depth, _tv(s["origins"]),
        _tv(s["dirs"]), torch.full((n,), t_max), torch.as_tensor(s["act"]),
        any_hit=True)
    assert np.array_equal(np.asarray(ref.slot) >= 0, got.numpy())


def test_trace_wrappers_mask_inactive_lanes(scene600):
    s = scene600
    act = torch.as_tensor(s["act"])
    hit = T.trace_closest(s["bvh"], _tv(s["origins"]), _tv(s["dirs"]), active=act)
    assert (hit.slot.numpy()[~s["act"]] == -1).all()
    occ = T.trace_occluded(s["bvh"], _tv(s["origins"]), _tv(s["dirs"]),
                           torch.full((act.shape[0],), 5.0), active=act)
    assert not occ.numpy()[~s["act"]].any()


@pytest.mark.parametrize("any_hit", [False, True])
def test_dense_tier_matches_reference(any_hit):
    rng = np.random.default_rng(3)
    num_tris = 90
    base = (rng.random((num_tris, 1, 3)) - 0.5) * 6.0
    corners = (base + (rng.random((num_tris, 3, 3)) - 0.5)).astype(np.float32)
    wide = collapse_wide(build_bvh(corners, leaf_size=WIDE_LEAF))
    tris = _slot_tris(corners, wide)
    bvh = T.pack_device_bvh(wide, *tris, device="cpu")
    j_wide = j_collapse(j_build_bvh(corners, leaf_size=WIDE_LEAF))
    j_bvh = jax.device_put(j_pack_device_bvh(j_wide, *_slot_tris(corners, j_wide)))
    n = 1024
    origins, dirs = _rays(rng, n, spread=12.0)
    t_max = np.where(rng.random(n) > 0.5, 3e38, 2.0).astype(np.float32)
    ref = j_trace_dense(j_bvh, _jv(origins), _jv(dirs), jnp.asarray(t_max),
                        any_hit=any_hit)
    got = T._trace_dense(bvh, _tv(origins), _tv(dirs), torch.as_tensor(t_max),
                         any_hit=any_hit)
    assert np.array_equal(np.asarray(ref.slot), got.slot.numpy())
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-5)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(ref.u), atol=1e-5)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(ref.v), atol=1e-5)


def _grazing_rays(s, per_pair=4):
    """Rays that touch a node-row box only along one of its edges: each
    enters one slab and leaves another at the same point of the edge, so the
    exact ray meets the box in that one point. Half of them pass through a
    triangle vertex lying on both faces of the edge, where the Möller-Trumbore
    test may or may not report the triangle; the other half pass through the
    edge a little way from the vertex and miss it. Padded with inactive lanes
    to the fixture's 2048 rays."""
    rows = s["bvh"].rows.numpy()
    m = s["bvh"].num_nodes
    lo = np.stack([rows[:m, 0:16], rows[:m, 32:48], rows[:m, 64:80]], -1)
    hi = np.stack([rows[:m, 16:32], rows[:m, 48:64], rows[:m, 80:96]], -1)
    codes = rows[:m, 96:112].view(np.int32)
    v0, e1, e2 = s["tris"]
    used = (np.abs(e1).sum(-1) > 0) | (np.abs(e2).sum(-1) > 0)
    verts = np.concatenate([v0[used], (v0 + e1)[used], (v0 + e2)[used]])
    rng = np.random.default_rng(11)
    origins, dirs = [], []
    for node, k in zip(*np.nonzero(codes != T.INVALID_CHILD)):
        box_lo, box_hi = lo[node, k], hi[node, k]
        for vert in verts[(verts == box_lo).sum(-1) + (verts == box_hi).sum(-1) >= 2]:
            faces = ([(a, -1.0) for a in range(3) if vert[a] == box_lo[a]]
                     + [(a, 1.0) for a in range(3) if vert[a] == box_hi[a]])
            for (a_in, s_in), (a_out, s_out) in (
                    (f, g) for f in faces for g in faces if f[0] != g[0]):
                # the point of the edge a tenth of the way to the box centre
                # along the third axis
                a3 = 3 - a_in - a_out
                off = vert.copy()
                off[a3] += np.float32(0.1) * (0.5 * (box_lo[a3] + box_hi[a3]) - vert[a3])
                for point in (vert, off):
                    for _ in range(per_pair):
                        d = rng.standard_normal(3)
                        d[a_in] = -s_in * abs(d[a_in])  # inward through a_in
                        d[a_out] = s_out * abs(d[a_out])  # outward through a_out
                        d = (d / np.linalg.norm(d)).astype(np.float32)
                        dirs.append(d)
                        origins.append((point - rng.uniform(0.5, 4.0) * d)
                                       .astype(np.float32))
    k = len(origins)
    n = s["origins"].shape[0]
    assert 200 <= k <= n
    o = np.zeros((n, 3), np.float32)
    d = np.tile(np.float32([0.0, 0.0, 1.0]), (n, 1))
    o[:k], d[:k] = origins, dirs
    act = np.arange(n) < k
    return o, d, act


def _path_admits(bvh, origin, direction, t_max, slot):
    """Per (ray, slot) pair: does kernel B's box test (``slab_admits``)
    admit every box from the root down to the slot's leaf?"""
    m = bvh.num_nodes
    rows = bvh.rows
    codes = rows.view(torch.int32)[:m, 96:112].long()
    parent = torch.full((rows.shape[0],), -1, dtype=torch.long)
    child_k = torch.full((rows.shape[0],), -1, dtype=torch.long)
    real = codes != T.INVALID_CHILD
    target = torch.where(codes >= 0, codes, m + ~codes)[real]
    parent[target] = torch.arange(m)[:, None].expand(m, T.BRANCH)[real]
    child_k[target] = torch.arange(T.BRANCH)[None, :].expand(m, T.BRANCH)[real]
    inv = T._safe_inv(direction)
    at = m + slot.long() // WIDE_LEAF
    ok = torch.ones(slot.shape[0], dtype=torch.bool)
    while bool((parent[at] >= 0).any()):
        live = parent[at] >= 0
        node, kk = parent[at].clamp(min=0), child_k[at].clamp(min=0)[:, None]

        def col(c0):
            return rows[node].gather(1, kk + c0)[:, 0]

        box = T.slab_admits(Vec3(col(0), col(32), col(64)),
                            Vec3(col(16), col(48), col(80)),
                            origin, inv, t_max)
        ok &= ~live | box
        at = torch.where(live, node, at)
    return ok


def test_grazing_rays_box_test_admits_every_hit(scene600, monkeypatch):
    """Rays grazing box edges: the plain packet walk agrees with the JAX walk
    there (closest slots up to exact-t ties, any-hit flags exactly) on every
    lane whose verdict no triangle border decides (``_edge_lanes``), and
    kernel B's conservative box test admits every box on the path to every
    triangle such a ray hits (brute force over all slots), where the test
    without the far-distance margin rejects some."""
    s = scene600
    bvh = s["bvh"]
    o, d, act = _grazing_rays(s)
    n = o.shape[0]
    t_max = np.full(n, 3e38, np.float32)
    args = (bvh.rows, bvh.num_nodes, bvh.depth, _tv(o), _tv(d),
            torch.as_tensor(t_max), torch.as_tensor(act))
    clear = act & ~_edge_lanes(s["tris"], o, d)
    assert clear.sum() >= act.sum() // 3
    ref = j_traverse_wide(s["j_bvh"], _jv(o), _jv(d), jnp.asarray(t_max),
                          any_hit=False, active=jnp.asarray(act))
    got = T.traverse_wide_plain(*args, any_hit=False)
    ties = _tie_lanes(s["tris"], o, d)
    same = np.asarray(ref.slot) == got.slot.numpy()
    assert (same | ties)[clear].all()
    ref_occ = j_traverse_wide(s["j_bvh"], _jv(o), _jv(d), jnp.asarray(t_max),
                              any_hit=True, active=jnp.asarray(act))
    got_occ = T.traverse_wide_plain(*args, any_hit=True)
    assert np.array_equal((np.asarray(ref_occ.slot) >= 0)[clear],
                          got_occ.numpy()[clear])

    v0, e1, e2 = (Vec3(*(torch.as_tensor(np.ascontiguousarray(a[None, :, i]))
                         for i in range(3))) for a in s["tris"])
    o_t, d_t = _tv(o), _tv(d)
    _t, _u, _v, hit = ray_triangle(Vec3(*(c[:, None] for c in o_t)),
                                   Vec3(*(c[:, None] for c in d_t)), v0, e1, e2)
    lane, slot = torch.nonzero(hit & torch.as_tensor(act)[:, None], as_tuple=True)
    assert lane.numel() > 20
    o_h, d_h = Vec3(*(c[lane] for c in o_t)), Vec3(*(c[lane] for c in d_t))
    t_h = torch.as_tensor(t_max)[lane]
    assert bool(_path_admits(bvh, o_h, d_h, t_h, slot).all())
    monkeypatch.setattr(T, "ROBUST_FAR", 1.0)
    assert not bool(_path_admits(bvh, o_h, d_h, t_h, slot).all())
