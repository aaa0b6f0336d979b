"""Cutouts against the JAX package, and the slice as a whole.

* The cutout tables: the 8x8 micro-alpha grid (``_cutout_micro_alpha``) and
  the per-slot alpha bit for bit; ``rows_shadow`` (the leaf rows without the
  cutout triangles), ``cut_tris`` and the dense tier's alpha column word for
  word.
* ``trace_occluded`` on the shadow table and ``trace_transmission`` on the
  card scene of tests/test_cutout.py with ``big=True`` (a far triangle field
  forces the tree tier): occlusion flags exactly equal, transmission within
  1e-6.
* One whole-slice render: the 16x16 content scene of
  ``luminary_tpu_torch.testing.content_scene`` over a 3x3 sphere field
  (packed shade and aux rows, a light tree, 69-column light rows with micro
  weights, cutout cards with a micro-alpha grid, fog with 2-vertex
  bridges, albedo/roughness/metallic/normal/luminance maps), depth 3, 4
  samples a pixel in one wavefront: port radiance within 1e-4 of the scale
  of the JAX integrator's on every lane, the same rays traced. The scene's
  stars are off: a star is a Gaussian of ~3e-4 rad evaluated from
  1 - cos(angle) in float32, where XLA's and PyTorch's transcendentals
  differ by percents on a lane (tests/test_torch_slice.py compares those
  lanes apart).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from luminary_tpu.ops import traverse as JTR
from luminary_tpu.ops.vec import Vec3 as JVec3
from luminary_tpu.render import device_scene as JD
from luminary_tpu_torch.ops import traverse as TR
from luminary_tpu_torch.ops.vec import Vec3
from luminary_tpu_torch.render import device_scene as D
from luminary_tpu_torch.render.renderer import Renderer
from luminary_tpu_torch.render.wavefront import render_sample
from luminary_tpu_torch.testing import content_scene
from test_cutout import _card_scene
from test_torch_textures import (
    convert_scene,
    jax_config,
    jax_device_scene,
    jax_render,
)

torch.set_num_threads(1)


def _port_geo(scene):
    return D.upload_geometry(D.pack_geometry_np(scene), "cpu")


@pytest.mark.parametrize("case", ["content", "card", "card_big"])
def test_cutout_tables_match_reference(case):
    if case == "content":
        ts = content_scene(16, 16, 3, nx=3, nz=3, n_cards=12)
        js = convert_scene(ts, "luminary_tpu")
    else:
        js = _card_scene(0.5, big=case == "card_big")
        ts = convert_scene(js, "luminary_tpu_torch")
    hg = D.pack_geometry_np(ts)
    jg = JD.pack_geometry(js)
    assert hg.slot_alpha is not None and (hg.slot_alpha < 1.0).any()
    tb, jb = D.upload_geometry(hg, "cpu").bvh, jg.bvh
    for name in ("rows", "rows_shadow", "cut_tris", "dense_tris"):
        a, b = getattr(tb, name), getattr(jb, name)
        if b is None:
            assert a is None, name
            continue
        assert np.array_equal(a.numpy().view(np.int32),
                              np.asarray(b).view(np.int32)), name
    if case == "content":
        assert tb.cut_tris.shape[1] == 44  # with the micro-alpha grid
        cut = hg.slot_alpha < 1.0
        grid = hg.cut_grid[cut]
        assert (grid.min(axis=1) < grid.max(axis=1)).any()  # partial cells


@pytest.fixture(scope="module")
def card_big():
    js = _card_scene(0.5, big=True)
    ts = convert_scene(js, "luminary_tpu_torch")
    jb = jax.device_put(JD.pack_geometry(js).bvh)
    tb = _port_geo(ts).bvh
    assert tb.tri_v0.x.shape[0] > 128 and tb.rows_shadow is not None
    rng = np.random.default_rng(9)
    n = 2048
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = rng.uniform(-4.0, 4.0, n)
    o[:, 1] = rng.uniform(0.01, 3.0, n)
    o[:, 2] = rng.uniform(-4.0, 4.0, n)
    tgt = np.zeros((n, 3), np.float32)
    tgt[:, 0] = rng.uniform(-2.0, 2.0, n)  # through or past the card
    tgt[:, 1] = 2.0
    tgt[:, 2] = rng.uniform(-2.0, 2.0, n)
    far = rng.random(n) < 0.25  # toward the opaque far field
    tgt[far] = rng.uniform(500.0, 520.0, (int(far.sum()), 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(rng.random(n) < 0.5, 1e7, rng.uniform(0.5, 800.0, n)).astype(
        np.float32)
    act = rng.random(n) < 0.9
    return dict(jb=jb, tb=tb, o=o, d=d.astype(np.float32), t=t_max, act=act)


def _args(c):
    jo = JVec3(*(jnp.asarray(np.ascontiguousarray(c["o"][:, i])) for i in range(3)))
    jd = JVec3(*(jnp.asarray(np.ascontiguousarray(c["d"][:, i])) for i in range(3)))
    to = Vec3(*(torch.as_tensor(np.ascontiguousarray(c["o"][:, i])) for i in range(3)))
    td = Vec3(*(torch.as_tensor(np.ascontiguousarray(c["d"][:, i])) for i in range(3)))
    return (jo, jd, jnp.asarray(c["t"]), jnp.asarray(c["act"])), (
        to, td, torch.as_tensor(c["t"]), torch.as_tensor(c["act"]))


def test_occluded_on_shadow_table_matches_reference(card_big):
    (jo, jd, jt, ja), (to, td, tt, ta) = _args(card_big)
    ref = np.asarray(JTR.trace_occluded(card_big["jb"], jo, jd, jt, active=ja))
    got = TR.trace_occluded(card_big["tb"], to, td, tt, active=ta).numpy()
    assert np.array_equal(got, ref)
    assert 0 < ref.sum() < ref.size  # the far field occludes, the card not
    # the main table's walk sees the card: lanes the shadow table lets pass
    main = TR.traverse_wide(card_big["tb"].rows, card_big["tb"].num_nodes,
                            card_big["tb"].depth, to, td, tt, ta, True).numpy()
    assert (main & ~got).sum() > 0


def test_transmission_matches_reference(card_big):
    (jo, jd, jt, ja), (to, td, tt, ta) = _args(card_big)
    ref = np.asarray(JTR.trace_transmission(card_big["jb"], jo, jd, jt, active=ja))
    got = TR.trace_transmission(card_big["tb"], to, td, tt, active=ta).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert ((ref > 0.4) & (ref < 0.6)).sum() > 0  # lanes through the card


def test_whole_slice_matches_reference():
    w = h = 16
    spp = 4
    scene = content_scene(w, h, 3, nx=3, nz=3, n_cards=12, fog_density=10.0)
    sky = scene.get_entity("sky")
    sky.stars_count = 0
    scene.set_entity("sky", sky)
    r = Renderer(scene, device="cpu")
    ds, c = r.device_scene, r.config
    assert ds.geo.material_id.shape[0] > 2048  # packed shade and aux rows
    assert ds.lights.has_tree and ds.lights.has_micro
    assert ds.light_slot_rows.shape[1] == D.LSR_FUSED_MICRO_COLS
    assert ds.geo.bvh.has_cutouts and ds.geo.bvh.cut_tris.shape[1] == 44
    assert ds.fog.on and c.use_bridges and c.bridge_vertices == 2
    assert c.use_textures and c.use_aux_textures and c.aerial and c.sun_ris
    js = convert_scene(scene, "luminary_tpu")
    from luminary_tpu.ops.camera import pack_camera

    n = w * h * spp
    px = np.tile(np.arange(w * h) % w, spp).astype(np.int32)
    py = np.tile(np.arange(w * h) // w, spp).astype(np.int32)
    sid = np.repeat(np.arange(spp), w * h).astype(np.uint32)
    ref, _, rays_j = jax_render(jax_device_scene(js, ds),
                                jax.device_put(pack_camera(js.camera)),
                                jax_config(c, n), px, py, sid)
    got, _, rays_t = render_sample(ds, r.device_camera, c, torch.as_tensor(px),
                                   torch.as_tensor(py),
                                   torch.as_tensor(sid.astype(np.int64)))
    ref, got = np.asarray(ref), got.numpy()
    scale = float(np.abs(ref).mean())
    assert np.isfinite(got).all() and scale > 0
    assert float(np.abs(got - ref).max()) <= 1e-4 * scale
    assert float(rays_t) == float(rays_j)
