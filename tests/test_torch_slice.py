"""The slice as a whole against the JAX package, on the one small scene that
takes every main-path branch: ``benchmark_scene(32, 18, max_depth=2, nx=6,
nz=6)`` has a wide BVH (>128 slots), packed shade rows (>2048 slots), a light
tree (>=64 emitters), the DEFAULT sky with aerial perspective, sun RIS and
RIS K=4.

One module fixture builds the JAX Renderer (about a minute on a CPU, most
of it the reference's aerial-perspective bake, whose 64 unrolled march
steps XLA compiles for ~60 s) and renders one sample with the JAX
``render_sample`` called without jit, its walks jitted (a jitted compile
of the whole sample takes another ~50 s); every check reuses it:

(a) the port's own pack equals the JAX tables word for word per slot; the
    baked sky, aerial and env-pdf rows (transcendentals differ between XLA
    and PyTorch) within rtol 1e-4;
(b) ``sky_radiance`` and ``aerial_fetch`` on the fixture's baked tables,
    within rtol 1e-5 (atol 1e-6 of the largest value);
(c) one port sample, on the carried-across JAX pack and on its own pack,
    against the JAX sample, within the golden bound (RMSE/scale < 0.02).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from luminary_tpu.ops import sky as jsky
from luminary_tpu.ops.vec import Vec3 as JVec3
from luminary_tpu.render.renderer import Renderer as JRenderer
from luminary_tpu.testing import benchmark_scene as j_benchmark_scene
from luminary_tpu_torch.ops import sky as tsky
from luminary_tpu_torch.ops.vec import Vec3
from luminary_tpu_torch.render.device_scene import from_jax_arrays, pack_scene
from luminary_tpu_torch.render.wavefront import RenderConfig, render_sample
from luminary_tpu_torch.testing import benchmark_scene
from test_torch_pack import TABLES, _jax_tables, _port_tables, jax_scene_tree, same_words
from test_torch_textures import jax_render

torch.set_num_threads(1)

W, H = 32, 18
BAKED = ("env_rows", "aerial_rows", "env_cell_pdf", "sun_disc_radiance")
# rows derived from the baked env by host code (alias draws of env NEE,
# which the DEFAULT sky never runs)
NOT_COMPARED = ("env_alias_rows",)


@pytest.fixture(scope="module")
def fx():
    scene_j = j_benchmark_scene(W, H, max_depth=2, nx=6, nz=6)
    r = JRenderer(scene_j, chunk=1 << 20)
    rad, gbuffer, rays = jax_render(r.device_scene, r.device_camera, r.config,
                                    np.asarray(r._px), np.asarray(r._py),
                                    np.uint32(0))
    n = W * H
    # the Renderer's accumulation of one sample: the firefly clamp
    ref_img = np.minimum(np.asarray(rad), 1e6)[:n]
    tree = jax_scene_tree(r.device_scene, r.device_camera)
    own = pack_scene(benchmark_scene(W, H, max_depth=2, nx=6, nz=6), "cpu")
    carried, cam = from_jax_arrays(tree, "cpu")
    c = r.config
    assert c.shading_mode == 0
    cfg = RenderConfig(width=c.width, height=c.height, max_depth=c.max_depth,
                       ris_candidates=c.ris_candidates, blue_noise=c.blue_noise,
                       aerial=c.aerial, sun_ris=c.sun_ris)
    return dict(r=r, ref_img=ref_img, own=own, carried=carried, cam=cam,
                cfg=cfg, px=torch.as_tensor(np.array(r._px)),
                py=torch.as_tensor(np.array(r._py)), rays=float(rays),
                gbuffer=gbuffer)


def test_fixture_takes_every_main_path_branch(fx):
    own, cfg = fx["own"], fx["cfg"]
    assert own.geo.material_id.shape[0] > 2048  # packed shade rows
    assert own.geo.bvh.tri_v0.x.shape[0] > 128  # wide BVH walk
    assert own.lights.has_tree  # light-tree candidate 0
    assert own.sky.mode == 0 and cfg.aerial and cfg.sun_ris
    assert cfg.ris_candidates == 4 and cfg.blue_noise


@pytest.mark.parametrize("name", [t for t in TABLES if t not in NOT_COMPARED])
def test_own_pack_matches_reference(fx, name):
    got = _port_tables(fx["own"], fx["cam"])[name]
    ref = _jax_tables(fx["r"].device_scene, fx["r"].device_camera)[name]
    if name in BAKED:
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(ref).max()))
    else:
        assert same_words(got, ref), name


def test_static_sizes(fx):
    own, d = fx["own"], fx["r"].device_scene
    assert own.geo.bvh.depth == d.geo.bvh.depth
    assert own.geo.bvh.num_nodes == d.geo.bvh.num_nodes
    assert own.lights.tree_levels == d.lights.tree_levels
    assert own.lights.tree_num_nodes == d.lights.tree_num_nodes
    assert (own.sky.env_h, own.sky.env_w) == (int(d.sky.env_h), int(d.sky.env_w))


def _dirs(n=4096, seed=3):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _close_sky(got, ref):
    got = got.numpy()
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * float(np.abs(ref).max()))


def test_sky_radiance_on_reference_tables(fx):
    """The baked dome on every lane; moon and star terms are compared apart:
    a star is a Gaussian of ~3e-4 rad evaluated from 1 - cos(angle) in
    float32, so one ulp of the direction moves a lane on a star by percents.
    Lanes the reference lights with a star or the moon are only counted."""
    d = _dirs()
    sky_j = fx["r"].device_scene.sky
    dj = JVec3(*(jnp.asarray(d[:, i]) for i in range(3)))
    ref = jsky.sky_radiance(sky_j, dj, include_sun=False)
    got = tsky.sky_radiance(fx["carried"].sky,
                            Vec3(*(torch.as_tensor(d[:, i].copy()) for i in range(3))),
                            include_sun=False)
    star = np.asarray(jsky.stars_radiance(sky_j, dj)[1]) > 0.0
    moon = np.asarray(jsky.moon_radiance(sky_j, dj)[1])
    plain = ~star & ~moon
    assert plain.mean() > 0.95  # ~1.4 % of random directions land on a star
    for a, b in zip(got, ref):
        _close_sky(a[torch.as_tensor(plain)], np.asarray(b)[plain])
    dome_j = jsky.sample_env_rows(sky_j, dj)
    dome_t = tsky.sample_env_rows(fx["carried"].sky,
                                  Vec3(*(torch.as_tensor(d[:, i].copy()) for i in range(3))))
    for a, b in zip(dome_t, dome_j):
        _close_sky(a, b)


def test_aerial_fetch_on_reference_tables(fx):
    d = _dirs(seed=4)
    dist = np.exp(np.random.default_rng(5).uniform(
        np.log(1e-3), np.log(100.0), d.shape[0])).astype(np.float32)
    (tr_j, in_j) = jsky.aerial_fetch(
        fx["r"].device_scene.sky, JVec3(*(jnp.asarray(d[:, i]) for i in range(3))),
        jnp.asarray(dist))
    (tr_t, in_t) = tsky.aerial_fetch(
        fx["carried"].sky, Vec3(*(torch.as_tensor(d[:, i].copy()) for i in range(3))),
        torch.as_tensor(dist))
    for a, b in zip(tr_t + in_t, tr_j + in_j):
        _close_sky(a, b)


@pytest.mark.parametrize("pack", ["carried", "own"])
def test_one_sample_matches_reference(fx, pack):
    scene = fx[pack]
    rad, _gbuf, rays = render_sample(scene, fx["cam"], fx["cfg"], fx["px"],
                                     fx["py"], 0)
    n = W * H
    img = rad.numpy()[:n]
    ref = fx["ref_img"]
    assert np.isfinite(img).all()
    rmse = float(np.sqrt(np.mean((img - ref) ** 2)))
    scale = float(np.abs(ref).mean()) + 1e-6
    assert rmse / scale < 0.02, (pack, rmse, scale)
    # the same rays were traced, up to lanes that an ulp moved across a
    # sampling decision
    assert abs(float(rays) - fx["rays"]) <= 0.01 * fx["rays"]


@pytest.mark.parametrize("pack", ["carried", "own"])
def test_gbuffer_matches_reference(fx, pack):
    """The primary-hit metadata that picking reads: the same instance and
    material on every lane, depth and hit position within f32 rounding."""
    _rad, g, _rays = render_sample(fx[pack], fx["cam"], fx["cfg"], fx["px"],
                                   fx["py"], 0)
    ref = fx["gbuffer"]
    n = W * H
    np.testing.assert_array_equal(g.instance_id.numpy()[:n],
                                  np.asarray(ref.instance_id)[:n])
    np.testing.assert_array_equal(g.material_id.numpy()[:n],
                                  np.asarray(ref.material_id)[:n])
    np.testing.assert_allclose(g.depth.numpy()[:n], np.asarray(ref.depth)[:n],
                               rtol=1e-5)
    np.testing.assert_allclose(g.rel_hit_pos.numpy()[:n],
                               np.asarray(ref.rel_hit_pos)[:n], rtol=1e-4,
                               atol=1e-4)
    assert (g.instance_id.numpy()[:n] >= 0).any()
