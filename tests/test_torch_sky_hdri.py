"""The HDRI sky and environment NEE against the JAX package on the same
numpy inputs: ``_bake_hdri_extras`` without clouds (moon and stars folded
into a map, rtol 1e-5), the env-NEE alias rows and cell pdf of
``_build_env_nee`` (bit for bit on the same map), ``sample_env_direction``
(the drawn cells' pdf exact, directions within 1e-6) and ``env_pdf``
(exact); and one whole-slice render of a 16x16 sky-and-sea scene (the
analytic ocean with water scattering and sun caustics, the HDRI sky with
env NEE, clouds off; depth 3, 4 samples) held against the JAX integrator
within 1e-4 of the scale, as tests/test_torch_cutout.py holds the content
slice: the JAX ``render_sample`` is called without jit around the port's
baked sky tables, with its walks and ocean marches jitted.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from luminary_tpu.ops import sky as JS
from luminary_tpu.ops.vec import Vec3 as JVec3
from luminary_tpu.render import device_scene as JD
from luminary_tpu_torch.ops import sky as S
from luminary_tpu_torch.ops.vec import Vec3
from luminary_tpu_torch.render import device_scene as D
from luminary_tpu_torch.render.renderer import Renderer
from luminary_tpu_torch.render.wavefront import render_sample
from luminary_tpu_torch.scene.entities import SkyMode
from luminary_tpu_torch.scene.mesh import Mesh
from luminary_tpu_torch.testing import _uv_sphere, sun_plane_scene
from test_torch_textures import convert_scene, jax_device_scene, jax_render

torch.set_num_threads(1)

N = 4096


def _env(seed, h=64, w=128):
    """A positive lat-long map with one hot patch."""
    rng = np.random.default_rng(seed)
    env = (rng.random((h, w, 3)) * 0.2 + 0.01).astype(np.float32)
    env[h // 5:h // 3, w // 3:w // 2] = (30.0, 25.0, 20.0)
    return env


def _sky_scene():
    s = sun_plane_scene(16, 16)
    sky = s.get_entity("sky")
    sky.mode = SkyMode.HDRI
    sky.moon_altitude = 0.4
    sky.moon_azimuth = 1.3
    sky.stars_count = 600
    s.set_entity("sky", sky)
    return s


def test_bake_hdri_extras_matches_reference():
    """Moon and stars folded into a map (the moon, 0.0045 rad, falls
    between this map's texel centres): texels off the stars within rtol
    1e-5. A star is a Gaussian of ~3e-4 rad evaluated from 1 - cos(angle)
    in float32, so one ulp of a direction moves its texels by percents
    (tests/test_torch_slice.py compares those lanes apart): the star texels
    (under 1 % of the map) are held within rtol 0.1."""
    scene = _sky_scene()
    env = _env(1)
    sun_dir = D.sun_direction(scene.sky.azimuth, scene.sky.altitude)
    disc = np.asarray([900.0, 800.0, 700.0], np.float32)
    js = convert_scene(scene, "luminary_tpu")
    ref = JD._bake_hdri_extras(js, env, sun_dir, jnp.asarray(disc))
    got = D._bake_hdri_extras(scene, torch.as_tensor(env), sun_dir,
                              torch.as_tensor(disc)).numpy()
    assert got.shape == ref.shape == env.shape
    dirs = D._latlong_dirs(*env.shape[:2])
    dsky = types.SimpleNamespace(
        stars_seed=jnp.int32(js.sky.stars_seed),
        stars_count=jnp.int32(js.sky.stars_count),
        stars_intensity=jnp.float32(js.sky.stars_intensity))
    star = (np.asarray(JS.stars_radiance(dsky, JVec3(*(
        jnp.asarray(dirs[:, i].copy()) for i in range(3))))[1]) > 0.0)
    star = star.reshape(env.shape[:2])
    assert 0 < star.mean() < 0.01, star.mean()
    assert (got[star] > env[star] + 1e-3).any()  # the stars are in
    np.testing.assert_allclose(got[~star], ref[~star], rtol=1e-5)
    np.testing.assert_allclose(got[star], ref[star], rtol=0.1)


@pytest.mark.parametrize("seed", [2, 3])
def test_env_nee_rows_match_reference_bit_for_bit(seed):
    env = _env(seed, 96, 200)
    ref = JD._build_env_nee(env, False)
    got = D._build_env_nee(env, False)
    for a, b in zip(got[:2], ref[:2]):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.int32),
                                                     b.view(np.int32))
    assert got[2:4] == ref[2:4] and np.float32(got[4]) == np.float32(ref[4])


def _skies(env):
    """(JAX-side sky namespace, the port's DeviceSky) on the same map."""
    scene = _sky_scene()
    scene.set_sky_hdri(env)
    t = D.pack_sky(scene, "cpu")
    j = types.SimpleNamespace(
        env_alias_rows=jnp.asarray(t.env_alias_rows.numpy()),
        env_cell_pdf=jnp.asarray(t.env_cell_pdf.numpy()),
        env_ch=jnp.int32(t.env_ch), env_cw=jnp.int32(t.env_cw))
    return j, t


def test_sample_env_direction_and_pdf_match_reference():
    skj, skt = _skies(_env(4))
    rng = np.random.default_rng(5)
    pid = rng.integers(0, 1920 * 1080, N).astype(np.uint32)
    sid = rng.integers(0, 1 << 20, N).astype(np.uint32)
    px, py = (pid % 1920).astype(np.int32), (pid // 1920).astype(np.int32)
    from luminary_tpu.ops.random import blue_base as j_blue_base
    from luminary_tpu_torch.ops.random import blue_base

    for use_bn in (False, True):
        for depth in (0, 2):
            dj, pj = JS.sample_env_direction(
                skj, jnp.asarray(pid), jnp.asarray(sid), depth,
                bn=j_blue_base(jnp.asarray(px), jnp.asarray(py)) if use_bn else None)
            dt, pt = S.sample_env_direction(
                skt, torch.as_tensor(pid.astype(np.int64)),
                torch.as_tensor(sid.astype(np.int64)), depth,
                bn=blue_base(torch.as_tensor(px), torch.as_tensor(py))
                if use_bn else None)
            assert np.array_equal(pt.numpy(), np.asarray(pj))
            for a, b in zip(dt, dj):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    # hot cells are drawn far above their share of the sphere
    assert float(pt.max()) > 20.0 * float(pt.min())
    d = rng.standard_normal((N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:4] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [0, 0, -1]]
    ref = np.asarray(JS.env_pdf(skj, JVec3(*(jnp.asarray(d[:, i].copy())
                                             for i in range(3)))))
    got = S.env_pdf(skt, Vec3(*(torch.as_tensor(d[:, i].copy())
                                for i in range(3)))).numpy()
    assert np.array_equal(got, ref)


def _sea_scene(w=16, h=16):
    """The sun plane under 0.5 m of analytic ocean (water scattering, sun
    caustics), four spheres standing in the water, the HDRI sky baked at
    256 x 128 with env NEE."""
    s = sun_plane_scene(w, h)
    mid = 0
    for i, (x, z) in enumerate(((0.0, -5.0), (2.5, -4.0), (-2.5, -6.0),
                                (1.0, -8.0))):
        v, t = _uv_sphere(x, 0.4 + 0.2 * i, z, 0.9)
        mesh = Mesh(vertices=v, triangles=t,
                    material_ids=np.full(len(t), mid, np.uint16), name="s%d" % i)
        s.add_mesh(mesh)
        inst = s.new_instance()
        inst.mesh_id = mesh.id
        s.set_instance(inst)
    oc = s.get_entity("ocean")
    oc.active = True
    oc.height = 0.5
    oc.amplitude = 0.15
    oc.caustics_active = True
    s.set_entity("ocean", oc)
    sky = s.get_entity("sky")
    sky.mode = SkyMode.HDRI
    sky.hdri_dim = 256
    s.set_entity("sky", sky)
    return s


def _jax_config(c, chunk):
    from luminary_tpu.render.wavefront import RenderConfig as JRC

    return JRC(width=c.width, height=c.height, max_depth=c.max_depth,
               chunk=chunk, ris_candidates=c.ris_candidates,
               use_textures=c.use_textures, use_aux_textures=c.use_aux_textures,
               use_bridges=c.use_bridges, bridge_vertices=c.bridge_vertices,
               blue_noise=c.blue_noise, aerial=c.aerial, sun_ris=c.sun_ris,
               use_clouds=c.use_clouds, cloud_steps=c.cloud_steps,
               cloud_layers=c.cloud_layers, env_nee=c.env_nee,
               ocean_caustics=c.ocean_caustics, caustics_k=c.caustics_k,
               ocean_mat_id=c.ocean_mat_id, analytic_ocean=c.analytic_ocean,
               water_scatter=c.water_scatter)


def test_whole_slice_matches_reference(monkeypatch):
    w = h = 16
    spp = 4
    scene = _sea_scene(w, h)
    r = Renderer(scene, device="cpu")
    ds, c = r.device_scene, r.config
    assert c.analytic_ocean and c.water_scatter and c.ocean_caustics
    assert c.env_nee and not c.use_clouds and not c.aerial
    assert ds.sky.env_w == 256 and ds.sky.env_nee_total > 0.0
    js = convert_scene(scene, "luminary_tpu")
    from luminary_tpu.ops import ocean as JO
    from luminary_tpu.ops.camera import pack_camera

    monkeypatch.setattr(JO, "ocean_intersect", jax.jit(
        JO.ocean_intersect, static_argnames=("iters",)))
    monkeypatch.setattr(JO, "ocean_crosses", jax.jit(
        JO.ocean_crosses, static_argnames=("steps",)))
    n = w * h * spp
    px = np.tile(np.arange(w * h) % w, spp).astype(np.int32)
    py = np.tile(np.arange(w * h) // w, spp).astype(np.int32)
    sid = np.repeat(np.arange(spp), w * h).astype(np.uint32)
    ref, gb_j, rays_j = jax_render(jax_device_scene(js, ds),
                                   jax.device_put(pack_camera(js.camera)),
                                   _jax_config(c, n), px, py, sid)
    got, gb_t, rays_t = render_sample(ds, r.device_camera, c,
                                      torch.as_tensor(px), torch.as_tensor(py),
                                      torch.as_tensor(sid.astype(np.int64)))
    ref, got = np.asarray(ref), got.numpy()
    scale = float(np.abs(ref).mean())
    assert np.isfinite(got).all() and scale > 0
    assert float(np.abs(got - ref).max()) <= 1e-4 * scale
    assert float(rays_t) == float(rays_j)
    # the analytic ocean is hit and picks as the procedural instance
    assert np.array_equal(gb_t.instance_id.numpy(), np.asarray(gb_j.instance_id))
    assert (gb_t.instance_id.numpy() == 0x7FFF0000).any()
