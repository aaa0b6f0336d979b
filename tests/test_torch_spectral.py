"""Spectral rendering against the JAX package on the same numpy inputs:

- the module tables (inverse CDF, resolve and uplift matrices, the 8 sky
  bands, the Rayleigh, ozone and solar band spectra) bit for bit;
- ``sample_hero_wavelengths``: the three wavelengths bit for bit, their pdfs
  within rtol 1e-6; ``uplift``, ``resolve_to_rgb`` and ``cauchy_ior``
  within rtol 1e-5 (``exp`` differs between XLA and PyTorch by ulps);
  ``sample_spectrum_bands`` bit for bit;
- the 8-band DEFAULT-sky bake (``bake_sky_spectral``) against the
  reference's atmosphere functions at the pack's size within rtol 1e-4
  (atol 1e-6 of the largest value), as tests/test_torch_slice.py holds the
  RGB bake; the disc's spectrum likewise;
- ``sky_radiance_spectral`` and ``sun_radiance_spectral`` on shared tables
  (the port's bake in a JAX sky) within rtol 1e-5, off the moon and the
  stars (a star is a 3e-4 rad Gaussian that an ulp of a direction moves);
- the reference's own assertions (``tests/test_spectral.py``): a white
  furnace renders as in RGB (3 %), a coloured floor agrees (12 %), the
  8-band atmosphere reddens the low sun, and dispersive glass keeps energy.
  Those renders trace all their samples as one wavefront (``render_sample``
  over lanes tiled by sample).
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from luminary_tpu.ops import atmosphere as JA
from luminary_tpu.ops import sky as JS
from luminary_tpu.ops import spectral as JSP
from luminary_tpu.ops.vec import Vec3 as JVec3
from luminary_tpu_torch.ops import sky as S
from luminary_tpu_torch.ops import spectral as SP
from luminary_tpu_torch.ops.vec import Vec3
from luminary_tpu_torch.render import device_scene as D
from luminary_tpu_torch.render.renderer import Renderer
from luminary_tpu_torch.render.wavefront import render_sample
from luminary_tpu_torch.scene.entities import (
    Material,
    MaterialBaseSubstrate,
    SkyMode,
)
from luminary_tpu_torch.scene.mesh import Mesh
from luminary_tpu_torch.scene.scene import Scene
from luminary_tpu_torch.testing import sun_plane_scene
from test_torch_textures import convert_scene

torch.set_num_threads(1)

N = 4096


def _t(a):
    return torch.as_tensor(np.array(a, copy=True))


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def test_tables_bit_for_bit():
    for name in ("_INV_CDF", "_M_RESOLVE", "_UPLIFT_CORR", "SKY_BANDS"):
        assert np.array_equal(_bits(getattr(SP, name)), _bits(getattr(JSP, name))), name
    assert SP._W_INT == JSP._W_INT
    for fn in ("rayleigh_beta_bands", "ozone_beta_bands", "sun_irradiance_bands"):
        assert np.array_equal(_bits(getattr(SP, fn)()), _bits(getattr(JSP, fn)())), fn


def _u(seed, n=N):
    u = np.random.default_rng(seed).random(n, dtype=np.float32)
    u[:4] = [0.0, np.float32(1.0) - np.float32(2**-24), 1.0 / 3.0, 2.0 / 3.0]
    return u.astype(np.float32)


def test_hero_wavelengths_match_reference():
    u = _u(1)
    lam_t, pdf_t = SP.sample_hero_wavelengths(_t(u))
    lam_j, pdf_j = JSP.sample_hero_wavelengths(jnp.asarray(u))
    for a, b in zip(lam_t, lam_j):
        assert np.array_equal(_bits(a.numpy()), _bits(b))
    for a, b in zip(pdf_t, pdf_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_uplift_resolve_cauchy_bands_match_reference():
    rng = np.random.default_rng(2)
    lam = rng.uniform(380.0, 720.0, N).astype(np.float32)
    lam[:4] = [380.0, 405.0, 690.0, 720.0]
    rgb = rng.uniform(0.0, 2.0, (3, N)).astype(np.float32)
    got = SP.uplift(*(_t(c) for c in rgb), _t(lam)).numpy()
    ref = np.asarray(JSP.uplift(*(jnp.asarray(c) for c in rgb), jnp.asarray(lam)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    lam3, pdf3 = JSP.sample_hero_wavelengths(jnp.asarray(_u(3)))
    ls = rng.uniform(0.0, 5.0, (3, N)).astype(np.float32)
    got = SP.resolve_to_rgb(*(_t(c) for c in ls),
                            tuple(_t(np.asarray(x)) for x in lam3),
                            tuple(_t(np.asarray(x)) for x in pdf3))
    ref = JSP.resolve_to_rgb(*(jnp.asarray(c) for c in ls), lam3, pdf3)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    n_d = rng.uniform(1.3, 1.9, N).astype(np.float32)
    abbe = rng.choice([0.0, -1.0, 20.0, 64.17], N).astype(np.float32)
    got = SP.cauchy_ior(_t(n_d), _t(lam), _t(abbe)).numpy()
    ref = np.asarray(JSP.cauchy_ior(jnp.asarray(n_d), jnp.asarray(lam),
                                    jnp.asarray(abbe)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert np.array_equal(got[abbe <= 0.0], n_d[abbe <= 0.0])
    bands = rng.uniform(0.0, 3.0, (N, 8)).astype(np.float32)
    got = SP.sample_spectrum_bands(_t(bands.T.copy()), _t(lam)).numpy()
    ref = np.asarray(JSP.sample_spectrum_bands(jnp.asarray(bands), jnp.asarray(lam)))
    assert np.array_equal(_bits(got), _bits(ref))


def _spectral_plane(altitude=0.6, mode=SkyMode.DEFAULT):
    s = sun_plane_scene(16, 16)
    st = s.get_entity("settings")
    st.spectral_rendering = True
    s.set_entity("settings", st)
    sky = s.get_entity("sky")
    sky.mode = mode
    sky.altitude = altitude
    sky.moon_altitude = 0.5
    s.set_entity("sky", sky)
    return s


def test_spectral_bake_matches_reference():
    """The port's 8-band bake (transmittance and multiscatter LUTs, the env
    at Ws = max(env width / 2, 64), the disc) against the reference's
    functions, jitted, on the same parameters."""
    scene = _spectral_plane()
    env_w = 128  # pack_sky's env width at a 16-pixel image
    env8, disc8 = D.bake_sky_spectral(scene, env_w, "cpu")
    js = convert_scene(scene, "luminary_tpu")
    p8 = JA.atmo_params_from_sky(js.sky, spectral=True)
    t_lut = jax.jit(JA.build_transmittance_lut)(p8)
    ms_lut = jax.jit(JA.build_multiscatter_lut)(p8, t_lut)
    h_obs = jnp.float32(max(float(js.sky.geometry_offset[1]), 0.001))
    sun_dir = jnp.asarray(D.sun_direction(js.sky.azimuth, js.sky.altitude))
    bands = jnp.asarray(JSP.sun_irradiance_bands())
    from luminary_tpu.ops.sky import SUN_IRRADIANCE, SUN_RADIANCE

    irr8 = bands * jnp.float32(SUN_IRRADIANCE * js.sky.sun_strength)
    sw = max(env_w // 2, 64)
    steps = int(min(max(js.sky.steps, 8), 64))
    ref = np.asarray(jax.jit(
        lambda *a: JA.bake_sky_envmap(*a, width=sw, height=sw // 2,
                                      steps=steps))(
        p8, t_lut, ms_lut, h_obs, sun_dir, irr8))
    got = env8.numpy()
    assert got.shape == ref.shape == (32, 64, 8)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-6 * float(np.abs(ref).max()))
    ref_disc = np.asarray(JA.sample_transmittance_lut(t_lut, h_obs, sun_dir[1])
                          * bands * jnp.float32(SUN_RADIANCE * js.sky.sun_strength))
    np.testing.assert_allclose(disc8.numpy(), ref_disc, rtol=1e-4)
    # and the pack carries it as 32-column quad rows
    ds = D.pack_sky(scene, "cpu")
    assert D.env_to_rows_spec(got).shape == ds.env_spec_rows.shape == (2048, 32)
    assert (ds.env_spec_h, ds.env_spec_w) == (32, 64)
    assert np.array_equal(ds.env_spec_rows.numpy(), D.env_to_rows_spec(got))


def _jax_sky(k, js):
    """The port's DeviceSky as the JAX sky functions read it."""
    f32 = lambda v: jnp.asarray(np.asarray(v, np.float32))  # noqa: E731
    return types.SimpleNamespace(
        mode=jnp.int32(k.mode), constant_color=f32(k.constant_color),
        sun_dir=f32(k.sun_dir), env_rows=f32(k.env_rows),
        env_h=jnp.int32(k.env_h), env_w=jnp.int32(k.env_w),
        env_spec_rows=f32(k.env_spec_rows), env_spec_h=jnp.int32(k.env_spec_h),
        env_spec_w=jnp.int32(k.env_spec_w), sun_disc_spec=f32(k.sun_disc_spec),
        sun_disc_radiance=f32(k.sun_disc_radiance), moon_dir=f32(k.moon_dir),
        moon_tex_offset=f32(k.moon_tex_offset),
        stars_seed=jnp.int32(k.stars_seed), stars_count=jnp.int32(k.stars_count),
        stars_intensity=f32(k.stars_intensity))


@pytest.mark.parametrize("mode", [SkyMode.DEFAULT, SkyMode.CONSTANT_COLOR])
def test_sky_radiance_spectral_on_shared_tables(mode):
    scene = _spectral_plane(mode=mode)
    k = D.pack_sky(scene, "cpu")
    assert S.has_spectral_bake(k) == (mode == SkyMode.DEFAULT)
    skj = _jax_sky(k, None)
    rng = np.random.default_rng(4)
    d = rng.standard_normal((N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    lam3, _ = JSP.sample_hero_wavelengths(jnp.asarray(_u(5)))
    dj = JVec3(*(jnp.asarray(d[:, i]) for i in range(3)))
    ref = JS.sky_radiance_spectral(skj, dj, lam3)
    got = S.sky_radiance_spectral(k, Vec3(*(_t(d[:, i]) for i in range(3))),
                                  tuple(_t(np.asarray(x)) for x in lam3))
    star = np.asarray(JS.stars_radiance(skj, dj)[1]) > 0.0
    moon = np.asarray(JS.moon_radiance(skj, dj)[1])
    plain = ~star & ~moon
    assert plain.mean() > 0.95
    for a, b in zip(got, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy()[plain], b[plain], rtol=1e-5,
                                   atol=1e-6 * float(np.abs(b).max()))
    sun_j = JS.sun_radiance_spectral(skj, lam3)
    sun_t = S.sun_radiance_spectral(k, tuple(_t(np.asarray(x)) for x in lam3))
    for a, b in zip(sun_t, sun_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


def _floor_scene(albedo, spectral, width=20, height=20, sky_color=(1, 1, 1)):
    scene = Scene()
    scene.add_material(Material(albedo=albedo, roughness=1.0))
    mesh = Mesh(vertices=np.asarray([(-20, 0, -20), (20, 0, -20), (20, 0, 20),
                                     (-20, 0, 20)], np.float32),
                triangles=np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
                material_ids=np.zeros(2, np.uint16), name="floor")
    scene.add_mesh(mesh)
    inst = scene.new_instance()
    inst.mesh_id = mesh.id
    scene.set_instance(inst)
    sky = scene.get_entity("sky")
    sky.mode = SkyMode.CONSTANT_COLOR
    sky.constant_color = sky_color
    scene.set_entity("sky", sky)
    s = scene.get_entity("settings")
    s.width = width
    s.height = height
    s.max_ray_depth = 3
    s.spectral_rendering = spectral
    scene.set_entity("settings", s)
    cam = scene.get_entity("camera")
    cam.pos = (0.0, 4.0, 0.0)
    cam.rotation = (-np.pi / 2, 0.0, 0.0)
    scene.set_entity("camera", cam)
    return scene


def _mean_rgb(scene, samples=64):
    """Mean radiance over the image and ``samples`` samples, traced as one
    wavefront of pixels x samples lanes."""
    r = Renderer(scene, device="cpu")
    c = r.config
    n = c.width * c.height
    px = r._px[:n].repeat(samples)
    py = r._py[:n].repeat(samples)
    sid = torch.arange(samples, dtype=torch.int64).repeat_interleave(n)
    rad, _, _ = render_sample(r.device_scene, r.device_camera, c,
                              px, py, sid, with_gbuffer=False)
    return torch.clamp(rad, max=1e6).double().mean(dim=0).numpy()


def test_spectral_white_furnace_matches_rgb():
    m_rgb = _mean_rgb(_floor_scene((1.0, 1.0, 1.0, 1.0), False))
    m_spec = _mean_rgb(_floor_scene((1.0, 1.0, 1.0, 1.0), True))
    assert np.all(np.abs(m_spec - m_rgb) / np.maximum(m_rgb, 1e-9) < 0.03), (
        m_spec, m_rgb)


def test_spectral_colored_scene_agrees():
    alb = (0.7, 0.35, 0.15, 1.0)
    m_rgb = _mean_rgb(_floor_scene(alb, False), samples=96)
    m_spec = _mean_rgb(_floor_scene(alb, True), samples=96)
    assert np.all(np.abs(m_spec - m_rgb) / np.maximum(m_rgb, 1e-2) < 0.12), (
        m_spec, m_rgb)


def test_spectral_sky_reddens_low_sun():
    def disc_ratio(altitude):
        ds = D.pack_sky(_spectral_plane(altitude=altitude), "cpu")
        assert ds.env_spec_rows.shape[0] > 1  # the 8-band bake happened
        spec = ds.sun_disc_spec.numpy()
        return spec[5:].sum() / max(spec[:3].sum(), 1e-12)

    assert disc_ratio(0.06) > 3.0 * disc_ratio(1.2)


def test_spectral_dispersion_conserves_energy():
    scene = _floor_scene((0.9, 0.9, 0.9, 1.0), True)
    scene.add_material(Material(
        albedo=(1.0, 1.0, 1.0, 1.0), roughness=0.02,
        base_substrate=MaterialBaseSubstrate.TRANSLUCENT,
        refraction_index=1.5, abbe=20.0))
    verts = [(-2, 1.0, -2), (2, 1.0, -2), (2, 1.0, 2), (-2, 1.0, 2),
             (-2, 1.4, -2), (2, 1.4, -2), (2, 1.4, 2), (-2, 1.4, 2)]
    mesh = Mesh(vertices=np.asarray(verts, np.float32),
                triangles=np.asarray([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7]],
                                     np.int32),
                material_ids=np.ones(4, np.uint16), name="slab")
    scene.add_mesh(mesh)
    inst = scene.new_instance()
    inst.mesh_id = mesh.id
    scene.set_instance(inst)
    m = _mean_rgb(scene, samples=48)
    assert np.all(np.isfinite(m)) and np.all(m >= 0)
    assert m.mean() > 0.2  # light still reaches the floor through the slab
