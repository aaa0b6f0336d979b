"""Textures and emission-texture importance against the JAX package, on the
same inputs: the atlas tables word for word; ``sample_atlas`` (trilinear,
nearest level and level 0, with UVs on and past the edges and
``tex_id = -1``) within 1e-6; the mip level the integrator's LOD selects,
exactly; the aux shade table bit for bit; ``_emission_tex_means``, the
69-column fused light rows and the slot micro weights within rtol 1e-6; one
sample of the ``textured_32`` golden scene (the small-table texture path)
against the JAX integrator.

Helpers shared with tests/test_torch_cutout.py: ``convert_scene`` (a scene
of one package as a scene of the other) and ``jax_device_scene`` (the JAX
package's DeviceScene of a scene, with the sky tables of the port's pack in
place of the JAX bake, whose compile takes minutes on a CPU).
"""

import dataclasses
import enum
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from luminary_tpu.ops import textures as JT
from luminary_tpu.render import device_scene as JD
from luminary_tpu_torch.ops import textures as T
from luminary_tpu_torch.render import device_scene as D
from luminary_tpu_torch.render.renderer import Renderer
from luminary_tpu_torch.render.wavefront import render_sample
from luminary_tpu_torch.testing import content_scene, textured_scene

torch.set_num_threads(1)


def _conv(x, ents):
    if dataclasses.is_dataclass(x):
        cls = getattr(ents, type(x).__name__)
        return cls(**{f.name: _conv(getattr(x, f.name), ents)
                      for f in dataclasses.fields(x)})
    if isinstance(x, enum.Enum):
        return getattr(ents, type(x).__name__)(x.value)
    if isinstance(x, list):
        return [_conv(v, ents) for v in x]
    return x


def convert_scene(s, package: str):
    """A Scene of either package as a Scene of ``package`` ("luminary_tpu"
    or "luminary_tpu_torch"): entities field by field, meshes and textures
    sharing their arrays."""
    ents = importlib.import_module(package + ".scene.entities")
    mesh = importlib.import_module(package + ".scene.mesh")
    out = importlib.import_module(package + ".scene.scene").Scene()
    for name in ("settings", "camera", "ocean", "sky", "cloud", "fog",
                 "particles"):
        setattr(out, name, _conv(getattr(s, name), ents))
    out.materials = [_conv(m, ents) for m in s.materials]
    out.instances = [_conv(i, ents) for i in s.instances]
    for m in s.meshes:
        nm = mesh.Mesh(vertices=m.vertices, triangles=m.triangles,
                       normals=m.normals, uvs=m.uvs,
                       material_ids=m.material_ids, name=m.name)
        nm.id = m.id
        out.meshes.append(nm)
    out.textures = [mesh.Texture(data=t.data, gamma=t.gamma, wrap=t.wrap,
                                 name=t.name) for t in s.textures]
    return out


def jax_device_scene(js, port_scene):
    """The JAX DeviceScene of the JAX scene ``js``, its sky the port's baked
    tables (``port_scene.sky``)."""
    from luminary_tpu.ops.clouds import pack_clouds
    from luminary_tpu.ops.volume import pack_fog, pack_water

    geo = JD.pack_geometry(js)
    mats = JD.pack_materials(js)
    lights = JD.pack_lights_for(geo, mats, scene=js)
    hot, aux, micro = JD.pack_shade_packed(
        geo, mats, lights, tex_res=JT.page_resolutions(js.textures))
    k = port_scene.sky

    def f32(v):
        return np.asarray(v, np.float32)

    sky = JD.DeviceSky(
        mode=np.int32(k.mode), constant_color=f32(k.constant_color),
        sun_dir=f32(k.sun_dir), sun_strength=np.float32(js.sky.sun_strength),
        env_rows=f32(k.env_rows), env_h=np.int32(k.env_h),
        env_w=np.int32(k.env_w), env_alias_rows=f32(k.env_alias_rows),
        env_cell_pdf=f32(k.env_cell_pdf), env_ch=np.int32(k.env_ch),
        env_cw=np.int32(k.env_cw), env_nee_total=np.float32(k.env_nee_total),
        env_spec_rows=JD.env_to_rows_spec(np.zeros((1, 1, 8), np.float32)),
        env_spec_h=np.int32(1), env_spec_w=np.int32(1),
        sun_disc_spec=np.zeros(8, np.float32), aerial_rows=f32(k.aerial_rows),
        sun_disc_radiance=f32(k.sun_disc_radiance),
        geometry_offset=f32(js.sky.geometry_offset), moon_dir=f32(k.moon_dir),
        moon_tex_offset=f32(k.moon_tex_offset),
        stars_seed=np.int32(k.stars_seed), stars_count=np.int32(k.stars_count),
        stars_intensity=f32(k.stars_intensity))
    ds = JD.DeviceScene(
        geo=geo, materials=mats, sky=sky, lights=lights, fog=pack_fog(js.fog),
        water=pack_water(js.ocean), textures=JT.pack_textures(js.textures),
        clouds=pack_clouds(js.cloud), shade_hot=hot, shade_aux=aux,
        shade_micro=micro,
        light_slot_rows=JD.pack_light_slot_rows(geo, mats, lights))
    return jax.device_put(ds)


def jax_render(ds, cam, cfg, px, py, sid):
    """The JAX package's render_sample, called without jit (its compile of
    a full configuration takes minutes on a CPU); the trace functions are
    jitted so that each walk compiles once per shape."""
    import luminary_tpu.render.wavefront as JW

    saved = JW.trace_closest, JW.trace_occluded
    JW.trace_closest = jax.jit(saved[0], static_argnames=("chunk",))
    JW.trace_occluded = jax.jit(saved[1], static_argnames=("chunk",))
    try:
        return JW.render_sample(ds, cam, cfg, jnp.asarray(px), jnp.asarray(py),
                                jnp.asarray(sid))
    finally:
        JW.trace_closest, JW.trace_occluded = saved


def jax_config(c, chunk):
    """The JAX RenderConfig of a port RenderConfig."""
    from luminary_tpu.render.wavefront import RenderConfig as JRC

    return JRC(width=c.width, height=c.height, max_depth=c.max_depth,
               chunk=chunk, ris_candidates=c.ris_candidates,
               use_textures=c.use_textures,
               use_aux_textures=c.use_aux_textures,
               use_bridges=c.use_bridges, bridge_vertices=c.bridge_vertices,
               blue_noise=c.blue_noise, aerial=c.aerial, sun_ris=c.sun_ris)


def _textures():
    """Textures of every shape the atlas takes: RGBA, RGB, one channel, a
    non-square non-power-of-two image, a float image and a 3D texture."""
    from luminary_tpu_torch.scene.mesh import Texture

    rng = np.random.default_rng(5)
    return [
        Texture(data=rng.integers(0, 256, (64, 64, 4), dtype=np.uint8), gamma=2.2),
        Texture(data=rng.integers(0, 256, (20, 37, 3), dtype=np.uint8)),
        Texture(data=rng.integers(0, 256, (16, 16, 1), dtype=np.uint8)),
        Texture(data=rng.random((5, 3, 4), dtype=np.float32)),
        Texture(data=rng.integers(0, 256, (4, 8, 8, 1), dtype=np.uint8)),
    ]


def test_atlas_tables_match_reference():
    tex = _textures()
    rows, ptab, n = T.pack_textures_np(tex)
    ref = JT.pack_textures(tex)
    assert np.array_equal(rows.view(np.int32), np.asarray(ref.rows).view(np.int32))
    assert np.array_equal(ptab, np.asarray(ref.page_table))
    assert n == int(ref.num_pages) == 4
    assert np.array_equal(T.page_resolutions(tex), JT.page_resolutions(tex))


@pytest.mark.parametrize("mode", ["trilinear", "nearest", "level0"])
def test_sample_atlas_matches_reference(mode):
    tex = _textures()
    rng = np.random.default_rng(6)
    n = 8192
    u = rng.uniform(-2.0, 3.0, n).astype(np.float32)
    v = rng.uniform(-2.0, 3.0, n).astype(np.float32)
    # UVs on texel centres, edges and integers, where the wrap decides
    edge = np.asarray([0.0, 1.0, -1.0, 0.5, 1e-7, 1.0 - 1e-7, 2.0, -0.0],
                      np.float32)
    u[:64], v[:64] = np.repeat(edge, 8), np.tile(edge, 8)
    tid = rng.integers(-1, len(tex), n).astype(np.int32)
    lod = rng.uniform(-1.0, 12.0, n).astype(np.float32)
    jt = jax.device_put(JT.pack_textures(tex))
    tt = T.pack_textures(tex, "cpu")
    kw_j = {} if mode == "level0" else dict(lod=jnp.asarray(lod),
                                            trilinear=mode == "trilinear")
    kw_t = {} if mode == "level0" else dict(lod=torch.as_tensor(lod),
                                            trilinear=mode == "trilinear")
    ref = JT.sample_atlas(jt, jnp.asarray(tid), jnp.asarray(u), jnp.asarray(v),
                          **kw_j)
    got = T.sample_atlas(tt, torch.as_tensor(tid), torch.as_tensor(u),
                         torch.as_tensor(v), **kw_t)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    assert np.all(np.asarray(ref[0])[tid < 0] == 1.0)


def test_lod_selects_the_reference_mip_level():
    """The integrator's LOD (log2 of the ray footprint in texels) and the
    level it selects: the same integer on every lane, the LOD within 1e-6
    (relative where |lod| > 1)."""
    rng = np.random.default_rng(7)
    n = 100000
    t = np.exp(rng.uniform(-3.0, 6.0, n)).astype(np.float32)
    cos_v = rng.uniform(0.0, 1.0, n).astype(np.float32)
    base = rng.uniform(-4.0, 8.0, n).astype(np.float32)
    spread = float(np.float32(2.0) * np.float32(0.9) / np.float32(1080))
    lod_j = np.asarray(jnp.asarray(base) + jnp.log2(
        jnp.maximum(jnp.asarray(t) * spread, 1e-8)
        / jnp.maximum(jnp.asarray(cos_v), 0.05)))
    lod_t = (torch.as_tensor(base) + torch.log2(
        torch.clamp(torch.as_tensor(t) * spread, min=1e-8)
        / torch.clamp(torch.as_tensor(cos_v), min=0.05))).numpy()
    lvl_j = np.clip(lod_j, 0.0, T.MAX_LEVELS - 1.0).astype(np.int32)
    lvl_t = torch.clamp(torch.as_tensor(lod_t), 0.0, T.MAX_LEVELS - 1.0).to(
        torch.int32).numpy()
    assert np.array_equal(lvl_t, lvl_j)
    np.testing.assert_allclose(lod_t, lod_j, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def content_packs():
    scene = content_scene(16, 16, 3, nx=3, nz=3, n_cards=12)
    js = convert_scene(scene, "luminary_tpu")
    geo = JD.pack_geometry(js)
    mats = JD.pack_materials(js)
    lights = JD.pack_lights_for(geo, mats, scene=js)
    hot, aux, micro = JD.pack_shade_packed(
        geo, mats, lights, tex_res=JT.page_resolutions(js.textures))
    hg = D.pack_geometry_np(scene)
    mt = D.materials_np(scene)
    lt = D.pack_lights_for(hg, mt, scene=scene)
    return dict(scene=scene, js=js, geo=geo, mats=mats, lights=lights,
                aux=aux, micro=micro, hg=hg, mt=mt, lt=lt)


def test_aux_table_matches_reference_bit_for_bit(content_packs):
    c = content_packs
    p = c["hg"].material_id.shape[0]
    got = D.pack_shade_aux(c["hg"], c["mt"], T.page_resolutions(c["scene"].textures))
    ref = D.unpack_reference_shade_rows(np.asarray(c["aux"]), p)
    assert got.shape == (p, D.SHA_COLS)
    assert np.array_equal(got, ref)
    assert (got[:, D.SHA_TEX_AR] != -1).any()  # textured slots in the table


def test_emission_importance_matches_reference(content_packs):
    c = content_packs
    mult_j, cells_j = JD._emission_tex_means(c["js"], c["geo"], c["mats"])
    mult_t, cells_t = D._emission_tex_means(c["scene"], c["hg"], c["mt"])
    np.testing.assert_allclose(mult_t, mult_j, rtol=1e-6)
    np.testing.assert_allclose(cells_t, cells_j, rtol=1e-6)
    lj, lt = c["lights"], c["lt"]
    assert lt["has_micro"] and lj.has_micro
    np.testing.assert_allclose(lt["select_pdf"], np.asarray(lj.select_pdf), rtol=1e-6)
    np.testing.assert_allclose(lt["micro_rows"], np.asarray(lj.micro_rows), rtol=1e-6)
    rows_t = D.pack_light_slot_rows(c["hg"], c["mt"], lt)
    rows_j = JD.pack_light_slot_rows(c["geo"], c["mats"], lj)
    assert rows_t.shape == rows_j.shape == (lt["num_lights"], D.LSR_FUSED_MICRO_COLS)
    np.testing.assert_allclose(rows_t, rows_j, rtol=1e-6)
    np.testing.assert_allclose(D.pack_shade_micro(c["hg"], lt),
                               np.asarray(c["micro"]), rtol=1e-6)


def test_textured_32_sample_matches_reference():
    """One sample of the textured_32 golden scene (a checker albedo with mip
    LOD on the sun plane: per-field gathers, no aux row) against the JAX
    integrator on the same pack, within RMSE/scale 1e-4.

    The golden itself is not held here: the JAX package's own 64-sample
    render of this scene reads RMSE/scale 0.049 against
    ``tests/golden/textured_32_64spp.npy``, the port's 0.049 too."""
    scene = textured_scene()
    r = Renderer(scene, device="cpu")
    ds = jax_device_scene(convert_scene(scene, "luminary_tpu"), r.device_scene)
    from luminary_tpu.ops.camera import pack_camera

    n = 32 * 32
    px, py = r._px[:n].numpy(), r._py[:n].numpy()
    ref, _, rays_j = jax_render(ds, jax.device_put(pack_camera(
        convert_scene(scene, "luminary_tpu").camera)), jax_config(r.config, n),
        px, py, np.uint32(0))
    got, _, rays_t = render_sample(r.device_scene, r.device_camera, r.config,
                                   torch.as_tensor(px), torch.as_tensor(py), 0)
    ref = np.asarray(ref)
    scale = float(np.abs(ref).mean())
    assert np.sqrt(np.mean((got.numpy() - ref) ** 2)) / scale < 1e-4
    assert float(rays_t) == float(rays_j)
