"""The optics slice as a whole against the JAX integrator: one 16x16
render (depth 3, 2 samples, 512 lanes) with every feature of the slice on
at once — a moving particle field (kernel B's plain walk on the particle
BVH), spectral rendering under the DEFAULT sky's 8-band bake, the physical
lens camera, the wavefront sort — over a scene with an emitter (light NEE
with RIS) and a dispersive glass sphere (the hero collapse). The JAX
``render_sample`` runs without jit (its walks jitted) on a DeviceScene
built around the port's sky tables, with the JAX package's own particle
pack and lens.

Held: every lane within 1e-4 of the image's scale (mean |radiance|),
except lanes whose lens trace took another threshold decision (clear
aperture or TIR, compared through both packages' lens rays: at most 2,
0 measured, counted in the assertion); the same rays traced; the primary
gbuffer's instance ids equal, particles among them.

Also the carry-across (``from_jax_arrays``) of a JAX pack with a particle
field, the 8-band sky tables and a lens: those tables word for word equal
to the port's own pack.
"""

import numpy as np
import torch

import jax

from luminary_tpu.ops import camera_physical as JCP
from luminary_tpu.ops import textures as JT
from luminary_tpu.ops.camera import pack_camera as j_pack_camera
from luminary_tpu.render import device_scene as JD
from luminary_tpu_torch.ops.camera_physical import generate_physical_camera_rays
from luminary_tpu_torch.ops.procedural import PARTICLES_INSTANCE_ID
from luminary_tpu_torch.render.renderer import Renderer
from luminary_tpu_torch.render.wavefront import render_sample
from luminary_tpu_torch.scene.entities import Material, MaterialBaseSubstrate
from luminary_tpu_torch.scene.mesh import Mesh
from luminary_tpu_torch.testing import _add_mesh, _uv_sphere, sun_plane_scene
from test_torch_textures import convert_scene, jax_render

torch.set_num_threads(1)

W = H = 16
SPP = 2
MAX_OTHER_DECISION = 2


def optics_test_scene():
    s = sun_plane_scene(W, H)
    s.add_material(Material(albedo=(1.0, 1.0, 1.0, 1.0), roughness=0.02,
                            base_substrate=MaterialBaseSubstrate.TRANSLUCENT,
                            refraction_index=1.5, abbe=20.0))
    s.add_material(Material(albedo=(0.0, 0.0, 0.0, 1.0),
                            emission=(6.0, 5.0, 4.0), emission_active=True))
    for i, (x, z, mat) in enumerate(((0.0, -5.0, 1), (2.5, -4.0, 0),
                                     (-2.2, -4.5, 2))):
        v, t = _uv_sphere(x, 0.9, z, 0.8)
        _add_mesh(s, Mesh(vertices=v, triangles=t,
                          material_ids=np.full(len(t), mat, np.uint16),
                          name="s%d" % i))
    st = s.get_entity("settings")
    st.spectral_rendering = True
    st.wavefront_sorting = True
    s.set_entity("settings", st)
    cam = s.get_entity("camera")
    cam.use_physical_camera = True
    cam.physical.focal_length = 0.05
    cam.physical.image_plane_distance = 0.055
    cam.physical.aperture_diameter = 0.01
    s.set_entity("camera", cam)
    p = s.get_entity("particles")
    p.active = True
    p.count = 500
    p.scale = 8.0
    p.size = 30.0
    p.speed = 1.5
    s.set_entity("particles", p)
    return s


def jax_optics_scene(js, ds):
    """The JAX DeviceScene of ``js`` around the port's sky tables (8-band
    bake included), with the JAX package's particle pack."""
    from luminary_tpu.ops.clouds import pack_clouds
    from luminary_tpu.ops.volume import pack_fog, pack_water

    geo = JD.pack_geometry(js)
    mats = JD.pack_materials(js)
    lights = JD.pack_lights_for(geo, mats, scene=js)
    hot, aux, micro = JD.pack_shade_packed(
        geo, mats, lights, tex_res=JT.page_resolutions(js.textures))
    k = ds.sky

    def f32(v):
        return np.asarray(v, np.float32)

    sky = JD.DeviceSky(
        mode=np.int32(k.mode), constant_color=f32(k.constant_color),
        sun_dir=f32(k.sun_dir), sun_strength=np.float32(js.sky.sun_strength),
        env_rows=f32(k.env_rows), env_h=np.int32(k.env_h),
        env_w=np.int32(k.env_w), env_alias_rows=f32(k.env_alias_rows),
        env_cell_pdf=f32(k.env_cell_pdf), env_ch=np.int32(k.env_ch),
        env_cw=np.int32(k.env_cw), env_nee_total=np.float32(k.env_nee_total),
        env_spec_rows=f32(k.env_spec_rows), env_spec_h=np.int32(k.env_spec_h),
        env_spec_w=np.int32(k.env_spec_w), sun_disc_spec=f32(k.sun_disc_spec),
        aerial_rows=f32(k.aerial_rows),
        sun_disc_radiance=f32(k.sun_disc_radiance),
        geometry_offset=f32(js.sky.geometry_offset), moon_dir=f32(k.moon_dir),
        moon_tex_offset=f32(k.moon_tex_offset),
        stars_seed=np.int32(k.stars_seed), stars_count=np.int32(k.stars_count),
        stars_intensity=f32(k.stars_intensity))
    return jax.device_put(JD.DeviceScene(
        geo=geo, materials=mats, sky=sky, lights=lights, fog=pack_fog(js.fog),
        water=pack_water(js.ocean), textures=JT.pack_textures(js.textures),
        clouds=pack_clouds(js.cloud), shade_hot=hot, shade_aux=aux,
        shade_micro=micro,
        light_slot_rows=JD.pack_light_slot_rows(geo, mats, lights),
        particles=JD.pack_particles_device(js.particles)))


def test_optics_slice_matches_reference():
    scene = optics_test_scene()
    r = Renderer(scene, device="cpu")
    ds, c = r.device_scene, r.config
    assert (c.use_particles and c.spectral and c.use_physical_camera
            and c.sort_wavefront and c.shading_mode == 0)
    assert c.particle_mat_id == 3 and ds.particles.bvh.tri_v0.x.shape[0] > 128
    assert ds.sky.env_spec_rows.shape[0] > 1 and ds.lights.num_lights > 0
    js = convert_scene(scene, "luminary_tpu")
    jcam = jax.device_put(j_pack_camera(js.camera))
    n = W * H * SPP
    px = np.tile(np.arange(W * H) % W, SPP).astype(np.int32)
    py = np.tile(np.arange(W * H) // W, SPP).astype(np.int32)
    sid = np.repeat(np.arange(SPP), W * H).astype(np.uint32)
    from luminary_tpu.render.wavefront import RenderConfig as JRC

    ref, gb_j, rays_j = jax_render(jax_optics_scene(js, ds), jcam,
                                   JRC(chunk=n, **c._asdict()), px, py, sid)
    pxt, pyt = torch.as_tensor(px), torch.as_tensor(py)
    sidt = torch.as_tensor(sid.astype(np.int64))
    got, gb_t, rays_t = render_sample(ds, r.device_camera, c, pxt, pyt, sidt)
    # the lens's alive decisions of both packages, lane for lane
    pid = pyt.to(torch.int64) * W + pxt
    _o, _d, w_t = generate_physical_camera_rays(
        r.device_camera, r.device_camera.phys, W, H, pxt, pyt, pid, sidt)
    alive_t = sum(x.abs() for x in w_t) > 0
    _oj, _dj, wj = JCP.generate_physical_camera_rays(
        jcam, jcam.phys, W, H, jax.numpy.asarray(px), jax.numpy.asarray(py),
        jax.numpy.asarray(pid.numpy().astype(np.uint32)), jax.numpy.asarray(sid))
    alive_j = sum(np.abs(np.asarray(x)) for x in wj) > 0
    other = alive_t.numpy() != alive_j
    assert other.sum() <= MAX_OTHER_DECISION, int(other.sum())
    assert 0.3 < alive_j.mean() < 1.0  # the lens vignettes some lanes
    ref, got = np.asarray(ref), got.numpy()
    scale = float(np.abs(ref).mean())
    assert np.isfinite(got).all() and scale > 0.0
    diff = np.abs(got - ref).max(axis=-1)
    assert float(diff[~other].max()) <= 1e-4 * scale, float(diff.max() / scale)
    assert float(rays_t) == float(rays_j)
    ids = gb_t.instance_id.numpy()
    assert np.array_equal(ids, np.asarray(gb_j.instance_id))
    assert (ids == PARTICLES_INSTANCE_ID).any() and (ids == 0).any()


def test_from_jax_arrays_carries_the_optics():
    """A JAX pack with a particle field, the 8-band sky tables and a lens,
    carried across (``from_jax_arrays``), equals the port's own pack of the
    same scene in those tables, word for word."""
    from test_torch_pack import jax_scene_tree, same_words

    from luminary_tpu_torch.render.device_scene import from_jax_arrays

    scene = optics_test_scene()
    r = Renderer(scene, device="cpu")
    ds, cam = r.device_scene, r.device_camera
    js = convert_scene(scene, "luminary_tpu")
    tree = jax_scene_tree(jax_optics_scene(js, ds),
                          jax.device_put(j_pack_camera(js.camera)))
    carried, ccam = from_jax_arrays(tree, "cpu")
    a, b = carried.particles, ds.particles
    assert same_words(a.bvh.rows.numpy(), b.bvh.rows.numpy())
    for name in ("tri_v0", "tri_e1", "tri_e2"):
        for x, y in zip(getattr(a.bvh, name), getattr(b.bvh, name)):
            assert same_words(x.numpy(), y.numpy()), name
    assert (a.bvh.depth, a.bvh.num_nodes) == (b.bvh.depth, b.bvh.num_nodes)
    assert (a.scale, a.motion, a.albedo) == (b.scale, b.motion, b.albedo)
    for name in ("env_spec_rows", "sun_disc_spec"):
        assert same_words(getattr(carried.sky, name).numpy(),
                          getattr(ds.sky, name).numpy()), name
    assert (carried.sky.env_spec_h, carried.sky.env_spec_w) == (
        ds.sky.env_spec_h, ds.sky.env_spec_w)
    for name in type(cam.phys)._fields:
        assert torch.equal(getattr(ccam.phys, name), getattr(cam.phys, name)), name
