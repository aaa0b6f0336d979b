"""Package rules of the port: it imports no JAX and nothing of the JAX
package; its entry points run on the card unless asked for the CPU; the
features once refused (the physical camera, spectral rendering, particles,
the wavefront sort, debug shading, and scene content before them) pack and
render, their RenderConfig set as the reference's Renderer sets it."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from luminary_tpu_torch.render.renderer import Renderer
from luminary_tpu_torch.scene.entities import (
    MaterialBaseSubstrate,
    ShadingMode,
    SkyMode,
)
from luminary_tpu_torch.scene.mesh import Texture
from luminary_tpu_torch.testing import cornell_scene, sun_plane_scene

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_jax_out():
    code = (
        "import sys, luminary_tpu_torch\n"
        "import luminary_tpu_torch.render.renderer, luminary_tpu_torch.kernels\n"
        "import luminary_tpu_torch.testing\n"
        "import luminary_tpu_torch.tools.proto_gather\n"
        "import luminary_tpu_torch.tools.proto_gather2\n"
        "import luminary_tpu_torch.tools.microbench_colext\n"
        "import luminary_tpu_torch.tools.time_render\n"
        "import luminary_tpu_torch.ops.libm\n"
        "import luminary_tpu_torch.io, luminary_tpu_torch.io.qoi\n"
        "import luminary_tpu_torch.io.lum_v5\n"
        "import luminary_tpu_torch.host.host\n"
        "import luminary_tpu_torch.parallel.mesh\n"
        "import luminary_tpu_torch.host.queue_worker\n"
        "import luminary_tpu_torch.frontend.cli\n"
        "import luminary_tpu_torch.frontend.benchmark\n"
        "import luminary_tpu_torch.frontend.properties\n"
        "import luminary_tpu_torch.frontend.viewer\n"
        "import luminary_tpu_torch.tools.compare\n"
        "import luminary_tpu_torch.utils.profiling\n"
        "import luminary_tpu_torch.ops.post, luminary_tpu_torch.ops.tonemap\n"
        "import luminary_tpu_torch.render.adaptive\n"
        "import luminary_tpu_torch.ops.textures, luminary_tpu_torch.ops.volume\n"
        "import luminary_tpu_torch.ops.bridges\n"
        "import luminary_tpu_torch.ops.clouds, luminary_tpu_torch.ops.ocean\n"
        "import luminary_tpu_torch.ops.caustics\n"
        "import luminary_tpu_torch.ops.procedural\n"
        "import luminary_tpu_torch.ops.phase, luminary_tpu_torch.ops.spectral\n"
        "import luminary_tpu_torch.ops.camera_physical\n"
        "import luminary_tpu_torch.ops.wavefront_utils\n"
        # python -m luminary_tpu_torch --help: runs __main__ and the CLI
        "import contextlib, io, runpy\n"
        "sys.argv = ['luminary_tpu_torch', '--help']\n"
        "with contextlib.redirect_stdout(io.StringIO()) as f:\n"
        "    try:\n"
        "        runpy.run_module('luminary_tpu_torch', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, e.code\n"
        "assert '--device' in f.getvalue()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'luminary_tpu' or m.startswith('luminary_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("entry", ["Renderer", "pack_scene", "pack_camera"])
def test_renderer_without_device_needs_a_card(monkeypatch, entry):
    """No device argument means the card; without one an entry point raises
    instead of falling back to the CPU."""
    from luminary_tpu_torch.ops.camera import pack_camera
    from luminary_tpu_torch.render.device_scene import pack_scene

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = cornell_scene(8, 8)
    call = {"Renderer": lambda: Renderer(scene),
            "pack_scene": lambda: pack_scene(scene),
            "pack_camera": lambda: pack_camera(scene.camera)}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


@pytest.mark.parametrize("asked, index", [("cuda", 3), ("cuda:1", 1)])
def test_explicit_cuda_device_gets_an_index(monkeypatch, asked, index):
    """An explicit "cuda" resolves to the current card's index, so that the
    asynchronous Host's worker thread can make it its current device."""
    from luminary_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert resolve_device(asked) == torch.device("cuda", index)
    assert resolve_device("cpu") == torch.device("cpu")


def _with(setting):
    def make():
        s = cornell_scene(8, 8)
        setting(s)
        return s
    return make


def _settings(**kw):
    def f(s):
        st = s.get_entity("settings")
        for k, v in kw.items():
            setattr(st, k, v)
        s.set_entity("settings", st)
    return f


def _entity(name, **kw):
    def f(s):
        e = s.get_entity(name)
        for k, v in kw.items():
            setattr(e, k, v)
        s.set_entity(name, e)
    return f


def _textures(s):
    s.add_texture(Texture(data=np.zeros((4, 4, 4), np.uint8)))


def _aux_texture(s):
    m = s.get_material(0)
    m.roughness_tex = 0
    s.set_material(m)


def _clouds(s):
    sky = s.get_entity("sky")
    sky.mode = SkyMode.DEFAULT
    s.set_entity("sky", sky)
    cl = s.get_entity("cloud")
    cl.active = True
    cl.low.active = True
    s.set_entity("cloud", cl)


def _caustics(s):
    oc = s.get_entity("ocean")
    oc.active = True
    oc.caustics_active = True
    s.set_entity("ocean", oc)
    sky = s.get_entity("sky")
    sky.mode = SkyMode.DEFAULT
    s.set_entity("sky", sky)


def _outdoor(*settings):
    """The sun plane at 8x8 (open sky) with the ocean's surface 0.3 above
    it where an ocean is set."""
    def make():
        s = sun_plane_scene(8, 8)
        _entity("ocean", height=0.3)(s)
        for f in settings:
            f(s)
        return s
    return make


def _user_hdri(s):
    env = np.full((32, 64, 3), 0.05, np.float32)
    env[6:12, 20:30] = (40.0, 30.0, 20.0)
    s.set_sky_hdri(env)


def _underwater_camera(s):
    cam = s.get_entity("camera")
    cam.pos = (cam.pos[0], 0.2, cam.pos[2])
    s.set_entity("camera", cam)
    _entity("ocean", active=True, height=1.5, caustics_active=True)(s)


ONCE_REFUSED = {
    "use_physical_camera": _with(_entity("camera", use_physical_camera=True)),
    "spectral": _with(_settings(spectral_rendering=True)),
    "use_particles": _with(_entity("particles", active=True, count=16)),
    "sort_wavefront": _with(_settings(wavefront_sorting=True)),
    "shading_mode": _with(_settings(shading_mode=ShadingMode.ALBEDO)),
}


@pytest.mark.parametrize("flag", sorted(ONCE_REFUSED))
def test_unported_feature_is_refused(flag):
    """The five RenderConfig features the port refused until the optics
    slice now render: one finite sample on the CPU, with the whole
    RenderConfig (the switch among it) as the reference's Renderer sets it
    for the same scene. (The name is kept from the refusal it replaced.)"""
    from luminary_tpu.render.renderer import Renderer as JRenderer
    from test_torch_textures import convert_scene

    scene = ONCE_REFUSED[flag]()
    r = Renderer(scene, device="cpu")
    r.render_samples(1)
    assert np.isfinite(r.get_radiance()).all()
    c = r.config._asdict()
    assert c[flag] == ({"shading_mode": int(ShadingMode.ALBEDO)}.get(flag, True))
    ref = JRenderer(convert_scene(scene, "luminary_tpu")).config._asdict()
    ref.pop("chunk")
    assert c == ref, {k: (c[k], ref[k]) for k in c if c[k] != ref.get(k)}


def _cutout(s):
    m = s.get_material(0)
    m.albedo = (0.73, 0.73, 0.73, 0.5)
    s.set_material(m)


@pytest.mark.parametrize("case", ["translucent_ok"])
def test_scene_level_refusals(case):
    # a supported feature that shares code with refused ones: glass
    s = cornell_scene(8, 8)
    m = s.get_material(0)
    m.base_substrate = MaterialBaseSubstrate.TRANSLUCENT
    s.set_material(m)
    Renderer(s, device="cpu").render_samples(1)


_HDRI = _entity("sky", mode=SkyMode.HDRI, hdri_dim=256)

PORTED_CONTENT = {
    "use_textures": _with(_textures),
    "use_aux_textures": _with(_aux_texture),
    "use_bridges": _with(_entity("fog", active=True)),
    "cutout": _with(_cutout),
    "clouds": _outdoor(_clouds, _entity("cloud", steps=16)),
    "hdri_baked": _outdoor(_HDRI),
    "hdri_user_map": _outdoor(_HDRI, _user_hdri),
    "analytic_ocean": _outdoor(_entity("ocean", active=True)),
    "tessellated_ocean": _outdoor(_entity("ocean", active=True,
                                          tessellated=True)),
    "caustics": _outdoor(_caustics, _entity("ocean", height=0.3)),
    "underwater_camera": _outdoor(_underwater_camera),
}


@pytest.mark.parametrize("case", sorted(PORTED_CONTENT))
def test_scene_content_packs_and_renders(case):
    """Textures, aux texture ids, fog, cutouts, cloud layers, the HDRI sky
    (baked and from a user map, with env NEE), the analytic and tessellated
    ocean, sun caustics and a camera under water, once refused, pack and
    render one finite sample on the CPU."""
    r = Renderer(PORTED_CONTENT[case](), device="cpu")
    r.render_samples(1)
    assert np.isfinite(r.get_radiance()).all()
    c = r.config
    if case == "cutout":
        assert r.device_scene.geo.bvh.has_cutouts
    if case == "use_bridges":
        assert c.use_bridges and r.device_scene.fog.on
    if case == "clouds":
        assert c.use_clouds and c.cloud_layers == (0,)
    if case.startswith("hdri"):
        assert c.env_nee and r.device_scene.sky.env_nee_total > 0.0
        assert not c.aerial
    if case == "hdri_user_map":
        assert r.device_scene.sky.env_h == 32
        assert float(r.device_scene.sky.sun_disc_radiance.abs().sum()) == 0.0
    if case in ("analytic_ocean", "caustics", "underwater_camera"):
        assert c.analytic_ocean and c.water_scatter
        assert c.ocean_mat_id == len(r.scene.materials)
    if case == "tessellated_ocean":
        assert not c.analytic_ocean and c.water_scatter
        assert r.device_scene.geo.material_id.shape[0] > 2 * 128 * 128
    if case in ("caustics", "underwater_camera"):
        assert c.ocean_caustics and c.caustics_k == 8


@pytest.mark.parametrize("feature", ["particles"])
def test_unported_scene_features_still_refused(feature):
    """The pack once refused particles; now a field of 100 quads packs into
    a tile BVH of its own, wide (200 triangles, past the dense tier), and
    its material follows the user's. (The name is kept from the refusal it
    replaced.)"""
    from luminary_tpu_torch.ops.traverse import DENSE_MAX_SLOTS
    from luminary_tpu_torch.render.device_scene import pack_scene

    s = cornell_scene(8, 8)
    _entity("particles", active=True, count=100, albedo=(0.6, 0.5, 0.4))(s)
    ds = pack_scene(s, "cpu")
    bvh = ds.particles.bvh
    assert bvh.tri_v0.x.shape[0] > DENSE_MAX_SLOTS and bvh.num_nodes > 0
    m = len(s.materials)
    assert ds.materials.albedo_r.shape[0] == m + 1
    assert float(ds.materials.albedo_r[m]) == np.float32(0.6)
    assert ds.particles.albedo == tuple(float(np.float32(a))
                                        for a in (0.6, 0.5, 0.4))


def test_cpu_render_launches_no_kernel():
    from luminary_tpu_torch.ops.light_tree import light_tree_descend
    from luminary_tpu_torch.ops.rowops import gather_soa
    from luminary_tpu_torch.ops.traverse import traverse_wide

    before = (gather_soa.launches, traverse_wide.launches,
              light_tree_descend.launches)
    r = Renderer(sun_plane_scene(8, 8), device="cpu")
    r.render_samples(1)
    assert (gather_soa.launches, traverse_wide.launches,
            light_tree_descend.launches) == before


def test_host_and_cli_without_device_need_a_card(monkeypatch, tmp_path):
    """Host() and the CLI without --device want the card and raise on a
    machine without one, before any work."""
    from luminary_tpu_torch.frontend import cli
    from luminary_tpu_torch.host.host import Host
    from luminary_tpu_torch.testing import write_obj_scene

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Host()
    lum = write_obj_scene(cornell_scene(8, 8), str(tmp_path), "box")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main([lum, "-s", "1", "-o", str(tmp_path / "o.png")])
    assert not (tmp_path / "o.png").exists()


@pytest.mark.parametrize("case", ["set_device_enable_without_mesh",
                                  "host_mesh_without_card",
                                  "sample_mesh_without_card",
                                  "host_mesh_over_the_cards",
                                  "pixel_block_not_whole_packets"])
def test_mesh_refusals(monkeypatch, case):
    """The JAX package's refusals on the mesh path, and no fallback: without
    a card neither a mesh Host nor a mesh of every visible card quietly runs
    on the CPU, and a mesh of N cards is not made of shards of fewer."""
    from luminary_tpu_torch.host.host import Host
    from luminary_tpu_torch.parallel.mesh import (
        distributed_sample_step,
        make_grid_mesh,
        make_sample_mesh,
        shard_pixels,
    )
    from luminary_tpu_torch.utils.errors import InvalidAPIArgumentError

    if case == "set_device_enable_without_mesh":
        host = Host(device="cpu")
        with pytest.raises(InvalidAPIArgumentError, match="requires a mesh"):
            host.set_device_enable(0, False)
        assert Host(mesh=1, device="cpu").get_device_count() == 1
    elif case in ("host_mesh_without_card", "sample_mesh_without_card"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Host(mesh=2) if case == "host_mesh_without_card" else make_sample_mesh()
    elif case == "host_mesh_over_the_cards":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        with pytest.raises(ValueError, match="mesh=2 devices requested, 1"):
            Host(mesh=2)
    else:
        mesh = make_grid_mesh(1, 2, ["cpu"] * 2)
        lanes = torch.zeros(96, dtype=torch.int32)  # blocks of 48 lanes
        with pytest.raises(ValueError, match="multiple of 32 lanes"):
            shard_pixels(mesh, lanes)
        step, _ = distributed_sample_step(mesh, None)
        with pytest.raises(ValueError, match="multiple of 32 lanes"):
            step(None, None, lanes, lanes, None, None, 0)
        assert shard_pixels(mesh, lanes[:64])[0].shape == (64,)


def test_adaptive_sampling_is_not_ignored():
    """With enable_adaptive_sampling the port renders adaptively: after the
    uniform stage 0 (2 samples) a 1-sample budget goes where the JAX
    package's allocation on the same accumulators sends it."""
    import jax.numpy as jnp
    import numpy as np

    from luminary_tpu.render.adaptive import allocate_stage_tasks, block_error_map

    s = cornell_scene(16, 16, max_depth=2)
    st = s.get_entity("settings")
    st.enable_adaptive_sampling = True
    s.set_entity("settings", st)
    r = Renderer(s, device="cpu")
    r.render_samples(2)
    acc = [x.numpy().copy() for x in r.accum]
    assert (acc[2][:256] == 2).all()
    r.render_samples(1)
    got = r.accum.sample_count.numpy()[:256]
    assert len(np.unique(got)) > 1, "adaptive sampling was ignored"

    # the JAX allocation: one stage, one 64-lane slice (n_pad // 4) of
    # max(update_interval // 8, 2) = 4 rounds
    err = np.asarray(block_error_map(
        jnp.asarray(acc[0]), jnp.asarray(acc[1]), jnp.asarray(acc[2]), 16, 16,
        bool(st.adaptive_sampling_exposure_aware), jnp.float32(1.0)))
    pix, rank = allocate_stage_tasks(
        err, 16, 16, st.adaptive_sampling_avg_sampling_rate,
        st.adaptive_sampling_max_sampling_rate, budget_tasks=64)
    if pix.size < 64:  # wrapped to a whole slice, as the renderer pads
        pix = np.concatenate([pix] * (-(-64 // pix.size)))
    want = acc[2][:256] + 4 * np.bincount(pix[:64], minlength=256)
    np.testing.assert_array_equal(got, want)
