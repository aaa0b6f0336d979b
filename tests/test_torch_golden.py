"""Port renders of three golden scenes at 64 spp on the CPU against
``tests/golden/*.npy``, at the bound of ``tests/test_golden.py`` (RMSE/scale
< 0.02: identical random streams leave only float-reassociation noise).

cornell_32: GGX + area-light NEE + MIS, constant sky, dense tier;
sun_plane_32: sun NEE with sun RIS, baked DEFAULT sky, aerial perspective;
emitter_field_32: 98 emitters, so the light tree drives RIS candidate 0.
"""

import os

import numpy as np
import pytest
import torch

from luminary_tpu_torch.render.renderer import Renderer
from luminary_tpu_torch.scene.entities import Material, SkyMode
from luminary_tpu_torch.scene.mesh import Mesh
from luminary_tpu_torch.scene.scene import Scene
from luminary_tpu_torch.testing import cornell_scene, sun_plane_scene

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
SPP = 64


def _emitter_field_scene(width=32, height=32, n_emit=7, ris_k=4):
    """tests/test_lights.py::_emitter_field_scene, built with the port's
    scene classes."""
    scene = Scene()
    scene.add_material(Material(albedo=(0.7, 0.7, 0.7, 1.0), roughness=1.0))
    verts = [(-8, 0, -8), (8, 0, -8), (8, 0, 8), (-8, 0, 8)]
    tris = [[0, 1, 2], [0, 2, 3]]
    mat_ids = [0, 0]
    rng = np.random.default_rng(3)
    for i in range(n_emit):
        for j in range(n_emit):
            mid = len(scene.materials)
            power = float(rng.uniform(0.5, 40.0))
            scene.add_material(Material(
                albedo=(0, 0, 0, 1),
                emission=(power, power * 0.9, power * 0.7),
                emission_active=True))
            cx = -6 + 12 * i / max(n_emit - 1, 1)
            cz = -6 + 12 * j / max(n_emit - 1, 1)
            s = 0.25
            base = len(verts)
            verts += [(cx - s, 3.0, cz - s), (cx + s, 3.0, cz - s),
                      (cx + s, 3.0, cz + s), (cx - s, 3.0, cz + s)]
            tris += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
            mat_ids += [mid, mid]
    mesh = Mesh(vertices=np.asarray(verts, np.float32),
                triangles=np.asarray(tris, np.int32),
                material_ids=np.asarray(mat_ids, np.uint16),
                name="emitter_field")
    scene.add_mesh(mesh)
    inst = scene.new_instance()
    inst.mesh_id = mesh.id
    scene.set_instance(inst)
    settings = scene.get_entity("settings")
    settings.width = width
    settings.height = height
    settings.max_ray_depth = 2
    settings.light_ris_candidates = ris_k
    scene.set_entity("settings", settings)
    cam = scene.get_entity("camera")
    cam.pos = (0.0, 5.0, 0.0)
    cam.rotation = (-np.pi / 2, 0.0, 0.0)
    scene.set_entity("camera", cam)
    sky = scene.get_entity("sky")
    sky.mode = SkyMode.CONSTANT_COLOR
    sky.constant_color = (0.0, 0.0, 0.0)
    scene.set_entity("sky", sky)
    return scene


SCENES = {
    "cornell_32": lambda: cornell_scene(32, 32, max_depth=4),
    "sun_plane_32": lambda: sun_plane_scene(32, 32),
    "emitter_field_32": _emitter_field_scene,
}


def rmse_over_scale(name: str, img: np.ndarray) -> float:
    """RMSE of a [H, W, 3] render against ``tests/golden/<name>_64spp.npy``
    over the golden's mean absolute value."""
    ref = np.load(os.path.join(GOLDEN_DIR, f"{name}_{SPP}spp.npy")).astype(np.float32)
    assert img.shape == ref.shape and np.isfinite(img).all(), (img.shape, ref.shape)
    rmse = float(np.sqrt(np.mean((img - ref) ** 2)))
    return rmse / (float(np.abs(ref).mean()) + 1e-6)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_port_render_matches_golden(name):
    scene = SCENES[name]()
    r = Renderer(scene, chunk=1 << 20, device="cpu")
    if name == "emitter_field_32":
        assert r.device_scene.lights.has_tree
    r.render_samples(SPP)
    rel = rmse_over_scale(name, r.get_radiance())
    assert rel < 0.02, (name, rel)
    assert r.sample_count == SPP
    assert r._last_rays_per_sample > 0
