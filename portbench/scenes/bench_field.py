"""The bench field: nx x nz UV spheres on a ground plane under the sun and
the DEFAULT sky, optionally at sea under the low and mid cloud layers.

The benchmark's own copy of the recipe of ``benchmark_scene`` and
``outdoor_scene``. The seed draws each sphere's radius and the material of
every sphere that is not a lamp; the counts stay fixed: 16 x 11 x 2 = 352
triangles a sphere, every 23rd sphere a lamp, the ground two triangles.

``build(api, params, seed)`` makes the scene's plain arrays and hands them
to ``api``, a module with the scene classes of the port's public API
(``Scene``, ``Material``, ``Mesh``, ``SkyMode``): the program's, or the
reference's frozen copy of them.
"""

from __future__ import annotations

import numpy as np

NU, NV = 16, 12
SPACING = 2.5
LAMP_EVERY = 23
MATERIALS = (
    dict(albedo=(0.75, 0.71, 0.68, 1.0), roughness=0.8),   # matte
    dict(albedo=(0.9, 0.6, 0.3, 1.0), roughness=0.25, metallic=True),  # copper
    dict(albedo=(0.95, 0.95, 0.95, 1.0), roughness=0.05, metallic=True),  # mirror
    dict(albedo=(0.2, 0.4, 0.8, 1.0), roughness=0.4),      # blue
    dict(albedo=(0.0, 0.0, 0.0, 1.0), emission=(8.0, 7.0, 5.0),
         emission_active=True),                            # lamp
    dict(albedo=(0.5, 0.52, 0.5, 1.0), roughness=0.9),     # ground
)
LAMP, GROUND = 4, 5


def _uv_template():
    """The angles' products of a UV sphere (float64 [NU * NV] each) and its
    triangles (int32 [352, 3])."""
    u = np.linspace(0, 2 * np.pi, NU, endpoint=False)
    v = np.linspace(1e-3, np.pi - 1e-3, NV)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    i = np.arange(NU)[:, None]
    j = np.arange(NV - 1)[None, :]
    a = i * NV + j
    b = ((i + 1) % NU) * NV + j
    tris = np.stack([np.stack([a, b, a + 1], -1),
                     np.stack([b, b + 1, a + 1], -1)], 2)
    return (np.cos(uu).ravel(), np.sin(vv).ravel(), np.cos(vv).ravel(),
            np.sin(uu).ravel(), tris.reshape(-1, 3).astype(np.int32))


def field_arrays(nx: int, nz: int, seed: int):
    """(vertices f32 [V, 3], triangles i32 [T, 3], material ids u16 [T])."""
    rng = np.random.default_rng(np.random.SeedSequence(int(seed) % (1 << 64)))
    n = nx * nz
    radii = rng.uniform(0.5, 1.1, n)
    picks = rng.integers(0, 4, n)
    cu, sv, cv, su, tris = _uv_template()
    k = np.arange(n)
    gx, gz = np.divmod(k, nz)
    r = radii[:, None]
    # per sphere as the port's recipe: centre + r * cos(u) * sin(v), ...
    x = gx[:, None] * SPACING + r * cu * sv
    y = r + r * cv
    z = gz[:, None] * SPACING + r * su * sv
    verts = np.stack([x, y, z], -1).astype(np.float32).reshape(-1, 3)
    nv = NU * NV
    tris_all = (tris[None] + (k * nv)[:, None, None]).reshape(-1, 3).astype(np.int32)
    mat = np.where(k % LAMP_EVERY == 0, LAMP, picks).astype(np.uint16)
    mats = np.repeat(mat, len(tris))
    ground = np.asarray(
        [(-10, 0, -10), (nx * SPACING + 10, 0, -10),
         (nx * SPACING + 10, 0, nz * SPACING + 10), (-10, 0, nz * SPACING + 10)],
        np.float32)
    return (np.concatenate([verts, ground]),
            np.concatenate([tris_all,
                            np.asarray([[0, 1, 2], [0, 2, 3]], np.int32) + n * nv]),
            np.concatenate([mats, np.full(2, GROUND, np.uint16)]))


def build(api, params: dict, seed: int):
    """The scene of ``params`` (``width``, ``height``, ``max_depth``, ``nx``,
    ``nz``; ``ocean``, ``clouds``, ``sky_mode``) for ``seed``."""
    nx, nz = int(params["nx"]), int(params["nz"])
    scene = api.Scene()
    for m in MATERIALS:
        scene.add_material(api.Material(**m))
    verts, tris, mats = field_arrays(nx, nz, seed)
    mesh = api.Mesh(vertices=verts, triangles=tris, material_ids=mats,
                    name="bench_field")
    scene.add_mesh(mesh)
    inst = scene.new_instance()
    inst.mesh_id = mesh.id
    scene.set_instance(inst)

    settings = scene.get_entity("settings")
    settings.width = int(params["width"])
    settings.height = int(params["height"])
    settings.max_ray_depth = int(params["max_depth"])
    scene.set_entity("settings", settings)

    cam = scene.get_entity("camera")
    mid = nx * SPACING / 2
    cam.pos = (mid - 14.0, 9.0, mid - 14.0)
    cam.rotation = (-0.28, np.pi + np.pi / 4, 0.0)
    cam.thin_lens.fov = 0.9
    scene.set_entity("camera", cam)

    sky = scene.get_entity("sky")
    sky.azimuth = 1.0
    sky.altitude = 0.6
    sky.mode = api.SkyMode(int(params.get("sky_mode", 0)))
    scene.set_entity("sky", sky)

    if params.get("ocean"):
        oc = scene.get_entity("ocean")
        oc.active = True
        oc.height = 0.7
        oc.caustics_active = True
        scene.set_entity("ocean", oc)
    if params.get("clouds"):
        cl = scene.get_entity("cloud")
        cl.active = True
        cl.low.active = True
        cl.mid.active = True
        scene.set_entity("cloud", cl)
    return scene
