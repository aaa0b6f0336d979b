"""Procedural test scenes (Cornell box etc.) used by tests and benchmarks.

The reference relies on external .obj/.lum assets for testing; we ship
generators so the test pyramid is hermetic.
"""

from __future__ import annotations

import numpy as np

from .scene.entities import Camera, Material, MaterialBaseSubstrate, SkyMode
from .scene.mesh import Mesh
from .scene.scene import Scene


def _quad(a, b, c, d):
    """Two triangles for quad a-b-c-d (counter-clockwise)."""
    return [[a, b, c], [a, c, d]]


def cornell_box_mesh() -> tuple[Mesh, list[Material]]:
    """The classic box: white floor/ceiling/back, red left, green right,
    an area light in the ceiling, and two interior boxes."""
    verts = []
    tris = []
    mats = []
    mat_ids = []

    def add_quad(p0, p1, p2, p3, mat):
        base = len(verts)
        verts.extend([p0, p1, p2, p3])
        tris.extend(_quad(base, base + 1, base + 2, base + 3))
        mat_ids.extend([mat, mat])

    WHITE, RED, GREEN, LIGHT = 0, 1, 2, 3
    # Room (2x2x2, open toward +Z camera): y up
    add_quad((-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1), WHITE)  # floor
    add_quad((-1, 2, 1), (1, 2, 1), (1, 2, -1), (-1, 2, -1), WHITE)  # ceiling
    add_quad((-1, 0, -1), (-1, 2, -1), (1, 2, -1), (1, 0, -1), WHITE)  # back
    add_quad((-1, 0, 1), (-1, 2, 1), (-1, 2, -1), (-1, 0, -1), RED)  # left
    add_quad((1, 0, -1), (1, 2, -1), (1, 2, 1), (1, 0, 1), GREEN)  # right
    # Ceiling light (wound so the face normal points down into the room —
    # emitters are one-sided like the reference's default)
    add_quad((-0.3, 1.98, -0.3), (0.3, 1.98, -0.3), (0.3, 1.98, 0.3), (-0.3, 1.98, 0.3), LIGHT)

    # Tall box
    def add_box(cx, cz, w, h, angle, mat):
        c, s = np.cos(angle), np.sin(angle)

        def rot(x, z):
            return (cx + x * c - z * s, cz + x * s + z * c)

        corners = [rot(-w, -w), rot(w, -w), rot(w, w), rot(-w, w)]
        # sides
        for i in range(4):
            (x0, z0), (x1, z1) = corners[i], corners[(i + 1) % 4]
            add_quad((x0, 0, z0), (x0, h, z0), (x1, h, z1), (x1, 0, z1), mat)
        # top
        (x0, z0), (x1, z1), (x2, z2), (x3, z3) = corners
        add_quad((x0, h, z0), (x1, h, z1), (x2, h, z2), (x3, h, z3), mat)

    add_box(-0.35, -0.35, 0.3, 1.2, 0.3, WHITE)
    add_box(0.4, 0.35, 0.28, 0.6, -0.25, WHITE)

    mesh = Mesh(
        vertices=np.asarray(verts, np.float32),
        triangles=np.asarray(tris, np.int32),
        material_ids=np.asarray(mat_ids, np.uint16),
        name="cornell_box",
    )
    mats = [
        Material(albedo=(0.73, 0.73, 0.73, 1.0), roughness=1.0),
        Material(albedo=(0.65, 0.05, 0.05, 1.0), roughness=1.0),
        Material(albedo=(0.12, 0.45, 0.15, 1.0), roughness=1.0),
        Material(
            albedo=(0.0, 0.0, 0.0, 1.0),
            emission=(15.0, 15.0, 15.0),
            emission_active=True,
        ),
    ]
    return mesh, mats


def cornell_scene(width: int = 64, height: int = 64, max_depth: int = 4) -> Scene:
    scene = Scene()
    mesh, mats = cornell_box_mesh()
    for m in mats:
        scene.add_material(m)
    scene.add_mesh(mesh)
    inst = scene.new_instance()
    inst.mesh_id = mesh.id
    scene.set_instance(inst)

    settings = scene.get_entity("settings")
    settings.width = width
    settings.height = height
    settings.max_ray_depth = max_depth
    scene.set_entity("settings", settings)

    cam = scene.get_entity("camera")
    cam.pos = (0.0, 1.0, 3.5)
    cam.rotation = (0.0, 0.0, 0.0)  # camera space looks down -Z → into the box
    cam.thin_lens.fov = 0.35
    cam.exposure = 1.0
    scene.set_entity("camera", cam)

    sky = scene.get_entity("sky")
    sky.mode = SkyMode.CONSTANT_COLOR
    sky.constant_color = (0.0, 0.0, 0.0)
    scene.set_entity("sky", sky)
    return scene


def sun_plane_scene(width: int = 64, height: int = 64) -> Scene:
    """A ground plane under the procedural sky — exercises sun NEE + sky."""
    scene = Scene()
    scene.add_material(Material(albedo=(0.5, 0.5, 0.5, 1.0), roughness=1.0))
    verts = np.asarray(
        [(-50, 0, -50), (50, 0, -50), (50, 0, 50), (-50, 0, 50)], np.float32
    )
    tris = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    mesh = Mesh(vertices=verts, triangles=tris, name="ground")
    scene.add_mesh(mesh)
    inst = scene.new_instance()
    inst.mesh_id = mesh.id
    scene.set_instance(inst)

    settings = scene.get_entity("settings")
    settings.width = width
    settings.height = height
    settings.max_ray_depth = 3
    scene.set_entity("settings", settings)

    cam = scene.get_entity("camera")
    cam.pos = (0.0, 2.0, 0.0)
    cam.rotation = (-0.3, 0.0, 0.0)
    scene.set_entity("camera", cam)
    return scene

def _uv_sphere(cx, cy, cz, r, nu=16, nv=12):
    u = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    v = np.linspace(1e-3, np.pi - 1e-3, nv)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    x = cx + r * np.cos(uu) * np.sin(vv)
    y = cy + r * np.cos(vv)
    z = cz + r * np.sin(uu) * np.sin(vv)
    verts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    tris = []
    for i in range(nu):
        for j in range(nv - 1):
            a = i * nv + j
            b = ((i + 1) % nu) * nv + j
            tris += [[a, b, a + 1], [b, b + 1, a + 1]]
    return verts, np.asarray(tris, np.int32)


def benchmark_scene(
    width: int = 1920,
    height: int = 1080,
    max_depth: int = 4,
    nx: int = 19,
    nz: int = 19,
) -> Scene:
    """The tree-tier benchmark: a ~130k-triangle sphere field on a ground
    plane with mixed GGX materials (diffuse/rough-metal/mirror/emissive)
    under the procedural sun + sky — an `Example.lum`-class scene
    (BASELINE.md configs 2/4) exercising the wide-BVH traversal, NEE + MIS,
    and the atmosphere, unlike the dense-tier Cornell box."""
    scene = Scene()
    mats = [
        Material(albedo=(0.75, 0.71, 0.68, 1.0), roughness=0.8),   # matte
        Material(albedo=(0.9, 0.6, 0.3, 1.0), roughness=0.25,
                 metallic=True),                                    # copper
        Material(albedo=(0.95, 0.95, 0.95, 1.0), roughness=0.05,
                 metallic=True),                                    # mirror
        Material(albedo=(0.2, 0.4, 0.8, 1.0), roughness=0.4),      # blue
        Material(albedo=(0.0, 0.0, 0.0, 1.0),
                 emission=(8.0, 7.0, 5.0), emission_active=True),  # lamp
        Material(albedo=(0.5, 0.52, 0.5, 1.0), roughness=0.9),     # ground
    ]
    for m in mats:
        scene.add_material(m)

    rng = np.random.default_rng(7)
    verts_l, tris_l, mat_l, off = [], [], [], 0
    for gx in range(nx):
        for gz in range(nz):
            r = float(rng.uniform(0.5, 1.1))
            v, t = _uv_sphere(gx * 2.5, r, gz * 2.5, r)
            verts_l.append(v)
            tris_l.append(t + off)
            # every 23rd sphere glows: "hundreds of emitters" light setup
            mat = 4 if (gx * nz + gz) % 23 == 0 else int(rng.integers(0, 4))
            mat_l.append(np.full(len(t), mat, np.uint16))
            off += len(v)
    # ground plane
    g = np.asarray(
        [(-10, 0, -10), (nx * 2.5 + 10, 0, -10),
         (nx * 2.5 + 10, 0, nz * 2.5 + 10), (-10, 0, nz * 2.5 + 10)],
        np.float32,
    )
    verts_l.append(g)
    tris_l.append(np.asarray([[0, 1, 2], [0, 2, 3]], np.int32) + off)
    mat_l.append(np.full(2, 5, np.uint16))

    mesh = Mesh(
        vertices=np.concatenate(verts_l),
        triangles=np.concatenate(tris_l),
        material_ids=np.concatenate(mat_l),
        name="bench_field",
    )
    scene.add_mesh(mesh)
    inst = scene.new_instance()
    inst.mesh_id = mesh.id
    scene.set_instance(inst)

    settings = scene.get_entity("settings")
    settings.width = width
    settings.height = height
    settings.max_ray_depth = max_depth
    scene.set_entity("settings", settings)

    cam = scene.get_entity("camera")
    mid = nx * 2.5 / 2
    cam.pos = (mid - 14.0, 9.0, mid - 14.0)
    cam.rotation = (-0.28, np.pi + np.pi / 4, 0.0)
    cam.thin_lens.fov = 0.9
    scene.set_entity("camera", cam)

    sky = scene.get_entity("sky")
    sky.azimuth = 1.0
    sky.altitude = 0.6
    scene.set_entity("sky", sky)
    return scene


def write_obj_scene(scene: Scene, directory: str, name: str = "scene") -> str:
    """Write a scene's meshes and materials as one OBJ/MTL pair (emitters as
    ``Ke``, per-corner normals as ``vn``) and its settings, camera and sky as
    a v4 ``.lum`` that loads it; returns the ``.lum`` path. Every instance
    must be untransformed (the ``.lum`` MESHFILE spawns one such instance)."""
    import os

    from .io.lum import LumFileContent, write_lum_file

    os.makedirs(directory, exist_ok=True)
    obj_path = os.path.join(directory, name + ".obj")
    mtl_name = name + ".mtl"
    with open(os.path.join(directory, mtl_name), "w") as f:
        for m in scene.materials:
            f.write(f"newmtl m{m.id}\n")
            f.write("Kd %.9g %.9g %.9g\nd %.9g\n" % tuple(m.albedo))
            f.write("Ke %.9g %.9g %.9g\n" % tuple(
                c if m.emission_active else 0.0 for c in m.emission))
            f.write("Pr %.9g\nPm %d\nNi %.9g\n" % (
                m.roughness, int(m.metallic), m.refraction_index))
    parts, v_off, n_off = [f"mtllib {mtl_name}\n"], 0, 0
    for inst in scene.instances:
        if not inst.active:
            continue
        assert (tuple(inst.position) == (0.0, 0.0, 0.0)
                and tuple(inst.rotation) == (0.0, 0.0, 0.0)
                and tuple(inst.scale) == (1.0, 1.0, 1.0)), inst
        mesh = scene.meshes[inst.mesh_id]
        v = np.asarray(mesh.vertices, np.float32)
        t = np.asarray(mesh.triangles, np.int64)
        n = np.asarray(mesh.normals, np.float32).reshape(-1, 3)
        parts.append("".join("v %.9g %.9g %.9g\n" % tuple(p) for p in v))
        parts.append("".join("vn %.9g %.9g %.9g\n" % tuple(p) for p in n))
        mat = np.asarray(mesh.material_ids, np.int64)
        for mid in np.unique(mat):
            parts.append(f"usemtl m{int(mid)}\n")
            for k in np.nonzero(mat == mid)[0]:
                a, b, c = t[k] + 1 + v_off
                na = 3 * k + 1 + n_off
                parts.append(f"f {a}//{na} {b}//{na + 1} {c}//{na + 2}\n")
        v_off += len(v)
        n_off += len(n)
    with open(obj_path, "w") as f:
        f.write("".join(parts))
    lum_path = os.path.join(directory, name + ".lum")
    write_lum_file(lum_path, LumFileContent(
        obj_file_paths=[obj_path],
        settings=scene.get_entity("settings"),
        camera=scene.get_entity("camera"),
        ocean=scene.get_entity("ocean"),
        sky=scene.get_entity("sky"),
        cloud=scene.get_entity("cloud"),
        fog=scene.get_entity("fog"),
        particles=scene.get_entity("particles"),
    ))
    return lum_path
