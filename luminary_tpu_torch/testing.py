"""Procedural test scenes (Cornell box etc.) used by tests and benchmarks.

The reference relies on external .obj/.lum assets for testing; we ship
generators so the test pyramid is hermetic.
"""

from __future__ import annotations

import numpy as np

from .scene.entities import Camera, Material, MaterialBaseSubstrate, SkyMode
from .scene.mesh import Mesh, Texture
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

def _uv_sphere_uvs(nu=16, nv=12) -> np.ndarray:
    """Spherical UVs [T, 3, 2] of the triangles of :func:`_uv_sphere` (u
    around, v from pole to pole; the seam's corners take u = 1)."""
    uvs = []
    for i in range(nu):
        for j in range(nv - 1):
            a = (i / nu, j / (nv - 1))
            b = ((i + 1) / nu, j / (nv - 1))
            a1 = (i / nu, (j + 1) / (nv - 1))
            b1 = ((i + 1) / nu, (j + 1) / (nv - 1))
            uvs += [[a, b, a1], [b, b1, a1]]
    return np.asarray(uvs, np.float32)


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


def _sphere_field(nx: int, nz: int):
    """The bench field: nx x nz UV spheres of random radius on a ground
    plane (seed 7) → (vertices, triangles, material ids, sphere index per
    triangle (-1 for the ground), sphere count). Materials 0-3 are the
    surfaces, 4 the lamp (every 23rd sphere), 5 the ground."""
    rng = np.random.default_rng(7)
    verts_l, tris_l, mat_l, sph_l, off = [], [], [], [], 0
    for gx in range(nx):
        for gz in range(nz):
            r = float(rng.uniform(0.5, 1.1))
            v, t = _uv_sphere(gx * 2.5, r, gz * 2.5, r)
            verts_l.append(v)
            tris_l.append(t + off)
            # every 23rd sphere glows: "hundreds of emitters" light setup
            mat = 4 if (gx * nz + gz) % 23 == 0 else int(rng.integers(0, 4))
            mat_l.append(np.full(len(t), mat, np.uint16))
            sph_l.append(np.full(len(t), gx * nz + gz, np.int32))
            off += len(v)
    g = np.asarray(
        [(-10, 0, -10), (nx * 2.5 + 10, 0, -10),
         (nx * 2.5 + 10, 0, nz * 2.5 + 10), (-10, 0, nz * 2.5 + 10)],
        np.float32,
    )
    verts_l.append(g)
    tris_l.append(np.asarray([[0, 1, 2], [0, 2, 3]], np.int32) + off)
    mat_l.append(np.full(2, 5, np.uint16))
    sph_l.append(np.full(2, -1, np.int32))
    return (np.concatenate(verts_l), np.concatenate(tris_l),
            np.concatenate(mat_l), np.concatenate(sph_l), nx * nz)


_BENCH_MATERIALS = (
    dict(albedo=(0.75, 0.71, 0.68, 1.0), roughness=0.8),   # matte
    dict(albedo=(0.9, 0.6, 0.3, 1.0), roughness=0.25, metallic=True),  # copper
    dict(albedo=(0.95, 0.95, 0.95, 1.0), roughness=0.05, metallic=True),  # mirror
    dict(albedo=(0.2, 0.4, 0.8, 1.0), roughness=0.4),      # blue
    dict(albedo=(0.0, 0.0, 0.0, 1.0), emission=(8.0, 7.0, 5.0),
         emission_active=True),                            # lamp
    dict(albedo=(0.5, 0.52, 0.5, 1.0), roughness=0.9),     # ground
)


def _bench_view(scene: Scene, width, height, max_depth, nx, nz) -> None:
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


def _add_mesh(scene: Scene, mesh: Mesh) -> None:
    scene.add_mesh(mesh)
    inst = scene.new_instance()
    inst.mesh_id = mesh.id
    scene.set_instance(inst)


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
    for m in _BENCH_MATERIALS:
        scene.add_material(Material(**m))
    verts, tris, mats, _sph, _n = _sphere_field(nx, nz)
    _add_mesh(scene, Mesh(vertices=verts, triangles=tris, material_ids=mats,
                          name="bench_field"))
    _bench_view(scene, width, height, max_depth, nx, nz)
    return scene


def _content_textures():
    """The content scene's textures, as uint8 images: a checker albedo, a
    roughness ramp, a metallic stripe mask, a bumpy normal map, a striped
    luminance map (diagonal bands narrower than a lamp triangle) and a leaf
    (a disc of alpha 1 in a clear square)."""
    res = 64
    y, x = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    cell = (x // 8 + y // 8) % 2
    checker = np.zeros((res, res, 4), np.uint8)
    checker[..., 0] = np.where(cell == 0, 220, 40)
    checker[..., 1] = np.where(cell == 0, 200, 90)
    checker[..., 2] = np.where(cell == 0, 170, 60)
    checker[..., 3] = 255
    rough = (40 + 200 * x / (res - 1)).astype(np.uint8)[..., None]
    metal = np.where((y // 16) % 2 == 0, 255, 0).astype(np.uint8)[..., None]
    nx_ = 0.6 * np.sin(x / res * 8 * np.pi)
    ny_ = 0.6 * np.cos(y / res * 6 * np.pi)
    nz_ = np.sqrt(np.clip(1.0 - nx_ ** 2 - ny_ ** 2, 0.0, 1.0))
    normal = (np.stack([nx_, ny_, nz_], -1) * 127.5 + 127.5).astype(np.uint8)
    lum = np.repeat(np.where(((x + 2 * y) // 3) % 2 == 0, 255, 20).astype(
        np.uint8)[..., None], 3, axis=-1)
    leaf = np.zeros((res, res, 4), np.uint8)
    disc = (x - 31.5) ** 2 + (y - 31.5) ** 2 < 26.0 ** 2
    leaf[..., 0], leaf[..., 1], leaf[..., 2] = 70, 150, 40
    leaf[..., 3] = np.where(disc, 255, 0)
    return dict(checker=checker, rough=rough, metal=metal, normal=normal,
                lum=lum, leaf=leaf)


def content_scene(width: int = 1920, height: int = 1080, max_depth: int = 4,
                  nx: int = 19, nz: int = 19, n_cards: int = 200,
                  fog_density: float = 5.0, bridge_vertices: int = 2) -> Scene:
    """The bench field (seed 7) with scene content: a checker albedo texture
    on the ground; roughness, metallic and normal maps with spherical UVs on
    every fourth non-lamp sphere; a luminance map on the lamp spheres (so
    that emission importance varies over each emitter triangle); ``n_cards``
    alpha-textured cards (quads whose leaf texture is clear outside a disc);
    fog of ``fog_density`` below y = 12 with bridges of up to
    ``bridge_vertices`` scattering events."""
    scene = Scene()
    tex = _content_textures()
    ids = {k: scene.add_texture(Texture(data=v, gamma=2.2 if k in (
        "checker", "leaf") else 1.0, name=k)) for k, v in tex.items()}
    for m in _BENCH_MATERIALS:
        scene.add_material(Material(**m))
    ground = scene.get_material(5)
    ground.albedo = (0.8, 0.8, 0.8, 1.0)
    ground.albedo_tex = ids["checker"]
    scene.set_material(ground)
    lamp = scene.get_material(4)
    lamp.luminance_tex = ids["lum"]
    scene.set_material(lamp)
    mapped = scene.add_material(Material(
        albedo=(0.8, 0.75, 0.7, 1.0), roughness=0.5,
        roughness_tex=ids["rough"], metallic_tex=ids["metal"],
        normal_tex=ids["normal"]))
    card = scene.add_material(Material(
        albedo=(1.0, 1.0, 1.0, 1.0), roughness=0.7, albedo_tex=ids["leaf"]))

    verts, tris, mats, sph, n_sph = _sphere_field(nx, nz)
    uvs = np.zeros((len(tris), 3, 2), np.float32)
    sphere_uvs = _uv_sphere_uvs()
    per = sphere_uvs.shape[0]
    uvs[:n_sph * per] = np.tile(sphere_uvs, (n_sph, 1, 1))
    span = np.float32(max(nx, nz) * 2.5 + 20.0)
    uvs[-2:] = np.asarray([[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]],
                          np.float32) * (span / 2.5)  # 2.5 m checker cells
    mats = mats.copy()
    mats[(sph >= 0) & (sph % 4 == 1) & (mats != 4)] = mapped

    rng = np.random.default_rng(11)
    cv, ct, cm, cuv = [], [], [], []
    base = len(verts)
    for i in range(n_cards):
        c = np.asarray([rng.uniform(-1.0, nx * 2.5), rng.uniform(0.4, 2.8),
                        rng.uniform(-1.0, nz * 2.5)], np.float32)
        a, b = rng.normal(size=3), rng.normal(size=3)
        a /= np.linalg.norm(a)
        b -= a * (a @ b)
        b /= np.linalg.norm(b)
        h = 0.5 * float(rng.uniform(0.6, 1.4))
        quad = [c - h * a - h * b, c + h * a - h * b, c + h * a + h * b,
                c - h * a + h * b]
        cv += quad
        k = base + 4 * i
        ct += [[k, k + 1, k + 2], [k, k + 2, k + 3]]
        cm += [card, card]
        cuv += [[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]]
    if n_cards:
        verts = np.concatenate([verts, np.asarray(cv, np.float32)])
        tris = np.concatenate([tris, np.asarray(ct, np.int32)])
        mats = np.concatenate([mats, np.asarray(cm, np.uint16)])
        uvs = np.concatenate([uvs, np.asarray(cuv, np.float32)])
    _add_mesh(scene, Mesh(vertices=verts, triangles=tris, uvs=uvs,
                          material_ids=mats, name="content_field"))
    _bench_view(scene, width, height, max_depth, nx, nz)
    st = scene.get_entity("settings")
    st.bridge_max_num_vertices = bridge_vertices
    scene.set_entity("settings", st)
    fog = scene.get_entity("fog")
    fog.active = True
    fog.density = fog_density
    fog.height = 12.0
    fog.dist = 500.0
    scene.set_entity("fog", fog)
    return scene


def glass_sphere_scene(width: int = 32, height: int = 32) -> Scene:
    """The ``glass_sphere_32`` golden scene: a glass sphere (IOR 1.5) on the
    sun plane, depth 5 (refraction through the 2-deep medium stack)."""
    s = sun_plane_scene(width, height)
    mid = s.add_material(Material(
        albedo=(1.0, 1.0, 1.0, 1.0), roughness=0.05,
        base_substrate=MaterialBaseSubstrate.TRANSLUCENT, refraction_index=1.5))
    v, t = _uv_sphere(0.0, 1.0, 0.0, 0.8)
    _add_mesh(s, Mesh(vertices=v, triangles=t,
                      material_ids=np.full(len(t), mid, np.uint16), name="glass"))
    st = s.get_entity("settings")
    st.max_ray_depth = 5
    s.set_entity("settings", st)
    return s


def textured_scene(width: int = 32, height: int = 32) -> Scene:
    """The ``textured_32`` golden scene: an 8x8-cell checker albedo
    texture tiled 4 times over the sun plane."""
    s = sun_plane_scene(width, height)
    c = np.zeros((64, 64, 4), np.uint8)
    cell = (np.arange(64) // 8)[:, None] + (np.arange(64) // 8)[None, :]
    c[..., 0] = np.where(cell % 2 == 0, 230, 30)
    c[..., 1] = np.where(cell % 2 == 0, 60, 200)
    c[..., 2] = 60
    c[..., 3] = 255
    tex_id = s.add_texture(Texture(data=c, gamma=2.2))
    m = s.get_material(0)
    m.albedo_tex = tex_id
    s.set_material(m)
    s.meshes[0].uvs = np.asarray(
        [[[0, 0], [4, 0], [4, 4]], [[0, 0], [4, 4], [0, 4]]], np.float32)
    return s


def fog_bridges_scene(width: int = 32, height: int = 32) -> Scene:
    """The ``fog_bridges_32`` golden scene: the Cornell box in homogeneous
    fog of density 0.35 (volume NEE and the bridge estimator)."""
    s = cornell_scene(width, height, max_depth=4)
    fog = s.get_entity("fog")
    fog.active = True
    fog.density = 0.35
    s.set_entity("fog", fog)
    return s


def outdoor_scene(width: int = 1920, height: int = 1080, max_depth: int = 4,
                  nx: int = 19, nz: int = 19, sky_mode: int = 0,
                  clouds: bool = True, hdri_dim: int = 2048) -> Scene:
    """The bench field (seed 7) at sea: the analytic ocean's surface at
    y = 0.7 covers the ground and the centres of about a third of the
    spheres (those of radius under 0.7), with water scattering and sun
    caustics; the low and mid cloud layers (``clouds``); the DEFAULT sky
    (``sky_mode`` 0: the cloud march on the miss side) or the HDRI sky
    (1: baked at ``hdri_dim`` with the clouds in the map, env NEE)."""
    scene = benchmark_scene(width, height, max_depth, nx, nz)
    oc = scene.get_entity("ocean")
    oc.active = True
    oc.height = 0.7
    oc.caustics_active = True
    scene.set_entity("ocean", oc)
    if clouds:
        cl = scene.get_entity("cloud")
        cl.active = True
        cl.low.active = True
        cl.mid.active = True
        scene.set_entity("cloud", cl)
    sky = scene.get_entity("sky")
    sky.mode = SkyMode(sky_mode)
    sky.hdri_dim = hdri_dim
    scene.set_entity("sky", sky)
    return scene


def optics_scene(width: int = 1920, height: int = 1080, max_depth: int = 4,
                 nx: int = 19, nz: int = 19, sort: bool = False) -> Scene:
    """The bench field (seed 7) through the optics features: a moving
    particle field at the reference's defaults (8,192 quads of size 1.0 in
    a 10 m tile, droplet diameter 50 µm; speed 0.5, so each sample draws a
    time), spectral rendering under the DEFAULT sky (its 8-band bake) and
    the physical camera (the generated achromat, f = 50 mm at f/5, the lens
    dispersing per lane); ``sort`` turns the wavefront sort on."""
    scene = benchmark_scene(width, height, max_depth, nx, nz)
    p = scene.get_entity("particles")
    p.active = True
    p.speed = 0.5
    scene.set_entity("particles", p)
    st = scene.get_entity("settings")
    st.spectral_rendering = True
    st.wavefront_sorting = sort
    scene.set_entity("settings", st)
    cam = scene.get_entity("camera")
    cam.use_physical_camera = True
    cam.physical.focal_length = 0.05
    cam.physical.image_plane_distance = 0.0501
    cam.physical.aperture_diameter = 0.01
    cam.physical.use_spectral_rendering = True
    scene.set_entity("camera", cam)
    return scene


def clouds_scene(width: int = 32, height: int = 32) -> Scene:
    """The ``clouds_32`` golden scene: the sun plane under the low cloud
    layer (the cloud march on the miss side, cloud shadows)."""
    s = sun_plane_scene(width, height)
    cl = s.get_entity("cloud")
    cl.active = True
    cl.low.active = True
    s.set_entity("cloud", cl)
    return s


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


def star_edge_directions(per_edge: int = 800, seed: int = 0, ulps: int = 4,
                         grid: int = 64) -> np.ndarray:
    """Unit directions, float32 ``[m, 3]``, whose star-grid coordinate u
    (from the azimuth) or v (from the polar angle), computed in float32 as
    ``ops/sky.py`` ``_star_cell`` computes them, lies within ``ulps`` float32
    ulps of a cell edge ``k / grid``: up to ``per_edge`` lanes for each k in
    0..grid on each axis. Near the poles float32 directions reach few such v,
    and the lanes there are fewer. Where the cell index is a truncation, these
    are the lanes that one ulp of atan2 or arccos moves to the next cell."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    out = []
    for axis in (0, 1):
        for k in range(grid + 1):
            edge = f32(k / grid)
            tol = ulps * np.spacing(max(edge, f32(1.0 / grid)))
            kept, tries = [], 0
            while sum(len(x) for x in kept) < per_edge and tries < 8:
                tries += 1
                m = 4 * per_edge
                t = rng.uniform(-1.0, 1.0, m) * (ulps + 2) * float(tol) / ulps
                if axis == 0:
                    phi = (k / grid - 0.5 + t) * 2.0 * np.pi
                    theta = np.arccos(rng.uniform(-0.95, 0.95, m))
                else:
                    phi = rng.uniform(-np.pi, np.pi, m)
                    theta = np.clip(k / grid + t, 0.0, 1.0) * np.pi
                d = np.stack([np.cos(phi) * np.sin(theta), np.cos(theta),
                              np.sin(phi) * np.sin(theta)], 1).astype(f32)
                if axis == 0:
                    c = (np.arctan2(d[:, 2], d[:, 0]) * f32(0.5 / np.pi)
                         + f32(0.5))
                else:
                    c = np.arccos(np.clip(d[:, 1], f32(-1), f32(1))) * f32(1 / np.pi)
                kept.append(d[np.abs(c.astype(np.float64) - float(edge)) <= tol])
            out.append(np.concatenate(kept)[:per_edge])
    return np.concatenate(out)
