"""The port's host IO against the JAX package's: the same arrays give the
same PNG and QOI bytes; the same ``.lum`` (v4 and a v5 script) and OBJ/MTL
text parse to equal contents, field by field; ``write_lum_file`` writes the
same bytes."""

import dataclasses
import enum
import os

import numpy as np
import pytest

from luminary_tpu.io import lum as jlum
from luminary_tpu.io import png as jpng
from luminary_tpu.io import qoi as jqoi
from luminary_tpu.io import wavefront as jwf
from luminary_tpu_torch.io import lum as tlum
from luminary_tpu_torch.io import png as tpng
from luminary_tpu_torch.io import qoi as tqoi
from luminary_tpu_torch.io import wavefront as twf

IMAGES = {
    "rgb": (13, 17, 3),
    "rgba": (9, 11, 4),
    "gray": (8, 5),
}


def _image(kind):
    rng = np.random.default_rng(11 + sorted(IMAGES).index(kind))
    img = rng.integers(0, 256, IMAGES[kind], dtype=np.uint8)
    img[: img.shape[0] // 2] //= 16  # runs and repeats for the encoders
    return img


def plain(x):
    """A package-free view of a parse result: dataclasses as dicts, enums
    as ints, arrays as (dtype, shape, bytes)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return int(x.value)
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    return x


@pytest.mark.parametrize("kind", sorted(IMAGES))
def test_png_bytes_and_decode_match(tmp_path, kind):
    img = _image(kind)
    pj, pt = tmp_path / "j.png", tmp_path / "t.png"
    jpng.write_png(str(pj), img)
    tpng.write_png(str(pt), img)
    assert pj.read_bytes() == pt.read_bytes()
    got, ref = tpng.read_png(str(pj)), jpng.read_png(str(pj))
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.parametrize("kind", ["rgb", "rgba"])
def test_qoi_bytes_and_decode_match(kind):
    img = _image(kind)
    data = jqoi.encode_qoi(img)
    assert tqoi.encode_qoi(img) == data
    got, ref = tqoi.decode_qoi(data), jqoi.decode_qoi(data)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert np.array_equal(got, img)


def _content_v4(lum_mod):
    """A content with every entity moved off its defaults."""
    c = lum_mod.LumFileContent(obj_file_paths=["/models/a.obj", "/models/b.obj"])
    s = c.settings
    s.width, s.height, s.max_ray_depth = 640, 360, 7
    s.ambient_nee, s.sun_ris, s.blue_noise = False, False, False
    cam = c.camera
    cam.pos = (1.5, -2.25, 3.125)
    cam.rotation = (0.1, -0.2, 0.3)
    cam.thin_lens.fov = 0.75
    cam.thin_lens.aperture_size = 0.05
    cam.exposure, cam.tonemap, cam.filter = 2.5, 3, 2
    cam.dithering, cam.bloom_blend, cam.purkinje = False, 0.25, True
    cam.film_grain = 0.1
    sky = c.sky
    sky.mode, sky.azimuth, sky.altitude = 2, 1.25, 0.4
    sky.constant_color = (0.1, 0.2, 0.3)
    sky.stars_count = 123
    c.cloud.active, c.cloud.density, c.cloud.low.coverage = True, 0.7, 0.3
    c.fog.active, c.fog.density, c.fog.height = True, 0.02, 40.0
    c.ocean.active, c.ocean.height, c.ocean.water_type = True, -1.5, 3
    c.particles.active, c.particles.count, c.particles.albedo = True, 512, (0.5, 0.6, 0.7)
    return c


EXTRA_V4 = """GENERAL SAMPLES_ 96
GENERAL OUTPUTFN render.png
GENERAL NUMLIGHT 4
MATERIAL EMISSION 2.5
MATERIAL COLORTRA 1
MATERIAL SMOOTHNE 1
MATERIAL FRESNEL_ 1
TOY ACTIVE__ 1
# a comment
"""

V5 = """Luminary
VERSION 5

settings s = settings.init();
s.width = 320;
s.height = 90 + 90;
s.max_ray_depth = 2 * 3;

camera c = camera.init();
c.pos = vec3(0.0, 1.0, 3.5);
c.exposure = 2.0;

sky k = sky.init();
k.mode = SKY_MODE_CONSTANT_COLOR;
k.constant_color = rgb(0.5, 0.25, 0.125);

mesh m = mesh.load("box.obj");
instance i = instance.init(m);
i.position = vec3(1, -2, 0.5);
"""


@pytest.mark.parametrize("case", ["v4_written", "v4_legacy_keys", "v5_script"])
def test_lum_parse_matches(tmp_path, case):
    if case == "v5_script":
        text = V5
    else:
        path = tmp_path / "scene.lum"
        jlum.write_lum_file(str(path), _content_v4(jlum))
        text = path.read_text()
        if case == "v4_legacy_keys":
            text += EXTRA_V4
    got = tlum.parse_lum(text, base_dir=str(tmp_path))
    ref = jlum.parse_lum(text, base_dir=str(tmp_path))
    assert plain(got) == plain(ref)
    assert type(got).__module__.startswith("luminary_tpu_torch.")


def test_write_lum_file_same_bytes(tmp_path):
    pj, pt = tmp_path / "j.lum", tmp_path / "t.lum"
    jlum.write_lum_file(str(pj), _content_v4(jlum))
    tlum.write_lum_file(str(pt), _content_v4(tlum))
    assert pj.read_bytes() == pt.read_bytes()
    # and what one package writes, the other reads back alike
    assert plain(tlum.read_lum_file(str(pj))) == plain(jlum.read_lum_file(str(pt)))


OBJ = """# two materials, a quad, negative indices, uvs and normals
mtllib scene.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1.25
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 0 2
usemtl lamp
f 1/1/1 2/2/1 3/3/2 4/4/2
usemtl wall
f -5/1 -4/2 -1/3
f 3 4 5
usemtl lamp
f 1//1 5//2 4//1
"""

MTL = """newmtl wall
Kd 0.8 0.7 0.6
Ns 250
Ni 1.45
d 1
map_Kd wall.png
newmtl lamp
Kd 0 0 0
Ke 12 10 8
Pr 0.35
Pm 1
newmtl unused
Kd 1 0 0
"""


@pytest.mark.parametrize("args", ["default", "legacy_scaled"])
def test_obj_mtl_parse_matches(tmp_path, args):
    (tmp_path / "scene.obj").write_text(OBJ)
    (tmp_path / "scene.mtl").write_text(MTL)
    jpng.write_png(str(tmp_path / "wall.png"), _image("rgb"))
    kw = ({} if args == "default"
          else dict(legacy_smoothness=True, emission_scale=3.0,
                    force_thin_walled=True))
    path = str(tmp_path / "scene.obj")
    got = twf.read_obj_file(path, twf.WavefrontArguments(**kw), base_texture_id=2)
    ref = jwf.read_obj_file(path, jwf.WavefrontArguments(**kw), base_texture_id=2)
    assert plain(got) == plain(ref)
    assert got.mesh.num_triangles == 5 and len(got.textures) == 1
    assert any(m.emission_active for m in got.materials)


def test_write_obj_scene_round_trip(tmp_path):
    """The scene writer of the port's testing module (used by the CLI checks)
    writes a .lum + OBJ/MTL that both packages load alike, with the scene's
    triangles, materials and emitters."""
    from luminary_tpu_torch.testing import cornell_scene, write_obj_scene

    scene = cornell_scene(16, 16, max_depth=2)
    lum_path = write_obj_scene(scene, str(tmp_path), "box")
    got = tlum.read_lum_file(lum_path)
    ref = jlum.read_lum_file(lum_path)
    assert plain(got) == plain(ref)
    assert got.settings.width == 16 and got.settings.max_ray_depth == 2
    obj = twf.read_obj_file(got.obj_file_paths[0])
    assert plain(obj) == plain(jwf.read_obj_file(got.obj_file_paths[0]))
    mesh = scene.meshes[0]
    assert obj.mesh.num_triangles == mesh.num_triangles
    # faces are written grouped by material, in the scene's order within each
    order = np.argsort(mesh.material_ids, kind="stable")
    np.testing.assert_array_equal(obj.mesh.vertices[obj.mesh.triangles],
                                  mesh.vertices[mesh.triangles[order]])
    assert sum(m.emission_active for m in obj.materials) == 1
    assert os.path.basename(got.obj_file_paths[0]) == "box.obj"
