"""The port's own scene pack against ``luminary_tpu/render/device_scene.py``
for ``cornell_scene(32, 32)`` (constant sky, dense tier): every table the
slice uses, word for word per slot. Also the carry-across of a JAX pack
(``from_jax_arrays``) that the module tests feed both packages with.

``jax_scene_tree`` (flatten the JAX DeviceScene/DeviceCamera to nested dicts
of numpy arrays) is shared with test_torch_slice.py."""

import numpy as np
import pytest
import torch

from luminary_tpu.ops.camera import pack_camera as j_pack_camera
from luminary_tpu.render.device_scene import pack_scene as j_pack_scene
from luminary_tpu.render.device_scene import pack_shade_packed as j_pack_shade_packed
from luminary_tpu.testing import cornell_scene as j_cornell
from luminary_tpu_torch.ops.camera import pack_camera
from luminary_tpu_torch.render.device_scene import (
    F16_MAX,
    SHP_EM_B_ROUGH,
    SHP_EM_RG,
    SHP_IDS,
    DeviceMaterials,
    from_jax_arrays,
    materials_np,
    pack_geometry_np,
    pack_lights_for,
    pack_scene,
    pack_shade_rows,
    unpack_reference_shade_rows,
)
from luminary_tpu_torch.testing import cornell_scene
from luminary_tpu_torch.utils.errors import InvalidAPIArgumentError

torch.set_num_threads(1)


def _to_np(x):
    if x is None or isinstance(x, (int, float, bool, str)):
        return x
    if isinstance(x, tuple) and getattr(x, "_fields", None) == ("x", "y", "z"):
        return tuple(np.asarray(c) for c in x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: _to_np(v) for k, v in zip(x._fields, x)}
    if hasattr(x, "tree_flatten") or type(x).__name__ in ("DeviceBVH", "DeviceLights"):
        return {k: _to_np(v) for k, v in vars(x).items()}
    return np.asarray(x)


def jax_scene_tree(scene_j, cam_j) -> dict:
    """The JAX DeviceScene and DeviceCamera as nested numpy dicts."""
    return {"scene": _to_np(scene_j), "camera": _to_np(cam_j)}


def words(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype.itemsize == 4 else a


def same_words(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(words(a.astype(b.dtype)), words(b))


def vec_np(v):
    return np.stack([np.asarray(c) for c in v], axis=-1)


@pytest.fixture(scope="module")
def packs():
    scene_j = j_cornell(32, 32)
    dj = j_pack_scene(scene_j)
    cj = j_pack_camera(scene_j.camera)
    scene_t = cornell_scene(32, 32)
    dt = pack_scene(scene_t, "cpu")
    ct = pack_camera(scene_t.camera, "cpu")
    return dict(j=dj, cj=cj, t=dt, ct=ct, tree=jax_scene_tree(dj, cj))


def _port_tables(dt, ct):
    g = dt.geo
    b = g.bvh
    out = {
        "bvh_rows": b.rows, "bounds": b.bounds, "dense_tris": b.dense_tris,
        "dense_slot": b.dense_slot,
        "tri_v0": vec_np(b.tri_v0), "tri_e1": vec_np(b.tri_e1),
        "tri_e2": vec_np(b.tri_e2),
        "n0": vec_np(g.n0), "n1": vec_np(g.n1), "n2": vec_np(g.n2),
        "face_normal": vec_np(g.face_normal),
        "material_id": g.material_id, "instance_id": g.instance_id,
        "prim_id": g.prim_id,
        "shade_rows": dt.shade_hot, "light_slot_rows": dt.light_slot_rows,
        "env_rows": dt.sky.env_rows, "aerial_rows": dt.sky.aerial_rows,
        "env_alias_rows": dt.sky.env_alias_rows,
        "env_cell_pdf": dt.sky.env_cell_pdf,
        "sun_dir": dt.sky.sun_dir, "constant_color": dt.sky.constant_color,
        "sun_disc_radiance": dt.sky.sun_disc_radiance,
        "moon_dir": dt.sky.moon_dir,
        "camera_pos": ct.pos, "camera_q": ct.rotation_q, "camera_fov": ct.fov,
    }
    for k in DeviceMaterials._fields:
        out["mat_" + k] = getattr(dt.materials, k)
    for k in ("prob", "alias", "slot", "select_pdf", "slot_select_pdf",
              "slot_area", "tree_rows"):
        out["light_" + k] = getattr(dt.lights, k)
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in out.items()}


def _jax_tables(dj, cj):
    g = dj.geo
    b = g.bvh
    p = np.asarray(g.material_id).shape[0]
    out = {
        "bvh_rows": b.rows, "bounds": b.bounds, "dense_tris": b.dense_tris,
        "dense_slot": b.dense_slot,
        "tri_v0": vec_np(b.tri_v0), "tri_e1": vec_np(b.tri_e1),
        "tri_e2": vec_np(b.tri_e2),
        "n0": vec_np(g.n0), "n1": vec_np(g.n1), "n2": vec_np(g.n2),
        "face_normal": vec_np(g.face_normal),
        "material_id": g.material_id, "instance_id": g.instance_id,
        "prim_id": g.prim_id,
        "shade_rows": unpack_reference_shade_rows(np.asarray(dj.shade_hot), p),
        "light_slot_rows": dj.light_slot_rows,
        "env_rows": dj.sky.env_rows, "aerial_rows": dj.sky.aerial_rows,
        "env_alias_rows": dj.sky.env_alias_rows,
        "env_cell_pdf": dj.sky.env_cell_pdf,
        "sun_dir": dj.sky.sun_dir, "constant_color": dj.sky.constant_color,
        "sun_disc_radiance": dj.sky.sun_disc_radiance,
        "moon_dir": dj.sky.moon_dir,
        "camera_pos": cj.pos, "camera_q": cj.rotation_q, "camera_fov": cj.fov,
    }
    for k in DeviceMaterials._fields:
        v = np.asarray(getattr(dj.materials, k))
        out["mat_" + k] = v.astype(np.int32) if k == "flags" else v
    for k in ("prob", "alias", "slot", "select_pdf", "slot_select_pdf",
              "slot_area", "tree_rows"):
        out["light_" + k] = getattr(dj.lights, k)
    return {k: np.asarray(v) for k, v in out.items()}


TABLES = [
    "bvh_rows", "bounds", "dense_tris", "dense_slot", "tri_v0", "tri_e1",
    "tri_e2", "n0", "n1", "n2", "face_normal", "material_id", "instance_id",
    "prim_id", "shade_rows", "light_slot_rows", "env_rows", "aerial_rows",
    "env_alias_rows", "env_cell_pdf", "sun_dir", "constant_color",
    "sun_disc_radiance", "moon_dir", "camera_pos", "camera_q", "camera_fov",
] + ["mat_" + k for k in DeviceMaterials._fields] + [
    "light_" + k for k in ("prob", "alias", "slot", "select_pdf",
                           "slot_select_pdf", "slot_area", "tree_rows")]


@pytest.mark.parametrize("name", TABLES)
def test_table_word_for_word(packs, name):
    got = _port_tables(packs["t"], packs["ct"])[name]
    ref = _jax_tables(packs["j"], packs["cj"])[name]
    assert same_words(got, ref), name


def test_static_sizes(packs):
    dt, dj = packs["t"], packs["j"]
    assert dt.geo.bvh.depth == dj.geo.bvh.depth
    assert dt.geo.bvh.num_nodes == dj.geo.bvh.num_nodes
    assert dt.lights.num_lights == int(dj.lights.num_lights)
    assert dt.lights.tree_levels == dj.lights.tree_levels
    assert dt.sky.mode == int(dj.sky.mode)
    assert (dt.sky.env_h, dt.sky.env_w) == (int(dj.sky.env_h), int(dj.sky.env_w))


def test_from_jax_arrays_equals_own_pack(packs):
    """The JAX pack carried across gives the port's own tables."""
    carried, cam = from_jax_arrays(packs["tree"], "cpu")
    a = _port_tables(carried, cam)
    b = _port_tables(packs["t"], packs["ct"])
    for name in TABLES:
        assert same_words(a[name], b[name]), name
    assert carried.geo.bvh.depth == packs["t"].geo.bvh.depth


def _host_pack(scene):
    hg = pack_geometry_np(scene)
    mats = materials_np(scene)
    return hg, mats, pack_lights_for(hg, mats)


@pytest.mark.parametrize("case", ["material_id", "instance_id", "emission"])
def test_packer_raises_where_reference_wraps(case):
    """Where the reference's shade row would wrap a 16-bit id or overflow
    f16 emission to inf (``luminary_tpu/render/device_scene.py``
    ``pack_shade_packed``), the port's packer raises."""
    scene = cornell_scene(8, 8)
    if case == "emission":
        lamp = next(m for m in scene.materials if m.emission_active)
        lamp.emission_scale = 65504.0 / 15.0 * 1.01
        scene.set_material(lamp)
        with pytest.raises(InvalidAPIArgumentError, match="emission_r"):
            pack_scene(scene, "cpu")
        return
    hg, mats, lights = _host_pack(scene)
    field = getattr(hg, case).copy()
    field[3] = 0xFFFF + (case == "material_id")
    with pytest.raises(InvalidAPIArgumentError, match=case.replace("_", " ")):
        pack_shade_rows(hg._replace(**{case: field}), mats, lights)


def test_edge_values_pack_like_reference(packs):
    """The largest ids and emission that fit (material 65535, instance 65534,
    pre-scaled emission 65504) pack to the reference's words: its shade rows
    for the same slots, with the material table padded to 65536 entries."""
    hg, mats, lights = _host_pack(cornell_scene(32, 32))
    dj = packs["j"]
    top, p = 0xFFFF, hg.material_id.shape[0]

    def grow(a, emission=False):
        a = np.asarray(a)
        out = np.concatenate([a, np.repeat(a[:1], top + 1 - a.shape[0], axis=0)])
        if emission:
            out[top] = F16_MAX
        return out

    mat = np.where(np.arange(p) % 2 == 1, top, hg.material_id).astype(np.int32)
    inst = np.where(hg.instance_id >= 0, top - 1, -1).astype(np.int32)
    got = pack_shade_rows(hg._replace(material_id=mat, instance_id=inst),
                          {k: grow(v, k.startswith("emission")) for k, v in mats.items()},
                          lights)
    j_mats = dj.materials._replace(**{
        k: grow(getattr(dj.materials, k), k.startswith("emission"))
        for k in dj.materials._fields})
    hot = j_pack_shade_packed(dj.geo._replace(material_id=mat, instance_id=inst),
                              j_mats, dj.lights)[0]
    assert same_words(got, unpack_reference_shade_rows(hot, p))
    edge = (mat == top) & (inst >= 0)
    assert edge.sum() > 10
    ids = got[edge, SHP_IDS].view(np.uint32)
    assert ((ids & 0xFFFF) == top).all() and ((ids >> 16) == top).all()
    em = got[edge][:, [SHP_EM_RG, SHP_EM_B_ROUGH]].view(np.uint32) & 0xFFFF
    assert (em == 0x7BFF).all()  # f16 65504
