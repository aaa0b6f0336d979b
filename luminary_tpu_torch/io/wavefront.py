"""Wavefront OBJ/MTL ingest.

Equivalent of the reference's OBJ pipeline (reference: src/luminary/host/
wavefront.c:1-1007, wavefront.h:33-63): parses v/vn/vt/f with polygon-fan
triangulation, resolves MTL materials into Luminary materials with the five
texture slots (albedo/luminance/roughness/metallic/normal), honors
``legacy_smoothness`` (MTL Ns as smoothness), transparency cutouts, and an
emission scale. One OBJ produces one :class:`Mesh` plus appended materials and
textures.

A host copy of ``luminary_tpu/io/wavefront.py``: the port keeps its own so
that it imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..scene.entities import Material, MaterialBaseSubstrate, TEXTURE_NONE
from ..scene.mesh import Mesh, Texture
from ..utils.errors import FileIOError
from ..utils.log import warn_message
from .png import read_png


@dataclass
class WavefrontArguments:
    """reference: src/luminary/host/wavefront.h:58-63."""

    legacy_smoothness: bool = False
    force_transparency_cutout: bool = False
    force_thin_walled: bool = False
    emission_scale: float = 1.0


@dataclass
class WavefrontResult:
    mesh: Mesh
    materials: list[Material] = field(default_factory=list)
    textures: list[Texture] = field(default_factory=list)


@dataclass
class _MtlMaterial:
    name: str
    kd: tuple = (0.9, 0.9, 0.9)
    ke: tuple = (0.0, 0.0, 0.0)
    ns: float = 300.0
    d: float = 1.0
    ni: float = 1.0
    map_kd: str | None = None
    map_ke: str | None = None
    map_ns: str | None = None
    map_metallic: str | None = None
    map_bump: str | None = None
    metallic: float = 0.0
    roughness: float | None = None  # PBR extension Pr


def _parse_mtl(path: str) -> list[_MtlMaterial]:
    mats: list[_MtlMaterial] = []
    cur: _MtlMaterial | None = None
    try:
        with open(path, "r", errors="replace") as f:
            lines = f.readlines()
    except OSError as e:
        raise FileIOError(f"cannot read MTL file {path}: {e}")
    for line in lines:
        tok = line.split()
        if not tok or tok[0].startswith("#"):
            continue
        key = tok[0]
        if key == "newmtl":
            cur = _MtlMaterial(name=" ".join(tok[1:]))
            mats.append(cur)
        elif cur is None:
            continue
        elif key == "Kd" and len(tok) >= 4:
            cur.kd = tuple(float(x) for x in tok[1:4])
        elif key == "Ke" and len(tok) >= 4:
            cur.ke = tuple(float(x) for x in tok[1:4])
        elif key == "Ns" and len(tok) >= 2:
            cur.ns = float(tok[1])
        elif key == "d" and len(tok) >= 2:
            cur.d = float(tok[1])
        elif key == "Tr" and len(tok) >= 2:
            cur.d = 1.0 - float(tok[1])
        elif key == "Ni" and len(tok) >= 2:
            cur.ni = float(tok[1])
        elif key == "Pm" and len(tok) >= 2:
            cur.metallic = float(tok[1])
        elif key == "Pr" and len(tok) >= 2:
            cur.roughness = float(tok[1])
        elif key == "map_Kd":
            cur.map_kd = tok[-1]
        elif key in ("map_Ke",):
            cur.map_ke = tok[-1]
        elif key in ("map_Ns", "map_Pr"):
            cur.map_ns = tok[-1]
        elif key in ("map_Pm", "map_refl"):
            cur.map_metallic = tok[-1]
        elif key in ("map_bump", "bump", "norm", "map_Kn"):
            cur.map_bump = tok[-1]
    return mats


def _mtl_to_material(m: _MtlMaterial, args: WavefrontArguments, tex_ids: dict) -> Material:
    # Ns → roughness: the reference's legacy mode maps shininess to smoothness
    # via 1 - sqrt(Ns/1000) clamped (wavefront.c material conversion).
    if m.roughness is not None:
        roughness = float(np.clip(m.roughness, 0.0, 1.0))
    elif args.legacy_smoothness:
        roughness = float(np.clip(1.0 - np.sqrt(max(m.ns, 0.0) / 1000.0), 0.0, 1.0))
    else:
        roughness = float(np.clip(1.0 - np.log2(max(m.ns, 1.0)) / 12.0, 0.0, 1.0))
    emission = tuple(c * args.emission_scale for c in m.ke)
    has_emission = max(emission) > 0.0 or m.map_ke is not None
    translucent = m.d < 1.0 and not args.force_transparency_cutout
    return Material(
        base_substrate=(
            MaterialBaseSubstrate.TRANSLUCENT if translucent else MaterialBaseSubstrate.OPAQUE
        ),
        albedo=(m.kd[0], m.kd[1], m.kd[2], m.d),
        emission=emission,
        emission_scale=args.emission_scale,
        roughness=roughness,
        refraction_index=max(m.ni, 1.0),
        emission_active=has_emission,
        metallic=m.metallic > 0.5,
        thin_walled=args.force_thin_walled,
        albedo_tex=tex_ids.get(m.map_kd, TEXTURE_NONE),
        luminance_tex=tex_ids.get(m.map_ke, TEXTURE_NONE),
        roughness_tex=tex_ids.get(m.map_ns, TEXTURE_NONE),
        metallic_tex=tex_ids.get(m.map_metallic, TEXTURE_NONE),
        normal_tex=tex_ids.get(m.map_bump, TEXTURE_NONE),
    )


def _load_texture(path: str, gamma: float) -> Texture | None:
    if not os.path.exists(path):
        warn_message("texture not found: %s", path)
        return None
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        data = read_png(path)
    else:
        warn_message("unsupported texture format: %s", path)
        return None
    return Texture(data=data, gamma=gamma, name=os.path.basename(path))


def read_obj_file(
    path: str,
    args: WavefrontArguments | None = None,
    base_texture_id: int = 0,
    load_textures: bool = True,
) -> WavefrontResult:
    """Parse an OBJ (+MTL) file into a Mesh + materials + textures.

    Material ids in the returned mesh are local (0-based); the caller offsets
    them when appending to the scene, mirroring the reference's slot remap
    (wavefront.c convert step).
    """
    args = args or WavefrontArguments()
    try:
        with open(path, "r", errors="replace") as f:
            lines = f.readlines()
    except OSError as e:
        raise FileIOError(f"cannot read OBJ file {path}: {e}")

    base_dir = os.path.dirname(os.path.abspath(path))
    positions: list[tuple] = []
    normals: list[tuple] = []
    uvs: list[tuple] = []
    # faces: (pos_idx[3], uv_idx[3], n_idx[3], mat_slot)
    tri_pos: list[tuple] = []
    tri_uv: list[tuple] = []
    tri_n: list[tuple] = []
    tri_mat: list[int] = []
    mtl_materials: list[_MtlMaterial] = []
    mat_slot_by_name: dict[str, int] = {}
    cur_slot = 0

    def resolve(idx: int, count: int) -> int:
        return idx - 1 if idx > 0 else count + idx

    for line in lines:
        if not line or line[0] in "#\n":
            continue
        tok = line.split()
        if not tok:
            continue
        key = tok[0]
        if key == "v":
            positions.append((float(tok[1]), float(tok[2]), float(tok[3])))
        elif key == "vn":
            normals.append((float(tok[1]), float(tok[2]), float(tok[3])))
        elif key == "vt":
            u = float(tok[1])
            v = float(tok[2]) if len(tok) > 2 else 0.0
            uvs.append((u, v))
        elif key == "f":
            corners = []
            for vert in tok[1:]:
                parts = vert.split("/")
                pi = resolve(int(parts[0]), len(positions))
                ti = (
                    resolve(int(parts[1]), len(uvs))
                    if len(parts) > 1 and parts[1]
                    else -1
                )
                ni = (
                    resolve(int(parts[2]), len(normals))
                    if len(parts) > 2 and parts[2]
                    else -1
                )
                corners.append((pi, ti, ni))
            # fan triangulation (reference: wavefront.c face handling)
            for i in range(1, len(corners) - 1):
                a, b, c = corners[0], corners[i], corners[i + 1]
                tri_pos.append((a[0], b[0], c[0]))
                tri_uv.append((a[1], b[1], c[1]))
                tri_n.append((a[2], b[2], c[2]))
                tri_mat.append(cur_slot)
        elif key == "usemtl":
            name = " ".join(tok[1:])
            if name not in mat_slot_by_name:
                mat_slot_by_name[name] = len(mat_slot_by_name)
            cur_slot = mat_slot_by_name[name]
        elif key == "mtllib":
            mtl_path = os.path.join(base_dir, " ".join(tok[1:]))
            if os.path.exists(mtl_path):
                mtl_materials.extend(_parse_mtl(mtl_path))
            else:
                warn_message("MTL file not found: %s", mtl_path)

    if not tri_pos:
        raise FileIOError(f"{path}: no faces found")

    verts = np.asarray(positions, dtype=np.float32)
    tris = np.asarray(tri_pos, dtype=np.int32)
    t = tris.shape[0]

    uv_idx = np.asarray(tri_uv, dtype=np.int64)
    uv_arr = np.zeros((t, 3, 2), dtype=np.float32)
    if uvs:
        uv_table = np.asarray(uvs, dtype=np.float32)
        valid = uv_idx >= 0
        uv_arr[valid] = uv_table[uv_idx[valid]]

    n_idx = np.asarray(tri_n, dtype=np.int64)
    mesh_tmp = Mesh(vertices=verts, triangles=tris)
    n_arr = mesh_tmp.face_normals()[:, None, :].repeat(3, axis=1)
    if normals:
        n_table = np.asarray(normals, dtype=np.float32)
        lens = np.linalg.norm(n_table, axis=-1, keepdims=True)
        n_table = n_table / np.maximum(lens, 1e-20)
        valid = n_idx >= 0
        n_arr[valid] = n_table[n_idx[valid]]

    # Build materials in slot order; unreferenced MTL defs are dropped like the
    # reference (only usemtl'd materials get slots).
    mtl_by_name = {m.name: m for m in mtl_materials}
    textures: list[Texture] = []
    tex_ids: dict[str, int] = {}

    def intern_texture(rel: str | None, gamma: float) -> None:
        if rel is None or rel in tex_ids or not load_textures:
            return
        tex = _load_texture(os.path.join(base_dir, rel), gamma)
        if tex is not None:
            tex_ids[rel] = base_texture_id + len(textures)
            textures.append(tex)

    num_slots = max(len(mat_slot_by_name), 1)
    materials: list[Material] = []
    slot_names = sorted(mat_slot_by_name, key=mat_slot_by_name.get)
    for slot in range(num_slots):
        name = slot_names[slot] if slot < len(slot_names) else None
        m = mtl_by_name.get(name) if name is not None else None
        if m is None:
            materials.append(Material())
            continue
        intern_texture(m.map_kd, gamma=2.2)
        intern_texture(m.map_ke, gamma=2.2)
        intern_texture(m.map_ns, gamma=1.0)
        intern_texture(m.map_metallic, gamma=1.0)
        intern_texture(m.map_bump, gamma=1.0)
        materials.append(_mtl_to_material(m, args, tex_ids))

    mesh = Mesh(
        vertices=verts,
        triangles=tris,
        normals=n_arr,
        uvs=uv_arr,
        material_ids=np.asarray(tri_mat, dtype=np.uint16),
        name=os.path.basename(path),
    )
    return WavefrontResult(mesh=mesh, materials=materials, textures=textures)
