"""Scene → device pack (port of ``luminary_tpu/render/device_scene.py``).

Geometry, materials, lights, textures and shade tables are packed in host
numpy (the same code as the reference, so every word compares) and uploaded
once; the sky's atmosphere LUTs and bakes run in PyTorch on the target
device. The shade tables are stored one slot per row, ``[P, 16]`` i32 (64
bytes): the hot table ``shade_hot`` (SHP_* columns, read at every hit) and
the aux table ``shade_aux`` (SHA_* columns: UVs, texture ids, the mip LOD
base and the normal-map tangent edges, read when textures are on). The
reference's 8-slots-per-row interleave existed only for the TPU's
gather-size knee. Quantized words are bit-identical per slot.

The aux table keeps the reference's f16 tangent edges (``SHA_E1XY`` ..
``SHA_E2YZ``) for parity: an edge component above 65504 world units packs
as inf, and a normal map on that triangle then gives a NaN shading normal,
as in the reference.

The sky packs in all three modes (DEFAULT, HDRI baked or from a user map,
CONSTANT_COLOR), and for spectral rendering a DEFAULT sky is baked a second
time at the 8 sky bands on the card; the ocean adds its water material (and,
tessellated, its mesh) and the water and cloud parameters ride along. An
active particle field packs its quads, in tile coordinates, into a BVH of
their own (``DeviceParticles``) and adds the particle material after the
water's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..bvh.native import build_wide_native
from ..device import resolve_device
from ..ops.clouds import DeviceClouds, pack_clouds
from ..ops.ggx import ggx_energy_quad
from ..ops.lights import DeviceLights, build_alias_table, lights_to_device, pack_lights_np
from ..ops.textures import (
    PAGE_RES,
    DeviceTextures,
    pack_textures,
    page_resolutions,
)
from ..ops.traverse import DeviceBVH, pack_device_bvh
from ..ops.vec import Vec3
from ..ops.procedural import (
    OCEAN_INSTANCE_ID,
    generate_ocean_mesh,
    generate_particles,
)
from ..ops.volume import DeviceFog, DeviceWater, pack_fog, pack_water
from ..scene.entities import TEXTURE_NONE, Material, MaterialBaseSubstrate
from ..scene.scene import Scene
from ..utils.errors import InvalidAPIArgumentError
from ..utils.log import info_message

MAT_FLAG_EMISSIVE = 1
MAT_FLAG_TRANSLUCENT = 2
MAT_FLAG_THIN_WALLED = 4

# Shade-row logical columns (one slot per row in the port).
SHP_N0 = 0            # oct snorm16 shading normal, corner 0
SHP_N1 = 1
SHP_N2 = 2
SHP_FACE = 3          # oct snorm16 geometric normal
SHP_IDS = 4           # mat_id u16 | (instance_id + 1) u16
SHP_ALB_RG = 5        # albedo r|g f16
SHP_ALB_BA = 6        # albedo b|a f16
SHP_EM_RG = 7         # emission r|g f16 (pre-scaled)
SHP_EM_B_ROUGH = 8    # emission b | roughness f16
SHP_METAL_IOR = 9     # metallic | ior f16
SHP_FLAGS = 10        # u32 material flags
SHP_SEL_PDF = 11      # f32 light selection pdf of this slot
SHP_AREA = 12         # f32 triangle area
SHP_PRIM = 13         # i32 source primitive id
SHP_COLS = 16
SHP_SUB_REFERENCE = 8  # slots per row in the JAX package's packed table

# Aux shade-row logical columns (read only when textures are on).
SHA_UV0 = 0           # u0|v0 f16
SHA_UV1 = 1           # u1|v1
SHA_UV2 = 2           # u2|v2
SHA_TEX_AR = 3        # albedo_tex i16 | rough_tex i16 (-1 = none)
SHA_TEX_MN = 4        # metallic_tex i16 | normal_tex i16
SHA_TEX_L_ABBE = 5    # luminance_tex i16 | abbe f16
SHA_LOD = 6           # f32 log2(res_tex * sqrt(uv_area / world_area))
SHA_E1XY = 7          # e1.x|e1.y f16 (normal-map tangent frame)
SHA_E1Z2X = 8         # e1.z|e2.x f16
SHA_E2YZ = 9          # e2.y|e2.z f16
SHA_COLS = 16

# Fused light rows (light_slot_rows), dense light-index order.
LSR_V0 = 0
LSR_E1 = 3
LSR_E2 = 6
LSR_FACE_N = 9
LSR_EMISSION = 12
LSR_AREA = 15
LSR_SELECT_PDF = 16
LSR_SLOT = 17
LSR_COLS = 18
LSR_ALIAS_PROB = 18
LSR_ALIAS_ROW = 19
LSR_FUSED_COLS = 37
LSR_MICRO_OWN = 37       # cols 37:53 — micro cell weights of the light
LSR_MICRO_ALIAS = 53     # cols 53:69 — those of its alias partner
LSR_FUSED_MICRO_COLS = 69


class DeviceMaterials(NamedTuple):
    albedo_r: torch.Tensor  # f32 [M]
    albedo_g: torch.Tensor
    albedo_b: torch.Tensor
    albedo_a: torch.Tensor
    emission_r: torch.Tensor  # f32 [M] (pre-scaled by emission_scale)
    emission_g: torch.Tensor
    emission_b: torch.Tensor
    roughness: torch.Tensor
    metallic: torch.Tensor
    ior: torch.Tensor
    abbe: torch.Tensor  # f32 [M] dispersion Abbe number (0 = none)
    flags: torch.Tensor  # i32 [M]: bit0 emissive, bit1 translucent, bit2 thin
    albedo_tex: torch.Tensor  # i32 [M] texture ids (-1 = none)
    luminance_tex: torch.Tensor
    roughness_tex: torch.Tensor
    metallic_tex: torch.Tensor
    normal_tex: torch.Tensor


@dataclass
class DeviceSky:
    """Baked sky (DEFAULT), HDRI map or constant colour; host ints for
    shapes and modes."""

    mode: int
    constant_color: torch.Tensor  # f32 [3]
    sun_dir: torch.Tensor  # f32 [3]
    env_rows: torch.Tensor  # f32 [He*We, 16]
    env_h: int
    env_w: int
    env_alias_rows: torch.Tensor  # f32 [Kc, 8]
    env_cell_pdf: torch.Tensor  # f32 [Kc]
    env_ch: int
    env_cw: int
    env_nee_total: float
    # the 8-band bake of spectral rendering (DEFAULT skies): quad rows of
    # bands at (y, x), (y, x+1), (y+1, x), (y+1, x+1) and the disc's
    # spectrum; a dummy [1, 32] table and zeros otherwise
    env_spec_rows: torch.Tensor  # f32 [Hs*Ws, 32]
    env_spec_h: int
    env_spec_w: int
    sun_disc_spec: torch.Tensor  # f32 [8]
    aerial_rows: torch.Tensor  # f32 [NU*NS, 128] (dummy [1, 128] when off)
    sun_disc_radiance: torch.Tensor  # f32 [3]
    moon_dir: torch.Tensor  # f32 [3]
    moon_tex_offset: torch.Tensor  # f32 0-d
    stars_seed: int
    stars_count: int
    stars_intensity: torch.Tensor  # f32 0-d


class DeviceSceneGeo(NamedTuple):
    bvh: DeviceBVH
    n0: Vec3
    n1: Vec3
    n2: Vec3
    uv_u: Vec3  # [P] texture u at corners (0, 1, 2) in .x/.y/.z
    uv_v: Vec3  # [P] texture v at corners (0, 1, 2)
    material_id: torch.Tensor  # i32 [P]
    instance_id: torch.Tensor  # i32 [P]
    prim_id: torch.Tensor  # i32 [P]
    face_normal: Vec3


@dataclass
class DeviceParticles:
    """The tiled particle field: a second BVH over the quad soup in tile
    coordinates [0, scale)^3. The integrator wraps each lane's origin (plus
    the sample's motion offset, direction x speed x time: motion blur) into
    the tile and walks this table. Particles are seen on delta paths only
    and occlude nothing. Scalars are host floats holding float32 values."""

    bvh: DeviceBVH
    scale: float  # the tile's edge length
    motion: tuple  # (x, y, z): the field's direction x speed
    albedo: tuple  # (r, g, b)


class DeviceScene(NamedTuple):
    geo: DeviceSceneGeo
    materials: DeviceMaterials
    sky: DeviceSky
    lights: DeviceLights
    fog: DeviceFog
    water: DeviceWater
    clouds: DeviceClouds
    textures: DeviceTextures
    shade_hot: torch.Tensor  # i32 [P, SHP_COLS]
    shade_aux: torch.Tensor  # i32 [P, SHA_COLS]
    shade_micro: torch.Tensor  # f32 [P, 16] micro cell weights ([1, 16] without)
    light_slot_rows: torch.Tensor  # f32 [L, 37] ([L, 69] with micro weights)
    ggx_quad: torch.Tensor  # f32 [32*32, 4] energy-LUT quads
    particles: DeviceParticles | None = None


# ---- shade-row decoders (consumed by render/wavefront.py) ----

def unpack_f16_pair(bits_i32: torch.Tensor):
    """i32 of two f16 halves → (lo, hi) f32."""
    lo = (bits_i32 & 0xFFFF).to(torch.int16)
    hi = ((bits_i32 >> 16) & 0xFFFF).to(torch.int16)
    return (lo.view(torch.float16).to(torch.float32),
            hi.view(torch.float16).to(torch.float32))


def unpack_i16_pair(bits_i32: torch.Tensor):
    """i32 of two i16 halves → (lo, hi) sign-extended i32."""
    return (bits_i32 << 16) >> 16, bits_i32 >> 16


def unpack_oct_snorm16(bits_i32: torch.Tensor):
    """Octahedral snorm16 pair → unit direction components (x, y, z)."""
    u = ((bits_i32 << 16) >> 16).to(torch.float32) * (1.0 / 32767.0)
    v = (bits_i32 >> 16).to(torch.float32) * (1.0 / 32767.0)
    y = 1.0 - torch.abs(u) - torch.abs(v)
    neg = y < 0.0
    sx = torch.where(u >= 0.0, 1.0, -1.0)
    sz = torch.where(v >= 0.0, 1.0, -1.0)
    x = torch.where(neg, (1.0 - torch.abs(v)) * sx, u)
    z = torch.where(neg, (1.0 - torch.abs(u)) * sz, v)
    inv = torch.rsqrt(torch.clamp(x * x + y * y + z * z, min=1e-12))
    return x * inv, y * inv, z * inv


# ---- host packing (numpy) ----

def _f16_pair_np(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    l16 = lo.astype(np.float16).view(np.uint16).astype(np.uint32)
    h16 = hi.astype(np.float16).view(np.uint16).astype(np.uint32)
    return (l16 | (h16 << 16)).view(np.int32)


def _i16_pair_np(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    l16 = lo.astype(np.int16).view(np.uint16).astype(np.uint32)
    h16 = hi.astype(np.int16).view(np.uint16).astype(np.uint32)
    return (l16 | (h16 << 16)).view(np.int32)


def _oct_snorm16_np(n: np.ndarray) -> np.ndarray:
    """Unit vectors [K, 3] → octahedral snorm16 pair i32."""
    a = np.abs(n).sum(axis=-1, keepdims=True)
    v = n / np.maximum(a, 1e-12)
    uv = v[..., [0, 2]].copy()
    neg = v[..., 1] < 0.0
    flip = (1.0 - np.abs(uv[..., ::-1])) * np.where(uv >= 0.0, 1.0, -1.0)
    uv[neg] = flip[neg]
    q = np.clip(np.round(uv * 32767.0), -32767, 32767).astype(np.int32)
    return ((q[..., 0] & 0xFFFF) | (q[..., 1] << 16)).astype(np.int32)


def _euler_to_matrix(rotation) -> np.ndarray:
    rx, ry, rz = rotation
    cr, sr = np.cos(rx * 0.5), np.sin(rx * 0.5)
    cp, sp = np.cos(ry * 0.5), np.sin(ry * 0.5)
    cy, sy = np.cos(rz * 0.5), np.sin(rz * 0.5)
    w = cr * cp * cy + sr * sp * sy
    x = sr * cp * cy - cr * sp * sy
    y = cr * sp * cy + sr * cp * sy
    z = cr * cp * sy - sr * sp * cy
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float32,
    )


def flatten_instances(scene: Scene):
    """World-space triangle soup over all active instances (numpy) →
    (corners [T,3,3], normals [T,3,3], uvs [T,3,2], mat [T], inst [T],
    prim [T])."""
    corners_l, normals_l, uvs_l, mats_l, insts_l, prims_l = [], [], [], [], [], []
    for inst in scene.instances:
        if not inst.active or inst.mesh_id >= len(scene.meshes):
            continue
        mesh = scene.meshes[inst.mesh_id]
        if mesh.num_triangles == 0:
            continue
        rot = _euler_to_matrix(inst.rotation)
        scale = np.asarray(inst.scale, np.float32)
        pos = np.asarray(inst.position, np.float32)
        c = mesh.corner_positions() * scale
        c = c @ rot.T + pos
        n = mesh.normals / np.maximum(scale, 1e-20)
        n = n @ rot.T
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
        corners_l.append(c.astype(np.float32))
        normals_l.append(n.astype(np.float32))
        uvs_l.append(mesh.uvs)
        mats_l.append(mesh.material_ids.astype(np.int32))
        insts_l.append(np.full(mesh.num_triangles, inst.id, np.int32))
        prims_l.append(np.arange(mesh.num_triangles, dtype=np.int32))
    # the (opt-in) tessellated ocean: a camera-centred displaced grid with
    # the procedural water material (the analytic ocean adds no geometry)
    if scene.ocean.active and getattr(scene.ocean, "tessellated", False):
        oc_c, oc_n = generate_ocean_mesh(
            scene.ocean, center_xz=(scene.camera.pos[0], scene.camera.pos[2]))
        t_o = oc_c.shape[0]
        corners_l.append(oc_c)
        normals_l.append(oc_n)
        uvs_l.append(np.zeros((t_o, 3, 2), np.float32))
        mats_l.append(np.full(t_o, len(scene.materials) if scene.materials
                              else 1, np.int32))
        insts_l.append(np.full(t_o, OCEAN_INSTANCE_ID, np.int32))
        prims_l.append(np.arange(t_o, dtype=np.int32))
    if not corners_l:
        z = np.zeros((0, 3, 3), np.float32)
        e = np.zeros(0, np.int32)
        return z, z.copy(), np.zeros((0, 3, 2), np.float32), e, e.copy(), e.copy()
    return (np.concatenate(corners_l), np.concatenate(normals_l),
            np.concatenate(uvs_l), np.concatenate(mats_l),
            np.concatenate(insts_l), np.concatenate(prims_l))


class HostGeometry(NamedTuple):
    """Leaf-slot-ordered geometry in numpy, before upload."""

    wide: object
    v0: np.ndarray  # [P, 3]
    e1: np.ndarray
    e2: np.ndarray
    normals: np.ndarray  # [P, 3, 3] corner shading normals
    face_normal: np.ndarray  # [P, 3]
    material_id: np.ndarray  # i32 [P]
    instance_id: np.ndarray
    prim_id: np.ndarray
    uvs: np.ndarray | None = None  # [P, 3, 2] corner texture coordinates
    slot_alpha: np.ndarray | None = None  # f32 [P] where cutouts exist
    cut_grid: np.ndarray | None = None  # u16 [P, 64] cutout micro-alpha


def _cutout_micro_alpha(scene, mat_list, base_a, mat_slot, slot_uv,
                        slot_alpha) -> np.ndarray:
    """[P, 64] u16 micro-alpha grid of the cutout slots: each triangle's
    barycentric domain split into 8x8 (u, v) cells, each cell the mean
    albedo-texture alpha of a 2x2 stencil inside it (clamped into the
    triangle) times the material's base alpha; untextured cutouts hold
    their base alpha."""
    p = mat_slot.shape[0]
    grid = np.zeros((p, 64), np.uint16)
    cut = np.nonzero(slot_alpha < 1.0)[0]
    if cut.size == 0:
        return grid
    g, k = 8, 2
    cell_s, cell_t = np.meshgrid(np.arange(g), np.arange(g), indexing="xy")
    cell_s = cell_s.reshape(-1)  # cell = t * 8 + s
    cell_t = cell_t.reshape(-1)
    off = (np.arange(k) + 0.5) / k
    oi, oj = np.meshgrid(off, off, indexing="ij")
    su = (cell_s[:, None] + oi.reshape(-1)[None, :]) / g  # [64, k*k]
    sv = (cell_t[:, None] + oj.reshape(-1)[None, :]) / g
    sv = np.minimum(sv, np.maximum(1.0 - su - 1e-4, 0.0))
    sw = 1.0 - su - sv

    mat_of = np.clip(mat_slot[cut], 0, len(mat_list) - 1)
    base = base_a[mat_of]
    tex_of = np.asarray([
        int(mat_list[m].albedo_tex) if mat_list[m].albedo_tex != TEXTURE_NONE
        else -1 for m in mat_of])
    grid[cut] = np.clip(np.rint(base[:, None] * 65535.0), 0.0, 65535.0).astype(
        np.uint16)
    for tid in np.unique(tex_of):
        if tid < 0 or tid >= len(scene.textures):
            continue
        img = scene.textures[int(tid)].as_float()
        if img.ndim != 3 or img.shape[-1] != 4:
            continue
        rows = np.nonzero(tex_of == tid)[0]
        sids = cut[rows]
        uv = slot_uv[sids]  # [R, 3, 2]
        tu = (uv[:, None, None, 0, 0] * sw[None] + uv[:, None, None, 1, 0] * su[None]
              + uv[:, None, None, 2, 0] * sv[None])
        tv = (uv[:, None, None, 0, 1] * sw[None] + uv[:, None, None, 1, 1] * su[None]
              + uv[:, None, None, 2, 1] * sv[None])
        h, w = img.shape[0], img.shape[1]
        xi = np.clip(((tu % 1.0) * w).astype(np.int64), 0, w - 1)
        yi = np.clip(((tv % 1.0) * h).astype(np.int64), 0, h - 1)
        cellmean = img[yi, xi, 3].mean(axis=2) * base[rows][:, None]
        grid[sids] = np.clip(np.rint(cellmean * 65535.0), 0.0, 65535.0).astype(
            np.uint16)
    return grid


def pack_geometry_np(scene: Scene) -> HostGeometry:
    """Flatten, build the 16-wide BVH (native C++ builder) and lay every
    per-triangle attribute out in leaf-slot order; slots of materials whose
    alpha (base alpha x mean albedo-texture alpha) is below 1 are cutouts."""
    corners, normals, uvs, mats, insts, prims = flatten_instances(scene)
    t = corners.shape[0]
    wide = build_wide_native(corners)
    info_message("BVH16 built: %d tris, %d wide nodes, %d leaf blocks, depth %d",
                 t, wide.num_nodes, wide.num_blocks, wide.depth)

    order = wide.tri_order
    p = order.shape[0]
    valid = order >= 0
    safe = np.where(valid, order, 0)

    def slotify(arr, pad_value=0.0):
        out = arr[safe].copy()
        out[~valid] = pad_value
        return out

    c = slotify(corners) if t else np.zeros((p, 3, 3), np.float32)
    v0 = c[:, 0]
    e1 = c[:, 1] - c[:, 0]
    e2 = c[:, 2] - c[:, 0]
    v0[~valid] = 0.0
    e1[~valid] = 0.0
    e2[~valid] = 0.0
    fn = np.cross(e1, e2)
    fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    slot_n = slotify(normals) if t else np.zeros((p, 3, 3), np.float32)
    slot_uv = slotify(uvs) if t else np.zeros((p, 3, 2), np.float32)

    slot_alpha = cut_grid = None
    mat_list = scene.materials
    if mat_list:
        base_a = np.asarray([m.albedo[3] for m in mat_list], np.float32)
        tex_a = np.ones(len(mat_list), np.float32)
        for i, m in enumerate(mat_list):
            tid = m.albedo_tex
            if tid != TEXTURE_NONE and 0 <= int(tid) < len(scene.textures):
                img = scene.textures[int(tid)].as_float()
                if img.ndim == 3 and img.shape[-1] == 4:
                    tex_a[i] = float(img[..., 3].mean())
        alpha_per_mat = np.clip(base_a * tex_a, 0.0, 1.0)
        if (alpha_per_mat < 1.0).any():
            mat_slot = np.where(valid, mats[safe] if t else 0, 0).astype(np.int64)
            slot_alpha = alpha_per_mat[
                np.clip(mat_slot, 0, len(mat_list) - 1)].astype(np.float32)
            slot_alpha[~valid] = 1.0
            cut_grid = _cutout_micro_alpha(scene, mat_list, base_a, mat_slot,
                                           slot_uv, slot_alpha)
    return HostGeometry(
        wide=wide, v0=v0, e1=e1, e2=e2, normals=slot_n,
        face_normal=fn.astype(np.float32),
        material_id=np.where(valid, mats[safe] if t else 0, 0).astype(np.int32),
        instance_id=np.where(valid, insts[safe] if t else 0, -1).astype(np.int32),
        prim_id=np.where(valid, prims[safe] if t else 0, -1).astype(np.int32),
        uvs=slot_uv, slot_alpha=slot_alpha, cut_grid=cut_grid,
    )


def _t(a, device, dtype=None):
    """Upload a host array (always a private copy: packed numpy tables may
    be read-only views)."""
    return torch.as_tensor(np.array(a, dtype=dtype, copy=True, order="C"),
                           device=device)


def _v3(a, device) -> Vec3:
    return Vec3(_t(a[..., 0], device), _t(a[..., 1], device), _t(a[..., 2], device))


def upload_geometry(hg: HostGeometry, device) -> DeviceSceneGeo:
    return DeviceSceneGeo(
        bvh=pack_device_bvh(hg.wide, hg.v0, hg.e1, hg.e2, device,
                            slot_alpha=hg.slot_alpha,
                            slot_cut_grid=hg.cut_grid),
        n0=_v3(hg.normals[:, 0], device),
        n1=_v3(hg.normals[:, 1], device),
        n2=_v3(hg.normals[:, 2], device),
        uv_u=_v3(hg.uvs[:, :, 0], device),
        uv_v=_v3(hg.uvs[:, :, 1], device),
        material_id=_t(hg.material_id, device),
        instance_id=_t(hg.instance_id, device),
        prim_id=_t(hg.prim_id, device),
        face_normal=_v3(hg.face_normal, device),
    )


def procedural_materials(scene: Scene) -> list[Material]:
    """Materials appended after the user's: the ocean's water, then the
    particles' albedo (ids num_materials + 0 / + 1 as they are active)."""
    out = []
    if scene.ocean.active:
        out.append(Material(albedo=(0.9, 0.95, 1.0, 1.0),
                            base_substrate=MaterialBaseSubstrate.TRANSLUCENT,
                            refraction_index=scene.ocean.refractive_index,
                            roughness=0.05))
    if scene.particles.active:
        a = scene.particles.albedo
        out.append(Material(albedo=(a[0], a[1], a[2], 1.0), roughness=1.0))
    return out


def materials_np(scene: Scene) -> dict:
    """Material table as numpy arrays (DeviceMaterials fields), the
    procedural materials last."""
    mats = (scene.materials or [Material()]) + procedural_materials(scene)
    flags = np.zeros(len(mats), np.int32)
    for i, mat in enumerate(mats):
        f = 0
        if mat.emission_active:
            f |= MAT_FLAG_EMISSIVE
        if mat.base_substrate == MaterialBaseSubstrate.TRANSLUCENT:
            f |= MAT_FLAG_TRANSLUCENT
        if mat.thin_walled:
            f |= MAT_FLAG_THIN_WALLED
        flags[i] = f
    albedo = np.asarray([mat.albedo for mat in mats], np.float32)
    emission = np.asarray(
        [np.asarray(mat.emission) * mat.emission_scale for mat in mats], np.float32)

    def tex(name):
        return np.asarray([-1 if getattr(m, name) == TEXTURE_NONE
                           else int(getattr(m, name)) for m in mats], np.int32)

    return dict(
        albedo_r=albedo[:, 0].copy(), albedo_g=albedo[:, 1].copy(),
        albedo_b=albedo[:, 2].copy(), albedo_a=albedo[:, 3].copy(),
        emission_r=emission[:, 0].copy(), emission_g=emission[:, 1].copy(),
        emission_b=emission[:, 2].copy(),
        roughness=np.asarray([mat.roughness for mat in mats], np.float32),
        metallic=np.asarray([1.0 if mat.metallic else 0.0 for mat in mats], np.float32),
        ior=np.asarray([mat.refraction_index for mat in mats], np.float32),
        abbe=np.asarray([mat.abbe for mat in mats], np.float32),
        flags=flags,
        albedo_tex=tex("albedo_tex"), luminance_tex=tex("luminance_tex"),
        roughness_tex=tex("roughness_tex"), metallic_tex=tex("metallic_tex"),
        normal_tex=tex("normal_tex"),
    )


def _emission_tex_means(scene: Scene, hg: HostGeometry, mats: dict):
    """Per-slot emission-texture importance of emitters with a luminance
    map: 256 stratified points of the sqrt-warp domain per triangle, a
    nearest-texel repeat-wrap fetch of the linear source → (mean [P], the
    triangle's selection multiplier; cells [P, 16], the mean of each 4x4
    cell of the warp domain, floored at 2 % of the row's largest), or
    (None, None) when no emitter has a luminance map."""
    lum_tex = mats["luminance_tex"]
    emissive = (mats["flags"] & MAT_FLAG_EMISSIVE) != 0
    if not np.any(emissive & (lum_tex >= 0)):
        return None, None
    mat_ids = hg.material_id.astype(np.int64)
    tids = np.where(emissive[mat_ids], lum_tex[mat_ids], -1)
    valid = hg.prim_id >= 0
    mult = np.ones(mat_ids.shape[0], np.float32)
    cells = np.ones((mat_ids.shape[0], 16), np.float32)

    # 16x16 stratified (r1, r2) grid; cell (i, j) = points [4i:4i+4, 4j:4j+4],
    # the cells the sampler warps a uniform draw into
    g = (np.arange(16, dtype=np.float64) + 0.5) / 16.0
    r1, r2 = np.meshgrid(g, g, indexing="ij")
    su = np.sqrt(r1.ravel())
    b1 = (1.0 - su).astype(np.float32)
    b2 = (r2.ravel() * su).astype(np.float32)
    b0 = 1.0 - b1 - b2
    uu = hg.uvs[:, :, 0]
    vv = hg.uvs[:, :, 1]

    page_of = {}
    for i, tex in enumerate(scene.textures):
        if tex.as_float().ndim != 4:  # 3D textures are not atlas paged
            page_of[i] = len(page_of)
    for tid in np.unique(tids[valid & (tids >= 0)]):
        if int(tid) not in page_of:
            continue
        f = scene.textures[int(tid)].as_float()
        if f.shape[-1] == 1:
            lum = f[..., 0]
        else:
            lum = 0.2126 * f[..., 0] + 0.7152 * f[..., 1] + 0.0722 * f[..., 2]
        h, w = lum.shape[:2]
        sel = np.nonzero(valid & (tids == tid))[0]
        u = (uu[sel, 0:1] * b0[None] + uu[sel, 1:2] * b1[None]
             + uu[sel, 2:3] * b2[None])
        v = (vv[sel, 0:1] * b0[None] + vv[sel, 1:2] * b1[None]
             + vv[sel, 2:3] * b2[None])
        xi = np.clip(((u - np.floor(u)) * w).astype(np.int64), 0, w - 1)
        yi = np.clip(((v - np.floor(v)) * h).astype(np.int64), 0, h - 1)
        vals = lum[yi, xi].astype(np.float32)  # [S, 256]
        # floor: an emitter with any nonzero texel stays selectable
        mult[sel] = np.maximum(vals.mean(axis=1), 1e-3)
        c = vals.reshape(-1, 4, 4, 4, 4).mean(axis=(2, 4)).reshape(-1, 16)
        # a cell the 16-point estimate missed must stay reachable
        floor = 0.02 * c.max(axis=1, keepdims=True) + 1e-6
        cells[sel] = np.maximum(c, floor)
    return mult, cells


def pack_lights_for(hg: HostGeometry, mats: dict, scene: Scene | None = None) -> dict:
    """Emissive-triangle light set over the packed geometry (numpy fields).
    With ``scene``, emitters with a luminance map weight their selection by
    the map's triangle mean and carry its micro-cell weights."""
    emission = np.stack([mats["emission_r"], mats["emission_g"],
                         mats["emission_b"]], axis=-1)
    tex_lum_mean, micro_w = (_emission_tex_means(scene, hg, mats)
                             if scene is not None else (None, None))
    return pack_lights_np(
        tri_v0=hg.v0, tri_e1=hg.e1, tri_e2=hg.e2,
        material_id=hg.material_id, emission=emission,
        emissive_flags=(mats["flags"] & MAT_FLAG_EMISSIVE) != 0,
        valid_slot=hg.prim_id >= 0, tex_lum_mean=tex_lum_mean,
        micro_w=micro_w)


def pack_light_slot_rows(hg: HostGeometry, mats: dict, lights: dict) -> np.ndarray:
    """Compact fused light rows [L, 37]: cols 0:18 the light's block, col 18
    its alias acceptance probability, cols 19:37 its alias partner's block;
    with micro weights [L, 69], cols 37:53 the light's and 53:69 its alias
    partner's."""
    slots = np.asarray(lights["slot"]).astype(np.int64)
    l = max(len(slots), 1)
    has_micro = bool(lights.get("has_micro", False))
    ncols = LSR_FUSED_MICRO_COLS if has_micro else LSR_FUSED_COLS
    if int(lights["num_lights"]) == 0:
        return np.zeros((l, ncols), np.float32)
    base = np.zeros((l, LSR_COLS), np.float32)
    s = slots
    base[:, LSR_V0:LSR_V0 + 3] = hg.v0[s]
    base[:, LSR_E1:LSR_E1 + 3] = hg.e1[s]
    base[:, LSR_E2:LSR_E2 + 3] = hg.e2[s]
    base[:, LSR_FACE_N:LSR_FACE_N + 3] = hg.face_normal[s]
    m = hg.material_id.astype(np.int64)[s]
    base[:, LSR_EMISSION + 0] = mats["emission_r"][m]
    base[:, LSR_EMISSION + 1] = mats["emission_g"][m]
    base[:, LSR_EMISSION + 2] = mats["emission_b"][m]
    base[:, LSR_AREA] = lights["slot_area"][s]
    base[:, LSR_SELECT_PDF] = lights["select_pdf"]
    base[:, LSR_SLOT] = s.astype(np.int32).view(np.float32)
    alias = np.asarray(lights["alias"]).astype(np.int64)
    rows = np.zeros((l, ncols), np.float32)
    rows[:, :LSR_COLS] = base
    rows[:, LSR_ALIAS_PROB] = lights["prob"]
    rows[:, LSR_ALIAS_ROW:LSR_ALIAS_ROW + LSR_COLS] = base[alias]
    if has_micro:
        mr = np.asarray(lights["micro_rows"], np.float32)
        rows[:, LSR_MICRO_OWN:LSR_MICRO_OWN + 16] = mr
        rows[:, LSR_MICRO_ALIAS:LSR_MICRO_ALIAS + 16] = mr[alias]
    return rows


F16_MAX = 65504.0  # the largest finite f16: emission's limit in the shade row


def pack_shade_rows(hg: HostGeometry, mats: dict, lights: dict) -> np.ndarray:
    """Per-slot shade rows [P, SHP_COLS] i32 (one slot per row); every word
    equals the reference's packed word for that slot.

    Where the reference would wrap or overflow, this raises
    ``InvalidAPIArgumentError``: a material id or ``instance_id + 1`` that
    does not fit the word's 16 bits, or a pre-scaled emission component
    above 65504, the largest finite f16. The tessellated ocean's procedural
    instance id wraps as in the reference (its slots read back as
    instance 0)."""
    p = hg.material_id.shape[0]
    mat = hg.material_id.astype(np.int64)
    inst = hg.instance_id.astype(np.int64)
    user_inst = inst[inst != OCEAN_INSTANCE_ID]
    for name, v in (("material id", mat), ("instance id + 1", user_inst + 1)):
        if v.size and int(v.max()) > 0xFFFF:
            raise InvalidAPIArgumentError(
                "%s %d does not fit the shade row's 16 bits" % (name, int(v.max())))
    for ch in ("emission_r", "emission_g", "emission_b"):
        e = mats[ch][mat]
        if e.size and float(np.abs(e).max()) > F16_MAX:
            raise InvalidAPIArgumentError(
                "pre-scaled %s %g of a material in use exceeds the f16 maximum "
                "%g of the shade row" % (ch, float(np.abs(e).max()), F16_MAX))
    ids = ((mat & 0xFFFF) | (((inst + 1) & 0xFFFF) << 16)).astype(np.uint32)

    def f32(v):
        return np.asarray(v, np.float32).view(np.int32)

    out = np.zeros((p, SHP_COLS), np.int32)
    out[:, SHP_N0] = _oct_snorm16_np(hg.normals[:, 0])
    out[:, SHP_N1] = _oct_snorm16_np(hg.normals[:, 1])
    out[:, SHP_N2] = _oct_snorm16_np(hg.normals[:, 2])
    out[:, SHP_FACE] = _oct_snorm16_np(hg.face_normal)
    out[:, SHP_IDS] = ids.view(np.int32)
    out[:, SHP_ALB_RG] = _f16_pair_np(mats["albedo_r"][mat], mats["albedo_g"][mat])
    out[:, SHP_ALB_BA] = _f16_pair_np(mats["albedo_b"][mat], mats["albedo_a"][mat])
    out[:, SHP_EM_RG] = _f16_pair_np(mats["emission_r"][mat], mats["emission_g"][mat])
    out[:, SHP_EM_B_ROUGH] = _f16_pair_np(mats["emission_b"][mat], mats["roughness"][mat])
    out[:, SHP_METAL_IOR] = _f16_pair_np(mats["metallic"][mat], mats["ior"][mat])
    out[:, SHP_FLAGS] = mats["flags"][mat].astype(np.int32)
    out[:, SHP_SEL_PDF] = f32(lights["slot_select_pdf"])
    out[:, SHP_AREA] = f32(lights["slot_area"])
    out[:, SHP_PRIM] = hg.prim_id.astype(np.int32)
    return out


def pack_shade_aux(hg: HostGeometry, mats: dict, tex_res) -> np.ndarray:
    """Per-slot aux rows [P, SHA_COLS] i32 (one slot per row); every word
    equals the reference's packed word for that slot. ``tex_res``: the
    textures' level-0 page resolutions, for the mip LOD base."""
    p = hg.material_id.shape[0]
    mat = hg.material_id.astype(np.int64)
    at = mats["albedo_tex"][mat]
    if tex_res is not None and len(tex_res):
        res_slot = np.where(at >= 0, np.asarray(tex_res)[np.maximum(at, 0)],
                            PAGE_RES).astype(np.float64)
    else:
        res_slot = np.float64(PAGE_RES)
    e1, e2 = hg.e1, hg.e2
    world_area2 = np.maximum(np.linalg.norm(np.cross(e1, e2), axis=-1), 1e-20)
    uu, vv = hg.uvs[:, :, 0], hg.uvs[:, :, 1]
    du1, dv1 = uu[:, 1] - uu[:, 0], vv[:, 1] - vv[:, 0]
    du2, dv2 = uu[:, 2] - uu[:, 0], vv[:, 2] - vv[:, 0]
    uv_area2 = np.abs(du1 * dv2 - du2 * dv1)
    lod_base = np.where(
        uv_area2 > 1e-20,
        np.log2(res_slot * np.sqrt(uv_area2 / world_area2) + 1e-20),
        0.0).astype(np.float32)
    out = np.zeros((p, SHA_COLS), np.int32)
    out[:, SHA_UV0] = _f16_pair_np(uu[:, 0], vv[:, 0])
    out[:, SHA_UV1] = _f16_pair_np(uu[:, 1], vv[:, 1])
    out[:, SHA_UV2] = _f16_pair_np(uu[:, 2], vv[:, 2])
    out[:, SHA_TEX_AR] = _i16_pair_np(at, mats["roughness_tex"][mat])
    out[:, SHA_TEX_MN] = _i16_pair_np(mats["metallic_tex"][mat],
                                      mats["normal_tex"][mat])
    out[:, SHA_TEX_L_ABBE] = (
        (mats["luminance_tex"][mat].astype(np.int16).view(np.uint16)
         .astype(np.uint32))
        | (mats["abbe"][mat].astype(np.float16).view(np.uint16).astype(np.uint32)
           << 16)).view(np.int32)
    out[:, SHA_LOD] = lod_base.view(np.int32)
    out[:, SHA_E1XY] = _f16_pair_np(e1[:, 0], e1[:, 1])
    out[:, SHA_E1Z2X] = _f16_pair_np(e1[:, 2], e2[:, 0])
    out[:, SHA_E2YZ] = _f16_pair_np(e2[:, 1], e2[:, 2])
    return out


def pack_shade_micro(hg: HostGeometry, lights: dict) -> np.ndarray:
    """Slot-space micro cell weights [P, 16] f32, normalised so that a hit
    multiplies its NEE pdf by them directly (16 w / sum w); [1, 16] of
    zeros without micro weights."""
    if not lights.get("has_micro", False):
        return np.zeros((1, 16), np.float32)
    mr = np.asarray(lights["micro_rows"])
    micro = np.ones((hg.material_id.shape[0], 16), np.float32)
    micro[np.asarray(lights["slot"])] = (
        16.0 * mr / np.maximum(mr.sum(axis=1, keepdims=True), 1e-20))
    return micro


def sun_direction(azimuth: float, altitude: float) -> np.ndarray:
    return np.array(
        [np.cos(azimuth) * np.cos(altitude), np.sin(altitude),
         np.sin(azimuth) * np.cos(altitude)], dtype=np.float32)


def env_to_rows(env: np.ndarray) -> np.ndarray:
    """Lat-long env [H, W, 3] → bilinear-quad rows [H*W, 16]."""
    h, w = env.shape[:2]
    rows = np.zeros((h * w, 16), np.float32)
    rows[:, 0:3] = env.reshape(-1, 3)
    rows[:, 4:7] = np.roll(env, -1, axis=1).reshape(-1, 3)
    dn = env[np.minimum(np.arange(h) + 1, h - 1)]
    rows[:, 8:11] = dn.reshape(-1, 3)
    rows[:, 12:15] = np.roll(dn, -1, axis=1).reshape(-1, 3)
    return rows


def env_to_rows_spec(env8: np.ndarray) -> np.ndarray:
    """8-band env [H, W, 8] → bilinear-quad rows [H*W, 32]: the bands at
    (y, x), (y, x+1), (y+1, x), (y+1, x+1)."""
    h, w = env8.shape[:2]
    rows = np.zeros((h * w, 32), np.float32)
    rows[:, 0:8] = env8.reshape(-1, 8)
    rows[:, 8:16] = np.roll(env8, -1, axis=1).reshape(-1, 8)
    dn = env8[np.minimum(np.arange(h) + 1, h - 1)]
    rows[:, 16:24] = dn.reshape(-1, 8)
    rows[:, 24:32] = np.roll(dn, -1, axis=1).reshape(-1, 8)
    return rows


def bake_sky_spectral(scene: Scene, env_w: int, device):
    """The 8-band DEFAULT atmosphere on ``device``: (env [Hs, Ws, 8] with
    Ws = max(env_w / 2, 64), Hs = Ws / 2, the disc's spectrum [8])."""
    from ..ops.atmosphere import (
        atmo_params_from_sky, bake_sky_envmap, build_multiscatter_lut,
        build_transmittance_lut, sample_transmittance_lut,
    )
    from ..ops.sky import SUN_IRRADIANCE, SUN_RADIANCE
    from ..ops.spectral import sun_irradiance_bands

    sky = scene.sky

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    p8 = atmo_params_from_sky(sky, device, spectral=True)
    t_lut8 = build_transmittance_lut(p8)
    ms_lut8 = build_multiscatter_lut(p8, t_lut8)
    h_obs = f32(max(float(sky.geometry_offset[1]), 0.001))
    sun_dir_t = f32(sun_direction(sky.azimuth, sky.altitude))
    bands = f32(sun_irradiance_bands())
    irr8 = bands * f32(SUN_IRRADIANCE * sky.sun_strength)
    sw = max(env_w // 2, 64)
    env8 = bake_sky_envmap(p8, t_lut8, ms_lut8, h_obs, sun_dir_t, irr8,
                           width=sw, height=sw // 2,
                           steps=int(min(max(sky.steps, 8), 64)))
    t_sun8 = sample_transmittance_lut(t_lut8, h_obs, sun_dir_t[1])
    disc8 = t_sun8 * bands * f32(SUN_RADIANCE * sky.sun_strength)
    return env8, disc8


def _build_env_nee(env: np.ndarray, is_constant: bool):
    """Cell-grid importance distribution over the baked env map (built
    always, as in the reference; env NEE itself is an HDRI-only strategy)."""
    h, w = env.shape[0], env.shape[1]
    ch = int(min(64, max(h, 1)))
    cw = int(min(128, max(w, 1)))
    empty = (np.zeros((1, 8), np.float32), np.zeros((1,), np.float32), 1, 1, 0.0)
    if is_constant or h < 4:
        return empty
    lum = (0.2126 * env[..., 0] + 0.7152 * env[..., 1]
           + 0.0722 * env[..., 2]).astype(np.float64)
    ys = (np.arange(h) * ch // h).clip(0, ch - 1)
    xs = (np.arange(w) * cw // w).clip(0, cw - 1)
    cell_sum = np.zeros((ch, cw), np.float64)
    cell_cnt = np.zeros((ch, cw), np.float64)
    np.add.at(cell_sum, (ys[:, None], xs[None, :]), lum * np.ones((1, w)))
    np.add.at(cell_cnt, (ys[:, None], xs[None, :]), np.ones((h, w)))
    cell_mean = cell_sum / np.maximum(cell_cnt, 1.0)
    theta = np.linspace(0.0, np.pi, ch + 1)
    band = np.cos(theta[:-1]) - np.cos(theta[1:])
    omega = (2.0 * np.pi / cw) * band[:, None] * np.ones((1, cw))
    weight = (cell_mean * omega).reshape(-1)
    total = float(weight.sum())
    if total <= 0.0:
        return empty
    p_cell = weight / total
    pdf_sr = (p_cell / np.maximum(omega.reshape(-1), 1e-12)).astype(np.float32)
    prob, alias = build_alias_table(weight)
    k = weight.shape[0]
    rows = np.zeros((k, 8), np.float32)
    rows[:, 0] = prob
    rows[:, 1] = np.arange(k, dtype=np.int32).view(np.float32)
    rows[:, 2] = pdf_sr
    rows[:, 3] = alias.astype(np.int32).view(np.float32)
    rows[:, 4] = pdf_sr[alias]
    return rows, pdf_sr, ch, cw, total


def _latlong_dirs(height: int, width: int) -> np.ndarray:
    """Unit direction per lat-long texel centre → f32 [H*W, 3] (y up)."""
    v = (np.arange(height) + 0.5) / height
    u = (np.arange(width) + 0.5) / width
    theta = v * np.pi
    phi = u * 2.0 * np.pi
    st = np.sin(theta)[:, None]
    d = np.stack([np.broadcast_to(st * np.cos(phi)[None, :], (height, width)),
                  np.broadcast_to(np.cos(theta)[:, None], (height, width)),
                  np.broadcast_to(st * np.sin(phi)[None, :], (height, width))],
                 axis=-1)
    return d.reshape(-1, 3).astype(np.float32)


def _bake_hdri_extras(scene: Scene, env: torch.Tensor, sun_dir: np.ndarray,
                      sun_disc: torch.Tensor) -> torch.Tensor:
    """HDRI mode folds moon, stars and the cloud layers into the baked map
    [H, W, 3] (on its device); only the solar disc stays analytic."""
    from types import SimpleNamespace

    from ..ops.clouds import active_layer_indices, cloud_march
    from ..ops.sky import moon_radiance, stars_radiance

    device = env.device
    h, w = env.shape[:2]
    dirs = torch.as_tensor(_latlong_dirs(h, w), device=device)
    d = Vec3(dirs[:, 0], dirs[:, 1], dirs[:, 2])
    sky = scene.sky

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    dsky = SimpleNamespace(
        sun_dir=f32(sun_dir),
        moon_dir=f32(sun_direction(sky.moon_azimuth, sky.moon_altitude)),
        moon_tex_offset=f32(sky.moon_tex_offset),
        stars_seed=int(sky.stars_seed), stars_count=int(sky.stars_count),
        stars_intensity=f32(sky.stars_intensity))
    moon, in_moon = moon_radiance(dsky, d)
    stars = stars_radiance(dsky, d, fused=False)  # the reference's eager bake
    ch = [env[:, :, c].reshape(-1) + (moon + torch.where(in_moon, 0.0, stars[c]))
          for c in range(3)]
    cloud_layers = active_layer_indices(scene.cloud)
    if cloud_layers:
        n = h * w
        cam = scene.camera.pos
        origin = Vec3(torch.full((n,), float(cam[0]), device=device),
                      torch.full((n,), max(float(cam[1]), 0.1), device=device),
                      torch.full((n,), float(cam[2]), device=device))
        sun_v = Vec3(*(f32(c) for c in sun_dir))
        (cr, cg, cb), ct = cloud_march(
            pack_clouds(scene.cloud), origin, d, sun_v, sun_disc, tuple(ch),
            steps=int(min(max(scene.cloud.steps, 16), 96)), layers=cloud_layers)
        ch = [cr + ch[0] * ct, cg + ch[1] * ct, cb + ch[2] * ct]
    return torch.stack(ch, dim=-1).reshape(h, w, 3)


def pack_sky(scene: Scene, device) -> DeviceSky:
    """Atmosphere LUTs + environment and aerial bakes, in PyTorch on
    ``device``. DEFAULT bakes the atmosphere at twice the image width;
    HDRI bakes it at ``sky.hdri_dim`` with moon, stars and clouds folded in
    (or takes ``scene.sky_hdri``, a user's lat-long image, verbatim, its
    lighting all in the map); CONSTANT_COLOR packs an empty map."""
    from ..ops.atmosphere import (
        atmo_params_from_sky, bake_aerial_rows, bake_sky_envmap,
        build_multiscatter_lut, build_transmittance_lut,
        sample_transmittance_lut,
    )
    from ..ops.sky import SUN_IRRADIANCE, SUN_RADIANCE

    sky = scene.sky
    mode = int(sky.mode)
    sun_dir = sun_direction(sky.azimuth, sky.altitude)
    is_constant = mode == 2
    is_hdri = mode == 1
    user_env = getattr(scene, "sky_hdri", None)
    if is_hdri:
        w = max(256, min(2048, int(sky.hdri_dim)))
    else:
        w = max(128, min(1024, 2 * scene.settings.width))
    env_res = (w // 2, w)

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    aerial = torch.zeros((1, 128), dtype=torch.float32, device=device)
    if is_constant:
        env = np.zeros((4, 8, 3), np.float32)
        sun_disc = f32(np.zeros(3))
    elif is_hdri and user_env is not None:
        env = np.asarray(user_env, np.float32)
        if env.ndim != 3 or env.shape[-1] < 3:
            raise ValueError("sky_hdri must be a [H, W, >=3] lat-long image")
        env = np.ascontiguousarray(env[..., :3])
        sun_disc = f32(np.zeros(3))
    else:
        p = atmo_params_from_sky(sky, device)
        sun_dir_t = f32(sun_dir)
        t_lut = build_transmittance_lut(p)
        ms_lut = build_multiscatter_lut(p, t_lut)
        h_obs = f32(max(float(sky.geometry_offset[1]), 0.001))
        sun_irr = f32(SUN_IRRADIANCE * sky.sun_strength)
        env_t = bake_sky_envmap(
            p, t_lut, ms_lut, h_obs, sun_dir_t, sun_irr,
            width=env_res[1], height=env_res[0],
            steps=int(min(max(sky.steps, 8), 64)))
        sun_t = sample_transmittance_lut(t_lut, h_obs, sun_dir_t[1])
        sun_disc = sun_t * f32(SUN_RADIANCE * sky.sun_strength)
        if is_hdri:
            env_t = _bake_hdri_extras(scene, env_t, sun_dir, sun_disc)
        env = env_t.cpu().numpy()
        if not is_hdri and getattr(scene.settings, "aerial_perspective", True):
            aerial = bake_aerial_rows(p, t_lut, ms_lut, h_obs, sun_dir_t, sun_irr)

    # the 8-band bake (DEFAULT and baked HDRI skies; a user map and a
    # constant sky uplift their RGB at shading time instead)
    if (getattr(scene.settings, "spectral_rendering", False)
            and not is_constant and not (is_hdri and user_env is not None)):
        env8, sun_disc_spec = bake_sky_spectral(scene, env_res[1], device)
        env_spec_rows = _t(env_to_rows_spec(env8.cpu().numpy()), device)
        env_spec_h, env_spec_w = int(env8.shape[0]), int(env8.shape[1])
    else:
        env_spec_rows = _t(env_to_rows_spec(np.zeros((1, 1, 8), np.float32)),
                           device)
        env_spec_h = env_spec_w = 1
        sun_disc_spec = f32(np.zeros(8))

    alias_rows, cell_pdf, ch, cw, nee_total = _build_env_nee(env, is_constant)
    return DeviceSky(
        mode=mode,
        constant_color=f32(sky.constant_color),
        sun_dir=f32(sun_dir),
        env_rows=_t(env_to_rows(env), device),
        env_h=int(env.shape[0]),
        env_w=int(env.shape[1]),
        env_alias_rows=_t(alias_rows, device),
        env_cell_pdf=_t(cell_pdf, device),
        env_ch=int(ch),
        env_cw=int(cw),
        env_nee_total=float(np.float32(nee_total)),
        env_spec_rows=env_spec_rows,
        env_spec_h=env_spec_h,
        env_spec_w=env_spec_w,
        sun_disc_spec=sun_disc_spec,
        aerial_rows=aerial,
        sun_disc_radiance=sun_disc,
        moon_dir=f32(sun_direction(sky.moon_azimuth, sky.moon_altitude)),
        moon_tex_offset=f32(sky.moon_tex_offset),
        stars_seed=int(sky.stars_seed),
        stars_count=int(sky.stars_count),
        stars_intensity=f32(sky.stars_intensity),
    )


def pack_particles_device(particles, device) -> DeviceParticles | None:
    """The particle field's quads → a tile-space wide BVH on ``device``
    (None when the field is off or empty)."""
    if not particles.active or int(particles.count) <= 0:
        return None
    corners, _normals = generate_particles(particles)
    wide = build_wide_native(corners)
    order = wide.tri_order
    valid = order >= 0
    c = corners[np.where(valid, order, 0)].copy()
    c[~valid] = 0.0
    v0 = c[:, 0]
    e1 = c[:, 1] - c[:, 0]
    e2 = c[:, 2] - c[:, 0]
    motion = sun_direction(float(particles.direction_azimuth),
                           float(particles.direction_altitude)
                           ) * np.float32(particles.speed)
    return DeviceParticles(
        bvh=pack_device_bvh(wide, v0, e1, e2, device),
        scale=float(np.float32(max(float(particles.scale), 1e-6))),
        motion=tuple(float(m) for m in motion.astype(np.float32)),
        albedo=tuple(float(a) for a in np.asarray(particles.albedo, np.float32)),
    )


def pack_scene(scene: Scene, device=None) -> DeviceScene:
    """Full scene pack on ``device``; None means the card, and raises
    without one."""
    device = resolve_device(device)
    hg = pack_geometry_np(scene)
    mats = materials_np(scene)
    lights = pack_lights_for(hg, mats, scene=scene)
    return DeviceScene(
        geo=upload_geometry(hg, device),
        materials=DeviceMaterials(**{k: _t(v, device) for k, v in mats.items()}),
        sky=pack_sky(scene, device),
        lights=lights_to_device(lights, device),
        fog=pack_fog(scene.fog),
        water=pack_water(scene.ocean),
        clouds=pack_clouds(scene.cloud),
        textures=pack_textures(scene.textures, device),
        shade_hot=_t(pack_shade_rows(hg, mats, lights), device),
        shade_aux=_t(pack_shade_aux(hg, mats, page_resolutions(scene.textures)),
                     device),
        shade_micro=_t(pack_shade_micro(hg, lights), device),
        light_slot_rows=_t(pack_light_slot_rows(hg, mats, lights), device),
        ggx_quad=_t(ggx_energy_quad(), device),
        particles=pack_particles_device(scene.particles, device),
    )


def unpack_reference_shade_rows(packed: np.ndarray, p: int) -> np.ndarray:
    """The reference's [ceil(P/8), 128] interleaved table (slot s at
    [s >> 3, c * 8 + (s & 7)]) → one slot per row [P, 16]."""
    r = packed.shape[0]
    sub = SHP_SUB_REFERENCE
    n_cols = packed.shape[1] // sub
    return (np.asarray(packed).reshape(r, n_cols, sub).transpose(0, 2, 1)
            .reshape(r * sub, n_cols)[:p].astype(np.int32))


def from_jax_arrays(tree: dict, device):
    """The JAX package's DeviceScene and DeviceCamera, flattened to nested
    dicts of numpy arrays and numbers (``tree["scene"]``, ``tree["camera"]``,
    field names as in the reference), → the port's (DeviceScene,
    DeviceCamera). The interleaved shade tables become one slot per row;
    depth and num_nodes are kept. The particle field (``scene["particles"]``,
    None when off), the 8-band sky tables and the lens prescription
    (``camera["phys"]``, None for a thin lens) come along."""
    from ..ops.camera import DeviceCamera
    from ..ops.camera_physical import DevicePhysicalCamera

    s = tree["scene"]
    g = s["geo"]

    def v3(x):
        return Vec3(*(_t(np.asarray(c, np.float32), device) for c in x))

    def opt(x, dtype):
        return None if x is None else _t(np.asarray(x, dtype), device)

    def bvh_of(b):
        return DeviceBVH(
            rows=_t(np.asarray(b["rows"], np.float32), device),
            tri_v0=v3(b["tri_v0"]), tri_e1=v3(b["tri_e1"]),
            tri_e2=v3(b["tri_e2"]),
            dense_tris=opt(b["dense_tris"], np.float32),
            dense_slot=opt(b["dense_slot"], np.int32),
            bounds=_t(np.asarray(b["bounds"], np.float32), device),
            depth=int(b["depth"]), num_nodes=int(b["num_nodes"]),
            rows_shadow=opt(b["rows_shadow"], np.float32),
            cut_tris=opt(b["cut_tris"], np.float32),
        )

    bvh = bvh_of(g["bvh"])
    p = int(np.asarray(g["material_id"]).shape[0])
    geo = DeviceSceneGeo(
        bvh=bvh, n0=v3(g["n0"]), n1=v3(g["n1"]), n2=v3(g["n2"]),
        uv_u=v3(g["uv_u"]), uv_v=v3(g["uv_v"]),
        material_id=_t(np.asarray(g["material_id"], np.int32), device),
        instance_id=_t(np.asarray(g["instance_id"], np.int32), device),
        prim_id=_t(np.asarray(g["prim_id"], np.int32), device),
        face_normal=v3(g["face_normal"]),
    )
    m = s["materials"]
    int_fields = ("flags", "albedo_tex", "luminance_tex", "roughness_tex",
                  "metallic_tex", "normal_tex")
    mats = DeviceMaterials(**{
        k: _t(np.asarray(m[k]).astype(np.int32 if k in int_fields else np.float32),
              device)
        for k in DeviceMaterials._fields})
    k = s["sky"]

    def f32(v):
        return _t(np.asarray(v, np.float32), device)

    sky = DeviceSky(
        mode=int(k["mode"]), constant_color=f32(k["constant_color"]),
        sun_dir=f32(k["sun_dir"]), env_rows=f32(k["env_rows"]),
        env_h=int(k["env_h"]), env_w=int(k["env_w"]),
        env_alias_rows=f32(k["env_alias_rows"]),
        env_cell_pdf=f32(k["env_cell_pdf"]), env_ch=int(k["env_ch"]),
        env_cw=int(k["env_cw"]), env_nee_total=float(k["env_nee_total"]),
        env_spec_rows=f32(k["env_spec_rows"]),
        env_spec_h=int(k["env_spec_h"]), env_spec_w=int(k["env_spec_w"]),
        sun_disc_spec=f32(k["sun_disc_spec"]),
        aerial_rows=f32(k["aerial_rows"]),
        sun_disc_radiance=f32(k["sun_disc_radiance"]),
        moon_dir=f32(k["moon_dir"]), moon_tex_offset=f32(k["moon_tex_offset"]),
        stars_seed=int(k["stars_seed"]), stars_count=int(k["stars_count"]),
        stars_intensity=f32(k["stars_intensity"]),
    )
    li = s["lights"]
    lights = lights_to_device(dict(
        prob=np.asarray(li["prob"], np.float32),
        alias=np.asarray(li["alias"], np.int32),
        slot=np.asarray(li["slot"], np.int32),
        select_pdf=np.asarray(li["select_pdf"], np.float32),
        slot_select_pdf=np.asarray(li["slot_select_pdf"], np.float32),
        slot_area=np.asarray(li["slot_area"], np.float32),
        num_lights=int(li["num_lights"]),
        total_power=float(li["total_power"]),
        tree_rows=np.asarray(li["tree_rows"], np.float32),
        tree_num_nodes=int(li["tree_num_nodes"]),
        tree_levels=int(li["tree_levels"]),
        micro_rows=np.asarray(li["micro_rows"], np.float32),
        has_micro=bool(li["has_micro"]),
    ), device)
    fo = s["fog"]
    fog = DeviceFog(active=bool(fo["active"]), sigma_t=float(fo["sigma_t"]),
                    scatter_albedo=float(fo["scatter_albedo"]),
                    height=float(fo["height"]), max_dist=float(fo["max_dist"]),
                    g=float(fo["g"]))
    wa = s["water"]
    water = DeviceWater(
        active=bool(wa["active"]),
        absorb=tuple(float(np.float32(a)) for a in np.asarray(wa["absorb"])),
        **{k: float(np.float32(wa[k])) for k in (
            "scatter", "mol_weight", "height", "amplitude", "frequency", "ior",
            "caustics_scale")})
    cl = s["clouds"]
    clouds = DeviceClouds(
        active=bool(cl["active"]),
        **{k: tuple(float(np.float32(v)) for v in np.asarray(cl[k]))
           for k in ("height_min", "height_max", "coverage", "coverage_min",
                     "offset")},
        **{k: float(np.float32(cl[k])) for k in (
            "density", "shape_scale", "detail_scale", "weather_scale", "seed")})
    tx = s["textures"]
    textures = DeviceTextures(rows=f32(tx["rows"]),
                              page_table=_t(np.asarray(tx["page_table"], np.int32),
                                            device),
                              num_pages=int(tx["num_pages"]))
    scene = DeviceScene(
        geo=geo, materials=mats, sky=sky, lights=lights, fog=fog,
        water=water, clouds=clouds, textures=textures,
        shade_hot=_t(unpack_reference_shade_rows(
            np.asarray(s["shade_hot"]), p), device),
        shade_aux=_t(unpack_reference_shade_rows(
            np.asarray(s["shade_aux"]), p), device),
        shade_micro=f32(s["shade_micro"]),
        light_slot_rows=f32(s["light_slot_rows"]),
        ggx_quad=_t(ggx_energy_quad(), device),
        particles=None if s.get("particles") is None else DeviceParticles(
            bvh=bvh_of(s["particles"]["bvh"]),
            scale=float(np.float32(s["particles"]["scale"])),
            motion=tuple(float(np.float32(m))
                         for m in np.asarray(s["particles"]["motion"])),
            albedo=tuple(float(np.float32(a))
                         for a in np.asarray(s["particles"]["albedo"]))),
    )
    c = tree["camera"]
    ph = c.get("phys")
    cam = DeviceCamera(
        pos=f32(c["pos"]), rotation_q=f32(c["rotation_q"]), fov=f32(c["fov"]),
        aperture_size=f32(c["aperture_size"]),
        aperture_blade_count=_t(c["aperture_blade_count"], device, np.int32),
        aperture_shape_bladed=_t(c["aperture_shape_bladed"], device, np.bool_),
        object_distance=f32(c["object_distance"]),
        camera_scale=f32(c["camera_scale"]),
        phys=None if ph is None else DevicePhysicalCamera(
            **{k: f32(ph[k]) for k in DevicePhysicalCamera._fields
               if k != "spectral"},
            spectral=_t(np.asarray(ph["spectral"], np.bool_), device)),
    )
    return scene, cam
