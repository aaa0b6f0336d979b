"""The wavefront path-tracing integrator (port of
``luminary_tpu/render/wavefront.py``).

One lane per pixel, flat ``[N]`` SoA state. Each depth traces the wavefront
(kernel B), samples fog collisions, fetches one shade row per hit (kernel A;
per-field gathers for tables up to SMALL_TABLE_SLOTS) and, with textures,
one aux row (UVs, texture ids, the LOD base, the tangent edges), applies
the albedo, roughness, metallic, luminance and normal maps, shades
GGX/Lambert/dielectric lobes or the fog's HG phase, runs sun NEE with sun
RIS and triangle-light NEE with RIS (candidate 0 from the light tree, kernel
C, in many-light scenes; micro-cell emission importance for emitters with a
luminance map), traces every shadow ray in one batched any-hit walk over
the opaque geometry with the transparency of cutout triangles and the fog's
transmittance on top, connects fog vertices to the chosen light through
bridges of 1..bridge_vertices scattering events, adds aerial perspective on
segments that end on geometry or in fog and evaluates the sky once after the
loop for the recorded misses.

Sky and sea: the analytic ocean's heightfield march beside the closest
walk (the nearer surface wins; ocean lanes take the water material and the
surface normal), water collisions composed with fog by min-event and
scattered by the water phase, Jerlov absorption on every segment, cloud
shadows on the sun segment, environment NEE from the HDRI map's cell
importance (MIS-paired with BSDF rays that escape), sun caustics through the
wavy surface for underwater vertices (two more shadow segments; the BSDF
path's disc hit after an upward ocean refraction is left to them), the
surface's sign-change test on every shadow segment, and the cloud march on
the miss side. The batched shadow walk takes the reference's segments in its
order: sun, light, env, caustic x→P, caustic P→sun.

Optics: the physical lens camera traces the primary rays through its lens
stack and starts each path with the lens weight; the tiled particle field
is a second closest walk (kernel B on the particle BVH, up to three tile
segments a depth) on delta paths, and its hits scatter by the
Jendersie-d'Eon phase (sun, light, env and caustic NEE, the bounce);
spectral rendering carries three hero wavelengths in the channel slots
(every RGB quantity uplifted to its slot's wavelength, the dielectric IOR
dispersed by Cauchy, the DEFAULT sky from its 8-band bake, one resolve to
sRGB at the end); the opt-in wavefront sort permutes every lane's state
between depths by a coherence key (a stable sort) and unscrambles the
radiance at the end; a debug shading mode returns a false-colour image of
the primary hits.

The branches run in the reference's order, so that every random stream is
drawn at the same point. Without fog, water, clouds, cutouts or textures
the reference's terms for them are exact identities (no collisions,
transmittance 1), so the port skips them and changes no value; under
spectral rendering a transmittance of 1 is uplifted like any other (the
uplift of white is 1 only to ~2e-4), so the port uplifts it too. The
marches (ocean, clouds, caustic connection) run on the lanes that use their
result only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.camera import DeviceCamera, generate_camera_rays
from ..ops.camera_physical import generate_physical_camera_rays
from ..ops.intersect import MISS_DIST
from ..ops.light_tree import sample_light_tree
from ..ops.lights import light_pdf_from_row, mis_balance, sample_light_point
from ..ops.material import (
    LaneMaterial,
    frame_eval,
    make_frame,
    material_sample,
    medium_below_ior,
    medium_pop,
    medium_push,
    medium_top_ior,
)
from ..ops.bridges import sample_bridge
from ..ops.caustics import sample_caustic_connection
from ..ops.clouds import cloud_march, cloud_sun_transmittance
from ..ops.ocean import ocean_crosses, ocean_intersect, ocean_normal
from ..ops.phase import je_phase, je_sample_direction
from ..ops.procedural import OCEAN_INSTANCE_ID, PARTICLES_INSTANCE_ID
from ..ops.random import RandomTarget, blue_base, random_1d
from ..ops.rowops import gather_packed_planar, gather_planar
from ..ops.sky import (
    SUN_COS_RADIUS,
    SUN_SOLID_ANGLE,
    aerial_fetch,
    env_pdf,
    sample_env_direction,
    sky_radiance,
    sky_radiance_spectral,
    sun_dir_vec,
    sun_radiance_spectral,
    sun_solid_angle_radiance,
)
from ..ops.spectral import (
    cauchy_ior,
    resolve_to_rgb,
    sample_hero_wavelengths,
    uplift,
)
from ..ops.textures import sample_atlas
from ..ops.traverse import Hit, trace_closest, trace_occluded, trace_transmission
from ..ops.vec import (Vec3, dot, gather as vgather, normalize, ray_point, sdiv,
                       vwhere)
from ..ops.volume import (
    fog_transmittance,
    hg_phase,
    ocean_phase,
    sample_fog_collision,
    sample_hg_direction,
    sample_ocean_phase_direction,
    sample_water_collision,
    water_transmittance,
)
from ..ops.wavefront_utils import ray_sort_key, sample_sun_direction
from ..utils.profiling import StageRanges
from .device_scene import (
    MAT_FLAG_EMISSIVE,
    MAT_FLAG_THIN_WALLED,
    MAT_FLAG_TRANSLUCENT,
    SHA_COLS,
    SHA_E1XY,
    SHA_E1Z2X,
    SHA_E2YZ,
    SHA_LOD,
    SHA_TEX_AR,
    SHA_TEX_L_ABBE,
    SHA_TEX_MN,
    SHA_UV0,
    SHA_UV1,
    SHA_UV2,
    SHP_ALB_BA,
    SHP_ALB_RG,
    SHP_AREA,
    SHP_COLS,
    SHP_EM_B_ROUGH,
    SHP_EM_RG,
    SHP_FACE,
    SHP_FLAGS,
    SHP_IDS,
    SHP_METAL_IOR,
    SHP_N0,
    SHP_N1,
    SHP_N2,
    SHP_SEL_PDF,
    DeviceScene,
    unpack_f16_pair,
    unpack_i16_pair,
    unpack_oct_snorm16,
)


class RenderConfig(NamedTuple):
    """Static per-render configuration (the reference's RenderConfig, same
    field names; the whole wavefront is traced in one launch, so there is
    no trace chunk)."""

    width: int
    height: int
    max_depth: int
    shading_mode: int = 0  # ShadingMode: 0 the path tracer, 1-5 debug views
    ris_candidates: int = 4
    # re-sort the wavefront between depths by (liveness, direction octant,
    # origin Morton code)
    sort_wavefront: bool = False
    use_textures: bool = False  # albedo maps (and the aux row)
    use_aux_textures: bool = False  # roughness/metallic/normal/luminance maps
    # bridge volume NEE, on with fog: fog vertices connect to the chosen
    # light through 1..bridge_vertices scattering events
    use_bridges: bool = False
    bridge_vertices: int = 1
    blue_noise: bool = True
    aerial: bool = False
    sun_ris: bool = False
    # the cloud march on the miss side and cloud shadows (not in HDRI mode,
    # whose map holds the clouds); active layer indices, low/mid/top
    use_clouds: bool = False
    cloud_steps: int = 32
    cloud_layers: tuple = (0,)
    # environment NEE from the HDRI map's cell importance, MIS-paired with
    # BSDF rays that escape to the sky
    env_nee: bool = False
    # sun caustics through the wavy surface for underwater vertices
    ocean_caustics: bool = False
    caustics_k: int = 8
    ocean_mat_id: int = -1  # the procedural water material
    # the analytic ocean surface (the tessellated one is geometry)
    analytic_ocean: bool = False
    # water in-scattering, on with the ocean
    water_scatter: bool = False
    use_physical_camera: bool = False  # primary rays through the lens stack
    # three hero wavelengths in the channel slots, resolved to sRGB at the
    # end of each sample
    spectral: bool = False
    # the tiled particle field: a second BVH walked on delta paths,
    # scattering by the Jendersie-d'Eon phase of this droplet diameter
    use_particles: bool = False
    particle_diameter: float = 50.0
    particle_mat_id: int = -1


class GBufferMeta(NamedTuple):
    """Primary-hit metadata for picking, written at depth 0 (misses keep
    depth MISS_DIST and ids -1)."""

    depth: torch.Tensor  # f32 [N]
    instance_id: torch.Tensor  # i32 [N]
    material_id: torch.Tensor  # i32 [N]
    rel_hit_pos: torch.Tensor  # f32 [N, 3], hit position less the camera's


_RAY_EPS = 1e-3
SMALL_TABLE_SLOTS = 2048  # up to this many slots, per-field gathers
# f32 1/Omega_sun, as the reference computes it
_INV_SUN_SOLID_ANGLE = float(np.float32(1.0) / np.float32(SUN_SOLID_ANGLE))


def _flip_normals(ns: Vec3, ng_raw: Vec3, direction: Vec3):
    flip_in = dot(ng_raw, direction)
    s_g = torch.where(flip_in > 0.0, -1.0, 1.0)
    ng = Vec3(ng_raw.x * s_g, ng_raw.y * s_g, ng_raw.z * s_g)
    s_n = torch.sign(dot(ns, ng))
    s_n = torch.where(s_n == 0.0, 1.0, s_n)
    ns = Vec3(ns.x * s_n, ns.y * s_n, ns.z * s_n)
    return ns, ng, ng_raw


def _shading_normal(geo, slot, direction: Vec3, u, v):
    """Interpolated shading normal + geometric normal (both flipped toward
    the incoming ray) + the unflipped face normal, from per-slot tables."""
    n0 = vgather(geo.n0, slot)
    n1 = vgather(geo.n1, slot)
    n2 = vgather(geo.n2, slot)
    w = 1.0 - u - v
    ns = normalize(Vec3(
        n0.x * w + n1.x * u + n2.x * v,
        n0.y * w + n1.y * u + n2.y * v,
        n0.z * w + n1.z * u + n2.z * v,
    ))
    return _flip_normals(ns, vgather(geo.face_normal, slot), direction)


def _shading_normal_packed(srow, direction: Vec3, u, v):
    """_shading_normal reading planar shade rows [SHP_COLS, N] i32."""
    w = 1.0 - u - v
    n0x, n0y, n0z = unpack_oct_snorm16(srow[SHP_N0])
    n1x, n1y, n1z = unpack_oct_snorm16(srow[SHP_N1])
    n2x, n2y, n2z = unpack_oct_snorm16(srow[SHP_N2])
    ns = normalize(Vec3(
        n0x * w + n1x * u + n2x * v,
        n0y * w + n1y * u + n2y * v,
        n0z * w + n1z * u + n2z * v,
    ))
    fx, fy, fz = unpack_oct_snorm16(srow[SHP_FACE])
    return _flip_normals(ns, Vec3(fx, fy, fz), direction)


def _gather_material(mats, mat_id) -> LaneMaterial:
    flags = mats.flags[mat_id]
    return LaneMaterial(
        albedo_r=mats.albedo_r[mat_id],
        albedo_g=mats.albedo_g[mat_id],
        albedo_b=mats.albedo_b[mat_id],
        roughness=mats.roughness[mat_id],
        metallic=mats.metallic[mat_id],
        ior=mats.ior[mat_id],
        translucent=(flags & MAT_FLAG_TRANSLUCENT) != 0,
        opacity=mats.albedo_a[mat_id],
        thin_walled=(flags & MAT_FLAG_THIN_WALLED) != 0,
    )


def _lum(r, g, b):
    return 0.2126 * r + 0.7152 * g + 0.0722 * b


def _normal_mapped(ns: Vec3, u0: Vec3, v0: Vec3, e1v: Vec3, e2v: Vec3,
                   nx_, ny_, nz_, normal_tex):
    """The shading normal perturbed by a tangent-space normal map (texel
    n = (nx, ny, nz) in [0, 1]); lanes without a map, or whose UV frame is
    degenerate, keep ``ns``."""
    du1 = u0.y - u0.x
    dv1 = v0.y - v0.x
    du2 = u0.z - u0.x
    dv2 = v0.z - v0.x
    det = du1 * dv2 - du2 * dv1
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, 1.0 / det, 0.0)
    tang = normalize(Vec3(
        (e1v.x * dv2 - e2v.x * dv1) * inv_det,
        (e1v.y * dv2 - e2v.y * dv1) * inv_det,
        (e1v.z * dv2 - e2v.z * dv1) * inv_det,
    ))
    bitan = Vec3(ns.y * tang.z - ns.z * tang.y,
                 ns.z * tang.x - ns.x * tang.z,
                 ns.x * tang.y - ns.y * tang.x)
    tnx = nx_ * 2.0 - 1.0
    tny = ny_ * 2.0 - 1.0
    tnz = torch.clamp(nz_ * 2.0 - 1.0, min=0.1)
    mapped = normalize(Vec3(
        tang.x * tnx + bitan.x * tny + ns.x * tnz,
        tang.y * tnx + bitan.y * tny + ns.y * tnz,
        tang.z * tnx + bitan.z * tny + ns.z * tnz,
    ))
    return vwhere((normal_tex >= 0) & ok, mapped, ns)


_FLT_MIN = float(np.finfo(np.float32).tiny)


def floor_mod(x: torch.Tensor, m: float) -> torch.Tensor:
    """``x`` mod ``m`` with the sign of ``m`` (JAX's ``jnp.mod``: the
    truncated remainder, plus ``m`` where it is non-zero and of the other
    sign; that sum rounds, so a tiny negative ``x`` wraps to ``m``). A
    subnormal remainder counts as zero, as under the reference's flush to
    zero, and is kept as it is."""
    r = torch.fmod(x, m)
    return torch.where((torch.abs(r) >= _FLT_MIN) & ((r < 0.0) != (m < 0.0)),
                       r + m, r)


def _lane_ids(sample_id, ix):
    """The sample ids of lanes ``ix`` (one id for all lanes stays one)."""
    return sample_id[ix] if sample_id.dim() else sample_id


def _particle_phase(particle_lane, lane_mat: LaneMaterial, direction: Vec3,
                    wi: Vec3, diameter: float, f, pdf=None):
    """Particle lanes' BSDF toward ``wi``: the Jendersie-d'Eon phase times
    the albedo (the phase is the bounce pdf too) → (f rgb, pdf)."""
    pj = je_phase(dot(direction, wi), diameter)
    f = tuple(torch.where(particle_lane, a * pj, c) for a, c in zip(
        (lane_mat.albedo_r, lane_mat.albedo_g, lane_mat.albedo_b), f))
    return f, (None if pdf is None else torch.where(particle_lane, pj, pdf))


def _add(rad, thr, f, le, tw, w):
    """rad + thr f Le (tw) w, in the reference's product order; ``tw`` (a
    water transmittance) is None where the reference's factor is 1."""
    x = thr * f * le
    if tw is not None:
        x = x * tw
    return rad + x * w


def _particle_tier(pt, origin: Vec3, direction: Vec3, hit: Hit, active,
                   prev_delta, depth: int, pixel_id, sample_id, max_depth: int):
    """The particle field's walk of one depth → (particle_lane: the lanes
    whose nearest hit is a particle, the particle hit distance [N])."""
    n = origin.x.shape[0]
    dev = origin.x.device
    p_gate = active if depth == 0 else (active & prev_delta)
    # one time per sample; the depth index max_depth never meets the
    # per-depth PARTICLE_PHASE draws of the bounce
    t_cam = random_1d(RandomTarget.PARTICLE_PHASE, pixel_id, sample_id,
                      max_depth)
    t_cur = torch.where(hit.valid, hit.t, 1e7)
    seg_o = Vec3(origin.x + pt.motion[0] * t_cam,
                 origin.y + pt.motion[1] * t_cam,
                 origin.z + pt.motion[2] * t_cam)
    scale = pt.scale
    t_base = torch.zeros(n, dtype=torch.float32, device=dev)
    p_t = torch.full((n,), 1e30, dtype=torch.float32, device=dev)
    p_found = torch.zeros(n, dtype=torch.bool, device=dev)
    hop_eps = float(np.float32(1e-4) * np.float32(scale))

    def exit_dist(wc, dc):
        """Distance to the tile's face along one axis."""
        flat = torch.abs(dc) < 1e-9
        tgt = torch.where(dc > 0.0, scale, 0.0)
        return torch.where(flat, 1e30, (tgt - wc) / torch.where(flat, 1e-9, dc))

    for _seg in range(3):
        wrapped = Vec3(floor_mod(seg_o.x, scale), floor_mod(seg_o.y, scale),
                       floor_mod(seg_o.z, scale))
        t_exit = torch.minimum(
            exit_dist(wrapped.x, direction.x),
            torch.minimum(exit_dist(wrapped.y, direction.y),
                          exit_dist(wrapped.z, direction.z)))
        t_exit = torch.clamp(t_exit, min=0.0)
        seg_act = p_gate & ~p_found & (t_base < t_cur)
        h_s = trace_closest(pt.bvh, wrapped, direction, active=seg_act)
        ok = seg_act & h_s.valid & (h_s.t <= t_exit + hop_eps)
        p_t = torch.where(ok, t_base + h_s.t, p_t)
        p_found = p_found | ok
        adv = t_exit + hop_eps
        seg_o = Vec3(seg_o.x + direction.x * adv, seg_o.y + direction.y * adv,
                     seg_o.z + direction.z * adv)
        t_base = t_base + adv
    return p_gate & p_found & (p_t < t_cur), p_t


def render_sample(scene: DeviceScene, cam: DeviceCamera, config: RenderConfig,
                  pixel_x: torch.Tensor, pixel_y: torch.Tensor, sample_id,
                  with_gbuffer: bool = True):
    """Trace one full sample for the pixel wavefront → (radiance [N, 3],
    gbuffer GBufferMeta, rays_traced 0-d f32: closest rays per depth + sun,
    light, env, caustic (two per connection) and bridge shadow rays, the
    accounting of ``bench.py``).

    ``sample_id`` is one id for every lane (an int or a 0-d tensor) or an
    ``[N]`` tensor of per-lane ids (adaptive stages); ids are u32 words.
    With ``with_gbuffer=False`` the gbuffer is not built and comes back
    None: eager ops run whether or not their result is used."""
    with StageRanges() as stage:
        return _render_sample(stage, scene, cam, config, pixel_x, pixel_y,
                              sample_id, with_gbuffer)


def _render_sample(stage, scene: DeviceScene, cam: DeviceCamera,
                   config: RenderConfig, pixel_x: torch.Tensor,
                   pixel_y: torch.Tensor, sample_id, with_gbuffer: bool):
    """:func:`render_sample`'s body; ``stage(name)`` marks where each of its
    stages begins (``utils/profiling.py``)."""
    stage("camera rays")
    geo = scene.geo
    mats = scene.materials
    lights = scene.lights
    sky = scene.sky
    fog = scene.fog
    water = scene.water
    dev = pixel_x.device
    n = pixel_x.shape[0]
    pixel_id = (pixel_y.to(torch.int64) * config.width
                + pixel_x.to(torch.int64)) & 0xFFFFFFFF
    if isinstance(sample_id, torch.Tensor):
        sample_id = sample_id.to(device=dev, dtype=torch.int64) & 0xFFFFFFFF
    else:
        sample_id = torch.as_tensor(int(sample_id) & 0xFFFFFFFF,
                                    dtype=torch.int64, device=dev)
    bn = blue_base(pixel_x, pixel_y) if config.blue_noise else None

    zeros = torch.zeros(n, dtype=torch.float32, device=dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    false = torch.zeros(n, dtype=torch.bool, device=dev)
    rad_r, rad_g, rad_b = zeros, zeros, zeros
    thr_r, thr_g, thr_b = ones, ones, ones
    if config.use_physical_camera and cam.phys is not None:
        # the lens stack's throughput (vignetting, spectral weights)
        origin, direction, (thr_r, thr_g, thr_b) = generate_physical_camera_rays(
            cam, cam.phys, config.width, config.height, pixel_x, pixel_y,
            pixel_id, sample_id)
    else:
        origin, direction = generate_camera_rays(
            cam, config.width, config.height, pixel_x, pixel_y, pixel_id,
            sample_id, bn=bn)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    rays_traced = torch.zeros((), dtype=torch.float32, device=dev)
    prev_pdf = zeros
    prev_delta = torch.ones(n, dtype=torch.bool, device=dev)
    medium = torch.zeros(n, dtype=torch.int64, device=dev)
    miss_dir = Vec3(zeros, zeros, zeros)
    miss_thr_r, miss_thr_g, miss_thr_b = zeros, zeros, zeros
    miss_sun_weight = zeros
    # the bounce pdf at the miss for env-NEE MIS (-1 = full weight),
    # resolved once after the loop
    miss_env_weight = -ones
    ever_missed = false
    prev_sun_nee = false
    prev_sun2 = false
    prev_light_nee = false
    prev_env_nee = false
    # a bounce refracted up through the ocean surface: its sun-disc hit
    # belongs to the caustic strategy
    ocean_exit = false
    gbuffer = None
    # the wavefront sort permutes lanes between depths; orig_lane
    # unscrambles the radiance at the end
    sort = config.sort_wavefront
    orig_lane = torch.arange(n, device=dev) if sort else None

    sun_radiance = sun_solid_angle_radiance(sky)  # f32 [3]
    sun_v = sun_dir_vec(sky)
    spectral = config.spectral
    if spectral:
        # three hero wavelengths in the channel slots; spec3 uplifts an RGB
        # quantity to each slot's wavelength (it reads lam3 when called, so
        # after a sort the permuted one). The sun's spectrum is evaluated
        # once and, as in the reference, not permuted by the sort.
        u_lam = random_1d(RandomTarget.WAVELENGTH, pixel_id, sample_id, 0,
                          bn=bn)
        lam3, lam_pdf3 = sample_hero_wavelengths(u_lam)

        def spec3(r, g, b):
            return tuple(uplift(r, g, b, lam) for lam in lam3)

        sun_rad3 = sun_radiance_spectral(sky, lam3)
        collapsed = false
    else:
        def spec3(r, g, b):
            return r, g, b

        sun_rad3 = (sun_radiance[0], sun_radiance[1], sun_radiance[2])
    use_rows = geo.material_id.shape[0] > SMALL_TABLE_SLOTS
    sun_up = sky.sun_dir[1] > -0.1  # 0-d bool
    sky_has_sun = int(sky.mode) != 2
    # fog: collisions only where an active fog has density; otherwise every
    # fog term of the reference is an identity and is skipped
    fog_on = fog.on
    water_on = water.active  # Jerlov absorption (identity without water)

    def water_tr(o, d, dist, with_scatter=False):
        """The water transmittance of segments, in the slots' wavelengths:
        None without water (the identity), except under spectral rendering,
        where the reference uplifts its transmittance of 1."""
        if water_on:
            return spec3(*water_transmittance(water, o, d, dist,
                                              with_scatter=with_scatter))
        if spectral:
            return spec3(ones, ones, ones)
        return None, None, None
    water_scatter = config.water_scatter
    vol_on = fog_on or water_scatter  # volume collisions possible
    vol_water = None
    use_bridges = config.use_bridges and fog_on
    # once a path scatters in the fog, the bridges of that first vertex own
    # all geometry-light transport (orders 1..M): later vertices run no
    # geometry NEE and collect no emission. M = 1 keeps the direct pairing.
    multi_bridge = use_bridges and config.bridge_vertices >= 2
    vol_scattered = false
    cutouts = geo.bvh.has_cutouts
    use_tex = config.use_textures
    use_aux = use_tex and config.use_aux_textures
    if use_tex:  # the ray footprint's angle per pixel, in float32
        spread = float(np.float32(2.0) * np.float32(float(cam.fov))
                       / np.float32(config.height))

    def vol_phase(cos_t):
        """The phase at a volume vertex: the water's mixture on water
        collisions, the fog's HG elsewhere."""
        p = hg_phase(cos_t, fog.g)
        if water_scatter:
            p = torch.where(vol_water, ocean_phase(cos_t, water), p)
        return p

    for depth in range(config.max_depth):
        stage("closest walk")
        rays_traced = rays_traced + active.to(torch.float32).sum()
        hit = trace_closest(geo.bvh, origin, direction, active=active)
        ocean_lane = particle_lane = None

        # ---- the analytic ocean: the heightfield march up to the walk's
        # hit, the nearer surface wins ----
        if config.analytic_ocean:
            stage("ocean")
            ocean_lane, oc_t = ocean_intersect(
                water, origin, direction, torch.where(hit.valid, hit.t, 1e7),
                active)
            hit = Hit(t=torch.where(ocean_lane, oc_t, hit.t),
                      slot=torch.where(ocean_lane, 0, hit.slot),
                      u=torch.where(ocean_lane, 0.0, hit.u),
                      v=torch.where(ocean_lane, 0.0, hit.v))

        # ---- the tiled particle field, on delta paths: wrap each lane's
        # origin (plus the sample's motion offset) into the tile and walk
        # the particle BVH (kernel B) up to the tile exit, then hop the
        # boundary; up to 3 segments. A lone tile goes blind where the
        # wrapped origin sits on a face the ray leaves through. ----
        if config.use_particles:
            stage("particles")
            particle_lane, p_t = _particle_tier(
                scene.particles, origin, direction, hit, active, prev_delta,
                depth, pixel_id, sample_id, config.max_depth)
            hit = Hit(t=torch.where(particle_lane, p_t, hit.t),
                      slot=torch.where(particle_lane, 0, hit.slot),
                      u=torch.where(particle_lane, 0.0, hit.u),
                      v=torch.where(particle_lane, 0.0, hit.v))
            if config.analytic_ocean:
                ocean_lane = ocean_lane & ~particle_lane
        hit_valid = hit.valid

        # ---- volume collisions (analog tracking): fog, and water composed
        # with it by the nearer event ----
        stage("volumes")
        t_media = torch.where(hit_valid, hit.t, 1e7)
        if fog_on:
            collided, t_col = sample_fog_collision(
                fog, origin, direction, t_media, pixel_id, sample_id, depth)
        elif vol_on:
            collided, t_col = false, t_media
        if water_scatter:
            coll_w, t_col_w = sample_water_collision(
                water, origin, direction, t_media, pixel_id, sample_id, depth,
                bn=bn)
            water_wins = coll_w & (~collided | (t_col_w < t_col))
            t_col = torch.where(water_wins, t_col_w, t_col)
            collided = collided | coll_w
            vol_water = active & water_wins
        if vol_on:
            vol_lane = active & collided
            missed = active & ~hit_valid & ~collided
            hit_lane = active & hit_valid & ~collided
            seg_len = torch.where(collided, t_col, t_media)
        else:
            missed = active & ~hit_valid
            hit_lane = active & hit_valid
            seg_len = t_media

        # ---- Jerlov absorption along the segment ----
        twr, twg, twb = water_tr(origin, direction, seg_len)
        if twr is not None:
            thr_r, thr_g, thr_b = thr_r * twr, thr_g * twg, thr_b * twb

        # ---- aerial perspective on segments that end on geometry or fog ----
        stage("sky and miss")
        if config.aerial:
            ends_here = active & (hit_valid | collided) if vol_on else hit_lane
            (atr_r, atr_g, atr_b), (ain_r, ain_g, ain_b) = aerial_fetch(
                sky, direction, seg_len * 1e-3)  # world m → km
            ain_r, ain_g, ain_b = spec3(ain_r, ain_g, ain_b)
            atr_r, atr_g, atr_b = spec3(atr_r, atr_g, atr_b)
            on = ends_here.to(torch.float32)
            rad_r = rad_r + thr_r * ain_r * on
            rad_g = rad_g + thr_g * ain_g * on
            rad_b = rad_b + thr_b * ain_b * on
            thr_r = thr_r * torch.where(ends_here, atr_r, 1.0)
            thr_g = thr_g * torch.where(ends_here, atr_g, 1.0)
            thr_b = thr_b * torch.where(ends_here, atr_b, 1.0)

        # ---- record the miss (sky evaluated once after the loop) ----
        den_sun = (_INV_SUN_SOLID_ANGLE
                   + prev_pdf * (1.0 + prev_sun2.to(torch.float32)))
        w_sun = torch.where(prev_delta | ~prev_sun_nee, 1.0, prev_pdf / den_sun)
        if config.ocean_caustics:
            w_sun = torch.where(ocean_exit, 0.0, w_sun)
        miss_dir = vwhere(missed, direction, miss_dir)
        miss_thr_r = torch.where(missed, thr_r, miss_thr_r)
        miss_thr_g = torch.where(missed, thr_g, miss_thr_g)
        miss_thr_b = torch.where(missed, thr_b, miss_thr_b)
        miss_sun_weight = torch.where(missed, w_sun, miss_sun_weight)
        if config.env_nee:
            pdfb_env = torch.where(prev_delta | ~prev_env_nee, -1.0, prev_pdf)
            miss_env_weight = torch.where(missed, pdfb_env, miss_env_weight)
        ever_missed = ever_missed | missed
        active = hit_lane | vol_lane if vol_on else hit_lane

        # ---- hit context: one shade-row gather (big tables) or per-field
        # gathers (small tables); with textures one aux row too ----
        stage("shade-row fetch")
        slot = torch.where(hit_lane, hit.slot, 0)
        t_safe = torch.where(hit_lane, hit.t, 1.0)
        hit_pos = ray_point(origin, direction, t_safe)
        if vol_on:
            vol_pos = Vec3(origin.x + direction.x * t_col,
                           origin.y + direction.y * t_col,
                           origin.z + direction.z * t_col)
        if use_rows:
            srow = gather_packed_planar(scene.shade_hot, slot, SHP_COLS)
            ids = srow[SHP_IDS]
            mat_id = ids & 0xFFFF
            mat_flags = srow[SHP_FLAGS]
            ns, ng, ng_raw = _shading_normal_packed(srow, direction, hit.u, hit.v)
            alb_r, alb_g = unpack_f16_pair(srow[SHP_ALB_RG])
            alb_b, alb_a = unpack_f16_pair(srow[SHP_ALB_BA])
            em_r, em_g = unpack_f16_pair(srow[SHP_EM_RG])
            em_b, rough = unpack_f16_pair(srow[SHP_EM_B_ROUGH])
            metal, ior = unpack_f16_pair(srow[SHP_METAL_IOR])
            lane_mat = LaneMaterial(
                albedo_r=alb_r, albedo_g=alb_g, albedo_b=alb_b,
                roughness=rough, metallic=metal, ior=ior,
                translucent=(mat_flags & MAT_FLAG_TRANSLUCENT) != 0,
                opacity=alb_a,
                thin_walled=(mat_flags & MAT_FLAG_THIN_WALLED) != 0,
            )
            nee_sel_pdf = srow[SHP_SEL_PDF].view(torch.float32)
            nee_area = srow[SHP_AREA].view(torch.float32)
            if use_tex or spectral:  # (spectral: the Abbe number)
                arow = gather_packed_planar(scene.shade_aux, slot, SHA_COLS)
            if use_tex:
                u0_, v0_ = unpack_f16_pair(arow[SHA_UV0])
                u1_, v1_ = unpack_f16_pair(arow[SHA_UV1])
                u2_, v2_ = unpack_f16_pair(arow[SHA_UV2])
                uvs = (Vec3(u0_, u1_, u2_), Vec3(v0_, v1_, v2_))
                tex_id, rough_tex = unpack_i16_pair(arow[SHA_TEX_AR])
        else:
            sl = slot.long()
            mat_id = geo.material_id[sl].long()
            mat_flags = mats.flags[mat_id]
            ns, ng, ng_raw = _shading_normal(geo, sl, direction, hit.u, hit.v)
            lane_mat = _gather_material(mats, mat_id)
            em_r = mats.emission_r[mat_id]
            em_g = mats.emission_g[mat_id]
            em_b = mats.emission_b[mat_id]
            nee_sel_pdf = lights.slot_select_pdf[sl]
            nee_area = lights.slot_area[sl]
            if use_tex:
                uvs = (vgather(geo.uv_u, sl), vgather(geo.uv_v, sl))
                tex_id = mats.albedo_tex[mat_id]
        stage("surface shading")
        if config.analytic_ocean:
            # ocean lanes carry slot 0: every slot-derived quantity becomes
            # the analytic surface's and the water material's
            omid = config.ocean_mat_id
            oix = torch.nonzero(ocean_lane).flatten()
            o_n = Vec3(zeros.clone(), ones.clone(), zeros.clone())
            on_part = ocean_normal(water, hit_pos.x[oix], hit_pos.z[oix])
            for c_full, c_part in zip(o_n, on_part):
                c_full[oix] = c_part
            o_flip = torch.where(dot(o_n, direction) > 0.0, -1.0, 1.0)
            o_nf = Vec3(o_n.x * o_flip, o_n.y * o_flip, o_n.z * o_flip)
            mat_id = torch.where(ocean_lane, omid, mat_id)
            mat_flags = torch.where(ocean_lane, MAT_FLAG_TRANSLUCENT, mat_flags)
            ns = vwhere(ocean_lane, o_nf, ns)
            ng = vwhere(ocean_lane, o_nf, ng)
            ng_raw = vwhere(ocean_lane, o_n, ng_raw)
            lane_mat = LaneMaterial(
                albedo_r=torch.where(ocean_lane, mats.albedo_r[omid],
                                     lane_mat.albedo_r),
                albedo_g=torch.where(ocean_lane, mats.albedo_g[omid],
                                     lane_mat.albedo_g),
                albedo_b=torch.where(ocean_lane, mats.albedo_b[omid],
                                     lane_mat.albedo_b),
                roughness=torch.where(ocean_lane, mats.roughness[omid],
                                      lane_mat.roughness),
                metallic=torch.where(ocean_lane, 0.0, lane_mat.metallic),
                ior=torch.where(ocean_lane, water.ior, lane_mat.ior),
                translucent=lane_mat.translucent | ocean_lane,
                opacity=torch.where(ocean_lane, 1.0, lane_mat.opacity),
                thin_walled=lane_mat.thin_walled & ~ocean_lane,
            )
            em_r = torch.where(ocean_lane, 0.0, em_r)
            em_g = torch.where(ocean_lane, 0.0, em_g)
            em_b = torch.where(ocean_lane, 0.0, em_b)
            if use_tex:
                tex_id = torch.where(ocean_lane, -1, tex_id)
        if config.use_particles:
            # particle lanes scatter by the phase function: the normal only
            # faces the ray, so that the front-face and cosine guards pass
            p_n = Vec3(-direction.x, -direction.y, -direction.z)
            alb = scene.particles.albedo
            mat_id = torch.where(particle_lane, config.particle_mat_id, mat_id)
            mat_flags = torch.where(particle_lane, 0, mat_flags)
            ns = vwhere(particle_lane, p_n, ns)
            ng = vwhere(particle_lane, p_n, ng)
            ng_raw = vwhere(particle_lane, p_n, ng_raw)
            lane_mat = LaneMaterial(
                albedo_r=torch.where(particle_lane, alb[0], lane_mat.albedo_r),
                albedo_g=torch.where(particle_lane, alb[1], lane_mat.albedo_g),
                albedo_b=torch.where(particle_lane, alb[2], lane_mat.albedo_b),
                roughness=torch.where(particle_lane, 1.0, lane_mat.roughness),
                metallic=torch.where(particle_lane, 0.0, lane_mat.metallic),
                ior=torch.where(particle_lane, 1.0, lane_mat.ior),
                translucent=lane_mat.translucent & ~particle_lane,
                opacity=torch.where(particle_lane, 1.0, lane_mat.opacity),
                thin_walled=lane_mat.thin_walled & ~particle_lane,
            )
            em_r = torch.where(particle_lane, 0.0, em_r)
            em_g = torch.where(particle_lane, 0.0, em_g)
            em_b = torch.where(particle_lane, 0.0, em_b)
            if use_tex:
                tex_id = torch.where(particle_lane, -1, tex_id)
        if use_tex:
            u0, v0 = uvs
            w_b = 1.0 - hit.u - hit.v
            uu = u0.x * w_b + u0.y * hit.u + u0.z * hit.v
            vv = v0.x * w_b + v0.y * hit.u + v0.z * hit.v
            # ray-footprint mip LOD: texels per pixel ~ texel density x hit
            # distance x angle per pixel / view cosine
            cos_view = torch.abs(dot(ng, direction))
            lod_base = arow[SHA_LOD].view(torch.float32) if use_rows else 0.0
            lod = lod_base + torch.log2(torch.clamp(t_safe * spread, min=1e-8)
                                        / torch.clamp(cos_view, min=0.05))
            tr_, tg_, tb_, ta_ = sample_atlas(scene.textures, tex_id, uu, vv,
                                              lod=lod)
            lane_mat = lane_mat._replace(
                albedo_r=lane_mat.albedo_r * tr_,
                albedo_g=lane_mat.albedo_g * tg_,
                albedo_b=lane_mat.albedo_b * tb_,
                opacity=lane_mat.opacity * ta_,
            )
            if use_aux:
                if use_rows:
                    metal_tex, normal_tex = unpack_i16_pair(arow[SHA_TEX_MN])
                    lum_tex, _ = unpack_i16_pair(arow[SHA_TEX_L_ABBE])
                else:
                    rough_tex = mats.roughness_tex[mat_id]
                    metal_tex = mats.metallic_tex[mat_id]
                    normal_tex = mats.normal_tex[mat_id]
                    lum_tex = mats.luminance_tex[mat_id]
                # the ocean surface and the particles are untextured
                for lane in (ocean_lane, particle_lane):
                    if lane is not None:
                        rough_tex = torch.where(lane, -1, rough_tex)
                        metal_tex = torch.where(lane, -1, metal_tex)
                        normal_tex = torch.where(lane, -1, normal_tex)
                        lum_tex = torch.where(lane, -1, lum_tex)
                rr_, _, _, _ = sample_atlas(scene.textures, rough_tex, uu, vv,
                                            lod=lod, trilinear=False)
                mm_, _, _, _ = sample_atlas(scene.textures, metal_tex, uu, vv,
                                            lod=lod, trilinear=False)
                lane_mat = lane_mat._replace(
                    roughness=torch.where(rough_tex >= 0, rr_, lane_mat.roughness),
                    metallic=torch.where(metal_tex >= 0, mm_, lane_mat.metallic),
                )
                lr_, lg_, lb_, _ = sample_atlas(scene.textures, lum_tex, uu, vv,
                                                lod=lod, trilinear=False)
                em_r = torch.where(lum_tex >= 0, em_r * lr_, em_r)
                em_g = torch.where(lum_tex >= 0, em_g * lg_, em_g)
                em_b = torch.where(lum_tex >= 0, em_b * lb_, em_b)
                nx_, ny_, nz_, _ = sample_atlas(scene.textures, normal_tex, uu,
                                                vv, lod=lod, trilinear=False)
                if use_rows:
                    e1x_, e1y_ = unpack_f16_pair(arow[SHA_E1XY])
                    e1z_, e2x_ = unpack_f16_pair(arow[SHA_E1Z2X])
                    e2y_, e2z_ = unpack_f16_pair(arow[SHA_E2YZ])
                    e1v = Vec3(e1x_, e1y_, e1z_)
                    e2v = Vec3(e2x_, e2y_, e2z_)
                else:
                    e1v = vgather(geo.bvh.tri_e1, sl)
                    e2v = vgather(geo.bvh.tri_e2, sl)
                ns = _normal_mapped(ns, u0, v0, e1v, e2v, nx_, ny_, nz_,
                                    normal_tex)
        # ---- spectral ingestion: albedo and emission to the slots'
        # wavelengths; the dielectric IOR dispersed at the hero's ----
        if spectral:
            if use_rows:
                _, abbe_lane = unpack_f16_pair(arow[SHA_TEX_L_ABBE])
            else:
                abbe_lane = mats.abbe[mat_id]
            if config.analytic_ocean:
                abbe_lane = torch.where(ocean_lane, 0.0, abbe_lane)
            if config.use_particles:
                abbe_lane = torch.where(particle_lane, 0.0, abbe_lane)
            a0, a1, a2 = spec3(lane_mat.albedo_r, lane_mat.albedo_g,
                               lane_mat.albedo_b)
            lane_mat = lane_mat._replace(
                albedo_r=a0, albedo_g=a1, albedo_b=a2,
                ior=cauchy_ior(lane_mat.ior, lam3[0], abbe_lane))
            em_r, em_g, em_b = spec3(em_r, em_g, em_b)
        wo = -direction
        if depth == 0 and with_gbuffer:
            if use_rows:  # mat_id u16 | (instance_id + 1) u16
                inst0 = ((ids >> 16) & 0xFFFF) - 1
            else:
                inst0 = geo.instance_id[sl]
            if config.analytic_ocean:
                inst0 = torch.where(ocean_lane, OCEAN_INSTANCE_ID, inst0)
            if config.use_particles:
                inst0 = torch.where(particle_lane, PARTICLES_INSTANCE_ID, inst0)
            gbuffer = GBufferMeta(
                depth=torch.where(hit_lane, hit.t, MISS_DIST),
                instance_id=torch.where(hit_lane, inst0.to(torch.int32), -1),
                material_id=torch.where(hit_lane, mat_id.to(torch.int32), -1),
                rel_hit_pos=torch.where(
                    hit_lane[:, None],
                    torch.stack([hit_pos.x - cam.pos[0], hit_pos.y - cam.pos[1],
                                 hit_pos.z - cam.pos[2]], dim=-1),
                    0.0),
            )
        if depth == 0 and config.shading_mode != 0:
            return (_debug_shade(config, scene, hit, hit_lane, slot, mat_id,
                                 ns), gbuffer, rays_traced)

        # ---- stochastic alpha test: a cutout surface exists with
        # probability opacity; pass-through lanes go straight on ----
        r_alpha = random_1d(RandomTarget.ALPHA_TEST, pixel_id, sample_id,
                            depth, bn=bn)
        pass_thru = hit_lane & (r_alpha >= lane_mat.opacity)

        if vol_on:  # the scattering albedo at a collision (water's is 1)
            vol_alb = torch.where(vol_lane, fog.scatter_albedo, 1.0)
            if water_scatter:
                vol_alb = torch.where(vol_water, 1.0, vol_alb)
            thr_r, thr_g, thr_b = thr_r * vol_alb, thr_g * vol_alb, thr_b * vol_alb

        # ---- emission on hit (one-sided), MIS vs light NEE ----
        emissive = (mat_flags & MAT_FLAG_EMISSIVE) != 0
        d_dot_ng = dot(ng_raw, direction)
        front_face = d_dot_ng < 0.0
        cos_light = torch.abs(d_dot_ng)
        pdf_nee = light_pdf_from_row(nee_sel_pdf, nee_area, hit.t, cos_light)
        if lights.has_micro:
            # the hit point's micro cell weight, as the sampler applies it:
            # invert the sqrt warp at the hit barycentrics
            mic16 = gather_planar(scene.shade_micro, slot)  # [16, N]
            r1h = torch.clamp((1.0 - hit.u) * (1.0 - hit.u), 0.0, 0.999999)
            r2h = torch.clamp(hit.v / torch.clamp(1.0 - hit.u, min=1e-6),
                              0.0, 0.999999)
            cellh = ((r1h * 4.0).to(torch.int32) * 4
                     + (r2h * 4.0).to(torch.int32))
            pdf_nee = pdf_nee * mic16.gather(0, cellh.long()[None])[0]
        w_emit = torch.where(prev_delta | ~prev_light_nee, 1.0,
                             mis_balance(prev_pdf, pdf_nee))
        add_emit = torch.where(hit_lane & emissive & front_face & ~pass_thru,
                               w_emit, 0.0)
        if multi_bridge:  # those orders belong to the first vertex's bridges
            add_emit = torch.where(vol_scattered, 0.0, add_emit)
        rad_r = rad_r + thr_r * em_r * add_emit
        rad_g = rad_g + thr_g * em_g * add_emit
        rad_b = rad_b + thr_b * em_b * add_emit

        shadow_origin = Vec3(hit_pos.x + ng.x * _RAY_EPS,
                             hit_pos.y + ng.y * _RAY_EPS,
                             hit_pos.z + ng.z * _RAY_EPS)
        nee_lane = hit_lane & ~lane_mat.translucent & ~pass_thru
        if vol_on:
            shadow_origin = vwhere(vol_lane, vol_pos, shadow_origin)
            nee_lane = nee_lane | vol_lane
        frame = make_frame(lane_mat, ns, wo, scene.ggx_quad)

        # ---- NEE 1: the sun, RIS over {cone sample, BSDF proposal} ----
        stage("sun NEE")
        sun_nee_on = nee_lane & sun_up & sky_has_sun
        sun_dir_s = sample_sun_direction(sun_v, pixel_id, sample_id, depth,
                                         bn=bn)
        (fs_r, fs_g, fs_b), pdf_b_sun = frame_eval(
            lane_mat, frame, lane_mat.roughness, sun_dir_s)
        if vol_on:  # volume vertices scatter by the phase
            phase_sun = vol_phase(dot(direction, sun_dir_s))
            fs_r = torch.where(vol_lane, phase_sun, fs_r)
            fs_g = torch.where(vol_lane, phase_sun, fs_g)
            fs_b = torch.where(vol_lane, phase_sun, fs_b)
            pdf_b_sun = torch.where(vol_lane, phase_sun, pdf_b_sun)
            cand1_ok = sun_nee_on & (vol_lane | (dot(sun_dir_s, ns) > 0.0))
        else:
            cand1_ok = sun_nee_on & (dot(sun_dir_s, ns) > 0.0)
        if config.use_particles:
            (fs_r, fs_g, fs_b), pdf_b_sun = _particle_phase(
                particle_lane, lane_mat, direction, sun_dir_s,
                config.particle_diameter, (fs_r, fs_g, fs_b), pdf_b_sun)
        pdf_sun = _INV_SUN_SOLID_ANGLE
        phat1 = _lum(fs_r, fs_g, fs_b)
        if config.sun_ris:
            wi_b2, _w2, pdf_s2, is_delta2, trans2 = material_sample(
                lane_mat, frame, ns, wo, pixel_id, sample_id, depth + 64, bn=bn)
            sun2_on = (sun_nee_on & ~lane_mat.translucent & ~is_delta2 & ~trans2)
            if vol_on:
                sun2_on = sun2_on & ~vol_lane
            if config.use_particles:  # phase lanes take the cone candidate
                sun2_on = sun2_on & ~particle_lane
            cand2_ok = (sun2_on & (dot(wi_b2, sun_v) >= SUN_COS_RADIUS)
                        & (dot(wi_b2, ns) > 0.0))
            (f2_r, f2_g, f2_b), pdf_eval2 = frame_eval(
                lane_mat, frame, lane_mat.roughness, wi_b2)
            n_b1 = 1.0 + sun2_on.to(torch.float32)
            phat2 = _lum(f2_r, f2_g, f2_b)
            w_s1 = torch.where(
                cand1_ok & (phat1 > 0.0),
                phat1 / torch.clamp(pdf_sun + pdf_b_sun * n_b1, min=1e-12), 0.0)
            w_s2 = torch.where(
                cand2_ok & (phat2 > 0.0),
                pdf_eval2 / torch.clamp(pdf_sun + pdf_eval2 * 2.0, min=1e-12)
                * phat2 / torch.clamp(pdf_s2, min=1e-12), 0.0)
            wsum_sun = w_s1 + w_s2
            r_spick = random_1d(RandomTarget.EMISSION_INDEX, pixel_id,
                                sample_id, depth, bn=bn)
            pick2 = (r_spick * wsum_sun < w_s2) & (w_s2 > 0.0)
            sun_dir_w = vwhere(pick2, wi_b2, sun_dir_s)
            fs_r = torch.where(pick2, f2_r, fs_r)
            fs_g = torch.where(pick2, f2_g, fs_g)
            fs_b = torch.where(pick2, f2_b, fs_b)
            sel_phat_sun = torch.where(pick2, phat2, phat1)
        else:
            sun2_on = false
            w_s1 = torch.where(
                cand1_ok & (phat1 > 0.0),
                phat1 / torch.clamp(pdf_sun + pdf_b_sun, min=1e-12), 0.0)
            wsum_sun = w_s1
            sun_dir_w = sun_dir_s
            sel_phat_sun = phat1
        sun_candidate = sun_nee_on & (wsum_sun > 0.0)
        sun_ris_w = torch.where(
            sun_candidate, wsum_sun / torch.clamp(sel_phat_sun, min=1e-20), 0.0)
        rays_traced = rays_traced + sun_candidate.to(torch.float32).sum()
        t_sun = (fog_transmittance(fog, shadow_origin, sun_dir_w, 1e7)
                 if fog_on else None)
        if config.use_clouds:
            # cloud shadows, marched for the sun candidates only
            cix = torch.nonzero(sun_candidate).flatten()
            t_cloud = ones.clone()
            t_cloud[cix] = cloud_sun_transmittance(
                scene.clouds, vgather(shadow_origin, cix), sun_v,
                layers=config.cloud_layers)
            t_sun = t_cloud if t_sun is None else t_sun * t_cloud
        tws = water_tr(shadow_origin, sun_dir_w, 1e7, water_scatter)

        # ---- NEE 2: emissive triangles, RIS over K candidates ----
        stage("light NEE (RIS, light tree)")
        k_ris = max(int(config.ris_candidates), 1)
        wsum = zeros
        sel_phat = zeros
        sel_pdf_sa = ones
        sel_le = (zeros, zeros, zeros)
        sel_dir = Vec3(zeros, zeros, ones)
        sel_dist = ones
        if use_aux:  # the winner's point, for its luminance map
            sel_slot = torch.zeros(n, dtype=torch.int32, device=dev)
            sel_b1 = sel_b2 = zeros
        for k in range(k_ris):
            dk = depth * 8 + k
            if lights.has_tree and k == 0:
                t_slot, t_pdf, t_valid = sample_light_tree(
                    lights.tree_rows, lights.tree_num_nodes,
                    lights.tree_levels, shadow_origin, pixel_id, sample_id,
                    dk, bn=bn)
                cand = dict(slot=t_slot, pdf_select=t_pdf, sel_valid=t_valid)
            else:
                cand = {}
            (l_slot, l_point, l_n, pdf_area, pdf_area_alias,
             (le_r, le_g, le_b), l_valid, (l_b1, l_b2)) = sample_light_point(
                lights, scene.light_slot_rows if use_rows else None,
                pixel_id, sample_id, dk, geo=geo, materials=mats, bn=bn,
                **cand)
            to_light = l_point - shadow_origin
            dist = torch.sqrt(torch.clamp(dot(to_light, to_light), min=0.0))
            inv_dist = torch.reciprocal(torch.clamp(dist, min=1e-8))
            l_dir = vwhere(
                dist > 1e-6,
                Vec3(to_light.x * inv_dist, to_light.y * inv_dist,
                     to_light.z * inv_dist),
                Vec3.of(0.0, 0.0, 1.0, like=to_light))
            cos_l = -dot(l_n, l_dir)
            pdf_l_sa = pdf_area * dist * dist / torch.clamp(cos_l, min=1e-8)
            pdf_mis_sa = (pdf_area_alias * dist * dist
                          / torch.clamp(cos_l, min=1e-8))
            cos_s = dot(l_dir, ns)
            cos_s_ok = cos_s > 0.0
            cos_term = torch.clamp(cos_s, min=0.0)
            if vol_on:
                cos_s_ok = vol_lane | cos_s_ok
                cos_term = torch.where(vol_lane, 1.0, cos_term)
            cand_ok = (nee_lane & l_valid & (cos_l > 1e-6) & cos_s_ok
                       & (dist > 1e-5))
            if multi_bridge:  # no geometry NEE after a fog scatter
                cand_ok = cand_ok & ~vol_scattered
            lum_le = _lum(le_r, le_g, le_b)
            phat = lum_le * cos_l * cos_term * inv_dist * inv_dist
            w_k = torch.where(
                cand_ok & (pdf_l_sa > 1e-12) & (phat > 0.0),
                phat / torch.clamp(pdf_l_sa, min=1e-12), 0.0)
            wsum = wsum + w_k
            if k == 0:
                take = w_k > 0.0
            else:
                r_k = random_1d(RandomTarget.LIGHT_RIS, pixel_id, sample_id,
                                dk, bn=bn)
                take = (r_k * wsum < w_k) & (w_k > 0.0)
            sel_phat = torch.where(take, phat, sel_phat)
            sel_pdf_sa = torch.where(take, pdf_mis_sa, sel_pdf_sa)
            sel_le = tuple(torch.where(take, c, s)
                           for c, s in zip((le_r, le_g, le_b), sel_le))
            sel_dir = vwhere(take, l_dir, sel_dir)
            sel_dist = torch.where(take, dist, sel_dist)
            if use_aux:
                sel_slot = torch.where(take, l_slot, sel_slot)
                sel_b1 = torch.where(take, l_b1, sel_b1)
                sel_b2 = torch.where(take, l_b2, sel_b2)
        ris_w = torch.where(
            sel_phat > 0.0,
            wsum / (k_ris * torch.clamp(sel_phat, min=1e-20)), 0.0)
        (fl_r, fl_g, fl_b), pdf_b_l = frame_eval(
            lane_mat, frame, lane_mat.roughness, sel_dir)
        if vol_on:
            phase_l = vol_phase(dot(direction, sel_dir))
            fl_r = torch.where(vol_lane, phase_l, fl_r)
            fl_g = torch.where(vol_lane, phase_l, fl_g)
            fl_b = torch.where(vol_lane, phase_l, fl_b)
            pdf_b_l = torch.where(vol_lane, phase_l, pdf_b_l)
        if config.use_particles:
            (fl_r, fl_g, fl_b), pdf_b_l = _particle_phase(
                particle_lane, lane_mat, direction, sel_dir,
                config.particle_diameter, (fl_r, fl_g, fl_b), pdf_b_l)
        sel_w_mis = mis_balance(sel_pdf_sa, pdf_b_l)
        le_r, le_g, le_b = sel_le
        l_dir, dist = sel_dir, sel_dist
        light_candidate = wsum > 0.0
        if use_aux:
            # the luminance map at the sampled light point, so that NEE's Le
            # equals the Le a BSDF hit there would see
            wb0 = 1.0 - sel_b1 - sel_b2
            if use_rows:
                wrow = gather_packed_planar(scene.shade_aux, sel_slot, SHA_COLS)
                wlum, _ = unpack_i16_pair(wrow[SHA_TEX_L_ABBE])
                wu0, wv0 = unpack_f16_pair(wrow[SHA_UV0])
                wu1, wv1 = unpack_f16_pair(wrow[SHA_UV1])
                wu2, wv2 = unpack_f16_pair(wrow[SHA_UV2])
                wuu = wu0 * wb0 + wu1 * sel_b1 + wu2 * sel_b2
                wvv = wv0 * wb0 + wv1 * sel_b1 + wv2 * sel_b2
            else:
                ss = sel_slot.long()
                wlum = mats.luminance_tex[geo.material_id[ss].long()]
                wu3 = vgather(geo.uv_u, ss)
                wv3 = vgather(geo.uv_v, ss)
                wuu = wu3.x * wb0 + wu3.y * sel_b1 + wu3.z * sel_b2
                wvv = wv3.x * wb0 + wv3.y * sel_b1 + wv3.z * sel_b2
            wlr, wlg, wlb, _ = sample_atlas(scene.textures, wlum, wuu, wvv)
            le_r = torch.where(wlum >= 0, le_r * wlr, le_r)
            le_g = torch.where(wlum >= 0, le_g * wlg, le_g)
            le_b = torch.where(wlum >= 0, le_b * wlb, le_b)
        rays_traced = rays_traced + light_candidate.to(torch.float32).sum()

        # ---- NEE 3: the environment, one alias-cell draw per vertex; Le is
        # the sky without the disc (the disc pairs with the sun strategy) ----
        stage("env NEE")
        if config.env_nee:
            env_dir, pdf_env = sample_env_direction(sky, pixel_id, sample_id,
                                                    depth, bn=bn)
            (fe_r, fe_g, fe_b), pdf_b_env = frame_eval(
                lane_mat, frame, lane_mat.roughness, env_dir)
            if vol_on:
                phase_env = vol_phase(dot(direction, env_dir))
                fe_r = torch.where(vol_lane, phase_env, fe_r)
                fe_g = torch.where(vol_lane, phase_env, fe_g)
                fe_b = torch.where(vol_lane, phase_env, fe_b)
                pdf_b_env = torch.where(vol_lane, phase_env, pdf_b_env)
                side_ok = vol_lane | (dot(env_dir, ns) > 0.0)
            else:
                side_ok = dot(env_dir, ns) > 0.0
            if config.use_particles:
                (fe_r, fe_g, fe_b), pdf_b_env = _particle_phase(
                    particle_lane, lane_mat, direction, env_dir,
                    config.particle_diameter, (fe_r, fe_g, fe_b), pdf_b_env)
            env_candidate = (nee_lane & (pdf_env > 1e-12)
                             & (sky.env_nee_total > 0.0) & side_ok)
            rays_traced = rays_traced + env_candidate.to(torch.float32).sum()
            env_le = (Vec3(*sky_radiance_spectral(sky, env_dir, lam3))
                      if spectral else
                      sky_radiance(sky, env_dir, include_sun=False))
            t_fog_env = (fog_transmittance(fog, shadow_origin, env_dir, 1e7)
                         if fog_on else None)
            twe = water_tr(shadow_origin, env_dir, 1e7, water_scatter)
            w_mis_env = mis_balance(pdf_env, pdf_b_env)

        # ---- NEE 4: sun caustics for underwater vertices, connected on
        # the lanes that can use them ----
        if config.ocean_caustics:
            stage("caustics")
            uw_lane = nee_lane & (shadow_origin.y < water.height) & sun_nee_on
            if not water.active:
                uw_lane = false
            uix = torch.nonzero(uw_lane).flatten()
            cau_p = Vec3(*(c.clone() for c in shadow_origin))
            cau_u = Vec3(zeros.clone(), ones.clone(), zeros.clone())
            cau_dist, cau_weight = ones.clone(), zeros.clone()
            cau_valid = false.clone()
            p_, u_, d_, w_, v_ = sample_caustic_connection(
                water, sun_v, vgather(shadow_origin, uix), pixel_id[uix],
                _lane_ids(sample_id, uix), depth, config.caustics_k)
            for full, part in zip((*cau_p, *cau_u, cau_dist, cau_weight,
                                   cau_valid), (*p_, *u_, d_, w_, v_)):
                full[uix] = part
            cau_candidate = uw_lane & cau_valid
            rays_traced = rays_traced + 2.0 * cau_candidate.to(torch.float32).sum()

        # ---- all shadow rays in one batched any-hit walk over the opaque
        # geometry, in the reference's segment order (sun, light, env,
        # caustic x→P, caustic P→sun); then the ocean surface and the
        # cutouts' transparency ----
        stage("shadow walk")
        full_t = torch.full((n,), MISS_DIST, device=dev)
        seg_o = [shadow_origin, shadow_origin]
        seg_d = [sun_dir_w, l_dir]
        seg_t = [full_t, dist - 2.0 * _RAY_EPS]
        seg_a = [sun_candidate, light_candidate]
        if config.env_nee:
            seg_o.append(shadow_origin)
            seg_d.append(env_dir)
            seg_t.append(full_t)
            seg_a.append(env_candidate)
        if config.ocean_caustics:
            i_cau = len(seg_o)
            # x → P, shortened (P lies on the surface), and P → sun, off the
            # interface
            seg_o += [shadow_origin,
                      Vec3(cau_p.x + sun_v.x * 0.02,
                           cau_p.y + sun_v.y * 0.02 + 0.02,
                           cau_p.z + sun_v.z * 0.02)]
            seg_d += [cau_u, Vec3(*(c.expand(n) for c in sun_v))]
            seg_t += [cau_dist * 0.95, full_t]
            seg_a += [cau_candidate, cau_candidate]
        shadow_o = Vec3(*(torch.cat([o[c] for o in seg_o]) for c in range(3)))
        shadow_d = Vec3(*(torch.cat([d[c] for d in seg_d]) for c in range(3)))
        shadow_t = torch.cat(seg_t)
        shadow_act = torch.cat(seg_a)
        occ = trace_occluded(geo.bvh, shadow_o, shadow_d, shadow_t,
                             active=shadow_act)
        if config.analytic_ocean:
            # the surface occludes every class; the sign-change test keeps
            # the caustic segments that end on it unblocked by it
            occ = occ | ocean_crosses(water, shadow_o, shadow_d, shadow_t,
                                      shadow_act & ~occ)
        sun_occluded, l_occluded = occ[:n], occ[n:2 * n]
        if cutouts:  # the sun, light and env segments' transparency
            n_tr = 3 * n if config.env_nee else 2 * n
            trans = trace_transmission(
                geo.bvh, Vec3(*(c[:n_tr] for c in shadow_o)),
                Vec3(*(c[:n_tr] for c in shadow_d)), shadow_t[:n_tr],
                active=(shadow_act & ~occ)[:n_tr])
        stage("NEE contributions")
        sun_w = sun_ris_w
        if t_sun is not None:
            sun_w = sun_w * t_sun
        if cutouts:
            sun_w = sun_w * trans[:n]
        sun_w = torch.where(sun_candidate & ~sun_occluded, sun_w, 0.0)
        rad_r = _add(rad_r, thr_r, fs_r, sun_rad3[0], tws[0], sun_w)
        rad_g = _add(rad_g, thr_g, fs_g, sun_rad3[1], tws[1], sun_w)
        rad_b = _add(rad_b, thr_b, fs_b, sun_rad3[2], tws[2], sun_w)
        l_w = sel_w_mis
        if fog_on:
            l_w = l_w * fog_transmittance(fog, shadow_origin, l_dir, dist)
        l_w = l_w * ris_w
        if cutouts:
            l_w = l_w * trans[n:2 * n]
        twl = water_tr(shadow_origin, l_dir, dist, water_scatter)
        # the chosen light's emission to the slots' wavelengths (the
        # bridges below use it too)
        le_r, le_g, le_b = spec3(le_r, le_g, le_b)
        direct_lane = light_candidate & ~vol_lane if use_bridges else light_candidate
        if use_bridges and water_scatter:
            # bridges model fog chains; water vertices connect directly
            direct_lane = direct_lane | (vol_water & light_candidate)
        l_w = torch.where(direct_lane & ~l_occluded, l_w, 0.0)
        rad_r = _add(rad_r, thr_r, fl_r, le_r, twl[0], l_w)
        rad_g = _add(rad_g, thr_g, fl_g, le_g, twl[1], l_w)
        rad_b = _add(rad_b, thr_b, fl_b, le_b, twl[2], l_w)
        if config.env_nee:
            env_w = w_mis_env / torch.clamp(pdf_env, min=1e-12)
            if t_fog_env is not None:
                env_w = env_w * t_fog_env
            if cutouts:
                env_w = env_w * trans[2 * n:3 * n]
            env_w = torch.where(env_candidate & ~occ[2 * n:3 * n], env_w, 0.0)
            rad_r = _add(rad_r, thr_r, fe_r, env_le.x, twe[0], env_w)
            rad_g = _add(rad_g, thr_g, fe_g, env_le.y, twe[1], env_w)
            rad_b = _add(rad_b, thr_b, fe_b, env_le.z, twe[2], env_w)
        if config.ocean_caustics:
            cau_blocked = (occ[i_cau * n:(i_cau + 1) * n]
                           | occ[(i_cau + 1) * n:(i_cau + 2) * n])
            (fc_r, fc_g, fc_b), _pdf_c = frame_eval(
                lane_mat, frame, lane_mat.roughness, cau_u)
            if vol_on:
                phase_c = vol_phase(dot(direction, cau_u))
                fc_r = torch.where(vol_lane, phase_c, fc_r)
                fc_g = torch.where(vol_lane, phase_c, fc_g)
                fc_b = torch.where(vol_lane, phase_c, fc_b)
            if config.use_particles:
                (fc_r, fc_g, fc_b), _ = _particle_phase(
                    particle_lane, lane_mat, direction, cau_u,
                    config.particle_diameter, (fc_r, fc_g, fc_b))
            # x→P lies under water: absorption, and the scattering
            # extinction under in-scattering (a shadow-class segment)
            sig = np.float32(water.scatter if water_scatter else 0.0)
            twc = spec3(*(torch.exp(-float(np.float32(a) + sig) * cau_dist)
                          for a in water.absorb))
            c_w = torch.where(cau_candidate & ~cau_blocked, cau_weight, 0.0)
            rad_r = _add(rad_r, thr_r, fc_r, sun_rad3[0], twc[0], c_w)
            rad_g = _add(rad_g, thr_g, fc_g, sun_rad3[1], twc[1], c_w)
            rad_b = _add(rad_b, thr_b, fc_b, sun_rad3[2], twc[2], c_w)

        # ---- bridge volume NEE: fog vertices connect to the chosen light
        # through 1..bridge_vertices scattering events (M = 1 is the
        # direct connection) ----
        if use_bridges:
            stage("bridges")
            y_pt = Vec3(shadow_origin.x + l_dir.x * dist,
                        shadow_origin.y + l_dir.y * dist,
                        shadow_origin.z + l_dir.z * dist)
            (_b_dir, b_starts, b_dirs, b_lens, b_wpdf, b_phase, b_m) = (
                sample_bridge(
                    shadow_origin, y_pt, direction, fog.g,
                    float(np.float32(fog.sigma_t) * np.float32(fog.scatter_albedo)),
                    fog.sigma_t, config.bridge_vertices, pixel_id, sample_id,
                    depth))
            b_lane = vol_lane & light_candidate
            if water_scatter:
                b_lane = b_lane & ~vol_water
            b_occ = false
            for i in range(config.bridge_vertices):
                act_i = b_lane & (i < b_m) & ~b_occ
                rays_traced = rays_traced + act_i.to(torch.float32).sum()
                b_len = torch.clamp(b_lens[i] - 2.0 * _RAY_EPS, min=0.0)
                b_occ = b_occ | trace_occluded(
                    geo.bvh, b_starts[i], b_dirs[i], b_len, active=act_i)
                if config.analytic_ocean:
                    b_occ = b_occ | ocean_crosses(
                        water, b_starts[i], b_dirs[i], b_len, act_i & ~b_occ)
            # with M >= 2 every order is the bridges' own (vol_scattered
            # stops the forward chain); M = 1 is MIS-paired as the direct
            # connection
            bw = b_phase * b_wpdf * dist * dist * ris_w
            if not multi_bridge:
                bw = bw * sel_w_mis
            bw = torch.where(b_lane & ~b_occ, bw, 0.0)
            rad_r = rad_r + thr_r * le_r * bw
            rad_g = rad_g + thr_g * le_g * bw
            rad_b = rad_b + thr_b * le_b * bw

        # ---- bounce ----
        if depth + 1 < config.max_depth:
            stage("bounce")
            cur_ior = medium_top_ior(medium)
            n_trans = torch.where(front_face | lane_mat.thin_walled,
                                  lane_mat.ior, medium_below_ior(medium))
            eta_rel = n_trans / torch.clamp(cur_ior, min=1e-6)
            wi, (wr, wg, wb), pdf, is_delta, transmitted = material_sample(
                lane_mat, frame, ns, wo, pixel_id, sample_id, depth,
                eta_rel=eta_rel, bn=bn)
            do_trans = active & hit_lane & transmitted & ~pass_thru
            medium = torch.where(
                do_trans,
                torch.where(front_face, medium_push(medium, lane_mat.ior),
                            medium_pop(medium)),
                medium)
            if config.use_particles:
                # particle lanes bounce by JE phase sampling, whose weight
                # is the albedo (phase / pdf = 1)
                r_p1 = random_1d(RandomTarget.PARTICLE_PHASE, pixel_id,
                                 sample_id, depth, bn=bn)
                r_p2 = random_1d(RandomTarget.VOLUME_PHASE, pixel_id,
                                 sample_id, depth, bn=bn)
                r_pc = random_1d(RandomTarget.BSDF_CHOICE, pixel_id,
                                 sample_id, depth, bn=bn)
                wi_p = je_sample_direction(direction, config.particle_diameter,
                                           r_p1, r_p2, r_pc)
                wi = vwhere(particle_lane, wi_p, wi)
                wr = torch.where(particle_lane, lane_mat.albedo_r, wr)
                wg = torch.where(particle_lane, lane_mat.albedo_g, wg)
                wb = torch.where(particle_lane, lane_mat.albedo_b, wb)
                pdf = torch.where(particle_lane, je_phase(
                    dot(direction, wi_p), config.particle_diameter), pdf)
                is_delta = torch.where(particle_lane, False, is_delta)
                transmitted = torch.where(particle_lane, False, transmitted)
            if vol_on:
                # volume lanes bounce by phase sampling: phase / pdf = 1
                wi_vol = sample_hg_direction(direction, fog.g, pixel_id,
                                             sample_id, depth, bn=bn)
                if water_scatter:
                    wi_vol = vwhere(vol_water, sample_ocean_phase_direction(
                        direction, water, pixel_id, sample_id, depth, bn=bn),
                        wi_vol)
                pdf_vol = vol_phase(dot(direction, wi_vol))
                wi = vwhere(vol_lane, wi_vol, wi)
                wr = torch.where(vol_lane, 1.0, wr)
                wg = torch.where(vol_lane, 1.0, wg)
                wb = torch.where(vol_lane, 1.0, wb)
                pdf = torch.where(vol_lane, pdf_vol, pdf)
                is_delta = torch.where(vol_lane, False, is_delta)
            wi = vwhere(pass_thru, direction, wi)
            wr = torch.where(pass_thru, 1.0, wr)
            wg = torch.where(pass_thru, 1.0, wg)
            wb = torch.where(pass_thru, 1.0, wb)
            thr_r = thr_r * torch.where(active, wr, 1.0)
            thr_g = thr_g * torch.where(active, wg, 1.0)
            thr_b = thr_b * torch.where(active, wb, 1.0)
            if spectral:
                # the hero-wavelength collapse at a dispersive refraction:
                # the other slots would refract elsewhere, so they end and
                # the hero carries the estimate (x3, the dropped 1/C)
                disperse = do_trans & (abbe_lane > 0.0) & ~lane_mat.thin_walled
                thr_r = torch.where(disperse & ~collapsed, thr_r * 3.0, thr_r)
                thr_g = torch.where(disperse, 0.0, thr_g)
                thr_b = torch.where(disperse, 0.0, thr_b)
                collapsed = collapsed | disperse
            off = torch.where(transmitted, -_RAY_EPS, _RAY_EPS)
            origin = vwhere(
                pass_thru,
                Vec3(hit_pos.x + direction.x * _RAY_EPS,
                     hit_pos.y + direction.y * _RAY_EPS,
                     hit_pos.z + direction.z * _RAY_EPS),
                Vec3(hit_pos.x + ng.x * off, hit_pos.y + ng.y * off,
                     hit_pos.z + ng.z * off))
            if vol_on:
                origin = vwhere(vol_lane, vol_pos, origin)
            direction = vwhere(active, wi, direction)
            prev_pdf = torch.where(active & ~pass_thru, pdf,
                                   torch.where(pass_thru, prev_pdf, 0.0))
            prev_delta = torch.where(active & ~pass_thru, is_delta, prev_delta)
            refl_side = vol_lane | ~transmitted if vol_on else ~transmitted
            upd = active & ~pass_thru
            prev_sun_nee = torch.where(upd, sun_nee_on & refl_side,
                                       prev_sun_nee & pass_thru)
            prev_sun2 = torch.where(upd, sun2_on & refl_side,
                                    prev_sun2 & pass_thru)
            prev_light_nee = torch.where(
                upd, nee_lane & (lights.num_lights > 0) & refl_side,
                prev_light_nee & pass_thru)
            if config.env_nee:
                env_on_lane = nee_lane & (sky.env_nee_total > 0.0) & refl_side
                prev_env_nee = torch.where(upd, env_on_lane,
                                           prev_env_nee & pass_thru)
            if config.ocean_caustics:
                is_ocean = mat_id == config.ocean_mat_id
                ocean_exit = torch.where(
                    upd, hit_lane & transmitted & is_ocean & ~front_face,
                    ocean_exit & pass_thru)
            if multi_bridge:  # sticky for the rest of the path (fog only)
                vol_scattered = vol_scattered | (
                    vol_lane & ~vol_water if water_scatter else vol_lane)

            wmax = torch.maximum(torch.abs(wr), torch.maximum(torch.abs(wg),
                                                              torch.abs(wb)))
            active = active & (wmax > 0.0)

            # Russian roulette past depth 2
            if depth >= 2:
                tmax = torch.maximum(thr_r, torch.maximum(thr_g, thr_b))
                p_continue = torch.clamp(tmax, 0.05, 1.0)
                r = random_1d(RandomTarget.RUSSIAN_ROULETTE, pixel_id,
                              sample_id, depth, bn=bn)
                active = active & (r < p_continue)
                inv_p = 1.0 / p_continue
                thr_r, thr_g, thr_b = thr_r * inv_p, thr_g * inv_p, thr_b * inv_p

            # ---- the wavefront sort for the next depth: every lane's
            # state follows its new place (a stable sort, so lanes of one
            # key keep their order) ----
            if sort:
                stage("wavefront sort")
                perm = torch.argsort(
                    ray_sort_key(origin, direction, active, geo.bvh.bounds),
                    stable=True)
                if sample_id.dim() == 0:
                    sample_id = sample_id.expand(n)
                state = [origin, direction, thr_r, thr_g, thr_b, rad_r, rad_g,
                         rad_b, prev_pdf, prev_delta, active, miss_dir,
                         miss_thr_r, miss_thr_g, miss_thr_b, miss_sun_weight,
                         miss_env_weight, ever_missed, pixel_id, sample_id,
                         orig_lane, medium, prev_sun_nee, prev_sun2,
                         prev_light_nee, prev_env_nee, ocean_exit,
                         vol_scattered, bn]
                if spectral:
                    state += [collapsed, lam3, lam_pdf3]
                state = [_permute(x, perm) for x in state]
                (origin, direction, thr_r, thr_g, thr_b, rad_r, rad_g, rad_b,
                 prev_pdf, prev_delta, active, miss_dir, miss_thr_r,
                 miss_thr_g, miss_thr_b, miss_sun_weight, miss_env_weight,
                 ever_missed, pixel_id, sample_id, orig_lane, medium,
                 prev_sun_nee, prev_sun2, prev_light_nee, prev_env_nee,
                 ocean_exit, vol_scattered, bn) = state[:29]
                if spectral:
                    collapsed, lam3, lam_pdf3 = state[29:]

    # ---- deferred sky: one evaluation for all recorded misses ----
    stage("sky and miss")
    safe_dir = vwhere(ever_missed, miss_dir, Vec3.of(0.0, 1.0, 0.0, like=miss_dir))
    in_sun_disc = dot(safe_dir, sun_v) >= SUN_COS_RADIUS
    disc_w = torch.where(in_sun_disc, miss_sun_weight, 0.0)
    if not spectral or config.use_clouds:
        sky_rgb = sky_radiance(sky, safe_dir, include_sun=False)
    sky_r, sky_g, sky_b = (sky_radiance_spectral(sky, safe_dir, lam3)
                           if spectral else sky_rgb)
    if config.env_nee:
        # the MIS weight against env NEE, one pdf lookup for all misses
        env_w_m = torch.where(
            miss_env_weight < 0.0, 1.0,
            mis_balance(miss_env_weight, env_pdf(sky, safe_dir)))
        sky_r, sky_g, sky_b = sky_r * env_w_m, sky_g * env_w_m, sky_b * env_w_m
    sky_r = sky_r + sun_rad3[0] * disc_w
    sky_g = sky_g + sun_rad3[1] * disc_w
    sky_b = sky_b + sun_rad3[2] * disc_w
    if config.use_clouds:
        # the cloud march in front of the sky, for the lanes that missed,
        # in RGB against the RGB sky (clouds are near-grey scatterers); its
        # inscatter then goes to the slots' wavelengths
        stage("clouds")
        mix = torch.nonzero(ever_missed).flatten()
        (cr_, cg_, cb_), ct_ = cloud_march(
            scene.clouds, vgather(origin, mix), vgather(safe_dir, mix), sun_v,
            sun_radiance, tuple(c[mix] for c in sky_rgb),
            steps=config.cloud_steps, layers=config.cloud_layers)
        cr, cg, cb, ct = zeros.clone(), zeros.clone(), zeros.clone(), ones.clone()
        cr[mix], cg[mix], cb[mix], ct[mix] = cr_, cg_, cb_, ct_
        cr, cg, cb = spec3(cr, cg, cb)
        sky_r = cr + sky_r * ct
        sky_g = cg + sky_g * ct
        sky_b = cb + sky_b * ct
    stage("sky and miss")
    add = ever_missed.to(torch.float32)
    rad_r = rad_r + miss_thr_r * sky_r * add
    rad_g = rad_g + miss_thr_g * sky_g * add
    rad_b = rad_b + miss_thr_b * sky_b * add
    if spectral:
        stage("spectral resolve")
        rad_r, rad_g, rad_b = resolve_to_rgb(rad_r, rad_g, rad_b, lam3,
                                             lam_pdf3)
    radiance = torch.stack([rad_r, rad_g, rad_b], dim=-1)
    if sort:  # back to the original lane order
        out = torch.empty_like(radiance)
        out[orig_lane] = radiance
        radiance = out
    return radiance, gbuffer, rays_traced


def _permute(x, perm):
    """A lane state (a tensor, a tuple of them, or None) in sorted order."""
    if x is None:
        return None
    if isinstance(x, Vec3):
        return Vec3(*(c[perm] for c in x))
    if isinstance(x, tuple):
        return tuple(c[perm] for c in x)
    return x[perm]


def _debug_shade(config, scene, hit, hit_lane, slot, mat_id, ns: Vec3):
    """The debug shading modes (ShadingMode 1-5) of the primary hits →
    radiance [N, 3]."""
    mats = scene.materials
    mode = config.shading_mode
    hl = hit_lane.to(torch.float32)
    mat_id = mat_id.long()
    if mode == 1:  # ALBEDO
        return torch.stack([mats.albedo_r[mat_id] * hl,
                            mats.albedo_g[mat_id] * hl,
                            mats.albedo_b[mat_id] * hl], dim=-1)
    if mode == 2:  # DEPTH, over the wavefront's largest
        d = torch.where(hit_lane, hit.t, 0.0)
        d = d / torch.clamp(torch.max(d), min=1e-6)
        return torch.stack([d, d, d], dim=-1)
    if mode == 3:  # NORMAL
        return torch.stack([ns.x * 0.5 + 0.5, ns.y * 0.5 + 0.5,
                            ns.z * 0.5 + 0.5], dim=-1) * hl[:, None]
    if mode == 4:  # IDENTIFICATION: the instance id hashed to a colour
        iid = scene.geo.instance_id[slot.long()].to(torch.int64) & 0xFFFFFFFF
        h = (iid * 2654435761) & 0xFFFFFFFF
        return torch.stack([sdiv((h & 0xFF).to(torch.float32), 255.0) * hl,
                            sdiv(((h >> 8) & 0xFF).to(torch.float32), 255.0) * hl,
                            sdiv(((h >> 16) & 0xFF).to(torch.float32), 255.0) * hl],
                           dim=-1)
    if mode == 5:  # LIGHTS: emissive surfaces highlighted
        emissive = (mats.flags[mat_id] & MAT_FLAG_EMISSIVE) != 0
        v = torch.where(hit_lane & emissive, 1.0, torch.where(hit_lane, 0.1, 0.0))
        return torch.stack([v, v, v], dim=-1)
    raise ValueError(f"unknown shading mode {mode}")
