"""Scene entity definitions.

These mirror the reference's public scene entities one-to-one so that a user of
the reference finds every knob here (reference: include/luminary/structs.h):
RendererSettings, Camera, Ocean, Sky, Cloud(+layers), Fog, Particles, Material,
Instance. All are plain mutable dataclasses; dirty-tracking happens in
:mod:`luminary_tpu_torch.scene.scene` by comparing copies, like the reference's
per-entity ``*_check_for_dirty`` functions (reference: src/luminary/camera.c etc.).

Defaults match the reference's ``*_get_default`` functions where observable.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from enum import IntEnum

Vec3 = tuple[float, float, float]
RGBF = tuple[float, float, float]
RGBAF = tuple[float, float, float, float]


# ---------------------------------------------------------------------------
# Enums (reference: include/luminary/structs.h:40-56, 126-152, 205-218, 344-348)
# ---------------------------------------------------------------------------


class ShadingMode(IntEnum):
    DEFAULT = 0
    ALBEDO = 1
    DEPTH = 2
    NORMAL = 3
    IDENTIFICATION = 4
    LIGHTS = 5


class AdaptiveSamplingOutputMode(IntEnum):
    BEAUTY = 0
    VARIANCE = 1
    ERROR = 2
    SAMPLE_DISTRIBUTION = 3


class Filter(IntEnum):
    NONE = 0
    GRAY = 1
    SEPIA = 2
    GAMEBOY = 3
    TWO_BIT_GRAY = 4
    CRT = 5
    BLACK_WHITE = 6


class ToneMap(IntEnum):
    NONE = 0
    ACES = 1
    REINHARD = 2
    UNCHARTED2 = 3
    AGX = 4
    AGX_PUNCHY = 5
    AGX_CUSTOM = 6


class ApertureShape(IntEnum):
    ROUND = 0
    BLADED = 1


class JerlovWaterType(IntEnum):
    I = 0
    IA = 1
    IB = 2
    II = 3
    III = 4
    C1 = 5
    C3 = 6
    C5 = 7
    C7 = 8
    C9 = 9


class SkyMode(IntEnum):
    DEFAULT = 0
    HDRI = 1
    CONSTANT_COLOR = 2


class MaterialBaseSubstrate(IntEnum):
    OPAQUE = 0
    TRANSLUCENT = 1


# ---------------------------------------------------------------------------
# Entities
# ---------------------------------------------------------------------------


@dataclass
class RendererSettings:
    """reference: include/luminary/structs.h:58-76 (LuminaryRendererSettings)."""

    width: int = 1920
    height: int = 1080
    max_ray_depth: int = 8
    bridge_max_num_vertices: int = 1
    # K resampled NEE candidates per path vertex (RIS; reference ris.cuh).
    light_ris_candidates: int = 4
    # Environment-map NEE (reference: direct_lighting ambient tasks +
    # sky_hdri.cuh). Active for DEFAULT (clear) and HDRI skies; the renderer
    # gates it off when the cloud march runs (clouds are only applied on the
    # BSDF-miss side, so MIS pairing would bias).
    ambient_nee: bool = True
    # Sun NEE RIS second candidate (BSDF-proposed direction; reference:
    # direct_lighting.cuh:21-119). Improves rough-specular sun highlights.
    sun_ris: bool = True
    # Aerial perspective: atmosphere transmittance + inscatter applied to
    # every path segment that ends on geometry (reference: the per-depth
    # SKY_INSCATTERING queue position, device_renderer.c:59-131). DEFAULT
    # skies only.
    aerial_perspective: bool = True
    # Full-path spectral rendering (reference: spectral.cuh CIE-CDF
    # wavelength sampling + the 8-wavelength sky of sky.cuh): hero
    # wavelength with 3 rotations riding the RGB channel slots, resolved
    # to sRGB per sample (ops/spectral.py).
    spectral_rendering: bool = False
    # Re-sort the wavefront between depths by traversal coherence
    # (tasks_sort analog; measured net-negative on the benchmark scene, so
    # opt-in).
    wavefront_sorting: bool = False
    # Blue-noise sampling (reference: random.cuh random_2D_base — Sobol +
    # per-pixel blue-noise Cranley-Patterson shift for every draw, making
    # low-spp error distribute as blue noise across the screen). The
    # reference has no toggle; ours exists for A/B measurement.
    blue_noise: bool = True
    undersampling: int = 3
    supersampling: int = 1
    enable_adaptive_sampling: bool = False
    adaptive_sampling_max_sampling_rate: int = 8
    adaptive_sampling_avg_sampling_rate: int = 2
    adaptive_sampling_update_interval: int = 32
    adaptive_sampling_exposure_aware: bool = True
    adaptive_sampling_output_mode: AdaptiveSamplingOutputMode = (
        AdaptiveSamplingOutputMode.BEAUTY
    )
    shading_mode: ShadingMode = ShadingMode.DEFAULT
    region_x: float = 0.0
    region_y: float = 0.0
    region_width: float = 1.0
    region_height: float = 1.0


@dataclass
class ThinLens:
    fov: float = 1.0
    aperture_size: float = 0.0


@dataclass
class PhysicalCameraParams:
    allow_reflections: bool = False
    use_spectral_rendering: bool = False
    focal_length: float = 0.05
    front_focal_point: float = 0.0
    back_focal_point: float = 0.0
    front_principal_point: float = 0.0
    back_principal_point: float = 0.0
    aperture_point: float = 0.0
    aperture_diameter: float = 0.0
    exit_pupil_point: float = 0.0
    exit_pupil_diameter: float = 0.0
    image_plane_distance: float = 0.05
    sensor_width: float = 0.036


@dataclass
class Camera:
    """reference: include/luminary/structs.h:154-203 (LuminaryCamera)."""

    pos: Vec3 = (0.0, 0.0, 0.0)
    rotation: Vec3 = (0.0, 0.0, 0.0)
    aperture_shape: ApertureShape = ApertureShape.ROUND
    aperture_blade_count: int = 7
    exposure: float = 1.0
    tonemap: ToneMap = ToneMap.AGX
    agx_custom_slope: float = 1.0
    agx_custom_power: float = 1.0
    agx_custom_saturation: float = 1.0
    filter: Filter = Filter.NONE
    use_local_error_minimization: bool = False
    bloom_blend: float = 0.0
    dithering: bool = True
    purkinje: bool = False
    purkinje_kappa1: float = 0.2
    purkinje_kappa2: float = 0.29
    wasd_speed: float = 1.0
    mouse_speed: float = 1.0
    smooth_movement: bool = False
    smoothing_factor: float = 0.1
    russian_roulette_threshold: float = 0.1
    use_color_correction: bool = False
    color_correction: RGBF = (0.0, 0.0, 0.0)
    film_grain: float = 0.0
    camera_scale: float = 1.0
    object_distance: float = 1.0
    use_physical_camera: bool = False
    thin_lens: ThinLens = field(default_factory=ThinLens)
    physical: PhysicalCameraParams = field(default_factory=PhysicalCameraParams)


@dataclass
class Ocean:
    """reference: include/luminary/structs.h:220-233 (LuminaryOcean)."""

    active: bool = False
    height: float = 0.0
    amplitude: float = 0.2
    frequency: float = 0.12
    refractive_index: float = 1.333
    water_type: JerlovWaterType = JerlovWaterType.IB
    caustics_active: bool = False
    caustics_ris_sample_count: int = 32
    caustics_domain_scale: float = 0.5
    multiscattering: bool = False
    triangle_light_contribution: bool = False
    # False (default) = analytic heightfield raymarch in the integrator
    # (reference: cuda/ocean_utils.cuh — the reference never tessellates);
    # True = opt back into the legacy camera-centered tessellated grid.
    tessellated: bool = False


@dataclass
class Sky:
    """reference: include/luminary/structs.h:250-279 (LuminarySky)."""

    geometry_offset: Vec3 = (0.0, 0.1, 0.0)
    azimuth: float = 3.141
    altitude: float = 0.5
    moon_azimuth: float = 0.0
    moon_altitude: float = -0.5
    moon_tex_offset: float = 0.0
    sun_strength: float = 1.0
    base_density: float = 1.0
    ozone_absorption: bool = True
    steps: int = 40
    stars_count: int = 10000
    stars_seed: int = 0
    stars_intensity: float = 1.0
    rayleigh_density: float = 1.0
    mie_density: float = 1.0
    ozone_density: float = 1.0
    rayleigh_falloff: float = 8.0
    mie_falloff: float = 1.7
    mie_diameter: float = 2.0
    ground_visibility: float = 60.0
    ozone_layer_thickness: float = 15.0
    multiscattering_factor: float = 1.0
    hdri_dim: int = 2048
    hdri_samples: int = 50
    aerial_perspective: bool = False
    constant_color: RGBF = (1.0, 1.0, 1.0)
    mode: SkyMode = SkyMode.DEFAULT


@dataclass
class CloudLayer:
    """reference: include/luminary/structs.h:285-295 (LuminaryCloudLayer)."""

    active: bool = False
    height_max: float = 5000.0
    height_min: float = 1500.0
    coverage: float = 1.0
    coverage_min: float = 0.0
    type: float = 1.0
    type_min: float = 0.0
    wind_speed: float = 0.0
    wind_angle: float = 0.0


@dataclass
class Cloud:
    """reference: include/luminary/structs.h:297-317 (LuminaryCloud)."""

    active: bool = False
    initialized: bool = False
    atmosphere_scattering: bool = True
    low: CloudLayer = field(default_factory=lambda: CloudLayer(active=True))
    mid: CloudLayer = field(default_factory=lambda: CloudLayer(height_min=6000.0, height_max=6500.0))
    top: CloudLayer = field(default_factory=lambda: CloudLayer(height_min=8000.0, height_max=9000.0))
    offset_x: float = 0.0
    offset_z: float = 0.0
    density: float = 1.0
    seed: int = 1
    droplet_diameter: float = 25.0
    steps: int = 96
    shadow_steps: int = 8
    noise_shape_scale: float = 1.0
    noise_detail_scale: float = 1.0
    noise_weather_scale: float = 1.0
    mipmap_bias: float = 0.0
    octaves: int = 9


@dataclass
class Fog:
    """reference: include/luminary/structs.h:323-329 (LuminaryFog)."""

    active: bool = False
    density: float = 1.0
    droplet_diameter: float = 10.0
    height: float = 500.0
    dist: float = 500.0


@dataclass
class Particles:
    """reference: include/luminary/structs.h:335-347 (LuminaryParticles)."""

    active: bool = False
    seed: int = 0
    count: int = 8192
    albedo: RGBF = (1.0, 1.0, 1.0)
    speed: float = 0.0
    direction_altitude: float = 1.234
    direction_azimuth: float = 0.0
    phase_diameter: float = 50.0
    scale: float = 10.0
    size: float = 1.0
    size_variation: float = 1.0


TEXTURE_NONE = 0xFFFF


@dataclass
class Material:
    """reference: include/luminary/structs.h:356-382 (LuminaryMaterial)."""

    id: int = 0
    base_substrate: MaterialBaseSubstrate = MaterialBaseSubstrate.OPAQUE
    albedo: RGBAF = (0.9, 0.9, 0.9, 1.0)
    emission: RGBF = (0.0, 0.0, 0.0)
    emission_scale: float = 1.0
    roughness: float = 0.7
    roughness_clamp: float = 0.25
    refraction_index: float = 1.5
    # Abbe number for spectral dispersion through this dielectric
    # (reference: camera_physical.cuh Abbe dispersion; 0 = non-dispersive).
    abbe: float = 0.0
    emission_active: bool = False
    thin_walled: bool = False
    metallic: bool = False
    colored_transparency: bool = False
    roughness_as_smoothness: bool = False
    normal_map_is_compressed: bool = False
    bidirectional_emission: bool = False
    albedo_tex: int = TEXTURE_NONE
    luminance_tex: int = TEXTURE_NONE
    roughness_tex: int = TEXTURE_NONE
    metallic_tex: int = TEXTURE_NONE
    normal_tex: int = TEXTURE_NONE


@dataclass
class Instance:
    """reference: include/luminary/structs.h:388-395 (LuminaryInstance)."""

    id: int = 0
    mesh_id: int = 0
    position: Vec3 = (0.0, 0.0, 0.0)
    rotation: Vec3 = (0.0, 0.0, 0.0)
    scale: Vec3 = (1.0, 1.0, 1.0)
    active: bool = True


def copy_entity(entity):
    """Deep-ish copy of a scene entity (dataclass trees of immutables)."""
    if dataclasses.is_dataclass(entity):
        return type(entity)(
            **{
                f.name: copy_entity(getattr(entity, f.name))
                for f in dataclasses.fields(entity)
            }
        )
    return entity
