"""``.lum`` scene-description parsing (v4) and writing.

Format (reference: src/luminary/host/lum_v4.c, LumFileDocsV4.md): line-based
``CATEGORY KEY8____ values`` records where the 8-char key is matched as a unit
(the reference switches on the key read as a u64, lum_v4.c:20-72; we match the
string). Header is ``Luminary`` + ``VERSION <n>``. Categories dispatch on their
leading characters (lum_v4.c:704-736): G=GENERAL, M=MATERIAL(legacy globals),
CA=CAMERA, S=SKY, CL=CLOUD, F=FOG, O=OCEAN, P=PARTICLE, T=TOY(legacy, ignored).

The parse result is a :class:`LumFileContent` — obj paths + instances + entity
values (reference: host/lum.h:9-20) — which the host applies to its scene.

A host copy of ``luminary_tpu/io/lum.py``: the port keeps its own so that it
imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..scene.entities import (
    ApertureShape,
    Camera,
    Cloud,
    Filter,
    Fog,
    Instance,
    JerlovWaterType,
    Ocean,
    Particles,
    RendererSettings,
    Sky,
    SkyMode,
    ToneMap,
)
from ..io.wavefront import WavefrontArguments
from ..utils.errors import FileIOError
from ..utils.log import warn_message

CURRENT_LUM_VERSION = 4


@dataclass
class LumFileContent:
    """reference: src/luminary/host/lum.h:9-20 (LumFileContent)."""

    obj_file_paths: list[str] = field(default_factory=list)
    instances: list[Instance] = field(default_factory=list)
    settings: RendererSettings = field(default_factory=RendererSettings)
    camera: Camera = field(default_factory=Camera)
    ocean: Ocean = field(default_factory=Ocean)
    sky: Sky = field(default_factory=Sky)
    cloud: Cloud = field(default_factory=Cloud)
    fog: Fog = field(default_factory=Fog)
    particles: Particles = field(default_factory=Particles)
    wavefront_args: WavefrontArguments = field(default_factory=WavefrontArguments)
    # Not in RendererSettings (the reference ignores these; we keep them for
    # the benchmark harness): target sample count / output file name.
    sample_count: int | None = None
    output_path: str | None = None


def _floats(value: str, n: int) -> list[float]:
    parts = value.split()
    out = [float(p) for p in parts[:n]]
    while len(out) < n:
        out.append(0.0)
    return out


def _f(value: str) -> float:
    return float(value.split()[0])


def _u(value: str) -> int:
    return int(float(value.split()[0]))


def _b(value: str) -> bool:
    return _u(value) != 0


def _parse_general(c: LumFileContent, key: str, value: str) -> None:
    if key == "MESHFILE":
        mesh_id = len(c.obj_file_paths)
        c.obj_file_paths.append(value.split()[0])
        # Legacy behaviour: every MESHFILE spawns an untransformed instance
        # (lum_v4.c MESHFILE case).
        c.instances.append(Instance(id=len(c.instances), mesh_id=mesh_id))
    elif key == "WIDTH___":
        c.settings.width = _u(value)
    elif key == "HEIGHT__":
        c.settings.height = _u(value)
    elif key == "BOUNCES_":
        c.settings.max_ray_depth = _u(value)
    elif key == "SAMPLES_":
        c.sample_count = _u(value)
    elif key == "OUTPUTFN":
        c.output_path = value.split()[0]
    elif key == "AMBIENTN":
        c.settings.ambient_nee = _b(value)
    elif key == "SUNRIS__":
        c.settings.sun_ris = _b(value)
    elif key == "SPECTRAL":
        c.settings.spectral_rendering = _b(value)
    elif key == "AERIALPE":
        c.settings.aerial_perspective = _b(value)
    elif key == "BLUENOIS":
        c.settings.blue_noise = _b(value)
    elif key in ("NUMLIGHT", "DENOISER"):
        pass  # legacy, ignored (lum_v4.c NUMLIGHT case)
    else:
        warn_message("%s is not a valid GENERAL setting.", key)


def _parse_material(c: LumFileContent, key: str, value: str) -> None:
    # Legacy global material settings → wavefront conversion args
    # (lum_v4.c LegacyLumFileSettings).
    if key == "EMISSION":
        c.wavefront_args.emission_scale = _f(value)
    elif key == "COLORTRA":
        c.wavefront_args.force_transparency_cutout = _b(value)
    elif key == "INTERTRO":
        c.wavefront_args.force_thin_walled = _b(value)
    elif key == "SMOOTHNE":
        c.wavefront_args.legacy_smoothness = True
    elif key in ("LIGHTSON", "OVERRIDE", "METALLIC", "ALPHACUT", "IORSHADO", "ROUGHCLA", "FRESNEL_"):
        pass  # legacy, ignored
    else:
        warn_message("%s is not a valid MATERIAL setting.", key)


def _parse_camera(c: LumFileContent, key: str, value: str) -> None:
    cam = c.camera
    if key == "POSITION":
        cam.pos = tuple(_floats(value, 3))
    elif key == "ROTATION":
        cam.rotation = tuple(_floats(value, 3))
    elif key == "FOV_____":
        cam.thin_lens.fov = _f(value)
    elif key == "FOCALLEN":
        cam.object_distance = _f(value)
    elif key == "APERTURE":
        cam.thin_lens.aperture_size = _f(value)
    elif key == "APESHAPE":
        cam.aperture_shape = ApertureShape(_u(value))
    elif key == "APEBLACO":
        cam.aperture_blade_count = _u(value)
    elif key == "EXPOSURE":
        cam.exposure = _f(value)
    elif key == "BLOOM___":
        cam.bloom_blend = 0.1 if _b(value) else 0.0
    elif key in ("BLOOMBLE", "BLOOMSTR"):
        cam.bloom_blend = _f(value)
    elif key == "DITHER__":
        cam.dithering = _b(value)
    elif key == "TONEMAP_":
        cam.tonemap = ToneMap(_u(value))
    elif key == "AGXSLOPE":
        cam.agx_custom_slope = _f(value)
    elif key == "AGXPOWER":
        cam.agx_custom_power = _f(value)
    elif key == "AGXSATUR":
        cam.agx_custom_saturation = _f(value)
    elif key == "FILTER__":
        cam.filter = Filter(_u(value))
    elif key == "PURKINJE":
        cam.purkinje = _b(value)
    elif key == "RUSSIANR":
        cam.russian_roulette_threshold = _f(value)
    elif key == "FILMGRAI":
        cam.film_grain = _f(value)
    elif key in ("AUTOEXP_", "MINEXPOS", "MAXEXPOS", "LENSFLAR", "LENSFTHR", "FIREFLYC", "FARCLIPD", "ALPHACUT"):
        pass  # legacy / not yet supported knobs, accepted silently like the reference
    else:
        warn_message("%s is not a valid CAMERA setting.", key)


def _parse_sky(c: LumFileContent, key: str, value: str) -> None:
    sky = c.sky
    if key == "MODE____":
        sky.mode = SkyMode(_u(value))
    elif key == "OFFSET__":
        sky.geometry_offset = tuple(_floats(value, 3))
    elif key == "AZIMUTH_":
        sky.azimuth = _f(value)
    elif key == "ALTITUDE":
        sky.altitude = _f(value)
    elif key == "MOONALTI":
        sky.moon_altitude = _f(value)
    elif key == "MOONAZIM":
        sky.moon_azimuth = _f(value)
    elif key == "MOONTEXO":
        sky.moon_tex_offset = _f(value)
    elif key == "SUNSTREN":
        sky.sun_strength = _f(value)
    elif key == "OZONEABS":
        sky.ozone_absorption = _b(value)
    elif key == "STEPS___":
        sky.steps = _u(value)
    elif key == "STARSEED":
        sky.stars_seed = _u(value)
    elif key == "STARINTE":
        sky.stars_intensity = _f(value)
    elif key == "STARNUM_":
        sky.stars_count = _u(value)
    elif key == "DENSITY_":
        sky.base_density = _f(value)
    elif key == "RAYLEDEN":
        sky.rayleigh_density = _f(value)
    elif key == "MIEDENSI":
        sky.mie_density = _f(value)
    elif key == "OZONEDEN":
        sky.ozone_density = _f(value)
    elif key == "RAYLEFAL":
        sky.rayleigh_falloff = _f(value)
    elif key == "MIEFALLO":
        sky.mie_falloff = _f(value)
    elif key == "GROUNDVI":
        sky.ground_visibility = _f(value)
    elif key == "DIAMETER":
        sky.mie_diameter = _f(value)
    elif key == "OZONETHI":
        sky.ozone_layer_thickness = _f(value)
    elif key == "MSFACTOR":
        sky.multiscattering_factor = _f(value)
    elif key == "AERIALPE":
        sky.aerial_perspective = _b(value)
    elif key == "HDRIDIM_":
        sky.hdri_dim = _u(value)
    elif key == "HDRISAMP":
        sky.hdri_samples = _u(value)
    elif key == "COLORCON":
        sky.constant_color = tuple(_floats(value, 3))
    elif key in (
        "HDRIMIPB", "HDRIORIG", "SUNCOLOR", "INTENSIT", "OZONEALB", "SHASTEPS", "MOONALBE",
    ):
        pass  # legacy keys (Example.lum era), accepted silently
    else:
        warn_message("%s is not a valid SKY setting.", key)


def _parse_cloud(c: LumFileContent, key: str, value: str) -> None:
    cl = c.cloud
    if key == "ACTIVE__":
        cl.active = _b(value)
    elif key == "INSCATTE":
        cl.atmosphere_scattering = _b(value)
    elif key == "MIPMAPBI":
        cl.mipmap_bias = _f(value)
    elif key == "SEED____":
        cl.seed = _u(value)
    elif key == "OFFSET__":
        cl.offset_x, cl.offset_z = _floats(value, 2)
    elif key == "SHASCALE":
        cl.noise_shape_scale = _f(value)
    elif key == "DETSCALE":
        cl.noise_detail_scale = _f(value)
    elif key == "WEASCALE":
        cl.noise_weather_scale = _f(value)
    elif key == "DIAMETER":
        cl.droplet_diameter = _f(value)
    elif key == "SHASTEPS":
        cl.shadow_steps = _u(value)
    elif key == "STEPS___":
        cl.steps = _u(value)
    elif key == "DENSITY_":
        cl.density = _f(value)
    elif key[:3] in ("LOW", "MID", "TOP"):
        layer = {"LOW": cl.low, "MID": cl.mid, "TOP": cl.top}[key[:3]]
        sub = key[3:]
        if sub == "ACTIV":
            layer.active = _b(value)
        elif sub == "COVER":
            layer.coverage, layer.coverage_min = _floats(value, 2)
        elif sub == "TYPE_":
            layer.type, layer.type_min = _floats(value, 2)
        elif sub == "HEIGH":
            layer.height_max, layer.height_min = _floats(value, 2)
        elif sub == "WIND_":
            layer.wind_speed, layer.wind_angle = _floats(value, 2)
        else:
            warn_message("%s is not a valid CLOUD setting.", key)
    elif key in (
        "HEIGHTMA", "HEIGHTMI", "CURSCALE", "COVERAGE", "COVERMIN", "ANVIL___",
        "FWDSCATT", "BWDSCATT", "SCATLERP", "WETNESS_", "POWDER__", "SEED___",
    ):
        pass  # legacy single-layer keys
    else:
        warn_message("%s is not a valid CLOUD setting.", key)


def _parse_fog(c: LumFileContent, key: str, value: str) -> None:
    fog = c.fog
    if key == "ACTIVE__":
        fog.active = _b(value)
    elif key == "DENSITY_":
        fog.density = _f(value)
    elif key == "DIAMETER":
        fog.droplet_diameter = _f(value)
    elif key == "DISTANCE":
        fog.dist = _f(value)
    elif key == "HEIGHT__":
        fog.height = _f(value)
    else:
        warn_message("%s is not a valid FOG setting.", key)


def _parse_ocean(c: LumFileContent, key: str, value: str) -> None:
    oc = c.ocean
    if key == "ACTIVE__":
        oc.active = _b(value)
    elif key == "HEIGHT__":
        oc.height = _f(value)
    elif key == "AMPLITUD":
        oc.amplitude = _f(value)
    elif key == "FREQUENC":
        oc.frequency = _f(value)
    elif key == "REFRACT_":
        oc.refractive_index = _f(value)
    elif key == "WATERTYP":
        oc.water_type = JerlovWaterType(_u(value))
    elif key == "CAUSACTI":
        oc.caustics_active = _b(value)
    elif key == "CAUSRISS":
        oc.caustics_ris_sample_count = _u(value)
    elif key == "CAUSSCAL":
        oc.caustics_domain_scale = _f(value)
    elif key == "MULTISCA":
        oc.multiscattering = _b(value)
    elif key == "LIGHTSON":
        oc.triangle_light_contribution = _b(value)
    elif key == "TESSELLA":
        oc.tessellated = _b(value)
    elif key in ("CHOPPY__", "SPEED___", "ANIMATED", "COLOR___", "EMISSIVE"):
        pass  # legacy keys
    else:
        warn_message("%s is not a valid OCEAN setting.", key)


def _parse_particle(c: LumFileContent, key: str, value: str) -> None:
    p = c.particles
    if key == "ACTIVE__":
        p.active = _b(value)
    elif key == "SCALE___":
        p.scale = _f(value)
    elif key == "ALBEDO__":
        p.albedo = tuple(_floats(value, 3))
    elif key == "DIRECTIO":
        p.direction_altitude, p.direction_azimuth = _floats(value, 2)
    elif key == "SPEED___":
        p.speed = _f(value)
    elif key == "PHASEDIA":
        p.phase_diameter = _f(value)
    elif key == "SEED____":
        p.seed = _u(value)
    elif key == "COUNT___":
        p.count = _u(value)
    elif key == "SIZE____":
        p.size = _f(value)
    elif key == "SIZEVARI":
        p.size_variation = _f(value)
    else:
        warn_message("%s is not a valid PARTICLE setting.", key)


def parse_lum(text: str, base_dir: str = ".") -> LumFileContent:
    lines = text.splitlines()
    if not lines or lines[0].strip() != "Luminary":
        raise FileIOError("not a Luminary .lum file (missing 'Luminary' header)")
    version = None
    for line in lines[1:3]:
        tok = line.split()
        if len(tok) >= 2 and tok[0] in ("VERSION", "V"):
            version = int(tok[1])
            break
    if version is None:
        raise FileIOError(".lum file missing VERSION line")
    if version == 5:
        from .lum_v5 import parse_lum_v5

        return parse_lum_v5(text, base_dir)
    if version != CURRENT_LUM_VERSION:
        warn_message(".lum version %d, expected %d — parsing best-effort", version, CURRENT_LUM_VERSION)

    content = LumFileContent()
    for line in lines[1:]:
        if not line or line[0] in "#\r\n" or line.startswith("VERSION"):
            continue
        # Category dispatch by leading chars (lum_v4.c:704-736).
        if line.startswith("GENERAL "):
            body, fn = line[8:], _parse_general
        elif line.startswith("MATERIAL "):
            body, fn = line[9:], _parse_material
        elif line.startswith("CAMERA "):
            body, fn = line[7:], _parse_camera
        elif line.startswith("SKY "):
            body, fn = line[4:], _parse_sky
        elif line.startswith("CLOUD "):
            body, fn = line[6:], _parse_cloud
        elif line.startswith("FOG "):
            body, fn = line[4:], _parse_fog
        elif line.startswith("OCEAN "):
            body, fn = line[6:], _parse_ocean
        elif line.startswith("PARTICLE "):
            body, fn = line[9:], _parse_particle
        elif line.startswith("TOY "):
            continue  # legacy entity, ignored like the reference
        elif line.strip() == "":
            continue
        else:
            warn_message("invalid .lum line: %s", line[:40])
            continue
        if len(body) < 8:
            continue
        key, value = body[:8], body[9:]
        fn(content, key, value)

    content.obj_file_paths = [
        p if os.path.isabs(p) else os.path.join(base_dir, p) for p in content.obj_file_paths
    ]
    return content


def read_lum_file(path: str) -> LumFileContent:
    try:
        with open(path, "r", errors="replace") as f:
            text = f.read()
    except OSError as e:
        raise FileIOError(f"cannot read .lum file {path}: {e}")
    return parse_lum(text, base_dir=os.path.dirname(os.path.abspath(path)))


def write_lum_file(path: str, content: LumFileContent) -> None:
    """Export scene state as .lum v4 (the reference's export is currently
    disabled; we restore the capability)."""
    s, cam, sky, cl, fog, oc, p = (
        content.settings,
        content.camera,
        content.sky,
        content.cloud,
        content.fog,
        content.ocean,
        content.particles,
    )
    out = ["Luminary", f"VERSION {CURRENT_LUM_VERSION}"]

    def emit(cat, key, *vals):
        txt = " ".join(
            f"{v:.6f}" if isinstance(v, float) else str(int(v)) if isinstance(v, (bool, int)) else str(v)
            for v in vals
        )
        out.append(f"{cat} {key} {txt}")

    for path_i in content.obj_file_paths:
        emit("GENERAL", "MESHFILE", os.path.basename(path_i))
    emit("GENERAL", "WIDTH___", s.width)
    emit("GENERAL", "HEIGHT__", s.height)
    emit("GENERAL", "BOUNCES_", s.max_ray_depth)
    emit("GENERAL", "AMBIENTN", s.ambient_nee)
    emit("GENERAL", "SUNRIS__", s.sun_ris)
    emit("GENERAL", "SPECTRAL", s.spectral_rendering)
    emit("GENERAL", "AERIALPE", s.aerial_perspective)
    emit("GENERAL", "BLUENOIS", s.blue_noise)
    emit("CAMERA", "POSITION", *cam.pos)
    emit("CAMERA", "ROTATION", *cam.rotation)
    emit("CAMERA", "FOV_____", cam.thin_lens.fov)
    emit("CAMERA", "APERTURE", cam.thin_lens.aperture_size)
    emit("CAMERA", "EXPOSURE", cam.exposure)
    emit("CAMERA", "TONEMAP_", int(cam.tonemap))
    emit("CAMERA", "FILTER__", int(cam.filter))
    emit("CAMERA", "DITHER__", cam.dithering)
    emit("CAMERA", "BLOOMBLE", cam.bloom_blend)
    emit("CAMERA", "PURKINJE", cam.purkinje)
    emit("CAMERA", "RUSSIANR", cam.russian_roulette_threshold)
    emit("CAMERA", "FILMGRAI", cam.film_grain)
    emit("SKY", "MODE____", int(sky.mode))
    emit("SKY", "OFFSET__", *sky.geometry_offset)
    emit("SKY", "AZIMUTH_", sky.azimuth)
    emit("SKY", "ALTITUDE", sky.altitude)
    emit("SKY", "MOONALTI", sky.moon_altitude)
    emit("SKY", "MOONAZIM", sky.moon_azimuth)
    emit("SKY", "SUNSTREN", sky.sun_strength)
    emit("SKY", "DENSITY_", sky.base_density)
    emit("SKY", "OZONEABS", sky.ozone_absorption)
    emit("SKY", "STARSEED", sky.stars_seed)
    emit("SKY", "STARNUM_", sky.stars_count)
    emit("SKY", "STARINTE", sky.stars_intensity)
    emit("SKY", "COLORCON", *sky.constant_color)
    emit("CLOUD", "ACTIVE__", cl.active)
    emit("CLOUD", "DENSITY_", cl.density)
    emit("CLOUD", "SEED____", cl.seed)
    emit("CLOUD", "STEPS___", cl.steps)
    for name, layer in (("LOW", cl.low), ("MID", cl.mid), ("TOP", cl.top)):
        emit("CLOUD", f"{name}ACTIV", layer.active)
        emit("CLOUD", f"{name}COVER", layer.coverage, layer.coverage_min)
        emit("CLOUD", f"{name}TYPE_", layer.type, layer.type_min)
        emit("CLOUD", f"{name}HEIGH", layer.height_max, layer.height_min)
        emit("CLOUD", f"{name}WIND_", layer.wind_speed, layer.wind_angle)
    emit("FOG", "ACTIVE__", fog.active)
    emit("FOG", "DENSITY_", fog.density)
    emit("FOG", "DIAMETER", fog.droplet_diameter)
    emit("FOG", "DISTANCE", fog.dist)
    emit("FOG", "HEIGHT__", fog.height)
    emit("OCEAN", "ACTIVE__", oc.active)
    emit("OCEAN", "HEIGHT__", oc.height)
    emit("OCEAN", "AMPLITUD", oc.amplitude)
    emit("OCEAN", "FREQUENC", oc.frequency)
    emit("OCEAN", "REFRACT_", oc.refractive_index)
    emit("OCEAN", "WATERTYP", int(oc.water_type))
    emit("OCEAN", "CAUSACTI", oc.caustics_active)
    emit("OCEAN", "CAUSRISS", oc.caustics_ris_sample_count)
    emit("OCEAN", "CAUSSCAL", oc.caustics_domain_scale)
    emit("OCEAN", "TESSELLA", oc.tessellated)
    emit("OCEAN", "MULTISCA", oc.multiscattering)
    emit("OCEAN", "LIGHTSON", oc.triangle_light_contribution)
    emit("PARTICLE", "ACTIVE__", p.active)
    emit("PARTICLE", "COUNT___", p.count)
    emit("PARTICLE", "SCALE___", p.scale)
    emit("PARTICLE", "ALBEDO__", *p.albedo)
    emit("PARTICLE", "SPEED___", p.speed)
    emit("PARTICLE", "DIRECTIO", p.direction_altitude, p.direction_azimuth)
    emit("PARTICLE", "PHASEDIA", p.phase_diameter)
    emit("PARTICLE", "SEED____", p.seed)
    emit("PARTICLE", "SIZE____", p.size)
    emit("PARTICLE", "SIZEVARI", p.size_variation)
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
