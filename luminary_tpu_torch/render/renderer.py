"""The renderer: owns device state and the sample loop (port of
``luminary_tpu/render/renderer.py``: ``__init__``, ``update``, the sample
step and ``render_samples``).

``Renderer(scene, device=None)`` renders on the first CUDA card and raises
without one; ``device="cpu"`` runs the plain PyTorch path. Every RenderConfig
feature of the reference that this slice has not ported is refused with
NotImplementedError when the scene asks for it.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.camera import pack_camera
from ..scene.entities import TEXTURE_NONE
from ..scene.scene import DirtyFlags, Scene
from .device_scene import pack_scene
from .wavefront import RenderConfig, render_sample


class AccumState(NamedTuple):
    """Per-pixel accumulators."""

    radiance: torch.Tensor  # f32 [N, 3] running sum
    lum_sq: torch.Tensor  # f32 [N] luminance second-moment sum
    sample_count: torch.Tensor  # i32 [N]


def _sample_step(scene, cam, config, pixel_x, pixel_y, sample_id,
                 accum: AccumState):
    radiance, rays = render_sample(scene, cam, config, pixel_x, pixel_y,
                                   sample_id)
    # firefly suppression: a fixed generous clamp per sample
    radiance = torch.clamp(radiance, max=1e6)
    lum = (0.2126 * radiance[..., 0] + 0.7152 * radiance[..., 1]
           + 0.0722 * radiance[..., 2])
    return AccumState(
        radiance=accum.radiance + radiance,
        lum_sq=accum.lum_sq + lum * lum,
        sample_count=accum.sample_count + 1,
    ), rays


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def unported_features(scene: Scene) -> list[str]:
    """The reference's RenderConfig switches this scene would turn on that
    the port lacks (names as in the reference)."""
    s = scene.settings
    mode = int(scene.sky.mode)
    cloud_layers = (tuple(i for i, l in enumerate(
        (scene.cloud.low, scene.cloud.mid, scene.cloud.top)) if l.active)
        if scene.cloud.active else ())
    ocean = scene.ocean
    flags = {
        "use_textures": len(scene.textures) > 0,
        "use_aux_textures": any(
            m.roughness_tex != TEXTURE_NONE or m.metallic_tex != TEXTURE_NONE
            or m.normal_tex != TEXTURE_NONE or m.luminance_tex != TEXTURE_NONE
            for m in scene.materials),
        "use_clouds": bool(cloud_layers and mode != 1),
        "use_bridges": bool(scene.fog.active),
        "use_physical_camera": bool(scene.camera.use_physical_camera),
        "env_nee": bool(getattr(s, "ambient_nee", True) and mode == 1),
        "spectral": bool(getattr(s, "spectral_rendering", False)),
        "ocean_caustics": bool(ocean.active
                               and getattr(ocean, "caustics_active", False)
                               and mode != 2),
        "analytic_ocean": bool(ocean.active
                               and not getattr(ocean, "tessellated", False)),
        "water_scatter": bool(ocean.active),
        "use_particles": bool(scene.particles.active
                              and int(scene.particles.count) > 0),
        "sort_wavefront": bool(getattr(s, "wavefront_sorting", False)),
        "shading_mode": int(s.shading_mode) != 0,
    }
    return [k for k, on in flags.items() if on]


class Renderer:
    """Single-card renderer over the port's device scene."""

    def __init__(self, scene: Scene, chunk: int = 1 << 20, device=None):
        self.device = resolve_device(device)
        self.scene = scene
        self.chunk = chunk
        self.device_scene = None
        self.device_camera = None
        self.config: RenderConfig | None = None
        self.accum: AccumState | None = None
        self._px = None
        self._py = None
        self._region = None
        self._last_sample_time = 0.0
        self._last_rays_per_sample = 0.0
        self.update()

    def update(self) -> DirtyFlags:
        flags = self.scene.consume_dirty()
        if flags == DirtyFlags.NONE:
            return flags
        missing = unported_features(self.scene)
        if missing:
            raise NotImplementedError(
                "not ported to the PyTorch renderer yet: " + ", ".join(missing))
        s = self.scene.settings
        ss = max(int(s.supersampling), 1)
        rw_full, rh_full = s.width * ss, s.height * ss
        rx = int(np.clip(s.region_x, 0.0, 1.0) * rw_full)
        ry = int(np.clip(s.region_y, 0.0, 1.0) * rh_full)
        rw = max(int(np.clip(s.region_width, 0.0, 1.0) * rw_full), 1)
        rh = max(int(np.clip(s.region_height, 0.0, 1.0) * rh_full), 1)
        rw = min(rw, rw_full - rx)
        rh = min(rh, rh_full - ry)
        new_region = (rx, ry, rw, rh)
        n_pixels = rw * rh
        # lanes: ceil(N/chunk) equal chunks rounded to 256, as the reference
        n_chunks = max(-(-n_pixels // max(self.chunk, 1)), 1)
        chunk = _round_up(-(-n_pixels // n_chunks), 256)
        mode = int(self.scene.sky.mode)

        self.device_scene = pack_scene(self.scene, self.device)
        lights = self.device_scene.lights
        k_eff = max(min(max(int(s.light_ris_candidates), 1), 8,
                        max(int(lights.num_lights), 1)), 1)
        self.config = RenderConfig(
            width=rw_full,
            height=rh_full,
            max_depth=max(int(s.max_ray_depth), 1),
            ris_candidates=k_eff,
            blue_noise=bool(getattr(s, "blue_noise", True)),
            aerial=bool(getattr(s, "aerial_perspective", True) and mode == 0),
            sun_ris=bool(getattr(s, "sun_ris", True) and mode != 2),
        )
        self.device_camera = pack_camera(self.scene.camera, self.device)
        if new_region != self._region or self._px is None:
            self._region = new_region
            n_pad = chunk * n_chunks
            idx = np.minimum(np.arange(n_pad, dtype=np.int64), n_pixels - 1)
            self._px = torch.as_tensor((rx + idx % rw).astype(np.int32),
                                       device=self.device)
            self._py = torch.as_tensor((ry + idx // rw).astype(np.int32),
                                       device=self.device)
        self.start_new_render()
        return flags

    def start_new_render(self):
        n_pad = int(self._px.shape[0])
        self.accum = AccumState(
            radiance=torch.zeros((n_pad, 3), dtype=torch.float32, device=self.device),
            lum_sq=torch.zeros(n_pad, dtype=torch.float32, device=self.device),
            sample_count=torch.zeros(n_pad, dtype=torch.int32, device=self.device),
        )

    @property
    def sample_count(self) -> int:
        if self._region is None or self.accum is None:
            return 0
        _, _, rw, rh = self._region
        return int(self.accum.sample_count[: rw * rh].min())

    def render_samples(self, num_samples: int):
        """Advance accumulation by num_samples full-frame samples
        (blocking: ends with a device synchronise)."""
        self.update()
        t0 = time.monotonic()
        start = self.sample_count
        rays = None
        for i in range(start, start + num_samples):
            self.accum, rays = _sample_step(
                self.device_scene, self.device_camera, self.config,
                self._px, self._py, i, self.accum)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if rays is not None:
            self._last_rays_per_sample = float(rays)
        self._last_sample_time = (time.monotonic() - t0) / max(num_samples, 1)

    @property
    def current_sample_time(self) -> float:
        return self._last_sample_time

    def get_radiance(self) -> np.ndarray:
        """float32 [H, W, 3] linear mean radiance (host copy)."""
        _, _, rw, rh = self._region
        n = rw * rh
        mean = self.accum.radiance[:n] / torch.clamp(
            self.accum.sample_count[:n].to(torch.float32), min=1.0)[:, None]
        return mean.cpu().numpy().reshape(rh, rw, 3)
