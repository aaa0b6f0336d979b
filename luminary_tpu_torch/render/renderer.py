"""The renderer: owns device state and the sample loop (port of
``luminary_tpu/render/renderer.py``: ``update``, the sample step,
``render_samples`` with adaptive sampling, the final image with post and
tonemap, the undersampled preview, picking and checkpoint/resume).

``Renderer(scene, device=None)`` renders on the first CUDA card and raises
without one; ``device="cpu"`` runs the plain PyTorch path. The scene's
settings switch every RenderConfig feature as the reference's Renderer does.
``Renderer(scene, mesh=...)`` distributes samples over a device mesh
(``parallel/mesh.py``) with hot device enable and disable.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..device import on_device, resolve_device
from ..ops.camera import pack_camera
from ..ops.clouds import active_layer_indices
from ..ops.post import (
    apply_bloom,
    apply_color_correction,
    apply_film_grain,
    apply_purkinje,
)
from ..ops.tonemap import (
    apply_crt_scanlines,
    apply_filter,
    apply_tonemap,
    dither_and_quantize,
    linear_to_srgb,
)
from ..scene.entities import TEXTURE_NONE
from ..scene.scene import DirtyFlags, Scene
from ..utils.errors import InvalidAPIArgumentError
from ..utils.profiling import StageRanges
from .adaptive import allocate_stage_tasks, block_error_map, scatter_add_stage
from .device_scene import pack_scene
from .wavefront import GBufferMeta, RenderConfig, render_sample


class AccumState(NamedTuple):
    """Per-pixel accumulators."""

    radiance: torch.Tensor  # f32 [N, 3] running sum
    lum_sq: torch.Tensor  # f32 [N] luminance second-moment sum
    sample_count: torch.Tensor  # i32 [N] (adaptive sampling varies it)


def _clamped_lum(radiance):
    # firefly suppression: a fixed generous clamp per sample
    radiance = torch.clamp(radiance, max=1e6)
    lum = (0.2126 * radiance[..., 0] + 0.7152 * radiance[..., 1]
           + 0.0722 * radiance[..., 2])
    return radiance, lum


def _sample_step(scene, cam, config, pixel_x, pixel_y, sample_id,
                 accum: AccumState, with_gbuffer: bool = True):
    radiance, gbuffer, rays = render_sample(scene, cam, config, pixel_x,
                                            pixel_y, sample_id, with_gbuffer)
    with StageRanges() as stage:
        stage("accumulation")
        radiance, lum = _clamped_lum(radiance)
        return AccumState(
            radiance=accum.radiance + radiance,
            lum_sq=accum.lum_sq + lum * lum,
            sample_count=accum.sample_count + 1,
        ), gbuffer, rays


def _subset_step(scene, cam, config, pixel_x, pixel_y, sample_ids,
                 rounds: int):
    """Adaptive-stage pass: ``rounds`` extra samples for a pixel subset, with
    per-lane sample ids (each pixel continues its own sequence) → (radiance
    sum [S, 3], luminance-square sum [S], rays traced 0-d)."""
    s = pixel_x.shape[0]
    rad = torch.zeros((s, 3), dtype=torch.float32, device=pixel_x.device)
    lsq = torch.zeros(s, dtype=torch.float32, device=pixel_x.device)
    rays = torch.zeros((), dtype=torch.float32, device=pixel_x.device)
    for r in range(rounds):
        radiance, _, n = render_sample(scene, cam, config, pixel_x, pixel_y,
                                       sample_ids + r, with_gbuffer=False)
        with StageRanges() as stage:
            stage("accumulation")
            radiance, lum = _clamped_lum(radiance)
            rad = rad + radiance
            lsq = lsq + lum * lum
            rays = rays + n
    return rad, lsq, rays


def _generate_image(accum: AccumState, width: int, height: int,
                    supersampling: int, exposure, tonemap: int,
                    filter_id: int, dithering: bool, agx_custom, bloom: bool,
                    bloom_blend, purkinje: bool, purkinje_kappa,
                    color_correction: bool, correction_rgb, film_grain: bool,
                    film_grain_strength) -> torch.Tensor:
    """The final 8-bit image on the accumulators' device: HDR post (bloom,
    purkinje) → tonemap → LDR post (colour correction, filter, sRGB, grain,
    CRT, dither). Returns uint8 [H, W, 3]."""
    dev = accum.radiance.device

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    n_pixels = width * height
    mean = accum.radiance[:n_pixels] / torch.clamp(
        accum.sample_count[:n_pixels].to(torch.float32), min=1.0)[:, None]
    img = (mean * f32(exposure)).reshape(height, width, 3)
    if supersampling > 1:
        oh, ow = height // supersampling, width // supersampling
        img = img[: oh * supersampling, : ow * supersampling].reshape(
            oh, supersampling, ow, supersampling, 3).mean(dim=(1, 3))
        height, width = oh, ow
        n_pixels = oh * ow
    if bloom:
        img = apply_bloom(img, f32(bloom_blend))
    if purkinje:
        kappa = f32(purkinje_kappa)
        img = apply_purkinje(img, kappa[0], kappa[1])
    rgb = apply_tonemap(img.reshape(-1, 3), tonemap, f32(agx_custom))
    if color_correction:
        rgb = torch.clamp(apply_color_correction(rgb, f32(correction_rgb)),
                          0.0, 1.0)
    rgb = apply_filter(rgb, filter_id)
    rgb = linear_to_srgb(rgb)
    img = rgb.reshape(height, width, 3)
    if film_grain:
        img = torch.clamp(apply_film_grain(img, f32(film_grain_strength), 0),
                          0.0, 1.0)
    if filter_id == 5:
        img = apply_crt_scanlines(img)
    pixel_id = torch.arange(n_pixels, dtype=torch.int64,
                            device=dev).reshape(height, width)
    seed = torch.max(accum.sample_count)
    return dither_and_quantize(img, pixel_id, seed, dithering)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class Renderer:
    """Renderer over one device or a device mesh.

    mesh: optional ``parallel.mesh.DeviceMesh`` with a "samples" axis (and
    optionally "pixels"): samples are distributed across its shards and the
    moment accumulators added on the main device, the reference's multi-GPU
    result interface (device_result_interface.c, device.c:1587-1624). Each
    render_samples budget is rounded up to a multiple of the samples axis.
    The main device is the mesh's first enabled entry; the accumulators,
    the pixel lanes, checkpoints and the preview live there. ``device``,
    where given with a mesh, must be that entry.
    """

    def __init__(self, scene: Scene, chunk: int = 1 << 20, device=None,
                 mesh=None):
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.shards[0]:
                raise ValueError("device %s is not the mesh's main device %s"
                                 % (device, mesh.shards[0]))
            device = mesh.shards[0]
        self.device = resolve_device(device)
        self.scene = scene
        self.chunk = chunk
        self.mesh = mesh
        # device elasticity (reference: device_manager.c:529-572 hot enable
        # and disable, device.h:83 DEVICE_STATE_UNAVAILABLE): the mesh's
        # entries stay as given; the live mesh is re-formed over the enabled
        # ones, and the first enabled entry is the main (re-election by order)
        self._mesh_devices = list(mesh.shards) if mesh is not None else None
        self._device_state = (["enabled"] * len(self._mesh_devices)
                              if mesh is not None else None)
        self._dist_step = None
        self._dist_config = None
        self.device_scene = None
        self.device_camera = None
        self.config: RenderConfig | None = None
        self.accum: AccumState | None = None
        self.gbuffer: GBufferMeta | None = None
        self._px = None
        self._py = None
        self._region = None
        self._ss = 1
        # the trace chunk update() computes: the wavefront is traced in one
        # launch, but adaptive stages size their subsets by it
        self._chunk = 0
        self._preview = None
        self._last_sample_time = 0.0
        self._last_rays_per_sample = 0.0
        self._last_rays_traced = 0.0
        self.update()

    def update(self) -> DirtyFlags:
        flags = self.scene.consume_dirty()
        if flags == DirtyFlags.NONE:
            return flags
        with on_device(self.device):
            self._pack()
        return flags

    def _pack(self):
        """Pack the scene, the camera and the config on the main device
        and restart the render."""
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
        ocean = self.scene.ocean
        particles = self.scene.particles
        cloud_layers = active_layer_indices(self.scene.cloud)

        self.device_scene = pack_scene(self.scene, self.device)
        lights = self.device_scene.lights
        k_eff = max(min(max(int(s.light_ris_candidates), 1), 8,
                        max(int(lights.num_lights), 1)), 1)
        self.config = RenderConfig(
            width=rw_full,
            height=rh_full,
            max_depth=max(int(s.max_ray_depth), 1),
            shading_mode=int(s.shading_mode),
            ris_candidates=k_eff,
            # the opt-in wavefront sort (off by default: it was net-negative
            # on the TPU)
            sort_wavefront=bool(getattr(s, "wavefront_sorting", False)),
            use_textures=len(self.scene.textures) > 0,
            use_aux_textures=any(
                m.roughness_tex != TEXTURE_NONE or m.metallic_tex != TEXTURE_NONE
                or m.normal_tex != TEXTURE_NONE or m.luminance_tex != TEXTURE_NONE
                for m in self.scene.materials),
            use_bridges=bool(self.scene.fog.active),
            bridge_vertices=min(max(int(s.bridge_max_num_vertices), 1), 4),
            blue_noise=bool(getattr(s, "blue_noise", True)),
            aerial=bool(getattr(s, "aerial_perspective", True) and mode == 0),
            sun_ris=bool(getattr(s, "sun_ris", True) and mode != 2),
            # an HDRI map holds the clouds: no march per sample there
            use_clouds=bool(cloud_layers and mode != 1),
            cloud_steps=min(max(int(self.scene.cloud.steps) // 2, 8), 64),
            cloud_layers=cloud_layers,
            # env NEE for HDRI skies only (the DEFAULT atmosphere is smooth
            # without its disc; a constant sky is uniform)
            env_nee=bool(getattr(s, "ambient_nee", True) and mode == 1),
            # caustics: a quarter of the entity's RIS count (each candidate
            # pays five FBM evaluations)
            ocean_caustics=bool(ocean.active
                                and getattr(ocean, "caustics_active", False)
                                and mode != 2),
            caustics_k=min(max(int(getattr(
                ocean, "caustics_ris_sample_count", 32)) // 4, 2), 32),
            ocean_mat_id=len(self.scene.materials) if ocean.active else -1,
            analytic_ocean=bool(ocean.active
                                and not getattr(ocean, "tessellated", False)),
            water_scatter=bool(ocean.active),
            use_physical_camera=bool(self.scene.camera.use_physical_camera),
            spectral=bool(getattr(s, "spectral_rendering", False)),
            use_particles=bool(particles.active and int(particles.count) > 0),
            particle_diameter=float(particles.phase_diameter),
            # the particle material follows the water's
            particle_mat_id=(len(self.scene.materials)
                             + (1 if ocean.active else 0)
                             if particles.active else -1),
        )
        self.device_camera = pack_camera(self.scene.camera, self.device)
        self._ss = ss
        self._chunk = chunk
        if (new_region != self._region or self._px is None
                or self._px.device != self.device):
            self._region = new_region
            n_pad = chunk * n_chunks
            idx = np.minimum(np.arange(n_pad, dtype=np.int64), n_pixels - 1)
            self._px = torch.as_tensor((rx + idx % rw).astype(np.int32),
                                       device=self.device)
            self._py = torch.as_tensor((ry + idx // rw).astype(np.int32),
                                       device=self.device)
        self.start_new_render()

    def start_new_render(self):
        n_pad = int(self._px.shape[0])
        self.accum = AccumState(
            radiance=torch.zeros((n_pad, 3), dtype=torch.float32, device=self.device),
            lum_sq=torch.zeros(n_pad, dtype=torch.float32, device=self.device),
            sample_count=torch.zeros(n_pad, dtype=torch.int32, device=self.device),
        )

    # -- checkpoint / resume -------------------------------------------------
    # The moment accumulators and per-pixel sample counts go to one npz with
    # the reference's keys and dtypes, so either package resumes the other's
    # checkpoint. Sample ids derive from sample_count, so restoring the
    # accumulators restores the QMC stream position: a resumed render is
    # bit-identical to an unbroken one. As in the reference, the
    # fingerprint covers resolution, region, depth and lane count, not the
    # scene's content.

    def _checkpoint_fingerprint(self) -> np.ndarray:
        c = self.config
        rx, ry, rw, rh = self._region
        return np.asarray(
            [c.width, c.height, c.max_depth, self._ss, rx, ry, rw, rh,
             int(self._px.shape[0])], np.int64)

    def save_checkpoint(self, path: str):
        """Serialize render progress (accumulators + config fingerprint)."""
        np.savez_compressed(
            path,
            radiance=self.accum.radiance.cpu().numpy(),
            lum_sq=self.accum.lum_sq.cpu().numpy(),
            sample_count=self.accum.sample_count.cpu().numpy(),
            fingerprint=self._checkpoint_fingerprint(),
        )

    def load_checkpoint(self, path: str):
        """Resume from save_checkpoint output. Raises ValueError when the
        checkpoint's resolution/region/depth fingerprint does not match the
        current configuration."""
        with np.load(path) as z:
            fp = z["fingerprint"]
            want = self._checkpoint_fingerprint()
            if fp.shape != want.shape or not (fp == want).all():
                raise ValueError(
                    "checkpoint fingerprint mismatch: saved "
                    f"{fp.tolist()} vs current {want.tolist()}")
            self.accum = AccumState(*(
                torch.as_tensor(z[k], device=self.device)
                for k in ("radiance", "lum_sq", "sample_count")))

    # -- device elasticity (reference: device_manager.c:529-572 hot device
    # enable/disable with main re-election; failure detection, the analog
    # of DEVICE_STATE_UNAVAILABLE, device.h:83) ------------------------------

    def set_device_enable(self, device_id: int, enable: bool):
        """Hot-enable/disable a mesh device (reference:
        luminary_host_set_device_enable, host.h:36). Re-forms the mesh over
        the enabled entries (the first enabled one is the main:
        re-election) and restarts accumulation, as the reference's
        INTEGRATION dirty and render restart."""
        if self._mesh_devices is None:
            raise InvalidAPIArgumentError(
                "set_device_enable requires a mesh renderer")
        if not 0 <= device_id < len(self._mesh_devices):
            raise InvalidAPIArgumentError(
                f"device id {device_id} out of range")
        state = self._device_state[device_id]
        if state == "unavailable" and enable:
            raise InvalidAPIArgumentError(
                "Tried to enable an unavailable device.")
        new_state = "enabled" if enable else "disabled"
        if state == new_state:
            return
        self._device_state[device_id] = new_state
        self._reform_mesh()

    def device_states(self) -> list:
        return list(self._device_state or [])

    def _reform_mesh(self):
        """Rebuild the live mesh over the enabled entries and restart the
        render; a new main device gets the scene packed anew (the old one
        may not answer any more)."""
        from ..parallel.mesh import make_sample_mesh

        enabled = [d for d, s in zip(self._mesh_devices, self._device_state)
                   if s == "enabled"]
        if not enabled:
            raise RuntimeError("no devices left enabled")
        self.mesh = make_sample_mesh(enabled)
        self._dist_step = None  # the step is built per mesh
        self._dist_config = None
        if enabled[0] != self.device:
            self.device = enabled[0]
            self.gbuffer = None
            if self._px is not None:
                with on_device(self.device):
                    self._pack()
        elif self._px is not None:
            self.start_new_render()

    def _probe_mesh_devices(self) -> list:
        """The ids of the enabled mesh entries whose device still answers (a
        tiny computation per distinct device)."""
        answers = {}
        alive = []
        for i, (d, s) in enumerate(zip(self._mesh_devices,
                                       self._device_state)):
            if s != "enabled":
                continue
            if d not in answers:
                try:
                    x = torch.ones(8, dtype=torch.float32, device=d)
                    answers[d] = bool(float((x + 1.0).sum()) == 16.0)
                except Exception:
                    answers[d] = False
            if answers[d]:
                alive.append(i)
        return alive

    def _recover_dead_devices(self) -> bool:
        """Mark the enabled entries the probe does not see unavailable and
        re-form the mesh. Returns True if any was dropped (the render
        restarts on the new mesh)."""
        alive = set(self._probe_mesh_devices())
        dropped = False
        for i, s in enumerate(self._device_state):
            if s == "enabled" and i not in alive:
                self._device_state[i] = "unavailable"
                dropped = True
        if dropped:
            self._reform_mesh()
        return dropped

    # -- undersampled preview ------------------------------------------------

    def render_preview(self, level: int):
        """Trace one sample on a 2^level-strided pixel grid and keep it as
        the preview; get_image upscales it while sample_count == 0."""
        self.update()
        level = max(int(level), 1)
        rx, ry, rw, rh = self._region
        step = 1 << level
        pw, ph = max(rw // step, 1), max(rh // step, 1)
        ux = (np.arange(pw * ph, dtype=np.int64) % pw) * step + step // 2
        uy = (np.arange(pw * ph, dtype=np.int64) // pw) * step + step // 2
        px = torch.as_tensor((rx + np.minimum(ux, rw - 1)).astype(np.int32),
                             device=self.device)
        py = torch.as_tensor((ry + np.minimum(uy, rh - 1)).astype(np.int32),
                             device=self.device)
        with on_device(self.device):
            radiance, _, _ = render_sample(self.device_scene,
                                           self.device_camera, self.config,
                                           px, py, 0, with_gbuffer=False)
        self._preview = (level, pw, ph, radiance.cpu().numpy())

    def _preview_image_accum(self) -> AccumState:
        """The upscaled preview radiance as a 1-sample AccumState."""
        level, pw, ph, rad = self._preview
        _, _, rw, rh = self._region
        img = rad.reshape(ph, pw, 3)
        img = np.repeat(np.repeat(img, 1 << level, axis=0), 1 << level, axis=1)
        img = img[:rh, :rw]
        if img.shape[0] < rh or img.shape[1] < rw:
            img = np.pad(img, ((0, rh - img.shape[0]), (0, rw - img.shape[1]),
                               (0, 0)), mode="edge")
        n_pad = int(self._px.shape[0])
        flat = np.zeros((n_pad, 3), np.float32)
        flat[: rw * rh] = img.reshape(-1, 3)
        return AccumState(
            radiance=torch.as_tensor(flat, device=self.device),
            lum_sq=torch.zeros(n_pad, dtype=torch.float32, device=self.device),
            sample_count=torch.ones(n_pad, dtype=torch.int32, device=self.device),
        )

    # -- sample loop ---------------------------------------------------------

    @property
    def sample_count(self) -> int:
        """Effective (minimum completed) samples per pixel."""
        if self._region is None or self.accum is None:
            return 0
        _, _, rw, rh = self._region
        return int(self.accum.sample_count[: rw * rh].min())

    def render_samples(self, num_samples: int):
        """Advance accumulation by a budget of num_samples full-frame samples
        (blocking: ends with a device synchronise). With adaptive sampling
        enabled, part of the budget goes to high-variance 4x4 blocks; a
        mesh renderer distributes the budget over its shards instead."""
        self.update()
        t0 = time.monotonic()
        rays = self._render(num_samples)
        self._last_rays_traced = float(rays) if rays is not None else 0.0
        self._last_sample_time = (time.monotonic() - t0) / max(num_samples, 1)

    def _render(self, num_samples: int):
        """The budget on the mesh, adaptively or sample by sample, ended by
        a synchronise of every device it ran on. Returns the rays traced
        (0-d tensor) or None."""
        if self.mesh is not None and self.mesh.size > 1:
            return self._render_mesh(num_samples)
        with on_device(self.device):
            if self.scene.settings.enable_adaptive_sampling:
                rays = self._render_adaptive(num_samples)
            else:
                start = self.sample_count
                last = start + num_samples - 1
                rays = None
                # picking reads the last sample's gbuffer: only it is built
                for i in range(start, last + 1):
                    self.accum, gbuffer, r = _sample_step(
                        self.device_scene, self.device_camera, self.config,
                        self._px, self._py, i, self.accum,
                        with_gbuffer=i == last)
                    if gbuffer is not None:
                        self.gbuffer = gbuffer
                    rays = r if rays is None else rays + r
                if rays is not None:
                    self._last_rays_per_sample = float(r)
        self._synchronize()
        return rays

    def _synchronize(self):
        devices = self.mesh.distinct() if self.mesh is not None else [self.device]
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _render_mesh(self, num_samples: int):
        """Distribute whole samples over the mesh's "samples" axis and add
        the moments on the main device (the reference's result interface).
        Returns the rays traced."""
        from ..parallel.mesh import distributed_sample_step, shard_pixels

        if self._dist_step is None or self._dist_config != self.config:
            self._dist_step, self._n_axis = distributed_sample_step(
                self.mesh, self.config)
            self._dist_config = self.config
        n_axis = self._n_axis
        px, py, rad, lsq = shard_pixels(self.mesh, self._px, self._py,
                                        self.accum.radiance, self.accum.lum_sq)
        count = self.accum.sample_count
        base = self.sample_count
        steps = max((num_samples + n_axis - 1) // n_axis, 1)
        rays = None
        try:
            for k in range(steps):
                rad, lsq, gbuf, r = self._dist_step(
                    self.device_scene, self.device_camera, px, py, rad, lsq,
                    base + k * n_axis)
                count = count + n_axis
                rays = r if rays is None else rays + r
            self._synchronize()
        except Exception:
            # failure detection and elastic recovery (reference: device
            # errors → DEVICE_STATE_UNAVAILABLE and a render restart): probe
            # the mesh, drop the devices that do not answer, restart the
            # budget on the re-formed mesh. A failure while every device
            # answers is a real error and propagates.
            if not self._recover_dead_devices():
                raise
            return self._render(num_samples)
        self.accum = AccumState(radiance=rad, lum_sq=lsq, sample_count=count)
        # picking and ray accounting as on the single-device path
        self.gbuffer = gbuf
        self._last_rays_per_sample = float(r) / n_axis
        return rays

    def _render_adaptive(self, num_samples: int):
        """Stage 0 renders uniform samples until every pixel has a baseline;
        then each stage allocates the remaining lane budget to blocks by
        their error and renders it in fixed-size subset wavefronts. Returns
        the rays traced (0-d tensor) or None."""
        s = self.scene.settings
        _, _, rw, rh = self._region
        n_pixels = rw * rh
        lane_budget = num_samples * n_pixels
        interval = max(int(s.adaptive_sampling_update_interval) // 8, 2)
        rays = None

        base = max(int(s.adaptive_sampling_avg_sampling_rate), 2)
        while self.sample_count < base and lane_budget > 0:
            self.accum, self.gbuffer, r = _sample_step(
                self.device_scene, self.device_camera, self.config,
                self._px, self._py, self.sample_count, self.accum)
            self._last_rays_per_sample = float(r)
            rays = r if rays is None else rays + r
            lane_budget -= n_pixels

        n_pad = int(self._px.shape[0])
        chunk = self._chunk or 65536
        # a subset strictly smaller than the frame, so allocation selects
        subset = min(n_pad, chunk) if n_pad > chunk else max(n_pad // 4, 16)
        avg_rate = max(int(s.adaptive_sampling_avg_sampling_rate), 1)
        max_rate = max(int(s.adaptive_sampling_max_sampling_rate), avg_rate)
        rx0, ry0 = self._region[0], self._region[1]
        dev = self.device
        while lane_budget > 0:
            err = block_error_map(
                self.accum.radiance, self.accum.lum_sq,
                self.accum.sample_count, rw, rh,
                bool(s.adaptive_sampling_exposure_aware),
                float(np.float32(self.scene.camera.exposure))).cpu().numpy()
            rounds = min(interval, max(lane_budget // subset, 1))
            pix_all, rank_all = allocate_stage_tasks(
                err, rw, rh, avg_rate, max_rate,
                budget_tasks=max(lane_budget // rounds, subset))
            if pix_all is None:
                break
            counts0 = self.accum.sample_count.cpu().numpy()
            total = pix_all.size
            n_slices = max((total + subset - 1) // subset, 1)
            # pad the task list to whole fixed-size wavefronts by wrapping;
            # wrapped entries continue their pixel's rank sequence, so no
            # sample id repeats within the stage
            pad_n = n_slices * subset - total
            if pad_n:
                max_rank = int(rank_all.max()) + 1
                wraps = (pad_n + total - 1) // total
                pads_p = [pix_all] * wraps
                pads_r = [rank_all + j * max_rank for j in range(1, wraps + 1)]
                pix_all = np.concatenate([pix_all] + pads_p)[: n_slices * subset]
                rank_all = np.concatenate([rank_all] + pads_r)[: n_slices * subset]
            for sl in range(n_slices):
                if lane_budget <= 0:
                    break
                pix_s = pix_all[sl * subset:(sl + 1) * subset]
                rank_s = rank_all[sl * subset:(sl + 1) * subset]
                ids = (counts0[pix_s].astype(np.uint32)
                       + rank_s.astype(np.uint32) * np.uint32(rounds))
                sample_ids = torch.as_tensor(ids.astype(np.int64), device=dev)
                px = torch.as_tensor((rx0 + pix_s % rw).astype(np.int32),
                                     device=dev)
                py = torch.as_tensor((ry0 + pix_s // rw).astype(np.int32),
                                     device=dev)
                rad, lsq, r = _subset_step(
                    self.device_scene, self.device_camera, self.config,
                    px, py, sample_ids, rounds)
                rays = r if rays is None else rays + r
                self.accum = AccumState(*scatter_add_stage(
                    self.accum.radiance, self.accum.lum_sq,
                    self.accum.sample_count,
                    torch.as_tensor(pix_s.astype(np.int64), device=dev),
                    rad, lsq,
                    torch.full((subset,), rounds, dtype=torch.int32,
                               device=dev)))
                lane_budget -= subset * rounds
        return rays

    @property
    def current_sample_time(self) -> float:
        return self._last_sample_time

    # -- output --------------------------------------------------------------

    def get_image(self) -> np.ndarray:
        """uint8 [H, W, 3] final image, or an adaptive-sampling inspection
        view when settings.adaptive_sampling_output_mode is not BEAUTY."""
        mode = int(self.scene.settings.adaptive_sampling_output_mode)
        if mode != 0:
            return self._debug_output_image(mode)
        accum = self.accum
        if self.sample_count == 0 and self._preview is not None:
            accum = self._preview_image_accum()
        return _generate_image(accum, *self.image_args()).cpu().numpy()

    def image_args(self) -> tuple:
        """The arguments of ``_generate_image`` after the accumulators, from
        the region, the supersampling and the camera's post settings."""
        cam = self.scene.camera
        _, _, rw, rh = self._region
        return (
            rw, rh, self._ss,
            cam.exposure,
            int(cam.tonemap),
            int(cam.filter),
            bool(cam.dithering),
            [cam.agx_custom_slope, cam.agx_custom_power,
             cam.agx_custom_saturation],
            bool(cam.bloom_blend > 0.0),
            cam.bloom_blend,
            bool(cam.purkinje),
            [cam.purkinje_kappa1, cam.purkinje_kappa2],
            bool(cam.use_color_correction),
            list(cam.color_correction),
            bool(cam.film_grain > 0.0),
            cam.film_grain,
        )

    def _debug_output_image(self, mode: int) -> np.ndarray:
        """VARIANCE / ERROR / SAMPLE_DISTRIBUTION inspection images (uint8
        heatmaps), computed on the host in float64."""
        _, _, rw, rh = self._region
        n = rw * rh
        count = self.accum.sample_count[:n].cpu().numpy().astype(np.float64)
        cnt = np.maximum(count, 1.0)
        if mode == 3:  # SAMPLE_DISTRIBUTION
            field = count
        else:
            rad = self.accum.radiance[:n].cpu().numpy().astype(np.float64)
            lum = (0.2126 * rad[:, 0] + 0.7152 * rad[:, 1]
                   + 0.0722 * rad[:, 2]) / cnt
            e2 = self.accum.lum_sq[:n].cpu().numpy().astype(np.float64) / cnt
            var = np.maximum(e2 - lum * lum, 0.0)
            if mode == 1:  # VARIANCE
                field = var
            else:  # ERROR: relative standard error of the mean
                field = np.sqrt(var / cnt) / (lum + 0.1)
        field = field.reshape(rh, rw)
        hi = np.percentile(field, 99.0) or 1.0
        t = np.clip(field / max(hi, 1e-12), 0.0, 1.0)
        # blue → red heatmap, a green bump at mid-range for contrast
        img = np.stack([t, 2.0 * t * (1.0 - t), 1.0 - t], -1)
        out = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        if self._ss > 1:
            out = out[:: self._ss, :: self._ss]
        return out

    def get_radiance(self) -> np.ndarray:
        """float32 [H, W, 3] linear mean radiance (host copy)."""
        _, _, rw, rh = self._region
        n = rw * rh
        mean = self.accum.radiance[:n] / torch.clamp(
            self.accum.sample_count[:n].to(torch.float32), min=1.0)[:, None]
        return mean.cpu().numpy().reshape(rh, rw, 3)

    def get_pixel_info(self, x: int, y: int):
        """Picking on the last sample's primary hits: a dict, or None before
        the first sample or outside the rendered region."""
        if self.gbuffer is None:
            return None
        rx, ry, rw, rh = self._region
        idx = (y * self._ss - ry) * rw + (x * self._ss - rx)
        if not 0 <= idx < rw * rh:
            return None
        g = self.gbuffer
        inst = int(g.instance_id[idx])
        return {
            "pixel_query_is_valid": inst >= 0,
            "instance_id": inst,
            "material_id": int(g.material_id[idx]),
            "depth": float(g.depth[idx]),
            "rel_hit_pos": tuple(g.rel_hit_pos[idx].cpu().numpy()),
        }
