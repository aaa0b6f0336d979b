"""The plain reference: the benchmark's frozen copy of the port's plain
PyTorch path (``lumref/``), run on the pixels the check draws.

It builds the scene again from the cell's recipe and seed through its own
copy of the scene classes, packs it with its own copy of the pack (the BVH
by its own build of the native builder, the light tree, the sky tables),
and renders every sample the program accumulated for each checked pixel:
one lane per (sample, pixel), with per-lane sample ids, in blocks of
lanes. Per pixel it sums the samples in the program's order (sample 0
first, in float32) and divides by their count. Nothing of the program is
imported or read.

``precision="bfloat16"`` is the control: the same reference with the
geometry it is handed and the accumulation of the samples rounded to
bfloat16, the precision below the float32 that the renderer states.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_LANES = 1 << 18


def _render_config(scene, lights, config_cls, active_layer_indices,
                   texture_none):
    """The renderer's RenderConfig of a scene (the mapping of the program's
    ``Renderer._pack``, copied)."""
    s = scene.settings
    ss = max(int(s.supersampling), 1)
    mode = int(scene.sky.mode)
    ocean = scene.ocean
    particles = scene.particles
    cloud_layers = active_layer_indices(scene.cloud)
    k_eff = max(min(max(int(s.light_ris_candidates), 1), 8,
                    max(int(lights.num_lights), 1)), 1)
    return config_cls(
        width=s.width * ss,
        height=s.height * ss,
        max_depth=max(int(s.max_ray_depth), 1),
        shading_mode=int(s.shading_mode),
        ris_candidates=k_eff,
        sort_wavefront=bool(getattr(s, "wavefront_sorting", False)),
        use_textures=len(scene.textures) > 0,
        use_aux_textures=any(
            m.roughness_tex != texture_none or m.metallic_tex != texture_none
            or m.normal_tex != texture_none or m.luminance_tex != texture_none
            for m in scene.materials),
        use_bridges=bool(scene.fog.active),
        bridge_vertices=min(max(int(s.bridge_max_num_vertices), 1), 4),
        blue_noise=bool(getattr(s, "blue_noise", True)),
        aerial=bool(getattr(s, "aerial_perspective", True) and mode == 0),
        sun_ris=bool(getattr(s, "sun_ris", True) and mode != 2),
        use_clouds=bool(cloud_layers and mode != 1),
        cloud_steps=min(max(int(scene.cloud.steps) // 2, 8), 64),
        cloud_layers=cloud_layers,
        env_nee=bool(getattr(s, "ambient_nee", True) and mode == 1),
        ocean_caustics=bool(ocean.active
                            and getattr(ocean, "caustics_active", False)
                            and mode != 2),
        caustics_k=min(max(int(getattr(
            ocean, "caustics_ris_sample_count", 32)) // 4, 2), 32),
        ocean_mat_id=len(scene.materials) if ocean.active else -1,
        analytic_ocean=bool(ocean.active
                            and not getattr(ocean, "tessellated", False)),
        water_scatter=bool(ocean.active),
        use_physical_camera=bool(scene.camera.use_physical_camera),
        spectral=bool(getattr(s, "spectral_rendering", False)),
        use_particles=bool(particles.active and int(particles.count) > 0),
        particle_diameter=float(particles.phase_diameter),
        particle_mat_id=(len(scene.materials) + (1 if ocean.active else 0)
                         if particles.active else -1),
    )


def _round_bf16(a: np.ndarray) -> np.ndarray:
    return torch.as_tensor(a).to(torch.bfloat16).to(torch.float32).numpy()


def reference_means(recipe, params: dict, seed: int, px: np.ndarray,
                    py: np.ndarray, samples: int, device,
                    precision: str = "float32", edit=None) -> np.ndarray:
    """Mean radiance f32 [K, 3] of pixels (``px``, ``py``) over sample ids
    0 .. ``samples`` - 1, of the recipe's scene after ``edit(scene)`` (the
    traffic's edits, where it makes any)."""
    from lumref import scene as ref_scene
    from lumref.ops.camera import pack_camera
    from lumref.ops.clouds import active_layer_indices
    from lumref.render.device_scene import pack_scene
    from lumref.render.wavefront import RenderConfig, render_sample
    from lumref.scene.entities import TEXTURE_NONE

    if precision not in ("float32", "bfloat16"):
        raise ValueError("precision is float32 or bfloat16, not %r" % precision)
    low = precision == "bfloat16"
    device = torch.device(device)
    scene = recipe.build(ref_scene, params, seed)
    if edit is not None:
        edit(scene)
    if low:
        for mesh in scene.meshes:
            mesh.vertices = _round_bf16(mesh.vertices)
    with torch.no_grad():
        ds = pack_scene(scene, device)
        cam = pack_camera(scene.camera, device)
        config = _render_config(scene, ds.lights, RenderConfig,
                                active_layer_indices, TEXTURE_NONE)
        k = int(px.shape[0])
        acc_dtype = torch.bfloat16 if low else torch.float32
        acc = torch.zeros((k, 3), dtype=acc_dtype, device=device)
        lane_px = torch.as_tensor(np.tile(px.astype(np.int32), samples),
                                  device=device)
        lane_py = torch.as_tensor(np.tile(py.astype(np.int32), samples),
                                  device=device)
        lane_s = torch.as_tensor(np.repeat(np.arange(samples, dtype=np.int64), k),
                                 device=device)
        n = samples * k
        block = max(BLOCK_LANES // k, 1) * k  # whole samples a block
        for a in range(0, n, block):
            b = min(a + block, n)
            rad, _, _ = render_sample(ds, cam, config, lane_px[a:b],
                                      lane_py[a:b], lane_s[a:b],
                                      with_gbuffer=False)
            # the program's firefly clamp, then the samples in order
            rad = torch.clamp(rad, max=1e6).reshape(-1, k, 3).to(acc_dtype)
            for s in range(rad.shape[0]):
                acc = acc + rad[s]
        mean = acc.to(torch.float32) / float(max(samples, 1))
        return mean.cpu().numpy()
