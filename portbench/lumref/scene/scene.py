"""Scene container with dirty-flag propagation.

The reference keeps three scene copies (caller/host/device) with per-entity
mutexes and propagates changes with dirty flags (reference:
src/luminary/scene.c, scene.h:42-63 SCENE_DIRTY_FLAG_*). The TPU build keeps
the same *semantics* — entity setters accumulate dirty flags that tell the
renderer what to rebuild (device scene re-pack, LUT rebuilds, integration
restart, buffer reallocation) — with a single lock instead of triple buffering,
since the JAX device upload is itself an immutable snapshot (the packed
DeviceScene pytree plays the role of ``scene_device``).
"""

from __future__ import annotations

import dataclasses
import threading
from enum import IntFlag
from typing import Dict, List

from .entities import (
    Camera,
    Cloud,
    Fog,
    Instance,
    Material,
    Ocean,
    Particles,
    RendererSettings,
    Sky,
    copy_entity,
)
from .mesh import Mesh, Texture
from ..utils.errors import InvalidAPIArgumentError


class DirtyFlags(IntFlag):
    """What must be recomputed after a mutation (reference: scene.h:42-63)."""

    NONE = 0
    OUTPUT = 1 << 0  # re-run post/tonemap only
    INTEGRATION = 1 << 1  # restart accumulation
    BUFFERS = 1 << 2  # resolution change: reallocate wavefront buffers
    HDRI = 1 << 3  # sky HDRI re-bake
    SKY_LUT = 1 << 4  # atmosphere LUT rebuild
    CLOUD_NOISE = 1 << 5
    PARTICLES = 1 << 6
    MATERIALS = 1 << 7
    INSTANCES = 1 << 8
    MESHES = 1 << 9  # BVH rebuild
    LIGHT_TREE = 1 << 10
    TEXTURES = 1 << 11
    ALL = (1 << 12) - 1


# Which flags each entity raises when it changes. Integration restarts for
# anything that changes the light transport; OUTPUT-only fields are handled in
# _camera_output_only below.
_ENTITY_FLAGS: Dict[str, DirtyFlags] = {
    "settings": DirtyFlags.INTEGRATION | DirtyFlags.BUFFERS,
    "camera": DirtyFlags.INTEGRATION,
    "ocean": DirtyFlags.INTEGRATION,
    "sky": DirtyFlags.INTEGRATION | DirtyFlags.SKY_LUT | DirtyFlags.HDRI,
    "cloud": DirtyFlags.INTEGRATION | DirtyFlags.CLOUD_NOISE,
    "fog": DirtyFlags.INTEGRATION,
    "particles": DirtyFlags.INTEGRATION | DirtyFlags.PARTICLES,
}

# Camera fields that only affect post-processing, not the integrator
# (reference: scene.c camera dirty handling — exposure/tonemap/filter changes
# do not restart integration).
_CAMERA_OUTPUT_ONLY = {
    "exposure",
    "tonemap",
    "agx_custom_slope",
    "agx_custom_power",
    "agx_custom_saturation",
    "filter",
    "bloom_blend",
    "dithering",
    "purkinje",
    "purkinje_kappa1",
    "purkinje_kappa2",
    "wasd_speed",
    "mouse_speed",
    "smooth_movement",
    "smoothing_factor",
    "use_color_correction",
    "color_correction",
    "film_grain",
}

# Settings fields that don't require a buffer reallocation.
_SETTINGS_NO_BUFFER = {
    "max_ray_depth",
    "bridge_max_num_vertices",
    "undersampling",
    "enable_adaptive_sampling",
    "adaptive_sampling_max_sampling_rate",
    "adaptive_sampling_avg_sampling_rate",
    "adaptive_sampling_update_interval",
    "adaptive_sampling_exposure_aware",
    "adaptive_sampling_output_mode",
    "shading_mode",
}


def _changed_fields(old, new) -> set:
    out = set()
    for f in dataclasses.fields(old):
        if getattr(old, f.name) != getattr(new, f.name):
            out.add(f.name)
    return out


class Scene:
    """Mutable scene state: 7 singleton entities + materials/instances/meshes."""

    def __init__(self):
        self._lock = threading.RLock()
        self.settings = RendererSettings()
        self.camera = Camera()
        self.ocean = Ocean()
        self.sky = Sky()
        self.cloud = Cloud()
        self.fog = Fog()
        self.particles = Particles()
        self.materials: List[Material] = []
        self.instances: List[Instance] = []
        self.meshes: List[Mesh] = []
        self.textures: List[Texture] = []
        self.sky_hdri = None  # user lat-long [H, W, 3] float (SkyMode.HDRI)
        self._dirty = DirtyFlags.ALL

    def set_sky_hdri(self, image) -> None:
        """Install a user lat-long HDRI (numpy [H, W, >=3], linear radiance);
        None reverts HDRI mode to baking the procedural sky."""
        with self._lock:
            self.sky_hdri = image
            self._dirty |= DirtyFlags.HDRI | DirtyFlags.INTEGRATION | DirtyFlags.OUTPUT

    # -- entity access ------------------------------------------------------

    def get_entity(self, name: str):
        with self._lock:
            return copy_entity(getattr(self, name))

    def set_entity(self, name: str, value) -> DirtyFlags:
        if name not in _ENTITY_FLAGS:
            raise InvalidAPIArgumentError(f"unknown scene entity '{name}'")
        with self._lock:
            old = getattr(self, name)
            changed = _changed_fields(old, value)
            if not changed:
                return DirtyFlags.NONE
            flags = _ENTITY_FLAGS[name]
            if name == "camera" and changed <= _CAMERA_OUTPUT_ONLY:
                flags = DirtyFlags.OUTPUT
            if name == "settings" and changed <= _SETTINGS_NO_BUFFER:
                flags = DirtyFlags.INTEGRATION
            if name == "sky" and changed <= {"hdri_dim", "hdri_samples"}:
                flags = DirtyFlags.HDRI
            setattr(self, name, copy_entity(value))
            self._dirty |= flags | DirtyFlags.OUTPUT
            return flags

    # -- lists ---------------------------------------------------------------

    def add_mesh(self, mesh: Mesh) -> int:
        with self._lock:
            mesh.id = len(self.meshes)
            self.meshes.append(mesh)
            self._dirty |= (
                DirtyFlags.MESHES
                | DirtyFlags.INSTANCES
                | DirtyFlags.LIGHT_TREE
                | DirtyFlags.INTEGRATION
            )
            return mesh.id

    def add_texture(self, tex: Texture) -> int:
        with self._lock:
            self.textures.append(tex)
            self._dirty |= DirtyFlags.TEXTURES | DirtyFlags.INTEGRATION
            return len(self.textures) - 1

    def add_material(self, mat: Material) -> int:
        with self._lock:
            mat.id = len(self.materials)
            self.materials.append(mat)
            self._dirty |= (
                DirtyFlags.MATERIALS | DirtyFlags.LIGHT_TREE | DirtyFlags.INTEGRATION
            )
            return mat.id

    def set_material(self, mat: Material) -> None:
        with self._lock:
            if not 0 <= mat.id < len(self.materials):
                raise InvalidAPIArgumentError(f"material id {mat.id} out of range")
            if _changed_fields(self.materials[mat.id], mat):
                self.materials[mat.id] = copy_entity(mat)
                self._dirty |= (
                    DirtyFlags.MATERIALS | DirtyFlags.LIGHT_TREE | DirtyFlags.INTEGRATION
                )

    def get_material(self, mat_id: int) -> Material:
        with self._lock:
            if not 0 <= mat_id < len(self.materials):
                raise InvalidAPIArgumentError(f"material id {mat_id} out of range")
            return copy_entity(self.materials[mat_id])

    def new_instance(self) -> Instance:
        with self._lock:
            inst = Instance(id=len(self.instances))
            self.instances.append(inst)
            self._dirty |= (
                DirtyFlags.INSTANCES | DirtyFlags.LIGHT_TREE | DirtyFlags.INTEGRATION
            )
            return copy_entity(inst)

    def add_instance(self, inst: Instance) -> int:
        with self._lock:
            inst.id = len(self.instances)
            self.instances.append(copy_entity(inst))
            self._dirty |= (
                DirtyFlags.INSTANCES | DirtyFlags.LIGHT_TREE | DirtyFlags.INTEGRATION
            )
            return inst.id

    def set_instance(self, inst: Instance) -> None:
        with self._lock:
            if not 0 <= inst.id < len(self.instances):
                raise InvalidAPIArgumentError(f"instance id {inst.id} out of range")
            if _changed_fields(self.instances[inst.id], inst):
                self.instances[inst.id] = copy_entity(inst)
                self._dirty |= (
                    DirtyFlags.INSTANCES | DirtyFlags.LIGHT_TREE | DirtyFlags.INTEGRATION
                )

    def get_instance(self, inst_id: int) -> Instance:
        with self._lock:
            if not 0 <= inst_id < len(self.instances):
                raise InvalidAPIArgumentError(f"instance id {inst_id} out of range")
            return copy_entity(self.instances[inst_id])

    # -- dirty management ----------------------------------------------------

    @property
    def dirty(self) -> DirtyFlags:
        with self._lock:
            return self._dirty

    def mark_dirty(self, flags: DirtyFlags) -> None:
        with self._lock:
            self._dirty |= flags

    def consume_dirty(self) -> DirtyFlags:
        """Atomically read-and-clear the dirty flags (renderer update step)."""
        with self._lock:
            d = self._dirty
            self._dirty = DirtyFlags.NONE
            return d

    @property
    def num_meshes(self) -> int:
        return len(self.meshes)

    @property
    def num_materials(self) -> int:
        return len(self.materials)

    @property
    def num_instances(self) -> int:
        return len(self.instances)
