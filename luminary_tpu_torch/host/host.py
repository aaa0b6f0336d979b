"""Public host API.

Python mirror of the reference's ``luminary_host_*`` C API (reference:
include/luminary/host.h:29-129): entity get/set with dirty propagation, scene
file loading, output request/promise handles, pixel queries.

Two execution modes:
  * synchronous (default): work happens on the caller thread — deterministic,
    test-friendly;
  * asynchronous (``Host(asynchronous=True)``): scene loads run on a host
    worker and rendering runs continuously on a render worker, matching the
    reference's architecture (host/host.c:15-20 — 1 main + N secondary host
    workers + 1 device worker). Worker names/tasks/times are introspectable
    (reference: luminary_host_get_queue_worker_*, host.h:46-70).

The port of ``luminary_tpu/host/host.py``. ``Host(device=None)`` renders on
the first CUDA card and raises without one; ``device="cpu"`` runs the plain
PyTorch path. ``Host(mesh=N)`` renders on the first N cards, or on N CPU
shards with ``device="cpu"``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..io.lum import read_lum_file, write_lum_file, LumFileContent
from ..io.png import write_png
from ..io.wavefront import WavefrontArguments, read_obj_file
from ..parallel.mesh import make_sample_mesh
from ..render.renderer import Renderer
from ..scene.entities import Instance, Material
from ..scene.scene import DirtyFlags, Scene
from ..utils.errors import InvalidAPIArgumentError, PreconditionError
from ..utils.log import info_message

OUTPUT_HANDLE_INVALID = 0xFFFFFFFF


@dataclass
class OutputRequest:
    """reference: LuminaryOutputRequestProperties + promise handle."""

    sample_count: int
    promise: int = 0
    ready: bool = False
    image: np.ndarray | None = None
    time: float = 0.0


@dataclass
class _Output:
    image: np.ndarray
    sample_count: int
    time: float
    ref_count: int = 1


class Host:
    """A Luminary rendering host (one per process is typical)."""

    def __init__(
        self,
        samples_per_step: int = 4,
        asynchronous: bool = False,
        mesh=None,
        device=None,
    ):
        """mesh: multi-device rendering (reference: DeviceManager's
        multi-GPU sample distribution, device_manager.c). Pass a
        ``parallel.mesh.DeviceMesh`` with a "samples" axis, or an int N to
        build one over the first N cards (N CPU shards where ``device`` is
        the CPU); None or 1 renders on one device. device: None means the
        first CUDA card (raising without one), or any torch device."""
        import threading

        self._device = resolve_device(device)
        if isinstance(mesh, int):
            if self._device.type == "cuda":
                n = torch.cuda.device_count()
                if mesh > n:
                    raise ValueError(
                        f"mesh={mesh} devices requested, {n} available")
                devs = [torch.device("cuda", i) for i in range(mesh)]
            else:
                devs = [self._device] * mesh
            mesh = make_sample_mesh(devs) if mesh > 1 else None
        if mesh is not None:
            self._device = mesh.shards[0]
        self._mesh = mesh
        self.scene = Scene()
        self._renderer: Renderer | None = None
        self._renderer_lock = threading.RLock()
        self._samples_per_step = samples_per_step
        self._requests: dict[int, OutputRequest] = {}
        self._fulfilled: dict[int, int] = {}  # promise -> output handle
        self._next_promise = 0
        self._outputs: dict[int, _Output] = {}
        self._next_output = 0
        self._render_time = 0.0
        self._asynchronous = asynchronous
        self._workers = []
        self._render_errors: list[BaseException] = []
        self._shutdown = threading.Event()
        self._work_available = threading.Event()
        if asynchronous:
            from .queue_worker import QueueWorker, WorkQueue

            self._host_queue = WorkQueue("host")
            self._host_worker = QueueWorker("Host Main Worker", self._host_queue)
            self._host_worker.start()
            self._workers.append(self._host_worker)
            self._render_thread = threading.Thread(
                target=self._render_loop, name="Device Worker", daemon=True
            )
            self._render_thread.start()

    # -- lifecycle ----------------------------------------------------------

    @property
    def renderer(self) -> Renderer:
        if self._renderer is None:
            with self._renderer_lock:
                if self._renderer is None:
                    self._renderer = Renderer(self.scene,
                                              device=self._device,
                                              mesh=self._mesh)
        return self._renderer

    def destroy(self):
        self._shutdown.set()
        self._work_available.set()
        for w in self._workers:
            w.shutdown()
        if self._asynchronous:
            # the device worker ends its turn first: a process that exits
            # while that thread is inside a PyTorch op aborts
            self._render_thread.join()
        self._renderer = None

    def check_errors(self):
        """Raise the first error captured on a worker thread or the device
        worker's loop."""
        if self._render_errors:
            errs, self._render_errors = self._render_errors, []
            raise errs[0]
        for w in self._workers:
            errs = w.take_errors()
            if errs:
                raise errs[0]

    # -- async workers -------------------------------------------------------

    @property
    def num_queue_workers(self) -> int:
        """reference: luminary_host_get_num_queue_workers."""
        return len(self._workers) + (1 if self._asynchronous else 0)

    def get_queue_worker_name(self, worker_id: int) -> str | None:
        names = [w.name for w in self._workers]
        if self._asynchronous:
            names.append("Device Worker")
        return names[worker_id] if 0 <= worker_id < len(names) else None

    def get_queue_worker_string(self, worker_id: int) -> str | None:
        """Current task of a worker (None = idle)."""
        if worker_id < len(self._workers):
            return self._workers[worker_id].current_task
        if self._asynchronous and worker_id == len(self._workers):
            return self._render_task
        return None

    def get_queue_worker_time(self, worker_id: int) -> float:
        if worker_id < len(self._workers):
            return self._workers[worker_id].current_task_time
        return 0.0

    _render_task: str | None = None

    def _render_loop(self):
        """The device-worker loop (reference: device_manager's worker thread
        + the render continuation callbacks, device_manager.c:864-877).
        The thread renders on the host's device. An error stops the loop
        until the next poll: try_await_output raises it (check_errors), and
        a later poll wakes the loop to try again."""
        while not self._shutdown.is_set():
            try:
                if self._device.type == "cuda":
                    # the current device is per thread
                    torch.cuda.set_device(self._device)
                self._render_turn()
            except Exception as e:
                self._work_available.clear()
                self._render_errors.append(e)
                self._work_available.wait()

    def _render_turn(self):
        """One turn of the device worker: a preview level or a bounded
        batch of samples toward the largest pending request."""
        import time as _time

        pending = [r for r in self._requests.values() if not r.ready]
        if not pending:
            self._work_available.wait(timeout=0.05)
            self._work_available.clear()
            return
        target = max(r.sample_count for r in pending)
        with self._renderer_lock:
            r = self.renderer
            r.update()
            if r.sample_count < target:
                # Undersampling PYRAMID before the first full sample
                # (reference: device.c:392-418 state machine): stride
                # 2^(us-1) → ... → 2, ONE level per loop turn so scene
                # edits apply between levels (sub-frame latency).
                us = int(self.scene.settings.undersampling)
                prev = getattr(r, "_preview", None)
                if r.sample_count == 0 and us > 0 and (
                    prev is None or prev[0] > 1
                ):
                    self._render_task = "Undersampled preview"
                    # render_preview takes an EXPONENT (stride is
                    # 1 << level): start at us-1 and step down one
                    # level per loop turn, floor at level 1 (stride 2).
                    level = (
                        max(us - 1, 1)
                        if prev is None
                        else max(prev[0] - 1, 1)
                    )
                    r.render_preview(level)
                    self._render_task = None
                    self._fulfill_ready()
                    return
                self._render_task = "Rendering"
                step = min(
                    self._samples_per_step, target - r.sample_count
                )
                # Bound batch walltime (~0.5 s) so pending edits never
                # wait long behind stale samples (the reference aborts
                # sub-kernel via the device abort flag; between-sample
                # granularity is the analog here).
                if r._last_sample_time > 1e-6:
                    step = max(
                        1, min(step, int(0.5 / r._last_sample_time) or 1)
                    )
                t0 = _time.monotonic()
                try:
                    r.render_samples(step)
                finally:
                    self._render_task = None
                self._render_time += _time.monotonic() - t0
            self._fulfill_ready()

    def _fulfill_ready(self):
        """Convert finished requests into output handles (render lock held)."""
        r = self.renderer
        for promise, req in list(self._requests.items()):
            if not req.ready and r.sample_count >= req.sample_count:
                handle = self._next_output
                self._next_output += 1
                self._outputs[handle] = _Output(
                    image=r.get_image(),
                    sample_count=r.sample_count,
                    time=self._render_time,
                )
                req.ready = True
                self._fulfilled[promise] = handle

    # -- scene loading ------------------------------------------------------

    def load_lum_file(self, path: str) -> LumFileContent | None:
        """reference: luminary_host_load_lum_file (host.c:534). In async
        mode the load happens on the host worker and None is returned."""
        if self._asynchronous:
            from .queue_worker import QueueEntry

            self._host_queue.push(
                QueueEntry(name="Loading Lum File",
                           function=lambda: self._load_lum_sync(path))
            )
            return None
        return self._load_lum_sync(path)

    def _load_lum_sync(self, path: str) -> LumFileContent:
        content = read_lum_file(path)
        base_instance_count = self.scene.num_instances
        mesh_id_offset = self.scene.num_meshes
        for obj_path in content.obj_file_paths:
            self._load_obj(obj_path, content.wavefront_args)
        for inst in content.instances:
            inst.mesh_id += mesh_id_offset
            inst.id = base_instance_count
            base_instance_count += 1
            self.scene.add_instance(inst)
        self.scene.set_entity("settings", content.settings)
        self.scene.set_entity("camera", content.camera)
        self.scene.set_entity("ocean", content.ocean)
        self.scene.set_entity("sky", content.sky)
        self.scene.set_entity("cloud", content.cloud)
        self.scene.set_entity("fog", content.fog)
        self.scene.set_entity("particles", content.particles)
        return content

    def load_obj_file(self, path: str, args: WavefrontArguments | None = None) -> int:
        """reference: luminary_host_load_obj_file. Returns mesh id; adds an
        untransformed instance (legacy behaviour matching lum MESHFILE)."""
        mesh_id = self._load_obj(path, args or WavefrontArguments())
        inst = self.scene.new_instance()
        inst.mesh_id = mesh_id
        self.scene.set_instance(inst)
        return mesh_id

    def _load_obj(self, path: str, args: WavefrontArguments) -> int:
        result = read_obj_file(
            path, args, base_texture_id=len(self.scene.textures)
        )
        # Remap local material slots to global ids (reference: wavefront
        # convert step applies the same offset).
        mat_offset = self.scene.num_materials
        for mat in result.materials:
            self.scene.add_material(mat)
        for tex in result.textures:
            self.scene.add_texture(tex)
        result.mesh.material_ids = result.mesh.material_ids + np.uint16(mat_offset)
        mesh_id = self.scene.add_mesh(result.mesh)
        info_message(
            "loaded %s: %d tris, %d materials",
            os.path.basename(path),
            result.mesh.num_triangles,
            len(result.materials),
        )
        return mesh_id

    def save_lum_file(self, path: str):
        c = LumFileContent(
            settings=self.scene.get_entity("settings"),
            camera=self.scene.get_entity("camera"),
            ocean=self.scene.get_entity("ocean"),
            sky=self.scene.get_entity("sky"),
            cloud=self.scene.get_entity("cloud"),
            fog=self.scene.get_entity("fog"),
            particles=self.scene.get_entity("particles"),
        )
        write_lum_file(path, c)

    # -- entity access (luminary_host_get/set_*) ----------------------------

    def get_settings(self):
        return self.scene.get_entity("settings")

    def set_settings(self, v):
        self.scene.set_entity("settings", v)

    def get_camera(self):
        return self.scene.get_entity("camera")

    def set_camera(self, v):
        self.scene.set_entity("camera", v)

    def get_ocean(self):
        return self.scene.get_entity("ocean")

    def set_ocean(self, v):
        self.scene.set_entity("ocean", v)

    def get_sky(self):
        return self.scene.get_entity("sky")

    def set_sky(self, v):
        self.scene.set_entity("sky", v)

    def set_sky_hdri(self, image) -> None:
        """Install a user lat-long HDRI for SkyMode.HDRI (numpy [H, W, >=3]
        linear radiance, or a path to a PNG to load and linearize)."""
        if isinstance(image, (str, bytes)):
            import numpy as np

            from ..io.png import read_png

            img = read_png(image).astype(np.float32) / 255.0
            image = img[..., :3] ** 2.2  # sRGB → linear
        self.scene.set_sky_hdri(image)

    def get_cloud(self):
        return self.scene.get_entity("cloud")

    def set_cloud(self, v):
        self.scene.set_entity("cloud", v)

    def get_fog(self):
        return self.scene.get_entity("fog")

    def set_fog(self, v):
        self.scene.set_entity("fog", v)

    def get_particles(self):
        return self.scene.get_entity("particles")

    def set_particles(self, v):
        self.scene.set_entity("particles", v)

    def get_material(self, mat_id: int) -> Material:
        return self.scene.get_material(mat_id)

    def set_material(self, mat: Material):
        self.scene.set_material(mat)

    def get_instance(self, inst_id: int) -> Instance:
        return self.scene.get_instance(inst_id)

    def set_instance(self, inst: Instance):
        self.scene.set_instance(inst)

    def new_instance(self) -> Instance:
        return self.scene.new_instance()

    @property
    def num_meshes(self) -> int:
        return self.scene.num_meshes

    @property
    def num_materials(self) -> int:
        return self.scene.num_materials

    @property
    def num_instances(self) -> int:
        return self.scene.num_instances

    # -- rendering ----------------------------------------------------------

    def start_new_render(self):
        """reference: luminary_host_start_new_render — restart integration."""
        self.scene.mark_dirty(DirtyFlags.INTEGRATION)

    def request_output(self, sample_count: int) -> int:
        """Request a frame at a target sample count, at render resolution;
        returns a promise handle (reference: luminary_host_request_output)."""
        promise = self._next_promise
        self._next_promise += 1
        self._requests[promise] = OutputRequest(
            sample_count=sample_count, promise=promise)
        return promise

    def try_await_output(self, promise: int) -> int:
        """Poll a promise. In async mode this never blocks (the render
        worker does the work); in sync mode it renders a bounded slice per
        call so callers stay responsive. Returns an output handle or
        OUTPUT_HANDLE_INVALID."""
        if promise in self._fulfilled:
            handle = self._fulfilled.pop(promise)
            del self._requests[promise]
            return handle
        if promise not in self._requests:
            raise InvalidAPIArgumentError(f"unknown output promise {promise}")
        if self._asynchronous:
            self.check_errors()
            self._work_available.set()
            return OUTPUT_HANDLE_INVALID
        req = self._requests[promise]
        r = self.renderer
        r.update()
        if r.sample_count < req.sample_count:
            step = min(self._samples_per_step, req.sample_count - r.sample_count)
            import time as _time

            t0 = _time.monotonic()
            r.render_samples(step)
            self._render_time += _time.monotonic() - t0
        if r.sample_count < req.sample_count:
            return OUTPUT_HANDLE_INVALID
        del self._requests[promise]
        handle = self._next_output
        self._next_output += 1
        self._outputs[handle] = _Output(
            image=r.get_image(),
            sample_count=r.sample_count,
            time=self._render_time,
        )
        return handle

    def acquire_output(self) -> int:
        """Acquire the current (recurring/interactive) output
        (reference: luminary_host_acquire_output)."""
        with self._renderer_lock:
            r = self.renderer
            r.update()
            if r.sample_count == 0 and not self._asynchronous:
                r.render_samples(1)
            handle = self._next_output
            self._next_output += 1
            self._outputs[handle] = _Output(
                image=r.get_image(), sample_count=r.sample_count,
                time=self._render_time,
            )
            return handle

    def get_image(self, handle: int) -> np.ndarray:
        if handle not in self._outputs:
            raise InvalidAPIArgumentError(f"invalid output handle {handle}")
        return self._outputs[handle].image

    def get_image_meta(self, handle: int) -> dict:
        o = self._outputs[handle]
        return {"sample_count": o.sample_count, "time": o.time}

    def release_output(self, handle: int):
        if handle not in self._outputs:
            raise InvalidAPIArgumentError(f"invalid output handle {handle}")
        o = self._outputs[handle]
        o.ref_count -= 1
        if o.ref_count <= 0:
            del self._outputs[handle]

    def save_png(self, handle: int, path: str):
        write_png(path, self.get_image(handle))

    def get_pixel_info(self, x: int, y: int):
        if self._renderer is None:
            raise PreconditionError("no render has run yet")
        return self._renderer.get_pixel_info(x, y)

    @property
    def current_sample_time(self) -> float:
        return self.renderer.current_sample_time

    def save_checkpoint(self, path: str):
        """Serialize render progress so an offline render can resume after
        a restart (no reference analog — its progressive state dies with
        the process; see Renderer.save_checkpoint)."""
        self.renderer.save_checkpoint(path)

    def load_checkpoint(self, path: str):
        """Resume from save_checkpoint output (fingerprint-validated)."""
        self.renderer.load_checkpoint(path)

    def profile_render(self, samples: int = 1):
        """Per-stage device-time breakdown of a render sample, the public
        face of the reference's per-kernel timing printout
        (device_renderer.c:282-343). Returns [(stage, ms, percent)]."""
        from ..utils.profiling import profile_renderer

        with self._renderer_lock:
            return profile_renderer(self.renderer, samples=samples)

    # -- device info --------------------------------------------------------

    def _devices(self) -> list:
        """The devices that ids index: the mesh's entries, else the CUDA
        cards visible to torch, or the CPU."""
        if self._mesh is not None:
            return list(self._mesh.shards)
        if self._device.type == "cuda":
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        return [self._device]

    def get_device_count(self) -> int:
        return len(self._devices())

    def get_device_info(self, device_id: int) -> dict:
        devs = self._devices()
        if not 0 <= device_id < len(devs):
            raise InvalidAPIArgumentError(f"device id {device_id} out of range")
        d = devs[device_id]
        if d.type == "cuda":
            name = f"cuda:{torch.cuda.get_device_name(d)}"
            free, total = torch.cuda.mem_get_info(d)
        else:
            name, free, total = "cpu", 0, 0
        # elasticity state (reference: LuminaryDeviceInfo is_enabled /
        # is_unavailable; Renderer.set_device_enable)
        states = (self._renderer.device_states()
                  if self._renderer is not None else [])
        if self._mesh is not None:
            state = states[device_id] if device_id < len(states) else "enabled"
            enabled_ids = [i for i, s in enumerate(states) if s == "enabled"]
            main_id = enabled_ids[0] if enabled_ids else 0
        else:
            state = "enabled"
            main_id = devs.index(self._device)
        return {
            "is_main_device": device_id == main_id,
            "is_unavailable": state == "unavailable",
            "is_enabled": state == "enabled",
            "name": name,
            "memory_size": total,
            "allocated_memory_size": total - free,
        }

    def set_device_enable(self, device_id: int, enable: bool) -> None:
        """Hot-enable/disable a mesh device (reference:
        luminary_host_set_device_enable, host.h:36). The mesh re-forms over
        the enabled entries, the first enabled one becomes the main
        (re-election), and the render restarts. A Host without a mesh
        raises InvalidAPIArgumentError, before it packs any scene."""
        if self._mesh is None:
            raise InvalidAPIArgumentError(
                "set_device_enable requires a mesh renderer")
        with self._renderer_lock:
            self.renderer.set_device_enable(device_id, enable)
