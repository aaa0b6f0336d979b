"""Multi-device sample distribution over a device mesh (port of
``luminary_tpu/parallel/mesh.py``).

The reference distributes whole samples across up to 4 GPUs and adds the
per-device moment buffers on the main GPU (reference:
src/luminary/device/device_result_interface.c, device.c:1587-1624). Here one
host thread renders every shard in turn, each under its own device, then
copies each shard's moments to the main device (the mesh's first entry) and
adds them there in shard order: the reference's ``BUFFER_ADD`` on the main
GPU, and the counterpart of the JAX package's ``psum``. No process group is
formed; one process drives every device.

Two parallel axes:
  * ``samples``: each shard renders the full frame at its own sample id;
  * ``pixels``: each shard renders a contiguous, equal block of lanes,
    joined on the main device. A block is a multiple of 32 lanes, kernel
    B's packet, so that every lane keeps the packet company it has in the
    unsplit wavefront.

An entry may repeat: shards on one device render one after another there
(N CPU shards for the tests, or a mesh of one card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import on_device, resolve_device
from ..render.wavefront import RenderConfig, render_sample

PACKET = 32  # lanes of a kernel B packet (csrc/traverse_wide.cu)


class DeviceMesh:
    """Devices on a grid with named axes: ``("samples",)`` or
    ``("samples", "pixels")``. ``shards`` are the entries in order;
    ``devices`` the same entries reshaped to the grid."""

    def __init__(self, shards, axis_names, shape):
        self.shards = tuple(resolve_device(d) for d in shards)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        if int(np.prod(list(self.shape.values()))) != len(self.shards):
            raise ValueError("cannot lay %d devices on a %s grid"
                             % (len(self.shards), self.shape))

    @property
    def size(self) -> int:
        return len(self.shards)

    @property
    def devices(self) -> np.ndarray:
        grid = np.empty(len(self.shards), dtype=object)
        for i, d in enumerate(self.shards):
            grid[i] = d
        return grid.reshape(tuple(self.shape.values()))

    def distinct(self) -> list:
        """The mesh's devices, each once, in order of first appearance."""
        return list(dict.fromkeys(self.shards))

    def __repr__(self):
        return "DeviceMesh(%s, %s)" % (self.shape, [str(d) for d in self.shards])


def _visible_cards() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass the mesh's devices, e.g. "
            "['cpu'] * n, to run the plain PyTorch path on CPU shards")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_sample_mesh(devices=None) -> DeviceMesh:
    """1D mesh over ``devices`` (None: every visible card)."""
    devices = list(devices) if devices is not None else _visible_cards()
    return DeviceMesh(devices, ("samples",), (len(devices),))


def make_grid_mesh(n_samples: int, n_pixels: int, devices=None) -> DeviceMesh:
    """2D mesh: sample replication × pixel sharding."""
    devices = list(devices) if devices is not None else _visible_cards()
    return DeviceMesh(devices, ("samples", "pixels"), (n_samples, n_pixels))


def tree_to(tree, device):
    """A copy of a device-state tree (the NamedTuples and dataclasses of
    ``render/device_scene.py`` and ``ops/camera.py``) with every tensor on
    ``device``. Host values (ints, floats, tuples of them) are shared: none
    of them is a device pointer, which the kernel wrappers take from the
    tensors at launch time."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_to(v, device) for v in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_to(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree


def _block(mesh: DeviceMesh, n: int) -> int:
    """Lanes of one pixel shard; raises where the lanes do not split into
    equal blocks of whole packets."""
    n_p = mesh.shape.get("pixels", 1)
    if n_p > 1 and (n % n_p or (n // n_p) % PACKET):
        raise ValueError(
            "%d lanes do not split over %d pixel shards in blocks of a "
            "multiple of %d lanes" % (n, n_p, PACKET))
    return n // n_p


def _join(blocks: list) -> torch.Tensor:
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks)


def distributed_sample_step(mesh: DeviceMesh, config: RenderConfig):
    """Build a multi-device accumulation step → ``(step, n_samples_axis)``.

    ``step(scene, cam, px, py, rad_accum, lum_sq_accum, sample_base)``
    advances the accumulators by ``mesh.shape['samples']`` samples: shard k
    of the samples axis renders sample id ``sample_base + k``. Scene, camera
    and pixels are copied once to each distinct device of the mesh (again
    only when the caller passes other objects). Returns ``(radiance,
    lum_sq, gbuffer, rays_total)`` on the main device; the gbuffer is that
    of samples-axis shard 0."""
    from ..render.renderer import _clamped_lum

    grid = mesh.devices.reshape(mesh.shape["samples"], -1)
    n_s, n_p = grid.shape
    main = mesh.shards[0]
    held = {"src": None, "copies": {}}

    def replica(dev, src):
        if held["src"] is None or any(a is not b
                                      for a, b in zip(held["src"], src)):
            held["src"], held["copies"] = src, {}
        got = held["copies"].get(dev)
        if got is None:
            got = src if dev == src[2].device else tree_to(src, dev)
            held["copies"][dev] = got
        return got

    def step(scene, cam, px, py, rad_accum, lum_accum, sample_base):
        blk = _block(mesh, px.shape[0])
        base = int(sample_base)
        total = total_lsq = rays = gbuf = None
        for k in range(n_s):
            rad_k, lsq_k, gbuf_k = [], [], []
            for j in range(n_p):
                dev = grid[k, j]
                s, c, x, y = replica(dev, (scene, cam, px, py))
                lanes = slice(j * blk, (j + 1) * blk)
                with on_device(dev):
                    radiance, g, r = render_sample(
                        s, c, config, x[lanes], y[lanes],
                        (base + k) & 0xFFFFFFFF, with_gbuffer=k == 0)
                    radiance, lum = _clamped_lum(radiance)
                    lsq = lum * lum
                rad_k.append(radiance.to(main))
                lsq_k.append(lsq.to(main))
                gbuf_k.append(g)
                r = r.to(main)
                rays = r if rays is None else rays + r
            rad_k, lsq_k = _join(rad_k), _join(lsq_k)
            if k == 0:
                total, total_lsq = rad_k, lsq_k
                gbuf = type(g)(*(_join([f.to(main) for f in fields])
                                 for fields in zip(*gbuf_k)))
            else:
                total, total_lsq = total + rad_k, total_lsq + lsq_k
        return rad_accum + total, lum_accum + total_lsq, gbuf, rays

    return step, n_s


def shard_pixels(mesh: DeviceMesh, *arrays):
    """The pixel-axis arrays for the step. They stay on the main device, and
    the step hands each pixel shard its block; with a pixels axis this
    checks that their lanes split into blocks of whole packets."""
    if "pixels" in mesh.axis_names:
        for a in arrays:
            _block(mesh, a.shape[0])
    return arrays
