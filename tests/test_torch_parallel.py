"""Multi-device rendering in the port (``luminary_tpu_torch/parallel/mesh.py``,
the Renderer's mesh path with device elasticity, ``Host(mesh=N)``) on CPU
shards: the mirrors of ``tests/test_parallel.py`` and
``tests/test_elasticity.py``, held against the port's serial
``render_sample`` over the same sample ids, and the JAX ``Host(mesh=4)``
driven through the same enable and disable sequence as the port's. No test
here compiles the JAX ``shard_map`` step: the JAX Host renders nothing."""

import dataclasses

import numpy as np
import pytest
import torch

from luminary_tpu_torch.host.host import OUTPUT_HANDLE_INVALID, Host
from luminary_tpu_torch.ops.camera import pack_camera
from luminary_tpu_torch.parallel.mesh import (
    DeviceMesh,
    distributed_sample_step,
    make_grid_mesh,
    make_sample_mesh,
    shard_pixels,
    tree_to,
)
from luminary_tpu_torch.render.device_scene import pack_scene
from luminary_tpu_torch.render.renderer import Renderer
from luminary_tpu_torch.render.wavefront import RenderConfig, render_sample
from luminary_tpu_torch.testing import cornell_scene
from luminary_tpu_torch.utils.errors import InvalidAPIArgumentError

torch.set_num_threads(1)

W = H = 16


def _cpu_mesh(n):
    return make_sample_mesh(["cpu"] * n)


@pytest.fixture(scope="module")
def packed():
    scene = cornell_scene(W, H, max_depth=2)
    dscene = pack_scene(scene, "cpu")
    cam = pack_camera(scene.camera, "cpu")
    config = RenderConfig(width=W, height=H, max_depth=2)
    idx = np.arange(W * H, dtype=np.int64)
    px = torch.as_tensor((idx % W).astype(np.int32))
    py = torch.as_tensor((idx // W).astype(np.int32))
    return dscene, cam, config, px, py


@pytest.fixture(scope="module")
def serial(packed):
    """The port's serial render_sample at sample ids 0-7 (radiance, gbuffer
    of id 0, rays)."""
    dscene, cam, config, px, py = packed
    out = []
    for s in range(8):
        radiance, gbuf, rays = render_sample(dscene, cam, config, px, py, s,
                                             with_gbuffer=s == 0)
        out.append((radiance, gbuf, float(rays)))
    return out


def _single_device_sum(serial, n_samples):
    total = torch.zeros((W * H, 3))
    for radiance, _, _ in serial[:n_samples]:
        total = total + radiance
    return total.numpy()


def _zeros():
    return torch.zeros((W * H, 3)), torch.zeros(W * H)


def test_sample_mesh_matches_single_device(packed, serial):
    dscene, cam, config, px, py = packed
    step, n_per = distributed_sample_step(_cpu_mesh(8), config)
    assert n_per == 8
    rad, lum, gbuf, rays = step(dscene, cam, px, py, *_zeros(), 0)
    assert float(rays) == sum(r for _, _, r in serial[:8]) > 0
    np.testing.assert_allclose(rad.numpy(), _single_device_sum(serial, 8),
                               rtol=1e-5, atol=1e-5)
    # the gbuffer is samples-axis shard 0's: sample id 0
    for a, b in zip(gbuf, serial[0][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_grid_mesh_pixel_sharding(packed, serial):
    dscene, cam, config, px, py = packed
    mesh = make_grid_mesh(4, 2, ["cpu"] * 8)
    assert mesh.shape == {"samples": 4, "pixels": 2}
    assert mesh.devices.shape == (4, 2) and mesh.size == 8
    step, n_per = distributed_sample_step(mesh, config)
    assert n_per == 4
    px_s, py_s, rad, lum = shard_pixels(mesh, px, py, *_zeros())
    rad, lum, gbuf, rays = step(dscene, cam, px_s, py_s, rad, lum, 0)
    np.testing.assert_allclose(rad.numpy(), _single_device_sum(serial, 4),
                               rtol=1e-5, atol=1e-5)
    assert gbuf.depth.shape == (W * H,)
    assert float(rays) == sum(r for _, _, r in serial[:4])


def test_accumulation_across_steps(packed, serial):
    dscene, cam, config, px, py = packed
    step, _ = distributed_sample_step(_cpu_mesh(4), config)
    rad, lum = _zeros()
    rad, lum, _, _ = step(dscene, cam, px, py, rad, lum, 0)
    rad, lum, _, _ = step(dscene, cam, px, py, rad, lum, 4)
    np.testing.assert_allclose(rad.numpy(), _single_device_sum(serial, 8),
                               rtol=1e-5, atol=2e-5)


def test_renderer_mesh_matches_single_device():
    """Renderer(mesh=...) accumulates the image the serial Renderer does over
    the same sample ids, with a gbuffer and the ray count."""
    r_serial = Renderer(cornell_scene(W, H, max_depth=2), device="cpu")
    r_serial.render_samples(8)
    r_mesh = Renderer(cornell_scene(W, H, max_depth=2), mesh=_cpu_mesh(8))
    assert r_mesh.device == torch.device("cpu")
    r_mesh.render_samples(8)  # one distributed step: sample ids 0..7
    assert int(r_mesh.accum.sample_count.max()) == 8 == r_mesh.sample_count
    np.testing.assert_allclose(r_serial.accum.radiance.numpy(),
                               r_mesh.accum.radiance.numpy(),
                               rtol=2e-4, atol=1e-5)
    assert r_mesh._last_rays_per_sample > 0
    assert r_mesh._last_rays_traced == r_serial._last_rays_traced
    # gbuffers from other sample ids (mesh: shard 0's id 0, serial: the last)
    # differ by their jitter; the hit structure agrees almost everywhere
    gd = r_mesh.gbuffer.depth.numpy()
    gs = r_serial.gbuffer.depth.numpy()
    assert ((gd < 1e30) == (gs < 1e30)).mean() > 0.95
    both = (gd < 1e30) & (gs < 1e30)
    rel = np.abs(gd[both] - gs[both]) / np.maximum(gs[both], 1e-6)
    assert np.median(rel) < 0.05
    assert r_mesh.get_pixel_info(8, 8)["pixel_query_is_valid"]


def test_device_mesh_layout():
    mesh = make_grid_mesh(2, 3, ["cpu", "meta", "cpu", "cpu", "meta", "cpu"])
    assert mesh.axis_names == ("samples", "pixels")
    assert mesh.shape == {"samples": 2, "pixels": 3} and mesh.size == 6
    assert mesh.devices.shape == (2, 3)
    assert mesh.devices[1, 1] == torch.device("meta")
    # each device once, in order of first appearance
    assert mesh.distinct() == [torch.device("cpu"), torch.device("meta")]
    assert "'samples': 2" in repr(mesh)
    flat = make_sample_mesh(["cpu"] * 3)
    assert flat.axis_names == ("samples",) and flat.devices.shape == (3,)
    with pytest.raises(ValueError, match="cannot lay 5 devices"):
        make_grid_mesh(2, 3, ["cpu"] * 5)


def _leaves(tree, path=()):
    """(path, leaf) pairs over the NamedTuples, dataclasses and tuples that
    ``tree_to`` walks."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _leaves(v, path + (name,))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), path + (f.name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_tree_to_moves_every_tensor(packed):
    """The per-device copy of the packed scene and camera: every tensor on
    the target device with its shape and dtype, every host value shared."""
    dscene, cam = packed[:2]
    moved = tree_to((dscene, cam), torch.device("meta"))
    assert type(moved[0]) is type(dscene) and type(moved[1]) is type(cam)
    src = list(_leaves((dscene, cam)))
    got = list(_leaves(moved))
    assert [p for p, _ in got] == [p for p, _ in src]
    n_tensors = 0
    for (path, a), (_, b) in zip(src, got):
        if isinstance(a, torch.Tensor):
            n_tensors += 1
            assert b.device.type == "meta", path
            assert (b.shape, b.dtype) == (a.shape, a.dtype), path
        else:
            assert not isinstance(b, torch.Tensor) and b == a, path
    assert n_tensors > 20


@pytest.mark.parametrize("n_pixels,lanes,whole", [
    (1, 7, True),     # no pixels axis: any lane count
    (2, 128, True),
    (2, 96, False),   # blocks of 48 lanes
    (3, 96, True),
    (3, 100, False),  # no equal blocks
])
def test_pixel_blocks_are_whole_packets(n_pixels, lanes, whole):
    mesh = make_grid_mesh(2, n_pixels, ["cpu"] * (2 * n_pixels))
    a = torch.zeros(lanes, dtype=torch.int32)
    if whole:
        assert shard_pixels(mesh, a, a)[1] is a
    else:
        with pytest.raises(ValueError, match="multiple of 32 lanes"):
            shard_pixels(mesh, a)


def test_renderer_mesh_takes_its_main_device():
    scene = cornell_scene(W, H, max_depth=2)
    with pytest.raises(ValueError, match="main device"):
        Renderer(scene, device="meta", mesh=_cpu_mesh(2))
    r = Renderer(scene, device="cpu", mesh=_cpu_mesh(2))
    assert r.device == torch.device("cpu") and r.mesh.size == 2
    assert r.device_states() == ["enabled", "enabled"]
    assert Renderer(scene, device="cpu").device_states() == []


def test_set_device_enable_checks_its_arguments():
    r = _mesh_renderer(2)
    r.render_samples(2)
    for bad in (2, -1):
        with pytest.raises(InvalidAPIArgumentError, match="out of range"):
            r.set_device_enable(bad, False)
    # enabling an enabled device changes nothing: the render goes on
    r.set_device_enable(1, True)
    assert r.sample_count == 2 and r.mesh.size == 2
    single = Renderer(cornell_scene(W, H, max_depth=2), device="cpu")
    with pytest.raises(InvalidAPIArgumentError, match="requires a mesh"):
        single.set_device_enable(0, False)


def test_host_without_mesh_device_info():
    """A single-device CPU Host indexes one device; set_device_enable is
    refused before any scene is packed."""
    host = Host(device="cpu")
    assert host.get_device_count() == 1
    info = host.get_device_info(0)
    assert info["is_main_device"] and info["is_enabled"]
    assert not info["is_unavailable"] and info["name"] == "cpu"
    with pytest.raises(InvalidAPIArgumentError, match="out of range"):
        host.get_device_info(1)
    with pytest.raises(InvalidAPIArgumentError, match="requires a mesh"):
        host.set_device_enable(0, False)
    assert host._renderer is None


def test_host_mesh_product_surface():
    h = Host(samples_per_step=8, mesh=8, device="cpu")
    h.scene = cornell_scene(W, H, max_depth=2)
    assert h.renderer.mesh is not None and h.renderer.mesh.size == 8
    p = h.request_output(sample_count=8)
    handle = OUTPUT_HANDLE_INVALID
    for _ in range(50):
        handle = h.try_await_output(p)
        if handle != OUTPUT_HANDLE_INVALID:
            break
    assert handle != OUTPUT_HANDLE_INVALID
    img = h.get_image(handle)
    assert img.shape == (W, H, 3) and float(np.mean(img)) > 0.0
    assert h.get_image_meta(handle)["sample_count"] == 8


def _mesh_renderer(n=4):
    return Renderer(cornell_scene(W, H, max_depth=2), chunk=W * H,
                    mesh=_cpu_mesh(n))


def test_hot_disable_reforms_mesh_and_restarts():
    r = _mesh_renderer(4)
    r.render_samples(4)
    assert r.sample_count == 4
    # disable the main (id 0): re-election to id 1, a mesh of 3, and the
    # accumulation restarts (the reference's INTEGRATION dirty)
    r.set_device_enable(0, False)
    assert r.sample_count == 0
    assert r.mesh.size == 3
    assert r.device_states() == ["disabled", "enabled", "enabled", "enabled"]
    r.render_samples(3)
    assert r.sample_count == 3
    rad_after = r.get_radiance()
    assert np.isfinite(rad_after).all() and rad_after.mean() > 0.0
    # the restarted render equals a fresh 3-shard renderer's
    r2 = _mesh_renderer(3)
    r2.render_samples(3)
    assert np.allclose(rad_after, r2.get_radiance(), atol=1e-6)
    r.set_device_enable(0, True)
    assert r.mesh.size == 4
    assert r.sample_count == 0


def test_disable_all_devices_rejected():
    r = _mesh_renderer(2)
    r.render_samples(1)  # the budget rounds up to the samples axis
    assert r.sample_count == 2
    r.set_device_enable(0, False)
    with pytest.raises(RuntimeError):
        r.set_device_enable(1, False)


def test_failure_recovery_drops_dead_device():
    """A step that raises triggers the probe; the entries it reports dead
    become unavailable and the budget restarts on the re-formed mesh."""
    r = _mesh_renderer(4)
    r.render_samples(4)
    real_probe = r._probe_mesh_devices
    assert real_probe() == [0, 1, 2, 3]
    r._probe_mesh_devices = lambda: [i for i in real_probe() if i != 2]
    fail_once = {"armed": True}
    real_step = r._dist_step
    assert real_step is not None  # built by the first render_samples

    def exploding(*a, **k):
        if fail_once["armed"]:
            fail_once["armed"] = False
            raise RuntimeError("simulated device loss")
        return real_step(*a, **k)

    r._dist_step = exploding
    r.render_samples(3)
    assert r.device_states()[2] == "unavailable"
    assert r.mesh.size == 3
    assert r.sample_count >= 3
    assert np.isfinite(r.get_radiance()).all()
    with pytest.raises(InvalidAPIArgumentError):
        r.set_device_enable(2, True)
    # a failure while every device answers propagates
    r._dist_step = lambda *a, **k: (_ for _ in ()).throw(ValueError("bug"))
    with pytest.raises(ValueError, match="bug"):
        r.render_samples(3)


def test_host_device_info_reflects_elasticity():
    host = Host(mesh=4, device="cpu")
    try:
        host.scene = cornell_scene(W, H, max_depth=2)
        host.renderer  # noqa: B018 (builds the renderer)
        assert host.get_device_count() == 4
        host.set_device_enable(1, False)
        info0 = host.get_device_info(0)
        info1 = host.get_device_info(1)
        assert info0["is_main_device"] and info0["is_enabled"]
        assert info0["name"] == "cpu"
        assert not info1["is_enabled"] and not info1["is_unavailable"]
        host.set_device_enable(0, False)
        assert host.get_device_info(2)["is_main_device"]
    finally:
        host.destroy()


def test_host_elasticity_matches_jax():
    """The JAX Host(mesh=4) on 4 of the virtual CPU devices and the port's
    Host(mesh=4, device="cpu") through one enable/disable sequence (no
    render): the same device states, device-info flags and refusals."""
    import jax

    from luminary_tpu.host.host import Host as JHost
    from luminary_tpu.testing import cornell_scene as jcornell_scene

    assert len(jax.devices()) >= 4
    jh = JHost(mesh=4)
    th = Host(mesh=4, device="cpu")
    jh.scene = jcornell_scene(W, H, max_depth=2)
    th.scene = cornell_scene(W, H, max_depth=2)

    def state(host):
        flags = [tuple(host.get_device_info(i)[k] for k in (
            "is_main_device", "is_enabled", "is_unavailable"))
            for i in range(4)]
        return host.renderer.device_states(), flags

    def outcome(call):
        try:
            call()
        except Exception as e:  # noqa: BLE001 (the type is compared)
            return type(e).__name__
        return None

    seq = [(1, False), (1, False), (0, False), (0, True), (3, False),
           (2, False), (0, False), (1, True), (9, True), (-1, False),
           (1, False), (0, True), (1, True), (2, True), (3, True)]
    for dev_id, enable in seq:
        got = [outcome(lambda h=h: h.set_device_enable(dev_id, enable))
               for h in (jh, th)]
        assert got[0] == got[1], (dev_id, enable, got)
        assert state(jh) == state(th), (dev_id, enable)
    assert state(th)[0] == ["enabled"] * 4
    # a device the probe no longer sees becomes unavailable, and neither
    # package re-enables it
    jr, tr = jh.renderer, th.renderer
    jprobe, tprobe = jr._probe_mesh_devices, tr._probe_mesh_devices
    dead = jr._mesh_devices[2]
    jr._probe_mesh_devices = lambda: [d for d in jprobe() if d is not dead]
    tr._probe_mesh_devices = lambda: [i for i in tprobe() if i != 2]
    assert jr._recover_dead_devices() and tr._recover_dead_devices()
    assert state(jh) == state(th)
    assert state(th)[0][2] == "unavailable"
    got = [outcome(lambda h=h: h.set_device_enable(2, True)) for h in (jh, th)]
    assert got == ["InvalidAPIArgumentError"] * 2
    assert jr.mesh.size == tr.mesh.size
