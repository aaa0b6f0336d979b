"""The slice as a whole: the port's CLI and ``Host`` against the JAX
package's.

One module fixture writes a dense-tier box with an emitter (16x16, depth 2)
as ``.lum`` + OBJ/MTL and runs both packages' CLIs on it in this process
(``-s 4``; the port's with ``--device cpu``), keeping each CLI's Host; then
both render an adaptive budget of 8 samples on the same scene. Checks: the
radiance within the golden bound (RMSE/scale < 0.02), the PNGs within one
level on at least 99 % of values, the adaptive sample maps equal on at least
99 % of pixels, checkpoints that load across the packages, and the debug
output images on the same accumulators. The rest drives the port's Host on
its own: synchronous and asynchronous requests with the preview pyramid,
entities, picking, checkpoints, the benchmark ladder and the CLI's other
modes."""

import dataclasses
import os
import threading
import time

import numpy as np
import pytest
import torch

from luminary_tpu.frontend import cli as jcli
from luminary_tpu_torch.frontend import cli as tcli
from luminary_tpu_torch.frontend.benchmark import run_benchmark
from luminary_tpu_torch.host.host import OUTPUT_HANDLE_INVALID, Host
from luminary_tpu_torch.host.queue_worker import QueueEntry
from luminary_tpu_torch.io.png import read_png
from luminary_tpu_torch.testing import cornell_scene, write_obj_scene

torch.set_num_threads(1)


def _run_cli(mod, argv):
    """Run a package's CLI main in this process; returns the Host it made."""
    made = []
    base = mod.Host

    class Recording(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "Host", Recording)
        assert mod.main(argv) == 0
    return made[0]


def _adaptive(host):
    s = host.get_settings()
    s.enable_adaptive_sampling = True
    s.adaptive_sampling_update_interval = 16  # stages of 2 rounds
    host.set_settings(s)
    r = host.renderer
    r.render_samples(8)
    return (np.asarray(r.accum.sample_count)[:256].copy(),
            np.asarray(r.get_radiance()))


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    lum = write_obj_scene(cornell_scene(16, 16, max_depth=2), str(d), "box")
    out = {"dir": d, "lum": lum}
    for name, mod, extra in (("jax", jcli, []),
                             ("torch", tcli, ["--device", "cpu"])):
        png = str(d / f"{name}.png")
        host = _run_cli(mod, [lum, "-s", "4", "-o", png] + extra)
        out[name] = dict(host=host, png=read_png(png),
                         radiance=np.asarray(host.renderer.get_radiance()),
                         count=host.renderer.sample_count)
    for name in ("jax", "torch"):
        out[name]["adaptive"] = _adaptive(out[name]["host"])
    return out


def test_cli_radiance_matches_jax(fx):
    got, ref = fx["torch"]["radiance"], fx["jax"]["radiance"]
    assert fx["torch"]["count"] == fx["jax"]["count"] == 4
    assert got.shape == ref.shape == (16, 16, 3) and np.isfinite(got).all()
    rmse = float(np.sqrt(np.mean((got - ref) ** 2)))
    assert rmse / (float(np.abs(ref).mean()) + 1e-6) < 0.02
    assert float(ref.mean()) > 0.0


def test_cli_png_matches_jax(fx):
    got, ref = fx["torch"]["png"], fx["jax"]["png"]
    assert got.shape == ref.shape == (16, 16, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert (diff <= 1).mean() >= 0.99, diff.max()
    assert got.max() > 0


def test_adaptive_sample_map_matches_jax(fx):
    (got, rad), (ref, rad_ref) = fx["torch"]["adaptive"], fx["jax"]["adaptive"]
    assert len(np.unique(got)) > 1, "adaptive sampling left a uniform map"
    assert (got == ref).mean() >= 0.99, (got != ref).sum()
    assert got.sum() == ref.sum() == 8 * 256
    # the stages' radiance: per-lane sample ids that went wrong would still
    # give a plausible image, but not the reference's. Sound runs agree to
    # ~1e-7 of the scale; this bound is 200x tighter than the golden one.
    assert np.isfinite(rad).all() and float(rad_ref.mean()) > 0.0
    rmse = float(np.sqrt(np.mean((rad - rad_ref) ** 2)))
    assert rmse / (float(np.abs(rad_ref).mean()) + 1e-6) < 1e-4


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_checkpoint_loads_across_packages(fx, tmp_path, direction):
    src, dst = direction.split("_to_")
    path = str(tmp_path / "ckpt.npz")
    fx[src]["host"].save_checkpoint(path)
    fx[dst]["host"].load_checkpoint(path)
    a, b = fx[src]["host"].renderer.accum, fx[dst]["host"].renderer.accum
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_mesh_host_matches_jax(fx):
    """Host(mesh=4) on CPU shards, one step of the 4 samples: within the CLI
    bound of the JAX render, and at the mesh tolerance of the port's serial
    CLI render."""
    host = Host(mesh=4, device="cpu", samples_per_step=4)
    host.load_lum_file(fx["lum"])
    handle = _await(host, host.request_output(4))
    assert host.get_image_meta(handle)["sample_count"] == 4
    got = host.renderer.get_radiance()
    ref = fx["jax"]["radiance"]
    rmse = float(np.sqrt(np.mean((got - ref) ** 2)))
    assert rmse / (float(np.abs(ref).mean()) + 1e-6) < 0.02
    np.testing.assert_allclose(got, fx["torch"]["radiance"], rtol=2e-4,
                               atol=1e-5)


def test_cli_mesh_png_matches_jax(fx):
    png = str(fx["dir"] / "torch_mesh.png")
    host = _run_cli(tcli, [fx["lum"], "-s", "4", "-o", png, "--mesh", "4",
                           "--device", "cpu"])
    assert host.renderer.mesh.size == 4
    got, ref = read_png(png), fx["jax"]["png"]
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert (diff <= 1).mean() >= 0.99, diff.max()


def test_mesh_checkpoint_loads_into_jax(fx, tmp_path):
    """A mesh renderer's checkpoint loads into a fresh JAX Renderer of the
    same scene (no render on the JAX side)."""
    from luminary_tpu.render.renderer import Renderer as JRenderer
    from luminary_tpu.testing import cornell_scene as jcornell_scene

    from luminary_tpu_torch.parallel.mesh import make_sample_mesh
    from luminary_tpu_torch.render.renderer import Renderer

    r = Renderer(cornell_scene(16, 16, max_depth=2),
                 mesh=make_sample_mesh(["cpu"] * 2))
    r.render_samples(2)
    path = str(tmp_path / "mesh.npz")
    r.save_checkpoint(path)
    jr = JRenderer(jcornell_scene(16, 16, max_depth=2))
    jr.load_checkpoint(path)
    for x, y in zip(r.accum, jr.accum):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert jr.sample_count == 2


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_debug_output_images_match_jax(fx, mode):
    """VARIANCE / ERROR / SAMPLE_DISTRIBUTION on the same accumulators."""
    import jax.numpy as jnp

    tr, jr = fx["torch"]["host"].renderer, fx["jax"]["host"].renderer
    jr.accum = type(jr.accum)(*(jnp.asarray(x.numpy()) for x in tr.accum))
    got, ref = tr._debug_output_image(mode), jr._debug_output_image(mode)
    assert got.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def _host(tmp_path, **kw):
    lum = write_obj_scene(cornell_scene(16, 16, max_depth=2), str(tmp_path), "box")
    host = Host(device="cpu", **kw)
    return host, lum


def _await(host, promise, timeout=120.0):
    t0 = time.monotonic()
    handle = OUTPUT_HANDLE_INVALID
    while handle == OUTPUT_HANDLE_INVALID:
        assert time.monotonic() - t0 < timeout
        handle = host.try_await_output(promise)
        if host._asynchronous:
            time.sleep(0.01)
    return handle


def test_host_synchronous_flow(tmp_path):
    host, lum = _host(tmp_path, samples_per_step=2)
    content = host.load_lum_file(lum)
    assert host.num_meshes == 1 and host.num_instances == 1
    assert host.num_materials == 4 and len(content.obj_file_paths) == 1
    promise = host.request_output(5)
    handle = _await(host, promise)
    img = host.get_image(handle)
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8 and img.max() > 0
    assert host.get_image_meta(handle)["sample_count"] == 5
    assert np.array_equal(img, host.renderer.get_image())
    host.save_png(handle, str(tmp_path / "o.png"))
    assert np.array_equal(read_png(str(tmp_path / "o.png")), img)
    info = host.get_pixel_info(8, 8)
    assert info["pixel_query_is_valid"] and info["instance_id"] == 0
    assert 0 < info["depth"] < 10 and len(info["rel_hit_pos"]) == 3
    host.release_output(handle)
    with pytest.raises(Exception, match="invalid output handle"):
        host.get_image(handle)
    acquired = host.acquire_output()
    assert host.get_image(acquired).shape == (16, 16, 3)
    assert host.get_device_count() == 1
    assert host.get_device_info(0)["name"] == "cpu"
    assert host.current_sample_time > 0.0


def test_host_async_flow_with_preview(tmp_path):
    host, lum = _host(tmp_path, asynchronous=True, samples_per_step=2)
    try:
        assert host.load_lum_file(lum) is None  # loads on the host worker
        # the worker runs its queue in order: once this entry has run, the
        # scene is loaded
        loaded = threading.Event()
        host._host_queue.push(QueueEntry(name="probe", function=loaded.set))
        assert loaded.wait(60) and host.num_instances == 1
        s = host.get_settings()
        s.undersampling = 3
        host.set_settings(s)
        handle = _await(host, host.request_output(3))
        host.check_errors()
        assert host.get_image_meta(handle)["sample_count"] >= 3
        assert host.get_image(handle).shape == (16, 16, 3)
        # the undersampled pyramid ran down to stride 2 before the samples
        assert host.renderer._preview[0] == 1
        assert host.num_queue_workers == 2
        assert host.get_queue_worker_name(1) == "Device Worker"
    finally:
        host.destroy()


def test_host_async_render_error_reaches_caller(tmp_path):
    """An error on the device worker (here update() refusing a lamp whose
    pre-scaled emission overflows the shade row's f16, which the packer
    refuses where the reference would store inf) is raised by the next poll
    instead of leaving the caller polling forever; once the scene is
    fixed, a later poll resumes."""
    from luminary_tpu_torch.utils.errors import InvalidAPIArgumentError

    host = Host(device="cpu", asynchronous=True)
    try:
        host.scene = cornell_scene(16, 16, max_depth=2)
        lamp = next(m for m in host.scene.materials if m.emission_active)
        host.set_material(dataclasses.replace(lamp, emission_scale=1e6))
        promise = host.request_output(1)
        t0 = time.monotonic()
        with pytest.raises(InvalidAPIArgumentError, match="f16 maximum"):
            while time.monotonic() - t0 < 60.0:
                assert host.try_await_output(promise) == OUTPUT_HANDLE_INVALID
                time.sleep(0.01)
        host.set_material(lamp)
        handle = _await(host, promise)
        assert host.get_image(handle).shape == (16, 16, 3)
    finally:
        host.destroy()


def test_preview_image_before_first_sample(tmp_path):
    host, lum = _host(tmp_path)
    host.load_lum_file(lum)
    r = host.renderer
    r.render_preview(2)
    img = r.get_image()
    assert r.sample_count == 0 and img.shape == (16, 16, 3) and img.max() > 0
    # the preview is 4x4 blocks of one traced pixel each
    assert (img[:4, :4] == img[0, 0]).all()


def test_host_entities_and_lum_round_trip(tmp_path):
    host, lum = _host(tmp_path)
    host.load_lum_file(lum)
    cam = host.get_camera()
    cam.exposure = 2.0
    host.set_camera(cam)
    assert host.get_camera().exposure == 2.0
    mat = host.get_material(3)
    assert mat.emission_active
    inst = host.get_instance(0)
    assert inst.mesh_id == 0
    host.save_lum_file(str(tmp_path / "saved.lum"))
    other = Host(device="cpu")
    content = other.load_lum_file(str(tmp_path / "saved.lum"))
    assert content.camera.exposure == 2.0
    assert content.settings.width == 16


def test_host_checkpoint_resume(tmp_path):
    a, lum = _host(tmp_path)
    a.load_lum_file(lum)
    a.renderer.render_samples(2)
    a.save_checkpoint(str(tmp_path / "c.npz"))
    a.renderer.render_samples(2)
    b = Host(device="cpu")
    b.load_lum_file(lum)
    b.load_checkpoint(str(tmp_path / "c.npz"))
    b.renderer.render_samples(2)
    for x, y in zip(a.renderer.accum, b.renderer.accum):
        assert torch.equal(x, y)


def test_benchmark_ladder(tmp_path):
    host, lum = _host(tmp_path)
    host.load_lum_file(lum)
    results = run_benchmark(host, 2, "t", output_dir=str(tmp_path))
    assert [spp for spp, _ in results] == [1, 2, 3, 4]
    for spp in (1, 2, 3, 4):
        assert read_png(str(tmp_path / f"Bench-{spp}-t.png")).shape == (16, 16, 3)
    rows = (tmp_path / "BenchResults-t.txt").read_text().split()
    assert rows[0] == "samples,seconds" and len(rows) == 5


@pytest.mark.parametrize("mode", ["obj", "dry_run", "bench", "overrides"])
def test_cli_modes(tmp_path, capsys, mode):
    lum = write_obj_scene(cornell_scene(16, 16, max_depth=2), str(tmp_path), "box")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        if mode == "obj":
            argv = [str(tmp_path / "box.obj"), "-s", "1", "--width", "12",
                    "--height", "8", "-o", "obj.png"]
        elif mode == "dry_run":
            argv = [lum, "--dry-run"]
        elif mode == "bench":
            argv = [lum, "-b", "1", "cli"]
        else:
            argv = [lum, "-s", "2", "--width", "20", "--height", "10",
                    "--depth", "1", "-o", "small.png"]
        assert tcli.main(argv + ["--device", "cpu"]) == 0
    finally:
        os.chdir(cwd)
    text = capsys.readouterr().out
    if mode == "obj":
        assert read_png(str(tmp_path / "obj.png")).shape == (8, 12, 3)
    elif mode == "dry_run":
        assert "dry-run ok: 1 meshes, 4 materials, 1 instances, 16x16" in text
    elif mode == "bench":
        assert (tmp_path / "Bench-2-cli.png").exists()
        assert (tmp_path / "BenchResults-cli.txt").exists()
    else:
        assert read_png(str(tmp_path / "small.png")).shape == (10, 20, 3)
        assert "rendered 2 spp" in text
