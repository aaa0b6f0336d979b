"""The physical lens camera against the JAX package on the same numpy
inputs: the achromat prescription and the packed lens bit for bit; the lens
rays (``generate_physical_camera_rays``) in RGB and spectral mode, their
alive masks compared lane for lane (the lanes that a clear-aperture or TIR
threshold decides the other way are counted: at most 2 of 4096 each time,
0 measured), origins and directions within atol 1e-5 and the weights
within rtol 1e-5 (atol 1e-6) on the lanes alive in both; and the
reference's own assertions (``tests/test_physical_camera.py``): the doublet
focuses, rays leave through the front, a wide stop vignettes more, the CIE
weights average to white, spectral mode disperses, and a render through the
lens is finite.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from luminary_tpu.ops import camera_physical as JCP
from luminary_tpu.ops.camera import pack_camera as j_pack_camera
from luminary_tpu.scene import Camera as JCamera
from luminary_tpu_torch.ops import camera_physical as CP
from luminary_tpu_torch.ops.camera import pack_camera
from luminary_tpu_torch.render.renderer import Renderer
from luminary_tpu_torch.scene.entities import Camera
from luminary_tpu_torch.testing import cornell_scene

torch.set_num_threads(1)

MAX_OTHER_DECISION = 2


def _mk(cls, **phys_kw):
    c = cls()
    c.use_physical_camera = True
    c.pos = (0.3, 1.0, 4.0)
    c.rotation = (-0.1, 0.3, 0.0)
    for k, v in phys_kw.items():
        setattr(c.physical, k, v)
    return c


def test_achromat_prescription_bit_for_bit():
    for f, ap in ((0.05, 0.01), (0.035, 0.002), (0.2, 0.05)):
        got = CP.achromat_prescription(f, ap)
        ref = JCP.achromat_prescription(f, ap)
        for a, b in zip(got, ref):
            assert np.array_equal(a, b)
    interfaces, media = got
    assert interfaces.shape == (3, 3) and media.shape == (4, 2)
    assert CP.achromat_prescription(0.05, 0.01)[0][2, 0] > 0


def test_pack_physical_camera_bit_for_bit():
    kw = dict(focal_length=0.05, image_plane_distance=0.055,
              aperture_diameter=0.01, use_spectral_rendering=True)
    got = pack_camera(_mk(Camera, **kw), "cpu").phys
    ref = j_pack_camera(_mk(JCamera, **kw)).phys
    for name in CP.DevicePhysicalCamera._fields:
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(ref, name))), name


def _rays(package_cam, w=64, h=64, n=4096, spectral=False, **kw):
    idx = np.arange(n, dtype=np.int64)
    px, py = idx % w, (idx // w) % h
    kw = dict(dict(focal_length=0.05, image_plane_distance=0.055,
                   aperture_diameter=0.01), **kw)
    kw["use_spectral_rendering"] = spectral
    if package_cam == "jax":
        cam = j_pack_camera(_mk(JCamera, **kw))
        o, d, wgt = JCP.generate_physical_camera_rays(
            cam, cam.phys, w, h, jnp.asarray(px.astype(np.int32)),
            jnp.asarray(py.astype(np.int32)), jnp.asarray(idx.astype(np.uint32)),
            jnp.uint32(3))
        return ([np.asarray(c) for c in o], [np.asarray(c) for c in d],
                [np.asarray(c) for c in wgt])
    cam = pack_camera(_mk(Camera, **kw), "cpu")
    o, d, wgt = CP.generate_physical_camera_rays(
        cam, cam.phys, w, h, torch.as_tensor(px.astype(np.int32)),
        torch.as_tensor(py.astype(np.int32)), torch.as_tensor(idx),
        torch.as_tensor(3))
    wgt = [c.numpy() for c in wgt]
    return ([c.numpy() for c in o], [c.numpy() for c in d], wgt, _alive(wgt))


def _alive(w):
    """The lens's alive mask: a dead lane weighs 0 in every channel."""
    return (np.abs(w[0]) + np.abs(w[1]) + np.abs(w[2])) > 0


@pytest.mark.parametrize("spectral", [False, True])
@pytest.mark.parametrize("aperture", [0.01, 0.03])
def test_lens_rays_match_reference(spectral, aperture):
    o_t, d_t, w_t, alive = _rays("torch", spectral=spectral,
                                 aperture_diameter=aperture)
    o_j, d_j, w_j = _rays("jax", spectral=spectral, aperture_diameter=aperture)
    alive_j = _alive(w_j)
    other = alive != alive_j
    assert other.sum() <= MAX_OTHER_DECISION, int(other.sum())
    both = alive & alive_j
    assert 0.2 < both.mean() and (aperture < 0.02 or both.mean() < 1.0)
    for a, b in zip(o_t + d_t, o_j + d_j):
        np.testing.assert_allclose(a[both], b[both], atol=1e-5)
    for a, b in zip(w_t, w_j):
        np.testing.assert_allclose(a[both], b[both], rtol=1e-5, atol=1e-6)


def test_physical_rays_exit_and_focus():
    _o, d, (wr, _wg, _wb), _ = _rays("torch", w=32, h=32, n=1024)
    assert (wr > 0).mean() > 0.3
    assert (d[2][wr > 0] < 0).all()  # the camera looks down -z


def test_wide_aperture_vignettes_more():
    _, _, (wr, _, _), _ = _rays("torch", w=32, h=32, n=1024,
                                aperture_diameter=0.0005)
    _, _, (wr2, _, _), _ = _rays("torch", w=32, h=32, n=1024,
                                 aperture_diameter=0.02)
    assert float(wr.mean()) >= float(wr2.mean())
    assert float(wr2.mean()) < 1.0


def test_spectral_weights_average_to_white():
    lam = torch.linspace(380.0, 700.0, 2048)
    x, y, z = CP.cie_fit_xyz(lam)
    scale = 320.0 / 106.857
    r, g, b = CP.xyz_to_rgb(x * scale, y * scale, z * scale)
    assert abs(float(g.mean()) - 1.0) < 0.1
    assert 0.7 < float(r.mean()) < 1.4 and 0.7 < float(b.mean()) < 1.4


def test_spectral_mode_disperses():
    _, _, (wr, wg, wb), alive = _rays("torch", w=32, h=32, spectral=True)
    assert alive.mean() > 0.2
    assert np.std(wr[alive] - wb[alive]) > 1e-3


def test_render_sample_with_physical_camera():
    scene = cornell_scene(32, 32, max_depth=2)
    cam = scene.get_entity("camera")
    cam.use_physical_camera = True
    cam.physical.focal_length = 0.05
    cam.physical.image_plane_distance = 0.055
    cam.physical.aperture_diameter = 0.01
    cam.physical.sensor_width = 0.036
    scene.set_entity("camera", cam)
    r = Renderer(scene, device="cpu")
    assert r.config.use_physical_camera and r.device_camera.phys is not None
    r.render_samples(2)
    img = r.get_image()
    assert img.shape == (32, 32, 3) and np.isfinite(r.get_radiance()).all()
