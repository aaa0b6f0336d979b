"""``csrc/shading.cu`` on the CPU: each of its kernels (the camera ray, the
hit point, the shading frame, the BSDF's evaluation and its sample, the
stars) equals its plain PyTorch version bit for bit.

The source is compiled for the host by g++ against the kernel emulation
(``emu_build`` in ``test_torch_proto_gather.py``: each launch runs its grid
block by block, g++ told not to contract multiply-adds, as nvcc is by
``-fmad=false``), and driven through the port's own wrappers, so the
operand order and strides the wrappers pass are checked with the kernel.
The plain versions are the ones ``tests/test_torch_rounding.py`` holds
against the reference compiled with ``jax.jit``. Equal bit for bit except
that any NaN equals any NaN, and +0 equals -0 (PyTorch's clamp keeps or
drops a zero's sign by its vector width). The stars take ``exp``,
``atan2`` and ``arccos``, which the emulation computes with the host's
``expf``, ``atan2f`` and ``acosf``: their plain version runs with the torch
functions replaced by those (``host_exp`` of ``test_torch_clouds_source.py``,
``host_atan2_acos`` here), since PyTorch's CPU versions round otherwise on
some inputs. On the card the kernel's functions and ATen's are the same.
"""

import ctypes
import ctypes.util

import numpy as np
import pytest
import torch

from luminary_tpu_torch import kernels
from luminary_tpu_torch.ops import camera as TCam
from luminary_tpu_torch.ops import material as TM
from luminary_tpu_torch.ops import vec as TV
from luminary_tpu_torch.ops.ggx import ggx_energy_quad
from luminary_tpu_torch.ops.random import blue_base, quasi_2d, RandomTarget
from luminary_tpu_torch.ops.vec import Vec3
from luminary_tpu_torch.testing import clouds_scene, star_edge_directions
from test_torch_clouds_source import host_exp  # noqa: F401
from test_torch_proto_gather import emu_build

torch.set_num_threads(1)

N = 3000  # lanes: 47 blocks of the emulated 64 threads, the last one short


@pytest.fixture(scope="module")
def shading_emu(tmp_path_factory):
    """The port's wrappers on csrc/shading.cu built for the host."""
    lib = emu_build("shading", "", str(tmp_path_factory.mktemp("emu_shading")),
                    "#define THREADS 64\n", launch=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(kernels._libs, "shading", lib)
        yield


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == torch.bool:
        assert torch.equal(a, b)
        return
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    bad = (a != b) & ~nan
    assert not bool(bad.any()), (int(bad.sum()), a[bad][:4], b[bad][:4])


def _unit(rng, n):
    v = rng.standard_normal((n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _vec(a):
    return Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i], np.float32))
                  for i in range(3)))


def _lanes(seed):
    """Random lanes over every branch: metals, dielectrics, translucent and
    thin-walled lanes, roughness down to and below the minimum, view
    directions on both sides and grazing, a relative IOR on both sides of
    1, and a few degenerate normals and directions."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    ns = _unit(rng, N)
    wo = _unit(rng, N)
    flip = rng.random(N) < 0.8
    wo = np.where(((wo * ns).sum(1, keepdims=True) < 0) & flip[:, None], -wo, wo)
    graze = rng.random(N) < 0.1  # wo nearly in the tangent plane
    t = np.cross(ns, _unit(rng, N))
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    wo = np.where(graze[:, None], t + ns * 1e-4, wo)
    ns[:8] = [[0, 0, 1], [0, 0, -1], [0, 1, 0], [1, 0, 0], [0, 0, 1e-9],
              [0, 0, -1e-9], [0, 0, 1], [0, 0, 1]]
    wo[:8] = [[0, 0, 1], [0, 0, 1], [0, 1, 0], [0, 0, -1], [1, 0, 0],
              [0, 1, 0], [1e-20, 0, 1], [0, 0, 0]]
    rough = rng.uniform(0.0, 1.0, N)
    rough[:40] = [0.0, 0.025, 1.0, 1.2] * 10
    trans = rng.random(N) < 0.3
    mat = TM.LaneMaterial(
        albedo_r=rng.random(N).astype(f32), albedo_g=rng.random(N).astype(f32),
        albedo_b=rng.random(N).astype(f32), roughness=rough.astype(f32),
        metallic=(rng.random(N) < 0.3).astype(f32),
        ior=rng.uniform(1.0, 2.5, N).astype(f32), translucent=trans,
        opacity=np.ones(N, f32), thin_walled=trans & (rng.random(N) < 0.3))
    mat = TM.LaneMaterial(*(torch.as_tensor(v) for v in mat))
    r2 = torch.as_tensor(rng.random((N, 2)).astype(f32))
    r2[:4] = torch.tensor([[0.0, 0.0], [1.0, 1.0], [0.25, 0.999999], [0.5, 0.0]])
    return dict(mat=mat, ns=_vec(ns), wo=_vec(wo), wi=_vec(_unit(rng, N)),
                r_choice=torch.as_tensor(rng.random(N).astype(f32)), r2=r2,
                eta=torch.as_tensor(rng.uniform(0.5, 2.0, N).astype(f32)))


@pytest.mark.parametrize("seed", [41, 42])
def test_make_frame_source_equals_plain(shading_emu, seed):
    r = _lanes(seed)
    quad = torch.as_tensor(ggx_energy_quad())
    got = TM._make_frame_kernel(r["mat"], r["ns"], r["wo"], quad)
    want = TM._make_frame_plain(r["mat"], r["ns"], r["wo"], quad)
    for a, b in zip(TM._frame_ins(got), TM._frame_ins(want)):
        _same(a, b)


@pytest.mark.parametrize("seed", [43, 44])
def test_frame_eval_source_equals_plain(shading_emu, seed):
    r = _lanes(seed)
    quad = torch.as_tensor(ggx_energy_quad())
    fr = TM._make_frame_plain(r["mat"], r["ns"], r["wo"], quad)
    # the light directions of the integrator, and one direction shared by
    # every lane (a stride-0 operand)
    sun = Vec3(*(torch.tensor(c) for c in (0.3, 0.8, 0.52)))
    for wi in (r["wi"], sun):
        got = TM._frame_eval_kernel(r["mat"], fr, r["mat"].roughness, wi)
        want = TM._frame_eval_plain(r["mat"], fr, r["mat"].roughness,
                                    Vec3(*(c.expand(N) for c in wi)))
        for a, b in zip((*got[0], got[1]), (*want[0], want[1])):
            _same(a, b)


@pytest.mark.parametrize("seed", [45, 46, 47])
def test_material_sample_source_equals_plain(shading_emu, seed):
    r = _lanes(seed)
    quad = torch.as_tensor(ggx_energy_quad())
    fr = TM._make_frame_plain(r["mat"], r["ns"], r["wo"], quad)
    args = (r["mat"], fr, r["r_choice"], r["r2"], r["eta"])
    got = TM._material_sample_kernel(*args)
    want = TM._material_sample_plain(*args)
    for a, b in zip((*got[0], *got[1], got[2], got[4]),
                    (*want[0], *want[1], want[2], want[4])):
        _same(a, b)
    assert got[3] is r["mat"].translucent


def test_ray_point_source_equals_plain(shading_emu):
    rng = np.random.default_rng(48)
    o, d = _vec(rng.standard_normal((N, 3)) * 100), _vec(_unit(rng, N))
    t = torch.as_tensor((rng.random(N) * 10.0 ** rng.integers(-3, 4, N)).astype(
        np.float32))
    for a, b in zip(TV._ray_point_kernel(o, d, t), TV.ray_point_plain(o, d, t)):
        _same(a, b)


@pytest.mark.parametrize("aperture", ["closed", "round", "bladed"])
def test_camera_ray_source_equals_plain(shading_emu, aperture):
    """The clouds_32 camera (closed aperture) and the same camera with an
    open round or bladed aperture, two samples each, every pixel."""
    w = h = 32
    cam = TCam.pack_camera(clouds_scene().camera, device="cpu")
    if aperture != "closed":
        cam = cam._replace(aperture_size=torch.tensor(0.4),
                           aperture_shape_bladed=torch.tensor(aperture == "bladed"),
                           object_distance=torch.tensor(7.5))
    lane = torch.arange(w * h, dtype=torch.int32)
    px, py = lane % w, lane // w
    pid = (py.long() * w + px.long()) & 0xFFFFFFFF
    bn = blue_base(px, py)
    for s in (0, 9):
        sid = torch.tensor(s, dtype=torch.int64)
        jitter = quasi_2d(RandomTarget.CAMERA_JITTER,
                          torch.zeros((1,), dtype=torch.int64), sid).reshape(-1)
        ap = TCam._sample_aperture(cam, pid, sid, bn=bn)
        got = TCam._camera_ray_kernel(cam, w, h, px, py, jitter, ap)
        want = TCam._camera_ray_plain(cam, w, h, px, py, jitter, ap)
        for a, b in zip((*got[0], *got[1]), (*want[0], *want[1])):
            _same(a, b)


@pytest.fixture(scope="module")
def host_atan2_acos():
    """``torch.atan2`` and ``torch.arccos`` through the host's ``atan2f`` and
    ``acosf``, element by element."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    for name, n_args in (("atan2f", 2), ("acosf", 1)):
        getattr(libm, name).restype = ctypes.c_float
        getattr(libm, name).argtypes = [ctypes.c_float] * n_args
    vatan2 = np.frompyfunc(libm.atan2f, 2, 1)
    vacos = np.frompyfunc(libm.acosf, 1, 1)

    def host(f, *xs):
        a = [x.detach().numpy() for x in xs]
        return torch.as_tensor(f(*a).astype(np.float32).reshape(a[0].shape))
    return (lambda y, x: host(vatan2, y, x)), (lambda x: host(vacos, x))


def test_stars_source_equals_plain(shading_emu, host_exp,  # noqa: F811
                                   host_atan2_acos):
    """Directions within ~2e-4 rad of the stars of 64 random cells, random
    ones (no star near), and ones whose grid coordinate u or v lies within 4
    ulps of a cell edge k/64 (where the kernel's own cell could part from
    the plain version's by a cell): the fused dot with an intensity tensor,
    the op-by-op dot (the HDRI bake's) with a host float."""
    from types import SimpleNamespace

    from luminary_tpu_torch.ops import sky as TS

    rng = np.random.default_rng(49)
    g = TS.STARS_GRID
    cells = torch.as_tensor(rng.integers(0, g * g, 64))
    h0 = TS._hash_u32((cells * 0x9E3779B9 + 7) & 0xFFFFFFFF)
    su = ((cells % g).double() + TS._hash01((h0 + 1) & 0xFFFFFFFF).double()) / g
    sv = ((cells // g).double() + TS._hash01((h0 + 2) & 0xFFFFFFFF).double()) / g
    phi, theta = (su - 0.5) * 2.0 * np.pi, sv * np.pi
    star = torch.stack([torch.cos(phi) * torch.sin(theta), torch.cos(theta),
                        torch.sin(phi) * torch.sin(theta)], -1).numpy()
    d = np.concatenate([np.repeat(star, 40, 0)
                        + rng.standard_normal((64 * 40, 3)) * 2e-4,
                        _unit(rng, 440)])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    edges = star_edge_directions(per_edge=40, seed=50)
    dv = _vec(np.concatenate([d, edges]))
    atan2, arccos = host_atan2_acos
    for intensity, fused, seed in ((torch.tensor(1.5), True, 7),
                                   (0.75, False, 0xDEADBEEF)):
        sky = SimpleNamespace(stars_seed=seed, stars_count=10000,
                              stars_intensity=intensity)
        got = TS._stars_kernel(sky, dv, fused)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch, "exp", host_exp)
            mp.setattr(torch, "atan2", atan2)
            mp.setattr(torch, "arccos", arccos)
            want = TS._stars_radiance_plain(sky, dv, fused)
            gx, gy, _ = TS._star_cell(sky, dv)
        for a, b in zip(got, want):
            _same(a, b)
        if seed == 7:
            assert float((want[1][:len(d)] > 1e-3).float().mean()) > 0.5
    # the edge lanes straddle their edges: the cells on both sides of every
    # u edge are taken, and of the v edges float32 reaches away from the poles
    e = slice(len(d), None)
    assert len(edges) > 4000
    assert len(np.unique(gx[e].numpy())) == g
    assert len(np.unique(gy[e].numpy())) >= g - 4
