"""``csrc/clouds.cu`` on the CPU: the cloud density, the march of a layer and
the cloud shadows equal their plain PyTorch versions bit for bit.

The source is compiled for the host by g++ against the kernel emulation
(``emu_build`` in ``test_torch_proto_gather.py``: each launch runs its grid
block by block, g++ told not to contract multiply-adds, as nvcc is by
``-fmad=false``) and driven through the port's own wrappers
(``ops/clouds.py`` ``_cloud_march_kernel``, ``_cloud_sun_transmittance_kernel``),
so the operand order and strides the wrappers pass are checked with the
kernels. The density, with the fused hash (the march's step), the flat rule
(the weather FBM's first octave) and the plain hash (the shadows), goes
through a C entry added here.

Rule: bit for bit. The march and the shadows take ``exp``, which the kernel
on the emulation computes with the host's ``expf`` (glibc's) and the plain
version with PyTorch's CPU kernel, which rounds otherwise on some inputs;
those cases run the plain version with ``torch.exp`` replaced by the host's
``expf``, the one function that differs. On the card the kernel's ``expf``
and PyTorch's ``exp`` are the same function (``chip_smoke.py`` phase 9
holds the kernels against their plain versions there, bit for bit).

About 4 s with one worker.
"""

import ctypes
import ctypes.util
import dataclasses

import numpy as np
import pytest
import torch

from luminary_tpu_torch import kernels
from luminary_tpu_torch.ops import clouds as C
from luminary_tpu_torch.ops.vec import Vec3
from luminary_tpu_torch.testing import clouds_scene
from test_torch_proto_gather import emu_build

torch.set_num_threads(1)

_DENSITY_ENTRY = r"""
extern "C" void emu_density(const Clouds* cl, int layer, int mode, const float* x,
                            const float* y, const float* z, long long n, float* out) {
  for (long long i = 0; i < n; ++i)
    out[i] = mode == 0 ? cloud_density<false>(*cl, layer, x[i], y[i], z[i])
           : mode == 1 ? cloud_density<true>(*cl, layer, x[i], y[i], z[i])
                       : value_noise3<true, true>(x[i], y[i], z[i]);
}
"""


@pytest.fixture(scope="module")
def clouds_emu(tmp_path_factory):
    """The port's wrappers on csrc/clouds.cu built for the host."""
    lib = emu_build("clouds", _DENSITY_ENTRY,
                    str(tmp_path_factory.mktemp("emu_clouds")),
                    "#define THREADS 64\n", launch=True)
    p = ctypes.c_void_p
    lib.emu_density.argtypes = [ctypes.POINTER(C._Clouds), ctypes.c_int, ctypes.c_int,
                                p, p, p, ctypes.c_longlong, p]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(kernels._libs, "clouds", lib)
        yield lib


@pytest.fixture(scope="module")
def host_exp():
    """``torch.exp`` through the host's ``expf``, element by element."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.expf.restype = ctypes.c_float
    libm.expf.argtypes = [ctypes.c_float]
    vexp = np.frompyfunc(libm.expf, 1, 1)

    def exp(x):
        a = x.detach().numpy()
        return torch.as_tensor(vexp(a).astype(np.float32).reshape(a.shape))
    return exp


def _clouds():
    """clouds_32's clouds with all three layers dense enough to light steps,
    an offset and a seed."""
    cl = C.pack_clouds(clouds_scene().cloud)
    return dataclasses.replace(cl, coverage=(2.5, 3.0, 2.0),
                               coverage_min=(0.1, 0.0, 0.2), density=0.8,
                               offset=(3.5, -7.25), seed=517.0)


def _vec(a):
    return Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i], np.float32))
                  for i in range(3)))


def _same(a, b):
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    bad = (a != b) & ~nan
    assert not bool(bad.any()), (int(bad.sum()), a[bad][:4], b[bad][:4])


def _rays(n, seed):
    """Ray origins on and above the ground, directions up at every angle,
    some level (their span through a layer is 0 or huge) and some down
    (no span), with per-lane sky ambient."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-3000, 3000, n), rng.uniform(0, 3000, n),
                  rng.uniform(-3000, 3000, n)], -1)
    o[:n // 8, [0, 2]] *= 1e-3  # near the origin: hash arguments below 120
    d = rng.standard_normal((n, 3))
    d[:, 1] = np.abs(d[:, 1]) + 0.02
    d[:8, 1] = 0.0  # level
    d[8:16, 1] *= -1.0  # down
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    amb = tuple(torch.as_tensor((rng.random(n) * 0.1).astype(np.float32))
                for _ in range(3))
    return _vec(o), _vec(d), amb


_SUN = Vec3(*(torch.tensor(c) for c in np.asarray([0.3, 0.8, 0.2], np.float32)
              / np.float32(np.linalg.norm([0.3, 0.8, 0.2]))))
_SUN_RAD = torch.tensor([18000.0, 17000.0, 16000.0])


@pytest.mark.parametrize("case", [
    "density", "march-low-8", "march-mid-48", "march-top-96",
    "march-all-48", "shadow"])
def test_clouds_source_equals_plain(clouds_emu, host_exp, case):
    cl = _clouds()
    if case == "density":
        rng = np.random.default_rng(50)
        n = 2000
        p = np.stack([rng.uniform(-4000, 4000, n), rng.uniform(1400, 5200, n),
                      rng.uniform(-4000, 4000, n)], -1)
        p[:500, [0, 2]] *= 1e-2  # hash arguments below 120
        pos = _vec(p)
        out = torch.empty(n)
        c_cl = C._clouds_struct(cl)
        plain = (C.cloud_density(cl, pos, 0), C.cloud_density(cl, pos, 0, fused=True))
        flat = Vec3(pos.x * 1e-3, torch.zeros(n), pos.z * 1e-3)
        for mode, (q, want) in enumerate(((pos, plain[0]), (pos, plain[1]),
                                          (flat, C.value_noise3(flat, True, True)))):
            clouds_emu.emu_density(ctypes.byref(c_cl), 0, mode,
                                   *(c.data_ptr() for c in q), n, out.data_ptr())
            _same(out, want)
        assert 0.05 < float((plain[1] > 0).float().mean()) < 0.95
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "exp", host_exp)
        if case == "shadow":
            p = _rays(600, 51)[0]
            for layers in ((0,), (0, 1, 2)):
                got = C._cloud_sun_transmittance_kernel(cl, p, _SUN, layers, 3)
                want = C._cloud_sun_transmittance_plain(cl, p, _SUN, layers, 3)
                _same(got, want)
                assert float(want.min()) < 0.9
            return
        _, which, steps = case.split("-")
        layers = {"low": (0,), "mid": (1,), "top": (2,), "all": (0, 1, 2)}[which]
        o, d, amb = _rays(160 if steps == "96" else 240, int(steps))
        args = (cl, o, d, _SUN, _SUN_RAD, amb, int(steps), 4, layers)
        got = C._cloud_march_kernel(*args)
        want = C._cloud_march_plain(*args)
        for a, b in zip((*got[0], got[1]), (*want[0], want[1])):
            _same(a, b)
        # lanes without a span, lanes with light, lanes that keep some
        assert bool((want[1] == 1.0).any()) and float(want[0][0].max()) > 0.0
        assert bool(((want[1] > 0.0) & (want[1] < 1.0)).any())
