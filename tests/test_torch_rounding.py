"""The port's rounding of the camera ray, the bounce and the hit point against
the JAX package's compiled code, bit for bit, on the ``clouds_32`` golden
scene (32x32 pixels, 64 samples: 65,536 lanes).

XLA's CPU back end contracts a float32 product that has one use into the add
or subtract that consumes it: a fused multiply-add, rounded once. The port
rounds those sites the same way (``ops/vec.py`` ``fma32``, a float32 fused
multiply-add computed in float64 and rounded once). Which products fuse was
read from the compiled camera and bounce (``XLA_FLAGS=--xla_dump_to``: each
fusion's optimized LLVM IR, where x86 instruction selection fuses an
``fmul`` whose one use is an ``fadd``/``fsub``, the add's first operand where
both are such products). The camera and the bounce, each compiled alone,
equal the full render's bits (checked by capturing the full render's walk
inputs per depth). The compiled code's float32 sin and cos are glibc's
``sinf``/``cosf``, which the port copies (``ops/libm.py``).

Inputs are captured from the port's own ``clouds_32`` render, whose camera
rays the first test holds equal to the reference's; the bounce is also held
on random normals, view directions and roughness, which the scene's ground
plane (normal +y, roughness 1) does not exercise.
"""

import ctypes
import ctypes.util
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import luminary_tpu.ops.ggx as JG
from luminary_tpu.ops import camera as JCam
from luminary_tpu.ops import material as JM
from luminary_tpu.ops.random import blue_base as j_blue_base
from luminary_tpu.ops.vec import Vec3 as JV
import luminary_tpu_torch.render.wavefront as TW
from luminary_tpu_torch.ops import camera as TCam
from luminary_tpu_torch.ops import material as TM
from luminary_tpu_torch.ops.ggx import ggx_energy_quad
from luminary_tpu_torch.ops import libm
from luminary_tpu_torch.ops.libm import cosf, sinf
from luminary_tpu_torch.ops.random import blue_base
from luminary_tpu_torch.ops.vec import Vec3, fma32, fma32_plain, ray_point
from luminary_tpu_torch.render.renderer import Renderer
from luminary_tpu_torch.testing import clouds_scene
from test_golden import _scenes
from test_torch_proto_gather import emu_build

torch.set_num_threads(1)

W = H = 32


def _bits_equal(a, b):
    return np.array_equal(np.asarray(a).view(np.int32),
                          np.asarray(b).view(np.int32))


def test_fma32_rounds_once():
    """fma32 is the exactly rounded float32 a * b + c, also where float64's
    own rounding would land on a float32 tie (rounding twice gives 1)."""
    rng = np.random.default_rng(31)
    a, b = (rng.standard_normal(2000).astype(np.float32) for _ in range(2))
    c = (rng.standard_normal(2000) * 2.0 ** rng.integers(-30, 30, 2000)).astype(
        np.float32)
    got = fma32(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c)).numpy()
    for i in range(2000):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        want = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.asarray(v).view(np.int32)) & 1))
        assert got[i] == want, i
    tie = fma32(torch.tensor([2.0 ** -12 * (1 + 2.0 ** -23)]),
                torch.tensor([-(2.0 ** -12) * (1 - 2.0 ** -23)]),
                torch.tensor([1 + 2.0 ** -23]))
    assert tie.item() == 1 + 2.0 ** -23


def test_libm_sin_cos_equal_the_c_library():
    """ops/libm.py's sinf and cosf equal the C library's (glibc's, which
    XLA's CPU code calls) on every argument here: below and above 120 (the
    two reductions), tiny, huge, signed, and near multiples of pi/2."""
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    rng = np.random.default_rng(32)
    near = (np.arange(1, 400) * (np.pi / 2)).astype(np.float32)
    x = np.concatenate([
        rng.random(20000, dtype=np.float32) * np.float32(2 * np.pi),
        (rng.random(10000, dtype=np.float32) * 2 - 1) * np.float32(119),
        (rng.random(10000, dtype=np.float32) * 2 - 1) * np.float32(1e5),
        (rng.random(2000, dtype=np.float32) * 2 - 1) * np.float32(3e38),
        np.float32(2.0) ** rng.uniform(-20, 30, 4000).astype(np.float32),
        near, -near, np.nextafter(near, np.float32(0)),
        np.array([0.0, -0.0, 0.75, -0.75, 120.0, -120.0, 2.0 ** -12], np.float32),
    ]).astype(np.float32)
    for name, fn in (("sinf", sinf), ("cosf", cosf)):
        f = getattr(lib, name)
        f.restype, f.argtypes = ctypes.c_float, [ctypes.c_float]
        want = np.array([f(float(v)) for v in x], np.float32)
        got = fn(torch.as_tensor(x).reshape(2, -1)).reshape(-1).numpy()
        assert _bits_equal(got, want), (name, x[got != want][:5])
        # the card's plain version: glibc's fused multiply-adds on every element
        every = libm.glibc_exact(torch.as_tensor(x), name == "cosf").numpy()
        assert _bits_equal(every, want), (name, x[every != want][:5])


def test_fma32_kernel_source_equals_plain(tmp_path):
    """csrc/fma32.cu (the card's fma32) compiled for the host against the
    kernel emulation equals fma32_plain bit for bit, full operands and
    scalar ones (stride 0, and by value)."""
    emu = emu_build("fma32", "", str(tmp_path), launch=True)
    p, i64, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    emu.lum_fma32.argtypes = [p, i64, f32, p, i64, f32, p, i64, f32, p, i64, p]
    rng = np.random.default_rng(35)
    n = 5000
    a, b = (torch.as_tensor(rng.standard_normal(n).astype(np.float32)) for _ in "ab")
    c = torch.as_tensor((rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n))
                        .astype(np.float32))
    one = torch.tensor([1.5], dtype=torch.float32)
    for args, want in (((a, 1, 0.0, b, 1, 0.0, c, 1, 0.0), fma32_plain(a, b, c)),
                       ((one, 0, 0.0, b, 1, 0.0, None, 0, -0.25),
                        fma32_plain(1.5, b, -0.25))):
        out = torch.empty(n)
        ptrs = [x.data_ptr() if isinstance(x, torch.Tensor) else x for x in args]
        assert emu.lum_fma32(*ptrs, out.data_ptr(), n, None) == 0
        assert _bits_equal(out.numpy(), want.numpy())


def test_libm_kernel_source_equals_the_c_library(tmp_path):
    """csrc/libm_sincos.cu (the card's sinf / cosf) compiled for the host
    against the kernel emulation, through its own C entry point, equals the
    C library bit for bit, below and above 120, tiny and huge."""
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    emu = emu_build("libm_sincos", "", str(tmp_path), launch=True)
    emu.lum_libm_sincos.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_void_p]
    rng = np.random.default_rng(34)
    x = np.concatenate([
        rng.random(3000, dtype=np.float32) * np.float32(2 * np.pi),
        (rng.random(3000, dtype=np.float32) * 2 - 1) * np.float32(1e5),
        np.float32(2.0) ** rng.uniform(-20, 120, 1000).astype(np.float32),
        np.array([0.0, -0.0, 0.75, -0.75, 119.99999, 120.0, -120.0, 2.0 ** -12],
                 np.float32),
    ]).astype(np.float32)
    for name in ("sinf", "cosf"):
        f = getattr(lib, name)
        f.restype, f.argtypes = ctypes.c_float, [ctypes.c_float]
        want = np.array([f(float(v)) for v in x], np.float32)
        t = torch.as_tensor(x)
        out = torch.empty_like(t)
        assert emu.lum_libm_sincos(t.data_ptr(), out.data_ptr(), t.numel(),
                                   int(name == "cosf"), None) == 0
        assert _bits_equal(out.numpy(), want), (name, x[out.numpy() != want][:5])


def test_camera_rays_equal_compiled_reference():
    """The clouds_32 camera's origins and directions, all 64 samples, equal
    the reference's ``generate_camera_rays`` compiled with ``jax.jit``."""
    jcam = JCam.pack_camera(_scenes()["clouds_32"].camera)
    tcam = TCam.pack_camera(clouds_scene().camera, device="cpu")
    lane = np.arange(W * H, dtype=np.int32)
    px, py = lane % W, lane // W

    @jax.jit
    def ref(cam, px, py, sid):
        pid = py.astype(jnp.uint32) * jnp.uint32(W) + px.astype(jnp.uint32)
        return JCam.generate_camera_rays(cam, W, H, px, py, pid, sid,
                                         bn=j_blue_base(px, py))

    tpx, tpy = torch.as_tensor(px), torch.as_tensor(py)
    pid = (tpy.long() * W + tpx.long()) & 0xFFFFFFFF
    bn = blue_base(tpx, tpy)
    for s in range(64):
        o, d = TCam.generate_camera_rays(tcam, W, H, tpx, tpy, pid,
                                         torch.tensor(s, dtype=torch.int64), bn=bn)
        jo, jd = ref(jcam, jnp.asarray(px), jnp.asarray(py), jnp.uint32(s))
        for a, b in zip((*o, *d), (*jo, *jd)):
            assert _bits_equal(a.numpy(), b), s


@pytest.fixture(scope="module")
def clouds_sample():
    """One sample of the port's clouds_32 render: each closest walk's inputs
    and, at depth 0, the main bounce's inputs and sampled direction."""
    walks, bounces = [], []
    trace, sample = TW.trace_closest, TW.material_sample

    def trace_rec(bvh, origin, direction, *a, **k):
        hit = trace(bvh, origin, direction, *a, **k)
        walks.append((origin, direction, k.get("active"), hit.t))
        return hit

    def sample_rec(mat, fr, ns, wo, pixel_id, sample_id, depth, eta_rel=None,
                   bn=None):
        out = sample(mat, fr, ns, wo, pixel_id, sample_id, depth, eta_rel=eta_rel,
                     bn=bn)
        if depth == 0 and eta_rel is not None:
            bounces.append(dict(mat=mat, ns=ns, wo=wo, pid=pixel_id,
                                sid=sample_id, eta=eta_rel, fr=fr, wi=out[0]))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TW, "trace_closest", trace_rec)
        mp.setattr(TW, "material_sample", sample_rec)
        Renderer(clouds_scene(), chunk=1 << 20, device="cpu").render_samples(1)
    return walks, bounces[0]


def test_hit_point_equals_compiled_reference(clouds_sample):
    """The integrator's hit point at depth 0 equals the reference's
    ``origin + direction * t`` compiled, and it is what the next walk starts
    from (off the ground plane by 1e-3 along its normal +y)."""
    walks, _ = clouds_sample
    (o, d, act, t), (o1, _, _, _) = walks[0], walks[1]
    hit = act & (t < 1e9)
    assert 400 < int(hit.sum()) < W * H
    ts = torch.where(hit, t, 1.0)
    ref = jax.jit(lambda o, d, t: tuple(oc + dc * t for oc, dc in zip(o, d)))(
        tuple(jnp.asarray(c.numpy()) for c in o),
        tuple(jnp.asarray(c.numpy()) for c in d), jnp.asarray(ts.numpy()))
    got = ray_point(o, d, ts)
    for a, b in zip(got, ref):
        assert _bits_equal(a.numpy(), b)
    off = torch.tensor([0.0, 1e-3, 0.0])
    for c in range(3):
        assert torch.equal(o1[c][hit], (got[c] + off[c])[hit]), c


def _random_bounce(n=4096, seed=33):
    rng = np.random.default_rng(seed)
    ns = rng.standard_normal((n, 3))
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    wo = rng.standard_normal((n, 3))
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    wo = np.where((wo * ns).sum(1, keepdims=True) < 0, -wo, wo)
    f32 = np.float32
    mat = TM.LaneMaterial(
        albedo_r=rng.random(n).astype(f32), albedo_g=rng.random(n).astype(f32),
        albedo_b=rng.random(n).astype(f32),
        roughness=rng.uniform(0.05, 1.0, n).astype(f32),
        metallic=(rng.random(n) < 0.3).astype(f32), ior=np.full(n, 1.5, f32),
        translucent=np.zeros(n, bool), opacity=np.ones(n, f32),
        thin_walled=np.zeros(n, bool))
    mat = TM.LaneMaterial(*(torch.as_tensor(v) for v in mat))

    def vec(a):
        return Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i], f32))
                      for i in range(3)))

    return dict(mat=mat, ns=vec(ns), wo=vec(wo),
                pid=torch.as_tensor(rng.integers(0, W * H, n)),
                sid=torch.tensor(5, dtype=torch.int64),
                eta=torch.full((n,), 1.5))


@pytest.mark.parametrize("inputs", ["clouds_32", "random"])
def test_bounce_equals_compiled_reference(clouds_sample, inputs):
    """The shading frame (``make_frame``) and the main bounce's sampled
    direction (``material_sample``: the bounded-VNDF GGX lobe and the
    diffuse lobe) equal the reference's, compiled together with ``jax.jit``:
    on the clouds_32 render's depth-0 hits (all on its ground plane, whose
    hits took the wrong bits in ~27 % of lanes before), and on random
    normals, view directions and roughness."""
    JG.ggx_energy_lut()  # cached outside the trace
    r = clouds_sample[1] if inputs == "clouds_32" else _random_bounce()
    fr = (r["fr"] if inputs == "clouds_32" else
          TM.make_frame(r["mat"], r["ns"], r["wo"], torch.as_tensor(ggx_energy_quad())))
    pid = r["pid"]
    bn = blue_base((pid % W).to(torch.int32), (pid // W).to(torch.int32))
    wi = TM.material_sample(r["mat"], fr, r["ns"], r["wo"], pid, r["sid"], 0,
                            eta_rel=r["eta"], bn=bn)[0]
    if inputs == "clouds_32":
        for a, b in zip(wi, r["wi"]):
            assert torch.equal(a, b)

    @jax.jit
    def ref(mat, ns, wo, pid, sid, eta):
        px, py = (pid % W).astype(jnp.int32), (pid // W).astype(jnp.int32)
        jfr = JM.make_frame(mat, ns, wo)
        return jfr, JM.material_sample(mat, jfr, ns, wo, pid, sid, 0, eta_rel=eta,
                                       bn=j_blue_base(px, py))[0]

    def jvec(v):
        return JV(*(jnp.asarray(c.numpy()) for c in v))

    jfr, jwi = ref(JM.LaneMaterial(*(jnp.asarray(c.numpy()) for c in r["mat"])),
                   jvec(r["ns"]), jvec(r["wo"]),
                   jnp.asarray(pid.numpy().astype(np.uint32)),
                   jnp.uint32(int(r["sid"])), jnp.asarray(r["eta"].numpy()))
    for name in ("t", "b", "wo_l"):
        for a, b in zip(getattr(fr, name), getattr(jfr, name)):
            assert _bits_equal(a.numpy(), b), name
    assert _bits_equal(fr.p_spec.numpy(), jfr.p_spec)
    for a, b in zip(wi, jwi):
        assert _bits_equal(a.numpy(), b)


# the miss directions of two clouds_32 lanes whose sky radiance parted from
# the reference's by 60-125 % (pixel (x 3, y 12) at sample 26, (16, 30) at
# sample 9): each lies within a star's glow, as float32 bits
_STAR_LANES = ((0xbf2a729b, 0x3f3da2bd, 0x3db6c294),
               (0xbd912e80, 0x3f7c0dce, 0x3e23bb06))


def test_stars_equal_compiled_reference():
    """The star field equals the reference's ``stars_radiance`` compiled
    with ``jax.jit`` within 1e-5 (relative): at the two clouds_32 lanes, and
    at 40 directions within ~2e-4 rad of every cell's star. A star is a
    Gaussian of 3e-4 rad whose angle comes from ``1 - cos``, so one ulp of
    the cosine moves its glow by ~30 %: the port takes glibc's ``sinf`` /
    ``cosf`` for the star direction and XLA's contraction of the dot,
    fma(z, z', fma(y, y', x x')). What is left is the ``exp`` of the glow,
    XLA's against PyTorch's, an ulp apart (9e-7 measured)."""
    from types import SimpleNamespace

    from luminary_tpu.ops import sky as JS
    from luminary_tpu_torch.ops import sky as TS

    g = TS.STARS_GRID
    cells = torch.arange(g * g)
    h0 = TS._hash_u32((cells * 0x9E3779B9) & 0xFFFFFFFF)
    su = ((cells % g).double() + TS._hash01((h0 + 1) & 0xFFFFFFFF).double()) / g
    sv = ((cells // g).double() + TS._hash01((h0 + 2) & 0xFFFFFFFF).double()) / g
    phi, theta = (su - 0.5) * 2.0 * np.pi, sv * np.pi
    star = torch.stack([torch.cos(phi) * torch.sin(theta), torch.cos(theta),
                        torch.sin(phi) * torch.sin(theta)], -1).numpy()
    rng = np.random.default_rng(34)
    d = np.repeat(star, 40, 0) + rng.standard_normal((g * g * 40, 3)) * 2e-4
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lanes = np.asarray(_STAR_LANES, np.uint32).view(np.float32)
    d = np.concatenate([lanes, d.astype(np.float32)])
    sky_t = SimpleNamespace(stars_seed=0, stars_count=10000,
                            stars_intensity=torch.tensor(1.0))
    sky_j = SimpleNamespace(stars_seed=jnp.uint32(0), stars_count=jnp.int32(10000),
                            stars_intensity=jnp.float32(1.0))
    got = TS.stars_radiance(sky_t, Vec3(*(torch.as_tensor(
        np.ascontiguousarray(d[:, i])) for i in range(3))))
    ref = jax.jit(lambda x, y, z: JS.stars_radiance(sky_j, JV(x, y, z)))(
        *(jnp.asarray(d[:, i]) for i in range(3)))
    for a, b in zip(got, ref):
        a, b = a.numpy(), np.asarray(b)
        assert (b[:2] > 0.01).all() and (b > 1e-3).mean() > 0.9
        rel = np.abs(a - b) / np.maximum(b, 1e-30)
        assert rel.max() < 1e-5, (rel.max(), int(np.argmax(rel)))
