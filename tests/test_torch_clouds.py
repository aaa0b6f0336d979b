"""Clouds against the JAX package (``luminary_tpu/ops/clouds.py``) on the
same numpy inputs from a seed.

The lattice hash is ``fract(sin(h) * 43758.5453)``: one ulp of h gives a
new hash. XLA's CPU code contracts h = px * 127.1 + py * 311.7 + pz * 74.7
into fused multiply-adds wherever each product has one use: in the step
of the compiled ``cloud_march`` (each corner hash is a fusion of its own)
but not in its shadow march or in ``cloud_sun_transmittance`` (one fusion
of all the hashes, whose products are shared); eager ops never contract.
The port rounds h the same way at each site (``fused``). XLA's sin is the
C library's ``sinf`` (glibc's, not correctly rounded: one ulp apart from the
correctly rounded sin on ~1.3 % of arguments, which moves a hash by ~3e-3
or, where the product lies that close to an integer, wraps it); the port
takes a copy of it (``ops/libm.py``).

Measured on an x86 CPU over 4096 random points (eager JAX against the
port's plain rounding): ``cloud_density`` equal on every point (it read
mean |diff| 6e-6, max 0.0056 with the correctly rounded sin). Held as mean
|diff| < 2e-4, under 2 % of points beyond 1e-3, density max < 0.02. The
fused hash equals the compiled ``_hash3`` on every lattice point (it read
0.3 % apart with the correctly rounded sin), against 25 % apart for the
plain rounding. The march against the compiled ``cloud_march`` at 1024
lanes, 16 steps: 68 % of lanes bit-equal, transmittance mean |diff| 7.2e-8
(max 1.7e-6), radiance means within 4.4e-7 (with the step's position
rounded op by op it read 2.6e-7, 3.5e-5 and 7e-7; with the correctly
rounded sin 2.4e-5 and 0.004 %).
Held as transmittance mean |diff| < 2e-4, under 1 % of lanes beyond 1e-3
in transmittance and in radiance, the means within 0.1 %.
``cloud_sun_transmittance`` (plain) agrees lane by lane within 0.02.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from luminary_tpu.ops import clouds as JC
from luminary_tpu.ops.vec import Vec3 as JVec3
from luminary_tpu.scene.entities import Cloud as JCloud
from luminary_tpu_torch.ops import clouds as C
from luminary_tpu_torch.ops.vec import Vec3
from luminary_tpu_torch.scene.entities import Cloud

torch.set_num_threads(1)

N = 4096


def _cloud(cls, **kw):
    c = cls(active=True)
    c.low.active = True
    c.low.height_min, c.low.height_max, c.low.coverage = 1000.0, 2000.0, 2.0
    c.mid.active = kw.pop("mid", False)
    for k, v in kw.items():
        setattr(c, k, v)
    return c


def _clouds(**kw):
    return (jax.device_put(JC.pack_clouds(_cloud(JCloud, **dict(kw)))),
            C.pack_clouds(_cloud(Cloud, **kw)))


def _vec(a):
    return (JVec3(*(jnp.asarray(np.ascontiguousarray(a[:, i])) for i in range(3))),
            Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i])) for i in range(3))))


def _close_in_bulk(got, ref):
    d = np.abs(np.asarray(got) - np.asarray(ref))
    assert d.mean() < 2e-4, d.mean()
    assert np.mean(d > 1e-3) < 0.02, np.mean(d > 1e-3)


@pytest.mark.parametrize("kw", [dict(), dict(mid=True, seed=2000, offset_x=3.5),
                                dict(active=False)])
def test_pack_clouds_matches_reference(kw):
    j, t = _clouds(**kw)
    assert t.active == bool(j.active)
    for k in ("height_min", "height_max", "coverage", "coverage_min", "offset"):
        assert np.array_equal(np.float32(getattr(t, k)), np.asarray(getattr(j, k))), k
    for k in ("density", "shape_scale", "detail_scale", "weather_scale", "seed"):
        assert np.float32(getattr(t, k)) == np.float32(getattr(j, k)), k
    assert (C.active_layer_indices(_cloud(Cloud, **kw))
            == JC.active_layer_indices(_cloud(JCloud, **kw)))


@pytest.mark.parametrize("scale", [1.0, 50.0, 2000.0])
def test_value_noise3_matches_reference(scale):
    p = (np.random.default_rng(1).uniform(-1, 1, (N, 3)) * scale).astype(np.float32)
    pj, pt = _vec(p)
    got = C.value_noise3(pt).numpy()
    ref = np.asarray(JC.value_noise3(pj))
    _close_in_bulk(got, ref)
    assert got.min() >= 0.0 and got.max() <= 1.0 and got.std() > 0.05
    f = C.fbm3(pt).numpy()
    _close_in_bulk(f, np.asarray(JC.fbm3(pj)))


def test_cloud_density_matches_reference():
    cj, ct = _clouds()
    p = (np.random.default_rng(2).random((N, 3)) * [8000, 1200, 8000]
         + [0, 900, 0]).astype(np.float32)
    pj, pt = _vec(p)
    got = C.cloud_density(ct, pt).numpy()
    ref = np.asarray(JC.cloud_density(cj, pj))
    _close_in_bulk(got, ref)
    assert np.abs(got - ref).max() < 0.02
    assert ref.max() > 0.1 and (ref == 0.0).mean() > 0.5


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = np.stack([rng.random(n) * 6000, np.full(n, 1.0), rng.random(n) * 6000],
                 -1).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[:, 1] = np.abs(d[:, 1]) + 0.05
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    amb = (rng.random((3, n)) * 0.1).astype(np.float32)
    return o, d.astype(np.float32), amb


_SUN = np.asarray([0.3, 0.8, 0.2], np.float32) / np.float32(
    np.linalg.norm([0.3, 0.8, 0.2]))
_SUN_RAD = np.asarray([18000.0, 17000.0, 16000.0], np.float32)


def test_cloud_march_matches_reference():
    """The port's march against the JAX package's compiled march, lane by
    lane: transmittance and radiance."""
    cj, ct = _clouds()
    n, steps = 1024, 16
    o, d, amb = _rays(n, 3)
    (oj, ot), (dj, dt) = _vec(o), _vec(d)
    sun_j = JVec3(*(jnp.float32(c) for c in _SUN))
    sun_t = Vec3(*(torch.tensor(float(c)) for c in _SUN))
    (rt, gt, bt), tt = C.cloud_march(ct, ot, dt, sun_t, torch.as_tensor(_SUN_RAD),
                                     tuple(torch.as_tensor(a) for a in amb),
                                     steps=steps, layers=(0,))
    (rc, gc, bc), tc = jax.jit(lambda cl, o_, d_, s_, r_, a_: JC.cloud_march(
        cl, JVec3(*o_), JVec3(*d_), JVec3(*s_), r_, a_, steps=steps,
        layers=(0,)))(cj, tuple(oj), tuple(dj), tuple(sun_j),
                      jnp.asarray(_SUN_RAD), tuple(jnp.asarray(a) for a in amb))
    tc = np.asarray(tc)
    d_t = np.abs(tt.numpy() - tc)
    assert d_t.mean() < 2e-4 and np.mean(d_t > 1e-3) < 0.01, (
        d_t.mean(), np.mean(d_t > 1e-3))
    assert 0.05 < 1.0 - tc.mean() < 0.95
    for a, b in zip((rt, gt, bt), (rc, gc, bc)):
        a, b = a.numpy(), np.asarray(b)
        assert np.mean(np.abs(a - b) > 1e-3 * b.max()) < 0.01
        assert abs(a.mean() - b.mean()) < 1e-3 * b.mean(), (a.mean(), b.mean())


def test_fused_hash_matches_compiled_reference():
    """The fused rounding of h and glibc's sinf equal the JAX package's
    compiled ``_hash3`` (a fusion of its own, as in the march's step) on
    every lattice point; the plain rounding parts from it."""
    p = np.floor(np.random.default_rng(6).uniform(-1, 1, (N, 3)) * 2000.0)
    p = p.astype(np.float32)
    ref = np.asarray(jax.jit(JC._hash3)(*(jnp.asarray(p[:, i]) for i in range(3))))
    pt = [torch.as_tensor(np.ascontiguousarray(p[:, i])) for i in range(3)]
    fused = C._hash3(*pt, True).numpy()
    plain = C._hash3(*pt, False).numpy()
    assert np.array_equal(fused, ref), int((fused != ref).sum())
    assert np.mean(np.abs(plain - ref) > 1e-2) > 0.1


def test_cloud_march_composites_layers():
    """Two layers composite low → mid: the mid layer's light is seen
    through the low layer's transmittance."""
    _, ct = _clouds(mid=True)
    ct.coverage = (2.0, 3.0, 1.0)
    o, d, amb = _rays(512, 4)
    ot, dt = _vec(o)[1], _vec(d)[1]
    sun_t = Vec3(*(torch.tensor(float(c)) for c in _SUN))
    args = (ct, ot, dt, sun_t, torch.as_tensor(_SUN_RAD),
            tuple(torch.as_tensor(a) for a in amb))
    (r01, _, _), t01 = C.cloud_march(*args, steps=16, layers=(0, 1))
    (r0, _, _), t0 = C.cloud_march(*args, steps=16, layers=(0,))
    (r1, _, _), t1 = C.cloud_march(*args, steps=16, layers=(1,))
    torch.testing.assert_close(t01, t0 * t1)
    torch.testing.assert_close(r01, r0 + t0 * r1)


def test_cloud_sun_transmittance_matches_reference():
    cj, ct = _clouds(mid=True)
    rng = np.random.default_rng(5)
    p = np.stack([rng.random(N) * 6000, rng.random(N) * 50,
                  rng.random(N) * 6000], -1).astype(np.float32)
    pj, pt = _vec(p)
    ref = np.asarray(jax.jit(lambda cl, p_, s_: JC.cloud_sun_transmittance(
        cl, JVec3(*p_), JVec3(*s_), layers=(0, 1)))(
            cj, tuple(pj), tuple(jnp.float32(c) for c in _SUN)))
    got = C.cloud_sun_transmittance(
        ct, pt, Vec3(*(torch.tensor(float(c)) for c in _SUN)),
        layers=(0, 1)).numpy()
    d = np.abs(got - ref)
    assert d.max() < 0.02 and d.mean() < 1e-3, (d.max(), d.mean())
    assert ref.min() < 0.5 and (ref == 1.0).any()
