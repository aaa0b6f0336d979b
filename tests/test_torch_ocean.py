"""The sea against the JAX package on the same numpy inputs from a seed: the
water half of ``luminary_tpu/ops/volume.py`` (``pack_water``, the
segment transmittance, collision sampling, the phase mixture and its
sampling), the procedural surface of ``ops/procedural.py`` (value noise,
FBM, height and normal; the tessellated mesh bit for bit), the analytic
ocean of ``ops/ocean.py`` and the caustic connection of ``ops/caustics.py``.

Tolerances: flags and collision decisions exact, floats within rtol 1e-5.
The heightfield march (``ocean_intersect``) is exact in its hit flags but
on lanes that graze the surface, where one ulp of a step decides between
a hit and a miss; their count is held below 0.5 % of the lanes (it is 0
on an x86 CPU). The JAX loops run under ``jax.jit`` with array arguments,
as the JAX renderer runs them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from luminary_tpu.ops import caustics as JCa
from luminary_tpu.ops import ocean as JO
from luminary_tpu.ops import procedural as JP
from luminary_tpu.ops import volume as JV
from luminary_tpu.ops.vec import Vec3 as JVec3
from luminary_tpu.scene.entities import JerlovWaterType as JJerlov
from luminary_tpu.scene.entities import Ocean as JOcean
from luminary_tpu_torch.ops import caustics as Ca
from luminary_tpu_torch.ops import ocean as O
from luminary_tpu_torch.ops import procedural as P
from luminary_tpu_torch.ops import volume as V
from luminary_tpu_torch.ops.random import blue_base
from luminary_tpu_torch.ops.vec import Vec3
from luminary_tpu_torch.scene.entities import JerlovWaterType, Ocean

torch.set_num_threads(1)

N = 4096


def _ocean(cls=Ocean, jerlov=JerlovWaterType, **kw):
    o = cls(active=True, height=0.5, amplitude=0.6, frequency=0.12,
            water_type=jerlov.IB, caustics_active=True)
    for k, v in kw.items():
        setattr(o, k, v)
    return o


def _waters(**kw):
    """(JAX DeviceWater on the device, the port's DeviceWater)."""
    jkw = dict(kw)
    if "water_type" in kw:
        jkw["water_type"] = JJerlov(int(kw["water_type"]))
    return (jax.device_put(JV.pack_water(_ocean(JOcean, JJerlov, **jkw))),
            V.pack_water(_ocean(**kw)))


def _vec(a):
    j = JVec3(*(jnp.asarray(np.ascontiguousarray(a[:, i])) for i in range(3)))
    t = Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i])) for i in range(3)))
    return j, t


def _rays(seed, spread=40.0):
    """Origins above and below the surface band, unit directions (a few
    horizontal), segment lengths over four decades."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (N, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(-6.0, 8.0, N)
    d = rng.standard_normal((N, 3)).astype(np.float32)
    d[:8, 1] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.exp(rng.uniform(-1.0, 6.0, N)).astype(np.float32)
    return o, d.astype(np.float32), t


def _ids(seed):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, 1920 * 1080, N).astype(np.uint32)
    return pid, rng.integers(0, 1 << 20, N).astype(np.uint32)


def _t64(a):
    return torch.as_tensor(a.astype(np.int64))


@pytest.mark.parametrize("kw", [dict(), dict(water_type=JerlovWaterType.I),
                                dict(water_type=JerlovWaterType.C9),
                                dict(active=False)])
def test_pack_water_matches_reference(kw):
    j, t = _waters(**kw)
    assert t.active == bool(j.active)
    for k in ("scatter", "mol_weight", "height", "amplitude", "frequency",
              "ior", "caustics_scale"):
        assert np.float32(getattr(t, k)) == np.float32(getattr(j, k)), k
    assert np.array_equal(np.float32(t.absorb), np.asarray(j.absorb))


@pytest.mark.parametrize("with_scatter", [False, True])
def test_water_transmittance_matches_reference(with_scatter):
    (wj, wt) = _waters()
    o, d, t = _rays(1)
    (oj, ot), (dj, dt) = _vec(o), _vec(d)
    for lim_j, lim_t in ((jnp.asarray(t), torch.as_tensor(t)), (1e7, 1e7)):
        ref = JV.water_transmittance(wj, oj, dj, lim_j, with_scatter=with_scatter)
        got = V.water_transmittance(wt, ot, dt, lim_t, with_scatter=with_scatter)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    assert (got[2].numpy() < 0.5).any() and (got[2].numpy() == 1.0).any()


@pytest.mark.parametrize("use_bn", [False, True])
def test_water_collision_matches_reference(use_bn):
    wj, wt = _waters(water_type=JerlovWaterType.C9)
    o, d, t = _rays(2)
    (oj, ot), (dj, dt) = _vec(o), _vec(d)
    pid, sid = _ids(3)
    px, py = (pid % 1920).astype(np.int32), (pid // 1920).astype(np.int32)
    from luminary_tpu.ops.random import blue_base as j_blue_base

    bn_t = blue_base(torch.as_tensor(px), torch.as_tensor(py)) if use_bn else None
    bn_j = j_blue_base(jnp.asarray(px), jnp.asarray(py)) if use_bn else None
    for depth in (0, 3):
        cj, tcj = JV.sample_water_collision(
            wj, oj, dj, jnp.asarray(t), jnp.asarray(pid), jnp.asarray(sid),
            depth, bn=bn_j)
        ct, tct = V.sample_water_collision(wt, ot, dt, torch.as_tensor(t),
                                           _t64(pid), _t64(sid), depth, bn=bn_t)
        assert np.array_equal(ct.numpy(), np.asarray(cj))
        assert 0.01 * N < int(ct.sum()) < 0.9 * N
        np.testing.assert_allclose(tct.numpy(), np.asarray(tcj), rtol=1e-5)


def test_ocean_phase_and_sampling_match_reference():
    rng = np.random.default_rng(4)
    cos = rng.uniform(-1.0, 1.0, N).astype(np.float32)
    for wt_ in (JerlovWaterType.I, JerlovWaterType.II):
        wj, wt = _waters(water_type=wt_)
        np.testing.assert_allclose(
            V.ocean_phase(torch.as_tensor(cos), wt).numpy(),
            np.asarray(JV.ocean_phase(jnp.asarray(cos), wj)), rtol=1e-5)
    wj, wt = _waters(water_type=JerlovWaterType.IA)
    _, d, _ = _rays(5)
    dj, dt = _vec(d)
    pid, sid = _ids(6)
    ref = JV.sample_ocean_phase_direction(dj, wj, jnp.asarray(pid),
                                          jnp.asarray(sid), 2)
    got = V.sample_ocean_phase_direction(dt, wt, _t64(pid), _t64(sid), 2)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_noise_fbm_height_and_normal_match_reference():
    rng = np.random.default_rng(7)
    x = rng.uniform(-500.0, 500.0, N).astype(np.float32)
    z = rng.uniform(-500.0, 500.0, N).astype(np.float32)
    xt, zt = torch.as_tensor(x), torch.as_tensor(z)
    for seed in (0, 9):
        np.testing.assert_allclose(
            P.value_noise_t(xt, zt, seed).numpy(),
            np.asarray(JP.value_noise_jnp(jnp.asarray(x), jnp.asarray(z), seed)),
            rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        P.ocean_fbm_t(xt, zt).numpy(),
        np.asarray(JP.ocean_fbm_jnp(jnp.asarray(x), jnp.asarray(z))),
        rtol=1e-5, atol=1e-7)
    wj, wt = _waters()
    yj, nj = JP.ocean_height_normal_jnp(wj, jnp.asarray(x), jnp.asarray(z))
    yt, nt = P.ocean_height_normal(wt, xt, zt)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-6)
    for a, b in zip(nt, nj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    on = O.ocean_normal(wt, xt, zt)
    for a, b in zip(on, JO.ocean_normal(wj, jnp.asarray(x), jnp.asarray(z))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("center", [(0.0, 0.0), (13.5, -40.25)])
def test_generate_ocean_mesh_bit_for_bit(center):
    kw = dict(height=-0.4, amplitude=1.3, frequency=0.2)
    cj, nj = JP.generate_ocean_mesh(_ocean(JOcean, JJerlov, **kw), center_xz=center,
                                    extent=50.0, resolution=32)
    ct, nt = P.generate_ocean_mesh(_ocean(**kw), center_xz=center, extent=50.0,
                                   resolution=32)
    assert ct.shape == cj.shape == (2 * 32 * 32, 3, 3)
    assert np.array_equal(ct.view(np.int32), cj.view(np.int32))
    assert np.array_equal(nt.view(np.int32), nj.view(np.int32))


def _jit_intersect(w, o, d, t, a):
    return jax.jit(lambda w_, o_, d_, t_, a_: JO.ocean_intersect(
        w_, JVec3(*o_), JVec3(*d_), t_, a_))(w, tuple(o), tuple(d), t, a)


def test_ocean_intersect_matches_reference():
    wj, wt = _waters()
    o, d, t = _rays(8)
    (oj, ot), (dj, dt) = _vec(o), _vec(d)
    act = np.random.default_rng(9).random(N) > 0.1
    fj, tj = (np.asarray(v) for v in _jit_intersect(
        wj, oj, dj, jnp.asarray(t), jnp.asarray(act)))
    ft, tt = O.ocean_intersect(wt, ot, dt, torch.as_tensor(t),
                               torch.as_tensor(act))
    ft, tt = ft.numpy(), tt.numpy()
    grazing = ft != fj
    assert int(grazing.sum()) <= 0.005 * N, int(grazing.sum())
    assert 0.1 * N < int(fj.sum()) < 0.9 * N and not ft[~act].any()
    both = ft & fj
    np.testing.assert_allclose(tt[both], tj[both], rtol=1e-5)


def test_ocean_crosses_matches_reference():
    wj, wt = _waters()
    o, d, t = _rays(10)
    (oj, ot), (dj, dt) = _vec(o), _vec(d)
    act = np.random.default_rng(11).random(N) > 0.1
    ref = np.asarray(jax.jit(lambda w_, o_, d_, t_, a_: JO.ocean_crosses(
        w_, JVec3(*o_), JVec3(*d_), t_, a_))(
            wj, tuple(oj), tuple(dj), jnp.asarray(t), jnp.asarray(act)))
    got = O.ocean_crosses(wt, ot, dt, torch.as_tensor(t),
                          torch.as_tensor(act)).numpy()
    assert np.array_equal(got, ref)
    assert 0.1 * N < int(ref.sum()) < 0.9 * N


@pytest.mark.parametrize("k", [2, 8])
def test_caustic_connection_matches_reference(k):
    """RIS over k surface points for underwater vertices: the winners and
    their validity exact, the connection and its weight within rtol 1e-5.
    A winner is valid where it refracts into the solar disc (~1e-5 of the
    candidates), so this test takes 65,536 lanes."""
    wj, wt = _waters(amplitude=0.25)
    m = 1 << 16
    rng = np.random.default_rng(12 + k)
    x = np.stack([rng.uniform(-30, 30, m), rng.uniform(-8.0, 0.3, m),
                  rng.uniform(-30, 30, m)], -1).astype(np.float32)
    xj, xt = _vec(x)
    sun = np.asarray([0.3, 0.85, -0.2], np.float32)
    sun /= np.linalg.norm(sun)
    pid = rng.integers(0, 1920 * 1080, m).astype(np.uint32)
    sid = rng.integers(0, 1 << 20, m).astype(np.uint32)
    ref = JCa.sample_caustic_connection(
        wj, JVec3(*(jnp.float32(c) for c in sun)), xj, jnp.asarray(pid),
        jnp.asarray(sid), 1, k)
    got = Ca.sample_caustic_connection(
        wt, Vec3(*(torch.tensor(float(c)) for c in sun)), xt, _t64(pid),
        _t64(sid), 1, k)
    valid_j, valid_t = np.asarray(ref[4]), got[4].numpy()
    assert np.array_equal(valid_t, valid_j)
    if k == 8:
        assert valid_j.sum() >= 3
    for a, b in zip(got[0] + got[1], ref[0] + ref[1]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-5)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), rtol=1e-5)
