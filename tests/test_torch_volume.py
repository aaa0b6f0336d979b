"""Fog and bridges against the JAX package (``luminary_tpu/ops/volume.py``,
fog half, and ``luminary_tpu/ops/bridges.py``) on the same numpy inputs from
a seed: ``pack_fog``; the HG phase and its sampling; ``fog_segment`` and
``fog_transmittance``; ``sample_fog_collision`` (collision flags exact,
distances within rtol 1e-5); ``sample_bridge`` for 1 and 2 vertices (vertex
counts exact, everything else within rtol 1e-5)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from luminary_tpu.ops import bridges as JB
from luminary_tpu.ops import volume as JV
from luminary_tpu.ops.vec import Vec3 as JVec3
from luminary_tpu_torch.ops import bridges as B
from luminary_tpu_torch.ops import volume as V
from luminary_tpu_torch.ops.random import blue_base
from luminary_tpu_torch.ops.vec import Vec3
from luminary_tpu_torch.scene.entities import Fog

torch.set_num_threads(1)

N = 4096


def _fog(**kw):
    f = Fog(active=True, density=8.0, droplet_diameter=14.0, height=6.0,
            dist=40.0)
    for k, v in kw.items():
        setattr(f, k, v)
    return f


def _both(a):
    a = np.ascontiguousarray(a)
    return jnp.asarray(a), torch.as_tensor(a)


def _vec(a):
    j = JVec3(*(jnp.asarray(np.ascontiguousarray(a[:, i])) for i in range(3)))
    t = Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i])) for i in range(3)))
    return j, t


def _rays(seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-10.0, 10.0, (N, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(-2.0, 12.0, N)  # inside and above the slab
    d = rng.standard_normal((N, 3)).astype(np.float32)
    d[:8, 1] = 0.0  # grazing the fog top
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.exp(rng.uniform(-2.0, 5.0, N)).astype(np.float32)
    return o, d.astype(np.float32), t


def _ids(seed):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, 1920 * 1080, N).astype(np.uint32)
    return pid, rng.integers(0, 1 << 20, N).astype(np.uint32)


@pytest.mark.parametrize("fog", [dict(), dict(droplet_diameter=0.01),
                                 dict(active=False), dict(density=0.0)])
def test_pack_fog_matches_reference(fog):
    j, t = JV.pack_fog(_fog(**fog)), V.pack_fog(_fog(**fog))
    for k in ("sigma_t", "scatter_albedo", "height", "max_dist", "g"):
        assert np.float32(getattr(t, k)) == np.float32(getattr(j, k)), k
    assert t.active == bool(j.active)


def test_hg_phase_and_sampling_match_reference():
    rng = np.random.default_rng(1)
    cos = rng.uniform(-1.0, 1.0, N).astype(np.float32)
    for g in (0.55, 0.0, -0.3, 0.9):
        g32 = float(np.float32(g))
        np.testing.assert_allclose(
            V.hg_phase(torch.as_tensor(cos), g32).numpy(),
            np.asarray(JV.hg_phase(jnp.asarray(cos), jnp.float32(g32))), rtol=1e-5)
    o, d, _ = _rays(2)
    dj, dt = _vec(d)
    pid, sid = _ids(3)
    px = torch.as_tensor((pid % 1920).astype(np.int32))
    py = torch.as_tensor((pid // 1920).astype(np.int32))
    bn = blue_base(px, py)
    from luminary_tpu.ops.random import blue_base as j_blue_base

    bn_j = j_blue_base(jnp.asarray(px.numpy()), jnp.asarray(py.numpy()))
    for g in (0.55, 0.0005):
        for use_bn in (False, True):
            ref = JV.sample_hg_direction(dj, jnp.float32(g), jnp.asarray(pid),
                                         jnp.asarray(sid), 2,
                                         bn=bn_j if use_bn else None)
            got = V.sample_hg_direction(dt, float(np.float32(g)),
                                        torch.as_tensor(pid.astype(np.int64)),
                                        torch.as_tensor(sid.astype(np.int64)), 2,
                                        bn=bn if use_bn else None)
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                           atol=1e-6)


@pytest.mark.parametrize("fog", [dict(), dict(active=False)])
def test_fog_segment_and_transmittance_match_reference(fog):
    fj, ft = JV.pack_fog(_fog(**fog)), V.pack_fog(_fog(**fog))
    o, d, t = _rays(4)
    (oj, ot), (dj, dt) = _vec(o), _vec(d)
    tj, tt = _both(t)
    for lim_j, lim_t in ((tj, tt), (1e7, 1e7)):
        for a, b in zip(V.fog_segment(ft, ot, dt, lim_t),
                        JV.fog_segment(fj, oj, dj, lim_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
        np.testing.assert_allclose(
            V.fog_transmittance(ft, ot, dt, lim_t).numpy(),
            np.asarray(JV.fog_transmittance(fj, oj, dj, lim_j)), rtol=1e-5)


def test_fog_collision_matches_reference():
    fj, ft = JV.pack_fog(_fog()), V.pack_fog(_fog())
    o, d, t = _rays(5)
    (oj, ot), (dj, dt) = _vec(o), _vec(d)
    pid, sid = _ids(6)
    for depth in (0, 3):
        cj, tcj = JV.sample_fog_collision(fj, oj, dj, jnp.asarray(t),
                                          jnp.asarray(pid), jnp.asarray(sid),
                                          depth)
        ct, tct = V.sample_fog_collision(ft, ot, dt, torch.as_tensor(t),
                                         torch.as_tensor(pid.astype(np.int64)),
                                         torch.as_tensor(sid.astype(np.int64)),
                                         depth)
        assert np.array_equal(ct.numpy(), np.asarray(cj))
        assert 0.05 * N < int(ct.sum()) < 0.95 * N
        np.testing.assert_allclose(tct.numpy(), np.asarray(tcj), rtol=1e-5)


@pytest.mark.parametrize("vertices", [1, 2])
def test_sample_bridge_matches_reference(vertices):
    rng = np.random.default_rng(7 + vertices)
    x = rng.uniform(-5.0, 5.0, (N, 3)).astype(np.float32)
    y = (x + rng.standard_normal((N, 3)) * rng.uniform(0.1, 30.0, (N, 1))).astype(
        np.float32)
    y[:4] = x[:4]  # degenerate: the light point on the vertex
    v = rng.standard_normal((N, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    (xj, xt), (yj, yt), (vj, vt) = _vec(x), _vec(y), _vec(v.astype(np.float32))
    pid, sid = _ids(8)
    g, sig_t, alb = 0.55, 0.08, 0.98
    sig_s = float(np.float32(sig_t) * np.float32(alb))
    ref = JB.sample_bridge(xj, yj, vj, jnp.float32(g),
                           jnp.float32(sig_t) * jnp.float32(alb),
                           jnp.float32(sig_t), vertices, jnp.asarray(pid),
                           jnp.asarray(sid), 1)
    got = B.sample_bridge(xt, yt, vt, float(np.float32(g)), sig_s,
                          float(np.float32(sig_t)), vertices,
                          torch.as_tensor(pid.astype(np.int64)),
                          torch.as_tensor(sid.astype(np.int64)), 1)
    m_j, m_t = np.asarray(ref[6]), got[6].numpy()
    assert np.array_equal(m_t, m_j)
    if vertices > 1:
        assert (m_t == 1).any() and (m_t == 2).any()

    def close(a, b):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)

    for a, b in zip(got[0], ref[0]):
        close(a, b)
    for i in range(vertices):
        for a, b in zip(got[1][i] + got[2][i], ref[1][i] + ref[2][i]):
            close(a, b)
        close(got[3][i], ref[3][i])
    np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]), rtol=1e-5)
    np.testing.assert_allclose(got[5].numpy(), np.asarray(ref[5]), rtol=1e-5)
    assert (got[4].numpy()[:4] == 0.0).all()
