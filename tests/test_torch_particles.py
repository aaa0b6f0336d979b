"""The particle tier against the JAX package on the same numpy inputs:

- the Jendersie-d'Eon phase (``ops/phase.py``): ``je_params`` exact,
  ``je_phase`` within rtol 1e-5 in all four diameter regimes, and the
  sampler ``je_sample_direction`` within atol 1e-5 (its Draine inversion
  cancels badly in float32, so the port takes its square and cube roots
  rounded as XLA's are);
- ``generate_particles`` bit for bit, and the particle pack
  (``pack_particles_device``: the wide BVH's node and leaf rows, the slot
  triangles, bounds, depth; scale, motion and albedo) word for word;
- the tile wrap ``floor_mod`` against ``jnp.mod`` bit for bit, on values
  near multiples of the tile and on negative origins (``torch.remainder``
  too, apart from subnormal remainders, which the reference flushes);
- the tile-wrapped walk (up to 3 segments) on the plain kernel B against
  the reference's walk on the JAX ``trace_closest``: the same lanes hit a
  particle, their distances within 1e-6 of the tile's edge;
- the reference's own assertions (``tests/test_phase.py``,
  ``tests/test_ocean_particles.py::test_particles_scene_renders``): the
  phase integrates to 1 and large droplets scatter forward; a particle
  field shows in the gbuffer as ``PARTICLES_INSTANCE_ID`` and motion
  changes the image.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from luminary_tpu.ops import phase as JP
from luminary_tpu.ops import procedural as JPR
from luminary_tpu.ops import traverse as JT
from luminary_tpu.ops.vec import Vec3 as JVec3
from luminary_tpu.render import device_scene as JD
from luminary_tpu.scene.entities import Particles as JParticles
from luminary_tpu_torch.ops import phase as P
from luminary_tpu_torch.ops.procedural import (
    PARTICLES_INSTANCE_ID,
    generate_particles,
)
from luminary_tpu_torch.ops.vec import Vec3
from luminary_tpu_torch.render.device_scene import pack_particles_device
from luminary_tpu_torch.render.renderer import Renderer
from luminary_tpu_torch.render.wavefront import _particle_tier, floor_mod
from luminary_tpu_torch.scene.entities import Particles
from luminary_tpu_torch.testing import sun_plane_scene

torch.set_num_threads(1)

DIAMETERS = (0.05, 0.8, 3.0, 10.0, 50.0)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _unit(rng, n):
    d = rng.standard_normal((n, 3)).astype(np.float32)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("d", DIAMETERS)
def test_phase_matches_reference(d):
    assert P.je_params(d) == JP.je_params(d)
    cos = np.concatenate([np.linspace(-1.0, 1.0, 4001),
                          1.0 - np.logspace(-7, -1, 1000)]).astype(np.float32)
    got = P.je_phase(_t(cos), d).numpy()
    ref = np.asarray(JP.je_phase(jnp.asarray(cos), d))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("d", DIAMETERS)
def test_phase_sampler_matches_reference(d):
    rng = np.random.default_rng(int(d * 100))
    n = 4096
    w = _unit(rng, n)
    r = [rng.random(n, dtype=np.float32) for _ in range(3)]
    got = P.je_sample_direction(Vec3(*(_t(w[:, i]) for i in range(3))), d,
                                *(_t(x) for x in r))
    ref = JP.je_sample_direction(JVec3(*(jnp.asarray(w[:, i]) for i in range(3))),
                                 d, *(jnp.asarray(x) for x in r))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_phase_normalizes_and_large_droplets_scatter_forward():
    """``tests/test_phase.py``'s contracts on the port: the two-lobe mix
    integrates to 1 over the sphere (2e-2, the reference's bound) and the
    sampler's mean cosine is the phase's (0.02)."""
    body = np.linspace(-1.0, 0.99, 100001)
    peak = 1.0 - np.logspace(-9, -2, 100001)[::-1]
    cos = np.unique(np.concatenate([body, peak, [1.0]]))
    trapz = getattr(np, "trapezoid", None) or np.trapz
    for d in DIAMETERS:
        p = P.je_phase(torch.as_tensor(cos, dtype=torch.float32), d).double().numpy()
        assert abs(2.0 * np.pi * trapz(p, cos) - 1.0) < 2e-2, d
    n = 1 << 15
    rng = np.random.default_rng(5)
    fwd = Vec3(torch.zeros(n), torch.zeros(n), torch.ones(n))
    for d in (0.8, 50.0):
        wi = P.je_sample_direction(fwd, d, *(_t(rng.random(n, np.float32))
                                             for _ in range(3)))
        p = P.je_phase(torch.as_tensor(cos, dtype=torch.float32), d).double().numpy()
        expect = 2.0 * np.pi * trapz(p * cos, cos)
        assert abs(float(wi.z.mean()) - expect) < 0.02, d
    assert P.je_params(50.0)[0] > 0.95 and P.je_params(0.05)[0] < 0.1


@pytest.mark.parametrize("kw", [dict(count=100, scale=10.0, size=1.0, seed=3),
                                dict(count=8192, scale=10.0, size=1.0, seed=0),
                                dict(count=777, scale=4.0, size=12.0,
                                     size_variation=0.3, seed=11)])
def test_generate_particles_bit_for_bit(kw):
    got = generate_particles(Particles(active=True, **kw))
    ref = JPR.generate_particles(JParticles(active=True, **kw))
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.int32),
                                                     b.view(np.int32))
    assert PARTICLES_INSTANCE_ID == JPR.PARTICLES_INSTANCE_ID


def _words(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype.itemsize == 4 else a


def test_particle_pack_word_for_word():
    kw = dict(active=True, count=1500, scale=6.0, size=5.0, speed=3.0,
              direction_azimuth=0.7, direction_altitude=0.4,
              albedo=(0.8, 0.7, 0.6), seed=4)
    got = pack_particles_device(Particles(**kw), "cpu")
    ref = JD.pack_particles_device(JParticles(**kw))
    gb, rb = got.bvh, ref.bvh
    assert gb.rows.shape[0] > 0 and gb.tri_v0.x.shape[0] > 128  # a wide walk
    assert np.array_equal(_words(gb.rows.numpy()), _words(rb.rows))
    for name in ("tri_v0", "tri_e1", "tri_e2"):
        for a, b in zip(getattr(gb, name), getattr(rb, name)):
            assert np.array_equal(_words(a.numpy()), _words(b)), name
    assert np.array_equal(_words(gb.bounds.numpy()), _words(rb.bounds))
    assert (gb.depth, gb.num_nodes) == (int(rb.depth), int(rb.num_nodes))
    assert np.float32(got.scale) == np.float32(ref.scale)
    assert np.array_equal(np.asarray(got.motion, np.float32), np.asarray(ref.motion))
    assert np.array_equal(np.asarray(got.albedo, np.float32), np.asarray(ref.albedo))
    assert pack_particles_device(Particles(active=False), "cpu") is None


def test_floor_mod_matches_jnp_mod():
    scale = np.float32(10.0)
    rng = np.random.default_rng(8)
    k = rng.integers(-5, 6, 2000).astype(np.float32)
    eps = rng.choice([0.0, 1e-7, -1e-7, 1e-5, -1e-5, 1e-3], 2000).astype(np.float32)
    x = np.concatenate([
        k * scale + eps * scale,                     # near multiples
        np.nextafter(k * scale, np.float32(np.inf)),
        np.nextafter(k * scale, np.float32(-np.inf)),
        -rng.random(1000, dtype=np.float32) * 1e-6,  # tiny negatives wrap to scale
        rng.uniform(-100, 100, 2000).astype(np.float32),
        np.asarray([0.0, -0.0, 10.0, -10.0, 1e-30, -1e-30], np.float32),
    ]).astype(np.float32)
    ref = np.asarray(jnp.mod(jnp.asarray(x), scale))
    got = floor_mod(_t(x), float(scale)).numpy()
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))
    assert (ref == scale).any()  # a tiny negative origin lands on the face
    # torch.remainder agrees but where the remainder is subnormal (the
    # reference flushes it to zero before its sign test; -1e-45 stays
    # -1e-45 there and wraps to the face here)
    rem = np.fmod(x, scale)
    sub = (rem != 0.0) & (np.abs(rem) < np.finfo(np.float32).tiny)
    assert 0 < sub.sum() < 400
    assert np.array_equal(torch.remainder(_t(x), float(scale)).numpy()[~sub],
                          ref[~sub])


def _jax_tile_walk(pt, origin, direction, hit_t, hit_valid, active, prev_delta,
                   depth, t_cam):
    """The reference's particle tier (``luminary_tpu/render/wavefront.py``
    ``render_sample``, the tiled particle tier) on the JAX
    ``trace_closest``."""
    closest = jax.jit(JT.trace_closest, static_argnames=("chunk",))
    n = origin.x.shape[0]
    p_gate = active if depth == 0 else (active & prev_delta)
    t_cur = jnp.where(hit_valid, hit_t, 1e7)
    seg_o = JVec3(origin.x + pt.motion[0] * t_cam,
                  origin.y + pt.motion[1] * t_cam,
                  origin.z + pt.motion[2] * t_cam)
    t_base = jnp.zeros((n,), jnp.float32)
    p_t = jnp.full((n,), 1e30, jnp.float32)
    p_found = jnp.zeros((n,), bool)
    hop_eps = 1e-4 * pt.scale
    for _seg in range(3):
        wrapped = JVec3(jnp.mod(seg_o.x, pt.scale), jnp.mod(seg_o.y, pt.scale),
                        jnp.mod(seg_o.z, pt.scale))

        def _exit(wc, dc):
            tgt = jnp.where(dc > 0.0, pt.scale, 0.0)
            dc_s = jnp.where(jnp.abs(dc) < 1e-9, 1e-9, dc)
            return jnp.where(jnp.abs(dc) < 1e-9, 1e30, (tgt - wc) / dc_s)
        t_exit = jnp.minimum(_exit(wrapped.x, direction.x),
                             jnp.minimum(_exit(wrapped.y, direction.y),
                                         _exit(wrapped.z, direction.z)))
        t_exit = jnp.maximum(t_exit, 0.0)
        seg_act = p_gate & ~p_found & (t_base < t_cur)
        h_s = closest(pt.bvh, wrapped, direction, chunk=None, active=seg_act)
        ok = seg_act & h_s.valid & (h_s.t <= t_exit + hop_eps)
        p_t = jnp.where(ok, t_base + h_s.t, p_t)
        p_found = p_found | ok
        adv = t_exit + hop_eps
        seg_o = JVec3(seg_o.x + direction.x * adv, seg_o.y + direction.y * adv,
                      seg_o.z + direction.z * adv)
        t_base = t_base + adv
    return p_gate & p_found & (p_t < t_cur), p_t


@pytest.mark.parametrize("depth", [0, 1])
def test_tile_walk_matches_reference(depth):
    """Rays from origins over several tiles (negative ones too), a moving
    field (the time draw at depth index max_depth), geometry hits in front
    of some lanes, inactive and non-delta lanes."""
    kw = dict(active=True, count=1200, scale=3.0, size=20.0, speed=2.0,
              direction_azimuth=1.1, direction_altitude=0.5, seed=6)
    pt = pack_particles_device(Particles(**kw), "cpu")
    ptj = jax.device_put(JD.pack_particles_device(JParticles(**kw)))
    rng = np.random.default_rng(9 + depth)
    n = 2048
    o = rng.uniform(-7.0, 7.0, (n, 3)).astype(np.float32)
    o[:64] = np.round(o[:64] / 3.0) * 3.0  # on tile faces
    d = _unit(rng, n)
    d[64:96, 0] = 0.0  # axis-parallel components
    d[64:96] /= np.linalg.norm(d[64:96], axis=-1, keepdims=True)
    hit_t = rng.uniform(0.5, 30.0, n).astype(np.float32)
    hit_valid = rng.random(n) < 0.5
    active = rng.random(n) < 0.9
    prev_delta = rng.random(n) < 0.7
    pid = rng.integers(0, 1 << 20, n).astype(np.int64)
    sid = np.int64(5)
    from luminary_tpu.ops.random import RandomTarget as JRT, random_1d as j_random_1d
    from luminary_tpu_torch.ops.traverse import Hit

    t_cam = j_random_1d(JRT.PARTICLE_PHASE, jnp.asarray(pid.astype(np.uint32)),
                        jnp.uint32(sid), 4)
    ref_lane, ref_t = _jax_tile_walk(
        ptj, JVec3(*(jnp.asarray(o[:, i]) for i in range(3))),
        JVec3(*(jnp.asarray(d[:, i]) for i in range(3))), jnp.asarray(hit_t),
        jnp.asarray(hit_valid), jnp.asarray(active), jnp.asarray(prev_delta),
        depth, t_cam)
    hit = Hit(t=torch.where(_t(hit_valid), _t(hit_t), 1e30),
              slot=torch.where(_t(hit_valid), 0, -1).to(torch.int32),
              u=torch.zeros(n), v=torch.zeros(n))
    lane, p_t = _particle_tier(
        pt, Vec3(*(_t(o[:, i]) for i in range(3))),
        Vec3(*(_t(d[:, i]) for i in range(3))), hit, _t(active),
        _t(prev_delta), depth, _t(pid), torch.as_tensor(sid), 4)
    ref_lane, ref_t = np.asarray(ref_lane), np.asarray(ref_t)
    assert np.array_equal(lane.numpy(), ref_lane)
    assert 50 < ref_lane.sum() < n - 50
    # a hit distance rounds with the ray's path through the tile: within
    # 1e-6 of the tile's edge
    np.testing.assert_allclose(p_t.numpy()[ref_lane], ref_t[ref_lane],
                               rtol=0, atol=1e-6 * 3.0)


def test_particles_scene_renders():
    """``tests/test_ocean_particles.py::test_particles_scene_renders`` on
    the port: a dense field of big particles shows in the primary gbuffer,
    the image is finite, and a moving field (a time per sample) changes
    it."""
    def build(speed):
        scene = sun_plane_scene(16, 16)
        p = scene.get_entity("particles")
        p.active = True
        p.count = 500
        p.scale = 8.0
        p.size = 30.0
        p.speed = speed
        scene.set_entity("particles", p)
        return scene

    r = Renderer(build(0.0), device="cpu")
    assert r.config.use_particles and r.config.particle_mat_id == 1
    assert r.device_scene.particles.bvh.tri_v0.x.shape[0] > 128
    r.render_samples(4)
    rad = r.get_radiance()
    assert np.all(np.isfinite(rad))
    ids = {r.get_pixel_info(x, y)["instance_id"]
           for x in range(0, 16, 2) for y in range(0, 16, 2)}
    assert PARTICLES_INSTANCE_ID in ids, ids
    r2 = Renderer(build(200.0), device="cpu")
    r2.render_samples(4)
    rad2 = r2.get_radiance()
    assert np.all(np.isfinite(rad2))
    assert not np.allclose(rad, rad2)


def test_particle_edit_repacks():
    """An edit of the particle field marks the scene dirty and the Renderer
    packs the new field (and drops it when the field is switched off)."""
    scene = sun_plane_scene(8, 8)
    p = scene.get_entity("particles")
    p.active = True
    p.count = 100
    scene.set_entity("particles", p)
    r = Renderer(scene, device="cpu")
    n0 = r.device_scene.particles.bvh.tri_v0.x.shape[0]
    p.count = 300
    scene.set_entity("particles", p)
    r.update()
    assert r.device_scene.particles.bvh.tri_v0.x.shape[0] > n0
    p.active = False
    scene.set_entity("particles", p)
    r.update()
    assert r.device_scene.particles is None and not r.config.use_particles
