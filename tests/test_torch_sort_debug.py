"""The wavefront sort and the debug shading modes against the JAX package:

- ``ray_sort_key`` bit for bit on random rays (origins inside and outside
  the bounds, signed zero and negative direction components, live and
  dead lanes), and the stable sort's permutation equal to ``jnp.argsort``'s
  (dead lanes share keys, so an unstable sort would part the carried
  columns);
- a sorted render equals the unsorted one (rtol 1e-4, atol 1e-5, the bound
  of the reference's ``tests/test_wavefront_sort.py``), and dead lanes sort
  last;
- each debug shading mode (ALBEDO, DEPTH, NORMAL, IDENTIFICATION, LIGHTS)
  of one wavefront against the JAX ``render_sample`` on the same tables:
  ALBEDO, IDENTIFICATION and LIGHTS exact, DEPTH and NORMAL within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from luminary_tpu.ops.camera import pack_camera as j_pack_camera
from luminary_tpu.ops.vec import Vec3 as JVec3
from luminary_tpu.ops.wavefront_utils import ray_sort_key as j_ray_sort_key
from luminary_tpu_torch.ops.vec import Vec3
from luminary_tpu_torch.ops.wavefront_utils import ray_sort_key
from luminary_tpu_torch.render.renderer import Renderer
from luminary_tpu_torch.render.wavefront import render_sample
from luminary_tpu_torch.scene.entities import ShadingMode
from luminary_tpu_torch.scene.mesh import Mesh
from luminary_tpu_torch.testing import _add_mesh, _uv_sphere, benchmark_scene
from test_torch_sky_hdri import _jax_config
from test_torch_textures import convert_scene, jax_device_scene, jax_render

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a, copy=True))


@pytest.mark.parametrize("seed", [0, 1])
def test_ray_sort_key_bit_for_bit_and_stable(seed):
    rng = np.random.default_rng(seed)
    n = 8192
    o = rng.uniform(-2.0, 12.0, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d[:, :64] = 0.0
    d[0, 64:128] = -0.0
    act = rng.random(n) < 0.6
    bounds = np.asarray([0.0, -1.0, 0.5, 10.0, 9.0, 10.5], np.float32)
    ref = np.asarray(j_ray_sort_key(
        JVec3(*(jnp.asarray(c) for c in o)), JVec3(*(jnp.asarray(c) for c in d)),
        jnp.asarray(act), jnp.asarray(bounds)))
    got = ray_sort_key(Vec3(*(_t(c) for c in o)), Vec3(*(_t(c) for c in d)),
                       _t(act), _t(bounds)).numpy()
    assert ref.dtype == np.uint32 and np.array_equal(got, ref.astype(np.int64))
    assert len(np.unique(ref)) < n  # keys repeat (dead lanes, coarse origins)
    perm = torch.argsort(_t(got), stable=True).numpy()
    assert np.array_equal(perm, np.asarray(jnp.argsort(jnp.asarray(ref))))
    live = act[perm]
    first_dead = int(np.argmax(~live)) if (~live).any() else n
    assert not live[first_dead:].any()  # dead lanes last


def _bench_radiance(sort: bool, samples=1):
    scene = benchmark_scene(width=64, height=48, max_depth=3, nx=4, nz=4)
    s = scene.get_entity("settings")
    s.wavefront_sorting = sort
    scene.set_entity("settings", s)
    r = Renderer(scene, device="cpu")
    assert r.config.sort_wavefront == sort
    assert r.device_scene.geo.bvh.tri_v0.x.shape[0] > 128  # the tree tier
    r.render_samples(samples)
    return r.get_radiance()


def test_sorted_wavefront_matches_unsorted():
    a = _bench_radiance(sort=False)
    b = _bench_radiance(sort=True)
    assert np.isfinite(b).all() and float(np.abs(a).mean()) > 0.0
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def debug_fx():
    """The bench field (packed shade rows) with a second instance, a sphere
    in its middle, so that IDENTIFICATION tells instances apart."""
    scene = benchmark_scene(width=16, height=16, max_depth=2, nx=4, nz=4)
    v, t = _uv_sphere(5.0, 1.5, 5.0, 1.6)
    _add_mesh(scene, Mesh(vertices=v, triangles=t,
                          material_ids=np.full(len(t), 3, np.uint16),
                          name="middle"))
    r = Renderer(scene, device="cpu")
    assert r.device_scene.geo.material_id.shape[0] > 2048  # packed rows
    js = convert_scene(scene, "luminary_tpu")
    return dict(r=r, jds=jax_device_scene(js, r.device_scene),
                jcam=jax.device_put(j_pack_camera(js.camera)))


@pytest.mark.parametrize("mode", [ShadingMode.ALBEDO, ShadingMode.DEPTH,
                                  ShadingMode.NORMAL, ShadingMode.IDENTIFICATION,
                                  ShadingMode.LIGHTS])
def test_debug_shading_matches_reference(debug_fx, mode):
    r = debug_fx["r"]
    c = r.config._replace(shading_mode=int(mode))
    n = c.width * c.height
    px, py = r._px[:n], r._py[:n]
    ref, gb_j, rays_j = jax_render(
        debug_fx["jds"], debug_fx["jcam"],
        _jax_config(c, n)._replace(shading_mode=int(mode)),
        px.numpy(), py.numpy(), np.uint32(1))
    got, gb_t, rays_t = render_sample(r.device_scene, r.device_camera, c, px,
                                      py, 1)
    ref, got = np.asarray(ref), got.numpy()
    assert got.shape == ref.shape == (n, 3) and float(rays_t) == float(rays_j)
    assert np.array_equal(gb_t.instance_id.numpy(), np.asarray(gb_j.instance_id))
    if mode in (ShadingMode.DEPTH, ShadingMode.NORMAL):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.array_equal(got, ref)
    assert float(np.abs(got).max()) > 0.0
    if mode == ShadingMode.IDENTIFICATION:  # both instances are seen
        assert len(np.unique(got[gb_t.instance_id.numpy() >= 0], axis=0)) == 2
