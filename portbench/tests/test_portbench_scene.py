"""The scene recipe from a seed."""

import numpy as np

from harness import spec

bf = spec.load_module("scenes", "bench_field")


def test_same_seed_same_arrays():
    a = bf.field_arrays(5, 5, 2**31 + 11)
    b = bf.field_arrays(5, 5, 2**31 + 11)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_seed_moves_placement_not_counts():
    v1, t1, m1 = bf.field_arrays(19, 19, 1)
    v2, t2, m2 = bf.field_arrays(19, 19, 2)
    assert t1.shape == t2.shape == (19 * 19 * 352 + 2, 3)
    assert np.array_equal(t1, t2)
    assert not np.array_equal(v1, v2)
    assert not np.array_equal(m1, m2)
    # the lamps stay put: every 23rd sphere, 5,632 emitter triangles
    assert (m1 == bf.LAMP).sum() == (m2 == bf.LAMP).sum() == 16 * 352
    assert np.array_equal(m1 == bf.LAMP, m2 == bf.LAMP)


def test_sphere_matches_the_ports_recipe():
    """Each sphere of the field, bit for bit the port's ``_uv_sphere`` at
    the sphere's place and drawn radius."""
    from luminary_tpu_torch import testing

    nx, nz, seed = 2, 3, 5
    v, t, _ = bf.field_arrays(nx, nz, seed)
    radii = np.random.default_rng(np.random.SeedSequence(seed)).uniform(
        0.5, 1.1, nx * nz)
    nv = bf.NU * bf.NV
    for k in range(nx * nz):
        gx, gz = divmod(k, nz)
        r = float(radii[k])
        v2, t2 = testing._uv_sphere(gx * bf.SPACING, r, gz * bf.SPACING, r)
        assert np.array_equal(v[k * nv:(k + 1) * nv], v2)
        assert np.array_equal(t[k * len(t2):(k + 1) * len(t2)], t2 + k * nv)


def test_configured_field_counts():
    """The cells' field: 6,400 spheres and the ground (2,252,802
    triangles), 279 lamps (98,208 emitter triangles)."""
    for name in ("tree-4k.ladder", "outdoor-4k.ladder"):
        p = spec.load_cell(name).config["scene"]
        v, t, m = bf.field_arrays(p["nx"], p["nz"], 2**31 + 5)
        assert t.shape == (2_252_802, 3) and t.dtype == np.int32
        assert (m == bf.LAMP).sum() == 98_208 == 279 * 352
        assert t.max() == len(v) - 1


def test_build_hands_the_arrays_to_the_api():
    import luminary_tpu_torch.scene as api

    params = dict(width=64, height=36, max_depth=4, nx=3, nz=3, ocean=True,
                  clouds=True, sky_mode=0)
    scene = bf.build(api, params, 9)
    verts, tris, mats = bf.field_arrays(3, 3, 9)
    assert np.array_equal(scene.meshes[0].vertices, verts)
    assert np.array_equal(scene.meshes[0].triangles, tris)
    assert scene.settings.width == 64 and scene.settings.max_ray_depth == 4
    assert scene.ocean.active and scene.cloud.active
    assert scene.cloud.low.active and scene.cloud.mid.active
