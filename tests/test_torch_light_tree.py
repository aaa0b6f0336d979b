"""Kernel C's plain version (``light_tree_descend_plain``) and the tree build
against ``luminary_tpu/ops/light_tree.py`` (its XLA level body), on the
fixture of ``tests/test_light_tree.py`` (300 random lights, seed 5).

Picks must be exactly equal; the pdf (a product of per-level probabilities)
within rtol 1e-5, since XLA and PyTorch may round the per-child weights
differently in the last place."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from luminary_tpu.ops import random as jr
from luminary_tpu.ops.light_tree import build_light_tree as j_build
from luminary_tpu.ops.light_tree import sample_light_tree as j_sample
from luminary_tpu.ops.vec import Vec3 as JVec3
from luminary_tpu_torch.ops import light_tree as LT
from luminary_tpu_torch.ops import random as tr
from luminary_tpu_torch.ops.vec import Vec3

torch.set_num_threads(1)


def _random_lights(n=300, seed=5):
    """Same construction as tests/test_light_tree.py::_random_lights."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.4, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.4, (n, 3)).astype(np.float32)
    power = rng.uniform(0.1, 30.0, n).astype(np.float32)
    slots = np.arange(100, 100 + n, dtype=np.int32)
    centroid = v0 + (e1 + e2) / 3.0
    corners = np.stack([v0, v0 + e1, v0 + e2], axis=1)
    return centroid, corners, power, slots


@pytest.fixture(scope="module")
def trees():
    lights = _random_lights()
    return j_build(*lights), LT.build_light_tree(*lights)


def test_fixture_matches_reference_helper():
    import test_light_tree as ref

    for a, b in zip(ref._random_lights(n=300, seed=5), _random_lights()):
        assert np.array_equal(a, b)


def test_tree_rows_bit_identical(trees):
    jt, tt = trees
    assert np.array_equal(jt.rows.view(np.int32), tt.rows.view(np.int32))
    assert (jt.num_nodes, jt.levels) == (tt.num_nodes, tt.levels)


@pytest.mark.parametrize("blue_noise", [False, True])
@pytest.mark.parametrize("dk", [0, 9])
def test_descent_matches_reference(trees, blue_noise, dk):
    jt, tt = trees
    rng = np.random.default_rng(9 + dk)
    n = 2048
    p = [rng.uniform(-20, 20, n).astype(np.float32),
         rng.uniform(-2, 8, n).astype(np.float32),
         rng.uniform(-20, 20, n).astype(np.float32)]
    pid = np.arange(n, dtype=np.uint32)
    px = rng.integers(0, 1920, n).astype(np.int32)
    py = rng.integers(0, 1080, n).astype(np.int32)
    bn_j = jr.blue_base(jnp.asarray(px), jnp.asarray(py)) if blue_noise else None
    bn_t = tr.blue_base(torch.as_tensor(px), torch.as_tensor(py)) if blue_noise else None
    s_ref, p_ref, v_ref = j_sample(
        jnp.asarray(jt.rows), jt.num_nodes, jt.levels,
        JVec3(*map(jnp.asarray, p)), jnp.asarray(pid), jnp.uint32(4), dk,
        force="xla", bn=bn_j)
    slot, pdf, valid = LT.sample_light_tree(
        torch.as_tensor(tt.rows), tt.num_nodes, tt.levels,
        Vec3(*map(torch.as_tensor, p)), torch.as_tensor(pid.astype(np.int64)),
        torch.tensor(4), dk, bn=bn_t)
    assert np.array_equal(np.asarray(s_ref), slot.numpy())
    assert np.array_equal(np.asarray(v_ref), valid.numpy())
    ok = valid.numpy()
    assert ok.mean() > 0.9
    np.testing.assert_allclose(pdf.numpy()[ok], np.asarray(p_ref)[ok], rtol=1e-5)


def test_facing_panels_preferred():
    """Orientation cones: lights facing the query point win (the reference's
    test_light_tree.py facing test, through the port)."""
    rng = np.random.default_rng(2)
    n_half = 64
    base = rng.uniform(-6, 6, (2 * n_half, 3)).astype(np.float32)
    base[:, 1] = 5.0
    e_a = np.tile(np.array([[0.3, 0, 0]], np.float32), (n_half, 1))
    e_b = np.tile(np.array([[0, 0, 0.3]], np.float32), (n_half, 1))
    e1 = np.concatenate([e_a, e_b])
    e2 = np.concatenate([e_b, e_a])
    tree = LT.build_light_tree(
        base + (e1 + e2) / 3.0, np.stack([base, base + e1, base + e2], 1),
        np.full(2 * n_half, 5.0, np.float32),
        np.arange(2 * n_half, dtype=np.int32))
    n = 4096
    z = torch.zeros(n)
    slot, _, _ = LT.sample_light_tree(
        torch.as_tensor(tree.rows), tree.num_nodes, tree.levels, Vec3(z, z, z),
        torch.arange(n, dtype=torch.int64), torch.tensor(1), 0)
    assert (slot.numpy() < n_half).mean() > 0.85


def test_wrapper_takes_plain_path_on_cpu(trees):
    _, tt = trees
    n = 256
    rng = np.random.default_rng(1)
    pos = Vec3(*(torch.as_tensor(rng.uniform(-5, 5, n).astype(np.float32))
                 for _ in range(3)))
    rnd = torch.as_tensor(rng.random((tt.levels + 1, n)).astype(np.float32))
    rows = torch.as_tensor(tt.rows)
    before = LT.light_tree_descend.launches
    a = LT.light_tree_descend(rows, tt.num_nodes, tt.levels, pos, rnd)
    b = LT.light_tree_descend_plain(rows, tt.num_nodes, tt.levels, pos, rnd)
    assert LT.light_tree_descend.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)
