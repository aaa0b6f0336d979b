"""The port's random streams against ``luminary_tpu/ops/random.py``, bit for
bit: the renderer draws nothing from a generator, so every stochastic
decision depends on these hashes and they must be exactly equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from luminary_tpu.ops import random as jr
from luminary_tpu_torch.ops import random as tr

torch.set_num_threads(1)

N_PER_CASE = 2000
TARGETS = list(range(int(jr.RandomTarget.NUM_TARGETS)))
DEPTHS = (0, 9)  # 26 targets x 2 depths x 2000 lanes ≈ 10^5 keys


def _lanes(seed):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, 2**32, N_PER_CASE, dtype=np.uint64).astype(np.uint32)
    sid = rng.integers(0, 2**32, N_PER_CASE, dtype=np.uint64).astype(np.uint32)
    px = rng.integers(0, 4096, N_PER_CASE).astype(np.int32)
    py = rng.integers(0, 4096, N_PER_CASE).astype(np.int32)
    return pid, sid, px, py


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("fn", ["random_1d", "random_2d", "quasi_2d"])
def test_hash_streams_exact(fn):
    for target in TARGETS:
        for depth in DEPTHS:
            pid, sid, _, _ = _lanes(target * 17 + depth)
            ref = np.asarray(getattr(jr, fn)(target, jnp.asarray(pid),
                                             jnp.asarray(sid), depth))
            got = getattr(tr, fn)(target, _t(pid), _t(sid), depth).numpy()
            assert np.array_equal(ref, got), (fn, target, depth)


@pytest.mark.parametrize("fn", ["random_1d", "random_2d"])
def test_blue_noise_streams_exact(fn):
    for target in TARGETS:
        for depth in DEPTHS:
            pid, sid, px, py = _lanes(1000 + target * 17 + depth)
            bn_j = jr.blue_base(jnp.asarray(px), jnp.asarray(py))
            bn_t = tr.blue_base(torch.as_tensor(px), torch.as_tensor(py))
            ref = np.asarray(getattr(jr, fn)(target, jnp.asarray(pid),
                                             jnp.asarray(sid), depth, bn=bn_j))
            got = getattr(tr, fn)(target, _t(pid), _t(sid), depth,
                                  bn=bn_t).numpy()
            assert np.array_equal(ref, got), (fn, target, depth)


def test_blue_base_exact():
    _, _, px, py = _lanes(7)
    ref = jr.blue_base(jnp.asarray(px), jnp.asarray(py))
    got = tr.blue_base(torch.as_tensor(px), torch.as_tensor(py))
    assert len(ref) == len(got) == tr.BN_CHANNELS
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a).astype(np.int64), b.numpy())


def test_scalar_sample_id_broadcasts_exactly():
    """The renderer passes one 0-d sample id; it must equal the per-lane
    broadcast the reference uses."""
    pid, _, px, py = _lanes(11)
    bn_t = tr.blue_base(torch.as_tensor(px), torch.as_tensor(py))
    lanes = torch.full((N_PER_CASE,), 12345, dtype=torch.int64)
    scalar = torch.tensor(12345, dtype=torch.int64)
    for target in (3, 5, 24):
        a = tr.random_2d(target, _t(pid), lanes, 2, bn=bn_t)
        b = tr.random_2d(target, _t(pid), scalar, 2, bn=bn_t)
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["_reverse_bits", "_sobol_dim2", "_mix"])
def test_u32_primitives_exact(name):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(getattr(jr, name)(jnp.asarray(x))).astype(np.int64)
    got = getattr(tr, name)(_t(x)).numpy()
    assert np.array_equal(ref, got)


def test_owen_scramble_exact():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    seed = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(jr._nested_uniform_scramble(
        jnp.asarray(x), jnp.asarray(seed))).astype(np.int64)
    got = tr._nested_uniform_scramble(_t(x), _t(seed)).numpy()
    assert np.array_equal(ref, got)
    ref = np.asarray(jr._laine_karras(jnp.asarray(x), jnp.asarray(seed))).astype(np.int64)
    assert np.array_equal(ref, tr._laine_karras(_t(x), _t(seed)).numpy())
