"""Adaptive sampling and checkpoint/resume of the port.

Against the JAX package on the same numpy inputs: ``block_error_map``
(within rtol 1e-5), ``allocate_stage_tasks`` and ``pick_stage_pixels``
(exact), ``scatter_add_stage`` (exact counts, sums within rtol 1e-6). Port
only: a resumed render is bit-identical to an unbroken one, uniform and
adaptive, and a checkpoint of another configuration is refused."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from luminary_tpu.render import adaptive as jad
from luminary_tpu_torch.render import adaptive as tad
from luminary_tpu_torch.render.renderer import Renderer
from luminary_tpu_torch.testing import cornell_scene

torch.set_num_threads(1)


def _moments(width, height, seed, pad=29):
    """Accumulators with per-pixel counts 1-12 and a noisy region."""
    n = width * height
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 13, n + pad).astype(np.int32)
    mean = np.exp(rng.normal(-1.0, 1.0, (n + pad, 3))).astype(np.float32)
    rad = (mean * counts[:, None]).astype(np.float32)
    lum = 0.2126 * mean[:, 0] + 0.7152 * mean[:, 1] + 0.0722 * mean[:, 2]
    noise = rng.random(n + pad).astype(np.float32)
    noise[: n // 3] *= 40.0
    lsq = (counts * lum * lum * (1.0 + noise)).astype(np.float32)
    return rad, lsq, counts


SIZES = [(16, 16), (24, 20), (18, 13)]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("aware", [False, True])
def test_block_error_map_matches(size, aware):
    w, h = size
    rad, lsq, cnt = _moments(w, h, w * h)
    got = tad.block_error_map(torch.as_tensor(rad), torch.as_tensor(lsq),
                              torch.as_tensor(cnt), w, h, aware, 1.7)
    ref = np.asarray(jad.block_error_map(jnp.asarray(rad), jnp.asarray(lsq),
                                         jnp.asarray(cnt), w, h, aware,
                                         jnp.float32(1.7)))
    assert got.shape == ref.shape == (h // 4, w // 4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-12)


def _errors(hb, wb, seed):
    rng = np.random.default_rng(seed)
    err = np.exp(rng.normal(-4.0, 2.0, (hb, wb))).astype(np.float32)
    err[0, 0] = 5e-5  # converged blocks
    err.reshape(-1)[::7] = 0.0
    err.reshape(-1)[3] = err.reshape(-1)[5]  # a tie
    return err


@pytest.mark.parametrize("budget", [None, 16, 100, 10_000])
@pytest.mark.parametrize("size", SIZES)
def test_allocate_stage_tasks_exact(size, budget):
    w, h = size
    err = _errors(h // 4, w // 4, w + h)
    got = tad.allocate_stage_tasks(err, w, h, 3, 9, budget_tasks=budget)
    ref = jad.allocate_stage_tasks(err, w, h, 3, 9, budget_tasks=budget)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    conv = np.full((h // 4, w // 4), 1e-5, np.float32)
    assert tad.allocate_stage_tasks(conv, w, h, 2) == (None, None)


@pytest.mark.parametrize("budget", [1, 48, 1000])
def test_pick_stage_pixels_exact(budget):
    err = _errors(5, 6, 3)
    got = tad.pick_stage_pixels(err, 24, 20, budget)
    ref = jad.pick_stage_pixels(err, 24, 20, budget)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == ref.dtype
    assert tad.pick_stage_pixels(np.zeros((5, 6), np.float32), 24, 20, 64) is None


def test_scatter_add_stage_matches():
    n, s = 300, 200
    rad, lsq, cnt = _moments(15, 20, 5, pad=0)
    rng = np.random.default_rng(9)
    idx = rng.integers(0, n, s).astype(np.int32)  # repeated pixels add up
    srad = rng.random((s, 3), dtype=np.float32)
    slsq = rng.random(s, dtype=np.float32)
    scnt = np.full(s, 4, np.int32)
    got = tad.scatter_add_stage(torch.as_tensor(rad), torch.as_tensor(lsq),
                                torch.as_tensor(cnt), torch.as_tensor(idx),
                                torch.as_tensor(srad), torch.as_tensor(slsq),
                                torch.as_tensor(scnt))
    ref = jad.scatter_add_stage(jnp.asarray(rad), jnp.asarray(lsq),
                                jnp.asarray(cnt), jnp.asarray(idx),
                                jnp.asarray(srad), jnp.asarray(slsq),
                                jnp.asarray(scnt))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert got[2].dtype == torch.int32
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)


def _renderer(adaptive=False):
    s = cornell_scene(16, 16, max_depth=2)
    if adaptive:
        st = s.get_entity("settings")
        st.enable_adaptive_sampling = True
        s.set_entity("settings", st)
    return Renderer(s, device="cpu")


@pytest.mark.parametrize("adaptive", [False, True])
def test_checkpoint_resume_bit_identical(tmp_path, adaptive):
    path = str(tmp_path / "ckpt.npz")
    unbroken = _renderer(adaptive)
    unbroken.render_samples(3)
    unbroken.save_checkpoint(path)
    unbroken.render_samples(3)
    resumed = _renderer(adaptive)
    resumed.load_checkpoint(path)
    resumed.render_samples(3)
    for a, b in zip(unbroken.accum, resumed.accum):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with np.load(path) as z:
        assert sorted(z.files) == ["fingerprint", "lum_sq", "radiance",
                                   "sample_count"]
        assert (z["radiance"].dtype, z["lum_sq"].dtype, z["sample_count"].dtype,
                z["fingerprint"].dtype) == (np.float32, np.float32, np.int32,
                                            np.int64)
    if adaptive:
        assert len(np.unique(unbroken.accum.sample_count[:256].numpy())) > 1


def test_checkpoint_fingerprint_mismatch_raises(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    r = _renderer()
    r.render_samples(1)
    r.save_checkpoint(path)
    other = Renderer(cornell_scene(16, 16, max_depth=3), device="cpu")
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        other.load_checkpoint(path)
    assert other.sample_count == 0
