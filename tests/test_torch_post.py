"""The port's final image against the JAX package's: tonemap, LDR filters,
sRGB, bloom, purkinje, colour correction and grain on the same float inputs
(within rtol 1e-5), and ``_generate_image`` on the same accumulators at
16x16 (every tonemapper with filter 0, every filter with ACES, post on and
off, supersampling): the 8-bit images within one level everywhere and equal
on at least 99 % of values."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from luminary_tpu.ops import post as jpost
from luminary_tpu.ops import tonemap as jtm
from luminary_tpu.render.renderer import AccumState as JAccum
from luminary_tpu.render.renderer import _generate_image as j_generate_image
from luminary_tpu_torch.ops import post as tpost
from luminary_tpu_torch.ops import tonemap as ttm
from luminary_tpu_torch.render.renderer import AccumState as TAccum
from luminary_tpu_torch.render.renderer import _generate_image as t_generate_image

torch.set_num_threads(1)

RTOL = 1e-5
AGX_CUSTOM = (1.2, 0.9, 1.1)


def _hdr(shape, seed):
    """Linear radiance over ~8 stops, with exact zeros and a few fireflies."""
    rng = np.random.default_rng(seed)
    x = np.exp(rng.normal(-1.0, 1.6, shape)).astype(np.float32)
    x.reshape(-1)[::29] = 0.0
    x.reshape(-1)[::97] *= 50.0
    return x


def _close(got: torch.Tensor, ref, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(float(np.abs(ref).max()), 1e-6))


@pytest.mark.parametrize("tonemap", range(7))
def test_tonemap_matches(tonemap):
    x = _hdr((256, 3), 1)
    got = ttm.apply_tonemap(torch.as_tensor(x), tonemap,
                            torch.tensor(AGX_CUSTOM, dtype=torch.float32))
    ref = jtm.apply_tonemap(jnp.asarray(x), tonemap,
                            jnp.asarray(AGX_CUSTOM, jnp.float32))
    _close(got, ref)


@pytest.mark.parametrize("filter_id", range(7))
def test_filter_after_aces_matches(filter_id):
    x = ttm.tm_aces(torch.as_tensor(_hdr((256, 3), 2)))
    got = ttm.apply_filter(x, filter_id)
    ref = jtm.apply_filter(jnp.asarray(x.numpy()), filter_id)
    _close(got, ref)


def test_srgb_and_crt_match():
    x = np.random.default_rng(3).random((16, 16, 3), dtype=np.float32)
    x[0, :4, 0] = (0.0, 0.0031308, 1e-9, 1.0)
    _close(ttm.linear_to_srgb(torch.as_tensor(x)), jtm.linear_to_srgb(jnp.asarray(x)))
    _close(ttm.apply_crt_scanlines(torch.as_tensor(x)),
           jtm.apply_crt_scanlines(jnp.asarray(x)))


@pytest.mark.parametrize("shape", [(16, 16), (64, 40), (70, 45)])
def test_bloom_matches(shape):
    """Mip chains of 1 and 2 levels, and odd sizes (non-2x resizes)."""
    img = _hdr(shape + (3,), 4)
    got = tpost.apply_bloom(torch.as_tensor(img), torch.tensor(0.35))
    ref = jpost.apply_bloom(jnp.asarray(img), jnp.float32(0.35))
    _close(got, ref)
    if min(shape) >= 32:
        assert not np.allclose(got.numpy(), img)


@pytest.mark.parametrize("op", ["purkinje", "color_correction", "film_grain"])
def test_post_ops_match(op):
    img = _hdr((16, 16, 3), 5)
    ti, ji = torch.as_tensor(img), jnp.asarray(img)
    if op == "purkinje":
        got = tpost.apply_purkinje(ti, torch.tensor(0.2), torch.tensor(0.29))
        ref = jpost.apply_purkinje(ji, jnp.float32(0.2), jnp.float32(0.29))
    elif op == "color_correction":
        corr = (0.25, -0.5, 0.1)
        got = tpost.apply_color_correction(ti, torch.tensor(corr))
        ref = jpost.apply_color_correction(ji, jnp.asarray(corr, jnp.float32))
    else:
        got = tpost.apply_film_grain(ti, torch.tensor(0.3), 0)
        ref = jpost.apply_film_grain(ji, jnp.float32(0.3), 0)
    _close(got, ref)


def _accum(width, height, seed, pad=37):
    n = width * height
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 9, n + pad).astype(np.int32)
    counts[n:] = 0
    rad = _hdr((n + pad, 3), seed) * counts[:, None]
    lsq = (rad.sum(-1) ** 2 / np.maximum(counts, 1)).astype(np.float32)
    return rad.astype(np.float32), lsq, counts


# (tonemap, filter, post on, supersampling)
CASES = ([(t, 0, False, 1) for t in range(7)]
         + [(1, f, False, 1) for f in range(1, 7)]
         + [(1, 0, True, 1), (4, 5, True, 1), (6, 0, False, 2)])


@pytest.mark.parametrize("tonemap,filter_id,post,ss", CASES)
def test_generate_image_matches(tonemap, filter_id, post, ss):
    w, h = 16 * ss, 16 * ss
    rad, lsq, counts = _accum(w, h, 10 + tonemap * 7 + filter_id)
    args = [w, h, ss, 1.5, tonemap, filter_id, post, AGX_CUSTOM, post, 0.3,
            post, (0.2, 0.29), post, (0.2, -0.1, 0.05), post, 0.15]
    got = t_generate_image(
        TAccum(*(torch.as_tensor(a) for a in (rad, lsq, counts))), *args)
    jargs = list(args)
    for i in (3, 9, 15):
        jargs[i] = jnp.float32(jargs[i])
    for i in (7, 11, 13):
        jargs[i] = jnp.asarray(jargs[i], jnp.float32)
    ref = np.asarray(j_generate_image(
        JAccum(*(jnp.asarray(a) for a in (rad, lsq, counts))), *jargs))
    got = got.numpy()
    assert got.dtype == np.uint8 and got.shape == ref.shape == (16, 16, 3)
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.99, (diff != 0).sum()
    assert got.max() > 0


def test_dither_quantize_matches():
    x = np.random.default_rng(6).random((16, 16, 3), dtype=np.float32)
    pid = np.arange(256, dtype=np.uint32).reshape(16, 16)
    for enabled in (False, True):
        got = ttm.dither_and_quantize(torch.as_tensor(x),
                                      torch.as_tensor(pid.astype(np.int64)),
                                      torch.tensor(7, dtype=torch.int32), enabled)
        ref = jtm.dither_and_quantize(jnp.asarray(x), jnp.asarray(pid),
                                      jnp.int32(7), enabled)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
