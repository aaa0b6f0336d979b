"""Dimension-allocated quasi/pseudo random sampling (port of
``luminary_tpu/ops/random.py``, bit for bit).

Every stochastic decision draws from its own ``RandomTarget`` dimension keyed
on (pixel, sample, depth, target). The JAX package does its hashing in uint32;
PyTorch's uint32 support is partial, so here every u32 word lives in an int64
tensor holding a value in ``[0, 2**32)`` and every product, sum and left
shift is masked back to 32 bits. Right shifts of such values are logical, as
in the reference. The same helpers accept Python ints, which is how the
per-dimension salts are computed once on the host.
"""

from __future__ import annotations

import functools
import os
from enum import IntEnum

import numpy as np
import torch


class RandomTarget(IntEnum):
    """One dimension per sampling decision (the reference's allocation)."""

    CAMERA_JITTER = 0
    LENS = 1
    LENS_BLADE = 2
    BSDF_REFLECTION = 3
    BSDF_REFRACTION = 4
    BSDF_CHOICE = 5
    RUSSIAN_ROULETTE = 6
    LIGHT_TREE = 7
    LIGHT_TRIANGLE = 8
    LIGHT_SUN = 9
    LIGHT_AMBIENT = 10
    LIGHT_RIS = 11
    VOLUME_DISTANCE = 12
    VOLUME_PHASE = 13
    BRIDGE_VERTEX_COUNT = 14
    BRIDGE_PHASE = 15
    BRIDGE_DISTANCE = 16
    OCEAN_CAUSTICS = 17
    PARTICLE_PHASE = 18
    WAVELENGTH = 19
    DITHER = 20
    ADAPTIVE = 21
    MICROTRIANGLE = 22
    EMISSION_INDEX = 23
    LIGHT_TREE_LEVEL = 24
    ALPHA_TEST = 25

    NUM_TARGETS = 26


M32 = 0xFFFFFFFF
_DEPTH_STRIDE = int(RandomTarget.NUM_TARGETS)


def u32(x, device=None) -> torch.Tensor:
    """A u32 word (int, numpy or tensor) as an int64 tensor in [0, 2**32)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return torch.as_tensor(np.asarray(x, np.int64) & M32, device=device)


def _mix(x):
    """murmur3 fmix32 finalizer — full-avalanche 32-bit mixer."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & M32
    x = x ^ (x >> 16)
    return x


def _key(target, pixel_id, sample_id, depth):
    """Combine the 4-part key into well-mixed 32-bit state. ``depth`` is a
    Python int; pixel and sample ids are u32 words as from :func:`u32`."""
    t = (int(target) + _DEPTH_STRIDE * int(depth)) & M32
    h = pixel_id ^ ((sample_id * 0x85EBCA6B) & M32)
    h = (h + ((t * 0xC2B2AE35) & M32)) & M32
    return _mix(h ^ (h >> 15))


def _to_float(bits: torch.Tensor) -> torch.Tensor:
    """u32 word → float32 in [0, 1)."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def random_1d(target, pixel_id, sample_id, depth=0, bn=None) -> torch.Tensor:
    """One uniform float in [0,1) per element of pixel_id; ``bn`` switches to
    the Sobol + blue-noise construction (pixel_id is then unused)."""
    if bn is not None:
        return _blue_sobol(target, sample_id, depth, bn)[..., 0]
    return _to_float(_key(target, pixel_id, sample_id, depth))


def random_2d(target, pixel_id, sample_id, depth=0, bn=None) -> torch.Tensor:
    """``[..., 2]`` uniform floats; second dim decorrelated by one round."""
    if bn is not None:
        return _blue_sobol(target, sample_id, depth, bn)
    h = _key(target, pixel_id, sample_id, depth)
    h2 = ((h ^ 0x68BC21EB) * 0x846CA68B) & M32
    h2 = h2 ^ (h2 >> 16)
    return torch.stack([_to_float(h), _to_float(h2)], dim=-1)


def _reverse_bits(x):
    x = ((x & 0x55555555) << 1) | ((x & 0xAAAAAAAA) >> 1)
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    return ((x << 16) & M32) | (x >> 16)


def _sobol_dim2(index: torch.Tensor) -> torch.Tensor:
    """Second dimension of the Sobol (0,2)-sequence."""
    v = 1 << 31
    result = torch.zeros_like(index)
    for _ in range(32):
        result = torch.where((index & 1) != 0, result ^ v, result)
        index = index >> 1
        v = v ^ (v >> 1)
    return result


def _laine_karras(x, seed):
    """Hash-based per-digit permutation, LSB-avalanche-upward form."""
    x = (x + seed) & M32
    x = x ^ ((x * 0x6C50B47C) & M32)
    x = x ^ ((x * 0xB82F1E52) & M32)
    x = x ^ ((x * 0xC7AFE638) & M32)
    x = x ^ ((x * 0x8D22F6E6) & M32)
    return x


def _nested_uniform_scramble(x, seed):
    """Owen scrambling of the MSB-first digit tree via the LK permutation."""
    return _reverse_bits(_laine_karras(_reverse_bits(x), seed))


# R2 Kronecker constants in u32 fixed point.
_R2_PHI1 = 3242174889
_R2_PHI2 = 2447445413

_BN_PATH = os.path.join(
    os.path.dirname(__file__), "..", "data", "bluenoise_128.npy"
)
BN_CHANNELS = 16


@functools.lru_cache(maxsize=1)
def load_bluenoise() -> np.ndarray:
    """[16, 128, 128] uint32 fixed-point blue-noise rank masks (host numpy),
    from the repository's ``data/bluenoise_128.npy``."""
    f = np.load(_BN_PATH)  # [C, 128, 128] f32 in [0,1)
    out = (f * np.float32(2.0**32)).astype(np.int64).astype(np.uint32)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)  # one table per device
def _bn_rows(device: torch.device) -> torch.Tensor:
    mask = load_bluenoise()
    rows = np.ascontiguousarray(mask.reshape(mask.shape[0], -1).T)
    return torch.as_tensor(rows.astype(np.int64), device=device)  # [16384, C]


def blue_base(pixel_x: torch.Tensor, pixel_y: torch.Tensor):
    """Per-lane u32 mask values for this pixel: a tuple of C ``[N]`` words,
    gathered once per sample."""
    rows = _bn_rows(pixel_x.device)
    idx = ((pixel_y.to(torch.int64) & 127) * 128 + (pixel_x.to(torch.int64) & 127))
    r = rows.index_select(0, idx).T.contiguous()
    return tuple(r.unbind(0))


# Static channel-pair assignment (same table as the reference).
_BN_ASSIGN = {
    RandomTarget.BSDF_CHOICE: (0, 1),
    RandomTarget.BSDF_REFLECTION: (1, 2),
    RandomTarget.BSDF_REFRACTION: (2, 3),
    RandomTarget.LIGHT_RIS: (3, 4),
    RandomTarget.LIGHT_TREE: (4, 5),
    RandomTarget.LIGHT_TRIANGLE: (6, 7),
    RandomTarget.LIGHT_SUN: (8, 9),
    RandomTarget.LIGHT_AMBIENT: (10, 11),
    RandomTarget.RUSSIAN_ROULETTE: (12, 13),
    RandomTarget.ALPHA_TEST: (13, 14),
    RandomTarget.EMISSION_INDEX: (14, 15),
    RandomTarget.LIGHT_TREE_LEVEL: (15, 0),
    RandomTarget.LENS: (12, 13),
    RandomTarget.LENS_BLADE: (14, 15),
    RandomTarget.WAVELENGTH: (5, 6),
    RandomTarget.VOLUME_PHASE: (7, 8),
    RandomTarget.PARTICLE_PHASE: (9, 10),
    RandomTarget.VOLUME_DISTANCE: (11, 12),
}


def _bn_pick(target, depth):
    """Static (channel_x, channel_y) for a draw; depth hops by 7."""
    cx, cy = _BN_ASSIGN.get(
        RandomTarget(int(target)) if int(target) < int(RandomTarget.NUM_TARGETS)
        else -1,
        (int(target) * 2 % BN_CHANNELS, (int(target) * 2 + 9) % BN_CHANNELS),
    )
    d = int(depth)
    return (cx + 7 * d) % BN_CHANNELS, (cy + 7 * d) % BN_CHANNELS


def _blue_sobol(target, sample_id, depth, bn) -> torch.Tensor:
    """Owen-scrambled Sobol (0,2) point shared by all pixels of a sample,
    shifted per pixel by this dimension's blue-noise channel. The Sobol part
    depends on the sample id only, so a 0-d ``sample_id`` computes it once
    and broadcasts."""
    cx, cy = _bn_pick(target, depth)
    bx, by = bn[cx], bn[cy]
    dim = (int(target) + _DEPTH_STRIDE * int(depth)) & M32
    salt = _mix(((dim * 0x9E3779B9) + 0xFCBD6E15) & M32)
    idx = u32(sample_id, device=bx.device)
    shuffled = _nested_uniform_scramble(idx, _mix(salt))
    x = _reverse_bits(shuffled)
    y = _sobol_dim2(shuffled)
    x = _nested_uniform_scramble(x, _mix(salt ^ 0x1D8E4464))
    y = _nested_uniform_scramble(y, _mix(salt ^ 0x58F482D5))
    rot = (dim + 1) & M32
    x = (x + bx + ((rot * _R2_PHI1) & M32)) & M32
    y = (y + by + ((rot * _R2_PHI2) & M32)) & M32
    return torch.stack(torch.broadcast_tensors(_to_float(x), _to_float(y)),
                       dim=-1)


def quasi_2d(target, pixel_id, sample_id, depth=0) -> torch.Tensor:
    """Owen-scrambled Sobol (0,2) point, decorrelated per pixel/target."""
    idx = u32(sample_id, device=pixel_id.device)
    salt = _key(target, pixel_id, torch.zeros_like(idx), depth)
    shuffled = _nested_uniform_scramble(idx, _mix(salt))
    x = _reverse_bits(shuffled)
    y = _sobol_dim2(shuffled)
    x = _nested_uniform_scramble(x, _mix(salt ^ 0x1D8E4464))
    y = _nested_uniform_scramble(y, _mix(salt ^ 0x58F482D5))
    return torch.stack(torch.broadcast_tensors(_to_float(x), _to_float(y)),
                       dim=-1)
