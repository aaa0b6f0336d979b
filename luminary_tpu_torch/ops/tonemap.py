"""Tonemapping, colour transforms, filters and dithering (port of
``luminary_tpu/ops/tonemap.py``).

The reference's camera post colour pipeline: the ACES, Reinhard, Uncharted2
and AGX operators, the LDR filters, sRGB encoding and the dithered 8-bit
quantisation. Every function takes and returns float32 tensors of
``[..., 3]`` and runs on the tensor's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .math3 import luminance
from .random import RandomTarget, random_1d, u32


# --- tonemap operators -----------------------------------------------------


def tm_aces(x: torch.Tensor) -> torch.Tensor:
    """Narkowicz's ACES filmic fit."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    x = x * 0.6
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def tm_reinhard(x: torch.Tensor) -> torch.Tensor:
    return x / (1.0 + luminance(x)[..., None])


def _uncharted2_curve(x):
    a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f


def tm_uncharted2(x: torch.Tensor) -> torch.Tensor:
    exposure_bias = 2.0
    white = _uncharted2_curve(torch.tensor(11.2, dtype=torch.float32,
                                           device=x.device))
    return torch.clamp(_uncharted2_curve(x * exposure_bias) / white, 0.0, 1.0)


# AGX (Troy Sobotka's AgX, Benjamin Wrensch's approximation constants).
_AGX_IN = np.asarray(
    [
        [0.842479062253094, 0.0423282422610123, 0.0423756549057051],
        [0.0784335999999992, 0.878468636469772, 0.0784336],
        [0.0792237451477643, 0.0791661274605434, 0.879142973793104],
    ]
)
_AGX_OUT = np.asarray(
    [
        [1.19687900512017, -0.0528968517574562, -0.0529716355144438],
        [-0.0980208811401368, 1.15190312990417, -0.0980434501171241],
        [-0.0990297440797205, -0.0989611768448433, 1.15107367264116],
    ]
)


def _mat(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(m.T.astype(np.float32), device=like.device)


def _agx_default_contrast(x):
    """6th-order polynomial sigmoid approximation."""
    x2 = x * x
    x4 = x2 * x2
    return (
        15.5 * x4 * x2
        - 40.14 * x4 * x
        + 31.96 * x4
        - 6.868 * x2 * x
        + 0.4298 * x2
        + 0.1191 * x
        - 0.00232
    )


def _agx_base(x: torch.Tensor) -> torch.Tensor:
    min_ev, max_ev = -12.47393, 4.026069
    x = x @ _mat(_AGX_IN, x)
    x = torch.clamp(torch.log2(torch.clamp(x, min=1e-10)), min_ev, max_ev)
    x = (x - min_ev) / (max_ev - min_ev)
    return _agx_default_contrast(x)


def _agx_look(x, offset, slope, power, saturation):
    lw = luminance(x)[..., None]
    x = torch.pow(torch.clamp(x * slope + offset, min=0.0), power)
    return lw + saturation * (x - lw)


def tm_agx(x: torch.Tensor, look: int = 0, custom=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """look: 0=default, 1=punchy, 2=custom(slope, power, saturation)."""
    v = _agx_base(x)
    if look == 1:
        v = _agx_look(v, 0.0, 1.0, 1.35, 1.4)
    elif look == 2:
        slope, power, saturation = custom
        v = _agx_look(v, 0.0, slope, power, saturation)
    v = v @ _mat(_AGX_OUT, v)
    return torch.clamp(v, 0.0, 1.0)


def apply_tonemap(x: torch.Tensor, tonemap: int,
                  agx_custom=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """Dispatch on the ToneMap enum."""
    if tonemap == 0:
        return torch.clamp(x, 0.0, 1.0)
    if tonemap == 1:
        return tm_aces(x)
    if tonemap == 2:
        return torch.clamp(tm_reinhard(x), 0.0, 1.0)
    if tonemap == 3:
        return tm_uncharted2(x)
    if tonemap == 4:
        return tm_agx(x, 0)
    if tonemap == 5:
        return tm_agx(x, 1)
    if tonemap == 6:
        return tm_agx(x, 2, agx_custom)
    raise ValueError(f"unknown tonemap {tonemap}")


# --- LDR filters ------------------------------------------------------------

_GAMEBOY = ((0.06, 0.22, 0.06), (0.19, 0.38, 0.19), (0.54, 0.67, 0.06),
            (0.61, 0.74, 0.06))


def apply_filter(x: torch.Tensor, filter_id: int) -> torch.Tensor:
    if filter_id == 0:
        return x
    lum = luminance(x)[..., None]
    if filter_id == 1:  # GRAY
        return lum.expand(x.shape)
    if filter_id == 2:  # SEPIA
        r = 0.393 * x[..., 0] + 0.769 * x[..., 1] + 0.189 * x[..., 2]
        g = 0.349 * x[..., 0] + 0.686 * x[..., 1] + 0.168 * x[..., 2]
        b = 0.272 * x[..., 0] + 0.534 * x[..., 1] + 0.131 * x[..., 2]
        return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)
    if filter_id == 3:  # GAMEBOY (4-level green)
        level = torch.round(torch.clamp(lum, 0.0, 1.0) * 3.0) / 3.0
        pal = torch.tensor(_GAMEBOY, dtype=torch.float32, device=x.device)
        idx = torch.round(level[..., 0] * 3.0).to(torch.int64)
        return pal[idx]
    if filter_id == 4:  # 2BITGRAY
        return (torch.round(torch.clamp(lum, 0.0, 1.0) * 3.0) / 3.0).expand(x.shape)
    if filter_id == 5:  # CRT: scanline darkening is spatial, in the output
        return x
    if filter_id == 6:  # BLACKWHITE
        return (lum > 0.5).to(x.dtype).expand(x.shape)
    raise ValueError(f"unknown filter {filter_id}")


def apply_crt_scanlines(img: torch.Tensor) -> torch.Tensor:
    """The CRT filter's spatial part on an [H, W, 3] image."""
    row = torch.arange(img.shape[0], device=img.device) % 3
    gain = torch.where(row == 0, 0.75, 1.0)[:, None, None]
    return img * gain


# --- sRGB + dither ----------------------------------------------------------


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(
        x <= 0.0031308, x * 12.92,
        1.055 * torch.pow(torch.clamp(x, min=1e-8), 1.0 / 2.4) - 0.055)


def dither_and_quantize(x: torch.Tensor, pixel_id: torch.Tensor, sample_id,
                        enabled: bool) -> torch.Tensor:
    """[..., 3] in [0, 1] → uint8 with a random dither before the 8-bit
    conversion (which truncates, as the reference's)."""
    v = x * 255.0
    if enabled:
        r = random_1d(RandomTarget.DITHER, u32(pixel_id),
                      u32(sample_id, device=x.device))[..., None]
        v = v + r
    else:
        v = v + 0.5
    return torch.clamp(v, 0.0, 255.0).to(torch.uint8)
