"""Camera post-processing: bloom pyramid, purkinje shift, film grain and
colour correction (port of ``luminary_tpu/ops/post.py``).

Dense ``[H, W, 3]`` float32 image passes on the image's device: a 13-tap
downsample / tent upsample mip chain blended by ``bloom_blend``, the
low-light rod-vision shift, per-channel colour gains and luminance-modulated
grain.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .random import RandomTarget, random_1d


def _downsample_13tap(img: torch.Tensor) -> torch.Tensor:
    """Half-res downsample with the 13-tap partial Karis pattern: four
    overlapping 2x2 boxes around a weighted centre box."""
    h, w, _ = img.shape
    h2, w2 = h // 2, w // 2
    dev = img.device

    def at(dy, dx):
        ys = torch.clamp(torch.arange(h2, device=dev) * 2 + dy, 0, h - 1)
        xs = torch.clamp(torch.arange(w2, device=dev) * 2 + dx, 0, w - 1)
        return img[ys][:, xs]

    c = (at(0, 0) + at(0, 1) + at(1, 0) + at(1, 1)) * 0.25
    tl = (at(-1, -1) + at(-1, 0) + at(0, -1) + at(0, 0)) * 0.25
    tr = (at(-1, 1) + at(-1, 2) + at(0, 1) + at(0, 2)) * 0.25
    bl = (at(1, -1) + at(1, 0) + at(2, -1) + at(2, 0)) * 0.25
    br = (at(1, 1) + at(1, 2) + at(2, 1) + at(2, 2)) * 0.25
    return c * 0.5 + (tl + tr + bl + br) * 0.125


def _upsample_tent(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize (half-pixel centres, edges clamped: the reference's
    ``jax.image.resize(..., "bilinear")`` when upsampling) followed by a
    separable 3x3 [1 2 1]/4 tent with edge padding."""
    up = F.interpolate(img.permute(2, 0, 1)[None], size=(out_h, out_w),
                       mode="bilinear", align_corners=False)[0].permute(1, 2, 0)
    k0, k1, k2 = 0.25, 0.5, 0.25
    p = torch.cat([up[:1], up, up[-1:]], dim=0)
    up = p[:-2] * k0 + p[1:-1] * k1 + p[2:] * k2
    p = torch.cat([up[:, :1], up, up[:, -1:]], dim=1)
    return p[:, :-2] * k0 + p[:, 1:-1] * k1 + p[:, 2:] * k2


def apply_bloom(img: torch.Tensor, blend) -> torch.Tensor:
    """Mip-pyramid bloom blended into the frame (blend = camera.bloom_blend)."""
    h, w, _ = img.shape
    num_mips = 0
    mh, mw = h, w
    while mh >= 16 and mw >= 16 and num_mips < 8:
        mh //= 2
        mw //= 2
        num_mips += 1
    if num_mips == 0:
        return img
    blend = torch.clamp(torch.as_tensor(blend, dtype=torch.float32,
                                        device=img.device), 0.0, 1.0)
    mips = []
    cur = img
    for _ in range(num_mips):
        cur = _downsample_13tap(cur)
        mips.append(cur)
    acc = mips[-1]
    for level in range(num_mips - 2, -1, -1):
        th, tw = mips[level].shape[0], mips[level].shape[1]
        acc = mips[level] + _upsample_tent(acc, th, tw)
    bloom = _upsample_tent(acc, h, w) / num_mips
    return img * (1.0 - blend) + bloom * blend


def apply_purkinje(img: torch.Tensor, kappa1, kappa2) -> torch.Tensor:
    """Purkinje low-light blue shift: the rod response desaturates and
    blue-shifts scotopic regions."""
    scotopic = -0.702 * img[..., 0] + 1.039 * img[..., 1] + 0.433 * img[..., 2]
    scotopic = torch.clamp(scotopic, min=0.0)[..., None]
    photopic = (0.2126 * img[..., 0] + 0.7152 * img[..., 1]
                + 0.0722 * img[..., 2])[..., None]
    rod_weight = torch.exp(-photopic / torch.clamp(kappa1, min=1e-5))
    tint = torch.tensor([0.25, 0.45, 1.0], dtype=torch.float32,
                        device=img.device)
    rod_color = scotopic * tint * (1.0 + kappa2)
    return img * (1.0 - rod_weight) + rod_color * rod_weight


def apply_color_correction(img: torch.Tensor, correction) -> torch.Tensor:
    """Per-channel exposure-style gains from rgb deltas in [-1, 1]."""
    corr = torch.as_tensor(correction, dtype=torch.float32, device=img.device)
    return img * torch.exp2(corr * 2.0)


def apply_film_grain(img: torch.Tensor, strength, seed: int) -> torch.Tensor:
    """Luminance-modulated random grain."""
    h, w, _ = img.shape
    pid = torch.arange(h * w, dtype=torch.int64, device=img.device).reshape(h, w)
    g = random_1d(RandomTarget.DITHER, pid, (int(seed) + 1) & 0xFFFFFFFF)
    grain = (g - 0.5)[..., None] * strength
    return torch.clamp(img * (1.0 + grain), min=0.0)
