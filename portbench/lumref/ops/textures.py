"""Texture atlas: per-texture mip pyramids in one row table and the
bilinear/trilinear fetch (port of ``luminary_tpu/ops/textures.py``).

Every 2D texture becomes a power-of-two page at about its own resolution
(``next_pow2(max(h, w))`` in ``[4, MAX_PAGE_RES]``) with a full box-filtered
mip pyramid, packed in host numpy exactly as the JAX package packs it. Texels
are stored as paired rows ``[texel rgba, x-neighbour rgba]`` in one flat
``rows [total_texels, 8]`` f32 table, so a bilinear tap reads two rows; the
page table ``[T, 16]`` i32 holds each texture's base row (col 0), level-0
resolution (col 1), level count (col 2) and level offsets (cols 3:14).

The fetch reads the row table with plain tensor indexing: in the JAX package
it is an XLA gather, not a Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

PAGE_RES = 256  # page resolution of textures with no 2D dims
MAX_PAGE_RES = 1024
MAX_LEVELS = 11  # 1024 ... 1


@dataclass
class DeviceTextures:
    rows: torch.Tensor  # f32 [total_texels, 8] ([1, 8] of ones when empty)
    page_table: torch.Tensor  # i32 [T, 16]
    num_pages: int


def page_resolution(shape) -> int:
    """Page resolution for a texture of pixel dims (h, w)."""
    m = max(int(shape[0]), int(shape[1]), 4)
    return int(min(1 << int(np.ceil(np.log2(m))), MAX_PAGE_RES))


def page_resolutions(textures) -> np.ndarray:
    """Per-texture level-0 page resolution (PAGE_RES for 3D textures)."""
    out = np.full(max(len(textures), 1), PAGE_RES, np.int32)
    for i, tex in enumerate(textures):
        f = tex.as_float()
        if f.ndim == 4:
            continue
        out[i] = page_resolution(f.shape[:2])
    return out


def _resize_area(img: np.ndarray, res: int) -> np.ndarray:
    """Resample to res x res by bilinear sampling of the source."""
    h, w = img.shape[:2]
    if h == res and w == res:
        return img.astype(np.float64)
    ys = (np.arange(res) + 0.5) * h / res - 0.5
    xs = (np.arange(res) + 0.5) * w / res - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    a = img[y0][:, x0] * (1 - fy) * (1 - fx)
    b = img[y0][:, x1] * (1 - fy) * fx
    c = img[y1][:, x0] * fy * (1 - fx)
    d = img[y1][:, x1] * fy * fx
    return a + b + c + d


def _page_rows(img: np.ndarray, res: int) -> tuple[np.ndarray, list, int]:
    """One page: mip pyramid (box halving) → (paired rows [stride, 8],
    level offsets, level count)."""
    num_levels = int(np.log2(res)) + 1
    offsets = []
    off = 0
    for lvl in range(num_levels):
        offsets.append(off)
        off += (res >> lvl) ** 2
    rows = np.zeros((off, 8), np.float32)
    level = _resize_area(img, res).astype(np.float32)
    for lvl in range(num_levels):
        r = res >> lvl
        flat = level.reshape(r * r, 4)
        neigh = np.roll(level, -1, axis=1).reshape(r * r, 4)  # repeat wrap
        rows[offsets[lvl]: offsets[lvl] + r * r, 0:4] = flat
        rows[offsets[lvl]: offsets[lvl] + r * r, 4:8] = neigh
        if r > 1:
            level = 0.25 * (level[0::2, 0::2] + level[1::2, 0::2]
                            + level[0::2, 1::2] + level[1::2, 1::2])
    return rows, offsets, num_levels


def pack_textures_np(textures) -> tuple[np.ndarray, np.ndarray, int]:
    """Scene texture list → (rows, page_table, num_pages) in numpy. 3D
    textures keep a degenerate page-table entry (res 1, one level, row 0)."""
    t = max(len(textures), 1)
    ptab = np.zeros((t, 16), np.int32)
    ptab[:, 1] = 1
    ptab[:, 2] = 1
    pages = []
    base = 0
    for i, tex in enumerate(textures):
        f = tex.as_float()
        if f.ndim == 4:
            continue
        if f.shape[-1] == 3:
            f = np.concatenate([f, np.ones_like(f[..., :1])], axis=-1)
        elif f.shape[-1] == 1:
            f = np.concatenate([f.repeat(3, -1), np.ones_like(f)], axis=-1)
        res = page_resolution(f.shape[:2])
        rows, offsets, levels = _page_rows(f[..., :4], res)
        ptab[i, 0] = base
        ptab[i, 1] = res
        ptab[i, 2] = levels
        ptab[i, 3: 3 + levels] = offsets
        pages.append(rows)
        base += rows.shape[0]
    rows = np.concatenate(pages, axis=0) if pages else np.ones((1, 8), np.float32)
    return rows, ptab, len(pages)


def pack_textures(textures, device) -> DeviceTextures:
    rows, ptab, n = pack_textures_np(textures)
    return DeviceTextures(rows=torch.as_tensor(rows, device=device),
                          page_table=torch.as_tensor(ptab, device=device),
                          num_pages=n)


def _bilinear_level(tex: DeviceTextures, prow, level, u, v):
    """One bilinear tap at an integer mip level (two row reads) → [N, 4].
    ``prow``: the lanes' page-table rows [N, 16]."""
    level = torch.minimum(level, prow[:, 2] - 1)
    resi = prow[:, 1] >> level
    res = resi.to(torch.float32)
    lvl_off = prow[:, 3:3 + MAX_LEVELS].gather(
        1, level.clamp(0, MAX_LEVELS - 1)[:, None].long())[:, 0]
    uu = u - torch.floor(u)
    vv = v - torch.floor(v)
    x = uu * res - 0.5
    y = vv * res - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = torch.remainder(x0.to(torch.int32), resi)  # repeat wrap
    y0i = torch.remainder(y0.to(torch.int32), resi)
    y1i = torch.remainder(y0i + 1, resi)
    base = prow[:, 0] + lvl_off
    r0 = tex.rows[(base + y0i * resi + x0i).long()]  # (x0, x0+1) at y0
    r1 = tex.rows[(base + y1i * resi + x0i).long()]
    top = r0[:, 0:4] * (1.0 - fx) + r0[:, 4:8] * fx
    bot = r1[:, 0:4] * (1.0 - fx) + r1[:, 4:8] * fx
    return top * (1.0 - fy) + bot * fy


def sample_atlas(tex: DeviceTextures, tex_id, u, v, lod=None,
                 trilinear: bool = True):
    """Mipmapped fetch → (r, g, b, a); ``tex_id < 0`` gives white.

    ``lod``: per-lane float mip level (None = level 0). ``trilinear`` lerps
    the two straddling levels (four row reads); False takes the lower
    level (two)."""
    present = tex_id >= 0
    # an id past the table reads its last entry, as JAX's gather clamps
    page = torch.where(present, tex_id, 0).long().clamp(
        max=tex.page_table.shape[0] - 1)
    prow = tex.page_table[page]
    if lod is None:
        out = _bilinear_level(tex, prow, torch.zeros_like(page, dtype=torch.int32),
                              u, v)
    else:
        lodc = torch.clamp(lod, 0.0, MAX_LEVELS - 1.0)
        l0 = lodc.to(torch.int32)
        if trilinear:
            fl = (lodc - l0.to(torch.float32))[:, None]
            out = (_bilinear_level(tex, prow, l0, u, v) * (1.0 - fl)
                   + _bilinear_level(tex, prow, l0 + 1, u, v) * fl)
        else:
            out = _bilinear_level(tex, prow, l0, u, v)
    out = torch.where(present[:, None], out, 1.0)
    return out[:, 0], out[:, 1], out[:, 2], out[:, 3]
