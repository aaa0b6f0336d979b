"""Minimal PNG encode/decode (pure Python, stdlib zlib).

The reference vendors zlib and implements PNG store/load in C (reference:
src/luminary/host/png.c). Here we implement the subset the renderer needs:
8-bit RGB/RGBA encode (the output path) and decode of common 8/16-bit
truecolor/palette PNGs (texture ingest). No interlacing.

A host copy of ``luminary_tpu/io/png.py``: the port keeps its own so that it
imports nothing of the JAX package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..utils.errors import FileIOError

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(path: str, image: np.ndarray) -> None:
    """Write uint8 [H, W, 3|4] (or float in [0,1], converted) as PNG."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(np.asarray(img, dtype=np.float32), 0.0, 1.0)
        img = (img * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    h, w, c = img.shape
    if c not in (3, 4):
        raise FileIOError(f"write_png: unsupported channel count {c}")
    color_type = 2 if c == 3 else 6
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    # Filter 0 (None) per scanline; zlib level 6 is a good speed/size tradeoff.
    raw = np.empty((h, 1 + w * c), dtype=np.uint8)
    raw[:, 0] = 0
    raw[:, 1:] = img.reshape(h, w * c)
    idat = zlib.compress(raw.tobytes(), 6)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", idat))
        f.write(_chunk(b"IEND", b""))


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = data.reshape(h, 1 + stride)
    filters = rows[:, 0]
    out = np.zeros((h, stride), dtype=np.uint8)
    for y in range(h):
        ft = int(filters[y])
        cur = rows[y, 1:].astype(np.int32)
        prev = out[y - 1].astype(np.int32) if y > 0 else np.zeros(stride, np.int32)
        if ft == 0:
            line = cur
        elif ft == 2:  # Up
            line = (cur + prev) & 0xFF
        else:
            # Sub/Average/Paeth need a left-to-right scan.
            line = np.zeros(stride, np.int32)
            for x in range(stride):
                a = line[x - bpp] if x >= bpp else 0
                b = prev[x]
                cc = prev[x - bpp] if x >= bpp else 0
                if ft == 1:
                    pred = a
                elif ft == 3:
                    pred = (a + b) >> 1
                elif ft == 4:
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                else:
                    raise FileIOError(f"png: bad filter {ft}")
                line[x] = (cur[x] + pred) & 0xFF
        out[y] = line.astype(np.uint8)
    return out


def read_png(path: str) -> np.ndarray:
    """Read a PNG into uint8/uint16 [H, W, C]."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIG:
        raise FileIOError(f"{path}: not a PNG file")
    pos = 8
    ihdr = None
    idat = []
    plte = None
    trns = None
    while pos < len(blob):
        (length,) = struct.unpack_from(">I", blob, pos)
        tag = blob[pos + 4 : pos + 8]
        payload = blob[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"PLTE":
            plte = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(payload, np.uint8)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise FileIOError(f"{path}: missing IHDR")
    w, h, depth, color_type, comp, filt, interlace = ihdr
    if interlace:
        raise FileIOError(f"{path}: interlaced PNG unsupported")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    if depth not in (8, 16):
        raise FileIOError(f"{path}: bit depth {depth} unsupported")
    bpp = channels * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + stride):
        raise FileIOError(f"{path}: bad IDAT size")
    flat = _unfilter(raw, h, stride, bpp)
    if depth == 16:
        img = flat.reshape(h, w, channels, 2)
        img = (img[..., 0].astype(np.uint16) << 8) | img[..., 1]
    else:
        img = flat.reshape(h, w, channels)
    if color_type == 3:
        if plte is None:
            raise FileIOError(f"{path}: palette PNG missing PLTE")
        rgb = plte[img[..., 0]]
        if trns is not None:
            a = np.full((h, w, 1), 255, np.uint8)
            idx = img[..., 0]
            mask = idx < len(trns)
            a[mask, 0] = trns[idx[mask]]
            img = np.concatenate([rgb, a], axis=-1)
        else:
            img = rgb
    return img
