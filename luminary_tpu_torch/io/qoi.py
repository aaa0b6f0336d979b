"""QOI image decode/encode (reference embeds a QOI decoder: host/qoi.c,
include/qoi/ — used for embedded assets like the moon textures).

Pure-python implementation of the public QOI specification (qoiformat.org).
Decode is byte-serial by nature; this implementation walks the op stream
once in Python (fine for the asset sizes involved) and fills a numpy buffer.

A host copy of ``luminary_tpu/io/qoi.py``: the port keeps its own so that it
imports nothing of the JAX package.
"""

from __future__ import annotations

import struct

import numpy as np

from ..utils.errors import FileIOError

_MAGIC = b"qoif"

_OP_INDEX = 0x00
_OP_DIFF = 0x40
_OP_LUMA = 0x80
_OP_RUN = 0xC0
_OP_RGB = 0xFE
_OP_RGBA = 0xFF


def decode_qoi(data: bytes) -> np.ndarray:
    """QOI bytes → uint8 array [H, W, channels] (3 or 4)."""
    if len(data) < 22 or data[:4] != _MAGIC:
        raise FileIOError("not a QOI file")
    width, height = struct.unpack(">II", data[4:12])
    channels = data[12]
    if channels not in (3, 4):
        raise FileIOError(f"invalid QOI channel count {channels}")
    if width == 0 or height == 0 or width * height > 400_000_000:
        raise FileIOError(f"invalid QOI dimensions {width}x{height}")

    n = width * height
    out = np.empty((n, 4), np.uint8)
    index = np.zeros((64, 4), np.uint8)
    r, g, b, a = 0, 0, 0, 255
    p = 14
    i = 0
    data = memoryview(data)
    while i < n:
        if p >= len(data) - 7:
            raise FileIOError("truncated QOI stream")
        op = data[p]
        p += 1
        if op == _OP_RGB:
            r, g, b = data[p], data[p + 1], data[p + 2]
            p += 3
        elif op == _OP_RGBA:
            r, g, b, a = data[p], data[p + 1], data[p + 2], data[p + 3]
            p += 4
        else:
            tag = op & 0xC0
            if tag == _OP_INDEX:
                # plain ints: numpy uint8 scalars overflow in the hash below
                r, g, b, a = (int(v) for v in index[op & 0x3F])
            elif tag == _OP_DIFF:
                r = (r + ((op >> 4) & 0x03) - 2) & 0xFF
                g = (g + ((op >> 2) & 0x03) - 2) & 0xFF
                b = (b + (op & 0x03) - 2) & 0xFF
            elif tag == _OP_LUMA:
                dg = (op & 0x3F) - 32
                b2 = data[p]
                p += 1
                r = (r + dg - 8 + ((b2 >> 4) & 0x0F)) & 0xFF
                g = (g + dg) & 0xFF
                b = (b + dg - 8 + (b2 & 0x0F)) & 0xFF
            else:  # _OP_RUN
                run = (op & 0x3F) + 1
                out[i : i + run] = (r, g, b, a)
                i += run
                index[(r * 3 + g * 5 + b * 7 + a * 11) % 64] = (r, g, b, a)
                continue
        out[i] = (r, g, b, a)
        i += 1
        index[(r * 3 + g * 5 + b * 7 + a * 11) % 64] = (r, g, b, a)

    img = out.reshape(height, width, 4)
    return img[..., :3].copy() if channels == 3 else img


def encode_qoi(img: np.ndarray) -> bytes:
    """uint8 [H, W, 3|4] → QOI bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise FileIOError("encode_qoi expects uint8 [H, W, 3|4]")
    h, w, channels = img.shape
    if channels == 3:
        rgba = np.concatenate(
            [img, np.full((h, w, 1), 255, np.uint8)], axis=-1
        )
    else:
        rgba = img
    px = rgba.reshape(-1, 4)
    out = bytearray()
    out += _MAGIC
    out += struct.pack(">II", w, h)
    out += bytes([channels, 0])  # sRGB colorspace tag

    index = np.zeros((64, 4), np.uint8)
    prev = np.array([0, 0, 0, 255], np.int32)
    i = 0
    n = px.shape[0]
    while i < n:
        cur = px[i].astype(np.int32)
        if (cur == prev).all():
            run = 1
            while i + run < n and run < 62 and (px[i + run].astype(np.int32) == prev).all():
                run += 1
            out.append(_OP_RUN | (run - 1))
            i += run
            continue
        r, g, b, a = (int(x) for x in cur)
        hidx = (r * 3 + g * 5 + b * 7 + a * 11) % 64
        if (index[hidx].astype(np.int32) == cur).all():
            out.append(_OP_INDEX | hidx)
        elif a == int(prev[3]):
            dr = (r - int(prev[0]) + 128) % 256 - 128
            dg = (g - int(prev[1]) + 128) % 256 - 128
            db = (b - int(prev[2]) + 128) % 256 - 128
            if -2 <= dr <= 1 and -2 <= dg <= 1 and -2 <= db <= 1:
                out.append(_OP_DIFF | ((dr + 2) << 4) | ((dg + 2) << 2) | (db + 2))
            elif -32 <= dg <= 31 and -8 <= dr - dg <= 7 and -8 <= db - dg <= 7:
                out.append(_OP_LUMA | (dg + 32))
                out.append(((dr - dg + 8) << 4) | (db - dg + 8))
            else:
                out += bytes([_OP_RGB, r, g, b])
        else:
            out += bytes([_OP_RGBA, r, g, b, a])
        index[hidx] = cur
        prev = cur
        i += 1

    out += b"\x00\x00\x00\x00\x00\x00\x00\x01"
    return bytes(out)


def read_qoi(path: str) -> np.ndarray:
    try:
        with open(path, "rb") as f:
            return decode_qoi(f.read())
    except OSError as e:
        raise FileIOError(f"cannot read QOI file {path}: {e}") from e


def write_qoi(path: str, img: np.ndarray) -> None:
    try:
        with open(path, "wb") as f:
            f.write(encode_qoi(img))
    except OSError as e:
        raise FileIOError(f"cannot write QOI file {path}: {e}") from e
