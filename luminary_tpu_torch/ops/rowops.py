"""Row gathers handed out as structure-of-arrays columns (port of
``luminary_tpu/ops/rowops.py``) — kernel A, ``csrc/gather_soa.cu``.

``gather_soa(table, idx, n_cols, sub_stride)`` computes
``out[c, i] = table[k // s, c*s + k % s]`` with ``k = idx[i]`` and
``s = sub_stride``. With ``s = 1`` it is ``gather_planar`` (a row gather
followed by the ``[N, C] -> [C, N]`` transpose); with ``s = 8`` it is the
JAX package's packed shade-row select. The port stores its shade table one
slot per row, so the main path runs it with ``s = 1``.

``unplanar(cols)`` is the inverse layout change, ``[C, N] -> [N, C]``: C
planar columns of 32-bit words become one row of C words per lane (same
source file). The port packs the ray lanes that kernel B reads with it.

A CUDA table goes through the kernel (or the call raises); a CPU table goes
through :func:`gather_soa_plain` (:func:`unplanar_plain`). Indices follow
JAX's ``table[idx]``: floor division, negative rows wrap once, then clamp.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels


def gather_soa_plain(table: torch.Tensor, idx: torch.Tensor, n_cols: int,
                     sub_stride: int = 1) -> torch.Tensor:
    """Plain PyTorch version of kernel A (same index semantics)."""
    rows = table.shape[0]
    k = idx.to(torch.int64)
    r = torch.div(k, sub_stride, rounding_mode="floor")
    s = k - r * sub_stride
    r = torch.where(r < 0, r + rows, r).clamp(0, rows - 1)
    cols = (torch.arange(n_cols, device=table.device) * sub_stride)[:, None] + s[None, :]
    return table[r[None, :].expand(n_cols, -1), cols]


_argtypes_set = False


def _launch(table, idx, n_cols, sub_stride):
    global _argtypes_set
    lib = kernels.load("gather_soa")
    if not _argtypes_set:
        lib.lum_gather_soa.restype = ctypes.c_int
        lib.lum_gather_soa.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p]
        _argtypes_set = True
    if table.dim() != 2 or table.element_size() != 4:
        raise ValueError("gather_soa takes a 2-D table of 32-bit words")
    if n_cols * sub_stride > table.shape[1] or sub_stride < 1:
        raise ValueError("gather_soa: n_cols * sub_stride exceeds the row")
    table = table.contiguous()
    idx = idx.to(device=table.device, dtype=torch.int32).contiguous()
    n = idx.shape[0]
    out = torch.empty((n_cols, n), dtype=table.dtype, device=table.device)
    rc = lib.lum_gather_soa(
        table.data_ptr(), table.shape[0], table.shape[1], idx.data_ptr(), n,
        sub_stride, n_cols, out.data_ptr(), kernels.stream_handle(table.device))
    kernels.check(rc, "gather_soa")
    gather_soa.launches += 1
    key = (table.device, table.data_ptr())
    gather_soa.table_launches[key] = gather_soa.table_launches.get(key, 0) + 1
    return out


def gather_soa(table: torch.Tensor, idx: torch.Tensor, n_cols: int,
               sub_stride: int = 1) -> torch.Tensor:
    """Kernel A: ``[n_cols, N]`` columns of the rows ``idx`` selects."""
    if table.is_cuda:
        return _launch(table, idx, n_cols, sub_stride)
    if table.device.type != "cpu":
        raise RuntimeError("gather_soa runs on CUDA or CPU tensors only")
    return gather_soa_plain(table, idx, n_cols, sub_stride)


gather_soa.launches = 0
# launches by the table's (device, data pointer)
gather_soa.table_launches = {}


def gather_planar(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [P, C], idx [N] -> planar [C, N] component rows."""
    return gather_soa(table, idx, table.shape[1], 1)


def gather_packed_planar(table: torch.Tensor, slot: torch.Tensor,
                         n_cols: int, sub_stride: int = 1) -> torch.Tensor:
    """Shade-row fetch → planar [n_cols, N] logical columns. The port's
    tables are one slot per row (``sub_stride=1``); 8 reads the JAX
    package's interleaved layout."""
    return gather_soa(table, slot, n_cols, sub_stride)


UNPLANAR_MAX_COLS = 32  # csrc/gather_soa.cu UNPLANAR_MAX_COLS


def unplanar_plain(cols) -> torch.Tensor:
    """Plain PyTorch version of the unplanar kernel: ``[N, C]`` int32 words,
    ``out[i, c] = cols[c][i]``."""
    n = cols[0].shape[0]
    out = torch.empty((n, len(cols)), dtype=torch.int32, device=cols[0].device)
    for c, col in enumerate(cols):
        out[:, c] = col.view(torch.int32)
    return out


_unplanar_argtypes_set = False


def _launch_unplanar(cols):
    global _unplanar_argtypes_set
    lib = kernels.load("gather_soa")
    if not _unplanar_argtypes_set:
        lib.lum_unplanar.restype = ctypes.c_int
        lib.lum_unplanar.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p]
        _unplanar_argtypes_set = True
    c_n = len(cols)
    dev = cols[0].device
    n = cols[0].shape[0]
    cols = [c.contiguous() for c in cols]
    for c in cols:
        if c.shape != (n,) or c.element_size() != 4 or c.device != dev:
            raise ValueError("unplanar takes [N] columns of 32-bit words on "
                             "one device")
    out = torch.empty((n, c_n), dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * c_n)(*(c.data_ptr() for c in cols))
    rc = lib.lum_unplanar(ptrs, c_n, n, out.data_ptr(),
                          kernels.stream_handle(dev))
    kernels.check(rc, "unplanar")
    unplanar.launches += 1
    return out


def unplanar(cols) -> torch.Tensor:
    """``[C, N] -> [N, C]``: the C planar ``[N]`` columns (32-bit words, the
    rows of a ``[C, N]`` tensor or separate lane tensors) as ``[N, C]``
    int32 rows."""
    if not 1 <= len(cols) <= UNPLANAR_MAX_COLS:
        raise ValueError("unplanar takes 1 to %d columns, got %d"
                         % (UNPLANAR_MAX_COLS, len(cols)))
    dev = cols[0].device
    if dev.type == "cuda":
        return _launch_unplanar(cols)
    if dev.type != "cpu":
        raise RuntimeError("unplanar runs on CUDA or CPU tensors only")
    return unplanar_plain(cols)


unplanar.launches = 0
