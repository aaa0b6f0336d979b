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


import torch

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


def gather_soa(table: torch.Tensor, idx: torch.Tensor, n_cols: int,
               sub_stride: int = 1) -> torch.Tensor:
    """Kernel A: ``[n_cols, N]`` columns of the rows ``idx`` selects."""
    return gather_soa_plain(table, idx, n_cols, sub_stride)


# launches by the table's (device, data pointer)


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


def unplanar(cols) -> torch.Tensor:
    """``[C, N] -> [N, C]``: the C planar ``[N]`` columns (32-bit words, the
    rows of a ``[C, N]`` tensor or separate lane tensors) as ``[N, C]``
    int32 rows."""
    if not 1 <= len(cols) <= UNPLANAR_MAX_COLS:
        raise ValueError("unplanar takes 1 to %d columns, got %d"
                         % (UNPLANAR_MAX_COLS, len(cols)))
    return unplanar_plain(cols)


