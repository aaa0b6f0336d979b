"""Row gathers and a scalar-loop fetch on the card (port of
``tools/proto_pallas_gather.py``): kernel D (``csrc/gather_rows.cu``) and
kernel E's ``gather_sum`` (``csrc/gather_sum.cu``).

The prototype asked what a per-lane row gather from a table costs inside a
kernel (E1, E1b, E4), what K scalar-indexed row fetches summed in a loop
cost (E2), and what a one-hot matrix-unit gather costs (E3). On the H100
the same functions run as hand-written kernels; times come from CUDA
events
around CUDA-graph replays of the launches (device time; one eager call's
time, host included, beside it).

    python -m luminary_tpu_torch.tools.proto_gather [e1|e2|e3|e4|all]

Index rules. The prototypes differ on an index outside ``[0, S)``; the port
follows each one as it runs in Pallas's interpret mode on the CPU (the
reference the tests can run; Mosaic on a TPU may treat such indices
otherwise), chosen by ``mode``:

- ``"fill_nan"`` (E1 ``jnp.take``, E1b ``take_along_axis``): a negative
  index wraps once, an index still out of range gives a row of NaN;
- ``"clamp"`` (E4 ``ref[idx_vec]``, and E2's scalar ``ref[idx]``): wraps
  once, then clamps into ``[0, S - 1]``;
- ``"zero"`` (E3, one-hot): no wrap; out of range matches no row: zeros.

E3's product of a one-hot row with the bf16-rounded table, summed in f32, is
the gather of bf16-rounded rows (for finite tables), which is what kernel D
computes with ``round_bf16``; no matrix product runs.

A CUDA table goes through the kernel, or the call raises; a CPU table goes
through the plain version (``*_plain``).
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from . import device_line, launch_ms, time_ms

S = 8192          # table rows
COLS = 128
N = 64 * 1024     # rows gathered per call (E1, E1b, E4)
K = 2048          # rows summed per call (E2)
G = 512           # one-hot rows per call (E3)

MODES = {"fill_nan": 0, "clamp": 1, "zero": 2}


def _check_table(tab: torch.Tensor, max_cols: int | None = None) -> None:
    if tab.dim() != 2 or tab.dtype != torch.float32:
        raise ValueError("the table must be a 2-D float32 tensor")
    cols = tab.shape[1]
    if cols % 4 or cols == 0 or (max_cols is not None and cols > max_cols):
        raise ValueError("the table's row must be a positive multiple of 4 "
                         "columns%s, got %d" % (
                             "" if max_cols is None else " up to %d" % max_cols,
                             cols))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with the 16-byte alignment the kernels' float4 loads need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def gather_rows_plain(tab: torch.Tensor, idx: torch.Tensor, mode: str = "clamp",
                      round_bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version of kernel D: ``[n, cols]`` rows of ``tab`` at
    the ``n`` int32 indices ``idx`` (any shape, read flat), under ``mode``."""
    rows = tab.shape[0]
    k = idx.reshape(-1).to(torch.int32).to(torch.int64)
    if mode != "zero":
        k = torch.where(k < 0, k + rows, k)
    inside = (k >= 0) & (k < rows)
    out = tab[k.clamp(0, rows - 1)]
    if round_bf16:
        out = out.to(torch.bfloat16).to(torch.float32)
    if mode == "fill_nan":
        out[~inside] = float("nan")
    elif mode == "zero":
        out[~inside] = 0.0
    return out


def gather_rows(tab: torch.Tensor, idx: torch.Tensor, mode: str = "clamp",
                round_bf16: bool = False) -> torch.Tensor:
    """Kernel D: ``out[i, :] = tab[idx[i], :]`` with the index rule ``mode``
    (``"fill_nan"``, ``"clamp"`` or ``"zero"``) and, with ``round_bf16``,
    every value rounded to bf16 and widened back."""
    if mode not in MODES:
        raise ValueError("mode must be one of %s, got %r" % (sorted(MODES), mode))
    _check_table(tab)
    if tab.device.type == "cpu":
        return gather_rows_plain(tab, idx, mode, round_bf16)
    if not tab.is_cuda:
        raise RuntimeError("gather_rows runs on CUDA or CPU tensors only")
    tab = _aligned(tab)
    idx = idx.reshape(-1).to(device=tab.device, dtype=torch.int32).contiguous()
    n = idx.shape[0]
    out = torch.empty((n, tab.shape[1]), dtype=torch.float32, device=tab.device)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = kernels.entry("gather_rows", "lum_gather_rows",
                       [p, i64, i32, p, i64, i32, i32, p, p])
    kernels.check(fn(tab.data_ptr(), tab.shape[0], tab.shape[1], idx.data_ptr(),
                     n, MODES[mode], int(round_bf16), out.data_ptr(),
                     kernels.stream_handle(tab.device)), "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def gather_sum_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel E's ``gather_sum``: ``[1, cols]``, the
    rows at ``idx`` (``"clamp"`` rule) added one after another, in index
    order, from zeros."""
    rows = tab.shape[0]
    k = idx.reshape(-1).to(torch.int32).to(torch.int64)
    k = torch.where(k < 0, k + rows, k).clamp(0, rows - 1)
    picked = tab[k]
    acc = torch.zeros(tab.shape[1], dtype=tab.dtype, device=tab.device)
    for i in range(picked.shape[0]):
        acc = acc + picked[i]
    return acc[None]


def gather_sum(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel E: ``[1, cols]`` sum of the rows ``tab[idx[i]]`` over i, added
    in index order (bit-equal to :func:`gather_sum_plain`; a block per four
    columns, the rows fetched ahead of the adds); at most 128 columns."""
    _check_table(tab, 128)
    if tab.device.type == "cpu":
        return gather_sum_plain(tab, idx)
    if not tab.is_cuda:
        raise RuntimeError("gather_sum runs on CUDA or CPU tensors only")
    tab = _aligned(tab)
    idx = idx.reshape(-1).to(device=tab.device, dtype=torch.int32).contiguous()
    out = torch.empty((1, tab.shape[1]), dtype=torch.float32, device=tab.device)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = kernels.entry("gather_sum", "lum_gather_sum", [p, i64, i32, p, i64, p, p])
    kernels.check(fn(tab.data_ptr(), tab.shape[0], tab.shape[1], idx.data_ptr(),
                     idx.shape[0], out.data_ptr(),
                     kernels.stream_handle(tab.device)), "gather_sum")
    gather_sum.launches += 1
    return out


gather_sum.launches = 0


def _inputs(s, cols, n_idx, idx_shape, device, seed):
    rng = np.random.default_rng(seed)
    tab = torch.as_tensor(rng.random((s, cols), dtype=np.float32))
    idx = torch.as_tensor(rng.integers(0, s, n_idx, dtype=np.int32))
    return tab.to(device), idx.reshape(idx_shape).to(device)


def _gather_experiment(mode, round_bf16, idx_2d, s, cols, n, device, seed,
                       iters):
    dev = resolve_device(device)
    tab, idx = _inputs(s, cols, n, (n, 1) if idx_2d else (n,), dev, seed)
    out = gather_rows(tab, idx, mode, round_bf16)
    ms = launch_ms(lambda: gather_rows(tab, idx, mode, round_bf16), dev, iters)
    call = time_ms(lambda: gather_rows(tab, idx, mode, round_bf16), dev, iters)
    return out, ms, call, dev


def e1_take(s=S, cols=COLS, n=N, device=None, seed=0, iters=20):
    """E1: ``jnp.take(tab, idx, axis=0)``, kernel D with ``"fill_nan"``."""
    out, ms, call, dev = _gather_experiment("fill_nan", False, False, s, cols,
                                            n, device, seed, iters)
    print("E1 take (fill_nan) on %s: OK  %.4f ms -> %.1f Mrows/s, %.0f GB/s "
          "(one eager call %.4f ms)" % (dev.type, ms, n / ms / 1e3,
                                        n * cols * 4 / ms / 1e6, call))
    return out, ms


def e1b_takealong(s=S, cols=COLS, n=N, device=None, seed=0, iters=20):
    """E1b: ``take_along_axis`` with ``[n, 1]`` indices, the same rows."""
    out, ms, call, dev = _gather_experiment("fill_nan", False, True, s, cols,
                                            n, device, seed, iters)
    print("E1b take_along_axis (fill_nan) on %s: OK  %.4f ms -> %.1f Mrows/s, "
          "%.0f GB/s (one eager call %.4f ms)" % (
              dev.type, ms, n / ms / 1e3, n * cols * 4 / ms / 1e6, call))
    return out, ms


def e2_scalar_loop(s=S, cols=COLS, k=K, device=None, seed=0, iters=20):
    """E2: ``k`` scalar-indexed row fetches summed in order, kernel E."""
    dev = resolve_device(device)
    tab, idx = _inputs(s, cols, k, (k,), dev, seed)
    out = gather_sum(tab, idx)
    ms = launch_ms(lambda: gather_sum(tab, idx), dev, iters)
    call = time_ms(lambda: gather_sum(tab, idx), dev, iters)
    print("E2 scalar loop (gather_sum) on %s: OK  %.4f ms for %d rows -> "
          "%.2f Mrows/s  (%.1f ns/row; one eager call %.4f ms)" % (
              dev.type, ms, k, k / ms / 1e3, ms / k * 1e6, call))
    return out, ms


def e3_onehot(s=S, cols=COLS, g=G, device=None, seed=0, iters=20):
    """E3: one-hot ``[g, s] @ bf16(tab)``, kernel D with ``"zero"`` and
    bf16 rounding."""
    out, ms, call, dev = _gather_experiment("zero", True, True, s, cols, g,
                                            device, seed, iters)
    print("E3 onehot (bf16 rows) on %s: OK  %.4f ms for %d rows -> %.2f "
          "Mrows/s  (%.1f ns/row; one eager call %.4f ms)" % (
              dev.type, ms, g, g / ms / 1e3, ms / g * 1e6, call))
    return out, ms


def e4_dyn_slice_vec(s=S, cols=COLS, n=N, device=None, seed=0, iters=20):
    """E4: ``tab_ref[idx_vec, :]``, kernel D with ``"clamp"``."""
    out, ms, call, dev = _gather_experiment("clamp", False, False, s, cols, n,
                                            device, seed, iters)
    print("E4 ref[idx_vec] (clamp) on %s: OK  %.4f ms -> %.1f Mrows/s, "
          "%.0f GB/s (one eager call %.4f ms)" % (
              dev.type, ms, n / ms / 1e3, n * cols * 4 / ms / 1e6, call))
    return out, ms


def main(which: str = "all", device=None, **sizes) -> dict:
    """Run the experiments ``which`` selects, in the prototype's order;
    ``sizes`` (``s``, ``cols``, ``seed``, ``iters``) go to every experiment.
    Returns {experiment name: (output, ms)}."""
    if which not in ("e1", "e2", "e3", "e4", "all"):
        raise ValueError("which must be e1, e2, e3, e4 or all, got %r" % which)
    dev, line = device_line(device)
    print(line)
    res = {}
    if which in ("e1", "all"):
        res["e1_take"] = e1_take(device=dev, **sizes)
        res["e1b_takealong"] = e1b_takealong(device=dev, **sizes)
    if which in ("e4", "all"):
        res["e4_dyn_slice_vec"] = e4_dyn_slice_vec(device=dev, **sizes)
    if which in ("e2", "all"):
        res["e2_scalar_loop"] = e2_scalar_loop(device=dev, **sizes)
    if which in ("e3", "all"):
        res["e3_onehot"] = e3_onehot(device=dev, **sizes)
    return res


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "all")
