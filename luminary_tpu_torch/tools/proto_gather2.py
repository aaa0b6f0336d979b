"""A dependent fetch chain and the traversal-body-shaped slab test on the
card (port of ``tools/proto_pallas_gather2.py``): kernel E's
``gather_chain`` (``csrc/gather_sum.cu``) and kernel F
(``csrc/slab_body.cu``).

The prototype measured, inside one kernel, a chain of 4096 row fetches in
which each row chooses the next index (E2c), and a per-call slab test of G
packets x 16 children x 8 rays with its rows already resident or fetched
one by one first (E5).

E2c's function is unchanged on the card, but its time no longer measures
one dependent fetch a step: the next index depends on a row only through
that row's own columns 0 and 1, so kernel E lists the visited rows from a
next-index table of all S rows in shared memory, fetches them all at once
and sums them in order. Its ns a step is the call's time over the steps;
the ordered float adds, not the fetches, bound it. On the TPU it took a marginal cost over chained
``fori_loop`` calls, ``(T2 - T1) / (K2 - K1)``, to see past the host; that
workaround is not ported: the device time of a launch is taken with CUDA
events around CUDA-graph replays, and one eager call's time, host
included, is printed beside it.

    python -m luminary_tpu_torch.tools.proto_gather2 [e2c|e5|all]

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
from .proto_gather import _aligned, _check_table

S = 8192
COLS = 128
ROWS_PER_CALL = 4096   # fetches in one chain (E2c)
SLAB_G = 1024          # packets per call (E5)
CHAIN_SEED = 1e-5      # idx_0 = int32(f32(1e-5) * 1e6) = 9
SLAB_SEED = 1e-5
FETCH_MODES = ("none", "scalarloop")


def _seed_tensor(seed, device) -> torch.Tensor:
    return torch.as_tensor(seed, dtype=torch.float32, device=device).reshape(1)


def _clamp_rows(k: torch.Tensor, rows: int) -> torch.Tensor:
    """A scalar ``ref[k]`` index in interpret mode: wrap once, then clamp."""
    k = k.to(torch.int32).to(torch.int64)
    return torch.where(k < 0, k + rows, k).clamp(0, rows - 1)


def gather_chain_plain(tab: torch.Tensor, seed, steps: int = ROWS_PER_CALL
                       ) -> torch.Tensor:
    """Plain PyTorch version of kernel E's ``gather_chain``: ``[1, cols]``,
    the rows of a chain of ``steps`` fetches added in order. ``idx_0 =
    floormod(int32(f32(seed) * 1e6), S)``; each step adds its row and takes
    ``floormod(floormod(int32(f32(idx) + row[0] * 0 + 1), S) + (row[1] > 2),
    S)`` as the next index (int32 truncates toward zero)."""
    rows = tab.shape[0]
    s = _seed_tensor(seed, tab.device)
    idx = torch.remainder((s * 1e6).to(torch.int32), rows)
    acc = torch.zeros(tab.shape[1], dtype=tab.dtype, device=tab.device)
    for _ in range(steps):
        row = tab[idx.long()][0]
        acc = acc + row
        nidx = torch.remainder(
            (idx.to(torch.float32) + row[0] * 0 + 1).to(torch.int32), rows)
        idx = torch.remainder(nidx + (row[1] > 2.0).to(torch.int32), rows)
    return acc[None]


def chain_rows(tab: np.ndarray, seed: float, steps: int = ROWS_PER_CALL
               ) -> np.ndarray:
    """The row indices a chain of ``steps`` fetches visits, replayed in
    numpy with the same float32 and integer steps (for the bytes a chain
    needs, and for tests that want its branch taken)."""
    rows = tab.shape[0]
    idx = int(np.float32(seed) * np.float32(1e6)) % rows
    seen = []
    for _ in range(steps):
        seen.append(idx)
        row = tab[idx]
        idx = (int(np.float32(idx) + row[0] * np.float32(0) + np.float32(1)) % rows
               + int(row[1] > 2)) % rows
    return np.array(seen)


def gather_chain(tab: torch.Tensor, seed, steps: int = ROWS_PER_CALL
                 ) -> torch.Tensor:
    """Kernel E's chain of ``steps`` row fetches, each row choosing the
    next, equal to :func:`gather_chain_plain` bit for bit (the rows are
    listed from a next-index table, fetched at once and summed in order).
    ``seed`` is a number or a one-element tensor; at most 128 columns,
    ``|seed| < 2147``."""
    _check_table(tab, 128)
    if tab.device.type == "cpu":
        return gather_chain_plain(tab, seed, steps)
    if not tab.is_cuda:
        raise RuntimeError("gather_chain runs on CUDA or CPU tensors only")
    tab = _aligned(tab)
    s = _seed_tensor(seed, tab.device)
    out = torch.empty((1, tab.shape[1]), dtype=torch.float32, device=tab.device)
    p, i32 = ctypes.c_void_p, ctypes.c_int
    fn = kernels.entry("gather_sum", "lum_gather_chain", [p, i32, i32, p, i32, p, p])
    kernels.check(fn(tab.data_ptr(), tab.shape[0], tab.shape[1], s.data_ptr(),
                     steps, out.data_ptr(), kernels.stream_handle(tab.device)),
                  "gather_chain")
    gather_chain.launches += 1
    return out


gather_chain.launches = 0


def slab_body_plain(tab: torch.Tensor, ox: torch.Tensor, seed,
                    fetch: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of kernel F, written as the prototype's kernel
    body: ``[1, G]``, per packet the nearest entry distance over its 16
    children and 8 rays plus the index of the first child that has it."""
    g = ox.shape[1]
    rows = tab[:g] if fetch is None else tab[_clamp_rows(fetch.reshape(-1),
                                                         tab.shape[0])]
    row_t = rows.t()  # [cols, G]
    lo_x, hi_x = row_t[0:16], row_t[16:32]
    lo_y, hi_y = row_t[32:48], row_t[48:64]
    lo_z, hi_z = row_t[64:80], row_t[80:96]
    o = (ox + _seed_tensor(seed, ox.device))[None]  # [1, 8, G]
    t1x = (lo_x[:, None, :] - o) * 1.7
    t2x = (hi_x[:, None, :] - o) * 1.7
    t1y = (lo_y[:, None, :] - o) * 0.3
    t2y = (hi_y[:, None, :] - o) * 0.3
    t1z = (lo_z[:, None, :] - o) * 1.1
    t2z = (hi_z[:, None, :] - o) * 1.1
    enter = torch.maximum(torch.maximum(torch.minimum(t1x, t2x),
                                        torch.minimum(t1y, t2y)),
                          torch.minimum(t1z, t2z))
    leave = torch.minimum(torch.minimum(torch.maximum(t1x, t2x),
                                        torch.maximum(t1y, t2y)),
                          torch.maximum(t1z, t2z))
    dist16 = torch.where(enter <= leave, enter,
                         torch.full_like(enter, float("inf"))).amin(dim=1)
    sel = torch.argmin(dist16, dim=0)
    return (dist16.amin(dim=0) + sel.to(torch.float32))[None]


def slab_body(tab: torch.Tensor, ox: torch.Tensor, seed,
              fetch: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel F: ``[1, G]`` for ``G = ox.shape[1]`` packets; rows
    ``tab[0:G]`` without ``fetch`` (fetch mode ``"none"``), else
    ``tab[fetch[g]]`` (``"scalarloop"``)."""
    if tab.dim() != 2 or tab.dtype != torch.float32 or tab.shape[1] < 96:
        raise ValueError("slab_body takes a float32 table of >= 96 columns")
    if ox.dim() != 2 or ox.shape[0] != 8 or ox.dtype != torch.float32:
        raise ValueError("slab_body takes [8, G] float32 ray origins")
    g = ox.shape[1]
    if fetch is None and g > tab.shape[0]:
        raise ValueError("fetch mode 'none' reads rows 0..G-1: G > table rows")
    if tab.device.type == "cpu":
        return slab_body_plain(tab, ox, seed, fetch)
    if not tab.is_cuda:
        raise RuntimeError("slab_body runs on CUDA or CPU tensors only")
    tab = tab.contiguous()
    ox = ox.to(tab.device).contiguous()
    s = _seed_tensor(seed, tab.device)
    f = None
    if fetch is not None:
        f = fetch.reshape(-1).to(device=tab.device, dtype=torch.int32).contiguous()
        if f.shape[0] != g:
            raise ValueError("slab_body takes one fetch index per packet")
    out = torch.empty((1, g), dtype=torch.float32, device=tab.device)
    p, i32 = ctypes.c_void_p, ctypes.c_int
    fn = kernels.entry("slab_body", "lum_slab_body", [p, i32, i32, p, p, p, i32, p, p])
    kernels.check(fn(tab.data_ptr(), tab.shape[0], tab.shape[1], ox.data_ptr(),
                     None if f is None else f.data_ptr(), s.data_ptr(), g,
                     out.data_ptr(), kernels.stream_handle(tab.device)),
                  "slab_body")
    slab_body.launches += 1
    return out


slab_body.launches = 0


def e2c_scalar_loop(s=S, cols=COLS, steps=ROWS_PER_CALL, chain_seed=CHAIN_SEED,
                    device=None, seed=0, iters=20):
    """E2c: one chain of ``steps`` row fetches, each row choosing the next,
    kernel E. The prototype's table (uniform in [0, 1)) never takes the
    ``row[1] > 2`` branch. The time a step is the call's over the steps:
    kernel E lists the rows first, so it is not one dependent fetch."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    tab = torch.as_tensor(rng.random((s, cols), dtype=np.float32)).to(dev)
    cs = _seed_tensor(chain_seed, dev)
    out = gather_chain(tab, cs, steps)
    ms = launch_ms(lambda: gather_chain(tab, cs, steps), dev, iters)
    call = time_ms(lambda: gather_chain(tab, cs, steps), dev, iters)
    print("E2c scalar-loop fetch (gather_chain) on %s: %.1f us/call -> %.1f "
          "ns/step over the call (rows listed first, then summed in order: not "
          "one dependent fetch; %.1f Mrows/s; one eager call %.1f us)" % (
              dev.type, ms * 1e3, ms / steps * 1e6, steps / ms / 1e3, call * 1e3))
    return out, ms


def e5_slab_body(g=SLAB_G, fetch_mode="none", s=S, cols=COLS,
                 slab_seed=SLAB_SEED, device=None, seed=0, iters=20):
    """E5: the slab test of ``g`` packets, rows resident (``"none"``) or
    fetched by index (``"scalarloop"``), kernel F."""
    if fetch_mode not in FETCH_MODES:
        raise ValueError("fetch_mode must be one of %s" % (FETCH_MODES,))
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    tab = torch.as_tensor(rng.random((s, cols), dtype=np.float32)).to(dev)
    ox = torch.as_tensor(rng.random((8, g), dtype=np.float32)).to(dev)
    fetch = torch.as_tensor(rng.integers(0, s, (g, 1), dtype=np.int32)).to(dev)
    fetch = fetch if fetch_mode == "scalarloop" else None
    ss = _seed_tensor(slab_seed, dev)
    out = slab_body(tab, ox, ss, fetch)
    ms = launch_ms(lambda: slab_body(tab, ox, ss, fetch), dev, iters)
    call = time_ms(lambda: slab_body(tab, ox, ss, fetch), dev, iters)
    print("E5 slab body G=%d fetch=%s on %s: %.2f us/call (%.2f ns/packet-step; "
          "one eager call %.1f us)" % (g, fetch_mode, dev.type, ms * 1e3,
                                       ms / g * 1e6, call * 1e3))
    return out, ms


def main(which: str = "all", device=None, **sizes) -> dict:
    """Run E2c and/or E5 (both fetch modes); ``sizes`` (``s``, ``cols``,
    ``seed``, ``iters``) go to every experiment. Returns {name: (output,
    ms)}."""
    if which not in ("e2c", "e5", "all"):
        raise ValueError("which must be e2c, e5 or all, got %r" % which)
    dev, line = device_line(device)
    print(line)
    res = {}
    if which in ("e2c", "all"):
        res["e2c_scalar_loop"] = e2c_scalar_loop(device=dev, **sizes)
    if which in ("e5", "all"):
        for mode in FETCH_MODES:
            res["e5_slab_body." + mode] = e5_slab_body(
                fetch_mode=mode, device=dev, **sizes)
    return res


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "all")
