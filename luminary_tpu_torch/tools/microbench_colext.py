"""Column-extraction cost on ``[N, k < 128]`` gather outputs, on the card
(port of ``tools/microbench_colext.py``), with kernel T
(``csrc/transpose.cu``) for its one Pallas kernel.

The integrator reads many columns of gathered rows in separate passes. The
patterns below measure, on a ``[N, 48]`` gather from a 164k-row table,
whether many column consumers, one transpose to planar rows first, or one
fused expression costs least:

- A: 10 independent column-expression consumers of the gathered rows;
- B: transpose once (``t().contiguous()``), then the same consumers on rows;
- C: one expression over all the columns;
- F: transpose once with kernel T, then the consumers on rows;
- aerial: a ``[N, 128]`` row mixing 16 knots x 3 components, read
  interleaved (``reshape(-1, 16, 3)``) or component-planar;
- (``main2``) D: stack 30 columns to planar, then the consumers; E: the
  gather alone, with random and with sorted indices.

A-E and the aerial patterns are plain PyTorch, as they are plain XLA in the
prototype. Eager PyTorch materialises every intermediate, so the
prototype's ``jax.lax.optimization_barrier`` (B, D) has no counterpart and
needs none. Its varied ``eps`` per call defeated a result cache of the TPU
runtime; there is none here, so ``eps`` is fixed. The data are the
prototype's own: ``numpy.random.default_rng(0)`` drawn in the same order.

    python -m luminary_tpu_torch.tools.microbench_colext [main|main2|all] [N]

(``main2`` takes the place of the prototype's ``PART2=1``.) Times are CUDA
events over 12 calls after 14 warm-up calls.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from .. import kernels
from . import device_line, time_ms

N = 1 << 21
P = 164 * 1024
WARMUP, ITERS = 14, 12
EPS = 1e-9


def transpose_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel T: ``[c, n]``, column by column."""
    return torch.stack([x[:, j] for j in range(x.shape[1])])


def transpose(x: torch.Tensor) -> torch.Tensor:
    """Kernel T: ``[n, c] -> [c, n]`` of a 2-D tensor of 32-bit words."""
    if x.dim() != 2 or x.element_size() != 4:
        raise ValueError("transpose takes a 2-D tensor of 32-bit words")
    if x.device.type == "cpu":
        return transpose_plain(x)
    if not x.is_cuda:
        raise RuntimeError("transpose runs on CUDA or CPU tensors only")
    x = x.contiguous()
    n, c = x.shape
    out = torch.empty((c, n), dtype=x.dtype, device=x.device)
    p = ctypes.c_void_p
    fn = kernels.entry("transpose", "lum_transpose",
                       [p, ctypes.c_longlong, ctypes.c_int, p, p])
    kernels.check(fn(x.data_ptr(), n, c, out.data_ptr(),
                     kernels.stream_handle(x.device)), "transpose")
    transpose.launches += 1
    return out


transpose.launches = 0


def _consumer_outs(col):
    return [col(c) * 2.0 + col(c + 1) * col(c + 2) for c in range(0, 30, 3)]


def _reduce(outs):
    return sum(o.sum() for o in outs[:3]) + sum((o * o).sum() for o in outs[3:])


def consumers_cols(row):
    return _reduce(_consumer_outs(lambda c: row[:, c]))


def consumers_rows(rt):
    return _reduce(_consumer_outs(lambda c: rt[c]))


def _steady(f, dev, warmup, iters):
    value = f()
    return time_ms(f, dev, iters, warmup), value


def main(n=N, p=P, device=None, warmup=WARMUP, iters=ITERS) -> dict:
    """Patterns A, B, C, F and the two aerial ones. Returns {label: (ms,
    scalar result)}."""
    dev, line = device_line(device)
    print(line)
    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.standard_normal((p, 48), np.float32)).to(dev)
    idx = torch.as_tensor(rng.integers(0, p, n).astype(np.int32)).to(dev).long()
    arow_t = torch.as_tensor(rng.standard_normal((2048, 128), np.float32)).to(dev)
    aidx = torch.as_tensor(rng.integers(0, 2048, n).astype(np.int32)).to(dev).long()
    sel_host = torch.as_tensor(rng.standard_normal((n, 16), np.float32)).to(dev)

    def pat_a():
        return consumers_cols(table[idx] + EPS)

    def pat_b():
        return consumers_rows((table[idx] + EPS).t().contiguous())

    def pat_c():
        row = table[idx] + EPS
        return sum(_consumer_outs(lambda c: row[:, c])).sum()

    def pat_f():
        return consumers_rows(transpose(table[idx] + EPS))

    def aerial_interleaved():
        cur = (arow_t[aidx] + EPS)[:, 0:48].reshape(-1, 16, 3)
        return ((cur[..., 0] * sel_host).sum(1) + (cur[..., 1] * sel_host).sum(1)
                + (cur[..., 2] * sel_host).sum(1)).sum()

    def aerial_planar():
        row = arow_t[aidx] + EPS
        return ((row[:, 0:16] * sel_host).sum(1) + (row[:, 16:32] * sel_host).sum(1)
                + (row[:, 32:48] * sel_host).sum(1)).sum()

    print("N=%d  table [%d,48]" % (n, p), flush=True)
    res = {}
    for label, f in (("A 10-consumer column reads ", pat_a),
                     ("B transpose+row slices     ", pat_b),
                     ("C single-expression columns", pat_c),
                     ("F kernel-T transpose planar", pat_f),
                     ("aerial interleaved reshape ", aerial_interleaved),
                     ("aerial component-planar    ", aerial_planar)):
        ms, value = _steady(f, dev, warmup, iters)
        print("%s: %8.3f ms" % (label, ms), flush=True)
        res[label.strip()] = (ms, value)
    return res


def main2(n=N, p=P, device=None, warmup=WARMUP, iters=ITERS) -> dict:
    """Patterns D, E and E on sorted indices. Returns {label: (ms, scalar
    result)}."""
    dev, line = device_line(device)
    print(line)
    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.standard_normal((p, 48), np.float32)).to(dev)
    idx = torch.as_tensor(rng.integers(0, p, n).astype(np.int32)).to(dev).long()
    idx_s = torch.sort(idx).values

    def pat_d():
        row = table[idx] + EPS
        return consumers_rows(torch.stack([row[:, c] for c in range(30)]))

    def pat_e(ix):
        return lambda: (table[ix] + EPS)[:, 0].sum()

    res = {}
    for label, f in (("D stack-to-planar + slices ", pat_d),
                     ("E gather alone             ", pat_e(idx)),
                     ("E gather alone (sorted idx)", pat_e(idx_s))):
        ms, value = _steady(f, dev, warmup, iters)
        print("%s: %8.3f ms" % (label, ms), flush=True)
        res[label.strip()] = (ms, value)
    return res


def cli(argv) -> dict:
    which = argv[0] if argv else "main"
    if which not in ("main", "main2", "all"):
        raise SystemExit("usage: microbench_colext [main|main2|all] [N]")
    n = int(argv[1]) if len(argv) > 1 else N
    res = {}
    if which in ("main", "all"):
        res.update(main(n))
    if which in ("main2", "all"):
        res.update(main2(n))
    return res


if __name__ == "__main__":
    cli(sys.argv[1:])
