"""The port of ``tools/microbench_colext.py``
(``luminary_tpu_torch/tools/microbench_colext.py``, kernel T) against the
prototype's own Pallas transpose in interpret mode.

The prototype reads ``N = int(sys.argv[1])`` when it is imported and keeps
its Pallas kernel ``_tkern`` inside ``main``. So it is imported with
``sys.argv`` set to ``["x", "4096"]`` (a multiple of its 2048-row blocks),
its table size ``P`` is set small, and ``main()`` runs once with
``pallas_call`` recorded and run in interpret mode (as in
``tests/test_torch_proto_gather.py``); the recorded kernel then runs on this
test's own input. No file of ``tools/`` is changed. A transpose moves
values, so the comparison is exact.

Kernel T's CUDA source runs here on g++ against the warp emulation with a
block barrier added, on ragged shapes.
"""

import ctypes
import sys

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from luminary_tpu_torch.tools import microbench_colext as CX
from test_torch_proto_gather import PallasRecorder, emu_build, load_tool

torch.set_num_threads(1)

N, P = 4096, 1024


@pytest.fixture(scope="module")
def prototype():
    rec = PallasRecorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["x", str(N)])
        mod = load_tool("microbench_colext")
        mp.setattr(mod, "P", P)
        mp.setattr(pl, "pallas_call", rec)
        rec.capture("pallas_T", mod.main)
        yield rec


def test_transpose_matches_prototype_kernel(prototype):
    x = np.random.default_rng(31).standard_normal((N, 48)).astype(np.float32)
    ref = prototype.run("pallas_T", x)
    got = CX.transpose(torch.as_tensor(x)).numpy()
    assert got.shape == (48, N)
    np.testing.assert_array_equal(got, ref)


def _consumers64(rt):
    outs = [rt[c] * 2.0 + rt[c + 1] * rt[c + 2] for c in range(0, 30, 3)]
    return (sum(o.sum() for o in outs[:3]) + sum((o * o).sum() for o in outs[3:]),
            sum(np.abs(o).sum() for o in outs[:3]) + sum((o * o).sum() for o in outs[3:]))


def test_tool_runs_on_cpu():
    """``main`` and ``main2`` on the CPU at N = 4096, P = 1024: A, B, F and D
    compute the same sum bit for bit (the same contiguous consumer outputs);
    each pattern agrees with a float64 numpy version within 1e-5 of the sum
    of its terms' magnitudes (float32 sums in another order)."""
    res = CX.main(N, P, device="cpu", warmup=1, iters=1)
    res.update(CX.main2(N, P, device="cpu", warmup=1, iters=1))
    assert len(res) == 9 and all(ms > 0 for ms, _ in res.values())
    val = {k: float(v) for k, (_, v) in res.items()}
    a = val["A 10-consumer column reads"]
    assert a == val["B transpose+row slices"] == val["F kernel-T transpose planar"]
    assert a == val["D stack-to-planar + slices"]
    rng = np.random.default_rng(0)
    table = rng.standard_normal((P, 48), np.float32)
    idx = rng.integers(0, P, N).astype(np.int32)
    arow = rng.standard_normal((2048, 128), np.float32)
    aidx = rng.integers(0, 2048, N).astype(np.int32)
    sel = rng.standard_normal((N, 16), np.float32).astype(np.float64)
    row = table[idx].astype(np.float64) + np.float32(CX.EPS)
    want, scale = _consumers64(row.T)
    assert abs(a - want) <= 1e-5 * scale
    outs = [row[:, c] * 2.0 + row[:, c + 1] * row[:, c + 2] for c in range(0, 30, 3)]
    assert abs(val["C single-expression columns"] - sum(outs).sum()) <= 1e-5 * sum(
        np.abs(o).sum() for o in outs)
    e = row[:, 0]
    for name in ("E gather alone", "E gather alone (sorted idx)"):
        assert abs(val[name] - e.sum()) <= 1e-5 * np.abs(e).sum(), name
    arow_g = arow[aidx].astype(np.float64) + np.float32(CX.EPS)
    for name, comps in (("aerial interleaved reshape",
                         [arow_g[:, 0:48].reshape(-1, 16, 3)[..., k] for k in range(3)]),
                        ("aerial component-planar",
                         [arow_g[:, 16 * k:16 * k + 16] for k in range(3)])):
        terms = [c * sel for c in comps]
        assert abs(val[name] - sum(t.sum() for t in terms)) <= 1e-5 * sum(
            np.abs(t).sum() for t in terms), name


_T_ENTRY = r"""
extern "C" void emu_transpose(const uint32_t* in, long long n, int c,
                              uint32_t* out) {
  const long long tiles_n = (n + TILE - 1) / TILE;
  run_groups(tiles_n * ((c + TILE - 1) / TILE), TILE * TROWS, TILE * TROWS,
             [&] { transpose_kernel(in, n, c, tiles_n, out); });
}
"""


def test_kernel_t_source_matches_plain(tmp_path):
    """csrc/transpose.cu (32 x 32 tiles through a shared tile, edges masked)
    equals ``transpose_plain`` on shapes with ragged tiles in both
    dimensions, among them the prototype's 48 columns."""
    lib = emu_build("transpose", _T_ENTRY, str(tmp_path))
    p = ctypes.c_void_p
    lib.emu_transpose.argtypes = [p, ctypes.c_longlong, ctypes.c_int, p]
    rng = np.random.default_rng(32)
    for n, c in ((300, 48), (33, 5), (64, 32)):
        x = torch.as_tensor(rng.standard_normal((n, c)).astype(np.float32))
        out = torch.full((c, n), float("nan"))
        lib.emu_transpose(x.data_ptr(), n, c, out.data_ptr())
        assert torch.equal(out, CX.transpose_plain(x)), (n, c)
