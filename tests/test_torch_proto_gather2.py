"""The port of ``tools/proto_pallas_gather2.py``
(``luminary_tpu_torch/tools/proto_gather2.py``: kernel E's ``gather_chain``
and kernel F) against the prototype's own Pallas kernels in interpret mode.

The kernels are captured as in ``tests/test_torch_proto_gather.py``: the
tool's ``pallas_call`` records each kernel and its keyword arguments, the
tool's ``S`` is set small and its marginal-cost timer ``chain_time`` becomes
one call of a one-step chain. The prototype calls ``pallas_call`` inside a
``jit`` trace, so each recorded kernel is called again outside it on this
test's own inputs. No file of ``tools/`` is changed. Every comparison is
exact: the chain adds its rows in order and the slab test has no sum.

The kernels' CUDA sources also run here, on g++ against the warp emulation,
held against their plain versions.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from luminary_tpu_torch.tools import proto_gather2 as PG2
from test_torch_proto_gather import (PallasRecorder, emu_build,  # noqa: F401
                                     emu_gather_sum, load_tool, same_bits)

torch.set_num_threads(1)

S = 256   # table rows (the prototype's 8192 cut small)
G = 64    # packets (the prototype's 1024 cut small)


@pytest.fixture(scope="module")
def prototype():
    mod = load_tool("proto_pallas_gather2")
    rec = PallasRecorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", rec)
        mp.setattr(mod, "S", S)
        mp.setattr(mod, "chain_time", lambda make_fn, k1=4, k2=16: (
            jax.block_until_ready(make_fn(1)(jnp.float32(0.0))), 1.0)[1])
        rec.capture("e2c", mod.e2c_scalar_loop)
        for mode in PG2.FETCH_MODES:
            rec.capture("e5." + mode, mod.e5_slab_body, G, mode)
        yield rec


@pytest.mark.parametrize("seed", [-0.0123, 0.0004567], ids=["negative", "positive"])
def test_gather_chain_matches_prototype_kernel(prototype, seed):
    """Kernel E's ``gather_chain`` (plain) equals E2c's kernel over its 4096
    dependent fetches, on a table of ``2 * randn`` rows, so that the
    ``row[1] > 2`` branch is taken, and with a negative seed (floor modulo)."""
    rng = np.random.default_rng(21)
    tab = (2.0 * rng.standard_normal((S, PG2.COLS))).astype(np.float32)
    path = PG2.chain_rows(tab, seed, PG2.ROWS_PER_CALL)
    assert (tab[path, 1] > 2).sum() > 10
    ref = prototype.run("e2c", np.array([seed], np.float32), tab)
    got = PG2.gather_chain(torch.as_tensor(tab), seed, PG2.ROWS_PER_CALL).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got[0], tab[path].sum(axis=0, dtype=np.float64),
                               rtol=1e-4, atol=1e-2)


def _slab_inputs(seed):
    """Rows with some children missed by every ray, a packet whose children
    all miss, tied children, and fetch indices at the edges of [0, S)."""
    rng = np.random.default_rng(seed)
    tab = rng.uniform(-1.0, 2.0, (S, PG2.COLS)).astype(np.float32)
    tab[5, 0:32], tab[5, 32:64] = 10.0, -10.0  # packet 5: x and y slabs apart
    tab[:, 7] = tab[:, 3]                  # child 7 ties child 3 in x ...
    for a in (16, 32, 48, 64, 80):         # ... and in y and z
        tab[:, a + 7] = tab[:, a + 3]
    ox = rng.uniform(0.0, 1.0, (8, G)).astype(np.float32)
    fetch = rng.integers(-2 * S, 2 * S, (G, 1)).astype(np.int32)
    fetch[:6, 0] = [0, -1, S, S + 5, -S - 3, 5]
    return tab, ox, fetch


@pytest.mark.parametrize("mode", PG2.FETCH_MODES)
def test_slab_body_matches_prototype_kernel(prototype, mode):
    """Kernel F (plain) equals E5's kernel in both fetch modes: hits and
    misses, an all-miss packet (inf + 0), ties to the first child."""
    tab, ox, fetch = _slab_inputs(22)
    seed = np.array([0.125], np.float32)
    ref = prototype.run("e5." + mode, seed, tab, ox, fetch)
    got = PG2.slab_body(torch.as_tensor(tab), torch.as_tensor(ox), 0.125,
                        torch.as_tensor(fetch) if mode == "scalarloop" else None)
    got = got.numpy()
    np.testing.assert_array_equal(got, ref)
    assert G // 2 < np.isfinite(got).sum() < G and got[0, 5] == np.inf


def test_tool_runs_on_cpu():
    """``main("e2c")`` and E5 in both modes on the CPU at small sizes: the
    chain's sum is that of the rows its indices visit; E5 reads rows 0..G-1,
    or the rows its fetch indices name."""
    res = PG2.main("e2c", device="cpu", s=S, steps=256, iters=1)
    out, ms = res["e2c_scalar_loop"]
    assert out.shape == (1, PG2.COLS) and ms > 0
    tab = np.random.default_rng(0).random((S, PG2.COLS), dtype=np.float32)
    path = PG2.chain_rows(tab, PG2.CHAIN_SEED, 256)
    np.testing.assert_allclose(out[0].numpy(), tab[path].sum(0), rtol=1e-5)
    none, _ = PG2.e5_slab_body(G, "none", s=S, device="cpu", iters=1)
    loop, _ = PG2.e5_slab_body(G, "scalarloop", s=S, device="cpu", iters=1)
    rng = np.random.default_rng(0)
    tab = torch.as_tensor(rng.random((S, PG2.COLS), dtype=np.float32))
    ox = torch.as_tensor(rng.random((8, G), dtype=np.float32))
    fetch = torch.as_tensor(rng.integers(0, S, G))
    assert torch.equal(loop, PG2.slab_body_plain(tab[fetch], ox, PG2.SLAB_SEED))
    assert torch.equal(none, PG2.slab_body_plain(tab, ox, PG2.SLAB_SEED))
    assert not torch.equal(none, loop) and bool(torch.isfinite(none).any())


# (rows, columns, steps, seed, table): 2 * randn tables take the row[1] > 2
# branch; on 40 rows 300 steps go round the chain's cycle; 2,000 rows exceed
# the emulated shared memory, so the rows are listed by walking the table;
# "nan" holds NaN in column 0 of every seventh row
_CHAIN_CASES = {
    "s256-c128-negative-seed": (S, 128, 400, -0.0123, "randn2"),
    "s256-c128-positive-seed": (S, 128, 400, 0.0004567, "randn2"),
    "steps0": (S, 12, 0, 0.0004567, "randn2"),
    "steps1": (S, 12, 1, -0.0123, "randn2"),
    "s40-c12-cycles": (40, 12, 300, -0.0123, "randn2"),
    "s40-c4-one-pass": (40, 4, 30, 0.0004567, "randn2"),
    "s256-c12-nan-col0": (S, 12, 200, 0.0004567, "nan"),
    "s2000-c12-walks-table": (2000, 12, 250, -0.0123, "randn2"),
}


@pytest.mark.parametrize("case", sorted(_CHAIN_CASES))
def test_kernel_e_chain_source_matches_plain(emu_gather_sum, case):  # noqa: F811
    """csrc/gather_sum.cu's ``gather_chain`` (the visited rows listed through
    next-index and jump tables in shared memory, or by walking the table
    where they do not fit, then summed in order like ``gather_sum``) equals
    the plain chain bit for bit: the branch taken, negative seeds, 0 and 1
    steps, chains that cycle, passes of the list whole and not, a NaN in
    column 0, 4, 12 and 128 columns."""
    rows, cols, steps, seed, kind = _CHAIN_CASES[case]
    rng = np.random.default_rng(23 + rows + steps)
    tab = (2.0 * rng.standard_normal((rows, cols))).astype(np.float32)
    if kind == "nan":
        tab[::7, 0] = np.nan
    if kind == "randn2" and steps > 100:
        path = PG2.chain_rows(tab, seed, steps)
        assert (tab[path, 1] > 2).sum() > 5
    if case == "s40-c12-cycles":
        assert steps > rows
    tab = torch.as_tensor(tab)
    s = torch.tensor([seed], dtype=torch.float32)
    out = torch.full((1, cols), float("nan"))
    assert emu_gather_sum.lum_gather_chain(tab.data_ptr(), rows, cols, s.data_ptr(),
                                           steps, out.data_ptr(), None) == 0
    ref = PG2.gather_chain_plain(tab, seed, steps)
    if kind == "nan":  # column 0 sums NaN rows: its NaN equals any NaN
        assert same_bits(out, ref) and bool(torch.isnan(ref[0, 0]))
    else:
        assert torch.equal(out, ref)


_SLAB_ENTRY = r"""
extern "C" void emu_slab_body(const float* tab, int rows, int cols,
                              const float* ox, const int32_t* fetch,
                              const float* seed, int g, float* out) {
  run_groups(((long long)g * CHILDREN + THREADS - 1) / THREADS, THREADS, 32,
             [&] { slab_body_kernel(tab, rows, cols, ox, fetch, seed, g, out); });
}
"""


@pytest.fixture(scope="module")
def emu_slab_body(tmp_path_factory):
    lib = emu_build("slab_body", _SLAB_ENTRY,
                    str(tmp_path_factory.mktemp("emu_slab_body")))
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.emu_slab_body.argtypes = [p, i32, i32, p, p, p, i32, p]
    return lib


@pytest.mark.parametrize("mode", PG2.FETCH_MODES)
def test_kernel_f_source_matches_plain(emu_slab_body, mode):
    """csrc/slab_body.cu (16 lanes a packet, a shuffle argmin) equals the
    plain slab test bit for bit, on a G that leaves the last block short."""
    tab, ox, fetch = _slab_inputs(24)
    g = G - 3
    tab_t, ox_t = torch.as_tensor(tab), torch.as_tensor(np.ascontiguousarray(ox[:, :g]))
    f = torch.as_tensor(np.ascontiguousarray(fetch[:g, 0])) if mode == "scalarloop" else None
    s = torch.tensor([0.125], dtype=torch.float32)
    out = torch.empty((1, g))
    emu_slab_body.emu_slab_body(tab_t.data_ptr(), S, PG2.COLS, ox_t.data_ptr(),
                                None if f is None else f.data_ptr(), s.data_ptr(),
                                g, out.data_ptr())
    ref = PG2.slab_body_plain(tab_t, ox_t, 0.125, f)
    assert torch.equal(out, ref) and out[0, 5] == float("inf")
