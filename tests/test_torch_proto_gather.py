"""The port of ``tools/proto_pallas_gather.py``
(``luminary_tpu_torch/tools/proto_gather.py``, kernels D and E) against the
prototype's own Pallas kernels in interpret mode.

The prototype's kernels are closures inside ``e1_take()`` and the others,
so they are captured at run time: for one fixture the ``pallas_call`` of the
``jax.experimental.pallas`` module that the tool imports is replaced
(``pytest.MonkeyPatch``) by a recorder that keeps each kernel with its
keyword arguments and runs it with ``interpret=True``; the tool's globals
``S`` and ``N`` are set small and its timer ``timeit`` becomes one call.
Each recorded kernel then runs on this test's own seeded inputs. No file of
``tools/`` is changed. Every comparison is exact: gathers move values, and
the sums are taken in the prototype's order.

The kernels' CUDA sources run here too, compiled by g++ against the warp
emulation of ``tests/test_torch_kernel_emulation.py`` (``_EMU``), and are
held against their plain versions.
"""

import ctypes
import importlib.util
import os
import re
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from luminary_tpu_torch.tools import proto_gather as PG
from test_torch_kernel_emulation import _EMU

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "luminary_tpu_torch", "csrc")
S = 256          # table rows (the prototype's 8192 cut small)
N = 512          # gathered rows (the prototype's 65,536 cut small; E3's G)
EDGE = [0, 1, -1, S, S + 5, -S - 3, 7, 2]


def load_tool(name):
    """tools/<name>.py as a module of its own (``tools`` is no package)."""
    spec = importlib.util.spec_from_file_location(
        "_prototype_" + name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class PallasRecorder:
    """Stands in for ``pl.pallas_call``: records (kernel, keyword arguments)
    under the current name and runs the kernel in interpret mode."""

    def __init__(self):
        self.real = pl.pallas_call
        self.calls = {}
        self.name = None

    def __call__(self, kernel, **kw):
        self.calls[self.name] = (kernel, kw)
        return self.real(kernel, interpret=True, **kw)

    def capture(self, name, fn, *args):
        self.name = name
        fn(*args)
        assert name in self.calls, name

    def run(self, name, *args):
        kernel, kw = self.calls[name]
        return np.asarray(jax.block_until_ready(
            self.real(kernel, interpret=True, **kw)(*args)))


@pytest.fixture(scope="module")
def prototype():
    mod = load_tool("proto_pallas_gather")
    rec = PallasRecorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", rec)
        mp.setattr(mod, "S", S)
        mp.setattr(mod, "N", N)
        mp.setattr(mod, "timeit",
                   lambda fn, *a, iters=20: (jax.block_until_ready(fn(*a)), 1.0)[1])
        for name in ("e1_take", "e1b_takealong", "e2_scalar_loop", "e3_onehot",
                     "e4_dyn_slice_vec"):
            rec.capture(name, getattr(mod, name))
        yield rec  # the kernels read the small globals when traced again


# prototype → (kernel D's index rule, bf16 rounding, indices as [n, 1])
VARIANTS = {
    "e1_take": ("fill_nan", False, False),
    "e1b_takealong": ("fill_nan", False, True),
    "e4_dyn_slice_vec": ("clamp", False, False),
    "e3_onehot": ("zero", True, True),
}
# the edge rows of EDGE under each rule: a row index, "nan" or "zero"
EDGE_ROWS = {
    "fill_nan": [0, 1, S - 1, "nan", "nan", "nan", 7, 2],
    "clamp": [0, 1, S - 1, S - 1, S - 1, 0, 7, 2],
    "zero": [0, 1, "zero", "zero", "zero", "zero", 7, 2],
}


def _table_and_indices(seed):
    rng = np.random.default_rng(seed)
    tab = rng.standard_normal((S, PG.COLS)).astype(np.float32)
    idx = rng.integers(-2 * S, 2 * S, N).astype(np.int32)
    idx[:len(EDGE)] = EDGE
    return tab, idx


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_gather_rows_matches_prototype_kernel(prototype, name):
    """Kernel D's plain version, under the variant's index rule, equals the
    prototype's kernel on random indices in [-2S, 2S) that start with the
    edge cases 0, 1, -1, S, S+5, -S-3; the edge rows are as the docstring of
    ``proto_gather`` states."""
    mode, bf16, col = VARIANTS[name]
    tab, idx = _table_and_indices(11)
    idx_in = idx[:, None] if col else idx
    ref = prototype.run(name, tab, idx_in)
    got = PG.gather_rows(torch.as_tensor(tab), torch.as_tensor(idx_in), mode,
                         bf16).numpy()
    np.testing.assert_array_equal(got, ref)
    rows = torch.as_tensor(tab)
    if bf16:
        rows = rows.to(torch.bfloat16).to(torch.float32)
    for i, want in enumerate(EDGE_ROWS[mode]):
        if want == "nan":
            assert np.isnan(got[i]).all()
        elif want == "zero":
            assert not got[i].any()
        else:
            np.testing.assert_array_equal(got[i], rows[want].numpy())


def test_gather_sum_matches_prototype_kernel(prototype):
    """Kernel E's ``gather_sum`` (plain) equals E2's loop, K = 2048 fetches
    added in order, indices wrapping once and clamping as ``ref[idx]``."""
    rng = np.random.default_rng(12)
    tab = rng.standard_normal((S, PG.COLS)).astype(np.float32)
    idx = rng.integers(-2 * S, 2 * S, PG.K).astype(np.int32)
    idx[:len(EDGE)] = EDGE
    ref = prototype.run("e2_scalar_loop", idx, tab)
    got = PG.gather_sum(torch.as_tensor(tab), torch.as_tensor(idx)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_tool_runs_on_cpu():
    """``main("all")`` on the CPU: E1, E1b and E4 draw the same in-range
    rows, E3 their bf16 rounding, E2 their ordered sum."""
    res = PG.main("all", device="cpu", s=S, iters=1)
    assert set(res) == set(VARIANTS) | {"e2_scalar_loop"}
    tab, idx = PG._inputs(S, PG.COLS, PG.N, (PG.N,), "cpu", 0)
    e1 = res["e1_take"][0]
    assert e1.shape == (PG.N, PG.COLS) and torch.equal(e1, tab[idx.long()])
    assert torch.equal(res["e1b_takealong"][0], e1)
    assert torch.equal(res["e4_dyn_slice_vec"][0], e1)
    assert torch.equal(res["e3_onehot"][0],
                       e1[:PG.G].to(torch.bfloat16).to(torch.float32))
    tab2, idx2 = PG._inputs(S, PG.COLS, PG.K, (PG.K,), "cpu", 0)
    assert torch.equal(res["e2_scalar_loop"][0], PG.gather_sum_plain(tab2, idx2))
    assert all(ms > 0 for _, ms in res.values())


@pytest.mark.parametrize("tool", ["proto_gather", "proto_gather2",
                                  "microbench_colext"])
def test_tool_without_device_needs_a_card(monkeypatch, tool):
    """No device argument means the card; without one a tool raises instead
    of running on the CPU."""
    mod = importlib.import_module("luminary_tpu_torch.tools." + tool)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main()


# ---- the CUDA sources on the CPU ----

def same_bits(a, b):
    """Equal bit for bit, except that any NaN equals any NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a.view(torch.int32)[~nan], b.view(torch.int32)[~nan])


def emu_build(name, entry, tmp, defines="", launch=False):
    """csrc/<name>.cu with ``_EMU`` in place of the CUDA headers, plus
    ``entry``, → ctypes library; ``defines`` go before everything. Without
    ``launch`` the launch configurations are dropped (``entry`` runs the
    kernels) and ``__shared__`` arrays become statics (one block runs at a
    time). With it, each launch runs its grid through ``emu_launch`` and
    ``extern __shared__`` arrays point into that launch's dynamic shared
    memory, so the source's own C entry points run. Its headers
    (``csrc/*.cuh``) are included as they are."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ on this machine to build the kernel emulation")
    with open(os.path.join(CSRC, name + ".cu")) as f:
        src = f.read()
    src = re.sub(r"#include <cuda_\w+\.h>\n", "", src)
    if launch:
        src = re.sub(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);",
                     r"emu_launch(\2, [&] { \1(\3); });", src, flags=re.S)
        src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                     r"\1* \2 = (\1*)emu_dyn_smem;", src)
    else:
        src = re.sub(r"<<<[^>]*>>>", "", src)
    src = src.replace("__shared__", "static")
    path = os.path.join(tmp, name + ".cpp")
    with open(path, "w") as f:
        f.write(defines + _EMU + src + entry)
    lib = os.path.join(tmp, "lib%s_emu.so" % name)
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-pthread", "-w", "-I", CSRC, "-o", lib, path],
                   check=True)
    return ctypes.CDLL(lib)


_ROWS_ENTRY = r"""
extern "C" void emu_gather_rows(const float* tab, long long rows, int cols,
                                const int32_t* idx, long long n, int mode,
                                int round, float* out) {
  run_groups((n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, 32 * ROWS_PER_BLOCK, 32,
             [&] { gather_rows_kernel((const float4*)tab, rows, cols >> 2, idx,
                                      n, mode, round, (float4*)out); });
}
"""

# kernel E at an emulated size: gather_sum blocks of 5 warps (as on the
# card, warps 0-3 add one component each and the rest copy), gather_chain
# blocks of one warp (one thread adds all four components, every thread
# copies), stages of 16 rows, chains listed 96 steps at a time in chunks of
# 8, and 8 KB of shared memory a block, so that a table of more than ~600
# rows takes the path that walks the table
E_EMU_DEFINES = """
#define SUM_THREADS 160
#define CHAIN_THREADS 32
#define STAGE 16
#define SEQ 96
#define JUMP 8
#define EMU_SMEM_OPTIN 8192
"""


@pytest.fixture(scope="module")
def emu_gather_sum(tmp_path_factory):
    """csrc/gather_sum.cu on the CPU through its own C entry points
    (``lum_gather_sum``, ``lum_gather_chain``), at the sizes above."""
    lib = emu_build("gather_sum", "", str(tmp_path_factory.mktemp("emu_gather_sum")),
                    E_EMU_DEFINES, launch=True)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lum_gather_sum.argtypes = [p, i64, i32, p, i64, p, p]
    lib.lum_gather_chain.argtypes = [p, i32, i32, p, i32, p, p]
    return lib


@pytest.fixture(scope="module")
def emu_gather_rows(tmp_path_factory):
    lib = emu_build("gather_rows", _ROWS_ENTRY,
                    str(tmp_path_factory.mktemp("emu_gather_rows")))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.emu_gather_rows.argtypes = [p, i64, i32, p, i64, i32, i32, p]
    return lib


@pytest.mark.parametrize("mode", sorted(PG.MODES))
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_kernel_d_source_matches_plain(emu_gather_rows, mode, bf16):
    """csrc/gather_rows.cu (one warp a row, float4 lanes) equals
    ``gather_rows_plain`` bit for bit, edge indices included, on a table
    whose values round to bf16 both ways (ties to even) and hold a NaN and
    an infinity. NaN payloads are not compared: PyTorch's own bf16 rounding
    of a NaN differs between its CPU and CUDA kernels."""
    tab, idx = _table_and_indices(13)
    bits = tab.view(np.uint32)
    bits[0, :4] = [0x3F808000, 0x3F818000, 0x7FC00001, 0xFF800000]  # ties, NaN, -inf
    tab_t, idx_t = torch.as_tensor(tab), torch.as_tensor(idx)
    out = torch.empty((N, PG.COLS))
    emu_gather_rows.emu_gather_rows(tab_t.data_ptr(), S, PG.COLS, idx_t.data_ptr(), N,
                        PG.MODES[mode], int(bf16), out.data_ptr())
    ref = PG.gather_rows_plain(tab_t, idx_t, mode, bf16)
    assert same_bits(out, ref)


@pytest.mark.parametrize("cols,k", [(128, 300), (12, 77), (4, 5), (64, 48),
                                    (128, 1), (12, 0)],
                         ids=["c128-k300", "c12-k77", "c4-k5-one-stage",
                              "c64-k48-whole-stages", "c128-k1", "c12-k0"])
def test_kernel_e_sum_source_matches_plain(emu_gather_sum, cols, k):
    """csrc/gather_sum.cu's ``gather_sum`` (a block per float4 column group,
    rows through a two-stage cp.async ring, each component added in index
    order) equals the ordered plain sum bit for bit: K inside one stage, in
    whole stages and not, 0 and 1; 4, 12, 64 and 128 columns; indices
    negative and out of range both ways."""
    rng = np.random.default_rng(14 + k)
    tab = torch.as_tensor(rng.standard_normal((S, cols)).astype(np.float32))
    idx = rng.integers(-2 * S, 2 * S, k).astype(np.int32)
    idx[:min(k, len(EDGE))] = EDGE[:k]
    idx = torch.as_tensor(idx)
    out = torch.full((1, cols), float("nan"))
    assert emu_gather_sum.lum_gather_sum(tab.data_ptr(), S, cols, idx.data_ptr(), k,
                                         out.data_ptr(), None) == 0
    assert torch.equal(out, PG.gather_sum_plain(tab, idx))