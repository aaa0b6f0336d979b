"""Kernel A's plain version (``gather_soa_plain``, what the CPU runs) against
``luminary_tpu/ops/rowops.py``: planar row gathers and the packed 8-slot
select, masked lanes (negative and out-of-range indices) included; and the
``unplanar`` transpose (``unplanar_plain``) against the JAX ``unplanar``.
The functions move bits, so the check is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from luminary_tpu.ops.rowops import gather_packed_planar as j_packed
from luminary_tpu.ops.rowops import gather_planar as j_planar
from luminary_tpu.ops.rowops import unplanar as j_unplanar
from luminary_tpu_torch.ops.rowops import (
    gather_packed_planar,
    gather_planar,
    gather_soa,
    gather_soa_plain,
    unplanar,
    unplanar_plain,
)
from luminary_tpu_torch.render.device_scene import unpack_reference_shade_rows

torch.set_num_threads(1)


def _idx(rng, rows, n):
    """Indices across the table plus negatives and out-of-range ones."""
    inside = rng.integers(0, rows, n - 6)
    edge = np.asarray([-1, -rows, -rows - 5, rows, rows + 3, 2**20])
    return rng.permutation(np.concatenate([inside, edge])).astype(np.int32)


@pytest.mark.parametrize("cols", [4, 16, 37, 128])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_gather_planar_exact(cols, dtype):
    rng = np.random.default_rng(cols)
    rows = 300
    table = rng.standard_normal((rows, cols)).astype(np.float32).view(dtype)
    idx = _idx(rng, rows, 4096)
    ref = np.asarray(j_planar(jnp.asarray(table), jnp.asarray(idx)))
    got = gather_planar(torch.as_tensor(table), torch.as_tensor(idx)).numpy()
    assert got.shape == (cols, idx.shape[0])
    assert np.array_equal(ref.view(np.int32), got.view(np.int32))


def test_gather_packed_sub8_exact():
    """sub_stride 8 on the JAX package's interleaved [P/8, 128] layout."""
    rng = np.random.default_rng(1)
    p_rows = 257
    table = rng.integers(-2**31, 2**31, (p_rows, 128), dtype=np.int64).astype(np.int32)
    slots = _idx(rng, p_rows * 8, 5000)
    ref = np.asarray(j_packed(jnp.asarray(table), jnp.asarray(slots), 16))
    got = gather_packed_planar(torch.as_tensor(table), torch.as_tensor(slots),
                               16, sub_stride=8).numpy()
    assert np.array_equal(ref, got)


def test_gather_packed_sub1_on_port_layout_exact():
    """The port's one-slot-per-row table (sub_stride 1) gives the same
    logical columns as the reference's interleaved table."""
    rng = np.random.default_rng(2)
    p = 1000
    packed = rng.integers(-2**31, 2**31, ((p + 7) // 8, 128),
                          dtype=np.int64).astype(np.int32)
    flat = unpack_reference_shade_rows(packed, p)
    slots = rng.integers(0, p, 3000).astype(np.int32)
    ref = np.asarray(j_packed(jnp.asarray(packed), jnp.asarray(slots), 16))
    got = gather_packed_planar(torch.as_tensor(flat), torch.as_tensor(slots),
                               16).numpy()
    assert np.array_equal(ref, got)


def test_partial_columns_and_wrapper_route():
    """n_cols < C reads a column prefix; a CPU table takes the plain path."""
    rng = np.random.default_rng(5)
    table = torch.as_tensor(rng.standard_normal((50, 37)).astype(np.float32))
    idx = torch.as_tensor(_idx(rng, 50, 200))
    before = gather_soa.launches
    a = gather_soa(table, idx, 18, 1)
    assert gather_soa.launches == before  # no kernel launch for CPU tensors
    assert torch.equal(a, gather_planar(table, idx)[:18])
    assert torch.equal(a, gather_soa_plain(table, idx, 18, 1))


@pytest.mark.parametrize("cols", [1, 8, 32])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_unplanar_exact(cols, dtype):
    """[C, N] -> [N, C], given as the rows of a [C, N] tensor."""
    rng = np.random.default_rng(10 + cols)
    planar = rng.standard_normal((cols, 1000)).astype(np.float32).view(dtype)
    ref = np.asarray(j_unplanar(jnp.asarray(planar)))
    got = unplanar(torch.as_tensor(planar)).numpy()
    assert got.shape == (1000, cols) and got.dtype == np.int32
    assert np.array_equal(ref.view(np.int32), got)


def test_unplanar_ray_rows_and_wrapper_route():
    """Kernel B's ray rows: f32 lanes and an int32 active flag as separate
    [N] tensors; a CPU tensor takes the plain path; over 32 columns raises."""
    rng = np.random.default_rng(11)
    f = [torch.as_tensor(rng.standard_normal(777).astype(np.float32))
         for _ in range(7)]
    act = torch.as_tensor(rng.integers(0, 2, 777).astype(np.int32))
    cols = [*f[:4], *f[4:], act]
    ref = np.asarray(j_unplanar(jnp.stack([jnp.asarray(c.view(torch.int32).numpy())
                                           for c in cols])))
    before = unplanar.launches
    got = unplanar(cols)
    assert unplanar.launches == before  # no kernel launch for CPU tensors
    assert np.array_equal(ref, got.numpy())
    assert torch.equal(got, unplanar_plain(cols))
    assert torch.equal(got[:, 7], act)
    with pytest.raises(ValueError):
        unplanar([f[0]] * 33)
