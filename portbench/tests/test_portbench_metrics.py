"""Every metric reader on a small recorded trace."""

import pytest

from harness import spec, trace
from harness.cell import Readings


def _x(name, cat, ts, dur, pid=0, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def _events():
    """A window of 1000 us on the main thread with two stages; three
    launches and their kernels on card 0, a peer copy and an add on card
    0 outside any stage, an image kernel, and one kernel on card 1."""
    ev = [
        _x(trace.WINDOW, "user_annotation", 0, 1000),
        _x("lum::light NEE (RIS, light tree)", "user_annotation", 10, 200),
        _x("lum::ocean", "user_annotation", 300, 100),
        _x("portbench::get_image", "user_annotation", 800, 100),
        _x("cudaLaunchKernel", "cuda_runtime", 20, 5, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 30, 5, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 310, 5, correlation=3),
        _x("cudaMemcpyAsync", "cuda_runtime", 500, 5, correlation=4),
        _x("cudaLaunchKernel", "cuda_runtime", 600, 5, correlation=5),
        _x("cudaLaunchKernel", "cuda_runtime", 810, 5, correlation=6),
        _x("cudaLaunchKernel", "cuda_runtime", 620, 5, correlation=7),
        _x("void traverse_wide_kernel<true>(float const*)", "kernel", 100, 40,
           pid=0, tid=7, device=0, correlation=1),
        _x("void elementwise_kernel<mul>", "kernel", 150, 60, pid=0, tid=7,
           device=0, correlation=2),
        _x("void elementwise_kernel<exp>", "kernel", 320, 100, pid=0, tid=7,
           device=0, correlation=3),
        _x("Memcpy PtoP (Device -> Device)", "gpu_memcpy", 510, 20, pid=0,
           tid=7, device=0, correlation=4),
        _x("void vectorized_elementwise_kernel<CUDAFunctor_add<float>>",
           "kernel", 610, 10, pid=0, tid=7, device=0, correlation=5),
        _x("void tonemap_add_kernel", "kernel", 820, 30, pid=0, tid=7,
           device=0, correlation=6),
        _x("void traverse_wide_kernel<false>(float const*)", "kernel", 630,
           200, pid=1, tid=7, device=1, correlation=7),
        # outside the window: not counted
        _x("void late_kernel", "kernel", 1200, 50, pid=0, tid=7, device=0,
           correlation=99),
    ]
    return ev


def _readings(samples=2, view=True):
    return Readings(samples=samples, pack_s=1.25,
                    trace=trace.reduce_events(_events()) if view else None)


def _read(name, r):
    return spec.load_module("metrics", name).read(r)


def test_attribution():
    v = trace.reduce_events(_events())
    assert (v.t0, v.t1, v.devices) == (0.0, 1000.0, [0, 1])
    stages = [o.stage for o in v.ops]
    assert stages == ["light NEE (RIS, light tree)"] * 2 + ["ocean"] + [None] * 4
    assert [o.own for o in v.ops][5] == "portbench::get_image"


def test_busy_and_idle():
    v = trace.reduce_events(_events())
    # card 0: 100-140, 150-210, 320-420, 510-530, 610-620, 820-850
    assert v.busy_us(0) == pytest.approx(40 + 60 + 100 + 20 + 10 + 30)
    assert v.busy_us(1) == pytest.approx(200)
    assert _read("device_idle_pct", _readings()) == pytest.approx(
        100 * (1 - (260 + 200) / 2 / 1000))
    b = trace.breakdown(v)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    # card 0's longest gap, 620-820, before the image range opens
    assert b["idle_gaps"][0] == ["idle during outside any range",
                                 pytest.approx(200e-6)]
    assert b["idle_gaps"][1] == ["idle during portbench::get_image",
                                 pytest.approx(150e-6)]


def test_readers():
    r = _readings()
    assert _read("launches_per_sample", r) == pytest.approx(7 / 2)
    assert _read("light_nee_ms_per_sample", r) == pytest.approx(0.1 / 2)
    assert _read("marches_ms_per_sample", r) == pytest.approx(0.1 / 2)
    assert _read("kernel_b_ms_per_sample", r) == pytest.approx(0.24 / 2)
    assert _read("mesh_reduce_ms_per_sample", r) == pytest.approx(0.03 / 2)
    assert _read("pack_s", r) == 1.25


def test_readers_find_nothing_to_read():
    for name in ("device_idle_pct", "launches_per_sample",
                 "light_nee_ms_per_sample", "marches_ms_per_sample",
                 "kernel_b_ms_per_sample", "mesh_reduce_ms_per_sample"):
        assert _read(name, _readings(view=False)) is None
    empty = Readings(samples=2, pack_s=1.0,
                     trace=trace.reduce_events([_x(trace.WINDOW,
                                                   "user_annotation", 0, 10)]))
    for name in ("device_idle_pct", "light_nee_ms_per_sample",
                 "kernel_b_ms_per_sample", "mesh_reduce_ms_per_sample"):
        assert _read(name, empty) is None
