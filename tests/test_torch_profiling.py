"""``luminary_tpu_torch/utils/profiling.py``, the port of
``luminary_tpu/utils/profiling.py`` (mirrors ``tests/test_profiling.py``
with the port's Renderer and Host on the CPU): the breakdown of a profiled
sample by the integrator's named stages, its percentages summing to 100,
``format_breakdown``'s text, ``Host.profile_render``; and the device path
of the trace summary (each kernel under the stage whose host range launched
it, by the launch's correlation) on a hand-made Chrome trace."""

import json
import os

import numpy as np
import torch

from luminary_tpu_torch.render.renderer import Renderer
from luminary_tpu_torch.scene.entities import AdaptiveSamplingOutputMode
from luminary_tpu_torch.testing import cornell_scene
from luminary_tpu_torch.utils import profiling as P

torch.set_num_threads(1)

# stages that every sample of the cornell box runs (it has an area light
# and the sky's sun, no tree: the small tables fetch per field)
CORNELL_STAGES = {"camera rays", "closest walk", "shade-row fetch",
                  "surface shading", "sun NEE", "light NEE (RIS, light tree)",
                  "shadow walk", "NEE contributions", "sky and miss",
                  "bounce", "accumulation"}


def test_profile_renderer_reports_stage_groups(tmp_path):
    r = Renderer(cornell_scene(16, 16, max_depth=2), device="cpu")
    rows = P.profile_renderer(r, samples=1, trace_dir=str(tmp_path))
    assert rows, "no operators captured"
    total_pct = sum(p for _, _, p in rows)
    assert 99.0 < total_pct < 101.0
    groups = [g for g, _, _ in rows]
    assert CORNELL_STAGES <= set(groups), set(groups)
    ms = [m for _, m, _ in rows]
    assert ms == sorted(ms, reverse=True) and min(ms) >= 0.0
    text = P.format_breakdown(rows)
    assert "stage" in text and "ms" in text and "closest walk" in text
    # the Chrome trace is kept where asked; the warm-up sample ran outside
    assert os.path.exists(tmp_path / P.TRACE_FILE)
    assert r.sample_count == 2


def test_stage_ranges_open_nothing_without_a_profiler():
    with P.StageRanges() as stage:
        stage("camera rays")
        assert stage._cur is None


def _trace(tmp_path, events):
    with open(tmp_path / P.TRACE_FILE, "w") as f:
        json.dump({"traceEvents": events}, f)
    return str(tmp_path)


def test_device_time_goes_to_the_launching_stage(tmp_path):
    host, gpu = dict(pid=1, tid=1), dict(pid=0, tid=7)

    def rng(name, ts, dur):
        return dict(ph="X", cat="user_annotation", name=name, ts=ts, dur=dur, **host)

    def launch(ts, corr, cat="cuda_runtime"):
        return dict(ph="X", cat=cat, name="cudaLaunchKernel", ts=ts, dur=1,
                    args={"correlation": corr}, **host)

    def kern(name, ts, dur, corr, cat="kernel"):
        return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur,
                    args={"correlation": corr}, **gpu)

    events = [
        rng(P.WINDOW, 0, 1000),
        rng("lum::closest walk", 10, 100),
        launch(20, 1), launch(30, 2),
        rng("lum::shadow walk", 120, 200),
        rng("lum::inner", 150, 20),  # a range nested in another
        launch(155, 3), launch(200, 4, "cuda_driver"),
        launch(400, 5),  # in no stage
        # kernels run later than their launches, on the device's clock
        kern("traverse_wide_kernel", 500, 250, 1),
        kern("gather_soa_kernel", 760, 50, 2),
        kern("fill", 820, 10, 3, "gpu_memset"),
        kern("traverse_wide_kernel", 840, 500, 4),
        kern("other_kernel", 1400, 40, 5),
        kern("orphan", 1500, 60, 99),  # no launch in the trace
        dict(ph="X", cat="cpu_op", name="aten::add", ts=25, dur=3, **host),
    ]
    d = _trace(tmp_path, events)
    ev = P.stage_events(d)
    assert all(on_dev for *_, on_dev in ev) and len(ev) == 6
    assert ev[0] == ("closest walk", "traverse_wide_kernel", 0.25, True)
    assert ev[2][0] == "inner" and ev[3][0] == "shadow walk"
    assert ev[4][0] is None and ev[5][0] is None
    assert P.summarize_trace(d) == [("shadow walk", 0.5), ("closest walk", 0.3),
                                    ("other", 0.1), ("inner", 0.01)]


def test_host_self_time_goes_to_the_enclosing_stage(tmp_path):
    host = dict(pid=1, tid=1)
    events = [
        dict(ph="X", cat="user_annotation", name="lum::bounce", ts=0, dur=100,
             **host),
        dict(ph="X", cat="cpu_op", name="aten::where", ts=10, dur=50, **host),
        dict(ph="X", cat="cpu_op", name="aten::empty", ts=20, dur=20, **host),
        dict(ph="X", cat="cpu_op", name="aten::add", ts=150, dur=5, **host),
    ]
    ev = P.stage_events(_trace(tmp_path, events))
    assert ev == [("bounce", "aten::where", 0.03, False),
                  ("bounce", "aten::empty", 0.02, False),
                  (None, "aten::add", 0.005, False)]


def test_adaptive_output_modes_render_heatmaps():
    scene = cornell_scene(24, 24, max_depth=2)
    r = Renderer(scene, device="cpu")
    r.render_samples(6)
    for mode in (
        AdaptiveSamplingOutputMode.VARIANCE,
        AdaptiveSamplingOutputMode.ERROR,
        AdaptiveSamplingOutputMode.SAMPLE_DISTRIBUTION,
    ):
        s = scene.get_entity("settings")
        s.adaptive_sampling_output_mode = mode
        scene.set_entity("settings", s)
        img = r.get_image()
        assert img.shape == (24, 24, 3) and img.dtype == np.uint8
        if mode != AdaptiveSamplingOutputMode.SAMPLE_DISTRIBUTION:
            # variance differs across the frame: not a constant image
            assert img.std() > 1.0
    s = scene.get_entity("settings")
    s.adaptive_sampling_output_mode = AdaptiveSamplingOutputMode.BEAUTY
    scene.set_entity("settings", s)
    assert r.get_image().shape == (24, 24, 3)


def test_host_profile_render():
    from luminary_tpu_torch.host.host import Host

    host = Host(device="cpu")
    host.scene = cornell_scene(16, 16, max_depth=2)
    try:
        rows = host.profile_render()
    finally:
        host.destroy()
    assert rows and abs(sum(p for _, _, p in rows) - 100.0) < 1.0
    assert "closest walk" in [g for g, _, _ in rows]
