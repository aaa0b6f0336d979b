"""One run of one cell: set-up, the measured window, the readings, the
check against the reference.

Set-up builds the scene from the configuration's recipe and the seed, hands
it to the program's ``Host`` (synchronous, on ``chips`` cards: a
``Host(mesh=chips)`` beyond one), packs it, and warms up: the mix's first
request (and edit) through the same polls and image path as the window;
then the render restarts. The window (in a traced run its first
``TRACE_SECONDS``, under ``torch.profiler``) is the traffic mix's closed
loop (``traffic.run``) of image requests through ``Host.request_output`` /
``try_await_output``, each ready image copied to the host; when the
seconds have passed, one last image is fetched at the sample count reached
and the window closes. After it: the
peak memory, the program freed, the trace's readings, then the reference
on the pixels the seed draws.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import os
import shutil
import tempfile
import time
from dataclasses import dataclass

import torch

from . import compare, spec, trace, traffic
from .reference import reference_means

# the traced run's window: its trace of a 4K window holds ~45,000 device
# operations a second, and reading 30 s of them would take the run near
# its time limit
TRACE_SECONDS = 15.0


@dataclass
class Readings:
    """What a per-layer metric's reader (``metrics/<name>.py``) reads."""

    samples: int  # full-frame samples rendered in the window
    pack_s: float  # host clock around the pack, ended by a synchronise
    trace: trace.TraceView | None  # the traced window, where there is one


def _sync(devices):
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _ranged(fn, name):
    """``fn`` inside a profiler range of the benchmark's own."""
    from torch.autograd.profiler import record_function

    def call(*a, **k):
        with record_function(trace.OWN_PREFIX + name):
            return fn(*a, **k)
    return call


def _read_trace(prof, devices) -> trace.TraceView | None:
    tmp = tempfile.mkdtemp(prefix="portbench_trace_")
    try:
        path = os.path.join(tmp, "window.trace.json")
        prof.export_chrome_trace(path)
        return trace.load_trace(path, devices)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool,
        device: str | None = None, t_process: float | None = None,
        control: bool = False) -> dict:
    """Run ``cell`` once → the result line's object, with ``compared``.
    ``device``: None for the cards, ``"cpu"`` for the plain path (tests);
    ``control``: also judge the bfloat16 control against the reference, as
    ``control`` (``control.py``; the benchmark's runs do not)."""
    t_process = time.monotonic() if t_process is None else t_process
    import luminary_tpu_torch.scene as api
    from luminary_tpu_torch.host.host import Host

    cfg = cell.config
    params = cfg["scene"]
    width, height = int(params["width"]), int(params["height"])
    recipe = spec.load_module("scenes", cfg["recipe"])
    mix = cell.traffic
    devices = ([torch.device(device)] if device is not None else
               [torch.device("cuda", i) for i in range(cell.chips)])

    host = Host(samples_per_step=int(mix["samples_per_step"]),
                mesh=cell.chips if cell.chips > 1 else None, device=device)
    host.scene = recipe.build(api, params, seed)
    t0 = time.monotonic()
    renderer = host.renderer  # packs the scene
    _sync(devices)
    pack_s = time.monotonic() - t0
    # warm-up: the mix's first request (and edit), then a restart
    edits = traffic.warm_up(host, mix, (height, width, 3))
    renderer.start_new_render()
    _sync(devices)

    with contextlib.ExitStack() as stack:
        prof = None
        if traced:
            from torch.autograd.profiler import record_function
            from torch.profiler import ProfilerActivity, profile

            seconds = min(seconds, TRACE_SECONDS)
            acts = [ProfilerActivity.CPU]
            if device is None:
                acts.append(ProfilerActivity.CUDA)
            renderer.get_image = _ranged(renderer.get_image, "get_image")
            prof = stack.enter_context(profile(activities=acts))
            stack.enter_context(record_function(trace.WINDOW))
        setup_s = time.monotonic() - t_process
        w = traffic.run(host, mix, seconds, (height, width, 3), edits)
        _sync(devices)

    radiance = renderer.get_radiance()
    if device is None:
        peak = max(torch.cuda.max_memory_allocated(d) for d in devices)
        dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                    "count": cell.chips, "memory_peak_bytes": int(peak)}
    else:
        peak = 0
        dev_info = {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": 0}
    # the program's state is freed before the trace is read and the
    # reference runs
    host.destroy()
    del host, renderer
    gc.collect()
    if device is None:
        torch.cuda.empty_cache()

    t_trace = time.monotonic()
    metrics, breakdown = {}, None
    if traced:
        view = _read_trace(prof, [d.index for d in devices]
                           if device is None else None)
        del prof
        rd = Readings(samples=w.total_samples, pack_s=pack_s, trace=view)
        for m in cell.per_layer:
            value = spec.load_module("metrics", m["name"]).read(rd)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        if view is not None and view.devices:
            dev_info["busy_s"] = view.mean_busy_us() / 1e6
            dev_info["window_s"] = view.window_us / 1e6
            breakdown = trace.breakdown(view)
    else:
        e2e = {"msamples_per_s": width * height * w.total_samples / w.seconds / 1e6,
               "peak_mem_gib": peak / float(1 << 30),
               "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}

    # the check: the program's mean radiance at the pixels the seed draws
    px, py = compare.check_pixels(width, height, int(cfg["check_pixels"]), seed)
    program = radiance[py, px]
    del radiance
    ref_dev = device if device is not None else "cuda:0"
    t_ref = time.monotonic()
    edit = functools.partial(traffic.apply_edits, mix=mix, count=w.edits)
    reference = reference_means(recipe, params, seed, px, py, w.samples,
                                ref_dev, edit=edit)
    t_done = time.monotonic()
    correct, numbers = compare.judge(program, reference, w.samples,
                                     cfg["limits"])
    out = {"correct": bool(correct and w.failed == 0),
           "attempted": w.attempted, "failed": w.failed,
           "metrics": metrics, "device": dev_info,
           "seconds": {"setup": setup_s, "window": w.seconds,
                       "trace": t_ref - t_trace, "reference": t_done - t_ref}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if control:
        low = reference_means(recipe, params, seed, px, py, w.samples, ref_dev,
                              precision="bfloat16", edit=edit)
        out["control"] = compare.judge(low, reference, w.samples,
                                       cfg["limits"])[1]
    out["compared"] = numbers
    return out
