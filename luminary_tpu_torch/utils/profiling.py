"""Per-stage render profiling.

The port of ``luminary_tpu/utils/profiling.py``. The reference times every
kernel with CUDA events behind DEVICE_RENDERER_DO_PER_KERNEL_TIMING and
prints a percentage breakdown (reference: device_renderer.c:282-343,
608-638). The JAX package groups the XLA ops of one traced sample by their
name. The port's integrator is eager PyTorch, so its ops carry no stage in
their names: ``render/wavefront.py`` ``render_sample`` marks its stages
instead (:class:`StageRanges`: camera rays, the closest walk, the shade-row
fetch, surface shading, NEE, the shadow walk, sky and miss, ... and the
Renderer's accumulation), and one sample runs under ``torch.profiler``.
On a card each kernel's device time goes to the innermost stage whose host
range launched it (the trace's correlation of a kernel with its launch); on
the CPU each operator's self time goes to the stage it ran in. What lies in
no stage is "other".

Usage:
    from luminary_tpu_torch.utils.profiling import profile_renderer
    rows = profile_renderer(renderer)   # [(group, ms, percent), ...]
"""

from __future__ import annotations

import collections
import glob
import json
import os
import shutil
import tempfile

import torch

STAGE_PREFIX = "lum::"
# the range around the profiled samples (no stage of its own)
WINDOW = STAGE_PREFIX + "profiled samples"
TRACE_FILE = "lum_profile.trace.json"
# device activity in a Chrome trace of torch.profiler
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host calls that launch device activity (their args carry its correlation)
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class StageRanges:
    """Flat named profiler ranges over the stages of one function:
    ``stage(name)`` ends the stage before and opens ``name``; leaving the
    ``with`` block ends the last. Unless a profiler runs when the block is
    entered, a stage costs one attribute read and opens nothing."""

    def __init__(self):
        self._on = False
        self._cur = None

    def __enter__(self):
        self._on = torch.autograd.profiler._is_profiler_enabled
        return self

    def __call__(self, name: str) -> None:
        if not self._on:
            return
        self._end()
        self._cur = torch.autograd.profiler.record_function(STAGE_PREFIX + name)
        self._cur.__enter__()

    def _end(self) -> None:
        if self._cur is not None:
            self._cur.__exit__(None, None, None)
            self._cur = None

    def __exit__(self, *exc):
        self._end()
        return False


def _innermost(ranges, points):
    """For each (ts, key) of ``points`` on one host thread, the name of the
    innermost range of ``ranges`` [(ts, end, name)] that holds ts (None
    where none does). Ranges of one thread nest."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out = {}
    stack, i = [], 0
    for ts, key in sorted(points, key=lambda p: p[0]):
        while i < len(ranges) and ranges[i][0] <= ts:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < ts:
            stack.pop()
        out[key] = stack[-1][2] if stack else None
    return out


def _self_times(ops):
    """Self time (us) of each host operator [(ts, end, key)] of one thread:
    its duration less that of the operators directly inside it."""
    ops = sorted(ops, key=lambda o: (o[0], -o[1]))
    own = {key: end - ts for ts, end, key in ops}
    stack = []
    for ts, end, key in ops:
        while stack and stack[-1][1] <= ts:
            stack.pop()
        if stack:
            own[stack[-1][2]] -= end - ts
        stack.append((ts, end, key))
    return own


def stage_events(trace_dir: str) -> list[tuple[str, str, float, bool]]:
    """(stage, event name, ms, on the device) of every timed event in the
    Chrome trace(s) that :func:`profile_renderer` wrote into ``trace_dir``:
    the device's kernels, copies and fills where there are any, each under
    the stage whose host range launched it; else the host operators' self
    times, each under the stage it ran in. Stage None: in no stage."""
    events = []
    for path in sorted(glob.glob(os.path.join(trace_dir, "*.json"))):
        with open(path) as f:
            events += json.load(f).get("traceEvents", [])
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    ranges = collections.defaultdict(list)
    for e in timed:
        name = e.get("name", "")
        if (e.get("cat") == "user_annotation" and name.startswith(STAGE_PREFIX)
                and name != WINDOW):
            ranges[(e["pid"], e["tid"])].append(
                (e["ts"], e["ts"] + e["dur"], name[len(STAGE_PREFIX):]))
    device = [e for e in timed if e.get("cat") in DEVICE_CATS]
    points = collections.defaultdict(list)
    if device:
        launch = {e["args"]["correlation"]: e for e in timed
                  if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        for k, e in enumerate(device):
            h = launch.get(e.get("args", {}).get("correlation"))
            if h is not None:
                points[(h["pid"], h["tid"])].append((h["ts"], k))
        where = {}
        for thread, pts in points.items():
            where.update(_innermost(ranges[thread], pts))
        return [(where.get(k), e["name"], e["dur"] / 1e3, True)
                for k, e in enumerate(device)]
    ops = [e for e in timed if e.get("cat") == "cpu_op"]
    by_thread = collections.defaultdict(list)
    for k, e in enumerate(ops):
        by_thread[(e["pid"], e["tid"])].append((e["ts"], e["ts"] + e["dur"], k))
    out = []
    for thread, thread_ops in by_thread.items():
        own = _self_times(thread_ops)
        where = _innermost(ranges[thread], [(ts, k) for ts, _, k in thread_ops])
        out += [(where[k], ops[k]["name"], own[k] / 1e3, False)
                for _, _, k in thread_ops]
    return out


def summarize_trace(trace_dir: str) -> list[tuple[str, float]]:
    """Device time (ms; on the CPU, operator self time) by stage group from
    a :func:`profile_renderer` trace directory, the costliest first."""
    tot: collections.Counter = collections.Counter()
    for stage, _, ms, _ in stage_events(trace_dir):
        tot[stage or "other"] += ms
    return tot.most_common()


def profile_renderer(renderer, samples: int = 1, trace_dir: str | None = None):
    """Render ``samples`` under a torch.profiler trace (device activity too
    when the renderer is on a card); returns [(group, ms, percent)] sorted
    by cost. A renderer with no sample yet renders one first, outside the
    trace, so that the kernels' build at first use is not profiled. The
    Chrome trace (``lum_profile.trace.json``, for Perfetto or
    chrome://tracing) is kept when ``trace_dir`` is given, else temporary."""
    from torch.profiler import ProfilerActivity, profile, record_function

    own = trace_dir is None
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="lum_profile_")
    try:
        renderer.update()
        if renderer.sample_count == 0:
            renderer.render_samples(1)
        activities = [ProfilerActivity.CPU]
        cuda = renderer.device.type == "cuda"
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            with record_function(WINDOW):
                renderer.render_samples(samples)
                if cuda:
                    torch.cuda.synchronize(renderer.device)
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
        rows = summarize_trace(trace_dir)
    finally:
        if own:
            shutil.rmtree(trace_dir, ignore_errors=True)
    total = sum(ms for _, ms in rows) or 1.0
    return [(g, ms, 100.0 * ms / total) for g, ms in rows]


def format_breakdown(rows) -> str:
    lines = ["  %8s  %5s  %s" % ("ms", "%", "stage")]
    for g, ms, pct in rows:
        lines.append("  %8.2f  %5.1f  %s" % (ms, pct, g))
    return "\n".join(lines)
