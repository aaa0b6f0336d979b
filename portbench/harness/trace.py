"""The traced run's reduction: ``torch.profiler``'s Chrome trace of the
window → device operations with the stage that launched each, busy and
idle time per card, and the breakdown.

A device operation (kernel, copy, fill) goes to the innermost stage whose
host range launched it, through the trace's correlation of the operation
with its launch: the arithmetic of the program's ``utils/profiling.py``,
copied here. The program's stages are its ``StageRanges`` (``lum::<stage>``
ranges); the benchmark adds ``portbench::<name>`` ranges of its own around
the window and around its calls into the program.
"""

from __future__ import annotations

import collections
import json
from dataclasses import dataclass, field

STAGE_PREFIX = "lum::"
OWN_PREFIX = "portbench::"
WINDOW = OWN_PREFIX + "window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class DeviceOp:
    device: int
    ts: float  # us, the trace's clock
    dur: float  # us
    name: str
    cat: str
    stage: str | None  # the program's innermost stage at the launch
    own: str | None  # the benchmark's innermost range at the launch


@dataclass
class TraceView:
    """The window of one traced run."""

    t0: float
    t1: float
    ops: list = field(default_factory=list)
    devices: list = field(default_factory=list)
    # the main thread's host ranges [(ts, end, name)], program and benchmark
    host_ranges: list = field(default_factory=list)

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def busy_us(self, device: int) -> float:
        """Length of the union of the card's operations inside the window."""
        spans = sorted((max(o.ts, self.t0), min(o.ts + o.dur, self.t1))
                       for o in self.ops if o.device == device)
        busy, end = 0.0, self.t0
        for a, b in spans:
            if b <= end:
                continue
            busy += b - max(a, end)
            end = b
        return busy

    def mean_busy_us(self) -> float:
        if not self.devices:
            return 0.0
        return sum(self.busy_us(d) for d in self.devices) / len(self.devices)

    def idle_gaps(self, device: int) -> list:
        """(start, length) of every stretch of the window in which the card
        runs nothing."""
        spans = sorted((max(o.ts, self.t0), min(o.ts + o.dur, self.t1))
                       for o in self.ops if o.device == device)
        gaps, end = [], self.t0
        for a, b in spans:
            if a > end:
                gaps.append((end, a - end))
            end = max(end, b)
        if self.t1 > end:
            gaps.append((end, self.t1 - end))
        return gaps

    def host_stage_at(self, ts: float) -> str:
        """The innermost host range open on the main thread at ``ts``."""
        best = None
        for a, b, name in self.host_ranges:
            if a <= ts < b and (best is None or a >= best[0]):
                best = (a, b, name)
        return best[2] if best else "outside any range"


def innermost(ranges, points) -> dict:
    """For each (ts, key) of ``points`` on one host thread, the name of the
    innermost range of ``ranges`` [(ts, end, name)] that holds ts (None
    where none does). Ranges of one thread nest. (The arithmetic of the
    program's ``utils/profiling.py`` ``_innermost``.)"""
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


def _device_of(e) -> int:
    args = e.get("args", {})
    if "device" in args:
        return int(args["device"])
    return int(e.get("pid", 0))


def reduce_events(events: list, devices=None) -> TraceView | None:
    """The window's view of a Chrome trace's ``traceEvents``; None where the
    trace holds no window range. ``devices``: the card indices the run
    used (default: those with an operation in the window)."""
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in timed if e.get("name") == WINDOW]
    if not win:
        return None
    w = win[0]
    t0, t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    main = (w["pid"], w["tid"])
    stages = collections.defaultdict(list)
    own = collections.defaultdict(list)
    for e in timed:
        name = e.get("name", "")
        if e.get("cat") != "user_annotation":
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if name.startswith(STAGE_PREFIX):
            stages[(e["pid"], e["tid"])].append(
                span + (name[len(STAGE_PREFIX):],))
        elif name.startswith(OWN_PREFIX) and name != WINDOW:
            own[(e["pid"], e["tid"])].append(span + (name,))
    launch = {e["args"]["correlation"]: e for e in timed
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    device = [e for e in timed if e.get("cat") in DEVICE_CATS
              and float(e["ts"]) < t1 and float(e["ts"]) + float(e["dur"]) > t0]
    points = collections.defaultdict(list)
    for k, e in enumerate(device):
        h = launch.get(e.get("args", {}).get("correlation"))
        if h is not None:
            points[(h["pid"], h["tid"])].append((float(h["ts"]), k))
    stage_of, own_of = {}, {}
    for thread, pts in points.items():
        stage_of.update(innermost(stages[thread], pts))
        own_of.update(innermost(own[thread], pts))
    ops = [DeviceOp(device=_device_of(e), ts=float(e["ts"]), dur=float(e["dur"]),
                    name=e.get("name", ""), cat=e.get("cat", ""),
                    stage=stage_of.get(k), own=own_of.get(k))
           for k, e in enumerate(device)]
    host = [(a, b, STAGE_PREFIX + n) for a, b, n in stages[main]]
    host += own[main]
    host = [r for r in host if r[1] > t0 and r[0] < t1]
    if devices is None:
        devices = sorted({o.device for o in ops})
    return TraceView(t0=t0, t1=t1, ops=ops, devices=list(devices),
                     host_ranges=host)


def load_trace(path: str, devices=None) -> TraceView | None:
    with open(path) as f:
        return reduce_events(json.load(f).get("traceEvents", []), devices)


def _short(name: str, n: int = 96) -> str:
    """A kernel's name without its argument list, cut to ``n`` letters."""
    head = name.split("(")[0] if "(" in name else name
    return head[:n]


def breakdown(view: TraceView, top: int = 10) -> dict:
    """The device operations that took most time (half by kernel name, half
    by the stage that launched them) and the main card's longest idle
    gaps, each named by the host range open when it began; seconds."""
    by_name = collections.Counter()
    by_stage = collections.Counter()
    for o in view.ops:
        by_name["op " + _short(o.name)] += o.dur
        by_stage["stage " + (o.stage or o.own or "outside any stage")] += o.dur
    half = top // 2
    ops = by_name.most_common(half) + by_stage.most_common(top - half)
    gaps = []
    if view.devices:
        main = view.devices[0]
        longest = sorted(view.idle_gaps(main), key=lambda g: -g[1])[:top]
        gaps = [["idle during " + view.host_stage_at(a), d / 1e6]
                for a, d in longest]
    return {"device_ops": [[k, v / 1e6] for k, v in ops], "idle_gaps": gaps}
