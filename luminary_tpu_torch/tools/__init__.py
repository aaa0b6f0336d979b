"""The port's counterparts of the repository's Pallas prototypes in
``tools/``: the gather, fetch-chain and slab-body experiments
(``proto_gather``, ``proto_gather2``) and the column-extraction
microbenchmark (``microbench_colext``), each on its hand-written CUDA kernels.

Each runs as ``python -m luminary_tpu_torch.tools.<name> [which]`` with its
prototype's choices and prints one line per experiment. A kernel's time is
its device time per launch (:func:`launch_ms`: CUDA events around replays of
a CUDA graph of the launches, so the host's cost of each call is left out,
as the prototypes' marginal timings left the TPU host out); the time of one
eager call, host included, is printed beside it. Every experiment
function takes its sizes and ``device`` as keyword arguments (the defaults
are the prototype's sizes and the card; without a card it raises unless
``device="cpu"``) and returns its output tensors with the time.
"""

from __future__ import annotations

import time

import torch

from ..device import resolve_device


def device_line(device=None) -> tuple[torch.device, str]:
    """(the resolved device, the line that names it)."""
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return dev, "device: %s (%s)" % (name, dev)


def time_ms(fn, device: torch.device, iters: int = 20, warmup: int = 2) -> float:
    """Mean milliseconds of one ``fn()`` over ``iters`` calls after
    ``warmup``: CUDA events on a card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def launch_ms(fn, device: torch.device, iters: int = 20, replays: int = 5) -> float:
    """Device milliseconds of one ``fn()``: on a card, ``iters`` calls
    captured in a CUDA graph and replayed ``replays`` times between CUDA
    events; on the CPU, :func:`time_ms`."""
    if device.type != "cuda":
        return time_ms(fn, device, iters)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        fn()  # allocations and the kernel build happen outside the capture
        torch.cuda.synchronize(device)
        with torch.cuda.graph(graph, stream=side):
            for _ in range(iters):
                fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph.replay()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / (replays * iters)
