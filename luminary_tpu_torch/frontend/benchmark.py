"""Offline benchmark harness — the reference's Mandarin Duck ``-b`` mode.

Queues output requests at a ladder of sample counts (reference:
src/mandarin_duck/mandarin_duck.c:53-98 — powers of two, 1.5x midpoints, and
every 32 past 2^6), polls the promises, and writes ``Bench-<spp>-<name>.png``
plus a ``BenchResults-<name>.txt`` CSV of (samples, seconds)
(mandarin_duck.c:186-244).

A copy of ``luminary_tpu/frontend/benchmark.py`` over the port's Host.
"""

from __future__ import annotations

import os
import time

from ..host.host import Host, OUTPUT_HANDLE_INVALID
from ..utils.log import info_message


def benchmark_sample_ladder(log2_max: int) -> list[int]:
    """reference: mandarin_duck.c:53-98."""
    target = 1 << log2_max
    counts = set()
    k = 1
    while k <= target:
        counts.add(k)
        mid = k + k // 2
        if k >= 2 and mid <= target and k < 64:
            counts.add(mid)
        k <<= 1
    s = 96
    while s <= target:
        counts.add(s)
        s += 32
    return sorted(counts)


def run_benchmark(
    host: Host,
    log2_spp: int,
    name: str,
    output_dir: str = ".",
    save_images: bool = True,
) -> list[tuple[int, float]]:
    """Render the spp ladder; returns [(sample_count, seconds), ...]."""
    ladder = benchmark_sample_ladder(log2_spp)
    promises = [(spp, host.request_output(sample_count=spp)) for spp in ladder]

    results = []
    t_start = time.monotonic()
    for spp, promise in promises:
        handle = OUTPUT_HANDLE_INVALID
        while handle == OUTPUT_HANDLE_INVALID:
            handle = host.try_await_output(promise)
        elapsed = time.monotonic() - t_start
        results.append((spp, elapsed))
        info_message("benchmark %s: %d spp at %.3f s", name, spp, elapsed)
        if save_images:
            host.save_png(
                handle, os.path.join(output_dir, f"Bench-{spp}-{name}.png")
            )
        host.release_output(handle)

    csv_path = os.path.join(output_dir, f"BenchResults-{name}.txt")
    with open(csv_path, "w") as f:
        f.write("samples,seconds\n")
        for spp, secs in results:
            f.write(f"{spp},{secs:.6f}\n")
    return results
