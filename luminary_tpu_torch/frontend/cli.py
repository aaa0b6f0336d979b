"""Command-line frontend — the offline half of the reference's Mandarin Duck
(reference: src/mandarin_duck/main.c, argument_parser.c:14-95).

Usage:
    python -m luminary_tpu_torch <scene.lum|scene.obj> [options]

Options mirror the reference CLI:
    -b, --benchmark LOG2_SPP NAME   run the spp-ladder benchmark
    -o, --output PATH               output PNG path (default output.png)
    -s, --samples N                 sample count for a single render
    -v, --verbose                   raise log verbosity
    --width W / --height H          override render resolution
    --dry-run                       parse + build only, no rendering
    --mesh N                        distribute samples over N devices
    --device DEV                    torch device (default: the first CUDA
                                    card; "cpu" runs the plain PyTorch path)

The port of ``luminary_tpu/frontend/cli.py``; ``--device`` takes the place
of the reference's ``JAX_PLATFORMS``. Without ``--device`` the CLI renders
on the card and fails on a machine without one. ``--mesh N`` renders on the
first N cards (and fails where fewer exist), or on N CPU shards with
``--device cpu``.

(The interactive SDL GUI's counterpart is the terminal viewer,
``python -m luminary_tpu_torch.frontend.viewer``; the observability it
surfaced, worker status and sample times, is available through the Host API.)
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ..host.host import Host, OUTPUT_HANDLE_INVALID
from ..utils.log import LogLevel, info_message, set_verbosity
from .benchmark import run_benchmark


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="luminary_tpu_torch",
        description="Luminary offline renderer (PyTorch/CUDA port)",
    )
    p.add_argument("scene", help=".lum or .obj scene file")
    p.add_argument("-b", "--benchmark", nargs=2, metavar=("LOG2_SPP", "NAME"))
    p.add_argument("-o", "--output", default="output.png")
    p.add_argument("-s", "--samples", type=int, default=None)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--depth", type=int, default=None, help="max ray depth")
    p.add_argument("--dry-run", action="store_true")
    p.add_argument(
        "--mesh", type=int, default=None, metavar="N",
        help="distribute samples over N devices: the first N cards, or N "
             "CPU shards with --device cpu",
    )
    p.add_argument(
        "--device", default=None,
        help="torch device to render on (default: the first CUDA card)",
    )
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    if args.verbose:
        set_verbosity(LogLevel.INFO)

    host = Host(samples_per_step=8, mesh=args.mesh, device=args.device)
    ext = os.path.splitext(args.scene)[1].lower()
    t0 = time.monotonic()
    sample_target = 64
    if ext == ".lum":
        content = host.load_lum_file(args.scene)
        if content.sample_count:
            sample_target = content.sample_count
    elif ext == ".obj":
        host.load_obj_file(args.scene)
    else:
        print(f"unsupported scene format: {args.scene}", file=sys.stderr)
        return 1

    settings = host.get_settings()
    if args.width:
        settings.width = args.width
    if args.height:
        settings.height = args.height
    if args.depth:
        settings.max_ray_depth = args.depth
    host.set_settings(settings)
    info_message("scene loaded in %.2f s", time.monotonic() - t0)

    if args.dry_run:
        host.renderer.update()
        print(
            f"dry-run ok: {host.num_meshes} meshes, {host.num_materials} "
            f"materials, {host.num_instances} instances, "
            f"{settings.width}x{settings.height}"
        )
        return 0

    if args.benchmark:
        log2_spp, name = int(args.benchmark[0]), args.benchmark[1]
        run_benchmark(host, log2_spp, name)
        return 0

    samples = args.samples or sample_target
    promise = host.request_output(sample_count=samples)
    handle = OUTPUT_HANDLE_INVALID
    t0 = time.monotonic()
    while handle == OUTPUT_HANDLE_INVALID:
        handle = host.try_await_output(promise)
    host.save_png(handle, args.output)
    meta = host.get_image_meta(handle)
    print(
        f"rendered {samples} spp in {time.monotonic() - t0:.2f} s "
        f"-> {args.output} ({meta['sample_count']} samples)"
    )
    return 0
