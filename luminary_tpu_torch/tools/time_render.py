"""Time the port's main path on the card: the tree-tier bench scene
(``benchmark_scene(1920, 1080, 4)``) through ``Renderer.render_samples``.

    python luminary_tpu_torch/tools/time_render.py [--root DIR]

After 2 warm-up samples, times 3 blocks of 6 samples, each ending with the
renderer's device synchronise. Prints one JSON line: Mrays/s and s/sample
of each block, the rays per sample, the kernel launch counts of the timed
blocks and the card's ``nvidia-smi`` name and power limit. ``--root``
imports ``luminary_tpu_torch`` from another checkout, for instance an
earlier commit unpacked with ``git archive``; run the script by its path so
that the package is not imported before ``--root`` is read. Two versions
are compared in one machine session by running it in turns (earlier, this,
this, earlier).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

WARM, SAMPLES, BLOCKS = 2, 6, 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="checkout to import luminary_tpu_torch from")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("time_render: no CUDA device is available", file=sys.stderr)
        return 2
    import luminary_tpu_torch
    from luminary_tpu_torch.ops import light_tree as LT
    from luminary_tpu_torch.ops import rowops as RO
    from luminary_tpu_torch.ops import traverse as TR
    from luminary_tpu_torch.render.renderer import Renderer
    from luminary_tpu_torch.testing import benchmark_scene

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    t0 = time.monotonic()
    r = Renderer(benchmark_scene(1920, 1080, max_depth=4))
    torch.cuda.synchronize()
    pack_s = time.monotonic() - t0
    r.render_samples(WARM)
    RO.gather_soa.launches = RO.unplanar.launches = 0
    TR.traverse_wide.launches = 0
    LT.light_tree_descend.launches = 0
    blocks = []
    for _ in range(BLOCKS):
        t0 = time.monotonic()
        r.render_samples(SAMPLES)
        dt = time.monotonic() - t0
        blocks.append(dict(
            seconds=dt, s_per_sample=dt / SAMPLES,
            mrays=r._last_rays_per_sample * SAMPLES / dt / 1e6))
    print(json.dumps(dict(
        package=os.path.dirname(os.path.abspath(luminary_tpu_torch.__file__)),
        pack_s=pack_s, warm=WARM, samples=SAMPLES,
        rays_per_sample=r._last_rays_per_sample, blocks=blocks,
        launches=dict(gather_soa=RO.gather_soa.launches,
                      unplanar=RO.unplanar.launches,
                      traverse_wide=TR.traverse_wide.launches,
                      light_tree_descend=LT.light_tree_descend.launches),
        nvidia_smi=smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
