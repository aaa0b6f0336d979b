"""Time the port's main path on the card: a 1080p scene through
``Renderer.render_samples``.

    python luminary_tpu_torch/tools/time_render.py [--scene NAME] [--root DIR]

``--scene``: ``tree`` (the tree-tier bench scene, ``benchmark_scene(1920,
1080, 4)``; the default), ``content`` (``content_scene``: textures,
cutouts, fog and bridges), ``outdoor`` (``outdoor_scene``: the ocean under
the marched clouds, sky mode 0) or ``optics`` (``optics_scene``: particles,
spectral, the lens camera), each at 1920x1080 and depth 4. After warm-up
samples, times 3 blocks of samples (6 a block; 2 for ``outdoor``, 4 for
``optics``), each ending with the renderer's device synchronise. Prints one
JSON line: Mrays/s (rays traced over the block's seconds) and s/sample of
each block, the kernel launch counts of the timed blocks and the card's
``nvidia-smi`` name and power limit. ``--root`` imports
``luminary_tpu_torch`` from another checkout, for instance an earlier
commit unpacked with ``git archive``; run the script by its path so that the
package is not imported before ``--root`` is read. Two versions are compared
in one machine session by running it in turns (earlier, this, this,
earlier).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

BLOCKS = 3
# scene: (builder in luminary_tpu_torch.testing, warm-up samples, samples a block)
SCENES = {"tree": ("benchmark_scene", 2, 6), "content": ("content_scene", 2, 6),
          "outdoor": ("outdoor_scene", 1, 2), "optics": ("optics_scene", 1, 4)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", default="tree", choices=sorted(SCENES),
                    help="the 1080p scene to render (default: tree)")
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
    from luminary_tpu_torch import testing
    from luminary_tpu_torch.render.renderer import Renderer

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    builder, warm, samples = SCENES[args.scene]
    t0 = time.monotonic()
    r = Renderer(getattr(testing, builder)(1920, 1080, 4))
    torch.cuda.synchronize()
    pack_s = time.monotonic() - t0
    r.render_samples(warm)
    # the kernels of the main path (an earlier checkout may lack some)
    counted = dict(gather_soa=RO.gather_soa, unplanar=RO.unplanar,
                   traverse_wide=TR.traverse_wide,
                   light_tree_descend=LT.light_tree_descend)
    for mod, name in (("luminary_tpu_torch.ops.libm", "libm_sincos"),
                      ("luminary_tpu_torch.ops.vec", "fma32"),
                      ("luminary_tpu_torch.ops.camera", "generate_camera_rays"),
                      ("luminary_tpu_torch.ops.vec", "ray_point"),
                      ("luminary_tpu_torch.ops.material", "make_frame"),
                      ("luminary_tpu_torch.ops.material", "frame_eval"),
                      ("luminary_tpu_torch.ops.material", "material_sample"),
                      ("luminary_tpu_torch.ops.sky", "stars_radiance"),
                      ("luminary_tpu_torch.ops.clouds", "cloud_march"),
                      ("luminary_tpu_torch.ops.clouds", "cloud_sun_transmittance")):
        try:
            fn = getattr(__import__(mod, fromlist=[name]), name, None)
        except ImportError:
            continue
        if hasattr(fn, "launches"):
            counted[name] = fn
    for fn in counted.values():
        fn.launches = 0
    blocks = []
    for _ in range(BLOCKS):
        t0 = time.monotonic()
        r.render_samples(samples)
        dt = time.monotonic() - t0
        blocks.append(dict(
            seconds=dt, s_per_sample=dt / samples,
            mrays=r._last_rays_traced / dt / 1e6))
    print(json.dumps(dict(
        package=os.path.dirname(os.path.abspath(luminary_tpu_torch.__file__)),
        scene=args.scene, pack_s=pack_s, warm=warm, samples=samples,
        rays_per_sample=r._last_rays_per_sample, blocks=blocks,
        launches={k: fn.launches for k, fn in counted.items()},
        nvidia_smi=smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
