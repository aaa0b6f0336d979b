"""The port's render of the ``clouds_32`` golden scene (the sun plane under
the low cloud layer: the cloud march on the miss side, cloud shadows) at 64
spp on the CPU against ``tests/golden/clouds_32_64spp.npy``, under the bound
of ``tests/test_golden.py``: RMSE/scale < 0.02 over the whole image.

Measured on an x86 CPU (``tests/torch_clouds_golden_trace.py``): the JAX
package's own render reads 2.0e-4, and 7.87 when XLA may not fuse
multiply-adds (``--xla_cpu_max_isa=AVX``). The port reads 2.0e-4 over the
image, no pixel more than 1e-2 of the scale apart. It follows the compiled
reference's rounding in the cloud hash (fused h, glibc's sinf), the
march's step (its length times the float32 reciprocal of the step count,
t and the position each one fused multiply-add), the star field (glibc's
sinf/cosf, a fused dot), the camera ray, the hit point and the bounce
(tests/test_torch_rounding.py), so that every closest walk of the 64
samples starts from the reference's bits and the sky the misses see is the
reference's. The march's density still parts in 37 of 65,536 lanes, 2
beyond 1e-3 (ROADMAP.md queue 3). Before, the port read 0.0157 with 3
pixels apart (two of them lanes in a star's glow), and 0.764 before that.
"""

import os

import numpy as np
import torch

from luminary_tpu_torch.render.renderer import Renderer
from luminary_tpu_torch.testing import clouds_scene
from test_torch_golden import GOLDEN_DIR, SPP

torch.set_num_threads(1)


def test_clouds_32_against_golden():
    r = Renderer(clouds_scene(), chunk=1 << 20, device="cpu")
    assert r.config.use_clouds and r.config.cloud_layers == (0,)
    r.render_samples(SPP)
    img = r.get_radiance()
    ref = np.load(os.path.join(GOLDEN_DIR, "clouds_32_%dspp.npy" % SPP))
    assert np.isfinite(img).all() and img.shape == ref.shape
    scale = float(np.abs(ref).mean()) + 1e-6
    full = float(np.sqrt(np.mean((img - ref) ** 2)) / scale)
    apart = np.abs(img - ref).max(axis=-1) > 1e-2 * scale
    # the bound over the whole image, and no more pixels apart than the 5
    # the card is held to (chip_smoke.py); on the CPU 2.0e-4 is measured,
    # held within 1e-3
    assert full < 0.02 and apart.sum() <= 5, (full, int(apart.sum()))
    assert full < 1e-3, full
    assert r.sample_count == SPP
