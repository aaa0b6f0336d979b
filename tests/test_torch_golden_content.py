"""Port renders of the scene-content goldens at 64 spp on the CPU against
``tests/golden/*.npy``, at the bound of ``tests/test_golden.py`` (RMSE/scale
< 0.02), through the Renderer as tests/test_torch_golden.py renders:

glass_sphere_32: refraction through the 2-deep IOR medium stack, depth 5;
fog_bridges_32: the Cornell box in fog (volume collisions, the HG phase,
bridge NEE).

``textured_32`` is not held here: the JAX package's own 64-sample render of
it reads RMSE/scale 0.049 against its golden on this toolchain, also at the
commit that wrote the golden, and the port's render reads the same. The
port's textured path is held against the JAX integrator instead
(tests/test_torch_textures.py).
"""

import pytest
import torch

from luminary_tpu_torch.render.renderer import Renderer
from luminary_tpu_torch.testing import fog_bridges_scene, glass_sphere_scene
from test_torch_golden import SPP, rmse_over_scale

torch.set_num_threads(1)

SCENES = {
    "glass_sphere_32": glass_sphere_scene,
    "fog_bridges_32": fog_bridges_scene,
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_content_render_matches_golden(name):
    r = Renderer(SCENES[name](), chunk=1 << 20, device="cpu")
    r.render_samples(SPP)
    rel = rmse_over_scale(name, r.get_radiance())
    assert rel < 0.02, (name, rel)
    assert r.sample_count == SPP
