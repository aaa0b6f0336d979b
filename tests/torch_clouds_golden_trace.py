"""Where the port's ``clouds_32`` render parts from ``tests/golden`` on the
CPU, and why (the figures quoted in tests/test_torch_golden_sky.py).

1. The JAX package's own render against the golden, compiled as usual and
   with XLA kept from fusing multiply-adds (``--xla_cpu_max_isa=AVX``),
   each in a process of its own (a few minutes each: ``--skip-jax``).
2. The port's render against the golden: RMSE/scale over the image, the
   pixels more than 1e-2 of the scale apart, RMSE/scale over the rest.
3. The lanes: every cloud march's inputs and radiance in both renders
   (the JAX one through ``jax.debug.callback``), sample by sample: the
   lanes whose inputs are equal bit for bit and whose radiance still
   differs, and, at the lanes that differ most, the reference's compiled
   march run on the reference's inputs and on the port's.

Not a test (it compiles the JAX integrator). Run from the repository root:

    JAX_PLATFORMS=cpu python tests/torch_clouds_golden_trace.py [--skip-jax]
"""

import argparse
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
GOLDEN = os.path.join(HERE, "golden", "clouds_32_64spp.npy")
SPP = 64


def _rel(img, ref):
    scale = float(np.abs(ref).mean()) + 1e-6
    apart = np.abs(img - ref).max(axis=-1) > 1e-2 * scale
    return dict(full=float(np.sqrt(np.mean((img - ref) ** 2)) / scale),
                apart=int(apart.sum()),
                rest=float(np.sqrt(np.mean((img - ref)[~apart] ** 2)) / scale))


def _jax_render_child():
    from test_golden import _render, _scenes

    print(repr(_rel(_render(_scenes()["clouds_32"]), np.load(GOLDEN))))


def _jax_renders():
    for label, flags in (("as compiled", ""),
                         ("no fused multiply-add", "--xla_cpu_max_isa=AVX")):
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags)
        out = subprocess.run([sys.executable, __file__, "--jax-child"], env=env,
                             capture_output=True, text=True, check=True).stdout
        print("JAX package, %s: %s" % (label, out.strip().splitlines()[-1]))


def _capture(samples):
    """Each cloud march's (origin, direction, red radiance) per sample, in
    the JAX render and in the port's."""
    import jax
    import torch

    import luminary_tpu_torch.render.wavefront as TW
    from luminary_tpu.ops import clouds as JC
    from luminary_tpu.render.renderer import Renderer as JR
    from luminary_tpu_torch.render.renderer import Renderer as TR
    from luminary_tpu_torch.testing import clouds_scene
    from test_golden import _scenes

    jrec, trec = [], []
    j_march, t_march = JC.cloud_march, TW.cloud_march

    def keep(*a):
        jrec.append([np.asarray(x).copy() for x in a])

    def j_wrap(cl, origin, direction, *a, **k):
        out = j_march(cl, origin, direction, *a, **k)
        jax.debug.callback(keep, *origin, *direction, out[0][0])
        return out

    def t_wrap(cl, origin, direction, *a, **k):
        out = t_march(cl, origin, direction, *a, **k)
        trec.append([c.numpy().copy() for c in (*origin, *direction, out[0][0])]
                    + [a, k])
        return out

    JC.cloud_march, TW.cloud_march = j_wrap, t_wrap
    try:
        JR(_scenes()["clouds_32"], chunk=1 << 20).render_samples(samples)
        r = TR(clouds_scene(), chunk=1 << 20, device="cpu")
        r.render_samples(samples)
    finally:
        JC.cloud_march, TW.cloud_march = j_march, t_march
    torch.set_num_threads(1)
    return jrec, trec, r


def _lanes(samples):
    import jax
    import jax.numpy as jnp

    from luminary_tpu.ops import clouds as JC
    from luminary_tpu.ops.vec import Vec3 as JVec3
    from test_golden import _scenes

    jrec, trec, _ = _capture(samples)
    equal = differ = 0
    worst = []
    for s, (j, t) in enumerate(zip(jrec, trec)):
        # the port marches the lanes that ever missed, the reference all
        # lanes: compared where those are all lanes
        if len(j[0]) != len(t[0]):
            continue
        same = np.all([a == b for a, b in zip(j[:6], t[:6])], axis=0)
        diff = np.abs(j[6] - t[6]) > 1e-3 * np.maximum(np.abs(j[6]), 1.0)
        equal += int(same.sum())
        differ += int((same & diff).sum())
        for lane in np.argsort(-np.abs(j[6] - t[6]))[:2]:
            worst.append((float(abs(j[6][lane] - t[6][lane])), s, int(lane)))
    n = sum(len(j[0]) for j in jrec)
    print("lanes marched: %d; inputs equal bit for bit: %d; of those, radiance "
          "apart by more than 1e-3: %d" % (n, equal, differ))
    cl = jax.device_put(JC.pack_clouds(_scenes()["clouds_32"].get_entity("cloud")))
    kw = trec[0][8]
    jit_march = jax.jit(lambda o, d, sun, rad, amb: JC.cloud_march(
        cl, JVec3(*o), JVec3(*d), JVec3(*sun), rad, amb, **kw))

    def march(t, o, d):
        sun, rad, amb = t[7][:3]
        return np.asarray(jit_march(
            tuple(o), tuple(d), tuple(jnp.float32(float(c)) for c in sun),
            jnp.asarray(np.asarray(rad)),
            tuple(jnp.asarray(np.asarray(c)) for c in amb))[0][0])

    # the reference's compiled march on the port's inputs, every lane
    apart = sum(int((np.abs(march(t, t[:3], t[3:6]) - t[6])
                     > 1e-3 * np.maximum(np.abs(t[6]), 1.0)).sum())
                for t in trec)
    print("the reference's compiled march on the port's inputs: radiance "
          "apart from the port's by more than 1e-3 in %d of %d lanes"
          % (apart, sum(len(t[0]) for t in trec)))
    for _, s, lane in sorted(worst, reverse=True)[:3]:
        j, t = jrec[s], trec[s]
        on_j = float(march(t, j[:3], j[3:6])[lane])
        on_t = float(march(t, t[:3], t[3:6])[lane])
        print("sample %d lane %d: direction y %.9g (JAX) %.9g (port); the "
              "reference's compiled march on its inputs %.6g, on the port's "
              "%.6g; the port's march %.6g" % (s, lane, j[4][lane], t[4][lane],
                                                on_j, on_t, t[6][lane]))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--skip-jax", action="store_true")
    p.add_argument("--samples", type=int, default=SPP)
    p.add_argument("--jax-child", action="store_true")
    a = p.parse_args()
    if a.jax_child:
        return _jax_render_child()
    if not a.skip_jax:
        _jax_renders()
    import torch

    from luminary_tpu_torch.render.renderer import Renderer
    from luminary_tpu_torch.testing import clouds_scene

    torch.set_num_threads(1)
    r = Renderer(clouds_scene(), chunk=1 << 20, device="cpu")
    r.render_samples(SPP)
    print("port: %r" % _rel(r.get_radiance(), np.load(GOLDEN)))
    _lanes(a.samples)


if __name__ == "__main__":
    main()
