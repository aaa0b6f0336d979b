"""The check that no module of a run has the top-level name of JAX or the
JAX package, compared whole."""

import os
import subprocess
import sys

from harness import guard

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def test_names_compare_whole():
    assert guard.forbidden_loaded(["luminary_tpu_torch", "luminary_tpu_torch.ops",
                                   "jaxtyping", "lumref"]) == []
    assert guard.forbidden_loaded(["luminary_tpu.render"]) == ["luminary_tpu"]
    assert guard.forbidden_loaded(["jax.numpy", "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib"]


def test_the_harness_program_and_reference_load_neither():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import harness.cell, harness.cli, lumref.render.wavefront\n"
        "import lumref.render.device_scene, luminary_tpu_torch.host.host\n"
        "import luminary_tpu_torch.parallel.mesh\n"
        "from harness import guard, spec\n"
        "for m in ('device_idle_pct', 'launches_per_sample', 'pack_s'):\n"
        "    spec.load_module('metrics', m)\n"
        "spec.load_module('scenes', 'bench_field')\n"
        "print(guard.forbidden_loaded())\n" % (BENCH, ROOT))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    import ast

    for base, _, files in os.walk(os.path.join(BENCH, "lumref")):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(base, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module]
                else:
                    continue
                for n in names:
                    assert n.split(".")[0] not in (
                        "luminary_tpu", "luminary_tpu_torch", "jax"), (f, n)
