"""``luminary_tpu_torch/tools/compare.py`` against the JAX package's
``luminary_tpu/tools/compare.py``: the same seeded images written as PNGs
(a reference and a noisy spp ladder in the files the CLI's ``-b`` ladder
writes) give the same RMSE, relMSE, FLIP-style error and convergence rows,
to 1e-12 (both are the same numpy arithmetic)."""

import os

import numpy as np
import pytest

from luminary_tpu.tools import compare as JC
from luminary_tpu_torch.io.png import write_png
from luminary_tpu_torch.tools import compare as TC

TOL = 1e-12


def _images(seed=11, h=24, w=40):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ref = np.stack([xx * 255 // (w - 1), yy * 255 // (h - 1),
                    (xx + yy) * 255 // (w + h - 2)], -1).astype(np.uint8)
    ladder = {}
    for spp, sigma in ((1, 60.0), (2, 40.0), (4, 25.0), (8, 12.0)):
        noisy = ref.astype(np.float64) + rng.normal(0.0, sigma, ref.shape)
        ladder[spp] = np.clip(noisy, 0, 255).astype(np.uint8)
    return ref, ladder


@pytest.fixture
def ladder_dir(tmp_path):
    ref, ladder = _images()
    write_png(str(tmp_path / "ref.png"), ref)
    for spp, img in ladder.items():
        write_png(str(tmp_path / f"Bench-{spp}-smoke.png"), img)
    # an image of another size and another name: both skipped
    write_png(str(tmp_path / "Bench-16-smoke.png"), ref[:8])
    write_png(str(tmp_path / "Bench-2-other.png"), ref)
    with open(tmp_path / "BenchResults-smoke.txt", "w") as f:
        f.write("samples,seconds\n")
        for spp, secs in ((1, 0.25), (2, 0.5), (4, 1.0)):
            f.write(f"{spp},{secs:.6f}\n")
    return tmp_path


@pytest.mark.parametrize("metric", ["rmse", "rel_mse", "flip_approx"])
def test_metrics_equal_the_reference(metric):
    ref, ladder = _images(seed=12)
    for img in ladder.values():
        a = getattr(TC, metric)(img, ref)
        b = getattr(JC, metric)(img, ref)
        assert abs(a - b) <= TOL * max(1.0, abs(b)), (metric, a, b)
    # float inputs take the same path
    f = ladder[2].astype(np.float32) / 255.0
    assert abs(getattr(TC, metric)(f, ref) - getattr(JC, metric)(f, ref)) <= TOL


def test_compare_ladder_equals_the_reference(ladder_dir):
    d = str(ladder_dir)
    ref = os.path.join(d, "ref.png")
    got = TC.compare_ladder(ref, d, "smoke")
    with open(os.path.join(d, "Convergence-smoke.csv")) as f:
        got_csv = f.read()
    want = JC.compare_ladder(ref, d, "smoke")
    with open(os.path.join(d, "Convergence-smoke.csv")) as f:
        want_csv = f.read()
    assert [r["spp"] for r in got] == [1, 2, 4, 8]
    assert np.isnan(got[-1]["seconds"]) and got[0]["seconds"] == 0.25
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            if k == "seconds" and np.isnan(b[k]):
                assert np.isnan(a[k])
            else:
                assert abs(a[k] - b[k]) <= TOL * max(1.0, abs(b[k])), (k, a, b)
    assert got_csv == want_csv
    # the error falls along the ladder
    assert got[0]["rmse"] > got[-1]["rmse"]


def test_main_prints_the_ladder(ladder_dir, capsys):
    d = str(ladder_dir)
    assert TC.main([os.path.join(d, "ref.png"), d, "smoke"]) == 0
    out = capsys.readouterr().out.strip().split("\n")
    assert len(out) == 4 and out[0].startswith("spp      1")
    assert JC.main([os.path.join(d, "ref.png"), d, "smoke"]) == 0
    assert capsys.readouterr().out.strip().split("\n") == out
    assert TC.main([]) == 1
