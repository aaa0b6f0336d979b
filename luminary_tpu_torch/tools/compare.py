"""Image-error comparison for convergence benchmarking.

The port of ``luminary_tpu/tools/compare.py``. It fills the role of the
reference's comparison.py (mean FLIP error against a reference image for
each benchmark output, error curves against samples and wall time). FLIP
itself is not available, so the perceptual metric is a compact FLIP-style
approximation (a CSF-filtered colour difference in an opponent space) beside
exact RMSE and relMSE. Host-side numpy over the port's PNG reader: it runs
the same on any machine and touches no device.

Usage:
    python -m luminary_tpu_torch.tools.compare REF.png DIR NAME
        reads DIR/Bench-<spp>-<NAME>.png and DIR/BenchResults-<NAME>.txt
        (the CLI's ``-b LOG2_SPP NAME`` ladder) and writes
        DIR/Convergence-<NAME>.csv (spp, seconds, rmse, relmse, flip_approx)
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np

from ..io.png import read_png


def _srgb_to_linear(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32) / 255.0 if x.dtype == np.uint8 else x.astype(np.float32)
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def rmse(img: np.ndarray, ref: np.ndarray) -> float:
    a, b = _srgb_to_linear(img), _srgb_to_linear(ref)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def rel_mse(img: np.ndarray, ref: np.ndarray, eps: float = 1e-3) -> float:
    a, b = _srgb_to_linear(img), _srgb_to_linear(ref)
    return float(np.mean((a - b) ** 2 / (b * b + eps)))


def _gaussian_blur(x: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian with reflect padding."""
    radius = max(int(3 * sigma), 1)
    t = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (t / sigma) ** 2)
    k /= k.sum()

    def conv1d(img, axis):
        pad = [(0, 0)] * img.ndim
        pad[axis] = (radius, radius)
        p = np.pad(img, pad, mode="reflect")
        out = np.zeros_like(img)
        for i, w in enumerate(k):
            sl = [slice(None)] * img.ndim
            sl[axis] = slice(i, i + img.shape[axis])
            out += w * p[tuple(sl)]
        return out

    return conv1d(conv1d(x, 0), 1)


def _to_ycxcz(lin: np.ndarray) -> np.ndarray:
    """Linear RGB to an opponent (achromatic, red-green, blue-yellow) space,
    the colour decomposition FLIP uses."""
    # linear sRGB to XYZ (D65)
    m = np.asarray(
        [
            [0.4124, 0.3576, 0.1805],
            [0.2126, 0.7152, 0.0722],
            [0.0193, 0.1192, 0.9505],
        ],
        np.float32,
    )
    xyz = lin @ m.T
    y = xyz[..., 1:2]
    return np.concatenate(
        [y, xyz[..., 0:1] - xyz[..., 1:2], xyz[..., 1:2] - xyz[..., 2:3]], axis=-1
    )


def flip_approx(img: np.ndarray, ref: np.ndarray, ppd: float = 67.0) -> float:
    """FLIP-style perceptual error: each opponent channel band-passed by a
    Gaussian (the achromatic one sharpest), then a Minkowski-pooled
    normalised difference. It orders images as FLIP does well enough for
    convergence curves; it is not the official metric."""
    a = _to_ycxcz(_srgb_to_linear(img))
    b = _to_ycxcz(_srgb_to_linear(ref))
    sigmas = (0.5 * ppd / 67.0, 1.0 * ppd / 67.0, 2.0 * ppd / 67.0)
    err = np.zeros(a.shape[:2], np.float32)
    weights = (1.0, 0.5, 0.5)
    for c, (sig, w) in enumerate(zip(sigmas, weights)):
        fa = _gaussian_blur(a[..., c], sig)
        fb = _gaussian_blur(b[..., c], sig)
        scale = np.abs(fb).mean() + 0.01
        err += w * np.abs(fa - fb) / scale
    err /= sum(weights)
    # Minkowski pooling (q = 3) weighs localised errors, as FLIP's near-max
    return float(np.mean(err**3) ** (1.0 / 3.0))


def compare_ladder(ref_path: str, out_dir: str, name: str) -> list[dict]:
    """One row {spp, seconds, rmse, relmse, flip_approx} per ladder image of
    ``name`` in ``out_dir`` that has the reference's shape, by spp; also
    written as ``Convergence-<name>.csv`` there."""
    ref = read_png(ref_path)[..., :3]
    results_file = os.path.join(out_dir, f"BenchResults-{name}.txt")
    times = {}
    if os.path.exists(results_file):
        with open(results_file) as f:
            for line in f.readlines()[1:]:
                spp, secs = line.strip().split(",")
                times[int(spp)] = float(secs)

    rows = []
    pat = re.compile(rf"Bench-(\d+)-{re.escape(name)}\.png$")
    for fname in sorted(os.listdir(out_dir)):
        m = pat.match(fname)
        if not m:
            continue
        spp = int(m.group(1))
        img = read_png(os.path.join(out_dir, fname))[..., :3]
        if img.shape != ref.shape:
            continue
        rows.append(
            {
                "spp": spp,
                "seconds": times.get(spp, float("nan")),
                "rmse": rmse(img, ref),
                "relmse": rel_mse(img, ref),
                "flip_approx": flip_approx(img, ref),
            }
        )
    rows.sort(key=lambda r: r["spp"])

    csv = os.path.join(out_dir, f"Convergence-{name}.csv")
    with open(csv, "w") as f:
        f.write("spp,seconds,rmse,relmse,flip_approx\n")
        for r in rows:
            f.write(
                f"{r['spp']},{r['seconds']:.6f},{r['rmse']:.6f},"
                f"{r['relmse']:.6f},{r['flip_approx']:.6f}\n"
            )
    return rows


def format_row(r: dict) -> str:
    return (f"spp {r['spp']:6d}  t {r['seconds']:9.3f}s  rmse {r['rmse']:.5f}  "
            f"relmse {r['relmse']:.5f}  flip~ {r['flip_approx']:.5f}")


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 3:
        print(__doc__)
        return 1
    for r in compare_ladder(*argv):
        print(format_row(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
