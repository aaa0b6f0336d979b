"""The comparison that decides ``correct``.

Per checked pixel, the gap between the program's mean radiance and the
reference's, over the three channels, relative to the reference's
brightest channel plus a floor: ``max |P - R| / (max R + FLOOR)``. A pixel
whose gap passes ``PIXEL_GAP`` (or is not a number) is a mismatch. The
program's path is the reference's arithmetic, so a pixel matches to
rounding unless its paths parted (a tie between two hits, a branch
decided by an ulp); ``mismatch_pct``, the share of mismatched pixels, is
the number compared with the configuration's limit.
"""

from __future__ import annotations

import numpy as np

FLOOR = 1e-2
PIXEL_GAP = 1e-4


def pixel_gaps(program: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """The gap of each pixel [K] between two [K, 3] radiance arrays."""
    p = program.astype(np.float64)
    r = reference.astype(np.float64)
    return np.max(np.abs(p - r), axis=1) / (np.max(np.abs(r), axis=1) + FLOOR)


def mismatch_pct(program: np.ndarray, reference: np.ndarray) -> float:
    gaps = pixel_gaps(program, reference)
    return float(100.0 * np.mean(~(gaps <= PIXEL_GAP)))


def judge(program: np.ndarray, reference: np.ndarray, samples: int,
          limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): the share of mismatched
    pixels at most its limit, and at least one sample rendered."""
    numbers = {
        "samples": {"value": int(samples), "limit": 1},
        "mismatch_pct": {"value": mismatch_pct(program, reference),
                         "limit": float(limits["mismatch_pct"])},
    }
    ok = (samples >= 1
          and numbers["mismatch_pct"]["value"] <= numbers["mismatch_pct"]["limit"])
    return ok, numbers


def check_pixels(width: int, height: int, count: int, seed: int):
    """``count`` distinct pixels (px, py) drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), 1]))
    idx = rng.choice(width * height, size=min(count, width * height),
                     replace=False)
    idx.sort()
    return (idx % width).astype(np.int64), (idx // width).astype(np.int64)
