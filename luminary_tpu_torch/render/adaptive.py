"""Adaptive sampling: variance-driven per-block sample allocation (port of
``luminary_tpu/render/adaptive.py``).

Per-4x4-block relative error drives stages of extra samples, exposure-aware.
The error reduction is one dense pass over the moment buffers on their
device; a stage's wavefront is a new (px, py) index list built on the host
from the block picks, with per-lane sample ids so that every pixel continues
its own QMC sequence. A stage accumulates into subset-shaped buffers that
are scatter-added into the frame accumulators once per stage.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 4  # 4x4 blocks


def block_error_map(radiance_sum, lum_sq_sum, sample_count, width: int,
                    height: int, exposure_aware: bool, exposure=1.0):
    """[H/4, W/4] relative standard error per block: sqrt(Var[mean]) /
    (mean + eps), or compressed by the tonemap slope when exposure-aware
    (bright pixels tolerate more absolute noise)."""
    n_pix = width * height
    lum = (0.2126 * radiance_sum[:n_pix, 0] + 0.7152 * radiance_sum[:n_pix, 1]
           + 0.0722 * radiance_sum[:n_pix, 2])
    cnt = torch.clamp(sample_count[:n_pix].to(torch.float32), min=1.0)
    mean = lum / cnt
    ex2 = lum_sq_sum[:n_pix] / cnt
    var = torch.clamp(ex2 - mean * mean, min=0.0) / cnt
    err = torch.sqrt(var)
    if exposure_aware:
        exposure = torch.as_tensor(exposure, dtype=torch.float32,
                                   device=err.device)
        scale = 1.0 / torch.square(1.0 + mean * exposure)
        err = err * scale * exposure
    else:
        err = err / (mean + 1e-2)
    hb, wb = height // BLOCK, width // BLOCK
    err_img = err.reshape(height, width)
    blocks = err_img[: hb * BLOCK, : wb * BLOCK].reshape(hb, BLOCK, wb, BLOCK)
    return blocks.amax(dim=(1, 3))


def scatter_add_stage(radiance_sum, lum_sq_sum, sample_count, idx,
                      stage_radiance, stage_lum_sq, stage_count):
    """Fold a stage's subset accumulation back into the frame buffers
    (repeated indices add up; on CUDA their float order is not fixed)."""
    idx = idx.to(torch.int64)
    return (
        radiance_sum.index_add(0, idx, stage_radiance),
        lum_sq_sum.index_add(0, idx, stage_lum_sq),
        sample_count.index_add(0, idx, stage_count.to(sample_count.dtype)),
    )


def pick_stage_pixels(error_blocks: np.ndarray, width: int, height: int,
                      budget_pixels: int,
                      min_error: float = 1e-4) -> np.ndarray | None:
    """Host-side block selection: the highest-error blocks fill the stage
    budget. Returns flat pixel indices (a multiple of BLOCK² long) or None
    when converged."""
    hb, wb = error_blocks.shape
    flat = error_blocks.reshape(-1)
    order = np.argsort(-flat, kind="stable")
    num_blocks = min(max(budget_pixels // (BLOCK * BLOCK), 1), flat.size)
    chosen = order[:num_blocks]
    chosen = chosen[flat[chosen] > min_error]
    if chosen.size == 0:
        return None
    by, bx = np.divmod(chosen, wb)
    ys = (by[:, None, None] * BLOCK + np.arange(BLOCK)[None, :, None])
    xs = (bx[:, None, None] * BLOCK + np.arange(BLOCK)[None, None, :])
    pix = (ys * width + xs).reshape(-1)
    return pix[pix < width * height].astype(np.int32)


def allocate_stage_tasks(error_blocks: np.ndarray, width: int, height: int,
                         avg_rate: int, max_rate: int = 32,
                         min_error: float = 1e-4,
                         budget_tasks: int | None = None):
    """Proportional per-block stage allocation with a prefix-sum task list.

    Every unconverged block receives ``clamp(round(err/avg_err * avg_rate),
    1, max_rate)`` samples this stage; the task list repeats each block's
    pixels once per sample, highest-error blocks first, truncated to
    ``budget_tasks``. Returns (pix, rank): flat pixel indices and each
    entry's occurrence rank (its 0-based extra-sample index in the stage),
    or (None, None) when every block is converged.
    """
    flat = error_blocks.reshape(-1).astype(np.float64)
    unconverged = flat > min_error
    if not unconverged.any():
        return None, None
    # the average runs over all blocks: converged regions pull it down, so
    # the remaining hot blocks weigh more
    avg_err = flat.mean()
    counts = np.rint(flat / max(avg_err, 1e-12) * avg_rate).astype(np.int64)
    counts = np.clip(counts, 1, max_rate)
    counts[~unconverged] = 0

    hb, wb = error_blocks.shape
    order = np.argsort(-flat, kind="stable")
    order = order[counts[order] > 0]
    if budget_tasks is not None:
        keep = np.searchsorted(
            np.cumsum(counts[order] * (BLOCK * BLOCK)),
            max(budget_tasks, BLOCK * BLOCK))
        order = order[: max(int(keep), 1)]

    by, bx = np.divmod(order, wb)
    ys = by[:, None, None] * BLOCK + np.arange(BLOCK)[None, :, None]
    xs = bx[:, None, None] * BLOCK + np.arange(BLOCK)[None, None, :]
    block_pix = (ys * width + xs).reshape(order.size, -1)  # [B, 16]

    reps = counts[order]
    pix = np.repeat(block_pix, reps, axis=0).reshape(-1)
    rank = np.concatenate(
        [np.repeat(np.arange(r), BLOCK * BLOCK) for r in reps])
    valid = pix < width * height
    return pix[valid].astype(np.int32), rank[valid].astype(np.int64)
