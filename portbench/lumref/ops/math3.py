"""Vector math over tensors with a trailing dimension of 3 (port of
``luminary_tpu/ops/math3.py``; the atmosphere bake works in this layout)."""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(dot(v, v), min=0.0))


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return v * torch.reciprocal(torch.clamp(length(v), min=eps))[..., None]


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
