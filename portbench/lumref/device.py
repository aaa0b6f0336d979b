"""Device choice for the port's entry points: the card unless the caller
asks for the CPU."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the first CUDA card; without one this raises instead of
    quietly running the plain CPU path. Any explicit device is taken as is,
    except that ``"cuda"`` gets the current card's index, so that a worker
    thread can make it its own current device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def on_device(device):
    """Make ``device`` the current CUDA device for the block: the kernels
    launch into ``torch.cuda.current_stream(device)``, and CUDA refuses a
    launch into a stream of a device other than the current one. A no-op
    context for a CPU device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
