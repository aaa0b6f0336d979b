"""Luminary-TPU on PyTorch and CUDA: the renderer's port to one NVIDIA H100.

The package mirrors ``luminary_tpu`` module for module and keeps its flat
``[N]`` structure-of-arrays lane layout, so every module can be held against
its JAX counterpart on the CPU. The hot paths that the JAX package wrote as
Pallas kernels for the TPU are CUDA C++ kernels here (``csrc/``), built with
``nvcc`` for ``sm_90a`` on first use; each wrapper takes its plain PyTorch
version only for tensors that lie on the CPU.

Entry points run on the card unless the caller passes ``device="cpu"``.
The package imports neither ``jax`` nor ``luminary_tpu``.
"""

__version__ = "0.1.0"

from .scene import (  # noqa: F401
    Camera,
    Instance,
    Material,
    Mesh,
    RendererSettings,
    Scene,
    Sky,
    SkyMode,
)
