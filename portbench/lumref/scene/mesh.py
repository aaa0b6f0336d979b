"""Host-side mesh container.

The reference keeps meshes as triangle arrays with per-triangle material slots
(reference: src/luminary/mesh.c, src/luminary/device/device_structs.h:255-281,
DeviceTriangle split into vertex/texture SoA). Here a mesh is numpy SoA from the
start — the natural layout for both the BVH builder and the JAX device upload.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Mesh:
    """Triangle mesh in SoA layout.

    Attributes:
      vertices:   float32 [V, 3] positions.
      triangles:  int32 [T, 3] vertex indices.
      normals:    float32 [T, 3, 3] per-corner shading normals (unit).
      uvs:        float32 [T, 3, 2] per-corner texture coords.
      material_ids: uint16 [T] material slot per triangle.
      name:       debug name.
    """

    vertices: np.ndarray
    triangles: np.ndarray
    normals: np.ndarray | None = None
    uvs: np.ndarray | None = None
    material_ids: np.ndarray | None = None
    name: str = ""
    id: int = 0

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, dtype=np.float32).reshape(-1, 3)
        self.triangles = np.asarray(self.triangles, dtype=np.int32).reshape(-1, 3)
        t = self.num_triangles
        if self.material_ids is None:
            self.material_ids = np.zeros((t,), dtype=np.uint16)
        else:
            self.material_ids = np.asarray(self.material_ids, dtype=np.uint16).reshape(t)
        if self.uvs is None:
            self.uvs = np.zeros((t, 3, 2), dtype=np.float32)
        else:
            self.uvs = np.asarray(self.uvs, dtype=np.float32).reshape(t, 3, 2)
        if self.normals is None:
            self.normals = self.face_normals()[:, None, :].repeat(3, axis=1)
        else:
            self.normals = np.asarray(self.normals, dtype=np.float32).reshape(t, 3, 3)

    @property
    def num_triangles(self) -> int:
        return int(self.triangles.shape[0])

    @property
    def num_vertices(self) -> int:
        return int(self.vertices.shape[0])

    def corner_positions(self) -> np.ndarray:
        """float32 [T, 3, 3] triangle corner positions."""
        return self.vertices[self.triangles]

    def face_normals(self) -> np.ndarray:
        """float32 [T, 3] geometric normals (unit; zero-area tris get +Y)."""
        p = self.corner_positions()
        n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        length = np.linalg.norm(n, axis=-1, keepdims=True)
        fallback = np.array([0.0, 1.0, 0.0], dtype=np.float32)
        return np.where(length > 1e-20, n / np.maximum(length, 1e-20), fallback).astype(
            np.float32
        )

    def aabb(self) -> tuple[np.ndarray, np.ndarray]:
        if self.num_vertices == 0:
            z = np.zeros(3, np.float32)
            return z, z
        return self.vertices.min(axis=0), self.vertices.max(axis=0)


@dataclass
class Texture:
    """CPU texture container (reference: src/luminary/texture.h:6-38).

    data: numpy array [H, W, C] (uint8 or float32) or [D, H, W, C] for 3D.
    """

    data: np.ndarray
    gamma: float = 1.0
    wrap: str = "repeat"  # repeat | clamp | mirror
    name: str = ""

    @property
    def is_3d(self) -> bool:
        return self.data.ndim == 4

    @property
    def width(self) -> int:
        return int(self.data.shape[-2])

    @property
    def height(self) -> int:
        return int(self.data.shape[-3])

    def as_float(self) -> np.ndarray:
        if self.data.dtype == np.uint8:
            f = self.data.astype(np.float32) / 255.0
        elif self.data.dtype == np.uint16:
            f = self.data.astype(np.float32) / 65535.0
        else:
            f = self.data.astype(np.float32)
        if self.gamma != 1.0:
            f = f.copy()
            f[..., : min(3, f.shape[-1])] **= self.gamma
        return f
