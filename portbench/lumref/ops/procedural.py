"""Procedural geometry (port of ``luminary_tpu/ops/procedural.py``): the
ocean surface, with the u32 lattice hash, value noise and FBM in numpy (the
tessellated mesh, built on the host in float64 as the reference builds it)
and in PyTorch (the analytic surface the integrator marches, its normal and
the caustic connection sampler, all in float32); and the particle field's
billboard quads (numpy over the same random generator, so that the corners
come out bit for bit).

The tensor forms evaluate the four lattice corners of a value-noise lookup
in one stacked hash, and ``ocean_height_normal`` its five heights in one
stacked FBM; each element is the same expression the reference evaluates.
"""

from __future__ import annotations

import numpy as np
import torch

from .random import M32
from .vec import sdiv

# The procedural instances' stable ids (picking; user instances count
# from 0).
OCEAN_INSTANCE_ID = 0x7FFF0000
PARTICLES_INSTANCE_ID = 0x7FFF0001

# Jerlov water types: (absorption RGB 1/m, scattering 1/m).
JERLOV_COEFFS = {
    0: ((0.035, 0.045, 0.120), 0.002),  # I
    1: ((0.040, 0.050, 0.125), 0.003),  # IA
    2: ((0.045, 0.055, 0.130), 0.004),  # IB
    3: ((0.060, 0.070, 0.160), 0.009),  # II
    4: ((0.110, 0.110, 0.220), 0.016),  # III
    5: ((0.100, 0.090, 0.200), 0.016),  # 1C
    6: ((0.190, 0.150, 0.300), 0.029),  # 3C
    7: ((0.330, 0.230, 0.400), 0.049),  # 5C
    8: ((0.500, 0.330, 0.540), 0.075),  # 7C
    9: ((0.780, 0.500, 0.740), 0.115),  # 9C
}


# ---- numpy (host): the tessellated mesh ----

def _hash2(ix: np.ndarray, iz: np.ndarray, seed: int) -> np.ndarray:
    # u32 wraparound is the hash's mixing
    with np.errstate(over="ignore"):
        h = (ix.astype(np.uint32) * np.uint32(374761393)
             + iz.astype(np.uint32) * np.uint32(668265263)
             + np.uint32(seed) * np.uint32(2246822519))
        h ^= h >> 13
        h = h * np.uint32(1274126177)
    h ^= h >> 16
    return (h >> 8).astype(np.float32) / 16777216.0


def value_noise(x: np.ndarray, z: np.ndarray, seed: int = 0) -> np.ndarray:
    """Smooth value noise on a unit grid (bilinear with smoothstep)."""
    ix, iz = np.floor(x), np.floor(z)
    fx, fz = x - ix, z - iz
    sx = fx * fx * (3.0 - 2.0 * fx)
    sz = fz * fz * (3.0 - 2.0 * fz)
    ix, iz = ix.astype(np.int64), iz.astype(np.int64)
    v00 = _hash2(ix, iz, seed)
    v10 = _hash2(ix + 1, iz, seed)
    v01 = _hash2(ix, iz + 1, seed)
    v11 = _hash2(ix + 1, iz + 1, seed)
    return (v00 * (1 - sx) * (1 - sz) + v10 * sx * (1 - sz)
            + v01 * (1 - sx) * sz + v11 * sx * sz)


def ocean_fbm(x: np.ndarray, z: np.ndarray, octaves: int = 5,
              seed: int = 7) -> np.ndarray:
    """Value-noise FBM in [-0.5, 0.5]."""
    total = np.zeros_like(x)
    amp, freq, norm = 0.5, 1.0, 0.0
    for o in range(octaves):
        total += amp * (value_noise(x * freq + 13.7 * o, z * freq - 7.1 * o,
                                    seed + o) - 0.5)
        norm += amp
        amp *= 0.5
        freq *= 2.1
    return total / max(norm, 1e-6)


def generate_ocean_mesh(ocean, center_xz: tuple[float, float] = (0.0, 0.0),
                        extent: float = 200.0, resolution: int = 128):
    """Displaced grid over [center ± extent]² → (corners [T, 3, 3], smooth
    corner normals [T, 3, 3]), wound so that the face normal points +y."""
    n = resolution
    xs = np.linspace(center_xz[0] - extent, center_xz[0] + extent, n + 1)
    zs = np.linspace(center_xz[1] - extent, center_xz[1] + extent, n + 1)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    h = ocean.height + ocean.amplitude * ocean_fbm(gx * ocean.frequency,
                                                   gz * ocean.frequency)
    verts = np.stack([gx, h, gz], axis=-1).astype(np.float32)
    dx = np.gradient(h, xs[1] - xs[0], axis=0)
    dz = np.gradient(h, zs[1] - zs[0], axis=1)
    vn = np.stack([-dx, np.ones_like(h), -dz], axis=-1)
    vn /= np.linalg.norm(vn, axis=-1, keepdims=True)
    v00, v10, v01, v11 = verts[:-1, :-1], verts[1:, :-1], verts[:-1, 1:], verts[1:, 1:]
    n00, n10, n01, n11 = vn[:-1, :-1], vn[1:, :-1], vn[:-1, 1:], vn[1:, 1:]
    t1 = np.stack([v00, v11, v10], axis=2).reshape(-1, 3, 3)
    t2 = np.stack([v00, v01, v11], axis=2).reshape(-1, 3, 3)
    n1 = np.stack([n00, n11, n10], axis=2).reshape(-1, 3, 3)
    n2 = np.stack([n00, n01, n11], axis=2).reshape(-1, 3, 3)
    return (np.concatenate([t1, t2]).astype(np.float32),
            np.concatenate([n1, n2]).astype(np.float32))


def generate_particles(particles):
    """Billboard quads in tile coordinates [0, scale)^3: the integrator
    wraps ray origins into the tile. Returns (corners [T, 3, 3], normals
    [T, 3, 3]), T = 2 x count."""
    rng = np.random.default_rng(particles.seed)
    count = int(particles.count)
    scale = float(particles.scale)
    centers = rng.random((count, 3), np.float32) * scale
    sizes = (
        0.01 * particles.size * (1.0 + particles.size_variation
                                 * (rng.random(count, dtype=np.float32) - 0.5))
    ).astype(np.float32)
    # random facing
    phi = rng.random(count, dtype=np.float32) * 2 * np.pi
    ct = rng.random(count, dtype=np.float32) * 2 - 1
    st = np.sqrt(np.maximum(1 - ct * ct, 0))
    n = np.stack([st * np.cos(phi), ct, st * np.sin(phi)], axis=-1)
    up = np.where(np.abs(n[:, 1:2]) < 0.9, [[0.0, 1.0, 0.0]], [[1.0, 0.0, 0.0]])
    t = np.cross(up, n)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    b = np.cross(n, t)
    s = sizes[:, None]
    p0 = centers - t * s - b * s
    p1 = centers + t * s - b * s
    p2 = centers + t * s + b * s
    p3 = centers - t * s + b * s
    t1 = np.stack([p0, p1, p2], axis=1)
    t2 = np.stack([p0, p2, p3], axis=1)
    corners = np.concatenate([t1, t2]).astype(np.float32)
    nn = np.concatenate([n, n]).astype(np.float32)
    normals = np.repeat(nn[:, None, :], 3, axis=1)
    return corners, normals


# ---- PyTorch (device): the analytic surface ----

# corner offsets (x, z) of a lookup: 00, 10, 01, 11
_CORNER_DX = (0, 1, 0, 1)
_CORNER_DZ = (0, 0, 1, 1)


def _hash2_t(ix: torch.Tensor, iz: torch.Tensor, seed: int) -> torch.Tensor:
    """Tensor twin of _hash2 on int64 lattice coordinates (u32 words in
    int64, masked after each multiply)."""
    h = ((ix & M32) * 374761393 + (iz & M32) * 668265263
         + ((seed * 2246822519) & M32)) & M32
    h = h ^ (h >> 13)
    h = (h * 1274126177) & M32
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) / 16777216.0


def value_noise_t(x: torch.Tensor, z: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Float32 value noise at tensor positions (any shape)."""
    fx0, fz0 = torch.floor(x), torch.floor(z)
    fx, fz = x - fx0, z - fz0
    sx = fx * fx * (3.0 - 2.0 * fx)
    sz = fz * fz * (3.0 - 2.0 * fz)
    shape = (4,) + (1,) * x.dim()
    dx = torch.tensor(_CORNER_DX, dtype=torch.int64, device=x.device).view(shape)
    dz = torch.tensor(_CORNER_DZ, dtype=torch.int64, device=x.device).view(shape)
    v = _hash2_t(fx0.to(torch.int32).to(torch.int64)[None] + dx,
                 fz0.to(torch.int32).to(torch.int64)[None] + dz, seed)
    v00, v10, v01, v11 = v[0], v[1], v[2], v[3]
    return (v00 * (1 - sx) * (1 - sz) + v10 * sx * (1 - sz)
            + v01 * (1 - sx) * sz + v11 * sx * sz)


def ocean_fbm_t(x: torch.Tensor, z: torch.Tensor, octaves: int = 5,
                seed: int = 7) -> torch.Tensor:
    """Float32 twin of ocean_fbm: the surface the mesh displaces."""
    total = torch.zeros_like(x)
    amp, freq, norm = 0.5, 1.0, 0.0
    for o in range(octaves):
        total = total + amp * (value_noise_t(x * freq + 13.7 * o,
                                             z * freq - 7.1 * o, seed + o) - 0.5)
        norm += amp
        amp *= 0.5
        freq *= 2.1
    return sdiv(total, max(norm, 1e-6))


def ocean_height(water, px: torch.Tensor, pz: torch.Tensor) -> torch.Tensor:
    """Surface height y(x, z) of the analytic ocean."""
    f = water.frequency
    return water.height + water.amplitude * ocean_fbm_t(px * f, pz * f)


def ocean_height_normal(water, px: torch.Tensor, pz: torch.Tensor,
                        h_eps: float = 1.0):
    """Surface height and unit normal at world (x, z), the normal from
    central differences at the mesh-cell scale → (y, (nx, ny, nz)). The five
    heights are one stacked evaluation."""
    xs = torch.stack([px, px + h_eps, px - h_eps, px, px])
    zs = torch.stack([pz, pz, pz, pz + h_eps, pz - h_eps])
    h = ocean_height(water, xs, zs)
    dhdx = (h[1] - h[2]) / (2.0 * h_eps)
    dhdz = (h[3] - h[4]) / (2.0 * h_eps)
    # 1 / sqrt: IEEE on the card and the CPU alike (rsqrt is not)
    inv = torch.reciprocal(torch.sqrt(dhdx * dhdx + 1.0 + dhdz * dhdz))
    return h[0], (-dhdx * inv, inv, -dhdz * inv)
