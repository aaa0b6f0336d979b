"""Component-SoA 3-vectors for the hot path (port of ``luminary_tpu/ops/vec.py``).

A :class:`Vec3` is a NamedTuple of three flat ``[N]`` tensors. The JAX
package chose this layout against the TPU's lane padding; the port keeps it
so that every module compares like with like against the reference, and
because per-component tensors are also coalesced on a GPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __radd__(self, o):
        return self.__add__(o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    @staticmethod
    def of(x, y, z, like):
        """Vec3 of float32 constants broadcast to ``like``'s shape."""
        ref = like.x if isinstance(like, Vec3) else like
        return Vec3(*(torch.full(ref.shape, float(c), dtype=torch.float32,
                                 device=ref.device) for c in (x, y, z)))


def rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """``num / t`` with one IEEE division, as the reference computes it.
    (PyTorch evaluates ``float / tensor`` as ``reciprocal(t) * float``,
    which rounds twice.)"""
    return torch.div(torch.full_like(t, num), t)


def sdiv(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` for a host scalar ``c`` with one IEEE division on every
    device (on the card PyTorch multiplies by the float reciprocal of a host
    scalar, one more rounding), so that the card and the CPU agree."""
    return torch.div(t, torch.full_like(t, c))


def dot(a: Vec3, b: Vec3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length(v: Vec3):
    return torch.sqrt(torch.clamp(dot(v, v), min=0.0))


def normalize(v: Vec3, eps: float = 1e-20) -> Vec3:
    inv = torch.reciprocal(torch.clamp(length(v), min=eps))
    return Vec3(v.x * inv, v.y * inv, v.z * inv)


def fma32(a, b, c) -> torch.Tensor:
    """The float32 fused multiply-add ``a * b + c``, rounded once, as XLA's
    CPU code computes a product that has one use and the add that consumes
    it. Numbers are taken as float32 constants. On the card one launch of
    ``csrc/fma32.cu`` (the card's own fused multiply-add); elsewhere
    :func:`fma32_plain`. Both give the same bits."""
    return fma32_plain(a, b, c)




def fma32_plain(a, b, c) -> torch.Tensor:
    """Plain PyTorch version of :func:`fma32`: the product is exact in
    float64 and the sum is rounded once in float64. Rounding that to float32
    rounds the exact value alike unless the float64 sum landed on a float32
    midpoint (a tie that the exact value may not be), or lies below
    float32's normal range; only those lanes take the sum's rounding error
    (TwoSum) into account, rounding to odd in float64 first."""
    f64 = torch.float64

    def wide(v):
        if isinstance(v, torch.Tensor):
            return v.to(f64)
        return float(np.float32(v))

    p = wide(a) * wide(b)
    q = wide(c)
    s = p + q
    out = s.to(torch.float32)
    low = s.view(torch.int64) & 0x1FFFFFFF
    at = torch.nonzero(((low == 0x10000000) | (torch.abs(s) < 2.0 ** -126))
                       .reshape(-1)).flatten()
    if at.numel():
        p, q = (torch.broadcast_to(torch.as_tensor(v, dtype=f64, device=s.device),
                                   s.shape).reshape(-1)[at] for v in (p, q))
        out.view(-1)[at] = _round_odd_sum(p, q).to(torch.float32)
    return out


def _round_odd_sum(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``p + q`` in float64 rounded to odd: where the sum is inexact, the odd
    one of its two float64 neighbours (TwoSum finds the error), so that one
    more rounding to float32 is the single rounding of the exact sum."""
    s = p + q
    pv = s - q
    qv = s - pv
    e = (p - pv) + (q - qv)
    even = (s.view(torch.int64) & 1) == 0
    bump = (e != 0) & even & torch.isfinite(s)
    inf = torch.full_like(s, float("inf"))
    return torch.where(bump, torch.nextafter(s, torch.where(e > 0, inf, -inf)), s)


def ray_point(origin: Vec3, direction: Vec3, t) -> Vec3:
    """``origin + direction * t``, rounded once per component as the
    reference's compiled integrator rounds its hit point: on a grazing hit
    the sum cancels, and the next origin keeps the difference. On the card
    one launch of ``csrc/shading.cu`` ``lum_ray_point``; elsewhere
    :func:`ray_point_plain`."""
    return ray_point_plain(origin, direction, t)




def ray_point_plain(origin: Vec3, direction: Vec3, t) -> Vec3:
    """Plain PyTorch version of :func:`ray_point`."""
    return Vec3(fma32(direction.x, t, origin.x), fma32(direction.y, t, origin.y),
                fma32(direction.z, t, origin.z))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as XLA and CUDA take it.
    PyTorch's float32 CPU kernel is an ulp off on ~0.7 % of inputs, which
    formulas that cancel badly amplify; on the CPU this goes through
    float64 (rounded once: exact for a square root)."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def normalize_rn(v: Vec3, eps: float = 1e-20) -> Vec3:
    """:func:`normalize` with the correctly rounded square root."""
    inv = torch.reciprocal(torch.clamp(sqrt_rn(torch.clamp(dot(v, v), min=0.0)),
                                       min=eps))
    return Vec3(v.x * inv, v.y * inv, v.z * inv)


def normalize_fused(v: Vec3, eps: float = 1e-20) -> Vec3:
    """:func:`normalize_rn` with ``dot(v, v)`` contracted as XLA's CPU code
    contracts it: ``fma(z, z, fma(x, x, y * y))``."""
    d = fma32(v.z, v.z, fma32(v.x, v.x, v.y * v.y))
    inv = torch.reciprocal(torch.clamp(sqrt_rn(torch.clamp(d, min=0.0)), min=eps))
    return Vec3(v.x * inv, v.y * inv, v.z * inv)


def vwhere(mask, a: Vec3, b: Vec3) -> Vec3:
    """Component select by an ``[N]`` (or scalar) mask."""
    return Vec3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def reflect(v: Vec3, n: Vec3) -> Vec3:
    d = 2.0 * dot(v, n)
    return Vec3(v.x - d * n.x, v.y - d * n.y, v.z - d * n.z)


def orthonormal_basis(n: Vec3) -> tuple[Vec3, Vec3]:
    """Branchless ONB (Duff et al. 2017)."""
    s = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n.z)
    b = n.x * n.y * a
    t = Vec3(1.0 + s * n.x * n.x * a, s * b, -s * n.x)
    bt = Vec3(b, s + n.y * n.y * a, -n.y)
    return t, bt


def quaternion_apply_v(qw, qx, qy, qz, v: Vec3) -> Vec3:
    """Rotate v by quaternion components (0-d or ``[N]`` tensors)."""
    u = Vec3(qx, qy, qz)
    dot_uv = dot(u, v)
    dot_uu = qx * qx + qy * qy + qz * qz
    c = cross(u, v)
    s = qw
    k1 = 2.0 * dot_uv
    k2 = s * s - dot_uu
    k3 = 2.0 * s
    return Vec3(
        u.x * k1 + v.x * k2 + c.x * k3,
        u.y * k1 + v.y * k2 + c.y * k3,
        u.z * k1 + v.z * k2 + c.z * k3,
    )


def gather(tab: Vec3, idx) -> Vec3:
    """Per-component table gather: tab components are ``[M]`` tensors."""
    return Vec3(tab.x[idx], tab.y[idx], tab.z[idx])
