"""The analytic ocean surface (port of ``luminary_tpu/ops/ocean.py``): a
Lipschitz-bounded sphere trace of the FBM heightfield for closest hits and a
fixed-step sign-change march for shadow segments.

Both run only on the lanes whose ray meets the wave band (the others can
neither hit nor cross the surface), in blocks of at most OCEAN_BLOCK
elements. ``ocean_intersect`` steps all of a block's lanes 64 times as the
reference does, and stops early once every lane of the block is done (a
done lane never changes again). ``ocean_crosses`` evaluates its 16 steps
as one stacked height evaluation: the steps are independent.

The surface is ``y = height + amplitude * fbm(x f, z f)``
(:func:`ops.procedural.ocean_height`), shared with the caustic sampler and
the tessellated mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from .procedural import ocean_height, ocean_height_normal
from .vec import Vec3, gather

_F32 = np.float32
# Lipschitz bound of the FBM in noise coordinates (5 octaves, amp 0.5^o,
# freq 2.1^o, smoothstep slope 1.5): 1.5 * sum(1.05^o) / 0.96875
_FBM_LIPSCHITZ = 8.56
_FBM_RANGE = 0.5  # |fbm| <= 0.5
# the largest [steps, lanes] temporary of a march, in elements
OCEAN_BLOCK = 1 << 22
# steps between two checks of "every lane done" (a host sync on the card)
_DONE_CHECK = 16


def _band_clip(water, origin: Vec3, direction: Vec3, t_max):
    """Clip each ray to the wave band [height - A/2 - m, height + A/2 + m]
    → (t0, t1, feasible)."""
    band = float(_F32(_FBM_RANGE) * _F32(water.amplitude) + _F32(1e-4))
    hi = float(_F32(water.height) + _F32(band))
    lo = float(_F32(water.height) - _F32(band))
    dy = direction.y
    dy_s = torch.where(torch.abs(dy) < 1e-9, 1e-9, dy)
    t_hi = (hi - origin.y) / dy_s
    t_lo = (lo - origin.y) / dy_s
    t_enter = torch.minimum(t_hi, t_lo)
    t_exit = torch.maximum(t_hi, t_lo)
    inside = (origin.y > lo) & (origin.y < hi)
    horiz = torch.abs(dy) < 1e-9
    t0 = torch.where(inside, 0.0, torch.clamp(t_enter, min=0.0))
    t1 = torch.where(horiz & inside, t_max, torch.minimum(t_exit, t_max))
    t1 = torch.minimum(t1, t_max)
    feasible = (t1 > t0) & torch.where(horiz, inside, t_exit > 0.0)
    return t0, t1, feasible


def _g(water, o: Vec3, d: Vec3, t):
    """Height of the ray point above the surface at distance t."""
    return (o.y + d.y * t) - ocean_height(water, o.x + d.x * t, o.z + d.z * t)


def ocean_intersect(water, origin: Vec3, direction: Vec3, t_max, active,
                    iters: int = 64):
    """Closest intersection with the analytic surface → (found bool [N],
    t f32 [N]): t stops just shy of the surface; lanes that use up ``iters``
    inside the band take the mean plane y = height when it lies ahead
    within the band clip (waves are sub-pixel there), else report no hit."""
    n = origin.x.shape[0]
    dev = origin.x.device
    t_max = t_max.expand(n) if isinstance(t_max, torch.Tensor) else torch.full(
        (n,), float(t_max), dtype=torch.float32, device=dev)
    t0, t1, feasible = _band_clip(water, origin, direction, t_max)
    feasible = feasible & active
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    t_out = t0.clone()
    lanes = torch.nonzero(feasible).flatten()
    slope = float(_F32(water.amplitude) * _F32(water.frequency)
                  * _F32(_FBM_LIPSCHITZ))
    eps_g = float(_F32(1e-3) * _F32(water.amplitude) + _F32(1e-5))
    for a in range(0, lanes.shape[0], OCEAN_BLOCK):
        ix = lanes[a:a + OCEAN_BLOCK]
        o, d = gather(origin, ix), gather(direction, ix)
        tb0, tb1 = t0[ix], t1[ix]
        dxz = torch.sqrt(d.x * d.x + d.z * d.z)
        denom = torch.abs(d.y) + slope * dxz + 1e-9
        t = tb0
        done = torch.zeros_like(tb0, dtype=torch.bool)
        hit = torch.zeros_like(done)
        escaped = torch.abs(_g(water, o, d, tb0)) > 2.0 * eps_g
        for i in range(iters):
            if i % _DONE_CHECK == 0 and bool(done.all()):
                break
            g = _g(water, o, d, t)
            ag = torch.abs(g)
            hit_now = (ag < eps_g) & escaped & ~done
            t_new = t + torch.clamp(ag / denom, min=1e-5)
            stop = done | hit_now
            t = torch.where(stop, t, t_new)
            done = stop | (t_new > tb1)
            hit = hit | hit_now
            escaped = escaped | (ag > 2.0 * eps_g)
        # far field: a grazing ray still inside the band takes the mean plane
        exhausted = ~done
        dy_s = torch.where(torch.abs(d.y) < 1e-9, 1e-9, d.y)
        t_plane = (float(_F32(water.height)) - o.y) / dy_s
        plane_ok = exhausted & (t_plane >= t) & (t_plane <= tb1)
        found[ix] = hit | plane_ok
        t_out[ix] = torch.where(plane_ok, t_plane, t)
    return found, t_out


def ocean_crosses(water, origin: Vec3, direction: Vec3, t_len, active,
                  steps: int = 16) -> torch.Tensor:
    """True where the segment crosses the surface (shadow test): the sign
    of the height above the surface, at the inset start and at ``steps``
    fixed steps, changes. Endpoints on the interface (caustic segments)
    stay on their side."""
    n = origin.x.shape[0]
    dev = origin.x.device
    t0, t1, feasible = _band_clip(water, origin, direction, t_len)
    feasible = feasible & active & (t_len > 1e-6)
    crossed = torch.zeros(n, dtype=torch.bool, device=dev)
    lanes = torch.nonzero(feasible).flatten()
    k = torch.arange(steps + 1, dtype=torch.float32, device=dev)[:, None]
    block = max(OCEAN_BLOCK // (steps + 1), 1)
    for a in range(0, lanes.shape[0], block):
        ix = lanes[a:a + block]
        o, d = gather(origin, ix), gather(direction, ix)
        span = torch.clamp(t1[ix] - t0[ix], min=0.0)
        inset = torch.clamp(0.02 * span, max=1e-2)
        ta = t0[ix] + inset
        dt = torch.clamp((span - 2.0 * inset) / float(steps), min=0.0)
        # row 0 the start, row i the i-th step
        t = torch.cat([ta[None], ta[None] + dt[None] * k[1:]])
        above = _g(water, Vec3(o.x[None], o.y[None], o.z[None]),
                   Vec3(d.x[None], d.y[None], d.z[None]), t) >= 0.0
        crossed[ix] = (above[1:] != above[:1]).any(dim=0)
    return crossed


def ocean_normal(water, px: torch.Tensor, pz: torch.Tensor) -> Vec3:
    """Unit surface normal at world (x, z)."""
    _, n = ocean_height_normal(water, px, pz)
    return Vec3(n[0], n[1], n[2])
