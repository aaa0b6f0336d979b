"""Bridge sampling: multi-vertex volume NEE (port of
``luminary_tpu/ops/bridges.py``).

A bridge connects a volume scattering vertex x to a light point y through
M - 1 intermediate scattering vertices: sample M phase directions and
unit-exponential distances freely, then scale the sub-path so that its end
lands on y and rotate it so that the end direction matches:

    path:    d_1 = normalize(y - x), t_i ~ Exp(1),
             d_i = phase_sample(d_{i-1})          (i = 2..M)
    scale:   s = |y - x| / |sum t_i d_i|
    weight:  sigma_s^(M-1) * exp(-sum(s t_i) * sigma_t)
    pdf:     p(M) * (M-1)! / (s sum t_i)^M * |y - x|^3

M is at most the static ``max_vertices``; every step runs on every lane,
masked by ``i < M``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .random import RandomTarget, random_1d
from .vec import Vec3, dot, vwhere
from .volume import hg_phase, sample_hg_direction


def _log_factorial(m: torch.Tensor) -> torch.Tensor:
    """log((m-1)!) by Ramanujan's approximation."""
    n = torch.clamp(m.to(torch.float32) - 1.0, min=1.0)
    t0 = n * torch.log(n)
    t1 = (1.0 / 6.0) * torch.log(n * (1.0 + 4.0 * n * (1.0 + 2.0 * n)))
    t2 = float(np.float32(0.5) * np.log(np.float32(math.pi)))
    return torch.where(m <= 1, 0.0, t0 + t1 + t2 - n)


def _rodrigues(a: Vec3, b: Vec3, v: Vec3) -> Vec3:
    """Rotate v by the shortest rotation taking unit a to unit b (with the
    unnormalised axis a x b; only the antiparallel case degenerates)."""
    c = dot(a, b)
    axis = Vec3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
                a.x * b.y - a.y * b.x)
    s2 = axis.x * axis.x + axis.y * axis.y + axis.z * axis.z
    k = (1.0 - c) / torch.clamp(s2, min=1e-20)
    axv = Vec3(axis.y * v.z - axis.z * v.y, axis.z * v.x - axis.x * v.z,
               axis.x * v.y - axis.y * v.x)
    axd = dot(axis, v)
    return Vec3(v.x * c + axv.x + axis.x * axd * k,
                v.y * c + axv.y + axis.y * axd * k,
                v.z * c + axv.z + axis.z * axd * k)


def _rotate_to(a: Vec3, b: Vec3, v: Vec3) -> Vec3:
    """Rotation a -> b applied to v; near-antiparallel lanes go through a
    perpendicular of a (two well-conditioned rotations)."""
    c = dot(a, b)
    use_x = torch.abs(a.x) < 0.9
    px = torch.where(use_x, 0.0, -a.z)
    py = torch.where(use_x, a.z, 0.0)
    pz = torch.where(use_x, -a.y, a.x)
    pl = torch.sqrt(torch.clamp(px * px + py * py + pz * pz, min=1e-20))
    p = Vec3(px / pl, py / pl, pz / pl)
    two_step = _rodrigues(p, b, _rodrigues(a, p, v))
    return vwhere(c < -0.99, two_step, _rodrigues(a, b, v))


def sample_bridge(x: Vec3, y: Vec3, view_dir: Vec3, g: float, sigma_s: float,
                  sigma_t: float, max_vertices: int, pixel_id, sample_id,
                  depth: int):
    """Sample one bridge per lane from the volume vertex ``x`` to the light
    point ``y``; ``view_dir`` is the path's direction at x.

    Returns (first_dir, segment starts, segment dirs, segment lengths (lists
    of ``max_vertices``), weight_over_pdf [N], phase_first [N], n_verts [N]
    int32). Contribution = Le * phase_first * weight_over_pdf * visibility of
    every segment; degenerate lanes get weight 0."""
    n = x.x.shape[0]
    dev = x.x.device
    to_light = y - x
    target = torch.sqrt(torch.clamp(dot(to_light, to_light), min=0.0))
    tgt_c = torch.clamp(target, min=1e-6)
    base_dir = vwhere(target > 1e-6,
                      Vec3(to_light.x / tgt_c, to_light.y / tgt_c,
                           to_light.z / tgt_c),
                      Vec3.of(0.0, 0.0, 1.0, like=to_light))

    # vertex count ~ Poisson in the optical distance s0 = sigma_t * d,
    # truncated to 1..M: P(n) ~ s0^(n-1) / (n-1)!
    if max_vertices > 1:
        r_m = random_1d(RandomTarget.BRIDGE_VERTEX_COUNT, pixel_id, sample_id,
                        depth)
        log_s0 = torch.log(torch.clamp(sigma_t * target, min=1e-6))
        lf = 0.0
        log_w = []
        for nn in range(max_vertices):
            if nn >= 2:
                lf += math.log(nn)
            log_w.append(nn * log_s0 - lf)
        lw = torch.stack(log_w, dim=0)  # [M, N]
        lw = lw - lw.max(dim=0, keepdim=True).values
        w_cnt = torch.exp(lw)
        cdf = [w_cnt[0]]
        for k in range(1, max_vertices):  # the reference's sequential sums
            cdf.append(cdf[-1] + w_cnt[k])
        tot = cdf[-1]
        u = r_m * tot
        m = 1 + sum((u > c).to(torch.int32) for c in cdf)
        m = torch.clamp(m, 1, max_vertices).to(torch.int32)
        count_pdf = w_cnt.gather(0, (m - 1).long()[None])[0] / tot
    else:
        m = torch.ones(n, dtype=torch.int32, device=dev)
        count_pdf = 1.0

    cur_dir = base_dir
    zero = torch.zeros_like(x.x)
    px, py, pz = zero, zero, zero
    sum_dist = zero
    rel_starts, dirs, lens = [], [], []
    for i in range(max_vertices):
        live = i < m
        if i > 0:
            nd = sample_hg_direction(cur_dir, g, pixel_id, sample_id,
                                     depth * max_vertices + i)
            cur_dir = vwhere(live, nd, cur_dir)
        r_d = random_1d(RandomTarget.BRIDGE_DISTANCE, pixel_id, sample_id,
                        depth * max_vertices + i)
        t_i = -torch.log(torch.clamp(1.0 - r_d, 1e-7, 1.0))
        t_i = torch.where(live, t_i, 0.0)
        rel_starts.append(Vec3(px, py, pz))
        dirs.append(cur_dir)
        lens.append(t_i)
        px = px + cur_dir.x * t_i
        py = py + cur_dir.y * t_i
        pz = pz + cur_dir.z * t_i
        sum_dist = sum_dist + t_i

    actual = torch.sqrt(torch.clamp(px * px + py * py + pz * pz, min=0.0))
    ok = (actual > 1e-6) & (target > 1e-6)
    act_c = torch.clamp(actual, min=1e-6)
    scale = torch.where(ok, target / act_c, 0.0)
    s_sum = sum_dist * scale

    mf = m.to(torch.float32)
    log_pdf = _log_factorial(m) - mf * torch.log(torch.clamp(s_sum, min=1e-20))
    path_pdf = count_pdf * torch.exp(log_pdf) * target * target * target
    # sigma_s^(M-1): the interior scattering events (the albedo at x is in
    # the path throughput already, the end lands on the emitter)
    log_sigma_s = float(np.log(np.float32(max(sigma_s, 1e-20))))
    weight = torch.exp((mf - 1.0) * log_sigma_s - s_sum * sigma_t)
    w_over_pdf = torch.where(ok & (path_pdf > 1e-30),
                             weight / torch.clamp(path_pdf, min=1e-30), 0.0)

    end_dir = vwhere(ok, Vec3(px / act_c, py / act_c, pz / act_c), base_dir)
    first_dir = _rotate_to(end_dir, base_dir, dirs[0])
    phase_first = hg_phase(dot(view_dir, first_dir), g)

    seg_starts, seg_dirs, seg_lens = [], [], []
    for i in range(max_vertices):
        rs = _rotate_to(end_dir, base_dir, rel_starts[i])
        seg_starts.append(Vec3(x.x + rs.x * scale, x.y + rs.y * scale,
                               x.z + rs.z * scale))
        seg_dirs.append(_rotate_to(end_dir, base_dir, dirs[i]))
        seg_lens.append(lens[i] * scale)
    return (first_dir, seg_starts, seg_dirs, seg_lens, w_over_pdf,
            phase_first, m)
