"""Plain reference of the traversability fusion: a keyframe's camera-frame
cloud moved into the world through the keyframe's pose and added to the
running per-cell statistics, and the thresholded grid those statistics
give.

Statistics, flat over the (G, G) grid in row-major (y, x) order: the count,
sum of z and sum of z^2 of the points in each cell, their largest and
smallest z. A point falls in the cell floor((x - origin) / resolution) on
each axis, and outside the grid in none.

The grid: a known cell has points. Its roughness is the standard deviation
of z; its step z_max - z_min. The ground of a cell is the least z_min over
its 3x3 neighbourhood of known cells, taken where that neighbourhood holds
any point (0 elsewhere); the slope is the length of the central differences
of the ground over 2 * resolution, along an axis only where both neighbours'
neighbourhoods hold points. Cost 0..200 is the largest of slope / max_slope,
roughness / ground_clearance and step / robot_height, each clipped to
[0, 1], times 200, rounded to even; lethal (254) where the slope passes
max_slope, the step half the robot's height or the roughness twice the
clearance. Lethal spreads over a square of round(security_distance /
resolution) cells (at least 1) each way to known cells. The thresholded
grid: 255 unknown, 254 where the cost reaches ``lethal_threshold``, else 0.
``dtype`` sets the precision of every step (float64 here; the control runs
it in bfloat16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

UNKNOWN, LETHAL = 255, 254


def cloud_stats(points_c, valid, R_cw, t_cw, size, res, ox, oy, dtype=torch.float64):
    """(count, sum z, sum z^2, max z, min z), each (size * size,) in
    ``dtype``, of the cloud ``points_c`` (P, 3) where ``valid``, seen from
    the camera-from-world pose (``R_cw``, ``t_cw``)."""
    p = points_c.to(dtype)
    R, t = R_cw.to(dtype), t_cw.to(dtype)
    w = (p - t) @ R                              # world = R^T (p - t)
    cx = torch.floor((w[:, 0] - ox) / res).long()
    cy = torch.floor((w[:, 1] - oy) / res).long()
    ok = valid & (cx >= 0) & (cx < size) & (cy >= 0) & (cy < size)
    flat = (cy * size + cx)[ok]
    z = w[ok, 2]
    n = size * size
    zero = torch.zeros((n,), dtype=dtype, device=p.device)
    cnt = zero.index_add(0, flat, torch.ones_like(z))
    s1 = zero.index_add(0, flat, z)
    s2 = zero.index_add(0, flat, z * z)
    mx = torch.full((n,), -float("inf"), dtype=dtype, device=p.device).scatter_reduce(
        0, flat, z, "amax")
    mn = torch.full((n,), float("inf"), dtype=dtype, device=p.device).scatter_reduce(
        0, flat, z, "amin")
    return cnt, s1, s2, mx, mn


def merged(a, b):
    """Two sets of statistics as one."""
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2], torch.maximum(a[3], b[3]),
            torch.minimum(a[4], b[4]))


def thresholded(stats, size, res, max_slope, ground_clearance, robot_height,
                security_distance, lethal_threshold, dtype=torch.float64):
    """The (size, size) uint8 thresholded grid of the statistics."""
    cnt, s1, s2, mx, mn = (s.to(dtype).reshape(size, size) for s in stats)
    known = cnt > 0
    zero = torch.zeros((), dtype=dtype, device=cnt.device)
    n = torch.clamp_min(cnt, 1.0)
    mean = torch.where(known, s1 / n, zero)
    rough = torch.sqrt(torch.clamp_min(torch.where(known, s2 / n - mean * mean, zero), 0.0))
    z_max = torch.where(known, mx, zero)
    z_min = torch.where(known, mn, zero)

    def around(a, fill):                          # the 3x3 neighbourhood, (9, G, G)
        p = F.pad(a[None, None].double(), (1, 1, 1, 1), value=fill)[0, 0]
        return torch.stack([p[1 + dy:1 + dy + size, 1 + dx:1 + dx + size]
                            for dy in (-1, 0, 1) for dx in (-1, 0, 1)]).to(a.dtype)

    has = around(cnt, 0.0).sum(0) > 0
    ground = torch.where(has, around(torch.where(known, z_min, float("inf")), float("inf"))
                         .min(0).values, zero)

    def shifted(a, dy, dx, fill):                 # out[i, j] = a[i - dy, j - dx]
        p = F.pad(a[None, None].double(), (1, 1, 1, 1), value=fill)[0, 0].to(a.dtype)
        return p[1 - dy:1 - dy + size, 1 - dx:1 - dx + size]

    hasf = has.to(dtype)
    gx_ok = (shifted(hasf, 0, 1, 0.0) > 0) & (shifted(hasf, 0, -1, 0.0) > 0)
    gy_ok = (shifted(hasf, 1, 0, 0.0) > 0) & (shifted(hasf, -1, 0, 0.0) > 0)
    gx = torch.where(gx_ok, (shifted(ground, 0, -1, 0.0) - shifted(ground, 0, 1, 0.0))
                     / (2 * res), zero)
    gy = torch.where(gy_ok, (shifted(ground, -1, 0, 0.0) - shifted(ground, 1, 0, 0.0))
                     / (2 * res), zero)
    slope = torch.sqrt(gx * gx + gy * gy)
    step = z_max - z_min
    cost01 = torch.maximum(torch.maximum(torch.clamp(slope / max_slope, 0.0, 1.0),
                                         torch.clamp(rough / ground_clearance, 0.0, 1.0)),
                           torch.clamp(step / robot_height, 0.0, 1.0))
    cost = torch.round(cost01.double() * 200.0)
    lethal = (slope > max_slope) | (step > robot_height * 0.5) | (rough > 2 * ground_clearance)
    cost = torch.where(lethal, float(LETHAL), cost)
    r = max(1, int(round(security_distance / res)))
    spread = F.max_pool2d((cost >= LETHAL).double()[None, None], 2 * r + 1, stride=1,
                          padding=r)[0, 0] > 0
    cost = torch.where(spread & known, torch.clamp_min(cost, float(LETHAL)), cost)
    occ = torch.where(cost >= lethal_threshold, LETHAL, 0)
    return torch.where(known, occ, UNKNOWN).to(torch.uint8)
