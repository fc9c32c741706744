"""Batched grid raycasting (port of ``fitslam_tpu/ops/raycast.py``).

Reference hot loops replaced here (SURVEY.md §2.3 E5, §3.2):
- FrontierCostCalculator::setArrivalInformationForFrontier: per frontier, a
  360° fan of rays counting unknown cells, box-filtered over the camera FOV
  to pick the best arrival heading. Here: one (F, R, S) gather + cumulative
  masks.
- FrontierRoadMap::isConnectable: straight-line obstacle/unknown test per
  candidate edge. Here: (E, S) segment sampling.

All rays are fixed-length with validity masks — no early exit.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from fitslam_tpu_torch.ops.grid import LETHAL, UNKNOWN, GridSpec2D
from fitslam_tpu_torch.ops.numerics import true_div

_fans: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _sample_occ(spec: GridSpec2D, occ: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Gather occupancy at world positions (..., 2); out-of-bounds -> LETHAL."""
    cell, ok = spec.world_to_cell(xy)
    G = spec.size
    flat = torch.clamp(cell[..., 1] * G + cell[..., 0], 0, G * G - 1)
    vals = occ.reshape(-1)[flat.long()]
    return torch.where(ok, vals, torch.full_like(vals, LETHAL))


def ray_fan(n_rays: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """((R,) angles, (R, 2) unit directions) of an even 360° fan, made once
    per device (float32, as the reference's ``arange * (2 pi / R)``)."""
    key = (n_rays, str(device))
    if key not in _fans:
        theta = torch.arange(n_rays, device=device, dtype=torch.int32).to(torch.float32) \
            * (2.0 * math.pi / n_rays)
        _fans[key] = (theta, torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1))
    return _fans[key]


def linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in float32, rounded as JAX rounds it
    (``start * (1 - s) + stop * s`` with ``s = i / (num - 1)``, the end point
    exact); ``torch.linspace`` rounds some interior points differently."""
    if num < 2:
        return torch.full((num,), start, dtype=torch.float32, device=device)
    div = num - 1
    s = true_div(torch.arange(div, device=device, dtype=torch.int32).to(torch.float32),
                 float(div))
    out = start * (1 - s) + stop * s
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32, device=device)])


def _steps(count: int, start: float, step: float, device) -> torch.Tensor:
    """(arange(count) + start) * step in float32."""
    return (torch.arange(count, device=device, dtype=torch.int32).to(torch.float32)
            + start) * step


def arrival_information(
    spec: GridSpec2D,
    occ: torch.Tensor,           # (G, G) occupancy
    points_xy: torch.Tensor,     # (F, 2) world positions (frontier goals)
    valid: torch.Tensor,         # (F,) bool
    depth_m: float = 2.0,
    n_rays: int = 64,
    n_steps: int = 16,
    fov_rad: float = 1.04,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """360° unknown-counting sweep per point, box-filtered over the camera FOV.

    Returns (best_heading (F,), information (F,)) — the count of unknown
    cells observable in the best FOV-wide arrival direction. Rays stop at
    lethal cells (cumulative block mask).
    """
    dev = points_xy.device
    theta, dirs = ray_fan(n_rays, dev)
    ts = _steps(n_steps, 1.0, depth_m / n_steps, dev)                 # (S,)
    pos = points_xy[:, None, None, :] + dirs[None, :, None, :] * ts[None, None, :, None]
    occ_s = _sample_occ(spec, occ, pos)                               # (F, R, S)

    # lethal (not unknown) blocks the ray from the NEXT step on; unknown cells
    # are what we count and do not block
    lethal = ((occ_s != UNKNOWN) & (occ_s >= LETHAL)).to(torch.int32)
    blocked_before = (torch.cumsum(lethal, dim=-1) - lethal) > 0
    visible_unknown = (occ_s == UNKNOWN) & ~blocked_before
    per_ray = visible_unknown.to(torch.float32).sum(dim=-1)           # (F, R)

    # circular box filter of width fov (in rays)
    w = max(1, int(round(fov_rad / (2.0 * math.pi / n_rays))))
    idx = (torch.arange(n_rays, device=dev)[:, None]
           + torch.arange(w, device=dev)[None, :] - w // 2) % n_rays
    fov_sum = per_ray[:, idx].sum(dim=-1)                              # (F, R)
    best = torch.argmax(fov_sum, dim=-1)
    info = torch.gather(fov_sum, 1, best[:, None])[:, 0]
    heading = theta[best]
    return torch.where(valid, heading, 0.0), torch.where(valid, info, 0.0)


def segment_clearance(
    spec: GridSpec2D,
    occ: torch.Tensor,
    a_xy: torch.Tensor,          # (E, 2)
    b_xy: torch.Tensor,          # (E, 2)
    n_steps: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Straight-segment obstacle test (roadmap isConnectable).

    Returns (hits_obstacle (E,) bool, unknown_fraction (E,) float).
    """
    ts = linspace(0.0, 1.0, n_steps, a_xy.device)[None, :, None]
    pos = a_xy[:, None, :] * (1 - ts) + b_xy[:, None, :] * ts      # (E, S, 2)
    occ_s = _sample_occ(spec, occ, pos)
    hit = ((occ_s != UNKNOWN) & (occ_s >= LETHAL)).any(dim=-1)
    unknown_frac = (occ_s == UNKNOWN).to(torch.float32).mean(dim=-1)
    return hit, unknown_frac


def free_distance(
    spec: GridSpec2D,
    occ: torch.Tensor,
    origin_xy: torch.Tensor,     # (2,)
    dirs: torch.Tensor,          # (D, 2) unit directions
    max_dist: float = 2.5,
    n_steps: int = 25,
) -> torch.Tensor:
    """Distance to the first blocking cell along each direction — the recovery
    controller's free-space probe (SURVEY.md §2.3 E14: cells < 253 or == 255
    count as free)."""
    ts = linspace(max_dist / n_steps, max_dist, n_steps, origin_xy.device)
    pos = origin_xy[None, None, :] + dirs[:, None, :] * ts[None, :, None]
    occ_s = _sample_occ(spec, occ, pos)
    blocking = (occ_s != UNKNOWN) & (occ_s >= 253)
    any_block = blocking.any(dim=-1)
    first = torch.argmax(blocking.to(torch.uint8), dim=-1)
    return torch.where(any_block, ts[first] - max_dist / n_steps,
                       torch.full_like(ts[first], max_dist))
