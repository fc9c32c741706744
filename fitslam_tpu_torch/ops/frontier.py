"""Frontier detection and clustering as dense grid kernels (port of
``fitslam_tpu/ops/frontier.py``).

A frontier cell is an unknown cell with >= 1 free 4-neighbor and no lethal
neighbor, searched within a radius of the robot; clusters grow over the
8-neighborhood by iterated min-label propagation and split at
`max_frontier_cluster_size`; the goal point is the cluster cell closest to
its centroid. Cluster accounting is one stable sort + segmented reductions
over a fixed-capacity frontier-cell list, compacted without a host read.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from fitslam_tpu_torch.ops.grid import UNKNOWN, GridSpec2D, cell_centres, neighbour, padded
from fitslam_tpu_torch.utils.transfer import upload

_INF = 2**30


class Frontiers(NamedTuple):
    """Fixed-capacity frontier set (the Frontier data model, SURVEY.md §2.3 E4)."""

    uid: torch.Tensor          # (F,) int32 hash of goal cell
    goal_xy: torch.Tensor      # (F, 2) float32 world coords of goal point
    centroid_xy: torch.Tensor  # (F, 2) float32
    size: torch.Tensor         # (F,) int32 cells in cluster
    valid: torch.Tensor        # (F,) bool


N4 = ((1, 0), (-1, 0), (0, 1), (0, -1))
N8 = N4 + ((1, 1), (1, -1), (-1, 1), (-1, -1))


def frontier_mask(
    occ: torch.Tensor,            # (G, G) uint8 occupancy {0 free, 254 lethal, 255 unknown}
    robot_cell: torch.Tensor,     # (2,) int32 (x, y)
    radius_cells: float,          # search radius in cells (float32 value)
    lethal_threshold: int = 254,
) -> torch.Tensor:
    """Boolean frontier-cell mask within the search radius."""
    occ_i = occ.to(torch.int32)
    unknown = occ_i == UNKNOWN
    free = occ_i < lethal_threshold  # known and traversable
    known = occ_i != UNKNOWN
    lethal = known & (occ_i >= lethal_threshold)

    free4 = torch.zeros_like(unknown)
    p = padded(free & known, False)
    for dy, dx in N4:
        free4 = free4 | neighbour(p, dy, dx)
    lethal8 = torch.zeros_like(unknown)
    p = padded(lethal, False)
    for dy, dx in N8:
        lethal8 = lethal8 | neighbour(p, dy, dx)

    G = occ.shape[0]
    idx = torch.arange(G, device=occ.device, dtype=torch.int32)
    d2 = (idx[None, :] - robot_cell[0]) ** 2 + (idx[:, None] - robot_cell[1]) ** 2
    r = np.float32(radius_cells)
    within = d2.to(torch.float32) <= float(r * r)

    return unknown & free4 & ~lethal8 & within


def polygon_mask(spec: GridSpec2D, verts: torch.Tensor) -> torch.Tensor:
    """(G, G) bool mask of cells inside a world-frame polygon (even-odd rule
    at every cell centre at once; the exploration boundary of
    CostAssigner::updateBoundaryPolygon). verts: (V, 2) world, V >= 3."""
    px, py = cell_centres(spec, verts.device)
    a = verts                              # (V, 2) edge starts
    b = torch.roll(verts, -1, dims=0)      # (V, 2) edge ends
    ay, by = a[:, 1, None, None], b[:, 1, None, None]
    ax, bx = a[:, 0, None, None], b[:, 0, None, None]
    straddles = (ay > py[None]) != (by > py[None])
    dy = by - ay
    t = (py[None] - ay) / torch.where(dy.abs() < 1e-12, torch.full_like(dy, 1e-12), dy)
    # the reference's compiler contracts ax + t * (bx - ax) into one fused
    # multiply-add; float64 with one rounding to float32 gives its value
    x_cross = (ax.double() + t.double() * (bx - ax).double()).to(torch.float32)
    hits = straddles & (px[None] < x_cross)
    return (hits.to(torch.int32).sum(dim=0) % 2) == 1


def propagate_labels(mask: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """8-connected min-label propagation; labels are flat indices (INF off-mask).

    The 3x3 neighbourhood minimum is a max-pool of negated labels: labels
    (< G^2) and INF (2^30) are exact in float32, and the pool's -inf padding
    is the reference's INF edge fill.
    """
    G = mask.shape[0]
    flat = torch.arange(G * G, device=mask.device, dtype=torch.int32).reshape(G, G)
    lbl = torch.where(mask, flat, _INF).to(torch.float32)
    for _ in range(iters):
        m = -F.max_pool2d(-lbl[None, None], 3, stride=1, padding=1)[0, 0]
        lbl = torch.where(mask, m, float(_INF))
    return lbl.to(torch.int32)


def _segment(values: torch.Tensor, seg: torch.Tensor, nseg: int, reduce: str,
             init) -> torch.Tensor:
    """jax.ops.segment_{sum,min} over ``nseg`` segments: segment ids at or
    beyond ``nseg`` are dropped (collected in one extra slot)."""
    out = torch.full((nseg + 1,), init, dtype=values.dtype, device=values.device)
    seg = torch.clamp(seg, max=nseg).long()
    if reduce == "sum":
        out.scatter_add_(0, seg, values)
    else:
        out.scatter_reduce_(0, seg, values, reduce)
    return out[:nseg]


def extract_frontiers(
    spec: GridSpec2D,
    occ: torch.Tensor,
    robot_xy: torch.Tensor,       # (2,) world
    radius_m: float,
    max_cells: int = 4096,
    max_frontiers: int = 128,
    max_cluster_size: int = 20,
    min_cluster_size: int = 1,
    cc_iters: int = 64,
    boundary: torch.Tensor = None,   # optional (G, G) bool exploration boundary
) -> Frontiers:
    """Full frontier pipeline: mask -> clusters -> split -> goals."""
    G = spec.size
    n = G * G
    dev = occ.device
    robot_cell, _ = spec.world_to_cell(robot_xy)
    mask = frontier_mask(occ, robot_cell, np.float32(radius_m) / np.float32(spec.resolution))
    if boundary is not None:
        # clip to the boundary polygon (UpdateBoundaryPolygon, §2.3 E7)
        mask = mask & boundary
    lbl = propagate_labels(mask, cc_iters)

    # fixed-capacity frontier cell list: the first max_cells mask cells in
    # flat order (jnp.nonzero(size=..., fill_value=G*G)), compacted by a
    # prefix sum and a scatter instead of a host-synchronising nonzero
    flat_mask = mask.reshape(-1)
    pos = torch.cumsum(flat_mask.to(torch.int64), 0) - 1
    keep = flat_mask & (pos < max_cells)
    idx = torch.full((max_cells + 1,), n, dtype=torch.int64, device=dev)
    idx.scatter_(0, torch.where(keep, pos, max_cells),
                 torch.arange(n, device=dev))
    idx = idx[:max_cells]
    cell_ok = idx < n
    lbls = torch.where(cell_ok, lbl.reshape(-1)[torch.clamp(idx, max=n - 1)], _INF)

    # sort cells by label; stable sort keeps flat-index order within a label,
    # and invalid (INF) cells sink to the end
    order = torch.sort(lbls, stable=True).indices
    lbls_s = lbls[order]
    idx_s = idx[order]
    ok_s = cell_ok[order]

    # rank within cluster, split at max_cluster_size
    ar = torch.arange(max_cells, device=dev)
    new_cluster = torch.ones_like(ok_s)
    new_cluster[1:] = lbls_s[1:] != lbls_s[:-1]
    seg_start = torch.cummax(torch.where(new_cluster, ar, 0), 0).values
    rank = ar - seg_start
    sub_boundary = new_cluster | ((rank % max_cluster_size) == 0)
    slot = torch.cumsum(sub_boundary.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = torch.where(ok_s, slot, max_frontiers)  # invalid cells -> dropped bucket

    # per-slot stats via segment ops
    nseg = max_frontiers + 1
    slot_g = torch.clamp(slot, max=nseg - 1).long()   # a gather clamps, as in JAX
    xy_cells = torch.stack([idx_s % G, idx_s // G], dim=-1).to(torch.float32)
    ones = ok_s.to(torch.float32)
    size = _segment(ones, slot, nseg, "sum", 0.0)
    cx = _segment(xy_cells[:, 0] * ones, slot, nseg, "sum", 0.0)
    cy = _segment(xy_cells[:, 1] * ones, slot, nseg, "sum", 0.0)
    denom = torch.clamp_min(size, 1.0)
    centroid = torch.stack([cx / denom, cy / denom], dim=-1)   # (nseg, 2) cell coords

    # medoid goal: cluster cell closest to the centroid
    diff = xy_cells - centroid[slot_g]
    d2 = diff[:, 0] ** 2 + diff[:, 1] ** 2
    d2 = torch.where(ok_s, d2, float("inf"))
    best_d2 = _segment(d2, slot, nseg, "amin", float("inf"))
    is_best = ok_s & (d2 <= best_d2[slot_g] + 1e-6)
    # first best cell per slot wins (deterministic)
    first_best = _segment(torch.where(is_best, ar, max_cells), slot, nseg, "amin",
                          np.iinfo(np.int32).max)
    has_goal = first_best < max_cells
    goal_cell = xy_cells[torch.clamp(first_best, max=max_cells - 1)]

    size_i = size[:max_frontiers].to(torch.int32)
    valid = (size_i >= min_cluster_size) & has_goal[:max_frontiers] & (size_i > 0)
    goal_xy = spec.cell_to_world(goal_cell[:max_frontiers])
    centroid_xy = spec.cell_to_world(centroid[:max_frontiers])
    # uid = hash of goal cell (reference: Frontier.hpp:151-161 hash of x,y);
    # int32 products that wrap, as the reference's
    gc = goal_cell[:max_frontiers].to(torch.int32)
    uid = (gc[:, 0] * 73856093) ^ (gc[:, 1] * 19349663)
    return Frontiers(
        uid=torch.where(valid, uid, -1),
        goal_xy=torch.where(valid[:, None], goal_xy, 0.0),
        centroid_xy=torch.where(valid[:, None], centroid_xy, 0.0),
        size=torch.where(valid, size_i, 0),
        valid=valid,
    )


def extract_frontiers_all_cells(
    spec: GridSpec2D,
    occ: torch.Tensor,
    max_cells: int = 4096,
    max_frontiers: int = 128,
    max_cluster_size: int = 20,
    min_cluster_size: int = 1,
    cc_iters: int = 64,
) -> Frontiers:
    """Full-map frontier sweep with no BFS radius (offline analysis mode —
    reference FrontierSearchAllCells): the radius-limited pipeline run from
    the grid center with a radius covering every cell."""
    center = upload([spec.origin_x + spec.extent / 2.0, spec.origin_y + spec.extent / 2.0],
                    occ.device, torch.float32)
    return extract_frontiers(
        spec, occ, center, float(np.float32(spec.extent * 2.0)),
        max_cells=max_cells, max_frontiers=max_frontiers,
        max_cluster_size=max_cluster_size, min_cluster_size=min_cluster_size,
        cc_iters=cc_iters,
    )
