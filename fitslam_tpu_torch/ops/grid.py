"""Costmap layers on occupancy grids (the costmap part of
``fitslam_tpu/ops/grid.py``): the cost convention, the static grid geometry,
the chamfer distance transform and nav2-style inflation, rolling windows and
resampling. Cloud fusion (``CloudBuffer`` ... ``fuse_clouds``,
``threshold_grid``) belongs to the active-SLAM slice and is not here yet.

Costs follow the reference's 0..255 convention (255 unknown, >= 254 lethal).
Every grid function takes and returns tensors on the caller's device and
never reads a value back to the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

UNKNOWN = 255
LETHAL = 254
INSCRIBED = 253     # nav2 INSCRIBED_INFLATED_OBSTACLE
FREE = 0


def true_div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` rounded as IEEE division. On CUDA, PyTorch divides by a
    Python scalar as a product with its reciprocal, which can differ in the
    last bit; a device-side 0-d divisor keeps the reference's rounding (the
    cell index of ``world_to_cell`` depends on it)."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


class GridSpec2D(NamedTuple):
    """Static grid geometry: world <-> cell mapping (Python numbers only)."""

    size: int            # cells per side
    resolution: float    # m per cell
    origin_x: float      # world x of cell (0, 0) corner
    origin_y: float

    @property
    def extent(self) -> float:
        return self.size * self.resolution

    def world_to_cell(self, xy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(..., 2) float32 world -> ((..., 2) int32 cell, in-bounds mask)."""
        c = torch.stack([true_div(xy[..., 0] - self.origin_x, self.resolution),
                         true_div(xy[..., 1] - self.origin_y, self.resolution)], dim=-1)
        c = torch.floor(c).to(torch.int32)
        ok = ((c[..., 0] >= 0) & (c[..., 0] < self.size)
              & (c[..., 1] >= 0) & (c[..., 1] < self.size))
        return c, ok

    def cell_to_world(self, c: torch.Tensor) -> torch.Tensor:
        cf = c.to(torch.float32) + 0.5
        return torch.stack([cf[..., 0] * self.resolution + self.origin_x,
                            cf[..., 1] * self.resolution + self.origin_y], dim=-1)


def cell_centres(spec: GridSpec2D, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(G, G) world x and y of every cell centre (row = y, column = x)."""
    G = spec.size
    idx = torch.arange(G, device=device, dtype=torch.int32).to(torch.float32)
    wx = (idx[None, :] + 0.5) * spec.resolution + spec.origin_x
    wy = (idx[:, None] + 0.5) * spec.resolution + spec.origin_y
    return wx.expand(G, G), wy.expand(G, G)


# ---------------------------------------------------------------------------
# Costmap layers (SURVEY.md §2.4 N4): inflation, rolling windows, resampling
# ---------------------------------------------------------------------------

_BIG_D = 1e6
_SQRT2 = math.sqrt(2.0)


def padded(a: torch.Tensor, fill) -> torch.Tensor:
    """``a`` framed by one cell of ``fill`` on every side."""
    if a.dtype == torch.bool:
        return F.pad(a.to(torch.uint8), (1, 1, 1, 1), value=int(fill)).to(torch.bool)
    return F.pad(a, (1, 1, 1, 1), value=fill)


def neighbour(p: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """The reference's ``_shifted(a, dy, dx, fill)`` (a roll with edge fill,
    no wraparound: out[i, j] = a[i - dy, j - dx]) for |dy|, |dx| <= 1, as a
    view of ``p = padded(a, fill)``."""
    H, W = p.shape[0] - 2, p.shape[1] - 2
    return p[1 - dy: 1 - dy + H, 1 - dx: 1 - dx + W]


def distance_to_lethal(occ: torch.Tensor, resolution: float,
                       max_radius_m: float) -> torch.Tensor:
    """Chamfer distance transform to the nearest lethal cell, by iterated
    8-neighbor min-plus relaxation (axial step = res, diagonal = res*sqrt2).
    Exact to chamfer metric within `max_radius_m`; beyond it saturates."""
    occ_i = occ.to(torch.int32)
    lethal = (occ_i != UNKNOWN) & (occ_i >= LETHAL)
    d = torch.where(lethal, 0.0, _BIG_D).to(torch.float32)
    iters = max(1, int(math.ceil(max_radius_m / resolution)) + 1)
    diag = resolution * _SQRT2
    for _ in range(iters):
        p = padded(d, _BIG_D)
        ax = torch.minimum(
            torch.minimum(neighbour(p, 1, 0), neighbour(p, -1, 0)),
            torch.minimum(neighbour(p, 0, 1), neighbour(p, 0, -1)),
        ) + resolution
        dg = torch.minimum(
            torch.minimum(neighbour(p, 1, 1), neighbour(p, 1, -1)),
            torch.minimum(neighbour(p, -1, 1), neighbour(p, -1, -1)),
        ) + diag
        d = torch.minimum(d, torch.minimum(ax, dg))
    return d


def inflate_grid(
    occ: torch.Tensor,
    resolution: float,
    inflation_radius_m: float = 0.6,
    cost_scaling_factor: float = 0.6,
    inscribed_radius_m: float = 0.1,
) -> torch.Tensor:
    """nav2 InflationLayer equivalent (active_slam_nav2_params.yaml:129-136,
    160-163): cells within the robot's inscribed radius of a lethal cell get
    INSCRIBED (253); beyond that cost decays as
    252 * exp(-cost_scaling_factor * (d - inscribed_radius)) out to
    `inflation_radius_m`. Lethal and unknown cells are preserved."""
    occ_i = occ.to(torch.int32)
    lethal = (occ_i != UNKNOWN) & (occ_i >= LETHAL)
    unknown = occ_i == UNKNOWN
    d = distance_to_lethal(occ, resolution, inflation_radius_m)
    infl = torch.round(
        (INSCRIBED - 1.0)
        * torch.exp(-cost_scaling_factor * torch.clamp_min(d - inscribed_radius_m, 0.0))
    )
    infl = torch.where(d <= inscribed_radius_m, float(INSCRIBED), infl)
    infl = torch.where(d <= inflation_radius_m, infl, 0.0)
    out = torch.maximum(occ_i.to(torch.float32), infl)
    out = torch.where(lethal, float(LETHAL), out)
    out = torch.where(unknown, float(UNKNOWN), out)
    return out.to(torch.uint8)


def rolling_window(spec: GridSpec2D, occ: torch.Tensor, center_xy,
                   size_m: float) -> Tuple[torch.Tensor, GridSpec2D]:
    """Rolling local costmap extraction (nav2 local_costmap rolling_window:
    true, width/height 10 m): a size_m x size_m window of the global grid
    centered on the robot (host coordinates), clipped to bounds. Returns
    (local occ, local spec); the window origin is host math."""
    size_cells = max(1, int(round(size_m / spec.resolution)))
    size_cells = min(size_cells, spec.size)
    c = np.floor(
        (np.asarray(center_xy, np.float64)
         - np.array([spec.origin_x, spec.origin_y])) / spec.resolution
    ).astype(np.int64)
    row = int(np.clip(c[1] - size_cells // 2, 0, spec.size - size_cells))
    col = int(np.clip(c[0] - size_cells // 2, 0, spec.size - size_cells))
    local = occ[row: row + size_cells, col: col + size_cells]
    local_spec = GridSpec2D(
        size=size_cells,
        resolution=spec.resolution,
        origin_x=spec.origin_x + col * spec.resolution,
        origin_y=spec.origin_y + row * spec.resolution,
    )
    return local, local_spec


def upsample_grid(occ: torch.Tensor, factor: int) -> torch.Tensor:
    """Replicate cells (the reference's global costmap re-rasterizes the
    0.25 m traversability grid at 0.05 m — a 5x upsample)."""
    return occ.repeat_interleave(factor, dim=0).repeat_interleave(factor, dim=1)


def downsample_grid_max(occ: torch.Tensor, factor: int) -> torch.Tensor:
    """Conservative downsample: lethal wins over free, known wins over
    unknown (unknown only survives where the whole block is unknown)."""
    occ_i = occ.to(torch.int32)
    known_cost = torch.where(occ_i == UNKNOWN, -1, occ_i).to(torch.float32)
    pooled = F.max_pool2d(known_cost[None, None], factor, factor)[0, 0]
    return torch.where(pooled < 0, float(UNKNOWN), pooled).to(torch.uint8)
