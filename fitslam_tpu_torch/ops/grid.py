"""Traversability fusion and costmap layers on occupancy grids (port of
``fitslam_tpu/ops/grid.py``): the cost convention and the static grid
geometry; per-keyframe point clouds in a ring buffer fused into per-cell
statistics, slope / roughness / step classification and a thresholded
occupancy grid; the chamfer distance transform and nav2-style inflation,
rolling windows and resampling.

Costs follow the reference's 0..255 convention (255 unknown, >= 254 lethal).
Every grid function takes and returns tensors on the caller's device and
never reads a value back to the host.

Fusion gives the same cells on every run and on either device (ROADMAP
F16): the per-cell sums add each cell's points in their buffer order (a
stable sort by cell, then one sequential sum a cell), as the reference's
CPU scatter does, where CUDA's atomic scatter-add would add them in an order
that changes from run to run; and points are moved into the world with the
reference's own roundings (``transform_points``, ``inverse_pose``), in
float32 and float64 elementwise operations that round alike on both
devices.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fitslam_tpu_torch.ops import lie
from fitslam_tpu_torch.ops.numerics import div_const, fma32, sqrt32, true_div

UNKNOWN = 255
LETHAL = 254
INSCRIBED = 253     # nav2 INSCRIBED_INFLATED_OBSTACLE
FREE = 0


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


def transform_points(R: torch.Tensor, t: torch.Tensor, p: torch.Tensor,
                     fused_rows=(0, 1, 2)) -> torch.Tensor:
    """``R @ p + t`` for every point: R (..., 3, 3), t (..., 3), p (..., P, 3).

    The cell a point falls in depends on the last bit, so each output row is
    rounded as the reference's CPU compiler rounds it: a row in
    ``fused_rows`` as fma(R2, p2, fma(R1, p1, R0 * p0)), any other row as
    (R0 * p0 + R1 * p1) + R2 * p2; then t is added. (Its product of a pose
    and a point cloud fuses every row; its batched einsum over a cloud
    buffer fuses only the z row.)"""
    Rb, pb = R[..., None, :, :], p[..., None, :]
    prod = [Rb[..., k] * pb[..., k] for k in range(3)]
    plain = (prod[0] + prod[1]) + prod[2]
    fused = fma32(Rb[..., 2], pb[..., 2], fma32(Rb[..., 1], pb[..., 1], prod[0]))
    rows = [fused[..., i] if i in fused_rows else plain[..., i] for i in range(3)]
    return torch.stack(rows, dim=-1) + t[..., None, :]


def inverse_pose(T: lie.SE3) -> lie.SE3:
    """``lie.inverse`` with t' = -(R^T t) rounded as the reference's CPU
    compiler evaluates it (a chain of fused multiply-adds)."""
    Rt = T.R.transpose(-1, -2)
    t = T.t[..., None, :]
    acc = fma32(Rt[..., :, 2], t[..., 2], fma32(Rt[..., :, 1], t[..., 1], Rt[..., :, 0] * t[..., 0]))
    return lie.SE3(Rt, -acc)


def cell_centres(spec: GridSpec2D, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(G, G) world x and y of every cell centre (row = y, column = x)."""
    G = spec.size
    idx = torch.arange(G, device=device, dtype=torch.int32).to(torch.float32)
    wx = (idx[None, :] + 0.5) * spec.resolution + spec.origin_x
    wy = (idx[:, None] + 0.5) * spec.resolution + spec.origin_y
    return wx.expand(G, G), wy.expand(G, G)


# ---------------------------------------------------------------------------
# Traversability fusion (SURVEY.md §2.1 S5): cloud buffer -> cell stats -> grid
# ---------------------------------------------------------------------------


class CloudBuffer(NamedTuple):
    """Per-keyframe point clouds in keyframe camera frame (ring buffer)."""

    points: torch.Tensor       # (C, P, 3) float32, camera frame
    kf_idx: torch.Tensor       # (C,) int32 owning keyframe
    valid: torch.Tensor        # (C, P) bool
    cloud_valid: torch.Tensor  # (C,) bool
    n_clouds: torch.Tensor     # () int32


def empty_cloud_buffer(max_clouds: int, max_points: int, device="cuda") -> CloudBuffer:
    return CloudBuffer(
        points=torch.zeros((max_clouds, max_points, 3), dtype=torch.float32, device=device),
        kf_idx=torch.zeros((max_clouds,), dtype=torch.int32, device=device),
        valid=torch.zeros((max_clouds, max_points), dtype=torch.bool, device=device),
        cloud_valid=torch.zeros((max_clouds,), dtype=torch.bool, device=device),
        n_clouds=torch.zeros((), dtype=torch.int32, device=device),
    )


def add_cloud(buf: CloudBuffer, points_c: torch.Tensor, valid: torch.Tensor,
              kf_idx) -> CloudBuffer:
    """Append one keyframe cloud (camera frame); wraps when full. ``kf_idx``
    is a Python int or a device integer; the slot stays on the device."""
    C = buf.points.shape[0]
    dev = buf.points.device
    slot = torch.remainder(buf.n_clouds, C).reshape(1).long()
    kf = (kf_idx.reshape(1).to(torch.int32) if isinstance(kf_idx, torch.Tensor)
          else torch.full((1,), kf_idx, dtype=torch.int32, device=dev))
    return CloudBuffer(
        points=buf.points.index_copy(0, slot, points_c[None].to(torch.float32)),
        kf_idx=buf.kf_idx.index_copy(0, slot, kf),
        valid=buf.valid.index_copy(0, slot, valid[None]),
        cloud_valid=buf.cloud_valid.index_fill(0, slot, True),
        n_clouds=buf.n_clouds + 1,
    )


class TraversabilityGrid(NamedTuple):
    """Fused per-cell statistics + derived cost."""

    elevation: torch.Tensor   # (G, G) mean z
    z_min: torch.Tensor       # (G, G)
    z_max: torch.Tensor       # (G, G)
    roughness: torch.Tensor   # (G, G) z std dev
    slope: torch.Tensor       # (G, G) |grad elevation| (rise/run)
    count: torch.Tensor       # (G, G) int32 point count
    cost: torch.Tensor        # (G, G) uint8 0..255 (255 = unknown)


def cloud_points_world(buf: CloudBuffer, kf_T_cw: lie.SE3):
    """Transform every buffered cloud through its keyframe's CURRENT pose.
    Returns ((C*P, 3) world points, (C*P,) mask)."""
    C, P, _ = buf.points.shape
    idx = buf.kf_idx.long()
    T_wc = inverse_pose(lie.SE3(kf_T_cw.R[idx], kf_T_cw.t[idx]))   # (C,)
    pts_w = transform_points(T_wc.R, T_wc.t, buf.points, fused_rows=(2,)).reshape(C * P, 3)
    ok = (buf.valid & buf.cloud_valid[:, None]).reshape(C * P)
    return pts_w, ok


def empty_cell_stats(spec: GridSpec2D, device="cuda"):
    """Identity element of the cell-stats monoid (count/sum/sum2/max/min):
    running aggregates for INCREMENTAL fusion (see scatter_cloud_stats)."""
    n = spec.size * spec.size
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((n,), **f32), torch.zeros((n,), **f32), torch.zeros((n,), **f32),
            torch.full((n,), -math.inf, **f32), torch.full((n,), math.inf, **f32))


def merge_cell_stats(a, b):
    """Associative merge of two per-cell aggregates."""
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2],
            torch.maximum(a[3], b[3]), torch.minimum(a[4], b[4]))


def scatter_cloud_stats(spec: GridSpec2D, stats, points_c: torch.Tensor,
                        valid: torch.Tensor, T_cw_kf: lie.SE3):
    """Incremental fusion: scatter ONE keyframe cloud (camera frame) through
    its pose into the running per-cell aggregates (the reference's
    is_kf_optimization_enabled distinction, traversabilityParams.yaml:27-29:
    only a loop-closure pose correction re-stitches the whole buffer)."""
    T_wc = inverse_pose(T_cw_kf)
    pts_w = transform_points(T_wc.R, T_wc.t, points_c)
    return merge_cell_stats(stats, cell_stats(spec, pts_w, valid))


def cell_stats(spec: GridSpec2D, pts_w: torch.Tensor, ok: torch.Tensor):
    """Per-cell aggregates (count, sum z, sum z^2, max z, min z) of points
    (N, 3), flat over the (G, G) grid in row-major (y, x) order.

    The sums add each cell's points sequentially in their order in ``pts_w``
    (a stable sort by cell, then one sequential sum a cell), which is the
    reference's CPU scatter order and the same on every run of the card;
    max and min are exact in any order."""
    G = spec.size
    n = G * G
    cell, inb = spec.world_to_cell(pts_w[:, :2])
    ok = ok & inb
    flat = torch.where(ok, cell[:, 1].long() * G + cell[:, 0].long(), n)
    z = pts_w[:, 2]
    keys, order = torch.sort(flat, stable=True)
    # cell c's points are keys[offsets[c]:offsets[c + 1]]; the points outside
    # the grid sort last and fall in no segment
    offsets = torch.searchsorted(keys, torch.arange(n + 1, device=keys.device))
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    zz = torch.stack([ok.to(torch.float32), torch.where(ok, z, zero),
                      torch.where(ok, z * z, zero)], dim=1)[order]
    # (N, 3) data: one thread a segment and column, adding in order
    sums = torch.segment_reduce(zz, "sum", offsets=offsets, axis=0, unsafe=True,
                                initial=0.0)
    z_mx = torch.full((n + 1,), -math.inf, dtype=z.dtype, device=z.device).scatter_reduce_(
        0, flat, torch.where(ok, z, -math.inf), "amax")
    z_mn = torch.full((n + 1,), math.inf, dtype=z.dtype, device=z.device).scatter_reduce_(
        0, flat, torch.where(ok, z, math.inf), "amin")
    return sums[:, 0], sums[:, 1], sums[:, 2], z_mx[:n], z_mn[:n]


def stats_to_grid(
    spec: GridSpec2D,
    stats,
    max_slope: float = 0.7,
    ground_clearance: float = 0.17,
    robot_height: float = 1.5,
    security_distance: float = 0.6,
) -> TraversabilityGrid:
    """Derive slope/roughness/step classification + cost from fused per-cell
    aggregates (the non-associative tail of fuse_clouds).

    Slope is taken by central differences of the 3x3 min-pooled ground
    surface (z_min), not of the mean elevation, which would smear walls onto
    the floor cells beside them; shifts fill with zero and do not wrap."""
    G = spec.size
    cnt, s_z, s_z2, z_mx, z_mn = stats
    cnt = cnt.reshape(G, G)
    known = cnt > 0
    zero = torch.zeros((), dtype=torch.float32, device=cnt.device)
    denom = torch.clamp_min(cnt, 1.0)
    mean_z = torch.where(known, s_z.reshape(G, G) / denom, zero)
    # the reference's compiler contracts q - mean^2 into one fused multiply-add
    var_z = torch.where(known, fma32(-mean_z, mean_z, s_z2.reshape(G, G) / denom), zero)
    rough = sqrt32(torch.clamp_min(var_z, 0.0))
    z_max = torch.where(known, z_mx.reshape(G, G), zero)
    z_min = torch.where(known, z_mn.reshape(G, G), zero)

    # 3x3 count sum as shifted copies (exact for integers), 3x3 min-pool of
    # the ground surface as a max-pool of its negation (-inf padding)
    pc = padded(cnt, 0.0)
    cnt_pool = sum(neighbour(pc, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    z_for_min = torch.where(known, z_min, math.inf)
    z_ground = -F.max_pool2d(-z_for_min[None, None], 3, stride=1, padding=1)[0, 0]
    z_smooth = torch.where(cnt_pool > 0, z_ground, zero)
    known_s = cnt_pool > 0

    inv_2res = 1.0 / (2.0 * spec.resolution)
    pk, pz = padded(known_s, False), padded(z_smooth, 0.0)
    gx_ok = neighbour(pk, 0, 1) & neighbour(pk, 0, -1)
    gy_ok = neighbour(pk, 1, 0) & neighbour(pk, -1, 0)
    gx = torch.where(gx_ok, (neighbour(pz, 0, -1) - neighbour(pz, 0, 1)) * inv_2res, zero)
    gy = torch.where(gy_ok, (neighbour(pz, -1, 0) - neighbour(pz, 1, 0)) * inv_2res, zero)
    slope = sqrt32(fma32(gx, gx, gy * gy))

    # cost: reference-style traversability classification
    step = z_max - z_min
    slope_cost = torch.clamp(div_const(slope, max_slope), 0.0, 1.0)
    rough_cost = torch.clamp(div_const(rough, ground_clearance), 0.0, 1.0)
    step_cost = torch.clamp(div_const(step, robot_height), 0.0, 1.0)
    cost01 = torch.maximum(torch.maximum(slope_cost, rough_cost), step_cost)
    cost = torch.round(cost01 * 200.0)
    lethal = ((slope > max_slope) | (step > robot_height * 0.5)
              | (rough > 2 * ground_clearance))
    cost = torch.where(lethal, float(LETHAL), cost)

    # inflate lethal by security distance (max-pool with a square window)
    r_cells = max(1, int(round(security_distance / spec.resolution)))
    lethal_f = (cost >= LETHAL).to(torch.float32)
    inflated = F.max_pool2d(lethal_f[None, None], 2 * r_cells + 1, stride=1,
                            padding=r_cells)[0, 0]
    cost = torch.where((inflated > 0) & known, torch.clamp_min(cost, float(LETHAL)), cost)
    cost = torch.where(known, cost, float(UNKNOWN)).to(torch.uint8)

    return TraversabilityGrid(
        elevation=mean_z, z_min=z_min, z_max=z_max, roughness=rough, slope=slope,
        count=cnt.to(torch.int32), cost=cost,
    )


# the reference's jitted entry for the incremental path's tail
grid_from_stats = stats_to_grid


def buffer_cell_stats(spec: GridSpec2D, buf: CloudBuffer, kf_T_cw: lie.SE3):
    """Full re-stitch of the aggregates: every buffered cloud through its
    keyframe's CURRENT pose (used after loop corrections)."""
    pts_w, ok = cloud_points_world(buf, kf_T_cw)
    return cell_stats(spec, pts_w, ok)


def fuse_clouds(
    spec: GridSpec2D,
    buf: CloudBuffer,
    kf_T_cw: lie.SE3,             # (K,) all keyframe poses (current estimates)
    max_slope: float = 0.7,
    ground_clearance: float = 0.17,
    robot_height: float = 1.5,
    security_distance: float = 0.6,
    lethal_threshold: int = 55,
) -> TraversabilityGrid:
    """Fuse every buffered cloud through its keyframe's *current* pose:
    per-cell count / mean z / min-max z / variance, then slope stencils and
    the traversability cost. Calling it after a pose-graph update re-stitches
    the whole map. ``lethal_threshold`` is unused, as in the reference."""
    return stats_to_grid(spec, buffer_cell_stats(spec, buf, kf_T_cw), max_slope=max_slope,
                         ground_clearance=ground_clearance, robot_height=robot_height,
                         security_distance=security_distance)


def threshold_grid(grid: TraversabilityGrid, lethal_threshold: int = 55) -> torch.Tensor:
    """`traversability_threshold_node` equivalent
    (traversability_ros_params.yaml:18-24): tri-state occupancy
    {FREE=0, LETHAL=254, UNKNOWN=255} consumed by Nav2 + frontier search."""
    known = grid.cost != UNKNOWN
    occ = torch.where(grid.cost >= lethal_threshold, LETHAL, FREE)
    return torch.where(known, occ, UNKNOWN).to(torch.uint8)


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


def depth_image_to_cloud(K, depth_img: torch.Tensor, stride: int = 4,
                         max_depth: float = 14.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """RGB-D backprojection: depth image -> camera-frame cloud (fixed size),
    subsampled by ``stride`` to bound the point count."""
    H, W = depth_img.shape
    dev = depth_img.device
    v = torch.arange(0, H, stride, device=dev)
    u = torch.arange(0, W, stride, device=dev)
    uu, vv = torch.meshgrid(u, v, indexing="xy")
    d = depth_img[vv, uu]
    ok = (d > 0.1) & (d < max_depth)
    x = (uu.to(torch.float32) - K.cx) / K.fx * d
    y = (vv.to(torch.float32) - K.cy) / K.fy * d
    return torch.stack([x, y, d], dim=-1).reshape(-1, 3), ok.reshape(-1)
