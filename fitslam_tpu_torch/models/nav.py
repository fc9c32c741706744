"""Navigation layer: grid planner, controller, costmap services (port of
``fitslam_tpu/models/nav.py``).

- NavFn planner: a wavefront potential computed by iterated min-plus
  relaxation sweeps (K3, ``ops/pallas_grid.py``); path extraction follows
  the potential downhill.
- RegulatedPurePursuitController: host-side math producing (v, omega).
- LethalMarker costmap layer: FOV wedges and discs OR-ed into a persistent
  overlay grid, aged wedges that expire.
- ``Costmap``: one nav2 costmap instance (static source + inflation layers).

Every grid function takes its tensors on the caller's device and reads
nothing back; ``Costmap.grid_full_np`` is the one host read (per map
update), counted in ``Costmap.host_syncs``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from fitslam_tpu_torch.ops import grid as gridops
from fitslam_tpu_torch.ops.grid import LETHAL, UNKNOWN, GridSpec2D, cell_centres
from fitslam_tpu_torch.ops.pallas_grid import BIG, wavefront_sweeps
from fitslam_tpu_torch.utils.transfer import upload

# descent moves as (dy, dx) and the extra cost of a diagonal step, per device
_moves: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def wavefront_potential(
    spec: GridSpec2D,
    occ: torch.Tensor,            # (G, G) occupancy
    goal_xy: torch.Tensor,        # (2,) world
    iters: int = 256,
    allow_unknown: bool = True,
    unknown_penalty: float = 2.0,
    cost_weight: float = 0.02,
) -> torch.Tensor:
    """Min-plus relaxation potential field from the goal (NavFn equivalent).

    Each sweep relaxes all cells against their 4-neighbors; `iters` bounds
    the path length in cells. Returns (G, G) potential (BIG = unreachable).
    The sweeps run in K3 on a CUDA grid, whatever its size (the reference's
    VMEM size gate has no counterpart on the GPU), and in K3's plain twin on
    a CPU grid.
    """
    G = spec.size
    occ_i = occ.to(torch.int32)
    lethal = (occ_i != UNKNOWN) & (occ_i >= LETHAL)
    unknown = occ_i == UNKNOWN
    passable = ~lethal & (allow_unknown | ~unknown)

    # per-cell traversal cost: resolution * (1 + w * cost) (+ unknown penalty)
    base = spec.resolution * (
        1.0 + cost_weight * torch.where(unknown, 0, occ_i).to(torch.float32)
    )
    step_cost = torch.where(unknown, base * unknown_penalty, base)
    step_cost = torch.where(passable, step_cost, BIG)

    cell, _ = spec.world_to_cell(goal_xy)
    goal_flat = torch.clamp(cell[1] * G + cell[0], 0, G * G - 1)
    pot0 = torch.full((G * G,), BIG, dtype=torch.float32, device=occ.device)
    pot0.index_fill_(0, goal_flat.reshape(1).long(), 0.0)
    return wavefront_sweeps(pot0.reshape(G, G), step_cost, passable, iters)


def _descent_moves(resolution: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (resolution, str(device))
    if key not in _moves:
        offs = np.array(
            [(0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1)], np.int64)
        # diagonal steps travel sqrt(2) cells: charge the extra (sqrt2 - 1) * res
        diag = np.where(np.abs(offs).sum(1) == 2,
                        np.float32((math.sqrt(2.0) - 1.0) * resolution), np.float32(0.0))
        _moves[key] = (upload(offs, device), upload(diag, device))
    return _moves[key]


def descend_potential(
    spec: GridSpec2D,
    pot: torch.Tensor,
    start_xy: torch.Tensor,
    max_steps: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Follow the potential downhill (8-connected) from start to the goal.

    Returns (path (max_steps, 2) world coords, valid (max_steps,) bool).

    The reference scans ``max_steps`` times: from cell c (not yet done) it
    moves to the lowest of its 8 neighbours (diagonals charged the extra
    (sqrt2 - 1) * res, first index on ties) if that is below pot[c], and is
    done from then on once no neighbour improves or pot[c] <= 1e-6. A step
    depends only on (cell, done), so here the step is one table over all
    2 G^2 states, and the ``max_steps`` states of the walk are read off its
    powers by repeated squaring: the same path, in about 50 device
    operations instead of a sequential loop of thousands, and no host read.
    The start cell is clamped into the grid.
    """
    G = spec.size
    n = G * G
    dev = pot.device
    offs, diag_extra = _descent_moves(spec.resolution, dev)
    flat_pot = pot.reshape(-1)

    # one step from every cell that is not done yet
    idx = torch.arange(n, device=dev)
    rc = torch.stack([idx // G, idx % G], dim=-1)                    # (n, 2)
    cand = torch.clamp(rc[:, None, :] + offs[None], 0, G - 1)        # (n, 8, 2)
    cand_flat = cand[..., 0] * G + cand[..., 1]                      # (n, 8)
    vals = flat_pot[cand_flat] + diag_extra
    best = torch.argmin(vals, dim=1, keepdim=True)
    improve = torch.gather(vals, 1, best)[:, 0] < flat_pot
    nxt = torch.where(improve, torch.gather(cand_flat, 1, best)[:, 0], idx)
    stop = ~improve | (flat_pot <= 1e-6)
    # state s = cell + n * done; a done state stays where it is
    table = torch.cat([nxt + n * stop.long(), idx + n])

    cell, _ = spec.world_to_cell(start_xy)
    start = torch.clamp(cell[1], 0, G - 1).long() * G + torch.clamp(cell[0], 0, G - 1).long()
    k = torch.arange(1, max_steps + 1, device=dev)
    state = start.expand(max_steps).clone()
    power = table
    for j in range(max(1, max_steps.bit_length())):
        state = torch.where(((k >> j) & 1).bool(), power[state], state)
        power = power[power]
    cells = state % n
    xy = spec.cell_to_world(torch.stack([cells % G, cells // G], dim=-1))
    return xy, state < n


class PurePursuit:
    """Regulated pure-pursuit controller (host-side; N3 capability)."""

    def __init__(self, desired_speed=0.5, lookahead=0.6, max_omega=1.0,
                 rotate_to_heading=True, heading_tolerance=0.6,
                 regulate_radius=0.6):
        self.v = desired_speed
        self.lookahead = lookahead
        self.max_omega = max_omega
        self.rotate_to_heading = rotate_to_heading
        self.heading_tol = heading_tolerance
        self.regulate_radius = regulate_radius

    def command(self, pose_xy, yaw, path_xy: np.ndarray) -> Tuple[float, float, bool]:
        """Returns (v, omega, reached). path_xy: (W, 2) world waypoints."""
        if len(path_xy) == 0:
            return 0.0, 0.0, True
        p = np.asarray(pose_xy, np.float64)
        d = np.linalg.norm(path_xy - p, axis=1)
        goal_d = d[-1]
        if goal_d < 0.25:
            return 0.0, 0.0, True
        # lookahead point: first waypoint beyond lookahead distance
        beyond = np.nonzero(d >= self.lookahead)[0]
        target = path_xy[beyond[0]] if len(beyond) else path_xy[-1]
        dx, dy = target - p
        heading_err = math.atan2(dy, dx) - yaw
        heading_err = (heading_err + math.pi) % (2 * math.pi) - math.pi
        if self.rotate_to_heading and abs(heading_err) > self.heading_tol:
            return 0.0, float(np.clip(2.0 * heading_err, -self.max_omega, self.max_omega)), False
        # regulated speed: slow near the goal and in tight turns
        v = self.v * min(1.0, goal_d / self.regulate_radius)
        curvature = 2.0 * math.sin(heading_err) / max(self.lookahead, 1e-3)
        omega = float(np.clip(v * curvature, -self.max_omega, self.max_omega))
        return float(v), omega, False


# ---------------------------------------------------------------------------
# LethalMarker overlay (E15)
# ---------------------------------------------------------------------------


def _wedge(spec: GridSpec2D, apex_xy: torch.Tensor, yaw,
           apex_angle_rad: float, height_m: float) -> torch.Tensor:
    """(G, G) bool: cell centres inside the isosceles FOV wedge."""
    wx, wy = cell_centres(spec, apex_xy.device)
    dx = wx - apex_xy[0]
    dy = wy - apex_xy[1]
    r = torch.sqrt(dx * dx + dy * dy)
    ang = torch.atan2(dy, dx) - yaw
    ang = torch.remainder(ang + math.pi, 2 * math.pi) - math.pi
    return (r <= height_m) & (ang.abs() <= apex_angle_rad / 2.0)


def mark_lethal_wedge(
    spec: GridSpec2D,
    overlay: torch.Tensor,        # (G, G) bool persistent lethal overlay
    apex_xy: torch.Tensor,        # (2,) world — wedge apex (robot position)
    yaw,                          # () heading of the wedge axis
    apex_angle_rad: float = 0.7854,   # 45 deg
    height_m: float = 3.5,
) -> torch.Tensor:
    """OR an isosceles-triangle FOV wedge into the overlay
    (keepout_layer.cpp:74-126 mark_lethal_zone service)."""
    return overlay | _wedge(spec, apex_xy, yaw, apex_angle_rad, height_m)


def mark_lethal_discs(
    spec: GridSpec2D,
    overlay: torch.Tensor,        # (G, G) bool persistent lethal overlay
    circles: torch.Tensor,        # (K, 3) world (x, y, radius); (1e9,1e9,0) pad
) -> torch.Tensor:
    """OR a batch of world-frame discs into the persistent lethal overlay
    (blacklist circles evicted from the fixed-capacity buffer stay excluded
    through the overlay). Padding rows at 1e9 never match any cell."""
    wx, wy = cell_centres(spec, overlay.device)
    d2 = ((wx[None] - circles[:, 0, None, None]) ** 2
          + (wy[None] - circles[:, 1, None, None]) ** 2)
    inside = (d2 <= circles[:, 2, None, None] ** 2).any(dim=0)
    return overlay | inside


def apply_overlay(occ: torch.Tensor, overlay: torch.Tensor) -> torch.Tensor:
    """Overlay lethal zones onto an occupancy grid (cost 253-equivalent)."""
    return torch.where(overlay, torch.full_like(occ, LETHAL), occ)


def mark_wedge_age(
    spec: GridSpec2D,
    age_map: torch.Tensor,        # (G, G) int32; -1 = unmarked, else mark tick
    apex_xy: torch.Tensor,
    yaw,
    tick: int,                    # current tick
    apex_angle_rad: float = 0.7854,
    height_m: float = 3.5,
) -> torch.Tensor:
    """Tick-stamped FOV wedge marking: cells inside the wedge get the current
    tick (re-marking refreshes the age). These FI-failure wedges EXPIRE and
    can be cleared by the ClearCostmap recovery rung."""
    inside = _wedge(spec, apex_xy, yaw, apex_angle_rad, height_m)
    return torch.where(inside, torch.full_like(age_map, int(tick)), age_map)


def clear_age_disc(spec: GridSpec2D, age_map: torch.Tensor,
                   center_xy: torch.Tensor, radius_m: float) -> torch.Tensor:
    """ClearCostmap-equivalent local clear: unmark aged wedge cells within
    `radius_m` of the robot (nav2 ClearEntireCostmap scoped to a window)."""
    wx, wy = cell_centres(spec, age_map.device)
    d2 = (wx - center_xy[0]) ** 2 + (wy - center_xy[1]) ** 2
    radius = torch.full((), radius_m, dtype=torch.float32, device=age_map.device)
    return torch.where(d2 <= radius * radius, torch.full_like(age_map, -1), age_map)


def age_overlay_active(age_map: torch.Tensor, tick: int, ttl_ticks: int) -> torch.Tensor:
    """(G, G) bool — aged wedge cells still in force. ttl <= 0 = no expiry."""
    marked = age_map >= 0
    if ttl_ticks <= 0:
        return marked
    return marked & ((tick - age_map) <= ttl_ticks)


def clear_robot_footprint(spec: GridSpec2D, occ: torch.Tensor,
                          robot_xy: torch.Tensor,
                          radius_m: float = 0.3) -> torch.Tensor:
    """Nav2 footprint semantics: the robot's own footprint is never lethal
    (a robot standing inside the inflation skirt could otherwise never plan
    out of its own cell)."""
    G = spec.size
    cell, _ = spec.world_to_cell(robot_xy)
    idx = torch.arange(G, device=occ.device, dtype=torch.int32)
    r_cells = radius_m / spec.resolution
    d2 = ((idx[:, None] - cell[1]) ** 2 + (idx[None, :] - cell[0]) ** 2).to(torch.float32)
    disc = d2 <= r_cells * r_cells
    return torch.where(disc, torch.zeros_like(occ), occ)


# ---------------------------------------------------------------------------
# Costmap instances (N4): static source + inflation layer stack
# ---------------------------------------------------------------------------


class Costmap:
    """One nav2-costmap-2d instance (SURVEY.md §2.4 N4): a static source
    (the thresholded traversability grid) composed with an inflation layer,
    an optional LethalMarker overlay (E15) with its own inflation pass, and
    optional rolling-window extraction.

    `grid(robot_xy)` returns (occ, spec): the cost grid and the (possibly
    rolling) spec it lives on. Layer outputs are memoized against the source
    tensor identity, so per-control-tick queries recompose nothing.
    """

    def __init__(self, spec: GridSpec2D, layer_cfg, get_static, get_overlay=None):
        self.spec = spec
        self.cfg = layer_cfg
        self.get_static = get_static
        self.get_overlay = get_overlay
        self._cache_key = None
        self._cache_val = None
        self._np_for = None
        self._np_val = None
        self.host_syncs = 0          # device->host reads (grid_full_np)

    def _compose(self, occ: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.lethal_marker and self.get_overlay is not None:
            overlay = self.get_overlay()
            if overlay is not None:
                occ = apply_overlay(occ, overlay)
                if cfg.lethal_inflation_radius_m > 0:
                    occ = gridops.inflate_grid(
                        occ, self.spec.resolution,
                        inflation_radius_m=cfg.lethal_inflation_radius_m,
                        cost_scaling_factor=cfg.cost_scaling_factor,
                        inscribed_radius_m=cfg.inscribed_radius_m,
                    )
        if cfg.inflation_radius_m > 0:
            occ = gridops.inflate_grid(
                occ, self.spec.resolution,
                inflation_radius_m=cfg.inflation_radius_m,
                cost_scaling_factor=cfg.cost_scaling_factor,
                inscribed_radius_m=cfg.inscribed_radius_m,
            )
        return occ

    def _ensure_cache(self):
        """Compose (and resample) the source unless it is the cached one.
        The key holds STRONG references to the source and overlay, so `is`
        cannot false-hit on a recycled id."""
        src = self.get_static()
        overlay = None if self.get_overlay is None else self.get_overlay()
        if (self._cache_key is not None and src is self._cache_key[0]
                and overlay is self._cache_key[1]):
            return
        occ = self._compose(src)
        spec = self.spec
        if self.cfg.resample > 1:
            occ = gridops.upsample_grid(occ, self.cfg.resample)
            spec = GridSpec2D(spec.size * self.cfg.resample,
                              spec.resolution / self.cfg.resample,
                              spec.origin_x, spec.origin_y)
        elif self.cfg.resample < -1:
            k = -self.cfg.resample
            occ = gridops.downsample_grid_max(occ, k)
            spec = GridSpec2D(spec.size // k, spec.resolution * k,
                              spec.origin_x, spec.origin_y)
        self._cache_key = (src, overlay)
        self._cache_val = (occ, spec)

    def grid(self, robot_xy=None) -> Tuple[torch.Tensor, GridSpec2D]:
        self._ensure_cache()
        occ, spec = self._cache_val
        if self.cfg.rolling:
            if robot_xy is None:
                raise ValueError("rolling costmap needs robot_xy")
            return gridops.rolling_window(spec, occ, robot_xy, self.cfg.size_m)
        return occ, spec

    def grid_full_np(self):
        """Host-side (numpy) mirror of the FULL composed grid (no rolling
        crop), cached against the same source identity as `grid`: point
        probes (the controller's collision gate) read this, one device pull
        per map UPDATE instead of one per control step."""
        self._ensure_cache()
        occ, spec = self._cache_val
        if self._np_for is not self._cache_key:
            self._np_val = occ.cpu().numpy()
            self._np_for = self._cache_key
            self.host_syncs += 1
        return self._np_val, spec
