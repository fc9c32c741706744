"""Simulated differential-drive rover + sensor (port of
``fitslam_tpu/models/sim_robot.py``; a test and bench fixture): a kinematic
unicycle stepped by (v, omega) commands, a range-limited reveal sensor that
marks ground-truth occupancy into an explored map, and the rooms world.
The robot and the world are host numpy, identical to the reference.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from fitslam_tpu_torch.ops.grid import LETHAL, UNKNOWN, GridSpec2D
from fitslam_tpu_torch.ops.raycast import _steps, ray_fan


class DiffDriveRobot:
    """Kinematic unicycle. Positions in world meters; yaw in radians."""

    def __init__(self, x=0.0, y=0.0, yaw=0.0, v_max=0.6, w_max=1.2):
        self.x, self.y, self.yaw = float(x), float(y), float(yaw)
        self.v_max, self.w_max = v_max, w_max
        self.trajectory = [(self.x, self.y, self.yaw)]
        # last executed twist (after clipping) — what a wheel encoder would
        # integrate; the EKF layer's odometry source
        self.last_twist: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    @property
    def xy(self) -> np.ndarray:
        return np.array([self.x, self.y])

    def step(self, v: float, omega: float, dt: float):
        v = float(np.clip(v, -self.v_max, self.v_max))
        omega = float(np.clip(omega, -self.w_max, self.w_max))
        self.x += v * math.cos(self.yaw) * dt
        self.y += v * math.sin(self.yaw) * dt
        self.yaw = (self.yaw + omega * dt + math.pi) % (2 * math.pi) - math.pi
        self.trajectory.append((self.x, self.y, self.yaw))
        self.last_twist = (v, omega, dt)


def reveal_sensor(
    spec: GridSpec2D,
    gt_occ: torch.Tensor,         # (G, G) ground-truth occupancy {FREE, LETHAL}
    explored: torch.Tensor,       # (G, G) uint8 current explored map (UNKNOWN where unseen)
    robot_xy: torch.Tensor,       # (2,)
    range_m: float = 4.0,
    n_rays: int = 128,
    n_steps: int = 24,
) -> torch.Tensor:
    """Raycast reveal: cells along each ray become known (copied from the
    ground truth) until a wall blocks the ray; the wall cell itself is
    revealed as lethal. Returns the updated explored map (a new tensor)."""
    G = spec.size
    n = G * G
    dev = explored.device
    _, dirs = ray_fan(n_rays, dev)
    ts = _steps(n_steps, 1.0, range_m / n_steps, dev)
    pos = robot_xy[None, None, :] + dirs[:, None, :] * ts[None, :, None]   # (R, S, 2)
    cell, inb = spec.world_to_cell(pos)
    flat = torch.where(inb, cell[..., 1] * G + cell[..., 0], n).long()
    gt = torch.where(inb, gt_occ.reshape(-1)[torch.clamp(flat, max=n - 1)],
                     torch.full_like(flat, LETHAL, dtype=torch.uint8))

    lethal = ((gt != UNKNOWN) & (gt >= LETHAL)).to(torch.int32)
    blocked_before = (torch.cumsum(lethal, dim=-1) - lethal) > 0
    visible = ~blocked_before & inb

    # scatter into n + 1 cells: slot n collects what the reference drops
    tgt = torch.where(visible, flat, n).reshape(-1)
    upd = torch.where(visible, gt, torch.zeros_like(gt)).reshape(-1).to(torch.int32)
    seen = torch.zeros(n + 1, dtype=torch.bool, device=dev).index_fill_(0, tgt, True)
    vals = torch.zeros(n + 1, dtype=torch.int32, device=dev).scatter_reduce_(
        0, tgt, upd, "amax")
    out = torch.where(seen[:n], vals[:n].to(torch.uint8), explored.reshape(-1))

    # robot's own cell is always revealed free
    rc, r_ok = spec.world_to_cell(robot_xy)
    out = torch.cat([out, out.new_zeros(1)])
    out.index_fill_(0, torch.where(r_ok, rc[1] * G + rc[0], n).long().reshape(1), 0)
    return out[:n].reshape(G, G)


def make_rooms_world(spec: GridSpec2D, seed: int = 0) -> np.ndarray:
    """Ground-truth occupancy: bordered arena with a few walls + doorways."""
    G = spec.size
    occ = np.zeros((G, G), np.uint8)
    occ[:2, :] = LETHAL
    occ[-2:, :] = LETHAL
    occ[:, :2] = LETHAL
    occ[:, -2:] = LETHAL
    rng = np.random.RandomState(seed)
    # vertical wall with a door
    for frac in (0.35, 0.65):
        col = int(G * frac)
        occ[:, col] = LETHAL
        door = rng.randint(G // 5, G - G // 5)
        occ[max(0, door - 4): door + 4, col] = 0
    # horizontal wall with a door
    row = int(G * 0.5)
    occ[row, : int(G * 0.35)] = LETHAL
    door = rng.randint(4, int(G * 0.3))
    occ[row, max(0, door - 4): door + 4] = 0
    return occ
