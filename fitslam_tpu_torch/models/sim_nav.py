"""Simulated navigation stack: the Nav2-equivalent seam closed in-process
(port of ``fitslam_tpu/models/sim_nav.py``).

Implements the NavInterface boundary against the simulated rover: wavefront
potential planning (K3) at the configured replan rate, regulated
pure-pursuit control, goal state machine {ACTIVE, DONE, ABORTED} matching
Nav2Interface's states. The host reads back once per plan (the path and its
mask, packed) and once per map update (the local costmap's mirror), counted
in ``host_syncs``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from fitslam_tpu_torch.models import nav as navx
from fitslam_tpu_torch.models.exploration import GoalStatus, NavInterface
from fitslam_tpu_torch.models.sim_robot import DiffDriveRobot
from fitslam_tpu_torch.ops.grid import GridSpec2D
from fitslam_tpu_torch.utils.config import FitSlamConfig
from fitslam_tpu_torch.utils.transfer import upload


class SimNavInterface(NavInterface):
    def __init__(self, cfg: FitSlamConfig, spec: GridSpec2D, robot: DiffDriveRobot,
                 get_occupancy: Callable[[], torch.Tensor], dt: float = 0.1,
                 get_overlay: Optional[Callable[[], torch.Tensor]] = None,
                 twist_mux=None, device="cuda"):
        self.cfg = cfg
        self.spec = spec
        self.robot = robot
        self.get_occupancy = get_occupancy
        self.dt = dt
        self.device = torch.device(device)
        # the reference's two nav2 costmap instances (N4): the planner plans
        # on the global costmap (inflation 5.0 + LethalMarker + lethal
        # inflation); the controller collision-checks against the rolling
        # local costmap (10x10 m, inflation 0.6)
        self.global_costmap = navx.Costmap(
            spec, cfg.costmaps.global_map, get_occupancy, get_overlay)
        self.local_costmap = navx.Costmap(
            spec, cfg.costmaps.local, get_occupancy, get_overlay)
        # optional command multiplexer (twist_mux.yaml, N5): every commanded
        # twist is pushed as the "navigation" source
        self.twist_mux = twist_mux
        # wheel-odometry seam: called with the EXECUTED (clipped) twist after
        # every base step
        self.on_cmd: Optional[Callable[[float, float, float], None]] = None
        self.controller = navx.PurePursuit(
            desired_speed=cfg.nav.desired_speed,
            lookahead=cfg.nav.lookahead_m,
            rotate_to_heading=cfg.nav.rotate_to_heading,
        )
        self._goal: Optional[np.ndarray] = None
        self._goal_heading = 0.0
        self._status = GoalStatus.NONE
        self._path: Optional[np.ndarray] = None
        self._ext_path: Optional[np.ndarray] = None
        self._stuck_steps = 0
        self._replan_countdown = 0
        self.plans = 0               # wavefront plans made so far

    @property
    def host_syncs(self) -> int:
        """Device->host reads so far: one per plan, plus the costmaps'
        mirror updates."""
        return self.plans + self.global_costmap.host_syncs + self.local_costmap.host_syncs

    # -- NavInterface --

    def send_goal(self, goal_xy, heading: float):
        self._goal = np.asarray(goal_xy, np.float64)
        self._goal_heading = float(heading)
        self._status = GoalStatus.ACTIVE
        self._path = None
        self._stuck_steps = 0
        self._replan_countdown = 0

    def cancel(self):
        self._goal = None
        self._path = None
        self._ext_path = None
        self._status = GoalStatus.NONE

    def set_path(self, path_xy: np.ndarray):
        """Receive the exploration-published refined plan. Tracked directly
        when cfg.nav.planner == "roadmap" (E16)."""
        self._ext_path = np.asarray(path_xy, np.float64)

    def status(self) -> GoalStatus:
        return self._status

    def drive_open_loop(self, v: float, omega: float, source: str = "navigation"):
        self._apply_cmd(v, omega, source)

    def _apply_cmd(self, v: float, omega: float, source: str = "navigation"):
        """Route a commanded twist through the mux (when present) before it
        reaches the base."""
        if self.twist_mux is not None:
            self.twist_mux.push(source, v, omega)
            v, omega = self.twist_mux.output()
        self.robot.step(v, omega, self.dt)
        if self.on_cmd is not None:
            self.on_cmd(*self.robot.last_twist)

    def _local_blocked(self) -> bool:
        """Collision check a short segment ahead against the local costmap,
        probing its cached numpy mirror (one read per map UPDATE)."""
        occ_l, spec_l = self.local_costmap.grid_full_np()
        probe = self.robot.xy + 0.4 * np.array(
            [math.cos(self.robot.yaw), math.sin(self.robot.yaw)])
        cx = int(math.floor((probe[0] - spec_l.origin_x) / spec_l.resolution))
        cy = int(math.floor((probe[1] - spec_l.origin_y) / spec_l.resolution))
        if not (0 <= cx < spec_l.size and 0 <= cy < spec_l.size):
            return False
        c = int(occ_l[cy, cx])
        return c >= navx.LETHAL and c != navx.UNKNOWN

    # -- control loop (called at controller rate by the simulation) --

    def step(self):
        if self._status != GoalStatus.ACTIVE or self._goal is None:
            return
        occ, plan_spec = self.global_costmap.grid()
        if (self.cfg.nav.planner == "roadmap" and self._ext_path is not None
                and len(self._ext_path) >= 2):
            # roadmap-planner mode: follow the published exploration plan
            self._path = np.asarray(self._ext_path)
        elif self._path is None or self._replan_countdown <= 0:
            robot_dev = upload(np.asarray(self.robot.xy, np.float32), self.device)
            occ_plan = navx.clear_robot_footprint(plan_spec, occ, robot_dev)
            pot = navx.wavefront_potential(
                plan_spec, occ_plan, upload(np.asarray(self._goal, np.float32), self.device),
                iters=self.cfg.nav.wavefront_iters,
                allow_unknown=self.cfg.nav.allow_unknown,
            )
            path, ok = navx.descend_potential(plan_spec, pot, robot_dev)
            self.plans += 1
            # one packed pull for path + mask
            pk = torch.cat([path.reshape(-1), ok.to(torch.float32)]).cpu().numpy()
            n = path.shape[0]
            pts = pk[:2 * n].reshape(n, 2)[pk[2 * n:] > 0.5]
            if len(pts) == 0:
                # maybe we're already basically there
                if np.linalg.norm(self.robot.xy - self._goal) < self.cfg.nav.planner_tolerance_m:
                    self._status = GoalStatus.DONE
                else:
                    self._status = GoalStatus.ABORTED
                return
            self._path = pts
            self._replan_countdown = max(
                1, int(self.cfg.nav.replan_rate_hz and
                       (1.0 / self.cfg.nav.replan_rate_hz) / self.dt)
            )
        self._replan_countdown -= 1
        if self._path is None:
            return  # roadmap mode, no plan published yet

        v, w, reached = self.controller.command(self.robot.xy, self.robot.yaw, self._path)
        if reached or np.linalg.norm(self.robot.xy - self._goal) < self.cfg.nav.planner_tolerance_m:
            # the goal is a POSE: rotate to the commanded arrival heading
            # before reporting success (Nav2 navigate_to_pose semantics)
            if self.cfg.nav.rotate_to_heading:
                dyaw = (self._goal_heading - self.robot.yaw + math.pi) % (2 * math.pi) - math.pi
                if abs(dyaw) > 0.15:
                    w_cap = getattr(self.controller, "max_omega", 1.0)
                    w_cmd = math.copysign(min(w_cap, abs(dyaw) / self.dt), dyaw)
                    self._apply_cmd(0.0, w_cmd)
                    return
            self._status = GoalStatus.DONE
            return
        # local-costmap collision gate: a lethal cell dead ahead (marked
        # after the plan was drawn) stops forward motion and forces a replan
        if v > 0.0 and self._local_blocked():
            self._path = None
            self._replan_countdown = 0
            self._stuck_steps += 1
            if self._stuck_steps > 50:
                self._status = GoalStatus.ABORTED
            return
        before = self.robot.xy.copy()
        self._apply_cmd(v, w)
        if np.linalg.norm(self.robot.xy - before) < 1e-4 and abs(w) < 1e-3:
            self._stuck_steps += 1
            if self._stuck_steps > 50:
                self._status = GoalStatus.ABORTED
        else:
            self._stuck_steps = 0
