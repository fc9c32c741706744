"""Exploration server: the behavior-tree tick loop as explicit control flow
(port of ``fitslam_tpu/models/exploration.py``; FrontierExplorationServer /
ExplorationBT):

- SearchForFrontiers with search-radius growth on failure
- UpdateFrontierRoadmap / CleanupRoadmap with loop-closure correction
- ProcessFrontierCosts (CostAssigner/FrontierCostsManager pipeline)
- OptimizeFullPath: TSP + Fisher-information safety ladder with retry,
  pose blacklisting, lethal-FOV marking and fi_drop oscillation detection
- HysterisisControl goal stickiness
- SendNav2Goal with timeout + failure-count blacklisting
- CheckIfGoalMapped replan trigger
- RecoveryMoveBack / ExecuteRecoveryMove
- pause/play control surface

The server talks to a `NavInterface` (goal in, status out) and reads
occupancy through a callback. Its device work stays on ``device``; the host
reads back at the reference's points only (one packed pull per tick, one for
the published path and one for its line-of-sight mask), each counted in
``host_syncs``. Host values go up with ``utils.transfer.upload``, which
never waits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from fitslam_tpu_torch.models import costs as cx
from fitslam_tpu_torch.models import nav as navx
from fitslam_tpu_torch.models import roadmap as rmx
from fitslam_tpu_torch.ops import fisher
from fitslam_tpu_torch.ops import frontier as fx
from fitslam_tpu_torch.ops import lie, raycast
from fitslam_tpu_torch.ops.grid import UNKNOWN, GridSpec2D
from fitslam_tpu_torch.utils import logging as logx
from fitslam_tpu_torch.utils import prng
from fitslam_tpu_torch.utils.config import FitSlamConfig
from fitslam_tpu_torch.utils.profiling import MODULE, EventLogger
from fitslam_tpu_torch.utils.transfer import upload


def _pack_tick_scalars(spec, occ, fr_valid, fr_goal_xy, best_heading,
                       has_goal, goal_idx, prev_goal, fi_value):
    """The tick's control-flow scalars in one (8,) float32 tensor, read back
    in ONE transfer. `fi_value` is the prefetched Fisher-information scalar
    for the FI gate (-1e30 when no device oracle is wired)."""
    # a 1-d index: indexing with a 0-d device tensor would read it back
    gi = torch.clamp_min(goal_idx, 0).long().reshape(1)
    prev_cell = raycast._sample_occ(spec, occ, prev_goal[None, :])
    f32 = torch.float32
    return torch.cat([
        fr_valid.sum().to(f32).reshape(1),
        has_goal.to(f32).reshape(1),
        gi.to(f32),
        fr_goal_xy[gi, 0],
        fr_goal_xy[gi, 1],
        best_heading[gi],
        prev_cell.to(f32),
        (fi_value.to(f32).reshape(1) if isinstance(fi_value, torch.Tensor)
         else torch.full((1,), fi_value, dtype=f32, device=occ.device)),
    ])


class GoalStatus(Enum):
    ACTIVE = 0     # reference Nav2Interface state 0
    DONE = 1
    ABORTED = -1
    NONE = 2


class NavInterface:
    """Abstract Nav2 boundary (SURVEY.md §2.3 E13). Implementations: the
    simulated rover driver (SimNavInterface) or an external bridge."""

    def send_goal(self, goal_xy, heading: float):  # pragma: no cover
        raise NotImplementedError

    def cancel(self):  # pragma: no cover
        raise NotImplementedError

    def status(self) -> GoalStatus:  # pragma: no cover
        raise NotImplementedError


class ExplorationState(Enum):
    PAUSED = 0
    EXPLORING = 1
    RECOVERING = 2
    DONE = 3
    FAILED = 4
    INITIALIZING = 5


class PathSafety(Enum):
    """PathSafetyStatus (FullPathOptimizer.hpp): SAFE / UNSAFE, or
    UNDETERMINED when no trailing pose FOV-overlaps the segment to check."""

    SAFE = 0
    UNSAFE = 1
    UNDETERMINED = 2


@dataclass
class ExplorationDiagnostics:
    ticks: int = 0
    frontiers_found: int = 0
    goals_sent: int = 0
    replans: int = 0
    fi_rejections: int = 0
    recoveries: int = 0
    blacklisted: int = 0
    loop_corrections: int = 0


class ExplorationServer:
    def __init__(
        self,
        cfg: FitSlamConfig,
        spec: GridSpec2D,
        get_occupancy: Callable[[], torch.Tensor],
        nav: NavInterface,
        get_robot_pose: Callable[[], Tuple[np.ndarray, float]],
        fi_oracle: Optional[Callable[[np.ndarray, float, bool], float]] = None,
        fi_oracle_device: Optional[Callable[[np.ndarray, float, bool],
                                            torch.Tensor]] = None,
        get_kf_poses: Optional[Callable[[], Tuple]] = None,
        event_logger: Optional[EventLogger] = None,
        peer_goals: Optional[Callable[[], List[np.ndarray]]] = None,
        get_landmarks: Optional[Callable[[], Tuple]] = None,
        device="cuda",
    ):
        self.cfg = cfg
        self.spec = spec
        self.device = torch.device(device)
        self.get_occupancy = get_occupancy
        self.nav = nav
        self.get_robot_pose = get_robot_pose
        self.fi_oracle = fi_oracle
        # device-value variant of the oracle: its scalar folds into the
        # tick's ONE packed pull instead of costing its own readback
        self.fi_oracle_device = fi_oracle_device
        self.get_kf_poses = get_kf_poses
        # landmark map accessor for fisher_information_in_path: () ->
        # (xy (L, 2), info (L,), valid (L,)), tensors or host arrays
        self.get_landmarks = get_landmarks
        # goal sharing with peer robots: peers' active goals are treated like
        # blacklist circles so two robots never chase the same frontier
        self.peer_goals = peer_goals
        self.log = event_logger or EventLogger(time_tier=MODULE)
        self.host_syncs = 0          # device->host reads so far

        rcfg = cfg.roadmap
        self.roadmap = rmx.empty_roadmap(rcfg.max_nodes, rcfg.max_edges_per_node, self.device)
        self.lethal_overlay = torch.zeros((spec.size, spec.size), dtype=torch.bool,
                                          device=self.device)
        # tick-stamped FI-failure wedges: EXPIRE after lethal_wedge_ttl_ticks
        # and are cleared by the ClearCostmap recovery rung, unlike the
        # durable blacklist-eviction overlay above
        self.wedge_age = torch.full((spec.size, spec.size), -1, dtype=torch.int32,
                                    device=self.device)
        # with no SLAM the roadmap is anchored to one identity keyframe
        self._identity_kf = (lie.SE3.identity((1,), device=self.device), 1)
        self._clear_failures = 0
        self.boundary_mask: Optional[torch.Tensor] = None  # E7 boundary polygon
        self.blacklist_xy: List[np.ndarray] = []     # blacklisted goal circles
        self.trailing_poses: List[np.ndarray] = []   # last N (x, y, yaw)
        self.state = ExplorationState.EXPLORING
        self.diag = ExplorationDiagnostics()

        self._search_radius = cfg.frontier_search.search_radius_m
        # InitializationSequence: bootstrap wiggle before the first goal
        # (forward leg then a full spin)
        bt = cfg.exploration_bt
        if bt.bootstrap_enabled:
            self.state = ExplorationState.INITIALIZING
            dt = max(bt.tick_dt_s, 1e-3)
            self._boot_fwd_ticks = max(1, int(bt.bootstrap_forward_s / dt))
            self._boot_spin_ticks = max(
                1, int(2.0 * math.pi / max(bt.bootstrap_spin_rate, 1e-3) / dt)
            )
        else:
            self._boot_fwd_ticks = self._boot_spin_ticks = 0
        self._goal_xy: Optional[np.ndarray] = None
        self._goal_heading = 0.0
        # published exploration plan (refineAndPublishPath equivalent)
        self.published_path: Optional[np.ndarray] = None
        self._bf_parent = None
        self._bf_src = None
        self._goal_sent_tick = -1
        self._goal_failures: Dict[Tuple[int, int], int] = {}
        self._last_cleanup = 0.0
        self._recovery_ticks_left = 0
        # FI retry ladder state (OptimizeFullPath BT node)
        self._fi_retries = 0
        self._fi_drop_count = 0
        self._fi_exhaustive_retry = False

    # ------------------------------------------------------------------
    # Control surface (RViz panel equivalent)
    # ------------------------------------------------------------------

    @property
    def current_goal(self) -> Optional[np.ndarray]:
        """Active goal for peers (SendCurrentGoal response equivalent)."""
        return self._goal_xy

    def pause(self):
        self.state = ExplorationState.PAUSED
        self.nav.cancel()

    def update_boundary_polygon(self, verts_xy) -> None:
        """Clip exploration to a world-frame polygon. Pass None (or < 3
        vertices) to clear the boundary."""
        verts = None if verts_xy is None else np.asarray(verts_xy, np.float32)
        if verts is None or len(verts) < 3:
            self.boundary_mask = None
            return
        self.boundary_mask = fx.polygon_mask(self.spec, upload(verts, self.device))

    def resume(self):
        if self.state == ExplorationState.PAUSED:
            self.state = ExplorationState.EXPLORING

    def _upload_xy(self, xy) -> torch.Tensor:
        return upload(np.asarray(xy, np.float32), self.device)

    def _on_device(self, x) -> torch.Tensor:
        """A tensor on this server's device; host arrays go up with
        ``upload``, which never waits."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return upload(np.asarray(x), self.device)

    def _read(self, t: torch.Tensor) -> np.ndarray:
        """One counted device->host read."""
        self.host_syncs += 1
        return t.cpu().numpy()

    # ------------------------------------------------------------------
    # Main tick
    # ------------------------------------------------------------------

    def tick(self) -> ExplorationState:
        """One BT-equivalent iteration."""
        self.diag.ticks += 1
        if self.state in (ExplorationState.PAUSED, ExplorationState.DONE,
                          ExplorationState.FAILED):
            return self.state

        robot_xy, robot_yaw = self.get_robot_pose()

        if self.state == ExplorationState.INITIALIZING:
            bt = self.cfg.exploration_bt
            if self._boot_fwd_ticks > 0:
                self._boot_fwd_ticks -= 1
                if hasattr(self.nav, "drive_open_loop"):
                    self.nav.drive_open_loop(bt.bootstrap_speed, 0.0)
            elif self._boot_spin_ticks > 0:
                self._boot_spin_ticks -= 1
                if hasattr(self.nav, "drive_open_loop"):
                    self.nav.drive_open_loop(0.0, bt.bootstrap_spin_rate)
            else:
                self.state = ExplorationState.EXPLORING
            return self.state

        occ = navx.apply_overlay(self.get_occupancy(), self._overlay())

        if self.state == ExplorationState.RECOVERING:
            return self._tick_recovery(occ, robot_xy, robot_yaw)
        if self.nav.status() == GoalStatus.DONE:
            self._clear_failures = 0   # progress: reset the ClearCostmap rung

        # an aborted goal must be consumed even when later stages produce no
        # plan this tick, or the server deadlocks on a dead goal
        if self.nav.status() == GoalStatus.ABORTED:
            if self._goal_xy is not None:
                self._on_goal_failure(self._goal_xy)
            else:
                self.nav.cancel()

        robot_dev = self._upload_xy(robot_xy)

        # -- roadmap upkeep --
        with self.log.scope("roadmap.update", MODULE):
            self._update_roadmap(occ, robot_xy, robot_yaw, robot_dev)

        # -- frontier search with radius growth (SearchForFrontiers) --
        with self.log.scope("frontier_search", MODULE):
            fr = self._search_frontiers(occ, robot_dev)

        # -- costs --
        with self.log.scope("frontier_costs", MODULE):
            robot_dist, parent, src = rmx.shortest_paths(self.roadmap, robot_dev)
            blacklisted = self._blacklist_mask(fr)
            pot = navx.wavefront_potential(
                self.spec,
                navx.clear_robot_footprint(self.spec, occ, robot_dev),
                robot_dev,
                iters=self.cfg.nav.wavefront_iters,
                allow_unknown=True,
            )
            # fisher_information_in_path per frontier (E4/E5): mean FOV
            # landmark information along each approach segment
            fcfg = self.cfg.fisher_information
            path_fi = None
            if (self.get_landmarks is not None and fcfg.enabled
                    and fcfg.min_path_information > 0.0):
                lm_xy, lm_info, lm_valid = (self._on_device(a) for a in self.get_landmarks())
                path_fi = fisher.path_information(
                    lm_xy.to(torch.float32), lm_info.to(torch.float32), lm_valid.to(torch.bool),
                    robot_dev, fr.goal_xy, fr.valid,
                    num_waypoints=fcfg.path_fi_waypoints,
                    fov_half_angle=fcfg.fov_half_angle,
                    max_range=fcfg.max_landmark_distance,
                )
            methods = tuple(self.cfg.cost_assigner.cost_calculation_methods)
            costs = cx.assign_costs(
                self.spec, occ, fr, self.roadmap.xy, self.roadmap.valid,
                robot_dist, blacklisted,
                methods=methods,
                rng_key=(prng.prng_key(self.diag.ticks)
                         if "RandomCosts" in methods else None),
                alpha=self.cfg.cost_assigner.alpha,
                beta=self.cfg.cost_assigner.beta,
                v_max=self.cfg.cost_assigner.max_linear_velocity,
                w_max=self.cfg.cost_assigner.max_angular_velocity,
                grid_pot=pot,
                path_fi=path_fi,
                min_path_info=fcfg.min_path_information,
                robot_xy=robot_dev,
                closeness_rejection=self.cfg.cost_calculator.closeness_rejection_m,
                factor_of_max_info=self.cfg.cost_calculator.factor_of_max_info,
                raycast_depth_m=self.cfg.cost_calculator.raycast_depth_m,
            )

        # -- full path optimization (TSP) --
        with self.log.scope("optimize_full_path", MODULE):
            has_goal_d, goal_idx_d = self._optimize_path(
                costs, fr, blacklisted, robot_dev, occ)

        # ONE packed device->host pull for every per-tick control-flow scalar
        prev_goal = (np.asarray(self._goal_xy, np.float32)
                     if self._goal_xy is not None else np.zeros(2, np.float32))
        # prefetch the FI gate's scalar into the same pull when a device
        # oracle is wired
        fi_dev = -1e30
        if (self.fi_oracle_device is not None
                and self.cfg.fisher_information.enabled
                and not self._fi_exhaustive_retry):
            fi_dev = self.fi_oracle_device(robot_xy, robot_yaw, False)
        vals = self._read(_pack_tick_scalars(
            self.spec, occ, fr.valid, fr.goal_xy, costs.best_heading,
            has_goal_d, goal_idx_d, self._upload_xy(prev_goal), fi_dev))
        fi_prefetched = float(vals[7]) if float(vals[7]) > -1e29 else None

        n_frontiers = int(vals[0])
        self.diag.frontiers_found = n_frontiers
        if n_frontiers == 0:
            if self._search_radius >= self.spec.extent:
                # nothing left anywhere -> exploration complete
                self.nav.cancel()
                self.state = ExplorationState.DONE
                return self.state
            self._search_radius = min(
                self._search_radius * self.cfg.frontier_search.search_radius_growth,
                self.spec.extent,
            )
            return self.state
        self._search_radius = self.cfg.frontier_search.search_radius_m
        prev_goal_cell_occ = int(vals[6])

        # -- consume a COMPLETED goal before any early return. A goal REACHED
        # while its cell is still unknown sits in the sensor's blind radius:
        # blacklist it so the tick loop doesn't livelock re-dispatching it
        if self.nav.status() == GoalStatus.DONE and self._goal_xy is not None:
            if prev_goal_cell_occ == UNKNOWN:
                self.blacklist_xy.append(self._circle3(
                    self._goal_xy,
                    self.cfg.path_optimizer.unmappable_blacklist_radius_m))
                self.diag.blacklisted += 1
            self._goal_xy = None

        if vals[1] < 0.5:
            # no reachable goal: widen next tick; after repeated failure -> done
            self._search_radius = min(
                self._search_radius * self.cfg.frontier_search.search_radius_growth,
                self.spec.extent,
            )
            return self.state

        new_goal = np.asarray(vals[3:5], np.float64)
        new_heading = float(vals[5])

        # -- Fisher-information safety gate + retry ladder --
        if not self._fi_gate(robot_xy, robot_yaw, new_goal,
                             prefetched_info=fi_prefetched):
            return self.state
        goal, _ = cx.goal_hysteresis(
            self._goal_xy, new_goal, self._goal_xy is not None, True, robot_xy,
            self.cfg.goal_hysteresis.switch_threshold_m
            if self.cfg.goal_hysteresis.enabled else -1e9,
        )
        goal = np.asarray(goal)

        # -- publish the refined plan + dispatch / monitor --
        self.published_path = self._build_published_path(goal, occ, robot_xy)
        if self.published_path is not None and hasattr(self.nav, "set_path"):
            self.nav.set_path(self.published_path)
        self._send_or_monitor(goal, new_heading, occ, robot_xy,
                              goal_cell_occ=prev_goal_cell_occ)
        return self.state

    # ------------------------------------------------------------------
    # Stages
    # ------------------------------------------------------------------

    def _search_frontiers(self, occ, robot_dev) -> fx.Frontiers:
        fcfg = self.cfg.frontier_search
        return fx.extract_frontiers(
            self.spec, occ, robot_dev, self._search_radius,
            max_cells=4096,
            max_frontiers=fcfg.max_frontiers,
            max_cluster_size=fcfg.max_frontier_cluster_size,
            min_cluster_size=fcfg.min_frontier_cluster_size,
            cc_iters=fcfg.cc_iters,
            boundary=self.boundary_mask,
        )

    def _update_roadmap(self, occ, robot_xy, robot_yaw, robot_dev):
        rcfg = self.cfg.roadmap
        kf_T_cw, n_kf = self._kf_poses()
        # robot pose as node + trailing deque; trailing poses keep their
        # heading for the isPathSafe FOV-overlap test
        self.roadmap = rmx.add_nodes(
            self.roadmap, robot_dev[None, :],
            torch.ones((1,), dtype=torch.bool, device=self.device),
            torch.zeros((1,), dtype=torch.bool, device=self.device),
            kf_T_cw, n_kf, rcfg.min_node_separation,
        )
        self.trailing_poses.append(
            np.array([robot_xy[0], robot_xy[1], robot_yaw], np.float64))
        if len(self.trailing_poses) > rcfg.trailing_pose_count:
            self.trailing_poses.pop(0)

        # periodic full reconstruction + loop-closure correction (CleanupRoadmap)
        now = self.log.time_since_start()
        if now - self._last_cleanup > rcfg.cleanup_period_s:
            self._last_cleanup = now
            if rcfg.correct_loop_closure:
                self.roadmap = rmx.reanchor_nodes(self.roadmap, kf_T_cw)
                self.diag.loop_corrections += 1
        self.roadmap = rmx.connect_edges(
            self.roadmap, self.spec, occ,
            rcfg.max_edge_length, rcfg.max_unknown_fraction,
        )

    def add_frontier_nodes(self, fr: fx.Frontiers):
        kf_T_cw, n_kf = self._kf_poses()
        self.roadmap = rmx.add_nodes(
            self.roadmap, fr.goal_xy, fr.valid, torch.ones_like(fr.valid),
            kf_T_cw, n_kf, self.cfg.roadmap.min_node_separation,
        )

    def _kf_poses(self):
        if self.get_kf_poses is not None:
            return self.get_kf_poses()
        return self._identity_kf

    BLACKLIST_CAP = 64

    def _blacklist_mask(self, fr: fx.Frontiers) -> torch.Tensor:
        """Fixed-capacity circle buffer; unused rows sit at 1e9 and never
        match. When the buffer would overflow, the OLDEST circles are
        evicted into the persistent `lethal_overlay` (rasterized as
        world-frame discs) before being dropped, so a blacklisted goal stays
        excluded for the whole mission."""
        peers = []
        if self.peer_goals is not None:
            peers = [self._circle3(g) for g in self.peer_goals()
                     if g is not None]
        # peers are capped to half the buffer SEPARATELY so own-blacklist
        # circles within budget are never silently truncated
        peers = peers[: self.BLACKLIST_CAP // 2]
        budget = self.BLACKLIST_CAP - len(peers)
        if len(self.blacklist_xy) > budget:
            evicted = [self._circle3(c)
                       for c in self.blacklist_xy[: len(self.blacklist_xy) - budget]]
            self.blacklist_xy = self.blacklist_xy[len(evicted):]
            for i0 in range(0, len(evicted), self.BLACKLIST_CAP):
                chunk = evicted[i0:i0 + self.BLACKLIST_CAP]
                ebuf = np.zeros((self.BLACKLIST_CAP, 3), np.float32)
                ebuf[:, :2] = 1e9
                ebuf[: len(chunk)] = np.stack(chunk)
                self.lethal_overlay = navx.mark_lethal_discs(
                    self.spec, self.lethal_overlay, upload(ebuf, self.device))
        circles = [self._circle3(c) for c in self.blacklist_xy] + peers
        buf = np.zeros((self.BLACKLIST_CAP, 3), np.float32)
        buf[:, :2] = 1e9
        n = min(len(circles), self.BLACKLIST_CAP)
        if n:
            buf[:n] = np.stack(circles)[-n:]
        return cx.blacklist_mask(fr.goal_xy, upload(buf, self.device))

    def _circle3(self, xy, radius: Optional[float] = None) -> np.ndarray:
        """Normalize a blacklist entry to (x, y, radius); bare (x, y) entries
        and peer goals get the configured default radius."""
        a = np.asarray(xy, np.float32).reshape(-1)
        if a.shape[0] >= 3:
            return a[:3]
        r = (self.cfg.path_optimizer.blacklist_radius_m
             if radius is None else radius)
        return np.array([a[0], a[1], r], np.float32)

    def _optimize_path(self, costs, fr, blacklisted, robot_dev, occ):
        # frontier nodes join the roadmap AND get edges before the TSP prices
        # legs over them; node snaps are then refreshed so TSP legs route
        # through the just-connected nodes instead of stale ones
        self.add_frontier_nodes(fr)
        rcfg = self.cfg.roadmap
        self.roadmap = rmx.connect_edges(
            self.roadmap, self.spec, occ,
            rcfg.max_edge_length, rcfg.max_unknown_fraction,
        )
        costs = costs._replace(node_idx=cx.snap_to_nodes(
            fr.goal_xy, self.roadmap.xy, self.roadmap.valid))
        sel, sel_valid, g_idx = cx.select_locals(
            costs, fr, blacklisted, self.cfg.path_optimizer.local_path_threshold_m
        )
        # all BF rows (robot + every selected local) in ONE batched pass:
        # pairwise row 0 = robot, rows 1.. = locals in selection order
        srcs = cx.make_bf_sources(robot_dev, fr.goal_xy, sel)
        dists, parents, src_nodes = rmx.shortest_paths_multi(self.roadmap, srcs)
        self._bf_parent = parents[0]
        self._bf_src = src_nodes[0]
        g_node = cx.global_node(costs.node_idx, g_idx)
        plan = cx.optimize_full_path(
            costs, fr, blacklisted, dists, sel, sel_valid, g_node
        )
        # closest-global fallback applied branchlessly on the device: the
        # tick's control-flow scalars come back in one packed pull
        return cx.finalize_goal(plan.has_goal, plan.goal_idx, g_idx)

    def _build_published_path(self, goal_xy, occ, robot_xy) -> Optional[np.ndarray]:
        """The exploration-published plan (refineAndPublishPath): roadmap
        shortest path robot -> goal, LOS-shortcut smoothed. The nav layer's
        roadmap-planner mode replays this instead of planning its own path."""
        if self._bf_parent is None:
            return None
        # parent row + BF source + goal node + node coordinates in ONE pull
        goal_node_d = rmx.nearest_node(self.roadmap, self._upload_xy(goal_xy))
        N = self.roadmap.xy.shape[0]
        f32 = torch.float32
        pk = self._read(torch.cat([
            self._bf_parent.to(f32).reshape(-1),
            self._bf_src.to(f32).reshape(1),
            goal_node_d.to(f32).reshape(1),
            self.roadmap.xy.reshape(-1),
        ]))
        parent_h = pk[:N].astype(np.int64)
        src_h = int(pk[N])
        goal_node = int(pk[N + 1])
        xy = pk[N + 2:].reshape(N, 2)
        nodes = rmx.extract_path(self.roadmap, parent_h, src_h, goal_node)
        pts = [np.asarray(robot_xy, np.float64)]
        pts += [xy[i] for i in nodes]
        pts.append(np.asarray(goal_xy, np.float64))
        W = 32
        pts = np.asarray(pts[:W], np.float32)
        wp = np.zeros((W, 2), np.float32)
        wp[: len(pts)] = pts
        wv = np.zeros((W,), bool)
        wv[: len(pts)] = True
        keep = self._read(rmx.refine_path_los(
            self.spec, occ, upload(wp, self.device), upload(wv, self.device)))
        return wp[keep]

    # ------------------------------------------------------------------
    # Fisher-information retry ladder (§3.3)
    # ------------------------------------------------------------------

    def _path_safety(self, robot_xy, goal_xy) -> PathSafety:
        """isPathSafe: when the heading of the robot->goal segment
        FOV-overlaps any trailing robot pose heading, check the pose-pair
        Fisher information; with no overlap the safety is UNDETERMINED."""
        fcfg = self.cfg.fisher_information
        d = np.asarray(goal_xy, np.float64) - np.asarray(robot_xy, np.float64)
        if float(np.linalg.norm(d)) < 1e-6:
            return PathSafety.UNDETERMINED
        heading = math.atan2(d[1], d[0])
        overlap = any(
            abs((heading - float(p[2]) + math.pi) % (2 * math.pi) - math.pi)
            < fcfg.angle_fov_overlap_rad
            for p in self.trailing_poses if len(p) >= 3
        )
        if not overlap:
            return PathSafety.UNDETERMINED
        # pose-pair check: the robot pose oriented toward the goal
        info = self.fi_oracle(robot_xy, heading, self._fi_exhaustive_retry)
        return PathSafety.SAFE if info > fcfg.threshold else PathSafety.UNSAFE

    def _fi_gate(self, robot_xy, robot_yaw, goal_xy,
                 prefetched_info: Optional[float] = None) -> bool:
        """FI gate + retry ladder (OptimizeFullPath): fi_drop_count at limit
        forces a blacklist; UNSAFE increments retries; retries at
        number_retries-1 escalate to exhaustive landmark search; retries at
        number_retries blacklist the pose ahead, mark the lethal FOV wedge,
        and trigger recovery; a pass that needed exhaustive search increments
        fi_drop_count (oscillation pattern detector)."""
        if self.fi_oracle is None or not self.cfg.fisher_information.enabled:
            return True
        fcfg = self.cfg.fisher_information
        force_blacklist = (
            self._fi_drop_count >= self.cfg.exploration_bt.fi_drop_limit
        )
        if not force_blacklist:
            if prefetched_info is not None and not self._fi_exhaustive_retry:
                info = prefetched_info   # folded into the tick's packed pull
            else:
                info = self.fi_oracle(robot_xy, robot_yaw,
                                      self._fi_exhaustive_retry)
            unsafe = info <= fcfg.threshold
            if not unsafe and fcfg.check_path_safety:
                # path-level check on the segment about to be driven
                unsafe = (
                    self._path_safety(robot_xy, goal_xy) == PathSafety.UNSAFE
                )
            if not unsafe:
                if self._fi_exhaustive_retry:
                    # only passed via exhaustive search: count the drop
                    self._fi_drop_count += 1
                    logx.warn(
                        f"FI gate passed via exhaustive search "
                        f"(fi_drop_count={self._fi_drop_count})"
                    )
                else:
                    self._fi_drop_count = 0
                self._fi_retries = 0
                self._fi_exhaustive_retry = False
                return True
            logx.warn(f"FI gate: info {info:.1f} <= {fcfg.threshold} at {robot_xy}")
        else:
            logx.warn("FI oscillation pattern found — forcing blacklist "
                      "(fi_drop_count limit)")

        self.diag.fi_rejections += 1
        self.nav.cancel()
        self._fi_retries += 1
        if self._fi_retries >= fcfg.number_retries - 1:
            # escalate: next attempt searches landmarks exhaustively
            self._fi_exhaustive_retry = True
        if force_blacklist or self._fi_retries >= fcfg.number_retries:
            # final rung: blacklist ahead + mark lethal FOV wedge + recovery
            self._fi_retries = 0
            self._fi_drop_count = 0
            self._fi_exhaustive_retry = False
            look = fcfg.blacklist_lookahead_m
            ahead = np.asarray(robot_xy) + look * np.array(
                [math.cos(robot_yaw), math.sin(robot_yaw)]
            )
            self.blacklist_xy.append(self._circle3(ahead))
            self.diag.blacklisted += 1
            # FI wedges are AGED (expire + clearable), not durable
            self.wedge_age = navx.mark_wedge_age(
                self.spec, self.wedge_age, self._upload_xy(robot_xy),
                float(np.float32(robot_yaw)), self.diag.ticks,
                apex_angle_rad=math.radians(fcfg.lethal_wedge_apex_deg),
                height_m=fcfg.lethal_wedge_height_m,
            )
            self._note_failure_for_clear(robot_xy)
            self._start_recovery()
        return False

    def _overlay(self) -> torch.Tensor:
        """Effective lethal overlay: durable blacklist-eviction cells OR
        still-fresh aged FI wedges."""
        ttl = self.cfg.fisher_information.lethal_wedge_ttl_ticks
        active = navx.age_overlay_active(self.wedge_age, self.diag.ticks, ttl)
        return self.lethal_overlay | active

    def _note_failure_for_clear(self, robot_xy):
        """ClearCostmap recovery rung: after `clear_costmap_failures`
        consecutive failures with no completed goal, wipe aged wedge
        markings around the robot so an over-marked pocket cannot trap it."""
        bt = self.cfg.exploration_bt
        self._clear_failures += 1
        if self._clear_failures >= bt.clear_costmap_failures:
            self._clear_failures = 0
            self.wedge_age = navx.clear_age_disc(
                self.spec, self.wedge_age, self._upload_xy(robot_xy),
                bt.clear_costmap_radius_m)
            logx.warn("ClearCostmap recovery: cleared aged wedges within "
                      f"{bt.clear_costmap_radius_m} m")

    def _start_recovery(self):
        self.state = ExplorationState.RECOVERING
        self.diag.recoveries += 1
        self._recovery_ticks_left = max(
            1, int(self.cfg.recovery.move_distance_m / self.cfg.recovery.speed
                   / max(self.cfg.exploration_bt.tick_dt_s, 1e-3))
        )

    def _tick_recovery(self, occ, robot_xy, robot_yaw) -> ExplorationState:
        """Open-loop recovery move toward the freer direction (E14). Both
        probe distances come back in one read."""
        dirs = np.asarray(
            [[math.cos(robot_yaw), math.sin(robot_yaw)],
             [-math.cos(robot_yaw), -math.sin(robot_yaw)]], np.float32
        )
        free = self._read(raycast.free_distance(
            self.spec, occ, self._upload_xy(robot_xy), upload(dirs, self.device),
            max_dist=self.cfg.recovery.probe_distance_m,
        ))
        sign = 1.0 if float(free[0]) >= float(free[1]) else -1.0
        v = sign * self.cfg.recovery.speed
        if hasattr(self.nav, "drive_open_loop"):
            self.nav.drive_open_loop(v, 0.0)
        self._recovery_ticks_left -= 1
        if self._recovery_ticks_left <= 0:
            self.state = ExplorationState.EXPLORING
        return self.state

    # ------------------------------------------------------------------
    # Goal dispatch (SendNav2Goal / CheckIfGoalMapped / timeout)
    # ------------------------------------------------------------------

    def _send_or_monitor(self, goal, heading, occ, robot_xy,
                         goal_cell_occ=None):
        bt = self.cfg.exploration_bt
        status = self.nav.status()
        same_goal = (
            self._goal_xy is not None
            and float(np.linalg.norm(goal - self._goal_xy)) < 0.3
        )
        if status == GoalStatus.ACTIVE and same_goal:
            # CheckIfGoalMapped: replan once the goal cell becomes known.
            # `goal_cell_occ` (from the tick's packed pull, sampled at
            # self._goal_xy) is reused when the monitored goal IS that goal;
            # the extra pull happens only on the rare near-but-not-equal case
            if goal_cell_occ is not None and np.array_equal(
                    np.asarray(goal, np.float64),
                    np.asarray(self._goal_xy, np.float64)):
                cell_occ = goal_cell_occ
            else:
                cell_occ = int(self._read(raycast._sample_occ(
                    self.spec, occ, self._upload_xy(goal)[None, :]))[0])
            if cell_occ != UNKNOWN:
                self.diag.replans += 1
                self.nav.cancel()
                self._goal_xy = None
                return
            # timeout -> abort + count failure
            if (self.diag.ticks - self._goal_sent_tick) * bt.tick_dt_s > bt.nav2_goal_timeout_s:
                self._on_goal_failure(goal)
            return
        if status == GoalStatus.ABORTED and same_goal:
            self._on_goal_failure(goal)
            return
        # (re)send
        self.nav.send_goal(goal, heading)
        self._goal_xy = goal
        self._goal_heading = heading
        self._goal_sent_tick = self.diag.ticks
        self.diag.goals_sent += 1

    def _on_goal_failure(self, goal):
        key = (int(goal[0] * 4), int(goal[1] * 4))
        self._goal_failures[key] = self._goal_failures.get(key, 0) + 1
        self.nav.cancel()
        self._goal_xy = None
        # nav failures also feed the ClearCostmap rung
        self._note_failure_for_clear(self.get_robot_pose()[0])
        if self._goal_failures[key] >= self.cfg.exploration_bt.max_nav_failures_before_blacklist:
            self.blacklist_xy.append(self._circle3(goal))
            self.diag.blacklisted += 1
            if self.cfg.exploration_bt.abort_on_nav_abort:
                self.state = ExplorationState.FAILED
