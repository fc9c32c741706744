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

A tick's device work runs as captured programs (``utils/jit.py``; CUDA
graphs on a CUDA device), the counterpart of the reference's chain of
compiled programs: ``overlay`` (the aged lethal overlay on the grid) and
``tick`` (roadmap upkeep, frontier search, shortest paths, the blacklist
mask, the wavefront potential, costs, the TSP, the device oracle's FI scalar
and the packed scalars, the robot's BF row kept for the published path). The
tick's host values (robot pose, previous goal, search radius, blacklist
circles, the oracle's query pose, RandomCosts' draw) reach it as one staged
input. The configuration's branches are fixed by the slot's key; the host's
(the CleanupRoadmap clock, the FI retry ladder's exhaustive rung, a
boundary, the wired callbacks) name variants of ``tick``. After the tick's
pull, its tail: the published path as ``publish`` (the goal's node packed
with the BF row and the node coordinates, one read), the host's walk of the
parents, then ``los`` (the line-of-sight mask of the staged waypoints, one
read); the goal-cell probe of goal monitoring (``goal_cell``) and the
recovery's free-space probe (``recovery``), each one read; and the rare
writes, the blacklist eviction (``evict``), the FI wedge mark (``wedge``)
and the ClearCostmap disc (``clear``). These five recur rarely: each runs
eagerly for an owner's first ``RARE_EAGER_CALLS`` calls and is captured
after. ``roadmap``, ``lethal_overlay`` and ``wedge_age`` live in the slot's
buffers, updated in place; assigning any of them copies into the buffer.
Dispatch, the FI retry ladder and bootstrap are host logic.
``capture=False`` runs the same regions as plain PyTorch.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fitslam_tpu_torch.models import costs as cx
from fitslam_tpu_torch.models import nav as navx
from fitslam_tpu_torch.models import roadmap as rmx
from fitslam_tpu_torch.ops import fisher
from fitslam_tpu_torch.ops import frontier as fx
from fitslam_tpu_torch.ops import lie, raycast
from fitslam_tpu_torch.ops.grid import UNKNOWN, GridSpec2D
from fitslam_tpu_torch.utils import jit, profiling
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


class FiOracle(NamedTuple):
    """A device Fisher-information oracle in the three parts a captured tick
    needs: ``pose(robot_xy, robot_yaw)`` is the query's host values (a
    float32 numpy vector), ``inputs()`` the tree of device tensors it reads,
    and ``value(inputs, pose values on the device)`` the information as a
    0-d tensor, a function of tensors alone (it keeps no reference to its
    owner: a slot may outlive it)."""

    pose: Callable[[np.ndarray, float], np.ndarray]
    inputs: Callable[[], Any]
    value: Callable[[Any, torch.Tensor], torch.Tensor]


BLACKLIST_CAP = 64       # the tick's fixed-capacity blacklist circle buffer
_NO_FI = -1e30           # the packed FI slot when no device oracle is wired


def overlay_region(occ, lethal_overlay, wedge_age, tick, *, ttl):
    """Region ``overlay``: the effective lethal overlay (durable blacklist
    cells OR still-fresh aged FI wedges at tick ``tick``, a 0-d int32)
    applied to the grid."""
    active = navx.age_overlay_active(wedge_age, tick, ttl)
    return (), navx.apply_overlay(occ, lethal_overlay | active)


def tick_region(occ, roadmap, host, bf, kf_T_cw, n_kf, landmarks, fi_inputs, boundary, *,
                spec: GridSpec2D, cfg: FitSlamConfig, reanchor: bool, fi_value):
    """Region ``tick``: the tick's device work from the overlaid grid to the
    packed scalars. ``host`` is the staged host vector ([robot xy, previous
    goal xy, search radius, blacklist circles, the oracle's query pose when
    ``fi_value`` is given, RandomCosts' draw when configured]); ``landmarks``
    (xy, info, valid) turns path FI on. Writes the roadmap and ``bf`` (the
    robot row's BF parents and its BF source node, which ``publish``
    reads); returns (packed scalars,)."""
    rcfg, fscfg, fcfg = cfg.roadmap, cfg.frontier_search, cfg.fisher_information
    dev = occ.device
    robot = host[0:2]
    prev_goal = host[2:4]
    o = 5 + 3 * BLACKLIST_CAP
    circles = host[5:o].reshape(BLACKLIST_CAP, 3)

    # -- roadmap upkeep: the robot pose as a node, CleanupRoadmap's
    # loop-closure correction when its period is up, the edges --
    roadmap = rmx.add_nodes(roadmap, robot[None, :], torch.ones((1,), dtype=torch.bool, device=dev),
                            torch.zeros((1,), dtype=torch.bool, device=dev),
                            kf_T_cw, n_kf, rcfg.min_node_separation)
    if reanchor:
        roadmap = rmx.reanchor_nodes(roadmap, kf_T_cw)
    roadmap = rmx.connect_edges(roadmap, spec, occ, rcfg.max_edge_length,
                                rcfg.max_unknown_fraction)

    # -- frontier search (SearchForFrontiers) --
    fr = fx.extract_frontiers(spec, occ, robot, host[4], max_cells=4096,
                              max_frontiers=fscfg.max_frontiers,
                              max_cluster_size=fscfg.max_frontier_cluster_size,
                              min_cluster_size=fscfg.min_frontier_cluster_size,
                              cc_iters=fscfg.cc_iters, boundary=boundary)

    # -- costs --
    robot_dist, _, _ = rmx.shortest_paths(roadmap, robot)
    blacklisted = cx.blacklist_mask(fr.goal_xy, circles)
    pot = navx.wavefront_potential(spec, navx.clear_robot_footprint(spec, occ, robot), robot,
                                   iters=cfg.nav.wavefront_iters, allow_unknown=True)
    # fisher_information_in_path per frontier (E4/E5): mean FOV landmark
    # information along each approach segment
    path_fi = None
    if landmarks is not None:
        lm_xy, lm_info, lm_valid = landmarks
        path_fi = fisher.path_information(
            lm_xy.to(torch.float32), lm_info.to(torch.float32), lm_valid.to(torch.bool),
            robot, fr.goal_xy, fr.valid, num_waypoints=fcfg.path_fi_waypoints,
            fov_half_angle=fcfg.fov_half_angle, max_range=fcfg.max_landmark_distance)
    methods = tuple(cfg.cost_assigner.cost_calculation_methods)
    o_draw = o + (12 if fi_value is not None else 0)
    costs = cx.assign_costs(
        spec, occ, fr, roadmap.xy, roadmap.valid, robot_dist, blacklisted,
        methods=methods,
        random_weights=(host[o_draw:o_draw + fscfg.max_frontiers]
                        if "RandomCosts" in methods else None),
        alpha=cfg.cost_assigner.alpha,
        beta=cfg.cost_assigner.beta,
        v_max=cfg.cost_assigner.max_linear_velocity,
        w_max=cfg.cost_assigner.max_angular_velocity,
        grid_pot=pot,
        path_fi=path_fi,
        min_path_info=fcfg.min_path_information,
        robot_xy=robot,
        closeness_rejection=cfg.cost_calculator.closeness_rejection_m,
        factor_of_max_info=cfg.cost_calculator.factor_of_max_info,
        raycast_depth_m=cfg.cost_calculator.raycast_depth_m,
    )

    # -- full path optimization (TSP): frontier nodes join the roadmap AND
    # get edges before the TSP prices legs over them; node snaps are then
    # refreshed so TSP legs route through the just-connected nodes --
    roadmap = rmx.add_nodes(roadmap, fr.goal_xy, fr.valid, torch.ones_like(fr.valid),
                            kf_T_cw, n_kf, rcfg.min_node_separation)
    roadmap = rmx.connect_edges(roadmap, spec, occ, rcfg.max_edge_length,
                                rcfg.max_unknown_fraction)
    costs = costs._replace(node_idx=cx.snap_to_nodes(fr.goal_xy, roadmap.xy, roadmap.valid))
    sel, sel_valid, g_idx = cx.select_locals(costs, fr, blacklisted,
                                             cfg.path_optimizer.local_path_threshold_m)
    # all BF rows (robot + every selected local) in ONE batched pass:
    # pairwise row 0 = robot, rows 1.. = locals in selection order
    srcs = cx.make_bf_sources(robot, fr.goal_xy, sel)
    dists, parents, src_nodes = rmx.shortest_paths_multi(roadmap, srcs)
    g_node = cx.global_node(costs.node_idx, g_idx)
    plan = cx.optimize_full_path(costs, fr, blacklisted, dists, sel, sel_valid, g_node)
    # closest-global fallback applied branchlessly on the device
    has_goal, goal_idx = cx.finalize_goal(plan.has_goal, plan.goal_idx, g_idx)

    # the FI gate's scalar, prefetched into the same pull
    fi = _NO_FI if fi_value is None else fi_value(fi_inputs, host[o:o + 12])
    vals = _pack_tick_scalars(spec, occ, fr.valid, fr.goal_xy, costs.best_heading,
                              has_goal, goal_idx, prev_goal, fi)
    return (None, roadmap, None, (parents[0], src_nodes[0])), (vals,)


PATH_WAYPOINTS = 32      # the published path's fixed waypoint capacity
#: the calls of an owner's rare regions that run as plain PyTorch before the
#: region is captured: each the calls after which the measured capture cost
#: (warm-up and capture above two eager calls) equals what the replays save,
#: the largest of three card runs (PERF.md §6)
RARE_EAGER_CALLS = {"recovery": 14, "goal_cell": 25, "evict": 61, "wedge": 29, "clear": 62}


def publish_region(roadmap, bf, goal):
    """Region ``publish``: the roadmap node nearest the staged ``goal``,
    packed as float32 with the robot's BF parent row, its BF source node and
    the node coordinates ([parents (N), source, goal node, xy (2N)])."""
    parent, src = bf
    f32 = torch.float32
    return (), torch.cat([parent.to(f32), src.to(f32).reshape(1),
                          rmx.nearest_node(roadmap, goal).to(f32).reshape(1),
                          roadmap.xy.reshape(-1)])


def los_region(occ, host, *, spec: GridSpec2D):
    """Region ``los``: the line-of-sight keep mask of the staged waypoints
    (``host``: PATH_WAYPOINTS (x, y) pairs, then their validity as 0 / 1)."""
    W = PATH_WAYPOINTS
    return (), rmx.refine_path_los(spec, occ, host[:2 * W].reshape(W, 2), host[2 * W:] > 0.5)


def goal_cell_region(occ, goal, *, spec: GridSpec2D):
    """Region ``goal_cell``: the grid's value at the staged goal, (1,)."""
    return (), raycast._sample_occ(spec, occ, goal[None, :])


def recovery_region(occ, host, *, spec: GridSpec2D, max_dist: float):
    """Region ``recovery``: the free distance ahead of and behind the robot
    (``host``: its (x, y), then the two unit directions), (2,)."""
    return (), raycast.free_distance(spec, occ, host[0:2], host[2:6].reshape(2, 2),
                                     max_dist=max_dist)


def evict_region(lethal_overlay, circles, *, spec: GridSpec2D):
    """Region ``evict``: the staged evicted circles as discs into the
    durable overlay. Writes the overlay."""
    return (navx.mark_lethal_discs(spec, lethal_overlay, circles),), ()


def wedge_region(wedge_age, tick, host, *, spec: GridSpec2D, apex_angle_rad: float,
                 height_m: float):
    """Region ``wedge``: the FOV wedge at the staged robot pose (``host``:
    x, y, yaw) stamped with tick ``tick`` (a 0-d int32). Writes the ages."""
    return (navx.mark_wedge_age(spec, wedge_age, host[0:2], host[2], tick,
                                apex_angle_rad=apex_angle_rad, height_m=height_m),), ()


def clear_region(wedge_age, center, *, spec: GridSpec2D, radius_m: float):
    """Region ``clear``: aged wedge cells within ``radius_m`` of the staged
    ``center`` unmarked. Writes the ages."""
    return (navx.clear_age_disc(spec, wedge_age, center, radius_m),), ()


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
        fi_oracle_device: Optional[FiOracle] = None,
        get_kf_poses: Optional[Callable[[], Tuple]] = None,
        event_logger: Optional[EventLogger] = None,
        peer_goals: Optional[Callable[[], List[np.ndarray]]] = None,
        get_landmarks: Optional[Callable[[], Tuple]] = None,
        device="cuda",
        capture: bool = True,
    ):
        self.cfg = cfg
        self.spec = spec
        self.device = torch.device(device)
        self.get_occupancy = get_occupancy
        self.nav = nav
        self.get_robot_pose = get_robot_pose
        self.fi_oracle = fi_oracle
        # device-value variant of the oracle: its scalar folds into the
        # tick's ONE packed pull instead of costing its own readback, and
        # its device work runs inside the tick's region
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
        self.capture = capture

        rcfg = cfg.roadmap
        G = spec.size
        # the roadmap and the overlays move into a slot of this configuration
        # and grid (``utils/jit.py``) at the first tick; the overlay is a new
        # view after each change, as the costmaps cache their composed grid
        # against its identity
        key = ("ExplorationServer", repr(cfg), spec)
        self._slot_state = jit.SlotState(self, key, self.device, {
            "roadmap": rmx.empty_roadmap(rcfg.max_nodes, rcfg.max_edges_per_node, self.device),
            # durable blacklist-eviction cells
            "lethal_overlay": torch.zeros((G, G), dtype=torch.bool, device=self.device),
            # tick-stamped FI-failure wedges: EXPIRE after
            # lethal_wedge_ttl_ticks and are cleared by the ClearCostmap
            # recovery rung, unlike the durable overlay
            "wedge_age": torch.full((G, G), -1, dtype=torch.int32, device=self.device),
            "tick": torch.zeros((), dtype=torch.int32, device=self.device),
            # the last tick's BF parent row of the robot and its source node
            "bf": (torch.full((rcfg.max_nodes,), -1, dtype=torch.int32, device=self.device),
                   torch.zeros((), dtype=torch.int32, device=self.device)),
        }, capture, fresh=("lethal_overlay",))
        # with no SLAM the roadmap is anchored to one identity keyframe
        self._identity_kf = (lie.SE3.identity((1,), device=self.device),
                             torch.ones((), dtype=torch.int32, device=self.device))
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
        self._bf_ready = False       # a tick has written the BF row
        self._goal_sent_tick = -1
        self._goal_failures: Dict[Tuple[int, int], int] = {}
        self._last_cleanup = 0.0
        self._recovery_ticks_left = 0
        # FI retry ladder state (OptimizeFullPath BT node)
        self._fi_retries = 0
        self._fi_drop_count = 0
        self._fi_exhaustive_retry = False

    roadmap = jit.slot_field(doc="""The roadmap; with capture, the slot's buffers
        (updated in place by each tick: copy what must not change; assigning
        copies in).""")
    lethal_overlay = jit.slot_field()
    wedge_age = jit.slot_field()
    _bf = jit.slot_field("bf")

    @property
    def capture_stats(self) -> Dict[str, Dict]:
        """{region: calls, captured, capture seconds, graph pool bytes}; empty
        on the eager path."""
        return self._slot_state.stats()

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

    def _read(self, t: torch.Tensor, site: str) -> np.ndarray:
        """One counted device->host read, a ``sync`` span of ``site``."""
        self.host_syncs += 1
        with profiling.host_read(f"ExplorationServer.{site}", self.device):
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

        occ = self._overlaid(self.get_occupancy())

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

        # roadmap upkeep, frontier search, costs and the TSP up to ONE packed
        # device->host pull of every per-tick control-flow scalar
        with self.log.scope("exploration.tick", MODULE):
            (vals_d,) = self._tick_device(occ, robot_xy, robot_yaw)
        vals = self._read(vals_d, "tick")
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

    def _overlaid(self, occ_raw: torch.Tensor) -> torch.Tensor:
        """Region ``overlay`` on the grid ``occ_raw``: the tick's grid."""
        ttl = self.cfg.fisher_information.lethal_wedge_ttl_ticks
        tick = self._slot_state.fill("tick", self.diag.ticks)
        _, occ = self._slot_state.run("overlay", functools.partial(overlay_region, ttl=ttl),
                                      occ_raw, self.lethal_overlay, self.wedge_age, tick)
        return occ

    def _tick_device(self, occ, robot_xy, robot_yaw):
        """The tick's host decisions, then region ``tick`` (a variant for
        each host-chosen branch): its outputs, (packed scalars,)."""
        rcfg, fcfg = self.cfg.roadmap, self.cfg.fisher_information
        # trailing poses keep their heading for the isPathSafe FOV-overlap test
        self.trailing_poses.append(
            np.array([robot_xy[0], robot_xy[1], robot_yaw], np.float64))
        if len(self.trailing_poses) > rcfg.trailing_pose_count:
            self.trailing_poses.pop(0)
        # periodic full reconstruction + loop-closure correction
        # (CleanupRoadmap), on the logger's clock
        reanchor = False
        now = self.log.time_since_start()
        if now - self._last_cleanup > rcfg.cleanup_period_s:
            self._last_cleanup = now
            if rcfg.correct_loop_closure:
                reanchor = True
                self.diag.loop_corrections += 1

        prev_goal = (np.asarray(self._goal_xy, np.float32)
                     if self._goal_xy is not None else np.zeros(2, np.float32))
        host = [np.asarray(robot_xy, np.float32), prev_goal,
                np.float32([self._search_radius]), self._blacklist_buffer().reshape(-1)]
        oracle = self.fi_oracle_device
        fi = oracle is not None and fcfg.enabled and not self._fi_exhaustive_retry
        fi_inputs = None
        if fi:
            host.append(np.asarray(oracle.pose(robot_xy, robot_yaw), np.float32))
            fi_inputs = oracle.inputs()
        if "RandomCosts" in self.cfg.cost_assigner.cost_calculation_methods:
            host.append(cx.random_draw(prng.prng_key(self.diag.ticks),
                                       self.cfg.frontier_search.max_frontiers))
        landmarks = None
        if (self.get_landmarks is not None and fcfg.enabled
                and fcfg.min_path_information > 0.0):
            landmarks = tuple(self._on_device(a) for a in self.get_landmarks())
        kf_T_cw, n_kf = self._kf_poses()
        args = (occ, self.roadmap, upload(np.concatenate(host), self.device), self._bf, kf_T_cw,
                self._on_device(n_kf), landmarks, fi_inputs, self.boundary_mask)
        variant = "".join(f"+{flag}" for flag, on in (
            ("reanchor", reanchor), ("fi", fi), ("path_fi", landmarks is not None),
            ("boundary", self.boundary_mask is not None)) if on)
        # the oracle's inputs may differ in structure (a world anchor or not)
        name = f"tick{variant}/{len(jit.flatten(fi_inputs)[0])}"
        fn = functools.partial(tick_region, spec=self.spec, cfg=self.cfg, reanchor=reanchor,
                               fi_value=oracle.value if fi else None)
        (_, self.roadmap, _, self._bf, *_), out = self._slot_state.run(name, fn, *args)
        self._bf_ready = True
        return out

    def _claim(self) -> None:
        """With capture, the slot (so that the fields read next are its
        buffers, which a region then reads in place)."""
        if self.capture:
            self._slot_state.claim()

    def _kf_poses(self):
        if self.get_kf_poses is not None:
            return self.get_kf_poses()
        return self._identity_kf

    BLACKLIST_CAP = BLACKLIST_CAP      # the module's, as the reference's class attribute

    def _blacklist_buffer(self) -> np.ndarray:
        """The (BLACKLIST_CAP, 3) float32 circle buffer; unused rows sit at
        1e9 and never match. When the buffer would overflow, the OLDEST
        circles are evicted into the persistent `lethal_overlay` (rasterized
        as world-frame discs) before being dropped, so a blacklisted goal
        stays excluded for the whole mission."""
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
                self._evict(ebuf)
        circles = [self._circle3(c) for c in self.blacklist_xy] + peers
        buf = np.zeros((self.BLACKLIST_CAP, 3), np.float32)
        buf[:, :2] = 1e9
        n = min(len(circles), self.BLACKLIST_CAP)
        if n:
            buf[:n] = np.stack(circles)[-n:]
        return buf

    def _evict(self, ebuf: np.ndarray) -> None:
        """Region ``evict``: the (BLACKLIST_CAP, 3) circles ``ebuf`` (padding
        rows at 1e9) as discs into the durable overlay."""
        self._claim()
        (self.lethal_overlay, _), _ = self._slot_state.run(
            "evict", functools.partial(evict_region, spec=self.spec), self.lethal_overlay,
            upload(ebuf, self.device), eager=RARE_EAGER_CALLS["evict"])

    def _circle3(self, xy, radius: Optional[float] = None) -> np.ndarray:
        """Normalize a blacklist entry to (x, y, radius); bare (x, y) entries
        and peer goals get the configured default radius."""
        a = np.asarray(xy, np.float32).reshape(-1)
        if a.shape[0] >= 3:
            return a[:3]
        r = (self.cfg.path_optimizer.blacklist_radius_m
             if radius is None else radius)
        return np.array([a[0], a[1], r], np.float32)

    def _build_published_path(self, goal_xy, occ, robot_xy) -> Optional[np.ndarray]:
        """The exploration-published plan (refineAndPublishPath): roadmap
        shortest path robot -> goal, LOS-shortcut smoothed. The nav layer's
        roadmap-planner mode replays this instead of planning its own path.
        Regions ``publish`` and ``los``, a read each; the walk of the
        parents between them is the host's, as in the reference."""
        if not self._bf_ready:
            return None
        # parent row + BF source + goal node + node coordinates in ONE pull
        _, packed = self._slot_state.run("publish", publish_region, self.roadmap, self._bf,
                                         self._upload_xy(goal_xy))
        pk = self._read(packed, "publish")
        N = self.roadmap.xy.shape[0]
        parent_h = pk[:N].astype(np.int64)
        src_h = int(pk[N])
        goal_node = int(pk[N + 1])
        xy = pk[N + 2:].reshape(N, 2)
        nodes = rmx.extract_path(self.roadmap, parent_h, src_h, goal_node)
        pts = [np.asarray(robot_xy, np.float64)]
        pts += [xy[i] for i in nodes]
        pts.append(np.asarray(goal_xy, np.float64))
        W = PATH_WAYPOINTS
        pts = np.asarray(pts[:W], np.float32)
        wp = np.zeros((W, 2), np.float32)
        wp[: len(pts)] = pts
        wv = np.zeros((W,), bool)
        wv[: len(pts)] = True
        _, keep = self._slot_state.run(
            "los", functools.partial(los_region, spec=self.spec), occ,
            upload(np.concatenate([wp.reshape(-1), wv.astype(np.float32)]), self.device))
        return wp[self._read(keep, "los")]

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
            self._mark_wedge(robot_xy, robot_yaw)
            self._note_failure_for_clear(robot_xy)
            self._start_recovery()
        return False

    def _mark_wedge(self, robot_xy, robot_yaw) -> None:
        """Region ``wedge``: the lethal FOV wedge ahead of the robot stamped
        with this tick. FI wedges are AGED (expire + clearable), not
        durable."""
        fcfg = self.cfg.fisher_information
        tick = self._slot_state.fill("tick", self.diag.ticks)
        fn = functools.partial(wedge_region, spec=self.spec,
                               apex_angle_rad=math.radians(fcfg.lethal_wedge_apex_deg),
                               height_m=fcfg.lethal_wedge_height_m)
        (self.wedge_age, *_), _ = self._slot_state.run(
            "wedge", fn, self.wedge_age, tick,
            self._upload_xy([robot_xy[0], robot_xy[1], robot_yaw]),
            eager=RARE_EAGER_CALLS["wedge"])

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
            self._clear_disc(robot_xy)
            logx.warn("ClearCostmap recovery: cleared aged wedges within "
                      f"{bt.clear_costmap_radius_m} m")

    def _clear_disc(self, robot_xy) -> None:
        """Region ``clear``: aged wedges within the ClearCostmap radius of
        the robot unmarked."""
        self._claim()
        (self.wedge_age, _), _ = self._slot_state.run(
            "clear", functools.partial(clear_region, spec=self.spec,
                                       radius_m=self.cfg.exploration_bt.clear_costmap_radius_m),
            self.wedge_age, self._upload_xy(robot_xy), eager=RARE_EAGER_CALLS["clear"])

    def _start_recovery(self):
        self.state = ExplorationState.RECOVERING
        self.diag.recoveries += 1
        self._recovery_ticks_left = max(
            1, int(self.cfg.recovery.move_distance_m / self.cfg.recovery.speed
                   / max(self.cfg.exploration_bt.tick_dt_s, 1e-3))
        )

    def _free_distances(self, occ, robot_xy, robot_yaw) -> np.ndarray:
        """Region ``recovery``: the free distance ahead and behind, (2,), in
        one read."""
        dirs = np.asarray(
            [[math.cos(robot_yaw), math.sin(robot_yaw)],
             [-math.cos(robot_yaw), -math.sin(robot_yaw)]], np.float32
        )
        fn = functools.partial(recovery_region, spec=self.spec,
                               max_dist=self.cfg.recovery.probe_distance_m)
        _, free = self._slot_state.run(
            "recovery", fn, occ,
            upload(np.concatenate([np.asarray(robot_xy, np.float32), dirs.reshape(-1)]),
                   self.device), eager=RARE_EAGER_CALLS["recovery"])
        return self._read(free, "recovery")

    def _tick_recovery(self, occ, robot_xy, robot_yaw) -> ExplorationState:
        """Open-loop recovery move toward the freer direction (E14). Both
        probe distances come back in one read."""
        free = self._free_distances(occ, robot_xy, robot_yaw)
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
                cell_occ = self._goal_cell(occ, goal)
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

    def _goal_cell(self, occ, goal) -> int:
        """Region ``goal_cell``: the grid's value at ``goal``, one read."""
        _, cell = self._slot_state.run(
            "goal_cell", functools.partial(goal_cell_region, spec=self.spec), occ,
            self._upload_xy(goal), eager=RARE_EAGER_CALLS["goal_cell"])
        return int(self._read(cell, "goal_cell")[0])

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
