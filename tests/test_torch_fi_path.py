"""The port's counterpart of ``tests/test_fi_path.py``: Fisher information
through path selection, on the CPU with the reference's assertions.

Covers ``fisher.path_information`` per frontier and its use as an
achievability gate that reroutes the plan away from a landmark-poor
corridor, the trailing-pose FOV-overlap check (``_path_safety``), and the
FI retry ladder with exhaustive-search escalation and the ``_fi_drop_count``
oscillation detector of ``ExplorationServer``.
"""

import dataclasses
import math

import numpy as np
import torch

from fitslam_tpu_torch.models import costs as cx
from fitslam_tpu_torch.models import nav as navx
from fitslam_tpu_torch.models import roadmap as rmx
from fitslam_tpu_torch.models.exploration import (
    ExplorationServer, ExplorationState, GoalStatus, NavInterface, PathSafety,
)
from fitslam_tpu_torch.ops import fisher
from fitslam_tpu_torch.ops import frontier as fx
from fitslam_tpu_torch.ops import grid as gr
from fitslam_tpu_torch.ops import lie
from fitslam_tpu_torch.utils.config import FitSlamConfig

# several pytest-xdist workers share the machine
torch.set_num_threads(2)

CPU = "cpu"
SPEC = gr.GridSpec2D(size=80, resolution=0.25, origin_x=-10.0, origin_y=-10.0)


class StubNav(NavInterface):
    def __init__(self):
        self.goals = []
        self.cancels = 0
        self._status = GoalStatus.NONE

    def send_goal(self, goal_xy, heading):
        self.goals.append(np.asarray(goal_xy))
        self._status = GoalStatus.ACTIVE

    def cancel(self):
        self.cancels += 1
        self._status = GoalStatus.NONE

    def status(self):
        return self._status


def _band_world():
    """Free middle band; unknown bands north (y > 5) and south (y < -5)."""
    G = SPEC.size
    occ = np.full((G, G), gr.FREE, np.uint8)
    ys = (np.arange(G) + 0.5) * SPEC.resolution + SPEC.origin_y
    occ[ys > 5.0, :] = gr.UNKNOWN
    occ[ys < -5.0, :] = gr.UNKNOWN
    return torch.from_numpy(occ)


def _north_landmarks():
    """Landmark strip covering the northern approach (y in [0, 5])."""
    xs = np.linspace(-4.0, 4.0, 8)
    ys = np.linspace(0.5, 4.5, 8)
    pts = np.stack(np.meshgrid(xs, ys), axis=-1).reshape(-1, 2)
    info = np.full((pts.shape[0],), 50.0, np.float32)
    valid = np.ones((pts.shape[0],), bool)
    return (torch.tensor(pts, dtype=torch.float32), torch.from_numpy(info),
            torch.from_numpy(valid))


def test_path_information_separates_corridors():
    lm_xy, lm_info, lm_valid = _north_landmarks()
    robot = torch.tensor([0.0, -3.0])
    goals = torch.tensor([[0.0, 5.2], [0.0, -5.2]])
    fi = fisher.path_information(lm_xy, lm_info, lm_valid, robot, goals,
                                 torch.ones((2,), dtype=torch.bool), num_waypoints=6)
    fi = fi.numpy()
    assert fi[0] > 100.0          # northern path crosses the landmark strip
    assert fi[1] < 1.0            # southern path sees nothing


def test_low_path_fi_frontier_excluded_in_costs():
    occ = _band_world()
    lm_xy, lm_info, lm_valid = _north_landmarks()
    robot = torch.tensor([0.0, -3.0])
    F = 8
    goal = np.zeros((F, 2), np.float32)
    valid = np.zeros((F,), bool)
    goal[0] = [0.0, 5.1]    # north frontier (landmark-rich approach)
    goal[1] = [0.0, -5.1]   # south frontier (landmark-poor approach)
    valid[:2] = True
    valid_t = torch.from_numpy(valid)
    fr = fx.Frontiers(uid=torch.arange(F, dtype=torch.int32), goal_xy=torch.from_numpy(goal),
                      centroid_xy=torch.from_numpy(goal),
                      size=torch.where(valid_t, 10, 0).to(torch.int32), valid=valid_t)
    rm = rmx.empty_roadmap(32, device=CPU)
    kf = lie.SE3.identity((1,))
    rm = rmx.add_nodes(rm, robot[None, :], torch.ones((1,), dtype=torch.bool),
                       torch.zeros((1,), dtype=torch.bool), kf, torch.tensor(1, dtype=torch.int32))
    robot_dist, _, _ = rmx.shortest_paths(rm, robot)
    path_fi = fisher.path_information(lm_xy, lm_info, lm_valid, robot, fr.goal_xy, fr.valid)
    # the wavefront fallback prices the frontiers (the roadmap has one node)
    pot = navx.wavefront_potential(SPEC, occ, robot, iters=256, allow_unknown=True)
    kw = dict(alpha=0.25, beta=1.0, grid_pot=pot)
    no_blacklist = torch.zeros((F,), dtype=torch.bool)
    gated = cx.assign_costs(SPEC, occ, fr, rm.xy, rm.valid, robot_dist, no_blacklist,
                            path_fi=path_fi, min_path_info=10.0, **kw)
    ungated = cx.assign_costs(SPEC, occ, fr, rm.xy, rm.valid, robot_dist, no_blacklist,
                              path_fi=path_fi, min_path_info=0.0, **kw)
    assert bool(ungated.achievable[0]) and bool(ungated.achievable[1])
    assert bool(gated.achievable[0])
    assert not bool(gated.achievable[1])       # landmark-poor path excluded
    assert float(gated.weighted_cost[1]) > 1e8


def _server(cfg, occ_box, nav, fi_oracle=None, get_landmarks=None,
            robot=(0.0, -3.0, math.pi / 2)):
    pose = np.asarray(robot[:2], np.float64)
    return ExplorationServer(cfg, SPEC, get_occupancy=lambda: occ_box["occ"], nav=nav,
                             get_robot_pose=lambda: (pose, robot[2]), fi_oracle=fi_oracle,
                             get_landmarks=get_landmarks, device=CPU)


def _cfg(**fi_overrides):
    cfg = FitSlamConfig()
    return dataclasses.replace(
        cfg,
        fisher_information=dataclasses.replace(cfg.fisher_information, **fi_overrides),
        frontier_search=dataclasses.replace(cfg.frontier_search, search_radius_m=16.0,
                                            max_frontiers=64),
        nav=dataclasses.replace(cfg.nav, wavefront_iters=256),
    )


def test_plan_reroutes_around_landmark_poor_corridor():
    """e2e: with the path-FI gate on, the server dispatches the northern
    (landmark-rich) goal even though the southern frontier is much closer."""
    occ_box = {"occ": _band_world()}
    lm = _north_landmarks()

    nav_gated = StubNav()
    srv = _server(_cfg(min_path_information=10.0, threshold=550.0), occ_box, nav_gated,
                  fi_oracle=None, get_landmarks=lambda: lm)
    srv.tick()
    assert nav_gated.goals, "gated server dispatched no goal"
    assert nav_gated.goals[0][1] > 0.0, f"expected northern goal, got {nav_gated.goals[0]}"

    nav_plain = StubNav()
    srv2 = _server(_cfg(min_path_information=0.0), occ_box, nav_plain, fi_oracle=None,
                   get_landmarks=lambda: lm)
    srv2.tick()
    assert nav_plain.goals, "ungated server dispatched no goal"
    assert nav_plain.goals[0][1] < 0.0, (
        f"expected closer southern goal without the gate, got {nav_plain.goals[0]}")


def test_fi_retry_ladder_blacklists_after_retries():
    """Persistently unsafe pose: retries escalate to exhaustive search, then
    blacklist + lethal wedge + recovery."""
    occ_box = {"occ": _band_world()}
    nav = StubNav()
    calls = []

    def oracle(xy, yaw, exhaustive):
        calls.append(exhaustive)
        return 0.0  # always unsafe

    srv = _server(_cfg(threshold=5.0, number_retries=3), occ_box, nav, fi_oracle=oracle)
    goal = np.array([0.0, 5.0])
    assert not srv._fi_gate(np.zeros(2), 0.0, goal)   # retry 1
    assert srv._fi_retries == 1 and not srv.blacklist_xy
    assert not srv._fi_gate(np.zeros(2), 0.0, goal)   # retry 2 -> exhaustive
    assert srv._fi_exhaustive_retry
    assert not srv._fi_gate(np.zeros(2), 0.0, goal)   # retry 3 -> blacklist
    assert calls[-1] is True                          # exhaustive attempt ran
    assert len(srv.blacklist_xy) == 1
    # FI wedges are aged markings, apart from the durable blacklist overlay:
    # check the effective overlay
    assert bool(srv._overlay().any())
    assert srv.state == ExplorationState.RECOVERING
    assert srv._fi_retries == 0 and not srv._fi_exhaustive_retry


def test_fi_drop_pattern_forces_blacklist():
    """A pose that passes only through exhaustive search: after
    fi_drop_limit such passes the gate forces a blacklist without further
    retries."""
    occ_box = {"occ": _band_world()}
    nav = StubNav()

    def oracle(xy, yaw, exhaustive):
        return 100.0 if exhaustive else 0.0

    cfg = _cfg(threshold=5.0, number_retries=2)
    srv = _server(cfg, occ_box, nav, fi_oracle=oracle)
    goal = np.array([0.0, 5.0])

    for cycle in range(cfg.exploration_bt.fi_drop_limit):
        assert not srv._fi_gate(np.zeros(2), 0.0, goal)  # unsafe, escalate
        assert srv._fi_exhaustive_retry
        assert srv._fi_gate(np.zeros(2), 0.0, goal)      # passes exhaustively
        assert srv._fi_drop_count == cycle + 1
        srv.state = ExplorationState.EXPLORING

    # pattern found: the next gate call forces the blacklist at once
    assert not srv._fi_gate(np.zeros(2), 0.0, goal)
    assert len(srv.blacklist_xy) == 1
    assert srv.state == ExplorationState.RECOVERING
    assert srv._fi_drop_count == 0


def test_gate_uses_path_safety_when_enabled():
    """With check_path_safety on, a pose that is safe where the robot looks
    but unsafe toward the goal segment is rejected by the gate."""
    occ_box = {"occ": _band_world()}

    def oracle(xy, yaw, exhaustive):
        # information along the robot's heading (0), none toward the goal (pi/2)
        return 100.0 if abs(yaw) < 0.1 else 0.0

    goal = np.array([0.0, 5.0])   # heading pi/2 from the origin
    for check, expect_pass in ((False, True), (True, False)):
        nav = StubNav()
        srv = _server(_cfg(threshold=5.0, check_path_safety=check), occ_box, nav,
                      fi_oracle=oracle)
        srv.trailing_poses = [np.array([0.0, 0.0, math.pi / 2])]  # overlap
        assert srv._fi_gate(np.zeros(2), 0.0, goal) is expect_pass


def test_path_safety_fov_overlap():
    """A segment heading that overlaps a trailing pose's heading triggers the
    pose-pair FI check; no overlap -> UNDETERMINED."""
    occ_box = {"occ": _band_world()}
    nav = StubNav()

    def oracle(xy, yaw, exhaustive):
        return 0.0  # the pair check says unsafe

    srv = _server(_cfg(threshold=5.0, angle_fov_overlap_rad=0.3), occ_box, nav,
                  fi_oracle=oracle)
    goal = np.array([5.0, 0.0])  # heading 0 from the origin
    # trailing pose looking the same way -> overlap -> UNSAFE
    srv.trailing_poses = [np.array([0.0, 0.0, 0.1])]
    assert srv._path_safety(np.zeros(2), goal) == PathSafety.UNSAFE
    # trailing pose looking away -> no overlap -> UNDETERMINED
    srv.trailing_poses = [np.array([0.0, 0.0, math.pi])]
    assert srv._path_safety(np.zeros(2), goal) == PathSafety.UNDETERMINED
