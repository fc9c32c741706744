"""The port's rapid-exploration slice on the CPU: one ExplorationServer tick
against the reference's on the same state (the roadmap carried across
through interop), and the whole loop of tests/test_exploration_e2e.py
(reveal sensor, frontier tick loop, wavefront planner and controller).

Bounds: a single tick gives the same goal, heading (to 1e-6) and frontier
count as the reference. The whole loop is held to test_exploration_e2e.py's
bounds, not to per-step equality: over hundreds of steps a one-cell
difference in a float32 sample position compounds (ROADMAP fault F5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitslam_tpu.models import exploration as jex
from fitslam_tpu.models import sim_robot as jsim
from fitslam_tpu.models.sim_nav import SimNavInterface as JSimNav
from fitslam_tpu.ops import grid as jgrid
from fitslam_tpu.utils.config import FitSlamConfig as JConfig
from fitslam_tpu_torch.models import exploration as tex
from fitslam_tpu_torch.models import sim_robot as tsim
from fitslam_tpu_torch.models.sim_nav import SimNavInterface
from fitslam_tpu_torch.ops import grid as tgrid
from fitslam_tpu_torch.utils import interop
from fitslam_tpu_torch.utils.config import FitSlamConfig
from fitslam_tpu_torch.utils.evaluation import coverage_fraction

# several pytest-xdist workers share the machine: torch's default of one
# intra-op thread per core would oversubscribe it
torch.set_num_threads(2)

SPEC = tgrid.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)
JSPEC = jgrid.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)


def _test_config(cls):
    """tests/test_exploration_e2e.py's configuration."""
    cfg = cls()
    return dataclasses.replace(
        cfg,
        frontier_search=dataclasses.replace(cfg.frontier_search, search_radius_m=6.0,
                                            max_frontiers=64),
        roadmap=dataclasses.replace(cfg.roadmap, max_nodes=256, cleanup_period_s=5.0),
        nav=dataclasses.replace(cfg.nav, wavefront_iters=192, desired_speed=0.8),
        exploration_bt=dataclasses.replace(cfg.exploration_bt, nav2_goal_timeout_s=30.0),
        fisher_information=dataclasses.replace(cfg.fisher_information, enabled=False),
    )


def _recording_nav(module):
    class RecordingNav(module.NavInterface):
        def __init__(self):
            self.sent = []
            self.paths = []
            self._status = module.GoalStatus.NONE

        def send_goal(self, goal_xy, heading):
            self.sent.append((np.asarray(goal_xy, np.float64), float(heading)))
            self._status = module.GoalStatus.ACTIVE

        def cancel(self):
            self._status = module.GoalStatus.NONE

        def status(self):
            return self._status

        def set_path(self, path):
            self.paths.append(np.asarray(path))

    return RecordingNav()


@pytest.fixture(scope="module")
def reference_state():
    """The reference's loop run for 40 steps: its explored map, robot and
    server (roadmap, blacklist, goal) as the state both ticks start from."""
    cfg = _test_config(JConfig)
    gt = jnp.asarray(jsim.make_rooms_world(JSPEC, seed=1))
    state = {"explored": jnp.full((64, 64), jgrid.UNKNOWN, jnp.uint8)}
    robot = jsim.DiffDriveRobot(x=-5.0, y=-5.0, yaw=0.0, v_max=1.2, w_max=2.5)
    nav = JSimNav(cfg, JSPEC, robot, lambda: state["explored"], dt=0.15)
    nav.controller.max_omega = 2.0
    server = jex.ExplorationServer(cfg, JSPEC, lambda: state["explored"], nav,
                                   get_robot_pose=lambda: (robot.xy, robot.yaw))
    for step in range(40):
        state["explored"] = jsim.reveal_sensor(JSPEC, gt, state["explored"],
                                               jnp.asarray(robot.xy, jnp.float32), range_m=3.0)
        if step % 2 == 0:
            server.tick()
        for _ in range(4):
            nav.step()
    return np.asarray(state["explored"]), robot, server


@pytest.mark.parametrize("with_goal", [False, True])
def test_one_tick_equals_reference(reference_state, with_goal):
    explored, robot, ref_server = reference_state
    pose = (robot.xy.copy(), robot.yaw)
    navs = (_recording_nav(jex), _recording_nav(tex))
    jserver = jex.ExplorationServer(_test_config(JConfig), JSPEC, lambda: jnp.asarray(explored),
                                    navs[0], get_robot_pose=lambda: pose)
    occ_t = torch.tensor(explored)
    tserver = tex.ExplorationServer(_test_config(FitSlamConfig), SPEC, lambda: occ_t, navs[1],
                                    get_robot_pose=lambda: pose, device="cpu")
    for s, nav in zip((jserver, tserver), navs):
        s.blacklist_xy = list(ref_server.blacklist_xy)
        s.diag.ticks = ref_server.diag.ticks
        # pin the wall-clock CleanupRoadmap branch: both take the same one
        s._last_cleanup = 1e18
        if with_goal:
            s._goal_xy = np.array([-1.875, -4.125])
            nav.send_goal(s._goal_xy, 0.5)
            nav.sent.clear()
    jserver.roadmap = ref_server.roadmap
    tserver.roadmap = interop.to_torch(jax.tree.map(np.asarray, ref_server.roadmap))
    assert int(tserver.roadmap.n_nodes) > 3
    jserver.tick()
    tserver.tick()
    assert tserver.diag.frontiers_found == jserver.diag.frontiers_found > 0
    assert tserver.diag.goals_sent == jserver.diag.goals_sent
    assert len(navs[1].sent) == len(navs[0].sent)
    for (gt_, ht), (gj, hj) in zip(navs[1].sent, navs[0].sent):
        np.testing.assert_array_equal(gt_, gj)
        assert abs(ht - hj) <= 1e-6
    if not with_goal:
        assert len(navs[0].sent) == 1
    for pt, pj in zip(navs[1].paths, navs[0].paths):
        np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tserver.roadmap.adj.numpy(), np.asarray(jserver.roadmap.adj))
    # the tick read back at most the reference's three points
    assert 1 <= tserver.host_syncs <= 3


def _peer_servers(explored, pose, peers):
    """A reference and a port server, fresh, on one explored map and pose,
    with ``peers`` as their peers' goals (the multi-robot goal-sharing
    seam)."""
    navs = (_recording_nav(jex), _recording_nav(tex))
    jserver = jex.ExplorationServer(_test_config(JConfig), JSPEC, lambda: jnp.asarray(explored),
                                    navs[0], get_robot_pose=lambda: pose,
                                    peer_goals=lambda: list(peers))
    occ_t = torch.tensor(explored)
    tserver = tex.ExplorationServer(_test_config(FitSlamConfig), SPEC, lambda: occ_t, navs[1],
                                    get_robot_pose=lambda: pose, device="cpu",
                                    peer_goals=lambda: list(peers))
    for srv in (jserver, tserver):
        srv._last_cleanup = 1e18
    return jserver, tserver, navs


def test_peer_goals_seam_equals_reference():
    """A peer's goal on the frontier the tick would pick: both packages mask
    the same frontiers and send the robot to the same other goal."""
    from fitslam_tpu.ops import frontier as jfx

    gt = jnp.asarray(jsim.make_rooms_world(JSPEC, seed=1))
    explored = jnp.full((64, 64), jgrid.UNKNOWN, jnp.uint8)
    for xy in ([-5.0, -5.0], [-3.0, -4.0]):
        explored = jsim.reveal_sensor(JSPEC, gt, explored, jnp.asarray(xy, jnp.float32),
                                      range_m=3.0)
    explored = np.asarray(explored)
    pose = (np.array([-4.0, -4.5]), 0.3)
    jserver, tserver, navs = _peer_servers(explored, pose, [])
    jserver.tick()
    tserver.tick()
    best = navs[0].sent[0][0]
    np.testing.assert_array_equal(navs[1].sent[0][0], best)

    peers = [best.copy(), None, np.array([4.2, -3.1])]
    jserver, tserver, navs = _peer_servers(explored, pose, peers)
    fr = jfx.extract_frontiers(JSPEC, jnp.asarray(explored), jnp.zeros(2), jnp.float32(16.0),
                               max_cells=4096, max_frontiers=64)
    mask_j = np.asarray(jserver._blacklist_mask(fr))
    mask_t = tserver._blacklist_mask(interop.to_torch(jax.tree.map(np.asarray, fr))).numpy()
    np.testing.assert_array_equal(mask_t, mask_j)
    assert mask_j.sum() >= 1
    jserver.tick()
    tserver.tick()
    assert tserver.diag.frontiers_found == jserver.diag.frontiers_found
    assert len(navs[0].sent) == len(navs[1].sent) == 1
    np.testing.assert_array_equal(navs[1].sent[0][0], navs[0].sent[0][0])
    assert abs(navs[1].sent[0][1] - navs[0].sent[0][1]) <= 1e-6
    assert np.linalg.norm(navs[0].sent[0][0] - best) > 0.5


@pytest.fixture(scope="module")
def exploration_run():
    """tests/test_exploration_e2e.py's loop, through the port."""
    cfg = _test_config(FitSlamConfig)
    gt = torch.tensor(tsim.make_rooms_world(SPEC, seed=1))
    state = {"explored": torch.full((64, 64), tgrid.UNKNOWN, dtype=torch.uint8)}
    robot = tsim.DiffDriveRobot(x=-5.0, y=-5.0, yaw=0.0, v_max=1.2, w_max=2.5)
    nav = SimNavInterface(cfg, SPEC, robot, lambda: state["explored"], dt=0.15, device="cpu")
    nav.controller.max_omega = 2.0
    server = tex.ExplorationServer(cfg, SPEC, lambda: state["explored"], nav,
                                   get_robot_pose=lambda: (robot.xy, robot.yaw), device="cpu")
    coverage = []
    for step in range(300):
        state["explored"] = tsim.reveal_sensor(
            SPEC, gt, state["explored"], torch.tensor(robot.xy, dtype=torch.float32),
            range_m=3.0)
        if step % 2 == 0:
            if server.tick() == tex.ExplorationState.DONE:
                break
        for _ in range(4):  # controller at ~4x the sensor/tick rate
            nav.step()
        coverage.append(coverage_fraction(state["explored"].numpy() != tgrid.UNKNOWN))
    return server, nav, robot, coverage, state["explored"].numpy(), gt.numpy()


def test_loop_coverage_grows(exploration_run):
    server, nav, robot, coverage, explored, gt = exploration_run
    assert coverage[-1] > 0.5, f"final coverage {coverage[-1]:.2f}"
    assert coverage[-1] > coverage[10] + 0.2


def test_loop_robot_moved_between_rooms(exploration_run):
    server, nav, robot, coverage, explored, gt = exploration_run
    traj = np.array([(x, y) for x, y, _ in robot.trajectory])
    assert np.ptp(traj[:, 0]) > 3.0
    assert server.diag.goals_sent >= 2


def test_loop_explored_matches_ground_truth(exploration_run):
    server, nav, robot, coverage, explored, gt = exploration_run
    known = explored != tgrid.UNKNOWN
    assert (explored[known] == gt[known]).mean() > 0.97


def test_loop_diagnostics_and_host_reads(exploration_run):
    server, nav, robot, coverage, explored, gt = exploration_run
    assert server.diag.ticks > 10
    assert server.diag.frontiers_found >= 0
    assert int(server.roadmap.n_nodes) > 3
    # reads only at the reference's points: <= 3 per tick, one per plan,
    # at most one per map update for each costmap mirror
    assert server.host_syncs <= 3 * server.diag.ticks
    assert nav.plans > 10
    assert nav.local_costmap.host_syncs <= 300 and nav.global_costmap.host_syncs == 0
    assert nav.host_syncs == nav.plans + nav.local_costmap.host_syncs


def test_initialization_sequence_bootstrap():
    """With bootstrap enabled the server drives a forward leg then a full
    spin open-loop before dispatching any goal (the reference's test)."""
    import math

    cfg = FitSlamConfig()
    cfg = dataclasses.replace(
        cfg,
        exploration_bt=dataclasses.replace(
            cfg.exploration_bt, bootstrap_enabled=True, bootstrap_forward_s=0.5,
            bootstrap_spin_rate=2.0, tick_dt_s=0.1),
        fisher_information=dataclasses.replace(cfg.fisher_information, enabled=False),
    )
    gt = torch.tensor(tsim.make_rooms_world(SPEC, seed=1))
    state = {"explored": torch.full((64, 64), tgrid.UNKNOWN, dtype=torch.uint8)}
    robot = tsim.DiffDriveRobot(x=-5.0, y=-5.0, yaw=0.0, v_max=1.0, w_max=3.0)
    nav = SimNavInterface(cfg, SPEC, robot, lambda: state["explored"], dt=0.1, device="cpu")
    server = tex.ExplorationServer(cfg, SPEC, lambda: state["explored"], nav,
                                   get_robot_pose=lambda: (robot.xy, robot.yaw), device="cpu")
    assert server.state == tex.ExplorationState.INITIALIZING
    spun, last, steps_in_init = 0.0, robot.yaw, 0
    for _ in range(200):
        state["explored"] = tsim.reveal_sensor(
            SPEC, gt, state["explored"], torch.tensor(robot.xy, dtype=torch.float32), range_m=3.0)
        st = server.tick()
        d = (robot.yaw - last + math.pi) % (2 * math.pi) - math.pi
        spun += abs(d)
        last = robot.yaw
        if st != tex.ExplorationState.INITIALIZING:
            break
        steps_in_init += 1
    assert steps_in_init >= 5
    assert robot.x > -5.0 + 0.05
    assert spun > 2 * math.pi * 0.8
    assert server.diag.goals_sent == 0


def test_fi_ladder_and_recovery_follow_the_reference():
    """The FI retry ladder with a failing oracle: the same rejections,
    blacklist, aged wedge and recovery moves as the reference."""
    explored = np.full((64, 64), jgrid.UNKNOWN, np.uint8)
    explored[16:40, 8:30] = 0
    explored[16:40, 30] = jgrid.LETHAL
    pose = (np.array([-3.0, -1.0]), 0.4)
    runs = []
    for mod, cfg_cls, spec, wrap in ((jex, JConfig, JSPEC, jnp.asarray),
                                      (tex, FitSlamConfig, SPEC, torch.tensor)):
        cfg = _test_config(cfg_cls)
        cfg = dataclasses.replace(cfg, fisher_information=dataclasses.replace(
            cfg.fisher_information, enabled=True))
        nav = _recording_nav(mod)
        nav.drive_open_loop = lambda v, w, nav=nav: nav.paths.append(np.array([v, w]))
        occ = wrap(explored)
        server = mod.ExplorationServer(cfg, spec, lambda occ=occ: occ, nav,
                                       get_robot_pose=lambda: pose,
                                       fi_oracle=lambda xy, yaw, exhaustive: 10.0,
                                       **({} if mod is jex else {"device": "cpu"}))
        server._last_cleanup = 1e18
        states = [server.tick().name for _ in range(8)]
        wedge = np.asarray(server.wedge_age) if mod is jex else server.wedge_age.numpy()
        runs.append((states, server.diag.fi_rejections, server.diag.recoveries,
                     [c.tolist() for c in server.blacklist_xy], wedge,
                     [p.tolist() for p in nav.paths]))
    (sj, rj, cj, bj, wj, pj), (st, rt, ct, bt, wt, pt) = runs
    assert st == sj and rt == rj > 0 and ct == cj > 0 and bt == bj
    np.testing.assert_array_equal(wt, wj)
    assert pt == pj


def test_path_information_branch_matches_reference(monkeypatch):
    """The fisher_information_in_path branch: one tick with
    min_path_information > 0 and a landmark map west of the robot gives the
    reference's path information per frontier (within 1e-5 relative), the
    same achievable frontiers and the same goal."""
    occ = np.full((64, 64), jgrid.UNKNOWN, np.uint8)
    occ[20:40, 20:40] = 0
    rng = np.random.RandomState(11)
    lm = (np.c_[rng.uniform(-7.0, -3.5, 300), rng.uniform(-3.0, 3.0, 300)].astype(np.float32),
          rng.uniform(1.0, 30.0, 300).astype(np.float32), rng.rand(300) < 0.9)
    runs = []
    for mod, cfg_cls, spec, wrap in ((jex, JConfig, JSPEC, jnp.asarray),
                                      (tex, FitSlamConfig, SPEC, torch.tensor)):
        cfg = _test_config(cfg_cls)
        cfg = dataclasses.replace(cfg, fisher_information=dataclasses.replace(
            cfg.fisher_information, enabled=True, min_path_information=1.0))
        seen = []
        real = mod.fisher.path_information

        def recording(*a, real=real, seen=seen, **kw):
            out = real(*a, **kw)
            seen.append((np.asarray(a[4]), np.asarray(a[5]), np.asarray(out)))
            return out

        monkeypatch.setattr(mod.fisher, "path_information", recording)
        nav = _recording_nav(mod)
        grid = wrap(occ)
        server = mod.ExplorationServer(cfg, spec, lambda grid=grid: grid, nav,
                                       get_robot_pose=lambda: (np.array([0.0, 0.0]), 0.0),
                                       get_landmarks=lambda: lm,
                                       **({} if mod is jex else {"device": "cpu"}))
        server._last_cleanup = 1e18
        server.tick()
        assert len(seen) == 1
        runs.append((seen[0], nav.sent, server.diag.frontiers_found))
    ((gj, vj, fj), sent_j, nj), ((gt_, vt, ft), sent_t, nt) = runs
    assert nt == nj > 3
    np.testing.assert_array_equal(gt_, gj)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(ft, fj, rtol=1e-5, atol=1e-6)
    achievable = vj & (fj >= 1.0)
    np.testing.assert_array_equal(vt & (ft >= 1.0), achievable)
    assert 0 < achievable.sum() < vj.sum()
    assert len(sent_t) == len(sent_j) == 1
    np.testing.assert_array_equal(sent_t[0][0], sent_j[0][0])
    assert sent_t[0][0][0] < -2.0      # the goal lies on the landmark-rich side
