"""The port's counterpart of ``tests/test_path_follow.py``: the exploration
server publishes its line-of-sight-refined plan, and with
``planner="roadmap"`` the rover follows it; on the CPU with the reference's
assertions."""

import dataclasses

import numpy as np
import torch

from fitslam_tpu_torch.models import sim_robot as simr
from fitslam_tpu_torch.models.exploration import ExplorationServer, ExplorationState
from fitslam_tpu_torch.models.sim_nav import SimNavInterface
from fitslam_tpu_torch.ops import grid as gr
from fitslam_tpu_torch.utils.config import FitSlamConfig

# several pytest-xdist workers share the machine
torch.set_num_threads(2)

CPU = "cpu"
SPEC = gr.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)


def _cfg(planner):
    cfg = FitSlamConfig()
    return dataclasses.replace(
        cfg,
        nav=dataclasses.replace(cfg.nav, planner=planner, wavefront_iters=192, desired_speed=0.8),
        frontier_search=dataclasses.replace(cfg.frontier_search, search_radius_m=10.0,
                                            max_frontiers=64),
        fisher_information=dataclasses.replace(cfg.fisher_information, enabled=False),
        exploration_bt=dataclasses.replace(cfg.exploration_bt, bootstrap_enabled=False),
    )


def _run(planner, steps=120):
    """Rooms world, sensor-revealed occupancy, the server drives the rover."""
    cfg = _cfg(planner)
    gt = torch.from_numpy(simr.make_rooms_world(SPEC, seed=4))
    state = {"occ": torch.full((SPEC.size, SPEC.size), gr.UNKNOWN, dtype=torch.uint8)}
    robot = simr.DiffDriveRobot(x=-5.0, y=-5.0, yaw=0.5, v_max=1.0, w_max=2.0)
    nav = SimNavInterface(cfg, SPEC, robot, lambda: state["occ"], dt=0.12, device=CPU)
    srv = ExplorationServer(cfg, SPEC, get_occupancy=lambda: state["occ"], nav=nav,
                            get_robot_pose=lambda: (robot.xy, robot.yaw), device=CPU)
    published = []
    for step in range(steps):
        state["occ"] = simr.reveal_sensor(SPEC, gt, state["occ"],
                                          torch.tensor(robot.xy, dtype=torch.float32),
                                          range_m=3.0)
        if step % 3 == 0:
            srv.tick()
            if srv.published_path is not None and len(srv.published_path) >= 2:
                published.append(np.array(srv.published_path))
        for _ in range(2):
            nav.step()
        if srv.state == ExplorationState.DONE:
            break
    traj = np.array([(x, y) for x, y, _ in robot.trajectory])
    return srv, nav, traj, published


def _dist_to_polyline(p, poly):
    best = np.inf
    for a, b in zip(poly[:-1], poly[1:]):
        ab = b - a
        t = np.clip(np.dot(p - a, ab) / max(np.dot(ab, ab), 1e-9), 0.0, 1.0)
        best = min(best, float(np.linalg.norm(p - (a + t * ab))))
    return best


def test_server_publishes_refined_path():
    srv, nav, traj, published = _run("wavefront")
    assert published, "no plan ever published"
    # every published plan starts at the robot and ends at the active goal
    for plan in published[:5]:
        assert plan.shape[1] == 2 and len(plan) >= 2


def test_roadmap_mode_follows_published_plan():
    """With planner='roadmap' the rover tracks the published plan: each
    driven pose stays close to a published polyline."""
    srv, nav, traj, published = _run("roadmap")
    assert published, "no plan ever published"
    assert srv.diag.goals_sent >= 1
    # the robot moved and its driven path hugs the published polylines
    # (plans update as the robot advances, so the nearest plan counts)
    assert np.ptp(traj[:, 0]) + np.ptp(traj[:, 1]) > 1.5
    sampled = traj[:: max(1, len(traj) // 40)]
    devs = [min(_dist_to_polyline(p, plan) for plan in published) for p in sampled]
    assert float(np.median(devs)) < 0.6, float(np.median(devs))
    assert float(np.max(devs)) < 2.0, float(np.max(devs))
