"""A short two-rover run of the multi-robot active SLAM through both packages
on the CPU: examples/run_multirobot_slam.py's rovers (each a full
ActiveSlamSystem, peers' goals through ``peer_goals``) for 24 frames, both on
the simulation's clock (0.15 s a step), as the port's ``run_fleet`` runs.

Tolerances: each rover's keyframe count equal, its SLAM trajectory and
final position within 1e-3 m, and its first goal exactly equal (frontier
goals are cell centres).
"""

import sys
from dataclasses import dataclass
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fitslam_tpu.models.sim_nav import SimNavInterface as JNav
from fitslam_tpu.utils.profiling import EventLogger
from fitslam_tpu_torch.models.sim_nav import SimNavInterface
from fitslam_tpu_torch.run_multirobot_slam import DT, STARTS, TICK_EVERY, run_fleet

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

import run_multirobot_slam as ref  # noqa: E402

torch.set_num_threads(2)

FRAMES = 24


@dataclass
class _RefClock(EventLogger):
    """The reference's EventLogger on the simulation's clock."""

    sim_s: float = 0.0

    def time_since_start(self) -> float:
        return self.sim_s


def _ref_fleet(n_robots, steps):
    """examples/run_multirobot_slam.py's run_fleet loop, each rover's
    scheduling timer on the simulation's clock."""
    from fitslam_tpu.data import synthetic
    from fitslam_tpu.models import sim_robot as simr
    from fitslam_tpu.models.active_slam import camera_pose_from_robot
    from fitslam_tpu.ops import grid as gr
    from fitslam_tpu.ops.geometry import Intrinsics

    spec = gr.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)
    W, H = 320, 240
    cfg = ref.fleet_cfg(W, H)
    K = Intrinsics.from_config(cfg.camera)
    world3d = synthetic.world_from_occupancy(
        simr.make_rooms_world(spec, seed=3), spec, jax.random.PRNGKey(5), wall_height=2.0,
        points_per_wall_cell=4, floor_points=4000)
    fleet, clocks = [], []

    def peers_of(i):
        def get():
            return [fleet[j][2].explorer._goal_xy for j in range(len(fleet)) if j != i]
        return get

    for i in range(n_robots):
        robot, nav, system = ref.build_rover(cfg, spec, world3d, STARTS[i], peers_of(i))
        clocks.append(_RefClock())
        system.explorer.log = clocks[i]
        fleet.append((robot, nav, system))
    for step in range(steps):
        for i, (robot, nav, system) in enumerate(fleet):
            cam = camera_pose_from_robot(robot.x, robot.y, robot.yaw)
            if step == 0:
                system.set_world_anchor(cam)
            left, right = synthetic.render_stereo(K, world3d, cam, width=W, height=H,
                                                  max_depth=12.0)
            cloud, cvalid = synthetic.frustum_cloud(
                K, world3d, cam, max_points=cfg.traversability.max_points_per_cloud,
                max_depth=8.0, width=W, height=H)
            system.process_frame(left, right, cloud, cvalid)
            if step % TICK_EVERY == TICK_EVERY - 1:
                system.tick_exploration()
            nav.step()
            clocks[i].sim_s += DT
    return fleet


def _goal_recorder(monkeypatch, cls):
    """{nav id: [goals sent]} through the nav class's ``send_goal``."""
    sent = {}
    real = cls.send_goal

    def send_goal(nav, goal_xy, heading):
        sent.setdefault(id(nav), []).append(np.asarray(goal_xy, np.float64).copy())
        return real(nav, goal_xy, heading)

    monkeypatch.setattr(cls, "send_goal", send_goal)
    return sent


@pytest.fixture(scope="module")
def both_fleets():
    mp = pytest.MonkeyPatch()
    try:
        sent_t = _goal_recorder(mp, SimNavInterface)
        sent_j = _goal_recorder(mp, JNav)
        port, _ = run_fleet(2, FRAMES, verbose=False, device="cpu")
        refs = _ref_fleet(2, FRAMES)
    finally:
        mp.undo()
    return port, sent_t, refs, sent_j


def test_two_rover_fleet_equals_reference(both_fleets):
    port, sent_t, refs, sent_j = both_fleets
    for i, ((rt, nt, st), (rj, nj, sj)) in enumerate(zip(port, refs)):
        assert int(st.slam.map.n_kf) == int(sj.slam.map.n_kf), f"rover {i} keyframes"
        assert len(st.slam.trajectory) == len(sj.slam.trajectory)
        for Tt, Tj in zip(st.slam.trajectory, sj.slam.trajectory):
            np.testing.assert_allclose(Tt[:3, 3], Tj[:3, 3], rtol=0, atol=1e-3)
        np.testing.assert_allclose([rt.x, rt.y], [rj.x, rj.y], rtol=0, atol=1e-3)
        goals_t, goals_j = sent_t.get(id(nt), []), sent_j.get(id(nj), [])
        assert goals_t and goals_j, f"rover {i} sent no goal"
        np.testing.assert_array_equal(goals_t[0], goals_j[0])


def test_peer_goals_reach_each_rover(both_fleets):
    """Each rover's peers' goal reaches its exploration server: the peer's
    current goal is what ``peer_goals`` returns, in both packages."""
    port, _, refs, _ = both_fleets
    for fleet in (port, refs):
        for i, (_, _, system) in enumerate(fleet):
            peers = system.explorer.peer_goals()
            other = fleet[1 - i][2].explorer._goal_xy
            assert len(peers) == 1
            np.testing.assert_array_equal(np.asarray(peers[0]), np.asarray(other))
