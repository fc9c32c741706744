"""The dual EKF in the port's active-SLAM loop on the CPU: the three tests of
``tests/test_ekf_integration.py`` through ``ActiveSlamSystem`` with
``cfg.localization.enabled``, with that file's configuration (320x240) and
bounds, each beside the reference's own value on the same scenario; the
engine's relocalization setting on either path; and the first SLAM fix
seeding both filters, beside the reference.

The world is ``world_from_occupancy`` of the rooms world of seed 3 with the
seed the reference derives for ``PRNGKey(5)`` (359975681). The loops are
held to the reference file's bounds, not to per-frame equality (ROADMAP F5);
the first fix (the SLAM pose of the anchored first frame) is held to the
reference's within 1e-5, the odometry and IMU rows the filters buffer
exactly, and the later SLAM pose rows within 5e-3 m / rad (the frame
step's pose in two frameworks).
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from fitslam_tpu.data import synthetic as jsyn
from fitslam_tpu.models import sim_robot as jsim
from fitslam_tpu.models.active_slam import ActiveSlamSystem as JActive
from fitslam_tpu.models.active_slam import camera_pose_from_robot as jcam
from fitslam_tpu.models.localization import TwistMux as JTwistMux
from fitslam_tpu.models.sim_nav import SimNavInterface as JNav
from fitslam_tpu.ops import grid as jg
from fitslam_tpu.ops.geometry import Intrinsics as JK
from fitslam_tpu.utils.config import FitSlamConfig as JConfig
from fitslam_tpu_torch.data import synthetic as tsyn
from fitslam_tpu_torch.models import sim_robot as tsim
from fitslam_tpu_torch.models.active_slam import ActiveSlamSystem, camera_pose_from_robot
from fitslam_tpu_torch.models.localization import DualEkf, TwistMux
from fitslam_tpu_torch.models.sim_nav import SimNavInterface
from fitslam_tpu_torch.ops import grid as tg
from fitslam_tpu_torch.ops.geometry import Intrinsics
from fitslam_tpu_torch.utils.config import FitSlamConfig

torch.set_num_threads(2)

W, H = 320, 240
# a SLAM pose row's (x, y, yaw) beside the reference's: the frame step's pose
# in two frameworks on renders that agree to 1e-3 grey levels (m, rad)
POSE_ROW_TOL = 5e-3


def _cfg(cls, ekf=True, reloc=None):
    """tests/test_ekf_integration.py's configuration."""
    cfg = cls()
    R = dataclasses.replace
    cfg = R(
        cfg,
        camera=R(cfg.camera, width=W, height=H, fx=200.0, fy=200.0, cx=W / 2, cy=H / 2,
                 baseline=0.2),
        orb=R(cfg.orb, num_features=320, num_levels=2, fast_threshold=12.0),
        tracking=R(cfg.tracking, min_inliers=10, keyframe_min_interval=2,
                   keyframe_translation=0.25),
        mapping=R(cfg.mapping, max_keyframes=32, max_landmarks=2048, max_observations=6144,
                  local_window=4, ba_iters=3),
        loop=R(cfg.loop, enabled=False),
        traversability=R(cfg.traversability, max_points_per_cloud=4096, max_clouds=32),
        localization=R(cfg.localization, enabled=ekf),
        fisher_information=R(cfg.fisher_information, enabled=False),
    )
    if reloc is not None:
        cfg = R(cfg, tracking=R(cfg.tracking, reloc_enabled=reloc))
    return cfg


class _Port:
    """The port's system of tests/test_ekf_integration.py::_make_system."""

    def __init__(self, ekf=True, reloc=None):
        spec = tg.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)
        self.cfg = _cfg(FitSlamConfig, ekf, reloc)
        self.K = Intrinsics.from_config(self.cfg.camera, "cpu")
        self.world = tsyn.world_from_occupancy(
            tsim.make_rooms_world(spec, seed=3), spec, tsyn.ROOMS_WORLD_SEED,
            wall_height=2.0, points_per_wall_cell=4, floor_points=3000, device="cpu")
        self.robot = tsim.DiffDriveRobot(x=-5.0, y=-5.0, yaw=0.2, v_max=0.8, w_max=1.0)
        box = {}
        self.nav = SimNavInterface(self.cfg, spec, self.robot, lambda: box["s"].occupancy(),
                                   dt=0.15, twist_mux=TwistMux(), device="cpu")
        self.system = ActiveSlamSystem(self.cfg, spec, self.nav,
                                       get_robot_pose=lambda: box["s"].estimated_robot_pose(),
                                       device="cpu")
        box["s"] = self.system

    def frame(self, step):
        r = self.robot
        cam = camera_pose_from_robot(r.x, r.y, r.yaw, device="cpu")
        if step == 0:
            self.system.set_world_anchor(cam)
        left, right = tsyn.render_stereo(self.K, self.world.landmarks, cam, width=W, height=H,
                                         max_depth=12.0)
        return self.system.process_frame(left, right)


class _Ref(_Port):
    """The reference's system, the same scenario."""

    def __init__(self, ekf=True, reloc=None):
        spec = jg.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)
        self.cfg = _cfg(JConfig, ekf, reloc)
        self.K = JK.from_config(self.cfg.camera)
        self.world = jsyn.world_from_occupancy(
            jsim.make_rooms_world(spec, seed=3), spec, jax.random.PRNGKey(5),
            wall_height=2.0, points_per_wall_cell=4, floor_points=3000)
        self.robot = jsim.DiffDriveRobot(x=-5.0, y=-5.0, yaw=0.2, v_max=0.8, w_max=1.0)
        box = {}
        self.nav = JNav(self.cfg, spec, self.robot, lambda: box["s"].occupancy(), dt=0.15,
                        twist_mux=JTwistMux())
        self.system = JActive(self.cfg, spec, self.nav,
                              get_robot_pose=lambda: box["s"].estimated_robot_pose())
        box["s"] = self.system

    def frame(self, step):
        r = self.robot
        cam = jcam(r.x, r.y, r.yaw)
        if step == 0:
            self.system.set_world_anchor(cam)
        left, right = jsyn.render_stereo(self.K, self.world, cam, width=W, height=H,
                                         max_depth=12.0)
        return self.system.process_frame(left, right)


def _track(sim):
    """test_ekf_pose_source_tracks_ground_truth's drive: 30 frames, a gentle
    arc. Returns (mean error from frame 5 on, final yaw error)."""
    errs = []
    for step in range(30):
        sim.frame(step)
        sim.nav.drive_open_loop(0.5, 0.12)
        xy, yaw = sim.system.estimated_robot_pose()
        errs.append(np.linalg.norm(xy - sim.robot.xy))
    dyaw = (yaw - sim.robot.yaw + math.pi) % (2 * math.pi) - math.pi
    return float(np.mean(errs[5:])), abs(dyaw)


def _dropout(sim):
    """test_ekf_dead_reckons_through_slam_dropout's drive: 12 frames, then
    15 controller steps with no frame. Returns (error before, error after,
    distance the estimate moved)."""
    for step in range(12):
        sim.frame(step)
        sim.nav.drive_open_loop(0.5, 0.0)
    xy0, _ = sim.system.estimated_robot_pose()
    err0 = np.linalg.norm(xy0 - sim.robot.xy)
    for _ in range(15):
        sim.nav.drive_open_loop(0.5, 0.05)
    xy1, _ = sim.system.estimated_robot_pose()
    return float(err0), float(np.linalg.norm(xy1 - sim.robot.xy)), float(np.linalg.norm(xy1 - xy0))


def test_ekf_pose_source_tracks_ground_truth():
    port = _Port()
    assert isinstance(port.system.ekf, DualEkf)
    assert port.nav.on_cmd == port.system.observe_odometry   # odometry wired
    err, dyaw = _track(port)
    ref_err, ref_dyaw = _track(_Ref())
    print(f"EKF pose error from frame 5: port {err:.4f} m, reference {ref_err:.4f} m; final yaw "
          f"error port {dyaw:.4f} rad, reference {ref_dyaw:.4f} rad")
    assert err < 0.30, f"mean EKF pose error {err:.3f}"
    assert dyaw < 0.3
    ekf = port.system.ekf
    # one flush a frame (an input arrived each time), one read each
    assert ekf.flushes == 30 and ekf.host_syncs == 30


def test_ekf_dead_reckons_through_slam_dropout():
    err0, err1, moved = _dropout(_Port())
    ref = _dropout(_Ref())
    print(f"dropout: port before {err0:.4f} m, after {err1:.4f} m, moved {moved:.3f} m; "
          f"reference {ref[0]:.4f} / {ref[1]:.4f} / {ref[2]:.3f}")
    assert err1 < err0 + 0.35, f"dropout error {err1:.3f} vs pre {err0:.3f}"
    assert moved > 0.5


def test_twist_mux_priority_preempts_navigation():
    port = _Port(ekf=False)
    nav, robot = port.nav, port.robot
    assert port.system.ekf is None and nav.on_cmd is None
    nav.drive_open_loop(0.4, 0.0)
    assert robot.last_twist[0] > 0.3
    nav.twist_mux.push("joystick", 0.0, 0.0)
    nav.drive_open_loop(0.4, 0.0)
    assert robot.last_twist[0] == 0.0


@pytest.mark.parametrize("ekf,reloc", [(True, None), (True, False), (False, None)])
def test_engine_relocalization_follows_the_path(ekf, reloc):
    """With the EKF on, the engine runs the synchronous step and keeps the
    config's relocalization (the reference builds it from the unchanged
    config); with it off, the asynchronous step never relocalizes, so the
    engine runs with it forced off."""
    port = _Port(ekf=ekf, reloc=reloc)
    expected = port.cfg.tracking.reloc_enabled if ekf else False
    assert port.system.slam.cfg.tracking.reloc_enabled is expected
    if ekf:
        ref = JActive(_cfg(JConfig, ekf, reloc), jg.GridSpec2D(16, 0.25, -2.0, -2.0), nav=None,
                      get_robot_pose=lambda: None)
        assert ref.slam.cfg.tracking.reloc_enabled is expected
    # the frame path taken
    info = port.frame(0)
    assert ("async" in info) is (not ekf)


def test_first_fix_seeds_both_filters_beside_reference():
    """The first SLAM fix seeds both filters at the (anchored) SLAM pose and
    adds no row; each later fix (fuse_every_n_frames = 1) adds one pose row
    to the map filter; every executed twist adds odometry and IMU rows to
    both. Held to the reference's states and buffered rows."""
    port, ref = _Port(), _Ref()
    for sim in (port, ref):
        sim.frame(0)
    for t, j in ((port.system.ekf.odom_state, ref.system.ekf.odom_state),
                 (port.system.ekf.map_state, ref.system.ekf.map_state)):
        np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(t.P.numpy(), np.asarray(j.P))
    x = port.system.ekf.map_state.x.numpy()
    np.testing.assert_allclose(x[[0, 1, 5]], [-5.0, -5.0, 0.2], atol=1e-5)
    assert not port.system.ekf._odom_rows and not port.system.ekf._map_rows
    for step in (1, 2):
        for sim in (port, ref):
            sim.nav.drive_open_loop(0.5, 0.12)
            sim.frame(step)
        pe, je = port.system.ekf, ref.system.ekf
        assert (len(pe._odom_rows), len(pe._map_rows)) == (len(je._odom_rows), len(je._map_rows))
        for a, b in zip(pe._odom_rows, je._odom_rows):
            assert all(np.array_equal(u, v) for u, v in zip(a, b))
        for a, b in zip(pe._map_rows, je._map_rows):
            assert all(np.array_equal(u, v) for k, (u, v) in enumerate(zip(a, b)) if k != 1)
            np.testing.assert_allclose(a[1], b[1], rtol=0, atol=POSE_ROW_TOL)
    assert (len(pe._odom_rows), len(pe._map_rows)) == (4, 6)
