"""The port's active-SLAM slice on the CPU: the simulation pieces it is driven
by (camera poses, the rooms and marsyard worlds, frustum clouds, the RGB-D
sensor model and frontend), the Fisher-information oracles, the landmark map
and the traversability grid of ``ActiveSlamSystem`` on one map state carried
across to the reference, and the whole loops of
tests/test_active_slam_e2e.py and tests/test_rgbd_e2e.py through the port.

Tolerances: camera poses, the worlds (with the seed constant), frustum
clouds, the RGB-D depth image, the RGB-D frontend's levels and depths and
the grid of a carried state exactly equal; at least 98 % of the frontend's
features with the same descriptor and a position within 1e-3 px (the
rendered blobs are radially symmetric, so a few keypoints have an intensity
centroid near zero and an orientation set by the last bits of the moments,
which the port sums in its fixed order, ROADMAP F15: 5 and 4 of 320 on the
two frames); the rendered intensity within 1e-3 grey levels
(scatter-add sums in another order); the oracles within
1e-5 relative and the world-frame landmark map within 1e-5 m. The loops are
held to their reference files' bounds, not to per-frame equality (ROADMAP
fault F5). The RGB-D arc runs the synchronous frame step with relocalization
off (not ported); the reference's arc never relocalizes either.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitslam_tpu.data import synthetic as jsyn
from fitslam_tpu.models import sim_robot as jsim
from fitslam_tpu.models import slam_map as jsm
from fitslam_tpu.models import tracking as jtr
from fitslam_tpu.models.active_slam import ActiveSlamSystem as JActive
from fitslam_tpu.models.active_slam import camera_pose_from_robot as jcam
from fitslam_tpu.ops import grid as jg
from fitslam_tpu.ops import lie as jl
from fitslam_tpu.ops.geometry import Intrinsics as JK
from fitslam_tpu.utils.config import FitSlamConfig as JConfig
from fitslam_tpu_torch.data import synthetic as tsyn
from fitslam_tpu_torch.models import sim_robot as tsim
from fitslam_tpu_torch.models import tracking as ttr
from fitslam_tpu_torch.models.active_slam import ActiveSlamSystem, camera_pose_from_robot
from fitslam_tpu_torch.models.exploration import GoalStatus, NavInterface
from fitslam_tpu_torch.models.sim_nav import SimNavInterface
from fitslam_tpu_torch.models.slam import StereoSlam
from fitslam_tpu_torch.ops import frontier as tfx
from fitslam_tpu_torch.ops import grid as tg
from fitslam_tpu_torch.ops import lie as tl
from fitslam_tpu_torch.ops.geometry import Intrinsics
from fitslam_tpu_torch.utils import evaluation as ev
from fitslam_tpu_torch.utils import interop
from fitslam_tpu_torch.utils.config import FitSlamConfig
from fitslam_tpu_torch.utils.profiling import SimClock

torch.set_num_threads(2)

SPEC = tg.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)
JSPEC = jg.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)
W, H = 320, 240


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _active_cfg(cls):
    """tests/test_active_slam_e2e.py's configuration."""
    cfg = cls()
    R = dataclasses.replace
    return R(
        cfg,
        camera=R(cfg.camera, width=W, height=H, fx=200.0, fy=200.0, cx=W / 2, cy=H / 2,
                 baseline=0.2),
        orb=R(cfg.orb, num_features=320, num_levels=2, fast_threshold=12.0),
        tracking=R(cfg.tracking, min_inliers=10, keyframe_min_interval=2,
                   keyframe_translation=0.25),
        mapping=R(cfg.mapping, max_keyframes=48, max_landmarks=3072, max_observations=8192,
                  local_window=4, ba_iters=3),
        loop=R(cfg.loop, enabled=False),
        traversability=R(cfg.traversability, max_points_per_cloud=4096, max_clouds=48),
        frontier_search=R(cfg.frontier_search, search_radius_m=6.0, max_frontiers=64),
        roadmap=R(cfg.roadmap, max_nodes=256, cleanup_period_s=5.0),
        nav=R(cfg.nav, wavefront_iters=192, desired_speed=0.7),
        fisher_information=R(cfg.fisher_information, threshold=5.0),
    )


def _rgbd_cfg():
    """tests/test_rgbd_e2e.py's configuration, relocalization off."""
    cfg = FitSlamConfig()
    R = dataclasses.replace
    return R(
        cfg,
        camera=R(cfg.camera, width=W, height=H, fx=200.0, fy=200.0, cx=W / 2, cy=H / 2,
                 baseline=0.2, rgbd=True),
        orb=R(cfg.orb, num_features=320, num_levels=2, fast_threshold=12.0),
        tracking=R(cfg.tracking, min_inliers=10, keyframe_min_interval=2,
                   keyframe_translation=0.25, reloc_enabled=False),
        mapping=R(cfg.mapping, max_keyframes=32, max_landmarks=3072, max_observations=8192,
                  local_window=4, ba_iters=3),
        loop=R(cfg.loop, enabled=False),
        traversability=R(cfg.traversability, max_points_per_cloud=4800, max_clouds=32),
    )


def _jK():
    return JK(jnp.float32(200.0), jnp.float32(200.0), jnp.float32(W / 2), jnp.float32(H / 2),
              jnp.float32(0.2))


def _ref_world(**kw):
    occ = jsim.make_rooms_world(JSPEC, seed=3)
    return jsyn.world_from_occupancy(occ, JSPEC, jax.random.PRNGKey(5), wall_height=2.0, **kw)


def _port_world(**kw):
    occ = tsim.make_rooms_world(SPEC, seed=3)
    return tsyn.world_from_occupancy(occ, SPEC, tsyn.ROOMS_WORLD_SEED, wall_height=2.0,
                                     device="cpu", **kw)


# ---------------------------------------------------------------------------
# Simulation pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pose", [(-5.0, -5.0, 0.3, 0.8), (1.25, -3.5, -2.9, 1.1),
                                  (0.0, 0.0, math.pi / 2, 0.8), (3.3, 2.2, 7.1, 0.95)])
def test_camera_pose_from_robot_equals_reference(pose):
    got = camera_pose_from_robot(*pose, device="cpu")
    ref = jcam(*pose)
    np.testing.assert_array_equal(got.R.numpy(), np.asarray(ref.R))
    np.testing.assert_array_equal(got.t.numpy(), np.asarray(ref.t))


def test_rooms_world_seed_constant_and_world_equal_reference():
    assert int(jax.random.randint(jax.random.PRNGKey(5), (), 0, 2 ** 31 - 1)) \
        == tsyn.ROOMS_WORLD_SEED
    for kw in ({}, {"points_per_wall_cell": 4, "floor_points": 4000}):
        np.testing.assert_array_equal(_port_world(**kw).landmarks.numpy(),
                                      np.asarray(_ref_world(**kw).landmarks))


@pytest.mark.parametrize("max_points", [4096, 1024])
def test_frustum_cloud_equals_reference(max_points):
    jw, tw = _ref_world(points_per_wall_cell=4, floor_points=4000), _port_world(
        points_per_wall_cell=4, floor_points=4000)
    Kt = interop.to_torch(_np(_jK()))
    for pose in [(-5.0, -5.0, 0.3), (-2.0, -4.5, 1.4), (0.5, -3.0, 2.6)]:
        rp, rv = jsyn.frustum_cloud(_jK(), jw, jcam(*pose), max_points=max_points,
                                    max_depth=8.0, width=W, height=H)
        tp, tv = tsyn.frustum_cloud(Kt, tw.landmarks, camera_pose_from_robot(*pose, device="cpu"),
                                    max_points=max_points, max_depth=8.0, width=W, height=H)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))
        assert 200 < int(tv.sum()) <= max_points


def test_frustum_cloud_pads_a_small_world():
    pts = np.random.RandomState(3).uniform(-3, 3, (100, 3)).astype(np.float32)
    pts[:, 0] += 4.0
    rp, rv = jsyn.frustum_cloud(_jK(), jsyn.World(jnp.asarray(pts)), jcam(0.0, 0.0, 0.0),
                                max_points=256, width=W, height=H)
    tp, tv = tsyn.frustum_cloud(interop.to_torch(_np(_jK())), torch.tensor(pts),
                                camera_pose_from_robot(0.0, 0.0, 0.0, device="cpu"),
                                max_points=256, width=W, height=H)
    assert tp.shape == (256, 3) and not tv[100:].any()
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))


@pytest.fixture(scope="module")
def rgbd_frames():
    """The reference's RGB-D frames along the start of the arc, and the port's."""
    jw, tw = _ref_world(points_per_wall_cell=4, floor_points=5000), _port_world(
        points_per_wall_cell=4, floor_points=5000)
    Kt = interop.to_torch(_np(_jK()))
    out = []
    for pose in [(-5.0, -5.0, 0.3), (-4.6, -4.9, 0.42)]:
        ri, rd = jsyn.render_rgbd(_jK(), jw, jcam(*pose), width=W, height=H, max_depth=12.0)
        ti, td = tsyn.render_rgbd(Kt, tw.landmarks, camera_pose_from_robot(*pose, device="cpu"),
                                  width=W, height=H, max_depth=12.0)
        out.append((np.asarray(ri), np.asarray(rd), ti.numpy(), td.numpy()))
    return out


def test_render_rgbd_equals_reference(rgbd_frames):
    for ri, rd, ti, td in rgbd_frames:
        np.testing.assert_allclose(ti, ri, rtol=0, atol=1e-3)
        np.testing.assert_array_equal(td, rd)
        assert (rd > 0).mean() > 0.05 and ri.max() > 100.0


def test_process_rgbd_equals_reference(rgbd_frames):
    kw = dict(num_features=320, num_levels=2, scale_factor=1.4142135, fast_threshold=12.0,
              max_depth=14.0)
    for ri, rd, _, _ in rgbd_frames:
        ref = _np(jtr.process_rgbd(_jK(), jnp.asarray(ri), jnp.asarray(rd), **kw))
        got = interop.to_numpy(ttr.process_rgbd(interop.to_torch(_np(_jK())), torch.tensor(ri),
                                                torch.tensor(rd), **kw))
        g, r = got.feats, ref.feats
        np.testing.assert_array_equal(g.level, r.level)
        same = (np.all(np.abs(g.xy - r.xy) <= 1e-3, axis=1)
                & np.all(g.desc == np.asarray(r.desc, np.float32), axis=1) & (g.valid == r.valid))
        assert same.mean() >= 0.98, same.mean()
        np.testing.assert_array_equal(got.depth, ref.depth)
        assert (got.depth > 0).sum() > 100


def test_marsyard_world_equals_reference():
    ref = jsyn.marsyard_world(JSPEC, seed=3, points_per_cell=6)
    got = tsyn.marsyard_world(SPEC, seed=3, points_per_cell=6, device="cpu")
    np.testing.assert_array_equal(got.world.landmarks.numpy(), np.asarray(ref.world.landmarks))
    np.testing.assert_array_equal(got.gt_lethal, ref.gt_lethal)
    np.testing.assert_array_equal(got.gt_height, ref.gt_height)
    assert (got.ridge_x, got.corridor_y) == (ref.ridge_x, ref.corridor_y)
    assert got.gt_lethal.sum() > 50
    for x, y in [(-5.0, -0.5), (1.0, 3.0), (-20.0, 30.0)]:
        assert tsyn.marsyard_surface_z(x, y, got, SPEC) == jsyn.marsyard_surface_z(x, y, ref, JSPEC)


# ---------------------------------------------------------------------------
# The whole loop of tests/test_active_slam_e2e.py through the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def active_run():
    cfg = _active_cfg(FitSlamConfig)
    K = Intrinsics.from_config(cfg.camera, "cpu")
    world = _port_world(points_per_wall_cell=4, floor_points=4000)
    robot = tsim.DiffDriveRobot(x=-5.0, y=-5.0, yaw=0.3, v_max=0.8, w_max=1.0)
    box = {}
    nav = SimNavInterface(cfg, SPEC, robot, lambda: box["sys"].occupancy(), dt=0.15,
                          device="cpu")
    nav.controller.max_omega = 0.9
    clock = SimClock()      # simulated time, 0.15 s a step: the same loop on any host
    system = ActiveSlamSystem(cfg, SPEC, nav, event_logger=clock,
                              get_robot_pose=lambda: box["sys"].estimated_robot_pose(),
                              device="cpu")
    box["sys"] = system
    gt_traj, fi_values = [], []
    for step in range(150):
        cam = camera_pose_from_robot(robot.x, robot.y, robot.yaw, device="cpu")
        if step == 0:
            system.set_world_anchor(cam)
        left, right = tsyn.render_stereo(K, world.landmarks, cam, width=W, height=H,
                                         max_depth=12.0)
        cloud, cvalid = tsyn.frustum_cloud(K, world.landmarks, cam,
                                           max_points=cfg.traversability.max_points_per_cloud,
                                           max_depth=8.0, width=W, height=H)
        system.process_frame(left, right, cloud, cvalid)
        gt_traj.append(cam.matrix().numpy().astype(np.float64))
        if step % 4 == 3:
            system.tick_exploration()
            fi_values.append(system.fisher_information_of_pose(robot.xy, robot.yaw))
        nav.step()
        clock.sim_s += 0.15
    system.finalize()
    return system, robot, gt_traj, fi_values


def test_loop_slam_tracks(active_run):
    system, robot, gt_traj, fi_values = active_run
    assert int(system.slam.map.n_kf) >= 5
    anchored = [gt_traj[0] @ T for T in system.slam.trajectory]
    ate = ev.ate_rmse(anchored, gt_traj, align=False)
    assert ate < 0.5, f"ATE {ate:.3f} m"


def test_loop_traversability_built(active_run):
    system, robot, gt_traj, fi_values = active_run
    occ = system.occupancy().numpy()
    known = occ != tg.UNKNOWN
    assert known.mean() > 0.08
    assert (occ[known] == tg.LETHAL).sum() > 10


def test_loop_fisher_oracle_positive(active_run):
    system, robot, gt_traj, fi_values = active_run
    assert len(fi_values) > 5
    assert max(fi_values) > 5.0


def test_loop_robot_explored(active_run):
    system, robot, gt_traj, fi_values = active_run
    traj = np.array([(x, y) for x, y, _ in robot.trajectory])
    assert np.ptp(traj[:, 0]) + np.ptp(traj[:, 1]) > 2.0
    assert system.explorer.diag.goals_sent >= 1
    # reads back: the poll and the frame step's own, a robot pose a tick,
    # the test's oracle floats and the tick's three points
    ticks = system.explorer.diag.ticks
    assert system.host_syncs == 2 * ticks
    assert system.explorer.host_syncs <= 3 * ticks


class _IdleNav(NavInterface):
    def send_goal(self, goal_xy, heading):
        pass

    def cancel(self):
        pass

    def status(self):
        return GoalStatus.NONE


def _ref_system(system):
    """A reference ActiveSlamSystem holding the port system's map, anchor,
    cloud buffer and running cell statistics."""
    ref = JActive(_active_cfg(JConfig), JSPEC, _IdleNav(), get_robot_pose=lambda: None)
    m = interop.to_numpy(system.slam.map)
    ref.slam.map = jsm.SlamMap(*(jl.SE3(*map(jnp.asarray, v)) if isinstance(v, tuple)
                                 else jnp.asarray(v) for v in m))
    ref.set_world_anchor(jl.SE3(*map(jnp.asarray, interop.to_numpy(system.T_anchor))))
    ref.clouds = jg.CloudBuffer(*map(jnp.asarray, interop.to_numpy(system.clouds)))
    ref._fstats = tuple(map(jnp.asarray, interop.to_numpy(system._fstats)))
    return ref


QUERIES = [((-5.0, -5.0), 0.3), ((-3.5, -4.0), 1.2), ((-4.0, -3.0), -2.5), ((-1.0, -5.0), 0.0)]


def test_oracles_equal_reference_on_carried_state(active_run):
    system = active_run[0]
    ref = _ref_system(system)
    values = []
    for xy, yaw in QUERIES:
        for exhaustive in (False, True):
            want = float(ref.fisher_information_of_pose_device(np.array(xy), yaw, exhaustive))
            got = system.fisher_information_of_pose_device(np.array(xy), yaw, exhaustive)
            assert got.dim() == 0
            np.testing.assert_allclose(float(got), want, rtol=1e-5)
            values.append(want)
    assert max(values) > 5.0
    xy_r, info_r, ok_r = ref.landmark_map_world()
    xy_t, info_t, ok_t = system.landmark_map_world()
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_r))
    ok = np.asarray(ok_r)
    assert ok.sum() > 500
    np.testing.assert_allclose(xy_t.numpy()[ok], np.asarray(xy_r)[ok], rtol=0, atol=1e-5)
    np.testing.assert_allclose(info_t.numpy()[ok], np.asarray(info_r)[ok], rtol=1e-5)


def test_occupancy_equals_reference_on_carried_state(active_run):
    system = active_run[0]
    ref = _ref_system(system)
    ref._grid_dirty = True
    occ = system.occupancy().numpy()
    np.testing.assert_array_equal(occ, np.asarray(ref.occupancy()))
    # the re-stitch after a loop correction, through the same world-anchored
    # keyframe poses
    kf_r, n_r = ref.kf_poses_world()
    kf_t, n_t = system.kf_poses_world()
    assert int(n_t) == int(n_r) >= 5
    np.testing.assert_allclose(kf_t.R.numpy(), np.asarray(kf_r.R), rtol=0, atol=1e-6)
    np.testing.assert_allclose(kf_t.t.numpy(), np.asarray(kf_r.t), rtol=0, atol=1e-5)
    stats_r = _np(jg.buffer_cell_stats(JSPEC, ref.clouds, kf_r))
    stats_t = interop.to_numpy(tg.buffer_cell_stats(SPEC, system.clouds,
                                                    interop.to_torch(_np(kf_r))))
    for a, b in zip(stats_t, stats_r):
        np.testing.assert_array_equal(a, b)
    tcfg = system.cfg.traversability
    kw = dict(max_slope=tcfg.max_slope, ground_clearance=tcfg.ground_clearance,
              robot_height=tcfg.robot_height, security_distance=tcfg.security_distance)
    np.testing.assert_array_equal(
        tg.threshold_grid(tg.grid_from_stats(SPEC, interop.to_torch(stats_t), **kw),
                          tcfg.lethal_threshold).numpy(),
        np.asarray(jg.threshold_grid(jg.grid_from_stats(JSPEC, stats_r, **kw),
                                     tcfg.lethal_threshold)))
    # the system's own re-stitch (its own keyframe poses) still sees the walls
    system._restitch = True
    restitched = system.occupancy().numpy()
    assert (restitched == tg.LETHAL).sum() > 10
    assert (restitched != occ).mean() < 0.02


# ---------------------------------------------------------------------------
# The RGB-D arc of tests/test_rgbd_e2e.py through the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rgbd_run():
    cfg = _rgbd_cfg()
    K = Intrinsics.from_config(cfg.camera, "cpu")
    world = _port_world(points_per_wall_cell=4, floor_points=5000)
    slam = StereoSlam(cfg, "cpu")
    tcfg = cfg.traversability
    box = {"clouds": tg.empty_cloud_buffer(tcfg.max_clouds, tcfg.max_points_per_cloud, "cpu"),
           "depth": None}

    def on_kf(s, kf_idx):
        pts, ok = tg.depth_image_to_cloud(K, box["depth"], stride=4, max_depth=8.0)
        box["clouds"] = tg.add_cloud(box["clouds"], pts, ok, kf_idx)

    slam.keyframe_events.append(on_kf)
    x, y, yaw = -5.0, -5.0, 0.3
    gt_traj = []
    for step in range(40):
        cam = camera_pose_from_robot(x, y, yaw, device="cpu")
        img, depth = tsyn.render_rgbd(K, world.landmarks, cam, width=W, height=H, max_depth=12.0)
        box["depth"] = depth
        slam.process_rgbd_frame(img, depth)
        gt_traj.append(cam.matrix().numpy().astype(np.float64))
        if step >= 2:
            yaw += 0.04
            x += 0.12 * math.cos(yaw)
            y += 0.12 * math.sin(yaw)
    T_anchor = camera_pose_from_robot(-5.0, -5.0, 0.3, device="cpu")
    kf_T_cw_world = tl.compose(slam.map.kf_T_cw, tl.inverse(T_anchor))
    grid = tg.fuse_clouds(SPEC, box["clouds"], kf_T_cw_world, max_slope=tcfg.max_slope,
                          ground_clearance=tcfg.ground_clearance,
                          robot_height=tcfg.robot_height,
                          security_distance=tcfg.security_distance)
    return slam, gt_traj, tg.threshold_grid(grid, tcfg.lethal_threshold)


def test_rgbd_tracks(rgbd_run):
    slam, gt_traj, occ = rgbd_run
    assert int(slam.map.n_kf) >= 4
    anchored = [gt_traj[0] @ T for T in slam.trajectory]
    ate = ev.ate_rmse(anchored, gt_traj, align=False)
    assert ate < 0.3, f"ATE {ate:.3f} m"


def test_rgbd_depth_features(rgbd_run):
    slam, gt_traj, occ = rgbd_run
    assert int(slam.map.n_lm) > 200


def test_rgbd_traversability_and_frontiers(rgbd_run):
    slam, gt_traj, occ = rgbd_run
    o = occ.numpy()
    known = o != tg.UNKNOWN
    assert known.mean() > 0.05
    assert (o[known] == tg.FREE).sum() > 50
    fr = tfx.extract_frontiers(SPEC, occ, torch.tensor([-5.0, -5.0]), SPEC.extent,
                               max_cells=4096, max_frontiers=64, max_cluster_size=20,
                               min_cluster_size=2, cc_iters=48)
    assert int(fr.valid.sum()) >= 1
