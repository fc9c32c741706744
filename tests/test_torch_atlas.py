"""The port's Atlas multi-map and relocalization, on the scenarios of
``tests/test_atlas.py``, beside the reference's run of the same frames:
- a teleport with relocalization off opens a new map;
- with relocalization on, returning to the start re-locks the tracker onto
  map 0 through place recognition, within 0.5 m.

Both packages see the same images (the reference renders them from its
rooms world). Besides the reference test's own bounds, the port's active map
id a frame, the frames that relocalize and the keyframes' map ids equal the
reference's, and the final poses agree within 0.05 m (short runs of float32
Gauss-Newton in two frameworks, ROADMAP F5; inlier counts of a lost frame's
guesses are not compared).
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
from fitslam_tpu.models.active_slam import camera_pose_from_robot
from fitslam_tpu.models.slam import StereoSlam as JSlam
from fitslam_tpu.ops import grid as jgrid
from fitslam_tpu.ops.geometry import Intrinsics as JIntrinsics
from fitslam_tpu.utils.config import FitSlamConfig as JConfig
from fitslam_tpu_torch.models.slam import StereoSlam
from fitslam_tpu_torch.utils.config import FitSlamConfig

# several pytest-xdist workers share the machine
torch.set_num_threads(2)

SPEC = jgrid.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)
W, H = 320, 240


def _cfg(cls, reloc: bool):
    cfg = cls()
    R = dataclasses.replace
    return R(cfg,
             camera=R(cfg.camera, width=W, height=H, fx=200.0, fy=200.0, cx=W / 2, cy=H / 2,
                      baseline=0.2),
             orb=R(cfg.orb, num_features=320, num_levels=2, fast_threshold=12.0),
             tracking=R(cfg.tracking, min_inliers=10, keyframe_min_interval=2,
                        keyframe_translation=0.25, reinit_after_lost=3, reloc_enabled=reloc,
                        reloc_after_lost=1, reloc_min_inliers=15),
             mapping=R(cfg.mapping, max_keyframes=24, max_landmarks=2048,
                       max_observations=6144, local_window=4, ba_iters=2),
             loop=R(cfg.loop, enabled=False))


@pytest.fixture(scope="module")
def world():
    occ = jsim.make_rooms_world(SPEC, seed=3)
    return jsyn.world_from_occupancy(occ, SPEC, jax.random.PRNGKey(5), wall_height=2.0,
                                     points_per_wall_cell=4, floor_points=4000)


def _render(world, poses):
    K = JIntrinsics.from_config(_cfg(JConfig, False).camera)
    return [tuple(np.asarray(x) for x in jsyn.render_stereo(
        K, world, camera_pose_from_robot(x, y, yaw), width=W, height=H, max_depth=12.0))
        for x, y, yaw in poses]


def _creep():
    x, y, yaw, out = -5.0, -5.0, 0.3, []
    for _ in range(8):
        out.append((x, y, yaw))
        x += 0.15 * math.cos(yaw)
        y += 0.15 * math.sin(yaw)
    return out


def _drive(reloc, frames, marks):
    """Both engines over the frames: per frame (map id, relocalized, inliers)
    and the map ids of the keyframes after frame index ``marks``."""
    runs = []
    for cls, slam_of, conv in ((JConfig, JSlam, jnp.asarray),
                               (FitSlamConfig, lambda c: StereoSlam(c, "cpu"), torch.tensor)):
        slam = slam_of(_cfg(cls, reloc))
        rows, kf_ids = [], {}
        for k, (l, r) in enumerate(frames):
            info = slam.process_frame(conv(l), conv(r))
            rows.append((int(slam.state.map_id), bool(info.get("relocalized")),
                         info["n_inliers"]))
            if k in marks:
                kf_ids[k] = np.asarray(slam.map.kf_map_id)[np.asarray(slam.map.kf_valid)]
        runs.append((slam, rows, kf_ids))
    return runs


def test_teleport_spawns_new_map(world):
    poses = _creep() + [(5.0 + 0.1 * i, 5.0, -2.6) for i in range(8)]
    (ref, ref_rows, ref_ids), (slam, rows, ids) = _drive(False, _render(world, poses), {7, 15})
    assert ids[7].max() == 0
    assert ids[15].max() >= 1, "teleport must open a new Atlas map"
    assert int(slam.state.map_id) >= 1
    assert [r[:2] for r in rows] == [r[:2] for r in ref_rows]
    for k in ids:
        np.testing.assert_array_equal(ids[k], ref_ids[k])


def test_relocalization_relocks_old_map(world):
    poses = _creep() + [(5.0 + 0.1 * i, 5.0, -2.6) for i in range(6)] + [(-5.0, -5.0, 0.3)] * 5
    (ref, ref_rows, _), (slam, rows, _) = _drive(True, _render(world, poses), set())
    kidnap_map, back = rows[13][0], rows[14:]
    assert kidnap_map >= 1
    assert any(r[1] for r in back), "relocalization should have fired"
    assert int(slam.state.map_id) == 0
    assert back[-1][2] >= 15
    T = slam.current_pose_wc.matrix().numpy()
    anchor = np.asarray(camera_pose_from_robot(-5.0, -5.0, 0.3).matrix())
    est_xy = (anchor @ T)[:2, 3]
    assert np.linalg.norm(est_xy - np.array([-5.0, -5.0])) < 0.5
    # the reference relocalizes on the same frames onto the same map
    assert [r[:2] for r in rows] == [r[:2] for r in ref_rows]
    T_ref = np.asarray(ref.current_pose_wc.matrix())
    np.testing.assert_allclose(T[:3, 3], T_ref[:3, 3], atol=0.05)
