"""Full active-SLAM system: SLAM + traversability + FI-gated exploration
(port of ``fitslam_tpu/models/active_slam.py``).

The top-level composition of the reference's `active_slam` launch mode
(SURVEY.md §3.1): the stereo SLAM engine produces poses, keyframes and
landmarks; per-keyframe point clouds fuse into a traversability grid whose
threshold feeds both navigation and frontier search; the exploration server
picks goals and the Fisher-information oracle gates motion on localization
safety — all in one process, with the reference's functional seams.

Without the EKF layer, frames take the zero-readback path
(``StereoSlam.process_frame_async``); keyframe events, and with them cloud
fusion, arrive at the batched poll of the next exploration tick, and the
engine runs with relocalization off (the asynchronous step never
relocalizes). With the EKF layer (``cfg.localization.enabled``), frames take
the synchronous step on an engine built from the unchanged config
(relocalization as configured), and the dual EKF of
``models/localization.py`` fuses wheel odometry, IMU and the SLAM pose; its
map-frame estimate is the robot's pose. The system's own reads back (the
SLAM pose or the EKF estimate when the explorer asks for the robot's pose,
the anchor's matrix once, and ``fisher_information_of_pose``'s float) are
counted in ``host_syncs``, the EKF's flushes among them; the device oracle's
value folds into the tick's one packed read.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fitslam_tpu_torch.models import localization as loc
from fitslam_tpu_torch.models.exploration import ExplorationServer
from fitslam_tpu_torch.models.slam import StereoSlam
from fitslam_tpu_torch.ops import fisher, lie
from fitslam_tpu_torch.ops import grid as gridops
from fitslam_tpu_torch.ops.grid import GridSpec2D
from fitslam_tpu_torch.utils.config import FitSlamConfig
from fitslam_tpu_torch.utils.profiling import MODULE, EventLogger
from fitslam_tpu_torch.utils.transfer import upload


def camera_pose_from_robot(x: float, y: float, yaw: float, height: float = 0.8,
                           device="cuda") -> lie.SE3:
    """World-from-camera pose: camera at robot position, +z forward along
    yaw, y-down optical convention. Built in float32 on the host (the
    reference's arithmetic) and sent up in one copy that never waits."""
    fwd = np.array([math.cos(yaw), math.sin(yaw), 0.0], np.float32)
    down = np.array([0.0, 0.0, -1.0], np.float32)
    right = np.cross(down, fwd)
    R_wc = np.stack([right, down, fwd], axis=-1)
    t = np.array([x, y, height], np.float32)
    v = upload(np.concatenate([R_wc.reshape(9), t]), device)
    return lie.SE3(v[:9].reshape(3, 3), v[9:])


class ActiveSlamSystem:
    """Owns the SLAM engine, the traversability fusion, and the exploration
    server; exposes per-step hooks for a simulation or a recorded stream."""

    def __init__(
        self,
        cfg: FitSlamConfig,
        spec: GridSpec2D,
        nav,                      # NavInterface
        get_robot_pose,           # () -> (xy, yaw)
        event_logger: Optional[EventLogger] = None,
        peer_goals=None,          # () -> [peer goal xy] (multi-robot sharing)
        device="cuda",
    ):
        self.cfg = cfg
        self.spec = spec
        self.device = torch.device(device)
        self.log = event_logger or EventLogger(time_tier=MODULE)
        lcfg = cfg.localization
        # without the EKF, frames take the asynchronous step, which never
        # relocalizes (the reference relocalizes only in its synchronous
        # step), so that engine runs with relocalization off whatever the
        # config says; the EKF's synchronous path keeps the config's setting
        slam_cfg = cfg if lcfg.enabled else replace(
            cfg, tracking=replace(cfg.tracking, reloc_enabled=False))
        self.slam = StereoSlam(slam_cfg, self.device, event_logger=self.log)
        self._host_syncs = 0      # this object's own device->host reads

        # state-estimation layer (N5, ekf_with_gps.yaml/twist_mux.yaml): the
        # dual EKF fuses wheel-odometry twist + IMU rates (odom filter) and
        # the SLAM pose as the absolute map-frame reference (GPS's role);
        # when enabled its map-frame estimate IS the robot pose source
        self.ekf: Optional[loc.DualEkf] = None
        if lcfg.enabled:
            self.ekf = loc.DualEkf(device=self.device)
            self._ekf_dirty = False
            self._slam_fuse_counter = 0
            # the nav layer's executed twists feed the odometry input
            # (wheel-encoder seam): SimNavInterface calls on_cmd after every
            # robot step
            if hasattr(nav, "on_cmd"):
                nav.on_cmd = self.observe_odometry

        tcfg = cfg.traversability
        self.clouds = gridops.empty_cloud_buffer(tcfg.max_clouds, tcfg.max_points_per_cloud,
                                                 self.device)
        self._occ = torch.full((spec.size, spec.size), gridops.UNKNOWN, dtype=torch.uint8,
                               device=self.device)
        self._grid_dirty = True
        # incremental-fusion state (is_kf_optimization_enabled semantics,
        # SURVEY.md §3.4): running per-cell aggregates absorb each keyframe
        # cloud as it arrives; `_restitch` forces a full re-fuse of the whole
        # buffer through CURRENT keyframe poses (loop closure moved them)
        self._fstats = gridops.empty_cell_stats(spec, self.device)
        self._restitch = False
        self.slam.keyframe_events.append(self._on_keyframe)
        # per-frame clouds awaiting keyframe association, keyed by frame id
        # (keyframe events arrive at poll time, possibly several frames after
        # the cloud's frame)
        self._pending_cloud: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

        # SLAM's frame is anchored at the first camera; the simulation works
        # in a world frame. T_anchor is the first camera's world pose.
        self.T_anchor: Optional[lie.SE3] = None
        self._anchor_np: Optional[np.ndarray] = None  # host mirror of T_anchor
        self._ekf_pose_cache = None  # (xy, yaw) until the next EKF input

        self.explorer = ExplorationServer(
            cfg, spec,
            get_occupancy=self.occupancy,
            nav=nav,
            get_robot_pose=get_robot_pose,
            fi_oracle=self.fisher_information_of_pose,
            fi_oracle_device=self.fisher_information_of_pose_device,
            get_kf_poses=self.kf_poses_world,
            event_logger=self.log,
            get_landmarks=self.landmark_map_world,
            peer_goals=peer_goals,
            device=self.device,
        )

    # ------------------------------------------------------------------
    # Frame anchoring
    # ------------------------------------------------------------------

    def set_world_anchor(self, T_wc_first: lie.SE3):
        """Register the first camera's world pose (sim/GT or external init)."""
        self.T_anchor = T_wc_first
        self._anchor_np = None

    @property
    def host_syncs(self) -> int:
        """Device->host reads of this object and its EKF (not the engine's,
        the explorer's or the nav layer's)."""
        return self._host_syncs + (self.ekf.host_syncs if self.ekf is not None else 0)

    def kf_poses_world(self):
        """Keyframe camera-from-world poses expressed in the world frame."""
        m = self.slam.map
        if self.T_anchor is None:
            return m.kf_T_cw, m.n_kf
        return lie.compose(m.kf_T_cw, lie.inverse(self.T_anchor)), m.n_kf

    def _slam_pose_world(self, pose_wc_np=None) -> Tuple[np.ndarray, float]:
        """Raw SLAM pose in the world frame (xy, yaw).

        When the caller already holds the frame's pose matrix (numpy, from
        the synchronous step's packed read), the anchor composition is host
        math on the anchor's matrix, read once; otherwise one counted read."""
        if pose_wc_np is not None:
            T_np = np.asarray(pose_wc_np, np.float64)
            if self.T_anchor is not None:
                if self._anchor_np is None:
                    self._anchor_np = self.T_anchor.matrix().cpu().numpy().astype(np.float64)
                    self._host_syncs += 1
                T_np = self._anchor_np @ T_np
            fwd = T_np[:3, 2]
            return T_np[:2, 3], math.atan2(fwd[1], fwd[0])
        T = self.slam.current_pose_wc  # slam frame
        if self.T_anchor is not None:
            T = lie.compose(self.T_anchor, T)
        v = torch.cat([T.R[:, 2], T.t]).cpu().numpy()
        self._host_syncs += 1
        yaw = math.atan2(float(v[1]), float(v[0]))  # camera +z (forward)
        return v[3:5].astype(np.float64), yaw

    def estimated_robot_pose(self) -> Tuple[np.ndarray, float]:
        """Robot pose in the world frame (xy, yaw): the EKF map-frame
        estimate when the localization layer is enabled, else raw SLAM. The
        EKF flushes its pending rows only when an input arrived since the
        last call, and the pose it reads back is kept until the next input:
        one read an EKF update, not one a query."""
        if self.ekf is None:
            return self._slam_pose_world()
        if self._ekf_dirty:
            _, m = self.ekf.flush()   # its one read, counted by the EKF
            self._ekf_dirty = False
            self._ekf_pose_cache = (m[[loc.X, loc.Y]].astype(np.float64), float(m[loc.YAW]))
        if self._ekf_pose_cache is None:
            x = self.ekf.map_state.x[:loc.YAW + 1].cpu().numpy()
            self._host_syncs += 1
            self._ekf_pose_cache = (x[[loc.X, loc.Y]].astype(np.float64), float(x[loc.YAW]))
        return self._ekf_pose_cache

    # ------------------------------------------------------------------
    # State-estimation inputs (N5)
    # ------------------------------------------------------------------

    def observe_odometry(self, v: float, omega: float, dt: float):
        """Wheel-odometry twist + gyro rate into both EKF filters (the
        odom0/imu0 topics of ekf_with_gps.yaml). Called by the nav layer
        after every executed command when the EKF is enabled."""
        if self.ekf is None or dt <= 0:
            return
        lcfg = self.cfg.localization
        self.ekf.add_odom(v, 0.0, dt, var=lcfg.odom_var)
        self.ekf.add_imu(0.0, 0.0, omega, 0.0, var=lcfg.imu_rate_var,
                         gate=lcfg.imu_gate)
        self._ekf_dirty = True
        self._ekf_pose_cache = None

    def observe_imu_orientation(self, roll: float, pitch: float, yaw: float):
        """Absolute AHRS orientation (the imu0_config orientation rows)."""
        if self.ekf is None:
            return
        lcfg = self.cfg.localization
        self.ekf.add_imu(0.0, 0.0, 0.0, 0.0, roll=roll, pitch=pitch, yaw=yaw,
                         var=lcfg.imu_rate_var, ori_var=lcfg.imu_ori_var,
                         gate=lcfg.imu_gate)
        self._ekf_dirty = True
        self._ekf_pose_cache = None

    def _fuse_slam_pose(self, pose_wc_np=None):
        lcfg = self.cfg.localization
        xy, yaw = self._slam_pose_world(pose_wc_np)
        if self._slam_fuse_counter == 0:
            # first fix: seed both filters at the SLAM pose (datum), exactly
            # as navsat_transform seeds the map frame from the first GPS fix
            x0 = np.zeros(loc.STATE_DIM, np.float32)
            x0[[loc.X, loc.Y, loc.YAW]] = [xy[0], xy[1], yaw]
            self.ekf.odom_state = loc.initial_state(x0, device=self.device)
            self.ekf.map_state = loc.initial_state(x0, device=self.device)
            self._slam_fuse_counter += 1
            return
        self._slam_fuse_counter += 1
        if (self._slam_fuse_counter - 1) % max(1, lcfg.fuse_every_n_frames):
            return
        self.ekf.add_pose(float(xy[0]), float(xy[1]), yaw,
                          var=lcfg.slam_pose_var, gate=lcfg.slam_pose_gate)
        self._ekf_dirty = True
        self._ekf_pose_cache = None

    # ------------------------------------------------------------------
    # SLAM + mapping
    # ------------------------------------------------------------------

    def process_frame(self, img_left, img_right,
                      cloud_c: Optional[torch.Tensor] = None,
                      cloud_valid: Optional[torch.Tensor] = None) -> Dict:
        """Track one stereo frame; `cloud_c` is the camera-frame point cloud
        to associate with a keyframe if one is created this frame.

        Without the EKF layer, frames take the zero-readback path: keyframe
        events are consumed by the batched poll at the next exploration
        tick. With it, the synchronous step runs (one packed read a frame),
        and the map-frame filter fuses the SLAM pose at frame rate."""
        if cloud_c is not None:
            self._pending_cloud[self.slam.frame_id] = (cloud_c, cloud_valid)
        if self.ekf is None:
            self.slam.process_frame_async(img_left, img_right)
            return {"async": True}
        info = self.slam.process_frame(img_left, img_right)
        if info.get("loop"):
            # loop closure moved keyframes: re-stitch the grid
            self._restitch = True
        if not info.get("lost"):
            # fuse the SLAM pose into the map-frame filter; when tracking is
            # lost the EKF dead-reckons on odometry alone
            self._fuse_slam_pose(info.get("pose_wc"))
        return info

    def _on_keyframe(self, slam: StereoSlam, kf_idx: int):
        entry = self._pending_cloud.pop(slam.last_keyframe_frame_id, None)
        # fallback: newest pending cloud AT OR BEFORE this keyframe's frame
        # (a newer frame's cloud may already be pending under poll lag; it
        # belongs to a future keyframe, not this one)
        if entry is None and self._pending_cloud:
            cands = [k for k in self._pending_cloud
                     if k <= slam.last_keyframe_frame_id]
            if cands:
                entry = self._pending_cloud.pop(max(cands))
        if entry is None:
            return
        cloud_c, valid = entry
        # drop stale per-frame clouds from before this keyframe
        for k in [k for k in self._pending_cloud
                  if k < slam.last_keyframe_frame_id]:
            del self._pending_cloud[k]
        self.clouds = gridops.add_cloud(self.clouds, cloud_c, valid, kf_idx)
        if not self._restitch:
            # incremental path: scatter ONLY this cloud into the running
            # aggregates through the keyframe's current (world-anchored)
            # pose; a pending re-stitch supersedes it
            kf_T_cw_world, _ = self.kf_poses_world()
            T_kf = lie.SE3(kf_T_cw_world.R[kf_idx], kf_T_cw_world.t[kf_idx])
            self._fstats = gridops.scatter_cloud_stats(
                self.spec, self._fstats, cloud_c, valid, T_kf)
        self._grid_dirty = True

    def occupancy(self) -> torch.Tensor:
        """Thresholded traversability grid (the /traversability_thresholded
        topic equivalent). Per-keyframe updates are incremental; a full
        re-stitch through current keyframe poses happens only after loop
        corrections (`_restitch`)."""
        if self._restitch:
            with self.log.scope("traversability.restitch", MODULE):
                # keyframe poses must be world-anchored: the grid's z axis is
                # world-up, while the raw SLAM frame is the first camera's
                # optical frame (y down, z forward)
                kf_T_cw_world, _ = self.kf_poses_world()
                self._fstats = gridops.buffer_cell_stats(self.spec, self.clouds, kf_T_cw_world)
            self._restitch = False
            self._grid_dirty = True
        if self._grid_dirty:
            with self.log.scope("traversability.fuse", MODULE):
                tcfg = self.cfg.traversability
                grid = gridops.grid_from_stats(
                    self.spec, self._fstats,
                    max_slope=tcfg.max_slope,
                    ground_clearance=tcfg.ground_clearance,
                    robot_height=tcfg.robot_height,
                    security_distance=tcfg.security_distance,
                )
                self._occ = gridops.threshold_grid(grid, tcfg.lethal_threshold)
            self._grid_dirty = False
        return self._occ

    # ------------------------------------------------------------------
    # Fisher-information oracle (the reference's isPoseSafe, §3.3)
    # ------------------------------------------------------------------

    def fisher_information_of_pose_device(self, robot_xy, robot_yaw,
                                          exhaustive: bool = False) -> torch.Tensor:
        """isPoseSafe's information scalar as a 0-d DEVICE tensor: the
        exploration tick folds it into its one packed read
        (FisherInfoManager.cpp:39-115)."""
        fcfg = self.cfg.fisher_information
        T_wc = camera_pose_from_robot(robot_xy[0], robot_xy[1], robot_yaw, device=self.device)
        if self.T_anchor is not None:
            # the landmark map lives in the SLAM (first-camera) frame: convert
            # the world-frame query pose before frustum culling
            T_wc = lie.compose(lie.inverse(self.T_anchor), T_wc)
        max_d = fcfg.max_landmark_distance * (2.0 if exhaustive else 1.0)
        p_c, ok = self.slam.get_landmarks_in_view(T_wc, max_distance=max_d)
        return fisher.pose_information(
            p_c, ok,
            noise_var=fcfg.measurement_noise,
            max_distance=max_d,
            saturation_exponent=fcfg.saturation_exponent,
        )

    def fisher_information_of_pose(self, robot_xy, robot_yaw,
                                   exhaustive: bool = False) -> float:
        """The same scalar read back (one counted read)."""
        v = float(self.fisher_information_of_pose_device(robot_xy, robot_yaw, exhaustive))
        self._host_syncs += 1
        return v

    def landmark_map_world(self):
        """World-frame landmark ground-plane positions + per-landmark
        information weight for fisher_information_in_path (the landmark side
        of computeInformationFrontierPair, FisherInformationHelpers.cpp:125-143).
        Returns (lm_xy (L, 2), lm_info (L,), lm_valid (L,)) on the device."""
        m = self.slam.map
        p = m.lm_pos
        if self.T_anchor is not None:
            p = lie.apply(self.T_anchor, p)
        info = fisher.point_information_local(
            m.lm_pos_anchor, self.cfg.fisher_information.measurement_noise)
        return p[:, :2], info, m.lm_valid

    def finalize(self):
        """End-of-run: drain pending keyframe events and materialize the
        async path's trajectory/stats (one batched readback)."""
        self.slam.poll_keyframe_events()
        return self.slam.finalize()

    def tick_exploration(self):
        """Drain the keyframe events of the async frame path (one batched
        readback: cloud association fires here), then tick the explorer on
        the refreshed grid."""
        events = self.slam.poll_keyframe_events()
        if any(ev.get("loop") for ev in events):
            self._restitch = True   # keyframes moved: full re-stitch
        return self.explorer.tick()
