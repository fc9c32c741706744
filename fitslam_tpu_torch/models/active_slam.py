"""Full active-SLAM system: SLAM + traversability + FI-gated exploration
(port of ``fitslam_tpu/models/active_slam.py``).

The top-level composition of the reference's `active_slam` launch mode
(SURVEY.md §3.1): the stereo SLAM engine produces poses, keyframes and
landmarks; per-keyframe point clouds fuse into a traversability grid whose
threshold feeds both navigation and frontier search; the exploration server
picks goals and the Fisher-information oracle gates motion on localization
safety — all in one process, with the reference's functional seams.

Frames take the zero-readback path (``StereoSlam.process_frame_async``);
keyframe events, and with them cloud fusion, arrive at the batched poll of
the next exploration tick. The system's own reads back (the SLAM pose when
the explorer asks for the robot's pose, and ``fisher_information_of_pose``'s
float) are counted in ``host_syncs``; the device oracle's value folds into
the tick's one packed read.

The EKF layer (``cfg.localization.enabled``) waits for the port of
``models/localization.py``; asking for it raises.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

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
        if cfg.localization.enabled:
            raise NotImplementedError(
                "the EKF layer (cfg.localization.enabled) is not ported yet: it waits for "
                "models/localization.py (ROADMAP queue 1 item 14); set it to False")
        self.cfg = cfg
        self.spec = spec
        self.device = torch.device(device)
        self.log = event_logger or EventLogger(time_tier=MODULE)
        # frames take the asynchronous step, which never relocalizes (the
        # reference relocalizes only in its synchronous step), so the engine
        # runs with relocalization off whatever the config says
        self.slam = StereoSlam(
            replace(cfg, tracking=replace(cfg.tracking, reloc_enabled=False)),
            self.device, event_logger=self.log)
        self.ekf = None
        self.host_syncs = 0       # this object's own device->host reads

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

    def kf_poses_world(self):
        """Keyframe camera-from-world poses expressed in the world frame."""
        m = self.slam.map
        if self.T_anchor is None:
            return m.kf_T_cw, m.n_kf
        return lie.compose(m.kf_T_cw, lie.inverse(self.T_anchor)), m.n_kf

    def _slam_pose_world(self) -> Tuple[np.ndarray, float]:
        """Raw SLAM pose in the world frame (xy, yaw): one counted read. (The
        reference's host-math variant on a frame's pose matrix serves only
        the EKF's sync frame path.)"""
        T = self.slam.current_pose_wc  # slam frame
        if self.T_anchor is not None:
            T = lie.compose(self.T_anchor, T)
        v = torch.cat([T.R[:, 2], T.t]).cpu().numpy()
        self.host_syncs += 1
        yaw = math.atan2(float(v[1]), float(v[0]))  # camera +z (forward)
        return v[3:5].astype(np.float64), yaw

    def estimated_robot_pose(self) -> Tuple[np.ndarray, float]:
        """Robot pose in the world frame (xy, yaw): raw SLAM (the EKF
        estimate once ``models/localization.py`` is ported)."""
        return self._slam_pose_world()

    # ------------------------------------------------------------------
    # State-estimation inputs (N5): no-ops until the EKF is ported
    # ------------------------------------------------------------------

    def observe_odometry(self, v: float, omega: float, dt: float):
        """Wheel-odometry twist + gyro rate into the EKF filters."""
        if self.ekf is None or dt <= 0:
            return

    def observe_imu_orientation(self, roll: float, pitch: float, yaw: float):
        """Absolute AHRS orientation (the imu0_config orientation rows)."""
        if self.ekf is None:
            return

    # ------------------------------------------------------------------
    # SLAM + mapping
    # ------------------------------------------------------------------

    def process_frame(self, img_left, img_right,
                      cloud_c: Optional[torch.Tensor] = None,
                      cloud_valid: Optional[torch.Tensor] = None) -> Dict:
        """Track one stereo frame on the zero-readback path; `cloud_c` is the
        camera-frame point cloud to associate with a keyframe if one is
        created this frame (keyframe events are consumed by the batched poll
        at the next exploration tick)."""
        if cloud_c is not None:
            self._pending_cloud[self.slam.frame_id] = (cloud_c, cloud_valid)
        self.slam.process_frame_async(img_left, img_right)
        return {"async": True}

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
        self.host_syncs += 1
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
