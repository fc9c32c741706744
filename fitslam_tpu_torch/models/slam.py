"""The stereo/RGB-D SLAM engine (port of ``StereoSlam`` in
``fitslam_tpu/models/slam.py``): host orchestration of the frame step.

It covers the stereo and RGB-D frame steps (``process_frame[_async]``,
``process_rgbd_frame[_async]``, ``process_prepared[_async]``),
``poll_keyframe_events``, ``finalize``, loop closing (``models/loop_closing.py``,
fed by the candidate each keyframe's step retrieves), relocalization and the
Atlas re-lock in the synchronous step, the deferred ``refine_map``,
``corrected_trajectory`` and the service surface (``get_landmarks_in_view``,
``get_map_data``, ``current_pose_wc``).

Both behaviours of the reference's pipelined polling are kept: keyframe
events are polled with one packed readback per window (``flush=False`` starts
the copy now and delivers it at the next poll), and every ``outs_log`` entry
carries its own frame id.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from fitslam_tpu_torch.models import slam_map as sm
from fitslam_tpu_torch.models import tracking as tr
from fitslam_tpu_torch.models.loop_closing import LoopCloser, detect_loop, verify_loop
from fitslam_tpu_torch.models.slam_step import StepOutputs, _backend_body
from fitslam_tpu_torch.ops import ba, lie
from fitslam_tpu_torch.ops.geometry import Intrinsics
from fitslam_tpu_torch.ops.place import signature_from_descriptors
from fitslam_tpu_torch.utils.config import FitSlamConfig
from fitslam_tpu_torch.utils.profiling import MODULE, EventLogger


class StereoSlam:
    """Stereo SLAM system with fixed-capacity state on ``device``."""

    def __init__(self, cfg: FitSlamConfig, device="cuda",
                 event_logger: Optional[EventLogger] = None):
        # float32 products must stay float32: TF32 keeps ~3 decimal digits and
        # the pose chains compound it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.device = torch.device(device)
        self.K = Intrinsics.from_config(cfg.camera, self.device)
        mp = cfg.mapping
        self.map = sm.empty_map(mp.max_keyframes, mp.max_landmarks, mp.max_observations,
                                signature_dim=cfg.loop.vocab_dim, device=self.device)
        self.state = tr.init_track_state(self.device)
        self.frame_id = 0
        self.trajectory: List[np.ndarray] = []   # T_wc 4x4 per frame
        self._traj_ref: List = []                # (ref_kf, its T_cw then) per frame
        self.keyframe_events: List[Callable] = []
        self.log = event_logger or EventLogger(time_tier=MODULE)
        self._initialized = False
        # host mirror of state.initialized: it turns True with the first keyframe
        self._track_initialized = False
        self.host_syncs = 0                      # device->host waits so far
        self.last_frame: Optional[tr.StereoFrame] = None
        self.outs_log: List[StepOutputs] = []
        self._frame_ring: Dict[int, tr.StereoFrame] = {}
        self._polled_until = 0
        self._outs_fids: List[int] = []          # frame id per outs_log entry
        self._poll_pending = None
        self.last_keyframe_frame_id = -1
        self.loop_closer = LoopCloser(cfg, self.K) if cfg.loop.enabled else None
        self.loop_events: List[Dict] = []

    # ------------------------------------------------------------------
    # Frame pipeline
    # ------------------------------------------------------------------

    def _frontend(self, img_left, img_right) -> tr.StereoFrame:
        o = self.cfg.orb
        return tr.process_stereo(self.K, img_left, img_right, num_features=o.num_features,
                                 num_levels=o.num_levels, scale_factor=o.scale_factor,
                                 fast_threshold=o.fast_threshold)

    def _frontend_rgbd(self, img, depth_img) -> tr.StereoFrame:
        o = self.cfg.orb
        return tr.process_rgbd(self.K, img, depth_img, num_features=o.num_features,
                               num_levels=o.num_levels, scale_factor=o.scale_factor,
                               fast_threshold=o.fast_threshold,
                               max_depth=self.cfg.camera.depth_max)

    def _step(self, frame: tr.StereoFrame) -> StepOutputs:
        cfg = self.cfg
        self.map, self.state, outs, inserted, syncs = _backend_body(
            self.K, self.map, self.state, frame, self.frame_id,
            initialized=self._track_initialized,
            search_radius=cfg.tracking.search_radius_px,
            match_max_hamming=cfg.tracking.match_max_hamming,
            min_inliers=cfg.tracking.min_inliers,
            width=cfg.camera.width, height=cfg.camera.height,
            pose_iters=cfg.tracking.pose_gn_iters,
            kf_min_interval=cfg.tracking.keyframe_min_interval,
            kf_translation=cfg.tracking.keyframe_translation,
            kf_rotation=cfg.tracking.keyframe_rotation,
            kf_min_tracked_ratio=cfg.tracking.keyframe_min_tracked_ratio,
            scale_factor=cfg.orb.scale_factor,
            ba_window=cfg.mapping.local_window,
            ba_max_obs=min(8192, cfg.mapping.max_observations),
            ba_iters=cfg.mapping.ba_iters,
            cull_min_obs=cfg.mapping.cull_min_observations,
            wide_radius=cfg.tracking.wide_radius_px,
            reinit_after_lost=cfg.tracking.reinit_after_lost,
            match_ratio=cfg.tracking.match_ratio,
            ba_covis=cfg.mapping.covisibility_window,
            recycle_at_fraction=cfg.mapping.recycle_at_fraction,
            recycle_target_fraction=cfg.mapping.recycle_target_fraction,
            loop_min_gap=cfg.loop.min_gap_keyframes if cfg.loop.enabled else 0,
            max_spawn_depth=(cfg.camera.depth_max if cfg.camera.rgbd
                             else cfg.mapping.close_depth_factor * cfg.camera.baseline),
        )
        self.host_syncs += syncs
        self._track_initialized = self._track_initialized or inserted
        return outs

    def process_frame(self, img_left, img_right) -> Dict:
        """Track one stereo frame and read its result back."""
        with self.log.scope("frontend", MODULE):
            frame = self._frontend(img_left, img_right)
        return self.process_prepared(frame)

    def process_rgbd_frame(self, img, depth_img) -> Dict:
        """Track one RGB-D frame (reference rgbd mode, SURVEY.md §2.1 S2):
        the same backend as stereo, depth read from the registered depth
        image."""
        with self.log.scope("frontend", MODULE):
            frame = self._frontend_rgbd(img, depth_img)
        return self.process_prepared(frame)

    def process_rgbd_frame_async(self, img, depth_img) -> StepOutputs:
        """RGB-D variant of the zero-readback step."""
        return self.process_prepared_async(self._frontend_rgbd(img, depth_img))

    def process_frame_async(self, img_left, img_right) -> StepOutputs:
        """Frame step whose per-frame outputs stay on the device in
        ``outs_log``; ``finalize()`` reads them back in one transfer."""
        return self.process_prepared_async(self._frontend(img_left, img_right))

    def process_prepared_async(self, frame: tr.StereoFrame) -> StepOutputs:
        outs = self._step(frame)
        self.outs_log.append(outs)
        # frame id recorded per entry: interleaved process_frame calls advance
        # frame_id without touching outs_log
        self._outs_fids.append(self.frame_id)
        if self.loop_closer is not None or self.keyframe_events:
            self._frame_ring[self.frame_id] = frame
        self._initialized = True
        self.frame_id += 1
        return outs

    def poll_keyframe_events(self, flush: bool = True):
        """Batched keyframe-event poll for the async path: one packed
        device->host copy of (was_keyframe, kf_idx, loop_cand, loop_score)
        for every frame since the last poll, then keyframe callbacks and loop
        closing fire for each new keyframe, against its retained frame.

        flush=False is the pipelined mode: the new window's copy starts now
        (pinned memory, non-blocking, marked by a CUDA event) and is
        processed at the next poll, so the camera loop never waits on it."""
        events = []
        pending = self._poll_pending
        self._poll_pending = None
        start = self._polled_until
        window = self.outs_log[start:]
        new_pending = None
        if window:
            stacked = torch.stack([
                torch.stack([o.was_keyframe.float(), o.kf_idx.float(),
                             o.loop_cand.float(), o.loop_score]) for o in window])
            if stacked.is_cuda:
                host = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=True)
                host.copy_(stacked, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                host, done = stacked.clone(), None
            new_pending = (start, len(window), host, done)
            self._polled_until = start + len(window)
        if pending is not None:
            events += self._process_poll_window(*pending)
        if flush:
            if new_pending is not None:
                events += self._process_poll_window(*new_pending)
        else:
            self._poll_pending = new_pending
        return events

    def _process_poll_window(self, start, count, host, done):
        """Fire keyframe callbacks and loop closing for one polled window."""
        if done is not None:
            done.synchronize()
            self.host_syncs += 1
        flags = host.numpy()
        events = []
        for k in range(count):
            fid = self._outs_fids[start + k]
            if flags[k, 0] < 1:
                self._frame_ring.pop(fid, None)
                continue
            kf_idx = int(flags[k, 1])
            frame = self._frame_ring.pop(fid, None)
            if frame is not None:
                self.last_frame = frame
            self.last_keyframe_frame_id = fid
            for cb in self.keyframe_events:
                cb(self, kf_idx)
            loop_info = self._close_loop(kf_idx, int(flags[k, 2]), float(flags[k, 3]))
            events.append({"frame_id": fid, "kf_idx": kf_idx, "loop": loop_info})
        return events

    def _close_loop(self, kf_idx: int, cand_idx: int, score: float) -> Optional[Dict]:
        """Loop closing for one new keyframe; its record, or None."""
        if self.loop_closer is None:
            return None
        before = self.loop_closer.host_syncs
        with self.log.scope("loop_closing", MODULE):
            info = self.loop_closer.on_keyframe(self, kf_idx, cand_idx=cand_idx, score=score)
        self.host_syncs += self.loop_closer.host_syncs - before
        if info:
            self.loop_events.append(info)
        return info

    def finalize(self):
        """Materialize the per-frame outputs of ``process_frame_async`` in ONE
        device->host transfer."""
        if self._poll_pending is not None:
            self._process_poll_window(*self._poll_pending)
            self._poll_pending = None
        if not self.outs_log:
            return {"n_inliers": [], "keyframes": []}
        flat = torch.cat([
            torch.stack([o.pose_wc.reshape(16) for o in self.outs_log]),
            torch.stack([torch.stack([o.n_inliers.float(), o.was_keyframe.float(),
                                      o.kf_idx.float(), o.ref_kf.float()])
                         for o in self.outs_log]),
            torch.stack([o.ref_T_cw_R.reshape(9) for o in self.outs_log]),
            torch.stack([o.ref_T_cw_t for o in self.outs_log]),
        ], dim=1).cpu().numpy()
        self.host_syncs += 1
        for row in flat:
            self.trajectory.append(row[:16].reshape(4, 4).astype(np.float64))
            self._traj_ref.append((int(row[19]), lie.SE3(torch.as_tensor(row[20:29].reshape(3, 3)),
                                                         torch.as_tensor(row[29:32]))))
        stats = {
            "n_inliers": [int(v) for v in flat[:, 16]],
            "keyframes": [int(row[18]) for row in flat if row[17] > 0.5],
        }
        self._materialize_loop_events()
        self.outs_log = []
        self._outs_fids = []
        self._polled_until = 0
        return stats

    def _materialize_loop_events(self):
        """The loop records' device scalars (chi2 values, the scale found) as
        floats, in one read: they stay on the device during the run so that a
        correction never makes the camera loop wait."""
        cells = [(ev, k) for ev in self.loop_events for k, v in ev.items()
                 if isinstance(v, torch.Tensor)]
        if not cells:
            return
        vals = torch.stack([ev[k].float().reshape(()) for ev, k in cells]).cpu().tolist()
        self.host_syncs += 1
        for (ev, k), v in zip(cells, vals):
            ev[k] = v

    def process_prepared(self, frame: tr.StereoFrame) -> Dict:
        """Backend step on an already-extracted frame, with one packed read
        of the frame's control scalars and pose; then relocalization when the
        tracker is lost, and loop closing on a keyframe."""
        cfg = self.cfg
        with self.log.scope("backend_step", MODULE):
            outs = self._step(frame)
            v = torch.cat([
                torch.stack([outs.n_inliers.float(), outs.was_keyframe.float(),
                             outs.kf_idx.float(), outs.ref_kf.float(),
                             self.state.lost_frames.float(), outs.loop_cand.float(),
                             outs.loop_score]),
                outs.pose_wc.reshape(16),
            ]).cpu().numpy()
            self.host_syncs += 1
        n_inl, was_kf, kf_idx_h, ref_kf = int(v[0]), bool(v[1] > 0.5), int(v[2]), int(v[3])
        lost_frames_h, loop_cand_h, loop_score_h = int(v[4]), int(v[5]), float(v[6])
        pose_wc_np = v[7:23].reshape(4, 4).astype(np.float64)

        info: Dict = {
            "frame_id": self.frame_id,
            "keyframe": was_kf,
            "n_inliers": n_inl,
            "lost": self._initialized and n_inl < cfg.tracking.min_inliers,
            "pose_wc": pose_wc_np,
        }
        self.last_frame = frame
        if (info["lost"] and cfg.tracking.reloc_enabled
                and lost_frames_h >= cfg.tracking.reloc_after_lost):
            if self._try_relocalize(frame):
                info["relocalized"] = True
        if was_kf:
            self._initialized = True
            self.last_keyframe_frame_id = self.frame_id
            for cb in self.keyframe_events:
                cb(self, kf_idx_h)
            loop_info = self._close_loop(kf_idx_h, loop_cand_h, loop_score_h)
            if loop_info:
                info["loop"] = loop_info
        self.trajectory.append(pose_wc_np)
        # reference-keyframe anchor through the map as it stands now (a loop
        # correction of this frame moved it), kept on the device
        self._traj_ref.append((ref_kf, lie.SE3(self.map.kf_T_cw.R[ref_kf],
                                               self.map.kf_T_cw.t[ref_kf])))
        self.frame_id += 1
        return info

    def refine_map(self, cycles: int = 4, gba_iters: int = 15, stereo_weight: float = 1.0):
        """Deferred full-map refinement: ``cycles`` rounds of landmark
        re-triangulation (``ba.retriangulate_points``) and global BA, the
        analog of the full BA ORB-SLAM3's loop-closing thread runs in the
        background. A drifted map is a local minimum of the reprojection
        objective with poses and landmarks complicit; re-deriving the
        landmarks under the current poses breaks that, and GBA descends.
        Call it at mission end, at idle time or after the last expected loop.
        The tracker is re-based by delta composition, as after a loop
        correction. Returns the last cycle's GBA chi2 (device scalar)."""
        m = self.map
        j = max(int(m.n_kf) - 1, 0)
        self.host_syncs += 1
        T_j_old = lie.SE3(m.kf_T_cw.R[j], m.kf_T_cw.t[j])
        chi2 = None
        for _ in range(cycles):
            obs = ba.Observations(kf=m.obs_kf, lm=m.obs_lm, uvr=m.obs_uvr,
                                  sigma2=m.obs_sigma2, valid=m.obs_valid)
            m = m._replace(lm_pos=ba.retriangulate_points(
                self.K, m.kf_T_cw, m.lm_pos, obs, m.lm_valid, stereo_weight=stereo_weight))
            m, stats = sm.global_ba(m, self.K, iters=gba_iters)
            chi2 = stats.chi2[-1]
        self.map = m
        T_j_new = lie.SE3(m.kf_T_cw.R[j], m.kf_T_cw.t[j])
        T_cur = lie.compose(lie.compose(self.state.T_cw, lie.inverse(T_j_old)), T_j_new)
        self.state = self.state._replace(T_cw=T_cur, T_cw_last_kf=T_cur)
        return chi2

    def corrected_trajectory(self) -> List[np.ndarray]:
        """The trajectory with every frame re-anchored through its reference
        keyframe's current pose, so that past poses follow loop and GBA
        corrections (the full-trajectory rewrite ORB-SLAM3 performs before
        evaluation). One read of the keyframe poses and the anchors."""
        if len(self._traj_ref) != len(self.trajectory):
            return list(self.trajectory)
        now = lie.inverse(self.map.kf_T_cw).matrix()
        # anchors of the synchronous step are on the device, those that
        # finalize() read back are on the host: one read for the former
        then = [T.matrix() for _, T in self._traj_ref]
        on_dev = [n for n, M in enumerate(then) if M.device != torch.device("cpu")]
        pulled = torch.cat([now] + [then[n][None] for n in on_dev]).cpu().numpy()
        self.host_syncs += 1
        K_cap = now.shape[0]
        for r, n in enumerate(on_dev):
            then[n] = pulled[K_cap + r]
        kf_T_wc_now = pulled[:K_cap]
        return [kf_T_wc_now[k] @ (np.asarray(T_cw) @ T_then) for T_then, (k, _), T_cw
                in zip(self.trajectory, self._traj_ref, then)]

    # ------------------------------------------------------------------
    # Relocalization (ORB-SLAM3 place-recognition re-entry, S1)
    # ------------------------------------------------------------------

    def _try_relocalize(self, frame: tr.StereoFrame) -> bool:
        """Query the keyframes' place signatures with the lost frame, verify
        the best candidate against its landmarks and re-lock the tracker
        there; crossing into another Atlas map switches the active map id.
        Two reads, as in the reference: the candidate's score, then the
        inlier count."""
        cfg = self.cfg.tracking
        m = self.map
        K_cap = m.kf_valid.shape[0]
        sig = signature_from_descriptors(frame.feats.desc, frame.feats.valid)
        # no temporal gap: every valid keyframe is a relocalization target
        cand = detect_loop(m, sig, K_cap + 1, min_gap=-K_cap)
        self.host_syncs += 1
        if float(cand.score) < cfg.reloc_min_score:
            return False
        T_loop, n_inl = verify_loop(self.K, m, frame, cand.kf_idx)
        self.host_syncs += 1
        if int(n_inl) < cfg.reloc_min_inliers:
            return False
        dev = m.kf_valid.device
        self.state = self.state._replace(
            T_cw=T_loop, T_cw_last_kf=T_loop,
            velocity=torch.zeros((6,), dtype=torch.float32, device=dev),
            lost_frames=torch.zeros((), dtype=torch.int32, device=dev),
            map_id=tr.take(m.kf_map_id, cand.kf_idx),
        )
        return True

    # ------------------------------------------------------------------
    # Service surface (reference: slam_msgs services, SURVEY.md §1 L2→up)
    # ------------------------------------------------------------------

    def get_landmarks_in_view(self, T_wc: lie.SE3, max_distance: float = 14.0):
        """`orb_slam3/get_landmarks_in_view` equivalent: camera-frame landmark
        positions + mask (FisherInfoManager.cpp:60-78 call contract), on the
        device, with no read back."""
        return sm.landmarks_in_view(self.map, self.K, T_wc, max_distance,
                                    self.cfg.camera.width, self.cfg.camera.height)

    def get_map_data(self):
        """`orb_slam3_get_map_data` equivalent: keyframe graph + landmarks
        (one read of the keyframe count)."""
        n_kf = int(self.map.n_kf)
        self.host_syncs += 1
        return {
            "kf_poses_T_cw": lie.SE3(self.map.kf_T_cw.R[:n_kf], self.map.kf_T_cw.t[:n_kf]),
            "kf_frame_ids": self.map.kf_frame_id[:n_kf],
            "landmarks": self.map.lm_pos,
            "landmarks_valid": self.map.lm_valid,
        }

    @property
    def current_pose_wc(self) -> lie.SE3:
        return lie.inverse(self.state.T_cw)
