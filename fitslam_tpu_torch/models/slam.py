"""The stereo SLAM engine (port of ``StereoSlam`` in
``fitslam_tpu/models/slam.py``): host orchestration of the frame step.

This slice covers ``process_frame``, ``process_frame_async``,
``process_prepared[_async]``, ``poll_keyframe_events`` and ``finalize`` with
loop closing and relocalization off; asking for either raises.

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
from fitslam_tpu_torch.models.slam_step import StepOutputs, _backend_body
from fitslam_tpu_torch.ops import lie
from fitslam_tpu_torch.ops.geometry import Intrinsics
from fitslam_tpu_torch.utils.config import FitSlamConfig
from fitslam_tpu_torch.utils.profiling import MODULE, EventLogger

_NOT_PORTED = "is not ported yet (ROADMAP queue 1 item 10); set it to False"


class StereoSlam:
    """Stereo SLAM system with fixed-capacity state on ``device``."""

    def __init__(self, cfg: FitSlamConfig, device="cuda",
                 event_logger: Optional[EventLogger] = None):
        if cfg.loop.enabled:
            raise NotImplementedError(f"loop closing (cfg.loop.enabled) {_NOT_PORTED}")
        if cfg.tracking.reloc_enabled:
            raise NotImplementedError(f"relocalization (cfg.tracking.reloc_enabled) {_NOT_PORTED}")
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

    # ------------------------------------------------------------------
    # Frame pipeline
    # ------------------------------------------------------------------

    def _frontend(self, img_left, img_right) -> tr.StereoFrame:
        o = self.cfg.orb
        return tr.process_stereo(self.K, img_left, img_right, num_features=o.num_features,
                                 num_levels=o.num_levels, scale_factor=o.scale_factor,
                                 fast_threshold=o.fast_threshold)

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
        if self.keyframe_events:
            self._frame_ring[self.frame_id] = frame
        self._initialized = True
        self.frame_id += 1
        return outs

    def poll_keyframe_events(self, flush: bool = True):
        """Batched keyframe-event poll for the async path: one packed
        device->host copy of (was_keyframe, kf_idx, loop_cand, loop_score)
        for every frame since the last poll, then keyframe callbacks fire.

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
        """Fire keyframe callbacks for one polled window."""
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
            events.append({"frame_id": fid, "kf_idx": kf_idx, "loop": None})
        return events

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
        self.outs_log = []
        self._outs_fids = []
        self._polled_until = 0
        return stats

    def process_prepared(self, frame: tr.StereoFrame) -> Dict:
        """Backend step on an already-extracted frame, with one packed read
        of the frame's control scalars and pose."""
        cfg = self.cfg
        with self.log.scope("backend_step", MODULE):
            outs = self._step(frame)
            v = torch.cat([
                torch.stack([outs.n_inliers.float(), outs.was_keyframe.float(),
                             outs.kf_idx.float(), outs.ref_kf.float()]),
                outs.pose_wc.reshape(16),
            ]).cpu().numpy()
            self.host_syncs += 1
        n_inl, was_kf, kf_idx_h, ref_kf = int(v[0]), bool(v[1] > 0.5), int(v[2]), int(v[3])
        pose_wc_np = v[4:20].reshape(4, 4).astype(np.float64)

        info: Dict = {
            "frame_id": self.frame_id,
            "keyframe": was_kf,
            "n_inliers": n_inl,
            "lost": self._initialized and n_inl < cfg.tracking.min_inliers,
            "pose_wc": pose_wc_np,
        }
        self.last_frame = frame
        if was_kf:
            self._initialized = True
            self.last_keyframe_frame_id = self.frame_id
            for cb in self.keyframe_events:
                cb(self, kf_idx_h)
        self.trajectory.append(pose_wc_np)
        # reference-keyframe anchor, kept on the device (no extra read)
        self._traj_ref.append((ref_kf, lie.SE3(outs.ref_T_cw_R, outs.ref_T_cw_t)))
        self.frame_id += 1
        return info
