"""The SLAM backend step: tracking + conditional keyframe pipeline (port of
``_backend_body`` in ``fitslam_tpu/models/slam_step.py``).

The reference's three ``lax.cond``s are host branches here:
- ``initialized`` is known on the host (``StereoSlam`` mirrors it: the
  tracker becomes initialized exactly when a keyframe is inserted);
- ``can_insert`` costs one ``.item()`` every frame;
- the landmark-recycling test costs one more ``.item()`` on keyframe frames.
Those reads are the step's only host syncs; ``_backend_body`` returns their
count and the inserted flag so callers can mirror and report them. With
``loop_min_gap > 0`` a keyframe's loop candidate is retrieved inside the step
(``loop_closing.detect_loop``) and rides the frame's outputs to the poll.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from fitslam_tpu_torch.models import slam_map as sm
from fitslam_tpu_torch.models import tracking as tr
from fitslam_tpu_torch.models.loop_closing import detect_loop
from fitslam_tpu_torch.ops import lie
from fitslam_tpu_torch.ops.geometry import Intrinsics
from fitslam_tpu_torch.ops.place import signature_from_descriptors


class StepOutputs(NamedTuple):
    n_inliers: torch.Tensor     # () int32
    was_keyframe: torch.Tensor  # () bool
    kf_idx: torch.Tensor        # () int32 (-1 unless was_keyframe)
    pose_wc: torch.Tensor       # (4, 4) world-from-camera
    ref_kf: torch.Tensor        # () int32 reference keyframe at this frame
    ref_T_cw_R: torch.Tensor    # (3, 3) reference KF camera-from-world then
    ref_T_cw_t: torch.Tensor    # (3,)
    loop_cand: torch.Tensor     # () int32 loop candidate keyframe (-1 unless detected)
    loop_score: torch.Tensor    # () float32 its retrieval score (-inf unless detected)


def _backend_body(
    K: Intrinsics,
    m: sm.SlamMap,
    state: tr.TrackState,
    frame: tr.StereoFrame,
    frame_id: int,
    *,
    initialized: bool,
    search_radius, match_max_hamming, min_inliers, width, height, pose_iters,
    kf_min_interval, kf_translation, kf_rotation, kf_min_tracked_ratio,
    scale_factor, ba_window, ba_max_obs, ba_iters, cull_min_obs,
    wide_radius=96.0, reinit_after_lost=6, match_ratio=0.8, ba_covis=True,
    recycle_at_fraction=0.92, recycle_target_fraction=0.7, loop_min_gap=0,
    max_spawn_depth=1e9,
) -> Tuple[sm.SlamMap, tr.TrackState, StepOutputs, bool, int]:
    """One frame through the backend. ``initialized`` must equal
    ``state.initialized``. Returns (map, state, outputs, whether a keyframe
    was inserted, host syncs)."""
    dev = frame.depth.device
    num_features = frame.feats.capacity

    if initialized:
        state2, lm_match, n_inl = tr.track_frame(
            K, m, state, frame,
            search_radius=search_radius, wide_radius=wide_radius,
            match_max_hamming=match_max_hamming, match_ratio=match_ratio,
            min_inliers=min_inliers, width=width, height=height,
            pose_iters=pose_iters, sigma_scale=scale_factor,
        )
        need = tr.need_keyframe(state2, n_inl, kf_min_interval, kf_translation,
                                kf_rotation, kf_min_tracked_ratio)
    else:
        state2 = state
        lm_match = torch.full((num_features,), -1, dtype=torch.int32, device=dev)
        n_inl = torch.zeros((), dtype=torch.int32, device=dev)
        need = torch.ones((), dtype=torch.bool, device=dev)

    K_cap = m.kf_valid.shape[0]
    # never mint a keyframe from a lost tracker, unless loss has persisted
    # long enough that a re-initialization keyframe is the only way back
    healthy = (n_inl >= min_inliers) | torch.logical_not(state.initialized)
    reinit = state2.lost_frames >= reinit_after_lost
    can_insert_t = need & (m.n_kf < K_cap) & (healthy | reinit)
    can_insert = bool(can_insert_t.item())
    syncs = 1

    neg1 = torch.full((), -1, dtype=torch.int32, device=dev)
    neg_inf = torch.full((), float("-inf"), dtype=torch.float32, device=dev)
    if can_insert:
        sig = signature_from_descriptors(frame.feats.desc, frame.feats.valid)
        new_map_id = (state2.map_id + reinit.to(torch.int32)).to(torch.int32)
        m2 = sm.insert_keyframe(
            m, K, state2.T_cw, frame.feats, frame.depth, lm_match,
            torch.full((), frame_id, dtype=torch.int32, device=dev), sig,
            scale_factor=scale_factor, map_id=new_map_id, max_spawn_depth=max_spawn_depth,
        )
        m3 = sm.local_ba(m2, K, window=ba_window, max_obs_local=ba_max_obs,
                         iters=ba_iters, covis=ba_covis)
        m_out = sm.cull_landmarks(m3, min_obs=cull_min_obs)
        if recycle_at_fraction > 0:
            L_cap = m_out.lm_valid.shape[0]
            syncs += 1
            if bool((m_out.n_lm > int(recycle_at_fraction * L_cap)).item()):
                m_out = sm.compact_map(m_out, target_fraction=recycle_target_fraction)
        kf_idx = (m2.n_kf - 1).to(torch.int32)
        state_out = tr.rebase_to_kf(state2, m_out.kf_T_cw.R, m_out.kf_T_cw.t, kf_idx)
        state_out = tr.mark_keyframe(state_out, n_inl)
        state_out = state_out._replace(map_id=new_map_id)
        if loop_min_gap > 0:
            # retrieval against the just-updated keyframe database
            loop_cand, loop_score = detect_loop(m_out, sig, kf_idx, min_gap=loop_min_gap)
        else:
            loop_cand, loop_score = neg1, neg_inf
    else:
        m_out, state_out, kf_idx = m, state2, neg1
        loop_cand, loop_score = neg1, neg_inf

    ref = torch.clamp(m_out.n_kf - 1, min=0).to(torch.int32)
    outs = StepOutputs(
        n_inliers=n_inl,
        was_keyframe=can_insert_t,
        kf_idx=kf_idx,
        pose_wc=lie.inverse(state_out.T_cw).matrix(),
        ref_kf=ref,
        ref_T_cw_R=tr.take(m_out.kf_T_cw.R, ref),
        ref_T_cw_t=tr.take(m_out.kf_T_cw.t, ref),
        loop_cand=loop_cand,
        loop_score=loop_score,
    )
    return m_out, state_out, outs, can_insert, syncs
