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

The step is cut at those two reads into regions, each a function of fixed-
shape tensors (``utils/jit.py``'s ``(writes, out)`` form): ``track_region``
(A, up to ``can_insert``; the uninitialized branch is its own region),
``keyframe_region`` (B: signature, insertion, local BA, culling and the
recycle test's value), ``compact_region`` (C) and ``finish_region`` /
``finish_keyframe_region`` (D: the re-base, the loop candidate and the
outputs). ``backend_step`` drives them through a runner: ``jit.run_eagerly``
for the eager step, a ``jit.Slot``'s ``run`` for the captured one.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from fitslam_tpu_torch.models import slam_map as sm
from fitslam_tpu_torch.models import tracking as tr
from fitslam_tpu_torch.models.loop_closing import detect_loop
from fitslam_tpu_torch.ops import lie
from fitslam_tpu_torch.ops.geometry import Intrinsics
from fitslam_tpu_torch.ops.place import signature_from_descriptors
from fitslam_tpu_torch.utils import jit, profiling


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


def track_region(K: Intrinsics, m: sm.SlamMap, state: tr.TrackState, frame: tr.StereoFrame,
                 *, initialized: bool, search_radius, match_max_hamming, min_inliers, width,
                 height, pose_iters, kf_min_interval, kf_translation, kf_rotation,
                 kf_min_tracked_ratio, scale_factor, wide_radius, reinit_after_lost,
                 match_ratio):
    """Region A: tracking and the keyframe test. Writes the tracked state;
    returns (lm_match, n_inl, reinit, can_insert)."""
    dev = frame.depth.device
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
        lm_match = torch.full((frame.feats.capacity,), -1, dtype=torch.int32, device=dev)
        n_inl = torch.zeros((), dtype=torch.int32, device=dev)
        need = torch.ones((), dtype=torch.bool, device=dev)

    K_cap = m.kf_valid.shape[0]
    # never mint a keyframe from a lost tracker, unless loss has persisted
    # long enough that a re-initialization keyframe is the only way back
    healthy = (n_inl >= min_inliers) | torch.logical_not(state.initialized)
    reinit = state2.lost_frames >= reinit_after_lost
    can_insert_t = need & (m.n_kf < K_cap) & (healthy | reinit)
    writes = (None, None, state2 if initialized else None)
    return writes, (lm_match, n_inl, reinit, can_insert_t)


def keyframe_region(K: Intrinsics, m: sm.SlamMap, state: tr.TrackState, frame: tr.StereoFrame,
                    lm_match, reinit, frame_id, *, scale_factor, max_spawn_depth, ba_window,
                    ba_max_obs, ba_iters, ba_covis, cull_min_obs, recycle_at_fraction):
    """Region B: keyframe insertion, local BA and culling. Writes the map;
    returns (signature, new map id, keyframe index, the recycle test)."""
    sig = signature_from_descriptors(frame.feats.desc, frame.feats.valid)
    new_map_id = (state.map_id + reinit.to(torch.int32)).to(torch.int32)
    m2 = sm.insert_keyframe(
        m, K, state.T_cw, frame.feats, frame.depth, lm_match, frame_id, sig,
        scale_factor=scale_factor, map_id=new_map_id, max_spawn_depth=max_spawn_depth,
    )
    m3 = sm.local_ba(m2, K, window=ba_window, max_obs_local=ba_max_obs,
                     iters=ba_iters, covis=ba_covis)
    m_out = sm.cull_landmarks(m3, min_obs=cull_min_obs)
    recycle = m_out.n_lm > int(recycle_at_fraction * m_out.lm_valid.shape[0])
    kf_idx = (m2.n_kf - 1).to(torch.int32)
    return (None, m_out), (sig, new_map_id, kf_idx, recycle)


def compact_region(m: sm.SlamMap, *, target_fraction):
    """Region C: landmark recycling. Writes the map."""
    return (sm.compact_map(m, target_fraction=target_fraction),), ()


def _outputs(m: sm.SlamMap, state: tr.TrackState, n_inl, was_kf, kf_idx, loop_cand,
             loop_score) -> Tuple[StepOutputs, torch.Tensor]:
    ref = torch.clamp(m.n_kf - 1, min=0).to(torch.int32)
    outs = StepOutputs(
        n_inliers=n_inl,
        was_keyframe=was_kf,
        kf_idx=kf_idx,
        pose_wc=lie.inverse(state.T_cw).matrix(),
        ref_kf=ref,
        ref_T_cw_R=tr.take(m.kf_T_cw.R, ref),
        ref_T_cw_t=tr.take(m.kf_T_cw.t, ref),
        loop_cand=loop_cand,
        loop_score=loop_score,
    )
    return outs, state.lost_frames


def finish_region(m: sm.SlamMap, state: tr.TrackState, n_inl, can_insert):
    """Region D of a frame that inserts no keyframe: the outputs, and the
    tracker's lost-frame count for the synchronous read."""
    dev = n_inl.device
    neg1 = torch.full((), -1, dtype=torch.int32, device=dev)
    neg_inf = torch.full((), float("-inf"), dtype=torch.float32, device=dev)
    return (), _outputs(m, state, n_inl, can_insert, neg1, neg1, neg_inf)


def finish_keyframe_region(m: sm.SlamMap, state: tr.TrackState, n_inl, can_insert, sig,
                           kf_idx, new_map_id, *, loop_min_gap):
    """Region D of a keyframe frame: the tracker re-based to the refined
    keyframe (written), the loop candidate, the outputs."""
    state_out = tr.rebase_to_kf(state, m.kf_T_cw.R, m.kf_T_cw.t, kf_idx)
    state_out = tr.mark_keyframe(state_out, n_inl)
    state_out = state_out._replace(map_id=new_map_id)
    if loop_min_gap > 0:
        # retrieval against the just-updated keyframe database
        loop_cand, loop_score = detect_loop(m, sig, kf_idx, min_gap=loop_min_gap)
    else:
        loop_cand = torch.full((), -1, dtype=torch.int32, device=n_inl.device)
        loop_score = torch.full((), float("-inf"), dtype=torch.float32, device=n_inl.device)
    return (None, state_out), _outputs(m, state_out, n_inl, can_insert, kf_idx, loop_cand,
                                       loop_score)


def backend_step(
    run: Callable,
    K: Intrinsics,
    m: sm.SlamMap,
    state: tr.TrackState,
    frame: tr.StereoFrame,
    frame_id: int,
    *,
    initialized: bool,
    frame_id_buf: Optional[torch.Tensor] = None,
    search_radius, match_max_hamming, min_inliers, width, height, pose_iters,
    kf_min_interval, kf_translation, kf_rotation, kf_min_tracked_ratio,
    scale_factor, ba_window, ba_max_obs, ba_iters, cull_min_obs,
    wide_radius=96.0, reinit_after_lost=6, match_ratio=0.8, ba_covis=True,
    recycle_at_fraction=0.92, recycle_target_fraction=0.7, loop_min_gap=0,
    max_spawn_depth=1e9,
):
    """One frame through the backend's regions, each run by ``run(name, fn,
    *args) -> (args with the region's writes, out)``. ``initialized`` must
    equal ``state.initialized``; ``frame_id_buf``, where given, is the () int32
    device tensor the frame id is written into for insertion. Returns (map,
    state, outputs, the tracker's lost-frame count, whether a keyframe was
    inserted, host syncs)."""
    track = functools.partial(
        track_region, initialized=initialized, search_radius=search_radius,
        match_max_hamming=match_max_hamming, min_inliers=min_inliers, width=width,
        height=height, pose_iters=pose_iters, kf_min_interval=kf_min_interval,
        kf_translation=kf_translation, kf_rotation=kf_rotation,
        kf_min_tracked_ratio=kf_min_tracked_ratio, scale_factor=scale_factor,
        wide_radius=wide_radius, reinit_after_lost=reinit_after_lost, match_ratio=match_ratio)
    (K, m, state, frame), (lm_match, n_inl, reinit, can_insert_t) = run(
        "track" if initialized else "track_uninitialized", track, K, m, state, frame)
    with profiling.host_read("backend_step.can_insert", can_insert_t.device):
        can_insert = bool(can_insert_t.item())
    syncs = 1

    if can_insert:
        if frame_id_buf is None:
            fid = torch.full((), frame_id, dtype=torch.int32, device=frame.depth.device)
        else:
            fid = frame_id_buf.fill_(frame_id)
        insert = functools.partial(
            keyframe_region, scale_factor=scale_factor, max_spawn_depth=max_spawn_depth,
            ba_window=ba_window, ba_max_obs=ba_max_obs, ba_iters=ba_iters, ba_covis=ba_covis,
            cull_min_obs=cull_min_obs, recycle_at_fraction=recycle_at_fraction)
        (K, m, state, frame, _, _, _), (sig, new_map_id, kf_idx, recycle) = run(
            "keyframe", insert, K, m, state, frame, lm_match, reinit, fid)
        if recycle_at_fraction > 0:
            syncs += 1
            with profiling.host_read("backend_step.recycle", recycle.device):
                recycle_now = bool(recycle.item())
            if recycle_now:
                (m,), _ = run("compact", functools.partial(
                    compact_region, target_fraction=recycle_target_fraction), m)
        (m, state, *_), (outs, lost) = run(
            "finish_keyframe", functools.partial(finish_keyframe_region,
                                                 loop_min_gap=loop_min_gap),
            m, state, n_inl, can_insert_t, sig, kf_idx, new_map_id)
    else:
        _, (outs, lost) = run("finish", finish_region, m, state, n_inl, can_insert_t)
    return m, state, outs, lost, can_insert, syncs


def _backend_body(
    K: Intrinsics,
    m: sm.SlamMap,
    state: tr.TrackState,
    frame: tr.StereoFrame,
    frame_id: int,
    *,
    initialized: bool,
    **settings,
) -> Tuple[sm.SlamMap, tr.TrackState, StepOutputs, bool, int]:
    """One frame through the backend, eagerly. ``initialized`` must equal
    ``state.initialized``. Returns (map, state, outputs, whether a keyframe
    was inserted, host syncs)."""
    m, state, outs, _, inserted, syncs = backend_step(
        jit.run_eagerly, K, m, state, frame, frame_id, initialized=initialized, **settings)
    return m, state, outs, inserted, syncs
