"""Frame tracking: stereo frontend + motion-model pose tracking (port of
``fitslam_tpu/models/tracking.py``).

The per-frame "thread" is a function ``(state, frame) -> (state, outputs)``
on fixed-shape tensors. The reference's two ``lax.map``s over the 11 pan
hypotheses are a batch dimension here, the narrow and wide pose solves run
as one batch of two, and every branch is a ``torch.where``: nothing in this
module waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from fitslam_tpu_torch.ops import ba, lie, matching, orb
from fitslam_tpu_torch.ops.geometry import Intrinsics, depth_from_disparity
from fitslam_tpu_torch.models.slam_map import SlamMap, landmarks_in_view


class StereoFrame(NamedTuple):
    """Processed stereo frame: left features + per-feature depth."""

    feats: orb.FrameFeatures
    depth: torch.Tensor  # (N,) float32; 0 where no stereo match


class TrackState(NamedTuple):
    T_cw: lie.SE3                  # current camera-from-world
    velocity: torch.Tensor         # (6,) tangent increment per frame
    T_cw_last_kf: lie.SE3
    frames_since_kf: torch.Tensor  # () int32
    kf_ref_inliers: torch.Tensor   # () int32 — inliers when last KF was made
    initialized: torch.Tensor      # () bool
    lost_frames: torch.Tensor      # () int32 consecutive frames below min_inliers
    map_id: torch.Tensor           # () int32 active Atlas map


def init_track_state(device="cuda") -> TrackState:
    i32 = dict(dtype=torch.int32, device=device)
    return TrackState(
        T_cw=lie.SE3.identity(device=device),
        velocity=torch.zeros((6,), dtype=torch.float32, device=device),
        T_cw_last_kf=lie.SE3.identity(device=device),
        frames_since_kf=torch.zeros((), **i32),
        kf_ref_inliers=torch.zeros((), **i32),
        initialized=torch.zeros((), dtype=torch.bool, device=device),
        lost_frames=torch.zeros((), **i32),
        map_id=torch.zeros((), **i32),
    )


def take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``a[i]`` for a 0-d index tensor, without reading the index on the host."""
    return a.index_select(0, i.reshape(1).long())[0]


def _where_tree(cond: torch.Tensor, a, b):
    if isinstance(a, torch.Tensor):
        c = cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim()))
        return torch.where(c, a, b)
    return type(a)(*(_where_tree(cond, x, y) for x, y in zip(a, b)))


def process_stereo(
    K: Intrinsics,
    img_left: torch.Tensor,
    img_right: torch.Tensor,
    num_features: int = 1024,
    num_levels: int = 4,
    scale_factor: float = 1.4142135,
    fast_threshold: float = 20.0,
) -> StereoFrame:
    """Extract ORB on both images and stereo-match (K2) for per-feature depth,
    refined to sub-pixel disparity by patch correlation."""
    fl = orb.extract_orb(img_left, num_features, num_levels, scale_factor, fast_threshold)
    fr = orb.extract_orb(img_right, num_features, num_levels, scale_factor, fast_threshold)
    max_disp = K.bf / 0.3  # depth >= 0.3 m
    m, disparity = matching.match_stereo(
        orb.pack_descriptors(fl.desc), fl.valid, orb.pack_descriptors(fr.desc), fr.valid,
        fl.xy, fr.xy, fl.level, fr.level, max_disparity=max_disp)
    x_r = fr.xy[m.idx_b.long(), 0]
    d_ref, ref_ok = matching.refine_disparity_subpixel(img_left, img_right, fl.xy, x_r, m.valid)
    consistent = ref_ok & (torch.abs(d_ref - disparity) <= 1.5)
    disparity = torch.where(consistent, d_ref, torch.zeros_like(d_ref))
    return StereoFrame(fl, depth_from_disparity(K, disparity))


def process_rgbd(
    K: Intrinsics,
    img: torch.Tensor,
    depth_img: torch.Tensor,
    num_features: int = 1024,
    num_levels: int = 4,
    scale_factor: float = 1.4142135,
    fast_threshold: float = 20.0,
    max_depth: float = 14.0,
) -> StereoFrame:
    """RGB-D frontend (reference: orb_slam3 rgbd mode, rgbd.launch.py —
    SURVEY.md §2.1 S2): ORB on the intensity image (one K1 launch), the
    per-feature depth read from the registered depth image. Produces the
    same StereoFrame the stereo path does, so the backend is unchanged."""
    fl = orb.extract_orb(img, num_features, num_levels, scale_factor, fast_threshold)
    H, W = depth_img.shape
    iu = torch.clamp(torch.round(fl.xy[:, 0]).to(torch.int32), 0, W - 1).long()
    iv = torch.clamp(torch.round(fl.xy[:, 1]).to(torch.int32), 0, H - 1).long()
    d = depth_img[iv, iu]
    d = torch.where((d > 0.1) & (d < max_depth) & fl.valid, d, torch.zeros_like(d))
    return StereoFrame(fl, d)


def _pan_multipliers(device) -> torch.Tensor:
    """[0, -1, 1, -2, 2, ..., -5, 5]: zero offset first so it wins ties."""
    k = torch.arange(11, device=device)
    return torch.where(k % 2 == 1, -((k + 1) // 2), k // 2).float()


def track_frame(
    K: Intrinsics,
    m: SlamMap,
    state: TrackState,
    frame: StereoFrame,
    search_radius: float = 24.0,
    wide_radius: float = 96.0,
    match_max_hamming: int = 64,
    match_ratio: float = 0.8,
    min_inliers: int = 15,
    width: int = 640,
    height: int = 480,
    pose_iters: int = 8,
    sigma_scale: float = 1.4142135,
) -> Tuple[TrackState, torch.Tensor, torch.Tensor]:
    """One tracking step. Returns (new_state, lm_match (N,) int32 landmark
    index per feature (-1 = unmatched), inlier count)."""
    feats = frame.feats
    dev = feats.xy.device
    T_pred = lie.compose(lie.se3_exp(state.velocity), state.T_cw)

    # the candidate count below reads the dense int16 matrix; the matches
    # themselves run on K2 from packed descriptors
    dist = matching.hamming_matrix(feats.desc, m.lm_desc, feats.valid, m.lm_valid)
    bits_f = orb.pack_descriptors(feats.desc)
    bits_m = orb.pack_descriptors(m.lm_desc)

    u_r = torch.where(
        frame.depth > 1e-3,
        feats.xy[:, 0] - K.bf / torch.clamp(frame.depth, min=1e-3),
        torch.full_like(frame.depth, -1.0),
    )
    uvr = torch.cat([feats.xy, u_r[:, None]], dim=-1)
    sigma2 = (sigma_scale ** feats.level.float()) ** 2
    lm_map_ok = m.kf_map_id[m.lm_anchor_kf.long()] == state.map_id

    def project_uv(T_base: lie.SE3) -> torch.Tensor:
        p_c, vis = landmarks_in_view(m, K, lie.inverse(T_base), 40.0, width, height)
        vis = vis & lm_map_ok
        z = p_c[..., 2]
        z_safe = torch.where(z > 1e-3, z, torch.ones_like(z))
        lm_uv = torch.stack([K.fx * p_c[..., 0] / z_safe + K.cx,
                             K.fy * p_c[..., 1] / z_safe + K.cy], dim=-1)
        return torch.where(vis[..., None], lm_uv, torch.full_like(lm_uv, -1e6))

    def match_at(lm_uv: torch.Tensor, radius: float) -> matching.Matches:
        return matching.match_windowed(bits_f, feats.valid, bits_m, m.lm_valid,
                                       feats.xy, lm_uv, radius,
                                       max_distance=match_max_hamming, ratio=match_ratio)

    def solve(T_base: lie.SE3, mts) -> Tuple[lie.SE3, torch.Tensor]:
        """Pose solves for a batch of (start pose, matches) pairs."""
        idx = torch.stack([mt.idx_b.long() for mt in mts])
        valid = torch.stack([mt.valid for mt in mts])
        B = len(mts)
        T_new, inl, _ = ba.solve_pose(
            K, T_base, m.lm_pos[idx], uvr.expand(B, -1, -1), sigma2.expand(B, -1),
            valid, iters=pose_iters)
        return T_new, inl

    # rotation-hypothesis sweep: score pan offsets around the prediction by
    # the cheap in-window candidate count, then run the full ratio-test match
    # only at the winning offset
    spacing = 0.8 * search_radius / K.fx
    xi = torch.zeros((11, 6), dtype=torch.float32, device=dev)
    xi[:, 4] = spacing * _pan_multipliers(dev)
    T_hs = lie.compose(lie.se3_exp(xi), T_pred)
    lm_uvs = project_uv(T_hs)                        # (11, L, 2)
    good = dist <= match_max_hamming                 # (Na, Nb), computed once
    r2 = search_radius * search_radius
    d2 = ((feats.xy[None, :, None, 0] - lm_uvs[:, None, :, 0]) ** 2
          + (feats.xy[None, :, None, 1] - lm_uvs[:, None, :, 1]) ** 2)
    counts = torch.sum((d2 <= r2) & good, dim=(1, 2))
    best = torch.argmax(counts)
    T_best = lie.SE3(take(T_hs.R, best), take(T_hs.t, best))
    mt_n = match_at(take(lm_uvs, best), search_radius)

    # wide-window fallback at the raw prediction, solved in the same batch
    mt_w = match_at(project_uv(T_pred), wide_radius)
    T_nw, inl_nw = solve(lie.SE3(torch.stack([T_best.R, T_pred.R]),
                                 torch.stack([T_best.t, T_pred.t])), (mt_n, mt_w))
    narrow_ok = torch.sum(inl_nw[0]) >= min_inliers
    mt = _where_tree(narrow_ok, mt_n, mt_w)
    T_new = _where_tree(narrow_ok, lie.SE3(T_nw.R[0], T_nw.t[0]), lie.SE3(T_nw.R[1], T_nw.t[1]))
    inl = torch.where(narrow_ok, inl_nw[0], inl_nw[1])

    # second association pass at the solved pose (the reference's
    # refine_pass, which every caller leaves on)
    mt_r = match_at(project_uv(T_new), 0.5 * search_radius)
    T_r, inl_r = solve(lie.SE3(T_new.R[None], T_new.t[None]), (mt_r,))
    T_r, inl_r = lie.SE3(T_r.R[0], T_r.t[0]), inl_r[0]
    refine_ok = torch.sum(inl_r) >= torch.sum(inl)
    mt = _where_tree(refine_ok, mt_r, mt)
    T_new = _where_tree(refine_ok, T_r, T_new)
    inl = torch.where(refine_ok, inl_r, inl)

    n_inl = torch.sum(inl).to(torch.int32)
    tracked_ok = n_inl >= min_inliers
    T_out = _where_tree(tracked_ok, T_new, T_pred)
    vel = torch.where(tracked_ok,
                      lie.se3_log(lie.compose(T_out, lie.inverse(state.T_cw))),
                      torch.zeros((6,), dtype=torch.float32, device=dev))
    lm_match = torch.where(mt.valid & inl, mt.idx_b, -1).to(torch.int32)
    new_state = state._replace(
        T_cw=T_out,
        velocity=vel,
        frames_since_kf=(state.frames_since_kf + 1).to(torch.int32),
        lost_frames=torch.where(tracked_ok, 0, state.lost_frames + 1).to(torch.int32),
    )
    return new_state, lm_match, n_inl


def need_keyframe(state: TrackState, n_inliers: torch.Tensor, min_interval: int,
                  translation_thresh: float, rotation_thresh: float,
                  min_tracked_ratio: float) -> torch.Tensor:
    """Keyframe decision (() bool tensor)."""
    d = lie.se3_log(lie.compose(state.T_cw, lie.inverse(state.T_cw_last_kf)))
    trans = torch.linalg.norm(d[:3])
    rot = torch.linalg.norm(d[3:])
    weak = n_inliers.float() < min_tracked_ratio * torch.clamp(state.kf_ref_inliers.float(), min=1.0)
    moved = (trans > translation_thresh) | (rot > rotation_thresh)
    return (state.frames_since_kf >= min_interval) & (moved | weak)


def mark_keyframe(state: TrackState, n_inliers: torch.Tensor) -> TrackState:
    dev = state.frames_since_kf.device
    return state._replace(
        T_cw_last_kf=state.T_cw,
        frames_since_kf=torch.zeros((), dtype=torch.int32, device=dev),
        kf_ref_inliers=n_inliers.to(torch.int32),
        initialized=torch.ones((), dtype=torch.bool, device=dev),
        lost_frames=torch.zeros((), dtype=torch.int32, device=dev),
    )


def pose_matrix_wc(state: TrackState) -> torch.Tensor:
    """Current world-from-camera 4x4."""
    return lie.inverse(state.T_cw).matrix()


def rebase_to_kf(state: TrackState, kf_R: torch.Tensor, kf_t: torch.Tensor,
                 kf_idx: torch.Tensor) -> TrackState:
    """Sync the tracker to a (BA-refined) keyframe pose."""
    T = lie.SE3(take(kf_R, kf_idx), take(kf_t, kf_idx))
    return state._replace(T_cw=T, T_cw_last_kf=T)
