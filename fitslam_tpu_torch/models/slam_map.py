"""Fixed-capacity SLAM map state (port of ``fitslam_tpu/models/slam_map.py``).

The map is one NamedTuple of fixed-capacity tensors with validity masks and
scalar counters, field for field as in the reference; every mutation is a
function returning a new map.

Two things differ from the reference by necessity:
- JAX drops out-of-range scatter indices (``mode="drop"``); torch raises on
  the CPU and hits a device-side assert on CUDA. Every such scatter goes
  through ``_set_drop`` / ``_add_drop``, which route out-of-range rows to a
  spare slot that is cut off afterwards.
- Nothing here may wait for the device, so ``jnp.nonzero(size=...)`` is
  ``_nonzero_fixed`` (a prefix-sum scatter) and every sort that picks by rank
  is stable, so ties break by index as ``lax.top_k`` breaks them.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from fitslam_tpu_torch.ops import lie
from fitslam_tpu_torch.ops.ba import BAProblem, Observations, bundle_adjust
from fitslam_tpu_torch.ops.geometry import Intrinsics, backproject
from fitslam_tpu_torch.ops.numerics import top_k_stable
from fitslam_tpu_torch.ops.orb import FrameFeatures


class SlamMap(NamedTuple):
    # --- keyframes (capacity K) ---
    kf_T_cw: lie.SE3              # (K,) camera-from-world
    kf_valid: torch.Tensor        # (K,) bool
    kf_frame_id: torch.Tensor     # (K,) int32 source frame index
    kf_signature: torch.Tensor    # (K, D) float32 place-recognition signature
    kf_map_id: torch.Tensor       # (K,) int32 Atlas map membership
    # --- landmarks (capacity L) ---
    lm_pos: torch.Tensor          # (L, 3) world
    lm_desc: torch.Tensor         # (L, 256) ±1 bfloat16 representative descriptor
    lm_valid: torch.Tensor        # (L,) bool
    lm_nobs: torch.Tensor         # (L,) int32
    lm_anchor_kf: torch.Tensor    # (L,) int32
    lm_pos_anchor: torch.Tensor   # (L, 3) position in anchor-KF camera frame
    # --- observations (capacity O) ---
    obs_kf: torch.Tensor          # (O,) int32
    obs_lm: torch.Tensor          # (O,) int32
    obs_uvr: torch.Tensor         # (O, 3)
    obs_sigma2: torch.Tensor      # (O,)
    obs_valid: torch.Tensor       # (O,) bool
    # --- counters ---
    n_kf: torch.Tensor            # () int32
    n_lm: torch.Tensor            # () int32
    n_obs: torch.Tensor           # () int32

    @property
    def capacity(self) -> Tuple[int, int, int]:
        return (self.kf_valid.shape[0], self.lm_valid.shape[0], self.obs_valid.shape[0])


def empty_map(max_keyframes: int, max_landmarks: int, max_observations: int,
              signature_dim: int = 256, device="cuda") -> SlamMap:
    K, L, O = max_keyframes, max_landmarks, max_observations
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    b = dict(dtype=torch.bool, device=device)
    return SlamMap(
        kf_T_cw=lie.SE3.identity((K,), device=device),
        kf_valid=torch.zeros((K,), **b),
        kf_frame_id=torch.zeros((K,), **i32),
        kf_signature=torch.zeros((K, signature_dim), **f32),
        kf_map_id=torch.zeros((K,), **i32),
        lm_pos=torch.zeros((L, 3), **f32),
        lm_desc=torch.zeros((L, 256), dtype=torch.bfloat16, device=device),
        lm_valid=torch.zeros((L,), **b),
        lm_nobs=torch.zeros((L,), **i32),
        lm_anchor_kf=torch.zeros((L,), **i32),
        lm_pos_anchor=torch.zeros((L, 3), **f32),
        obs_kf=torch.zeros((O,), **i32),
        obs_lm=torch.zeros((O,), **i32),
        obs_uvr=torch.zeros((O, 3), **f32),
        obs_sigma2=torch.ones((O,), **f32),
        obs_valid=torch.zeros((O,), **b),
        n_kf=torch.zeros((), **i32),
        n_lm=torch.zeros((), **i32),
        n_obs=torch.zeros((), **i32),
    )


# ---------------------------------------------------------------------------
# Scatter / select helpers with the reference's out-of-range semantics
# ---------------------------------------------------------------------------


def _routed(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Indices with every out-of-range entry sent to the spare slot n."""
    idx = idx.long()
    return torch.where((idx >= 0) & (idx < n), idx, n)


def _set_drop(buf: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``buf.at[idx].set(vals, mode="drop")`` for unique in-range indices."""
    n = buf.shape[0]
    ext = torch.cat([buf, buf[:1]], dim=0)
    if not isinstance(vals, torch.Tensor):
        # index_fill_ takes the scalar by value; an indexed assignment of a
        # Python number would copy it to the device and wait for the copy
        return ext.index_fill_(0, _routed(idx, n), vals)[:n]
    ext[_routed(idx, n)] = torch.broadcast_to(vals.to(buf.dtype),
                                              (idx.shape[0],) + tuple(buf.shape[1:]))
    return ext[:n]


def _add_drop(buf: torch.Tensor, idx: torch.Tensor, value) -> torch.Tensor:
    """``buf.at[idx].add(value, mode="drop")`` for a scalar value or one value
    an index; indices may repeat (use it for integers, which add exactly in
    any order)."""
    n = buf.shape[0]
    ext = torch.cat([buf, buf[:1]], dim=0)
    shape = (idx.shape[0],) + tuple(buf.shape[1:])
    if isinstance(value, torch.Tensor):
        vals = torch.broadcast_to(value.to(buf.dtype), shape)
    else:
        vals = torch.full(shape, value, dtype=buf.dtype, device=buf.device)
    return ext.index_add_(0, _routed(idx, n), vals)[:n]


def _nonzero_fixed(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=fill)[0]`` without a host
    sync: the first ``size`` True positions in order, then ``fill``."""
    pos = torch.cumsum(mask.long(), 0) - 1
    tgt = torch.where(mask & (pos < size), pos, size)
    out = torch.full((size + 1,), fill, dtype=torch.long, device=mask.device)
    out.scatter_(0, tgt, torch.arange(mask.shape[0], device=mask.device))
    return out[:size]


def _segment_reduce(vals: torch.Tensor, ids: torch.Tensor, n: int, reduce: str,
                    init: int) -> torch.Tensor:
    out = torch.full((n,), init, dtype=torch.int64, device=vals.device)
    return out.scatter_reduce(0, ids.long(), vals.long(), reduce=reduce, include_self=True)


def _i32(x) -> torch.Tensor:
    return x.to(torch.int32)


# ---------------------------------------------------------------------------
# Keyframe insertion
# ---------------------------------------------------------------------------


def insert_keyframe(
    m: SlamMap,
    K: Intrinsics,
    T_cw: lie.SE3,
    feats: FrameFeatures,
    depth: torch.Tensor,        # (N,) stereo depth per feature (0 = none)
    lm_match: torch.Tensor,     # (N,) int32 landmark idx matched in tracking, -1 = none
    frame_id: torch.Tensor,     # () int32
    signature: torch.Tensor,    # (D,)
    scale_factor: float = 1.4142135,
    map_id=None,                # () int32 Atlas map; None = map 0
    max_spawn_depth: float = 1e9,
) -> SlamMap:
    """Append a keyframe: record observations of matched landmarks, spawn new
    landmarks from unmatched features that carry stereo depth. Slots are
    claimed with prefix sums; overflow beyond capacity is dropped."""
    dev = depth.device
    kf_idx = m.n_kf
    K_cap, L_cap, O_cap = m.capacity
    if map_id is None:
        map_id = torch.zeros((), dtype=torch.int32, device=dev)

    sigma2 = (scale_factor ** feats.level.float()) ** 2
    kf1 = kf_idx.reshape(1)
    m = m._replace(
        kf_T_cw=lie.SE3(_set_drop(m.kf_T_cw.R, kf1, T_cw.R[None]),
                        _set_drop(m.kf_T_cw.t, kf1, T_cw.t[None])),
        kf_valid=_set_drop(m.kf_valid, kf1, True),
        kf_frame_id=_set_drop(m.kf_frame_id, kf1, _i32(frame_id).reshape(1)),
        kf_signature=_set_drop(m.kf_signature, kf1, signature[None]),
        kf_map_id=_set_drop(m.kf_map_id, kf1, _i32(map_id).reshape(1)),
    )

    # stereo-vs-mono observation split (ORB-SLAM3 ThDepth): only close
    # features contribute a disparity row
    u_r = torch.where(
        (depth > 1e-3) & (depth < max_spawn_depth),
        feats.xy[:, 0] - K.bf / torch.clamp(depth, min=1e-3),
        torch.full_like(depth, -1.0),
    )
    uvr = torch.cat([feats.xy, u_r[:, None]], dim=-1)

    # -- observations of already-mapped landmarks --
    matched = feats.valid & (lm_match >= 0)
    slot_m = m.n_obs + torch.cumsum(matched.int(), 0) - 1
    slot_m = torch.where(matched, slot_m, O_cap)
    m = m._replace(
        obs_kf=_set_drop(m.obs_kf, slot_m, kf_idx),
        obs_lm=_set_drop(m.obs_lm, slot_m, torch.clamp(lm_match, min=0)),
        obs_uvr=_set_drop(m.obs_uvr, slot_m, uvr),
        obs_sigma2=_set_drop(m.obs_sigma2, slot_m, sigma2),
        obs_valid=_set_drop(m.obs_valid, slot_m, True),
        lm_nobs=_add_drop(m.lm_nobs, torch.where(matched, lm_match, L_cap), 1),
    )
    n_obs_after_m = torch.clamp(m.n_obs + torch.sum(matched.int()), max=O_cap)

    # -- spawn new landmarks from unmatched stereo features --
    spawn = feats.valid & (lm_match < 0) & (depth > 1e-3)
    lm_slot = m.n_lm + torch.cumsum(spawn.int(), 0) - 1
    spawn = spawn & (lm_slot < L_cap)
    lm_slot_w = torch.where(spawn, lm_slot, L_cap)

    T_wc = lie.inverse(T_cw)
    p_c = backproject(K, feats.xy, depth)
    p_w = lie.apply(T_wc, p_c)
    m = m._replace(
        lm_pos=_set_drop(m.lm_pos, lm_slot_w, p_w),
        lm_desc=_set_drop(m.lm_desc, lm_slot_w, feats.desc),
        lm_valid=_set_drop(m.lm_valid, lm_slot_w, True),
        lm_nobs=_set_drop(m.lm_nobs, lm_slot_w, 1),
        lm_anchor_kf=_set_drop(m.lm_anchor_kf, lm_slot_w, kf_idx),
        lm_pos_anchor=_set_drop(m.lm_pos_anchor, lm_slot_w, p_c),
    )

    # observations for the spawned landmarks
    slot_s = n_obs_after_m + torch.cumsum(spawn.int(), 0) - 1
    slot_s = torch.where(spawn, slot_s, O_cap)
    m = m._replace(
        obs_kf=_set_drop(m.obs_kf, slot_s, kf_idx),
        obs_lm=_set_drop(m.obs_lm, slot_s, torch.where(spawn, lm_slot, 0)),
        obs_uvr=_set_drop(m.obs_uvr, slot_s, uvr),
        obs_sigma2=_set_drop(m.obs_sigma2, slot_s, sigma2),
        obs_valid=_set_drop(m.obs_valid, slot_s, True),
    )

    n_spawn = torch.sum(spawn.int())
    return m._replace(
        n_kf=_i32(torch.clamp(m.n_kf + 1, max=K_cap)),
        n_lm=_i32(torch.clamp(m.n_lm + n_spawn, max=L_cap)),
        n_obs=_i32(torch.clamp(n_obs_after_m + n_spawn, max=O_cap)),
    )


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------


def landmarks_in_view(m: SlamMap, K: Intrinsics, T_wc: lie.SE3, max_distance: float,
                      width: int = 640, height: int = 480):
    """Camera-frame landmark positions (..., L, 3) and in-view mask (..., L)
    for a pose or a batch of poses."""
    return points_in_view(m.lm_pos, m.lm_valid, K, T_wc, max_distance, width, height)


def points_in_view(lm_pos: torch.Tensor, lm_valid: torch.Tensor, K: Intrinsics,
                   T_wc: lie.SE3, max_distance: float, width: int = 640, height: int = 480):
    """``landmarks_in_view`` on the map's landmark positions (L, 3) and
    validity (L,) alone."""
    T_cw = lie.inverse(T_wc)
    pts = lm_pos.expand(tuple(T_cw.t.shape[:-1]) + tuple(lm_pos.shape))
    p_c = lie.apply(T_cw, pts)
    z = p_c[..., 2]
    z_safe = torch.where(z > 1e-3, z, torch.ones_like(z))
    u = K.fx * p_c[..., 0] / z_safe + K.cx
    v = K.fy * p_c[..., 1] / z_safe + K.cy
    dist = torch.linalg.norm(p_c, dim=-1)
    ok = (lm_valid & (z > 1e-3) & (dist < max_distance)
          & (u >= 0) & (u < width) & (v >= 0) & (v < height))
    return p_c, ok


def reanchor_landmarks(m: SlamMap) -> SlamMap:
    """Recompute world landmark positions from their anchor keyframes' poses."""
    a = m.lm_anchor_kf.long()
    T_anchor_wc = lie.inverse(lie.SE3(m.kf_T_cw.R[a], m.kf_T_cw.t[a]))
    p_w = (T_anchor_wc.R @ m.lm_pos_anchor[..., :, None])[..., 0] + T_anchor_wc.t
    return m._replace(lm_pos=torch.where(m.lm_valid[:, None], p_w, m.lm_pos))


def compact_map(m: SlamMap, target_fraction: float = 0.75) -> SlamMap:
    """Recycle landmark + observation slots: keep a protected core per anchor
    keyframe plus the most recently observed landmarks, compact them (and
    their observations) to the front, and reset the allocation counters."""
    L = m.lm_valid.shape[0]
    O = m.obs_valid.shape[0]
    dev = m.lm_valid.device

    last_kf = _segment_reduce(
        torch.where(m.obs_valid, m.obs_kf, -1),
        torch.where(m.obs_valid, m.obs_lm, L), L + 1, "amax", -2 ** 31)[:L]
    last_kf = torch.where(m.lm_valid, torch.maximum(last_kf, m.lm_anchor_kf.long()), -1)

    K_cap = m.kf_valid.shape[0]
    target = int(L * target_fraction)
    Q = max(8, target // K_cap)
    idx_arange = torch.arange(L, device=dev)
    anchor = torch.where(m.lm_valid, m.lm_anchor_kf.long(), K_cap)
    akey = anchor * L + idx_arange
    order_a = torch.argsort(akey)            # keys are unique
    pos_of = torch.empty_like(idx_arange)
    pos_of[order_a] = idx_arange
    first_pos = _segment_reduce(pos_of, anchor, K_cap + 1, "amin", 2 ** 31 - 1)
    rank_in_kf = pos_of - first_pos[torch.clamp(anchor, max=K_cap)]
    protected = m.lm_valid & (rank_in_kf < Q)
    n_prot = torch.sum(protected.long())

    eligible = m.lm_valid & torch.logical_not(protected)
    score = torch.where(eligible, last_kf * L + idx_arange, -1)
    order = torch.sort(score).values          # ascending, ineligible (-1) first
    remaining = torch.clamp(target - n_prot, 0, L - 1)
    at = torch.clamp(L - remaining, max=L - 1).reshape(1)
    cutoff = torch.where(remaining > 0, order.gather(0, at)[0], 2 * L * L)
    keep = protected | (eligible & (score >= cutoff))

    new_idx = torch.cumsum(keep.long(), 0) - 1
    dst = torch.where(keep, new_idx, L)

    def move(a):
        return _set_drop(torch.zeros_like(a), dst, a)

    n_keep = torch.sum(keep.long())
    lm_valid = idx_arange < n_keep

    lm_c = torch.clamp(m.obs_lm.long(), max=L - 1)
    obs_keep = m.obs_valid & keep[lm_c]
    obs_new_lm = torch.where(keep, new_idx, L)[lm_c]
    obs_idx = torch.cumsum(obs_keep.long(), 0) - 1
    obs_dst = torch.where(obs_keep, obs_idx, O)

    def move_obs(a):
        return _set_drop(torch.zeros_like(a), obs_dst, a)

    n_obs_keep = torch.sum(obs_keep.long())
    obs_valid_new = torch.arange(O, device=dev) < n_obs_keep
    return m._replace(
        lm_pos=move(m.lm_pos),
        lm_desc=move(m.lm_desc),
        lm_valid=lm_valid,
        lm_nobs=move(m.lm_nobs),
        lm_anchor_kf=move(m.lm_anchor_kf),
        lm_pos_anchor=move(m.lm_pos_anchor),
        obs_kf=move_obs(m.obs_kf),
        obs_lm=move_obs(_i32(obs_new_lm)),
        obs_uvr=move_obs(m.obs_uvr),
        obs_sigma2=torch.where(obs_valid_new, move_obs(m.obs_sigma2), 1.0),
        obs_valid=obs_valid_new,
        n_lm=_i32(n_keep),
        n_obs=_i32(n_obs_keep),
    )


def cull_landmarks(m: SlamMap, min_obs: int = 2, grace_kf: int = 2) -> SlamMap:
    """Invalidate under-observed landmarks once their anchor KF is old enough."""
    old_enough = (m.n_kf - m.lm_anchor_kf) > grace_kf
    bad = m.lm_valid & old_enough & (m.lm_nobs < min_obs)
    lm_valid = m.lm_valid & torch.logical_not(bad)
    obs_valid = m.obs_valid & lm_valid[m.obs_lm.long()]
    return m._replace(lm_valid=lm_valid, obs_valid=obs_valid)


def gather_window_problem(m: SlamMap, window: int, max_obs_local: int):
    """Observations of the last ``window`` keyframes as a fixed-size local BA
    problem. Returns (BAProblem, window start, window slots)."""
    dev = m.obs_valid.device
    start = torch.clamp(m.n_kf - window, min=0)
    in_win = m.obs_valid & (m.obs_kf >= start)
    idx = _nonzero_fixed(in_win, max_obs_local, m.obs_valid.shape[0] - 1)
    local_kf = torch.clamp(m.obs_kf[idx] - start, 0, window - 1)
    obs = Observations(kf=_i32(local_kf), lm=m.obs_lm[idx], uvr=m.obs_uvr[idx],
                       sigma2=m.obs_sigma2[idx], valid=in_win[idx])
    w_idx = torch.clamp(start + torch.arange(window, device=dev), max=m.kf_valid.shape[0] - 1).long()
    T_win = lie.SE3(m.kf_T_cw.R[w_idx], m.kf_T_cw.t[w_idx])
    kf_exists = (w_idx < m.n_kf) & m.kf_valid[w_idx]
    fixed_kf = torch.logical_not(kf_exists) | (torch.arange(window, device=dev) == 0)
    fixed_lm = torch.logical_not(m.lm_valid) | (m.lm_anchor_kf < start)
    prob = BAProblem(T_cw=T_win, points=m.lm_pos, obs=obs, fixed_kf=fixed_kf, fixed_lm=fixed_lm)
    return prob, start, w_idx


def landmarks_seen_by_kf(m: SlamMap, kf_idx: torch.Tensor) -> torch.Tensor:
    """(L,) bool — landmarks with a valid observation from keyframe kf_idx."""
    L = m.lm_valid.shape[0]
    hit = m.obs_valid & (m.obs_kf == kf_idx)
    mask = _set_drop(torch.zeros((L,), dtype=torch.bool, device=hit.device),
                     torch.where(hit, m.obs_lm, L), True)
    return mask & m.lm_valid


def gather_covis_problem(m: SlamMap, window: int, max_obs_local: int):
    """Covisibility-window local BA problem: the ``window`` keyframes sharing
    the most landmarks with the newest keyframe, touched landmarks compacted
    into a local index space of size max_obs_local // 2.
    Returns (BAProblem, w_idx, kf_exists, sel_old, writeback mask)."""
    dev = m.obs_valid.device
    K_cap = m.kf_valid.shape[0]
    O = m.obs_valid.shape[0]
    c = torch.clamp(m.n_kf - 1, min=0)
    lm_c = landmarks_seen_by_kf(m, c)
    shared = m.obs_valid & lm_c[m.obs_lm.long()]
    counts = torch.zeros((K_cap,), dtype=torch.int64, device=dev).index_add_(
        0, m.obs_kf.long(), shared.long())
    kf_ar = torch.arange(K_cap, device=dev)
    exists = m.kf_valid & (kf_ar < m.n_kf)
    counts = torch.where(exists, counts, -1)
    counts = torch.where(kf_ar == c, 2 ** 30, counts)   # current KF always selected
    _, w_idx = top_k_stable(counts, window)
    w_idx = torch.sort(w_idx).values                     # oldest selected = gauge
    kf_exists = exists[w_idx]
    win_ar = torch.arange(window, device=dev)

    inv = _set_drop(torch.full((K_cap,), -1, dtype=torch.int64, device=dev), w_idx,
                    torch.where(kf_exists, win_ar, -1))
    in_win = m.obs_valid & (inv[m.obs_kf.long()] >= 0)
    idx = _nonzero_fixed(in_win, max_obs_local, O - 1)
    sel_valid = in_win[idx]
    obs_lm_old = m.obs_lm[idx].long()

    L_cap = m.lm_pos.shape[0]
    L_loc = max_obs_local // 2
    touched = _set_drop(torch.zeros((L_cap,), dtype=torch.bool, device=dev),
                        torch.where(sel_valid, obs_lm_old, L_cap), True)
    new_idx = torch.cumsum(touched.long(), 0) - 1
    slot_ok = touched & (new_idx < L_loc)
    old2new = torch.where(slot_ok, new_idx, L_loc)
    sel_old = _nonzero_fixed(slot_ok, L_loc, L_cap - 1)
    slot_valid = torch.arange(L_loc, device=dev) < torch.sum(slot_ok.long())
    lm_new = old2new[obs_lm_old]
    obs = Observations(
        kf=_i32(torch.clamp(inv[m.obs_kf[idx].long()], 0, window - 1)),
        lm=_i32(torch.clamp(lm_new, max=L_loc - 1)),
        uvr=m.obs_uvr[idx],
        sigma2=m.obs_sigma2[idx],
        valid=sel_valid & (lm_new < L_loc),
    )
    T_win = lie.SE3(m.kf_T_cw.R[w_idx], m.kf_T_cw.t[w_idx])
    fixed_kf = torch.logical_not(kf_exists) | (win_ar == 0)
    anchor_in = inv[m.lm_anchor_kf.long()] >= 0
    fixed_lm_full = torch.logical_not(m.lm_valid) | torch.logical_not(anchor_in)
    fixed_lm = torch.logical_not(slot_valid) | fixed_lm_full[sel_old]
    prob = BAProblem(T_cw=T_win, points=m.lm_pos[sel_old], obs=obs,
                     fixed_kf=fixed_kf, fixed_lm=fixed_lm)
    return prob, w_idx, kf_exists, sel_old, slot_valid & torch.logical_not(fixed_lm)


def local_ba(m: SlamMap, K: Intrinsics, window: int = 8, max_obs_local: int = 8192,
             iters: int = 5, covis: bool = True) -> SlamMap:
    """Local bundle adjustment over a keyframe window (covisibility-selected
    by default, else the last ``window`` keyframes)."""
    if covis:
        prob, w_idx, kf_exists, sel_old, writeback = gather_covis_problem(m, window, max_obs_local)
    else:
        prob, _, w_idx = gather_window_problem(m, window, max_obs_local)
        kf_exists = (w_idx < m.n_kf) & m.kf_valid[w_idx]
    out, _ = bundle_adjust(K, prob, iters=iters, damping=1e-3)

    exists = kf_exists[:, None]
    R = m.kf_T_cw.R.clone()
    t = m.kf_T_cw.t.clone()
    R[w_idx] = torch.where(exists[..., None], out.T_cw.R, R[w_idx])
    t[w_idx] = torch.where(exists, out.T_cw.t, t[w_idx])
    if covis:
        # padded entries of sel_old repeat one slot: write only real ones
        L_cap = m.lm_pos.shape[0]
        pts = _set_drop(m.lm_pos, torch.where(writeback, sel_old, L_cap), out.points)
    else:
        pts = torch.where(m.lm_valid[:, None], out.points, m.lm_pos)
    m = m._replace(kf_T_cw=lie.SE3(R, t), lm_pos=pts)

    K_cap = m.kf_valid.shape[0]
    dev = pts.device
    inv = _set_drop(torch.full((K_cap,), -1, dtype=torch.int64, device=dev), w_idx,
                    torch.where(kf_exists, torch.arange(window, device=dev), -1))
    a = m.lm_anchor_kf.long()
    anchor_in = inv[a] >= 0
    p_anchor = (m.kf_T_cw.R[a] @ m.lm_pos[..., :, None])[..., 0] + m.kf_T_cw.t[a]
    return m._replace(lm_pos_anchor=torch.where((m.lm_valid & anchor_in)[:, None],
                                                p_anchor, m.lm_pos_anchor))


def _write_back(m: SlamMap, out: BAProblem) -> SlamMap:
    """A BA's poses (valid keyframes) and points (valid landmarks) into the
    map, then the anchor-frame positions refreshed: every anchor may have
    moved."""
    keep = m.kf_valid[:, None]
    m = m._replace(
        kf_T_cw=lie.SE3(torch.where(keep[..., None], out.T_cw.R, m.kf_T_cw.R),
                        torch.where(keep, out.T_cw.t, m.kf_T_cw.t)),
        lm_pos=torch.where(m.lm_valid[:, None], out.points, m.lm_pos),
    )
    a = m.lm_anchor_kf.long()
    p_anchor = (m.kf_T_cw.R[a] @ m.lm_pos[..., :, None])[..., 0] + m.kf_T_cw.t[a]
    return m._replace(lm_pos_anchor=torch.where(m.lm_valid[:, None], p_anchor,
                                                m.lm_pos_anchor))


def _global_problem(m: SlamMap) -> BAProblem:
    """The whole map as one BA problem: keyframe 0 holds the gauge."""
    K_cap = m.kf_valid.shape[0]
    obs = Observations(kf=m.obs_kf, lm=m.obs_lm, uvr=m.obs_uvr, sigma2=m.obs_sigma2,
                       valid=m.obs_valid)
    fixed_kf = torch.logical_not(m.kf_valid) | (torch.arange(K_cap, device=m.kf_valid.device) == 0)
    return BAProblem(T_cw=m.kf_T_cw, points=m.lm_pos, obs=obs, fixed_kf=fixed_kf,
                     fixed_lm=torch.logical_not(m.lm_valid))


def global_ba(m: SlamMap, K: Intrinsics, iters: int = 8):
    """Global bundle adjustment over the whole map: every valid keyframe
    (keyframe 0 holds the gauge) and every valid landmark against the whole
    observation table (ORB-SLAM3's loop-closing GBA, SURVEY.md §2.1 S1,
    §3.4), then the anchor-frame positions refreshed. At 128 keyframes and
    20480 landmarks the dense coupling blocks Y and Y·Hll^-1 are (128, 20480,
    6, 3) float32, 189 MB each. Returns (map, BAStats)."""
    out, stats = bundle_adjust(K, _global_problem(m), iters=iters, damping=1e-3)
    return _write_back(m, out), stats


def global_ba_dist(m: SlamMap, K: Intrinsics, mesh, iters: int = 8, capture: bool = True):
    """Global BA with the landmark-sharded solver of ``parallel/dist_ba.py``
    over a mesh of ranks: landmarks, their Hll blocks and the (K, L/n, 6, 3)
    coupling tensor are split over the ranks; only pose-side terms cross
    them. Every rank calls it with the same map. The observations are routed
    to their landmark's owner on the host (GBA runs at loop closure, rarely).
    The solver's iterations replay the mesh's captured regions
    (``capture=False``: plain PyTorch); it is called outside every other
    region (the loop closer and ``refine_map`` run it between their engine's
    regions). Returns (map, chi2 history) on every rank; the write-back
    mirrors ``global_ba``."""
    from fitslam_tpu_torch.parallel import dist_ba

    packed = dist_ba.shard_problem_by_landmark(_global_problem(m), mesh.devices.size)
    out, chis = dist_ba.landmark_sharded_bundle_adjust(mesh, K, packed, iters=iters,
                                                       damping=1e-3, capture=capture)
    return _write_back(m, out), chis
