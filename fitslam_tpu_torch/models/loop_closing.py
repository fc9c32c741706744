"""Loop detection, geometric verification and map correction (port of
``fitslam_tpu/models/loop_closing.py``; ORB-SLAM3's LoopClosing thread:
DBoW2 candidate retrieval, geometric verification, essential-graph
optimization, landmark fusion and global BA, SURVEY.md §2.1 S1, §3.4).

- retrieval: the map-centred cosine of place signatures with a temporal gap
  (``detect_loop``, run inside the backend step at keyframe insertion);
- verification: K2 matches the keyframe's descriptors against the
  candidate's landmarks with the ratio and mutual tests
  (``pallas_matching.match_ratio_fused``), then ``ba.solve_pose``;
- correction: dense pose-graph Gauss-Newton (``ops/pgo.py``) over odometry,
  covisibility and loop edges, landmark re-anchoring, the Atlas merge,
  duplicate-landmark fusion, re-triangulation or the scale search, and
  global BA, rate-limited.

Everything runs on the device. ``LoopCloser`` reads the device once a
verified candidate (one packed pull: inliers and both ends' Atlas map ids),
and keeps the chi2 values as device scalars until ``StereoSlam.finalize``.

The closer's device work runs as regions of its engine's slot
(``utils/jit.py``; CUDA graphs on a CUDA device when the engine captures),
the counterpart of the reference's compiled functions: ``loop_detect`` (a
retrieval the step did not make), ``loop_verify`` (K2 and the pose solve, up
to the packed pull) and ``loop_correct[+merge][+fuse][+gba][+scale|+retri]``
(the odometry and covisibility edges, PGO, re-anchoring, the Atlas merge,
the fusion, the re-triangulation or scale search, GBA and the tracker's
re-base), whose host values (the loop's ends, the merged map id and the
loop-edge table's indices and weights) are one staged input. The map and
the tracker state are written in the engine's buffers in place. A region
of these is captured only at an engine's ``EAGER_CALLS + 1``-th call of it;
the calls before run as plain PyTorch through the same buffers. With a mesh
of more than one rank the correction's GBA runs landmark-sharded over it
(``slam_map.global_ba_dist``, with its own captured solver regions) between
two regions of the engine: ``loop_correct[+merge][+fuse]+gba_dist[+scale|
+retri]`` (the correction up to the GBA) and ``loop_rebase`` (the tracker's
re-base after it).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fitslam_tpu_torch.models import slam_map as sm
from fitslam_tpu_torch.models import tracking as tr
from fitslam_tpu_torch.ops import ba, lie, orb, pgo
from fitslam_tpu_torch.ops.geometry import Intrinsics
from fitslam_tpu_torch.ops.pallas_matching import match_ratio_fused
from fitslam_tpu_torch.ops.place import centered_cosine_scores
from fitslam_tpu_torch.utils import jit, profiling
from fitslam_tpu_torch.utils.transfer import upload


class LoopCandidate(NamedTuple):
    kf_idx: torch.Tensor    # () int32
    score: torch.Tensor     # () float32


def detect_loop(m: sm.SlamMap, signature: torch.Tensor, current_kf,
                min_gap: int = 20) -> LoopCandidate:
    """Best loop candidate by map-centred signature similarity among the
    keyframes more than ``min_gap`` before ``current_kf`` (an int or a 0-d
    device tensor). The lowest index wins a tie; with no candidate the
    score is -inf."""
    K_cap = m.kf_valid.shape[0]
    scores = centered_cosine_scores(signature, m.kf_signature, m.kf_valid)
    ok = m.kf_valid & (torch.arange(K_cap, device=scores.device) < current_kf - min_gap)
    scores = torch.where(ok, scores, float("-inf"))
    best = torch.argmax(scores)
    return LoopCandidate(best.to(torch.int32), tr.take(scores, best))


#: (L,) bool — landmarks with a valid observation from a keyframe
landmarks_seen_by = sm.landmarks_seen_by_kf


def verify_loop(K: Intrinsics, m: sm.SlamMap, frame: tr.StereoFrame, cand_kf,
                max_hamming: int = 64) -> Tuple[lie.SE3, torch.Tensor]:
    """Match the frame against the candidate keyframe's landmarks (K2, ratio
    0.85, mutual) and solve the camera pose those landmarks imply. Returns
    (T_cw_loop, () int32 inlier count). ``cand_kf`` is an int or a 0-d
    device tensor."""
    lm_mask = landmarks_seen_by(m, cand_kf)
    # the whole landmark table is packed on every call; compacting the
    # candidate's few hundred landmarks first would be cheaper
    mt = match_ratio_fused(orb.pack_descriptors(frame.feats.desc), frame.feats.valid,
                           orb.pack_descriptors(m.lm_desc), lm_mask,
                           max_distance=max_hamming, ratio=0.85, mutual=True)
    depth = frame.depth
    u_r = torch.where(depth > 1e-3, frame.feats.xy[:, 0] - K.bf / torch.clamp(depth, min=1e-3),
                      torch.full_like(depth, -1.0))
    uvr = torch.cat([frame.feats.xy, u_r[:, None]], dim=-1)
    if isinstance(cand_kf, torch.Tensor):
        T0 = lie.SE3(tr.take(m.kf_T_cw.R, cand_kf), tr.take(m.kf_T_cw.t, cand_kf))
    else:
        T0 = lie.SE3(m.kf_T_cw.R[cand_kf], m.kf_T_cw.t[cand_kf])
    n = frame.feats.capacity
    T_loop, inl, _ = ba.solve_pose(K, T0, m.lm_pos[mt.idx_b.long()], uvr,
                                   torch.ones((n,), dtype=torch.float32, device=depth.device),
                                   mt.valid, iters=10)
    return T_loop, torch.sum(inl).to(torch.int32)


def fuse_loop_landmarks(K: Intrinsics, m: sm.SlamMap, kf_i, kf_j, cap: int = 2048,
                        max_dist: float = 0.25, max_hamming: float = 72.0) -> sm.SlamMap:
    """Merge duplicate landmarks across a just-closed loop (ORB-SLAM3's
    SearchAndFuse): landmarks anchored near ``kf_j`` (side B) are matched to
    those anchored near ``kf_i`` (side A) by 3D proximity and descriptor
    Hamming distance ((cap, cap) products); each matched B hands its
    observations to its A and is invalidated."""
    L = m.lm_valid.shape[0]
    near_a = m.lm_valid & (torch.abs(m.lm_anchor_kf - kf_i) <= 2)
    near_b = m.lm_valid & (m.lm_anchor_kf >= kf_j - 1) & (m.lm_anchor_kf <= kf_j)
    idx_a = sm._nonzero_fixed(near_a, cap, L - 1)
    ok_a = near_a[idx_a]
    idx_b = sm._nonzero_fixed(near_b, cap, L - 1)
    ok_b = near_b[idx_b]
    pa, pb = m.lm_pos[idx_a], m.lm_pos[idx_b]
    d2 = torch.sum((pb[:, None, :] - pa[None, :, :]) ** 2, dim=-1)   # (B, A)
    sim = m.lm_desc[idx_b].float() @ m.lm_desc[idx_a].float().T
    ham = (m.lm_desc.shape[1] - sim) * 0.5
    good = (ok_b[:, None] & ok_a[None, :]
            & (d2 < max_dist * max_dist) & (ham <= max_hamming))
    d2m = torch.where(good, d2, float("inf"))
    best = torch.argmin(d2m, dim=1)
    has = torch.isfinite(torch.min(d2m, dim=1).values)
    target = idx_a[best]                      # (B,) absorbing landmark slot
    src = torch.where(has, idx_b, L)
    old2new = sm._set_drop(torch.arange(L, dtype=torch.int32, device=has.device), src,
                           torch.where(has, target, 0).to(torch.int32))
    drop = sm._set_drop(torch.zeros((L,), dtype=torch.bool, device=has.device), src, True)
    nobs_add = torch.where(has, m.lm_nobs[idx_b], 0)
    return m._replace(
        obs_lm=old2new[m.obs_lm.long()],
        lm_valid=m.lm_valid & torch.logical_not(drop),
        lm_nobs=sm._add_drop(m.lm_nobs, torch.where(has, target, L), nobs_add),
    )


def scale_search(K: Intrinsics, m: sm.SlamMap, scales: torch.Tensor):
    """Global map-scale line search + re-triangulation: for each candidate
    scale s (1.0 among them), every camera centre is scaled about keyframe
    0's, every landmark re-triangulated under the scaled poses and the
    robust chi2 scored; the lowest chi2 wins. The reference's two recorded
    faults are mirrored (ROADMAP F6): invalid keyframe slots get scaled
    translations too, and ill-conditioned landmarks keep their position at
    every scale. Returns (map at the best scale, best scale, (S,) chi2)."""
    obs = ba.Observations(kf=m.obs_kf, lm=m.obs_lm, uvr=m.obs_uvr, sigma2=m.obs_sigma2,
                          valid=m.obs_valid)
    R = m.kf_T_cw.R
    R0, t0 = R[0], m.kf_T_cw.t[0]
    c0 = -(R0.transpose(-1, -2) @ t0[..., None])[..., 0]
    centers = -torch.einsum("kij,kj->ki", R.transpose(-1, -2), m.kf_T_cw.t)
    ts, pts, chis = [], [], []
    for k in range(scales.shape[0]):
        c_s = c0 + scales[k] * (centers - c0)
        t_s = -torch.einsum("kij,kj->ki", R, c_s)
        T_s = lie.SE3(R, t_s)
        p = ba.retriangulate_points(K, T_s, m.lm_pos, obs, m.lm_valid)
        ts.append(t_s)
        pts.append(p)
        chis.append(ba.chi2_residuals(K, T_s, p, obs))
    chi_all = torch.stack(chis)
    best = torch.argmin(chi_all)
    m2 = m._replace(kf_T_cw=lie.SE3(R, tr.take(torch.stack(ts), best)),
                    lm_pos=tr.take(torch.stack(pts), best))
    return m2, tr.take(scales, best), chi_all


def loop_detect_region(m: sm.SlamMap, kf: torch.Tensor, *, min_gap: int):
    """Region ``loop_detect``: ``detect_loop`` for keyframe ``kf`` (a 0-d
    int32), packed as [candidate, score] float32."""
    cand = detect_loop(m, tr.take(m.kf_signature, kf), kf, min_gap)
    return (), torch.stack([cand.kf_idx.float(), cand.score])


def loop_verify_region(K: Intrinsics, m: sm.SlamMap, frame: tr.StereoFrame, ij: torch.Tensor):
    """Region ``loop_verify``: ``verify_loop`` against candidate ``ij[0]``
    for keyframe ``ij[1]``. Returns (T_cw_loop, [inliers, map id of ij[0],
    map id of ij[1]] float32)."""
    i, j = ij[0], ij[1]
    T_loop, n_inl = verify_loop(K, m, frame, i)
    return (), (T_loop, torch.stack([n_inl.float(), tr.take(m.kf_map_id, i).float(),
                                     tr.take(m.kf_map_id, j).float()]))


#: the fixed head of ``loop_correct_region``'s staged input: [i, j, the
#: merged maps' ids (kept, welded in), the new edge's row, shift the table,
#: valid edges]
_HEAD = 7


def _correct_head(K: Intrinsics, m: sm.SlamMap, state: tr.TrackState, T_loop: lie.SE3,
                  table: lie.SE3, host: torch.Tensor, *, cfg, merge: bool, gba: bool):
    """The correction up to its GBA: the new edge into the table, PGO, the
    re-anchoring, the Atlas merge, the fusion, and the re-triangulation or
    the scale search where GBA follows. Returns (map, state, table, the new
    edge's T_ij, PGO's last chi2, the scale found or None, keyframe j's pose
    before the correction)."""
    dev = m.kf_valid.device
    E_cap = cfg.max_loop_edges
    i, j = host[0].to(torch.int32), host[1].to(torch.int32)
    T_i = lie.SE3(tr.take(m.kf_T_cw.R, i), tr.take(m.kf_T_cw.t, i))
    # keyframe j's pose before the correction: the tracker update at the
    # end composes the correction relative to it
    T_j_old = lie.SE3(tr.take(m.kf_T_cw.R, j), tr.take(m.kf_T_cw.t, j))
    T_ij = lie.compose(T_i, lie.inverse(T_loop))

    # --- pose-graph correction ---
    K_cap = m.kf_valid.shape[0]
    # odometry measured from the raw (pre-correction) estimates: the
    # springs that relax to absorb the closure residual
    odo = pgo.odometry_edges(m.kf_T_cw, m.n_kf, K_cap - 1)
    # pre-correct the loop's tail group (keyframe j and its recent
    # neighbours) by the verified loop delta (ORB-SLAM3 CorrectLoop's
    # CorrectedSim3), so that cross-loop covisibility pairs measured
    # through it reinforce the closure instead of pinning the drift
    idx = torch.arange(K_cap, device=dev)
    tail = m.kf_valid & (idx > j - cfg.correct_tail_kf) & (idx <= j)
    delta = lie.compose(lie.inverse(T_j_old), T_loop)
    T_tail = lie.compose(m.kf_T_cw, delta)
    T_corr = lie.SE3(torch.where(tail[:, None, None], T_tail.R, m.kf_T_cw.R),
                     torch.where(tail[:, None], T_tail.t, m.kf_T_cw.t))
    covis = pgo.covisibility_edges(
        m.kf_T_cw, m.kf_valid, m.obs_kf, m.obs_lm, m.obs_valid,
        n_landmarks=m.lm_valid.shape[0], max_edges=cfg.covis_max_edges,
        min_shared=cfg.covis_min_shared, kf_T_cw_corr=T_corr, tail=tail,
        loop_gap=cfg.min_gap_keyframes)
    # fixed-capacity loop-edge table, the newest kept when over capacity:
    # the new edge goes to its row, after the oldest is shifted out
    shift = host[5] > 0.5
    at = (torch.arange(E_cap, device=dev) == host[4].long())
    tab_R = torch.where(shift, torch.roll(table.R, -1, 0), table.R)
    tab_t = torch.where(shift, torch.roll(table.t, -1, 0), table.t)
    table = lie.SE3(torch.where(at[:, None, None], T_ij.R[None], tab_R),
                    torch.where(at[:, None], T_ij.t[None], tab_t))
    rows = host[_HEAD:]
    loop_edges = pgo.PoseGraphEdges(
        i=rows[:E_cap].to(torch.int32),
        j=rows[E_cap:2 * E_cap].to(torch.int32),
        T_ij=table,
        weight=rows[2 * E_cap:],
        valid=torch.arange(E_cap, device=dev) < host[6],
    )
    edges = pgo.concat_edges(odo, covis, loop_edges)
    fixed = idx == 0
    # Gauss-Newton starts from the tail-corrected poses, around which the
    # measurements agree
    T_new, chis = pgo.optimize_pose_graph(T_corr, m.kf_valid, edges, fixed,
                                          iters=cfg.pgo_iters)
    keep = m.kf_valid[:, None]
    m = m._replace(kf_T_cw=lie.SE3(torch.where(keep[..., None], T_new.R, m.kf_T_cw.R),
                                   torch.where(keep, T_new.t, m.kf_T_cw.t)))
    m = sm.reanchor_landmarks(m)
    # Atlas merge: a loop between keyframes of two maps welds the newer
    # map into the older (ORB-SLAM3 map merging)
    if merge:
        lo, hi = host[2].to(torch.int32), host[3].to(torch.int32)
        m = m._replace(kf_map_id=torch.where(m.kf_map_id == hi, lo, m.kf_map_id))
        state = state._replace(map_id=lo)
    if cfg.fuse_landmarks:
        m = fuse_loop_landmarks(K, m, i, j)
    # re-triangulation (or the scale search) exists to put GBA in a
    # better basin, so it runs only when GBA will
    scale_est = None
    if gba and cfg.scale_search_halfrange > 0:
        h = cfg.scale_search_halfrange
        n = cfg.scale_search_points | 1          # odd: 1.0 is in the grid
        scales = torch.linspace(1.0 - h, 1.0 + h, n, device=dev)
        m, scale_est, _ = scale_search(K, m, scales)
    elif gba and cfg.retriangulate:
        obs = ba.Observations(kf=m.obs_kf, lm=m.obs_lm, uvr=m.obs_uvr,
                              sigma2=m.obs_sigma2, valid=m.obs_valid)
        m = m._replace(lm_pos=ba.retriangulate_points(K, m.kf_T_cw, m.lm_pos, obs, m.lm_valid))
    return m, state, table, T_ij, chis[-1], scale_est, T_j_old


def _rebased(m: sm.SlamMap, state: tr.TrackState, T_j_old: lie.SE3, j) -> tr.TrackState:
    """The tracker after the correction. The current frame may be several
    frames past keyframe j (the poll lags the camera), so the correction is
    composed, not imposed: C_new = C_old * T_j_old^-1 * T_j_new."""
    T_j_new = lie.SE3(tr.take(m.kf_T_cw.R, j), tr.take(m.kf_T_cw.t, j))
    T_cur = lie.compose(lie.compose(state.T_cw, lie.inverse(T_j_old)), T_j_new)
    return state._replace(T_cw=T_cur, T_cw_last_kf=T_cur)


def loop_correct_region(K: Intrinsics, m: sm.SlamMap, state: tr.TrackState, T_loop: lie.SE3,
                        table: lie.SE3, host: torch.Tensor, *, cfg, merge: bool, gba: bool):
    """Region ``loop_correct[...]``: the correction of the verified loop
    between candidate keyframe i and keyframe j (``T_loop``: keyframe j's
    camera pose the loop implies). ``table`` is the loop-edge table's
    measured poses (``cfg.max_loop_edges`` rows, identity where unused);
    ``host`` is float32 [i, j, the merged maps' ids (the older, kept; the
    newer, welded into it), the new edge's row, whether the table shifts out
    its oldest row first, the valid edges, then each row's i, j and weight]. Writes the map, the tracker state and the
    table; returns (the new edge's T_ij, PGO's last chi2, GBA's last chi2 or
    None, the scale found or None)."""
    m, state, table, T_ij, pgo_chi2, scale_est, T_j_old = _correct_head(
        K, m, state, T_loop, table, host, cfg=cfg, merge=merge, gba=gba)
    # global BA over every pose and landmark, queued and never waited
    # for: its chi2 stays a device scalar in the record
    gba_chi2 = None
    if gba:
        m, gba_stats = sm.global_ba(m, K, iters=cfg.gba_iters)
        gba_chi2 = gba_stats.chi2[-1]
    state = _rebased(m, state, T_j_old, host[1].to(torch.int32))
    return (None, m, state, None, table), (T_ij, pgo_chi2, gba_chi2, scale_est)


def loop_correct_head_region(K: Intrinsics, m: sm.SlamMap, state: tr.TrackState,
                             T_loop: lie.SE3, table: lie.SE3, host: torch.Tensor, *, cfg,
                             merge: bool):
    """Region ``loop_correct[...]`` of a correction whose GBA runs sharded
    over a mesh: ``loop_correct_region`` up to its GBA (which needs host
    reads and collectives, so it runs between this region and
    ``loop_rebase``). Writes the map, the tracker state and the table;
    returns (T_ij, PGO's last chi2, the scale found or None, keyframe j's
    pose before the correction)."""
    m, state, table, T_ij, pgo_chi2, scale_est, T_j_old = _correct_head(
        K, m, state, T_loop, table, host, cfg=cfg, merge=merge, gba=True)
    return (None, m, state, None, table), (T_ij, pgo_chi2, scale_est, T_j_old)


def loop_rebase_region(m: sm.SlamMap, state: tr.TrackState, T_j_old: lie.SE3,
                       host: torch.Tensor):
    """Region ``loop_rebase``: the tracker re-based by the correction of
    keyframe ``host[1]`` after a mesh's GBA. Writes the state."""
    return (None, _rebased(m, state, T_j_old, host[1].to(torch.int32))), ()


#: an engine's calls of each loop-closing region that run as plain PyTorch
#: before the region is captured. On the H100 a correction at 77 keyframes
#: takes 690-870 host ms eagerly, ~1.4 s to capture and ~135 ms a replay: a
#: capture pays only when a variant recurs, and a ring run closes each
#: variant once or twice (PERF.md, PR 14)
EAGER_CALLS = 2


def _runner(slam):
    """(run, keep) for ``slam``'s regions: its ``SlotState.run`` (the first
    ``EAGER_CALLS`` calls of a region eager) and the slot's ``snapshot`` for
    an engine that captures, else ``jit.run_eagerly`` and no copy (an engine
    without buffers, or a stand-in)."""
    st = getattr(slam, "_slot_state", None)
    if st is None or not st.capture:
        return jit.run_eagerly, (lambda tree: tree)
    return functools.partial(st.run, eager=EAGER_CALLS), st.claim().snapshot


class LoopCloser:
    """Host-side accumulator of loop edges and the correction trigger."""

    def __init__(self, cfg, K: Intrinsics):
        self.cfg = cfg
        self.K = K
        # (i, j, T_ij (device SE3), weight): the weight grows with the
        # verification's inliers, so a weak edge pulls less on later PGOs
        self.loop_edges: List[Tuple[int, int, lie.SE3, float]] = []
        # the newest ``max_loop_edges`` of their T_ij, in order, identity
        # after them: the correction's table (written by it)
        self._edge_table: Optional[lie.SE3] = None
        self.last_loop_kf = -(10 ** 9)
        # a mesh of more than one rank (parallel/mesh.py) makes GBA run
        # landmark-sharded over it; every rank then runs this closer alike
        self.mesh = None
        # temporal consistency (ORB-SLAM3 mnCovisibilityConsistencyTh): the
        # same candidate region must recur on consecutive keyframes
        self._consist_cand = -(10 ** 9)
        self._consist_count = 0
        self._last_gba_kf = -(10 ** 9)   # GBA rate limit (gba_min_interval_kf)
        self.host_syncs = 0              # device->host reads so far

    @profiling.layer("LoopCloser.on_keyframe")
    def on_keyframe(self, slam, kf_idx: int, cand_idx: Optional[int] = None,
                    score: Optional[float] = None) -> Optional[dict]:
        """Called after each keyframe insertion with the candidate the backend
        step retrieved (``StepOutputs.loop_cand`` / ``loop_score``, read in the
        poll's packed pull); without one, retrieval runs here. Returns the
        correction's record when a loop closed, else None. ``slam`` carries
        ``map``, ``state`` and ``last_frame``; ``map`` and ``state`` are
        replaced by the corrected ones (in its buffers, for an engine that
        captures)."""
        cfg = self.cfg.loop
        if not cfg.enabled or kf_idx < cfg.min_gap_keyframes:
            return None
        if kf_idx < self.last_loop_kf + cfg.cooldown_keyframes:
            return None
        run, keep = _runner(slam)
        m = slam.map
        dev = m.kf_valid.device
        if cand_idx is None or score is None:
            _, v = run("loop_detect", functools.partial(
                loop_detect_region, min_gap=cfg.min_gap_keyframes),
                m, upload(kf_idx, dev, torch.int32))
            with profiling.host_read("LoopCloser.detect", dev):
                v = v.cpu().tolist()
            self.host_syncs += 1
            cand_idx, score = int(v[0]), float(v[1])
        if cand_idx < 0 or score < cfg.min_score:
            self._consist_count = 0
            return None
        if abs(cand_idx - self._consist_cand) <= cfg.consistency_radius_kf:
            self._consist_count += 1
        else:
            self._consist_count = 1
        self._consist_cand = cand_idx
        if self._consist_count < cfg.consistency_threshold:
            return None
        frame = slam.last_frame
        if frame is None:
            return None
        i, j = cand_idx, kf_idx
        _, (T_loop, v) = run("loop_verify", loop_verify_region, self.K, m, frame,
                             upload([i, j], dev, torch.int32))
        # ONE packed pull for every host decision of this correction: the
        # inlier count and the Atlas map ids of both loop ends
        with profiling.host_read("LoopCloser.verify", dev):
            v = v.cpu().tolist()
        self.host_syncs += 1
        if int(v[0]) < cfg.min_matches:
            return None
        n_inl_h, map_i, map_j = int(v[0]), int(v[1]), int(v[2])
        # ~2 at the 40-inlier floor, saturating at 10 for dense revisits
        edge_w = float(min(10.0, n_inl_h / 20.0))
        self.last_loop_kf = kf_idx
        self._consist_count = 0
        self._consist_cand = -(10 ** 9)

        # the correction's host values, staged as one input: the loop-edge
        # table holds the newest E_cap edges, this one among them
        E_cap = cfg.max_loop_edges
        n_edges = len(self.loop_edges) + 1
        recent = (self.loop_edges + [(i, j, None, edge_w)])[-E_cap:]
        pad = E_cap - len(recent)
        merged = None
        if map_i != map_j:
            merged = (max(map_i, map_j), min(map_i, map_j))
        host = np.concatenate([
            np.float32([i, j, min(map_i, map_j), max(map_i, map_j), len(recent) - 1,
                        n_edges > E_cap, len(recent)]),
            np.float32([e[0] for e in recent] + [0] * pad),
            np.float32([e[1] for e in recent] + [0] * pad),
            np.float32([e[3] for e in recent] + [1.0] * pad)])
        if self._edge_table is None:
            self._edge_table = lie.SE3.identity((E_cap,), device=dev)
        run_gba = cfg.run_global_ba and kf_idx >= self._last_gba_kf + cfg.gba_min_interval_kf
        if run_gba:
            self._last_gba_kf = kf_idx
        mesh = self.mesh if self.mesh is not None and self.mesh.devices.size > 1 else None
        variant = "".join(f"+{flag}" for flag, on in (
            ("merge", merged is not None), ("fuse", cfg.fuse_landmarks), ("gba", run_gba),
            ("scale", run_gba and cfg.scale_search_halfrange > 0),
            ("retri", run_gba and cfg.scale_search_halfrange <= 0 and cfg.retriangulate)) if on)
        host_t = upload(host, dev)
        if mesh is None or not run_gba:
            fn = functools.partial(loop_correct_region, cfg=cfg, merge=merged is not None,
                                   gba=run_gba)
            (_, m, state, _, self._edge_table, _), out = run(
                "loop_correct" + variant, fn, self.K, m, slam.state, T_loop, self._edge_table,
                host_t)
            T_ij, pgo_chi2, gba_chi2, scale_est = keep(out)
        else:
            # the sharded GBA routes its observations on the host and
            # reduces across the ranks, so it runs between two regions:
            # the correction up to it, and the tracker's re-base after it
            fn = functools.partial(loop_correct_head_region, cfg=cfg, merge=merged is not None)
            (_, m, state, _, self._edge_table, _), (*out, T_j_old) = run(
                "loop_correct" + variant.replace("+gba", "+gba_dist"), fn, self.K, m,
                slam.state, T_loop, self._edge_table, host_t)
            T_ij, pgo_chi2, scale_est = keep(tuple(out))
            m, gba_chis = sm.global_ba_dist(m, self.K, mesh, iters=cfg.gba_iters,
                                            capture=getattr(slam, "capture", True))
            gba_chi2 = gba_chis[-1]
            slam.map = m
            m = slam.map                          # the engine's buffers, when it has them
            (_, state, _, _), _ = run("loop_rebase", loop_rebase_region, m, state, T_j_old,
                                      host_t)
        self.loop_edges.append((i, j, T_ij, edge_w))
        slam.map, slam.state = m, state
        return {
            "loop_from": j,
            "loop_to": i,
            "score": score,
            "inliers": n_inl_h,
            "pgo_chi2": pgo_chi2,
            "gba_chi2": gba_chi2,
            "scale_correction": scale_est,
            "merged_maps": merged,
        }
