"""Pose-graph optimization as dense batched Gauss-Newton (port of
``fitslam_tpu/ops/pgo.py``).

Edges are a fixed-capacity masked table. Each edge's two 6x6 Jacobians come
from forward-mode autodiff of the boxplus-perturbed residual, as in the
reference (``torch.func.jacfwd`` under ``torch.func.vmap`` for
``jax.jacfwd`` under ``jax.vmap``). The (6K, 6K) Hessian is assembled by a
fixed-order segment sum (``numerics.segment_sum_fixed``: the contributions in
the reference's scatter order, ii, jj, ij, ji, then i, j for the gradient,
so each block adds as XLA's CPU scatter adds it and alike on every run of the
card, ROADMAP fault F17) and solved densely in float32. The reference's
``lax.scan`` over iterations is a Python loop whose accept/reject stays a
``torch.where``: nothing waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from fitslam_tpu_torch.ops import lie
from fitslam_tpu_torch.ops.numerics import segment_plan, segment_sum_fixed, top_k_stable


class PoseGraphEdges(NamedTuple):
    i: torch.Tensor         # (E,) int32
    j: torch.Tensor         # (E,) int32
    T_ij: lie.SE3           # (E,) measured relative pose: maps frame j -> frame i
    weight: torch.Tensor    # (E,) float32 information scale
    valid: torch.Tensor     # (E,) bool


def concat_edges(*tables: PoseGraphEdges) -> PoseGraphEdges:
    """One edge table from several, in order."""
    return PoseGraphEdges(
        torch.cat([e.i for e in tables]), torch.cat([e.j for e in tables]),
        lie.SE3(torch.cat([e.T_ij.R for e in tables]), torch.cat([e.T_ij.t for e in tables])),
        torch.cat([e.weight for e in tables]), torch.cat([e.valid for e in tables]))


def edge_residual(T_cw_i: lie.SE3, T_cw_j: lie.SE3, T_ij: lie.SE3) -> torch.Tensor:
    """e = log(T_ij^-1 * T_cw_i * T_cw_j^-1)  (..., 6)."""
    rel = lie.compose(T_cw_i, lie.inverse(T_cw_j))
    return lie.se3_log(lie.compose(lie.inverse(T_ij), rel))


def _perturbed_residual(xi, xj, Ri, ti, Rj, tj, Rij, tij):
    Ti = lie.compose(lie.se3_exp(xi), lie.SE3(Ri, ti))
    Tj = lie.compose(lie.se3_exp(xj), lie.SE3(Rj, tj))
    return edge_residual(Ti, Tj, lie.SE3(Rij, tij))


_edge_jacobians = torch.func.vmap(torch.func.jacfwd(_perturbed_residual, argnums=(0, 1)))


def edge_jacobians(T_i: lie.SE3, T_j: lie.SE3, T_ij: lie.SE3):
    """(E, 6, 6) float32 Jacobians of each edge's residual with respect to the
    left perturbations of its two poses, at zero.

    Forward mode runs in float64: torch's forward-mode rule for an operation
    with a Python-number operand (``clamp(x, -1.0, 1.0)``, ``x + 1e-24``)
    gives a float64 tangent beside a float32 primal, which the next product
    refuses. The Jacobians are rounded to float32 after."""
    z = torch.zeros(T_i.t.shape[:-1] + (6,), dtype=torch.float64, device=T_i.t.device)
    Ji, Jj = _edge_jacobians(z, z, *(x.double() for x in (T_i.R, T_i.t, T_j.R, T_j.t,
                                                          T_ij.R, T_ij.t)))
    return Ji.float(), Jj.float()


def _take(T: lie.SE3, idx: torch.Tensor) -> lie.SE3:
    idx = idx.long()
    return lie.SE3(T.R[idx], T.t[idx])


def optimize_pose_graph(
    T_cw: lie.SE3,              # (K,) poses
    kf_valid: torch.Tensor,     # (K,) bool
    edges: PoseGraphEdges,
    fixed: torch.Tensor,        # (K,) bool — gauge
    iters: int = 12,
    damping: float = 1e-4,
    huber_delta: float = 0.5,
) -> Tuple[lie.SE3, torch.Tensor]:
    """Gauss-Newton over the pose graph. Returns (poses, (iters,) chi2 history)."""
    K_n = T_cw.t.shape[0]
    dev = T_cw.t.device
    valid_f = edges.valid.to(torch.float32)
    i, j = edges.i.long(), edges.j.long()
    # the edge table is fixed across iterations, so are the sums' orders
    h_ids = torch.cat([i * K_n + i, j * K_n + j, i * K_n + j, j * K_n + i])
    h_plan = segment_plan(h_ids, K_n * K_n)
    b_ids = torch.cat([i, j])
    b_plan = segment_plan(b_ids, K_n)

    def robust(r):
        r2 = torch.sum(r * r, dim=-1)
        w_rob = torch.where(r2 > huber_delta ** 2,
                            huber_delta / torch.sqrt(torch.clamp(r2, min=1e-12)),
                            torch.ones_like(r2))
        return edges.weight * w_rob * valid_f, r2

    def chi2_of(T):
        w, r2 = robust(edge_residual(_take(T, i), _take(T, j), edges.T_ij))
        return torch.sum(w * r2)

    free = (torch.logical_not(fixed) & kf_valid).to(torch.float32)
    diag = torch.arange(K_n, device=dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    T = T_cw
    chis = []
    for _ in range(iters):
        Ti, Tj = _take(T, i), _take(T, j)
        r = edge_residual(Ti, Tj, edges.T_ij)
        Ji, Jj = edge_jacobians(Ti, Tj, edges.T_ij)
        w, _ = robust(r)
        Hii = torch.einsum("e,eri,erj->eij", w, Ji, Ji)
        Hjj = torch.einsum("e,eri,erj->eij", w, Jj, Jj)
        Hij = torch.einsum("e,eri,erj->eij", w, Ji, Jj)
        bi = -torch.einsum("e,eri,er->ei", w, Ji, r)
        bj = -torch.einsum("e,eri,er->ei", w, Jj, r)
        H = segment_sum_fixed(torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)]), h_ids,
                              K_n * K_n, h_plan).reshape(K_n, K_n, 6, 6)
        b = segment_sum_fixed(torch.cat([bi, bj]), b_ids, K_n, b_plan)

        H = H * free[:, None, None, None] * free[None, :, None, None]
        H[diag, diag] = H[diag, diag] + eye6 * torch.where(
            free > 0, damping, 1.0)[:, None, None]
        b = b * free[:, None]

        H_mat = H.permute(0, 2, 1, 3).reshape(K_n * 6, K_n * 6)
        dx = torch.linalg.solve_ex(H_mat, b.reshape(-1))[0].reshape(K_n, 6)
        dx = dx * free[:, None]
        # step clip for robustness
        n = torch.linalg.norm(dx, dim=-1, keepdim=True)
        dx = dx * torch.clamp(1.0 / torch.clamp(n, min=1e-12), max=1.0)

        T_new = lie.compose(lie.se3_exp(dx), T)
        c_old = chi2_of(T)
        c_new = chi2_of(T_new)
        accept = torch.isfinite(c_new) & (c_new < c_old)
        T = lie.SE3(torch.where(accept, T_new.R, T.R), torch.where(accept, T_new.t, T.t))
        chis.append(torch.where(accept, c_new, c_old))
    return T, torch.stack(chis)


def covisibility_edges(
    kf_T_cw: lie.SE3,           # (K,) current keyframe poses
    kf_valid: torch.Tensor,     # (K,) bool
    obs_kf: torch.Tensor,       # (O,) int32
    obs_lm: torch.Tensor,       # (O,) int32
    obs_valid: torch.Tensor,    # (O,) bool
    n_landmarks: int,
    max_edges: int = 256,
    min_shared: int = 15,
    weight: float = 1.0,
    kf_T_cw_corr: Optional[lie.SE3] = None,   # (K,) loop-corrected poses
    tail: Optional[torch.Tensor] = None,      # (K,) bool — pre-corrected group
    loop_gap: int = 0,
) -> PoseGraphEdges:
    """Essential-graph edges: keyframe pairs sharing >= ``min_shared``
    landmarks (ORB-SLAM3's covisibility graph, SURVEY.md §2.1 S1, §3.4).

    The (K, L) incidence matrix is one scatter of ones; the shared counts are
    one (K, L) @ (L, K) float32 product (exact: integers below 2^24, TF32
    off); the top ``max_edges`` pairs of the strict upper triangle without
    the |i - j| <= 1 pairs of the odometry chain come from one stable sort
    (``lax.top_k``'s lowest-index tie order, ROADMAP F2). Relative
    measurements are taken from the current poses, except that a pair whose
    ``j`` lies in the pre-corrected ``tail`` and is at least ``loop_gap``
    keyframes after ``i`` takes ``j``'s pose from ``kf_T_cw_corr`` (the
    loop's corrected connections). Weights grow with sqrt(shared / min_shared)."""
    K_cap = kf_valid.shape[0]
    L = n_landmarks
    dev = kf_valid.device
    flat = torch.where(obs_valid, obs_kf.long() * L + obs_lm.long(), K_cap * L)
    A = torch.zeros((K_cap * L + 1,), dtype=torch.float32, device=dev)
    A.index_fill_(0, flat, 1.0)
    A = A[:-1].reshape(K_cap, L)
    counts = A @ A.T
    ii = torch.arange(K_cap, device=dev)
    pair_ok = kf_valid[:, None] & kf_valid[None, :] & (ii[None, :] - ii[:, None] > 1)
    counts = torch.where(pair_ok, counts, torch.zeros_like(counts))
    top, flat_idx = top_k_stable(counts.reshape(-1), max_edges)
    i = (flat_idx // K_cap).to(torch.int32)
    j = (flat_idx % K_cap).to(torch.int32)
    ok = top >= float(min_shared)
    i = torch.where(ok, i, 0)
    j = torch.where(ok, j, 0)
    Tj = _take(kf_T_cw, j)
    if kf_T_cw_corr is not None and loop_gap > 0:
        cross = tail[j.long()] & (j - i >= loop_gap)
        Tj_corr = _take(kf_T_cw_corr, j)
        Tj = lie.SE3(torch.where(cross[:, None, None], Tj_corr.R, Tj.R),
                     torch.where(cross[:, None], Tj_corr.t, Tj.t))
    T_ij = lie.compose(_take(kf_T_cw, i), lie.inverse(Tj))
    w = weight * torch.sqrt(torch.clamp(top / float(min_shared), min=1.0))
    return PoseGraphEdges(i, j, T_ij, w, ok)


def odometry_edges(T_cw: lie.SE3, n_kf: torch.Tensor, max_edges: int,
                   weight: float = 1.0) -> PoseGraphEdges:
    """Consecutive-keyframe edges from the current pose estimates."""
    K_n = T_cw.t.shape[0]
    dev = T_cw.t.device
    i = torch.arange(max_edges, dtype=torch.int32, device=dev)
    j = i + 1
    ok = j < n_kf
    i_c = torch.clamp(i, max=K_n - 1)
    j_c = torch.clamp(j, max=K_n - 1)
    T_ij = lie.compose(_take(T_cw, i_c), lie.inverse(_take(T_cw, j_c)))
    return PoseGraphEdges(i_c, j_c, T_ij,
                          torch.full((max_edges,), weight, dtype=torch.float32, device=dev), ok)
