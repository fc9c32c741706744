"""Bundle adjustment as batched dense linear algebra (port of
``fitslam_tpu/ops/ba.py``: motion-only pose solve, Schur-complement
Gauss-Newton BA, residual-only chi2, linear landmark re-triangulation).

The reference's ``lax.scan`` iterations are Python loops here; each step's
accept/reject stays a ``torch.where`` so no iteration waits for the device.
``segment_sum`` is ``numerics.segment_sum_fixed``: each segment adds its rows
in order, as the reference's CPU scatter does, and alike on every run of the
card (ROADMAP fault F17); ``bundle_adjust`` sorts its three id sets once and
reuses the plans in every iteration. The dense solves are
``torch.linalg.solve_ex`` in float32, which does not synchronise to check for
singular systems.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fitslam_tpu_torch.ops import lie
from fitslam_tpu_torch.ops.geometry import Intrinsics, huber_weight
from fitslam_tpu_torch.ops.numerics import SegmentPlan, segment_plan, segment_sum_fixed
from fitslam_tpu_torch.utils import jit

# the reference computes these thresholds as float32 square roots on device
_SQRT_CHI2_STEREO = float(np.sqrt(np.float32(7.815)))
_SQRT_CHI2_MONO = float(np.sqrt(np.float32(5.991)))
# the robust chi2 caps each observation's term at four times the stereo gate
CHI2_CAP = 7.815 * 4


class Observations(NamedTuple):
    """Fixed-capacity observation table (structure of arrays)."""

    kf: torch.Tensor      # (O,) int32 keyframe index
    lm: torch.Tensor      # (O,) int32 landmark index
    uvr: torch.Tensor     # (O, 3) float32 [u_left, v, u_right]; u_right<0 => mono
    sigma2: torch.Tensor  # (O,) float32 measurement variance (px^2), per level
    valid: torch.Tensor   # (O,) bool


class BAProblem(NamedTuple):
    T_cw: lie.SE3          # (K,) camera-from-world keyframe poses
    points: torch.Tensor   # (L, 3) world landmarks
    obs: Observations
    fixed_kf: torch.Tensor  # (K,) bool — poses held constant (gauge)
    fixed_lm: torch.Tensor  # (L,) bool — landmarks held constant


class BAStats(NamedTuple):
    chi2: torch.Tensor         # robust total chi2 per iteration (I,)
    num_inliers: torch.Tensor  # (I,)


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of batched 3x3 matrices."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    inv_det = 1.0 / det
    adj = torch.stack([
        torch.stack([A00, A01, A02], dim=-1),
        torch.stack([A10, A11, A12], dim=-1),
        torch.stack([A20, A21, A22], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def _residual_and_jac(K: Intrinsics, R, t, p_w, uvr, stereo_mask):
    """Closed-form residuals (..., 3) and Jacobians (..., 3, 6) / (..., 3, 3)
    for a batch of observations. Left perturbation: T' = exp(dxi) @ T_cw, so
    d p_c / d xi = [ I  -[p_c]x ]."""
    p_c = (R @ p_w[..., None])[..., 0] + t
    x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
    z_ok = z > 1e-2
    zs = torch.where(z_ok, z, torch.ones_like(z))
    iz = 1.0 / zs
    iz2 = iz * iz
    u = K.fx * x * iz + K.cx
    v = K.fy * y * iz + K.cy
    ur = u - K.bf * iz
    pred = torch.stack([u, v, ur], dim=-1)
    s = stereo_mask.to(pred.dtype)
    one = torch.ones_like(s)
    res = (pred - uvr) * torch.stack([one, one, s], dim=-1)

    zero = torch.zeros_like(iz)
    row_u = torch.stack([K.fx * iz, zero, -K.fx * x * iz2], dim=-1)
    row_v = torch.stack([zero, K.fy * iz, -K.fy * y * iz2], dim=-1)
    row_r = torch.stack([K.fx * iz, zero, -K.fx * x * iz2 + K.bf * iz2], dim=-1)
    J_pc = torch.stack([row_u, row_v, row_r * s[..., None]], dim=-2)
    J_pose = torch.cat([J_pc, -(J_pc @ lie.skew(p_c))], dim=-1)   # (..., 3, 6)
    J_point = J_pc @ R                                             # (..., 3, 3)
    return res, J_pose, J_point, z_ok


def linearize(K: Intrinsics, prob: BAProblem):
    """Per-observation (res, J_pose, J_point, weight, ok, chi2) with robust
    IRLS weights folded in."""
    obs = prob.obs
    kf = obs.kf.long()
    R_o, t_o = prob.T_cw.R[kf], prob.T_cw.t[kf]
    p_o = prob.points[obs.lm.long()]
    stereo = obs.uvr[:, 2] > 0.0
    res, J_pose, J_point, z_ok = _residual_and_jac(K, R_o, t_o, p_o, obs.uvr, stereo)
    ok = obs.valid & z_ok
    inv_sigma2 = torch.where(ok, 1.0 / obs.sigma2, torch.zeros_like(obs.sigma2))
    chi2 = torch.sum(res * res, dim=-1) * inv_sigma2
    w = inv_sigma2 * huber_weight(chi2, delta=_SQRT_CHI2_STEREO)
    return res, J_pose, J_point, w, ok, chi2


def chi2_residuals(K: Intrinsics, T_cw: lie.SE3, points: torch.Tensor,
                   obs: Observations) -> torch.Tensor:
    """Residual-only robust chi2 (no Jacobians, no block assembly)."""
    kf = obs.kf.long()
    R_o, t_o = T_cw.R[kf], T_cw.t[kf]
    p_o = points[obs.lm.long()]
    p_c = (R_o @ p_o[..., :, None])[..., 0] + t_o
    x, y, z = p_c[:, 0], p_c[:, 1], p_c[:, 2]
    z_ok = z > 1e-2
    iz = 1.0 / torch.where(z_ok, z, torch.ones_like(z))
    u = K.fx * x * iz + K.cx
    v = K.fy * y * iz + K.cy
    ur = u - K.bf * iz
    stereo = obs.uvr[:, 2] > 0.0
    pred = torch.stack([u, v, torch.where(stereo, ur, torch.zeros_like(ur))], dim=-1)
    meas = torch.cat([obs.uvr[:, :2],
                      torch.where(stereo, obs.uvr[:, 2], torch.zeros_like(ur))[:, None]], dim=-1)
    res = pred - meas
    ok = obs.valid & z_ok
    inv_sigma2 = torch.where(ok, 1.0 / obs.sigma2, torch.zeros_like(obs.sigma2))
    chi2 = torch.sum(res * res, dim=-1) * inv_sigma2
    return robust_chi2(ok, chi2)


class SumPlans(NamedTuple):
    """The fixed summation orders of one BA problem's observations: by
    keyframe, by landmark and by (keyframe, landmark) block."""

    kf: SegmentPlan
    lm: SegmentPlan
    block: SegmentPlan


def sum_plans(obs: Observations, K_n: int, L_n: int) -> SumPlans:
    kf, lm = obs.kf.long(), obs.lm.long()
    return SumPlans(segment_plan(kf, K_n), segment_plan(lm, L_n),
                    segment_plan(kf * L_n + lm, K_n * L_n))


def schur_blocks(prob: BAProblem, res, J_pose, J_point, w, plans: SumPlans):
    """The normal equations' blocks of one linearization, each a fixed-order
    segment sum: (Hpp (K, 6, 6), Hll (L, 3, 3), bp (K, 6), bl (L, 3), the
    pose-landmark coupling Y (K, L, 6, 3))."""
    K_n = prob.T_cw.t.shape[0]
    L_n = prob.points.shape[0]
    obs = prob.obs

    Jp_w = J_pose * w[:, None, None]     # (O, 3, 6)
    Jl_w = J_point * w[:, None, None]    # (O, 3, 3)

    Hpp = segment_sum_fixed(torch.einsum("oij,oik->ojk", Jp_w, J_pose), obs.kf, K_n, plans.kf)
    Hll = segment_sum_fixed(torch.einsum("oij,oik->ojk", Jl_w, J_point), obs.lm, L_n, plans.lm)
    bp = -segment_sum_fixed(torch.einsum("oij,oi->oj", Jp_w, res), obs.kf, K_n, plans.kf)
    bl = -segment_sum_fixed(torch.einsum("oij,oi->oj", Jl_w, res), obs.lm, L_n, plans.lm)

    Hpl_o = torch.einsum("oij,oik->ojk", Jp_w, J_point)   # (O, 6, 3)
    Y = segment_sum_fixed(Hpl_o, None, K_n * L_n, plans.block).reshape(K_n, L_n, 6, 3)
    return Hpp, Hll, bp, bl, Y


def schur_terms(fixed_lm: torch.Tensor, Hll: torch.Tensor, bl: torch.Tensor, Y: torch.Tensor,
                damping: float):
    """The landmark side of the Schur complement, the first half of a
    Gauss-Newton step: the damped landmark inverses ``Hll_inv`` (L, 3, 3)
    and the two landmark terms S_l = Y Hll^-1 Y^T (K, K, 6, 6) and
    b_l = Y Hll^-1 bl (K, 6), which the landmark-sharded BA of
    ``parallel/dist_ba.py`` sums over the ranks that hold the other
    landmarks. Returns (S_l, b_l, Hll_inv)."""
    eye3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    diag_l = torch.einsum("lii->l", Hll)[:, None, None] / 3.0
    Hll_d = Hll + (0.05 * diag_l + damping + 1e-6) * eye3
    empty_lm = torch.abs(Hll).sum(dim=(-2, -1)) < 1e-10
    Hll_d = torch.where(empty_lm[:, None, None], eye3, Hll_d)
    Hll_inv = inv3x3(Hll_d)
    Hll_inv = torch.where(empty_lm[:, None, None], torch.zeros_like(eye3), Hll_inv)
    lm_free = torch.logical_not(fixed_lm)
    Hll_inv = Hll_inv * lm_free[:, None, None]

    YHinv = torch.einsum("klij,ljm->klim", Y, Hll_inv)        # (K, L, 6, 3)
    S_l = torch.einsum("alim,bljm->abij", YHinv, Y)           # (K, K, 6, 6)
    b_l = torch.einsum("klim,lm->ki", YHinv, bl)               # (K, 6)
    return S_l, b_l, Hll_inv


def schur_solve(fixed_kf: torch.Tensor, fixed_lm: torch.Tensor, Hpp: torch.Tensor,
                bp: torch.Tensor, bl: torch.Tensor, Y: torch.Tensor, S_l: torch.Tensor,
                b_l: torch.Tensor, Hll_inv: torch.Tensor, damping: float):
    """The second half of a Gauss-Newton step: the reduced pose system
    from the landmark terms of ``schur_terms``, its dense solve and the
    back-substituted landmark step, each step length clamped.
    Returns (delta_pose (K, 6), delta_point (L, 3))."""
    K_n = Hpp.shape[0]
    dev = Hpp.device
    S = -S_l
    diag = torch.arange(K_n, device=dev)
    S[diag, diag] = S[diag, diag] + Hpp
    b_schur = bp - b_l

    free = torch.logical_not(fixed_kf).to(S.dtype)
    S = S * free[:, None, None, None] * free[None, :, None, None]
    eye6 = torch.eye(6, dtype=S.dtype, device=dev)
    S[diag, diag] = S[diag, diag] + eye6 * fixed_kf.to(S.dtype)[:, None, None]
    b_schur = b_schur * free[:, None]
    S[diag, diag] = S[diag, diag] + eye6 * damping

    S_mat = S.permute(0, 2, 1, 3).reshape(K_n * 6, K_n * 6)
    b_vec = b_schur.reshape(K_n * 6)
    dp = torch.linalg.solve_ex(S_mat, b_vec)[0].reshape(K_n, 6)

    Yt_dp = torch.einsum("klim,ki->lm", Y, dp)               # (L, 3)
    dl = torch.einsum("lij,lj->li", Hll_inv, bl - Yt_dp)
    dl = dl * torch.logical_not(fixed_lm)[:, None]
    dp = dp * torch.logical_not(fixed_kf)[:, None]

    dp_n = torch.linalg.norm(dp, dim=-1, keepdim=True)
    dp = dp * torch.clamp(0.5 / torch.clamp(dp_n, min=1e-12), max=1.0)
    dl_n = torch.linalg.norm(dl, dim=-1, keepdim=True)
    dl = dl * torch.clamp(1.0 / torch.clamp(dl_n, min=1e-12), max=1.0)
    return dp, dl


def reduced_step(fixed_kf: torch.Tensor, fixed_lm: torch.Tensor, blocks, damping: float):
    """One Gauss-Newton step via Schur complement from the blocks (Hpp, Hll,
    bp, bl, Y): ``schur_terms`` then ``schur_solve``.
    Returns (delta_pose (K, 6), delta_point (L, 3))."""
    Hpp, Hll, bp, bl, Y = blocks[:5]
    S_l, b_l, Hll_inv = schur_terms(fixed_lm, Hll, bl, Y, damping)
    return schur_solve(fixed_kf, fixed_lm, Hpp, bp, bl, Y, S_l, b_l, Hll_inv, damping)


def robust_chi2(ok, chi2):
    """The sum of the valid observations' chi2, each capped at ``CHI2_CAP``."""
    return torch.sum(torch.where(ok, torch.clamp(chi2, max=CHI2_CAP), torch.zeros_like(chi2)))


def _select(accept, a, b):
    """Tree-wise torch.where over matching NamedTuples / tensors."""
    if isinstance(a, torch.Tensor):
        return torch.where(accept, a, b)
    return type(a)(*(_select(accept, x, y) for x, y in zip(a, b)))


def bundle_adjust(K: Intrinsics, prob: BAProblem, iters: int = 6,
                  damping: float = 1e-4, plans: Optional[SumPlans] = None
                  ) -> Tuple[BAProblem, BAStats]:
    """Gauss-Newton BA with a fixed iteration count; a step is rolled back if
    it increases the robust chi2. ``plans``: the problem's ``sum_plans``,
    made here where not given."""
    chis, ninl = [], []
    p = prob
    # the observation table is fixed across iterations, so are the sums' orders
    if plans is None:
        plans = sum_plans(prob.obs, prob.T_cw.t.shape[0], prob.points.shape[0])
    for _ in range(iters):
        res, J_pose, J_point, w, ok, chi2 = linearize(K, p)
        w = torch.where(ok, w, torch.zeros_like(w))
        blocks = schur_blocks(p, res, J_pose, J_point, w, plans)
        dp, dl = reduced_step(p.fixed_kf, p.fixed_lm, blocks, damping)
        T_new = lie.compose(lie.se3_exp(dp), p.T_cw)
        cand = p._replace(T_cw=T_new, points=p.points + dl)
        c_old = robust_chi2(ok, chi2)
        _, _, _, _, ok_new, chi2_new = linearize(K, cand)
        c_new = robust_chi2(ok_new, chi2_new)
        accept = torch.isfinite(c_new) & (c_new < c_old)
        p = p._replace(T_cw=_select(accept, cand.T_cw, p.T_cw),
                       points=torch.where(accept, cand.points, p.points))
        chis.append(torch.where(accept, c_new, c_old))
        ninl.append(torch.sum(ok_new))
    return p, BAStats(torch.stack(chis), torch.stack(ninl))


def ba_solve_region(K: Intrinsics, prob: BAProblem, plans: SumPlans, *, iters: int,
                    damping: float):
    """Region ``ba_solve``: the whole fixed-iteration ``bundle_adjust``, as
    the reference compiles it. Writes nothing; returns (T_cw, points,
    BAStats)."""
    p, stats = bundle_adjust(K, prob, iters=iters, damping=damping, plans=plans)
    return (), (p.T_cw, p.points, stats)


class BundleAdjuster:
    """``bundle_adjust`` on problems of one shape (``n_kf`` keyframes,
    ``n_lm`` landmarks, ``n_obs`` observations) as one captured program,
    region ``ba_solve``: eager at its first call, captured at its second,
    replayed after (``utils/jit.py``); the sum plans are made at each call,
    outside the region. ``capture=False`` runs the plain function. What a
    call returns is a copy that later calls leave alone.

    ``bundle_adjust`` itself stays a plain function: the frame step's,
    the loop closer's and ``refine_map``'s regions call it inside their own
    captures, and a region never enters another."""

    def __init__(self, device, n_kf: int, n_lm: int, n_obs: int, iters: int = 6,
                 damping: float = 1e-4, capture: bool = True):
        self.device = torch.device(device)
        self.shape = (n_kf, n_lm, n_obs)
        self._fn = functools.partial(ba_solve_region, iters=iters, damping=damping)
        self._slot_state = jit.SlotState(
            self, ("BundleAdjuster", n_kf, n_lm, n_obs, iters, damping), self.device, {},
            capture)

    @property
    def capture_stats(self) -> Dict[str, Dict]:
        """{region: calls, captured, capture seconds, graph pool bytes}; empty
        on the eager path."""
        return self._slot_state.stats()

    def __call__(self, K: Intrinsics, prob: BAProblem) -> Tuple[BAProblem, BAStats]:
        shape = (prob.T_cw.t.shape[0], prob.points.shape[0], prob.obs.valid.shape[0])
        if shape != self.shape:
            raise ValueError(f"a BundleAdjuster of {self.shape} (keyframes, landmarks, "
                             f"observations) given a problem of {shape}")
        plans = sum_plans(prob.obs, shape[0], shape[1])
        st = self._slot_state
        _, out = st.run("ba_solve", self._fn, K, prob, plans)
        T_cw, points, stats = st.snapshot(out)
        return prob._replace(T_cw=T_cw, points=points), stats


def retriangulate_points(K: Intrinsics, T_cw: lie.SE3, points: torch.Tensor,
                         obs: Observations, lm_valid: torch.Tensor,
                         stereo_weight: float = 1.0) -> torch.Tensor:
    """Linear re-triangulation of every landmark from its observations: per
    landmark, the DLT least squares over all its observation rays (two
    image-line rows an observation, plus an absolute-depth row for stereo
    rows: u - u_r = bf / z, weighted by ``stereo_weight``), segment-summed in
    a fixed order into (3, 3) / (3,) normal equations and solved with the
    closed-form 3x3 inverse. Landmarks whose system is ill-conditioned (the
    reference's LU determinant guard) or whose solution is not finite keep
    their current position. Returns (L, 3) positions."""
    L_n = points.shape[0]
    kf = obs.kf.long()
    R, t = T_cw.R[kf], T_cw.t[kf]            # (O, 3, 3), (O, 3)
    u, v, ur = obs.uvr[:, 0], obs.uvr[:, 1], obs.uvr[:, 2]
    xn = (u - K.cx) / K.fx
    yn = (v - K.cy) / K.fy
    r0, r1, r2 = R[:, 0, :], R[:, 1, :], R[:, 2, :]
    a1 = xn[:, None] * r2 - r0               # (O, 3)
    b1 = t[:, 0] - xn * t[:, 2]
    a2 = yn[:, None] * r2 - r1
    b2 = t[:, 1] - yn * t[:, 2]
    stereo = ur > 0.0
    disp = torch.clamp(u - ur, min=1e-6)
    z_meas = K.bf / disp
    a3 = r2
    b3 = z_meas - t[:, 2]
    w = torch.where(obs.valid, 1.0 / obs.sigma2, torch.zeros_like(obs.sigma2))
    w3 = stereo_weight * w * stereo.to(torch.float32)
    AtA_o = (w[:, None, None] * (a1[:, :, None] * a1[:, None, :]
                                 + a2[:, :, None] * a2[:, None, :])
             + w3[:, None, None] * a3[:, :, None] * a3[:, None, :])
    Atb_o = (w[:, None] * (a1 * b1[:, None] + a2 * b2[:, None])
             + w3[:, None] * a3 * b3[:, None])
    plan = segment_plan(obs.lm, L_n)
    AtA = segment_sum_fixed(AtA_o, obs.lm, L_n, plan)
    Atb = segment_sum_fixed(Atb_o, obs.lm, L_n, plan)
    trace = torch.einsum("lii->l", AtA)
    lam = 1e-5 * trace[:, None, None] / 3.0
    eye3 = torch.eye(3, dtype=AtA.dtype, device=AtA.device)
    AtA_d = AtA + (lam + 1e-9) * eye3
    det = torch.linalg.det(AtA)
    scale = torch.clamp(trace / 3.0, min=1e-12)
    well = (det > 1e-4 * scale ** 3) & lm_valid
    p_new = torch.einsum("lij,lj->li", inv3x3(AtA_d), Atb)
    ok = well & torch.all(torch.isfinite(p_new), dim=-1)
    return torch.where(ok[:, None], p_new, points)


def solve_pose(
    K: Intrinsics,
    T_cw0: lie.SE3,
    points_w: torch.Tensor,   # (N, 3)
    uvr: torch.Tensor,        # (N, 3) [u, v, u_r]; u_r < 0 for mono rows
    sigma2: torch.Tensor,     # (N,)
    valid: torch.Tensor,      # (N,) bool
    iters: int = 8,
    damping: float = 1e-3,
) -> Tuple[lie.SE3, torch.Tensor, torch.Tensor]:
    """Gauss-Newton camera-pose refinement with Huber IRLS.
    Returns (T_cw, inlier_mask, final robust chi2).

    ``T_cw0`` may carry leading batch dimensions (B,) with the observations
    batched alike ((B, N, ...)); every hypothesis then iterates independently."""
    stereo = uvr[..., 2] > 0.0
    eye6 = torch.eye(6, dtype=uvr.dtype, device=uvr.device)

    def lin(T):
        res, J_pose, _, z_ok = _residual_and_jac(
            K, T.R[..., None, :, :], T.t[..., None, :], points_w, uvr, stereo)
        ok = valid & z_ok
        inv_s2 = torch.where(ok, 1.0 / sigma2, torch.zeros_like(sigma2))
        chi2 = torch.sum(res * res, dim=-1) * inv_s2
        w = inv_s2 * huber_weight(chi2, delta=_SQRT_CHI2_MONO)
        return res, J_pose, w, ok, chi2

    def robust_sum(ok, chi2):
        return torch.sum(torch.where(ok, torch.clamp(chi2, max=5.991 * 4),
                                     torch.zeros_like(chi2)), dim=-1)

    # one linearization per iteration: the current pose's is carried, only
    # the candidate's is computed
    res, J, w, ok, chi2 = lin(T_cw0)
    T = T_cw0
    c_old = robust_sum(ok, chi2)
    for _ in range(iters):
        Jw = J * w[..., None, None]
        H = torch.einsum("...oij,...oik->...jk", Jw, J) + damping * eye6
        b = -torch.einsum("...oij,...oi->...j", Jw, res)
        dx = torch.linalg.solve_ex(H, b)[0]
        T_new = lie.compose(lie.se3_exp(dx), T)
        res2, J2, w2, ok2, chi2_new = lin(T_new)
        c_new = robust_sum(ok2, chi2_new)
        accept = c_new < c_old
        a1 = accept[..., None]
        T = lie.SE3(torch.where(accept[..., None, None], T_new.R, T.R),
                    torch.where(a1, T_new.t, T.t))
        res = torch.where(a1[..., None], res2, res)
        J = torch.where(a1[..., None, None], J2, J)
        w = torch.where(a1, w2, w)
        ok = torch.where(a1, ok2, ok)
        c_old = torch.where(accept, c_new, c_old)
    _, _, _, ok, chi2 = lin(T)
    inliers = ok & (chi2 < torch.where(stereo, 7.815, 5.991))
    return T, inliers, robust_sum(ok, chi2)
