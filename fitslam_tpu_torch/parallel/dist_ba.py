"""Distributed bundle adjustment over a mesh of ranks (port of
``fitslam_tpu/parallel/dist_ba.py``).

Two shardings of the same Schur-complement Gauss-Newton as ``ops/ba.py``:

- observation-sharded (``distributed_bundle_adjust``): each rank linearizes
  its contiguous slice of the observation table; the block tuple (Hpp, Hll,
  bp, bl, Y and the chi2) crosses as ONE ``all_reduce`` of a flat buffer, and
  the candidate's chi2 as one more scalar: two reductions an iteration. The
  reduced solve is the same on every rank;
- landmark-sharded (``landmark_sharded_bundle_adjust``): each rank owns a
  contiguous block of landmarks with their observations (routed by
  ``shard_problem_by_landmark``), their Hll blocks and its (K, L/n, 6, 3)
  slice of the coupling tensor Y; only pose-side terms cross: Hpp, bp, the
  Schur complement, its b-term, the chi2 and the candidate's chi2, six
  reductions an iteration, then one all-gather of the points at the end.

Every input is whole on every rank; each function slices what it shards and
returns the reference's outputs on every rank. Within a rank every float32
segment sum is ``numerics.segment_sum_fixed`` (ROADMAP F17): the local sums
repeat run for run, and the all-reduce adds the ranks' partial sums.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fitslam_tpu_torch.ops import ba as ba_mod
from fitslam_tpu_torch.ops import lie
from fitslam_tpu_torch.ops.geometry import Intrinsics
from fitslam_tpu_torch.parallel.mesh import Mesh, data_sharding, psum


def _local_blocks(K: Intrinsics, T_cw: lie.SE3, points, fixed_lm, obs: ba_mod.Observations,
                  mesh: Mesh, axis: str, plans: ba_mod.SumPlans):
    """Linearize the local observation shard and sum its blocks over the
    ranks in one reduction: (Hpp, Hll, bp, bl, Y, chi2)."""
    K_n = T_cw.t.shape[0]
    prob = ba_mod.BAProblem(T_cw=T_cw, points=points, obs=obs,
                            fixed_kf=torch.zeros((K_n,), dtype=torch.bool, device=T_cw.t.device),
                            fixed_lm=fixed_lm)
    res, J_pose, J_point, w, ok, chi2 = ba_mod.linearize(K, prob)
    w = torch.where(ok, w, torch.zeros_like(w))
    blocks = ba_mod.schur_blocks(prob, res, J_pose, J_point, w, plans)
    out = (*blocks, ba_mod.robust_chi2(ok, chi2))
    flat = psum(mesh, torch.cat([x.reshape(-1) for x in out]), axis)
    return tuple(b.reshape(x.shape) for b, x in zip(torch.split(flat, [x.numel() for x in out]),
                                                     out))


def _accept(c_new, c_old, T_new, T_cw, pts_new, points):
    accept = torch.isfinite(c_new) & (c_new < c_old)
    T_out = lie.SE3(torch.where(accept, T_new.R, T_cw.R), torch.where(accept, T_new.t, T_cw.t))
    return T_out, torch.where(accept, pts_new, points)


def distributed_bundle_adjust(
    mesh: Mesh,
    K: Intrinsics,
    prob: ba_mod.BAProblem,
    iters: int = 6,
    damping: float = 1e-3,
    axis: str = "data",
) -> Tuple[ba_mod.BAProblem, torch.Tensor]:
    """Observation-sharded BA. The observation capacity must divide by the
    mesh axis size (pad with invalid slots). Returns (problem, chi2 history:
    the chi2 before each iteration's step)."""
    n_dev = mesh.shape[axis]
    O = prob.obs.valid.shape[0]
    assert O % n_dev == 0, f"obs capacity {O} not divisible by mesh axis {n_dev}"
    obs_shard = data_sharding(mesh, axis)(prob.obs)
    K_n, L_n = prob.T_cw.t.shape[0], prob.points.shape[0]
    # the shard is fixed across iterations, so are its sums' orders
    plans = ba_mod.sum_plans(obs_shard, K_n, L_n)

    T_cw, points = prob.T_cw, prob.points
    chis = []
    for _ in range(iters):
        blocks = _local_blocks(K, T_cw, points, prob.fixed_lm, obs_shard, mesh, axis, plans)
        dp, dl = ba_mod.reduced_step(prob.fixed_kf, prob.fixed_lm, blocks, damping)
        T_new = lie.compose(lie.se3_exp(dp), T_cw)
        pts_new = points + dl
        # candidate chi2: residual-only pass, one scalar across the ranks
        c_new = psum(mesh, ba_mod.chi2_residuals(K, T_new, pts_new, obs_shard), axis)
        c_old = blocks[-1]
        T_cw, points = _accept(c_new, c_old, T_new, T_cw, pts_new, points)
        chis.append(c_old)
    return prob._replace(T_cw=T_cw, points=points), torch.stack(chis)


# ---------------------------------------------------------------------------
# Landmark-block-sharded BA (map-block sharding)
# ---------------------------------------------------------------------------


def shard_problem_by_landmark(prob: ba_mod.BAProblem, n_dev: int) -> ba_mod.BAProblem:
    """Host-side repack: route every observation to the shard that owns its
    landmark (shard d owns landmarks [d*L/n, (d+1)*L/n)), padding each shard
    to a common size (a multiple of 8) so the observation table stays
    fixed-shape. Padding rows point at the shard's first landmark with
    valid=False (exact no-ops). The landmark capacity must divide by n_dev."""
    L = prob.points.shape[0]
    assert L % n_dev == 0, f"landmark capacity {L} not divisible by {n_dev}"
    Lb = L // n_dev
    dev = prob.points.device
    kf = prob.obs.kf.cpu().numpy()
    lm = prob.obs.lm.cpu().numpy()
    uvr = prob.obs.uvr.cpu().numpy()
    s2 = prob.obs.sigma2.cpu().numpy()
    ok = prob.obs.valid.cpu().numpy()

    shard_of = lm // Lb
    counts = np.bincount(shard_of[ok], minlength=n_dev)
    cap = int(max(1, counts.max()))
    cap = -(-cap // 8) * 8

    O_new = n_dev * cap
    kf_n = np.zeros((n_dev, cap), np.int32)
    lm_n = np.tile((np.arange(n_dev) * Lb)[:, None], (1, cap)).astype(np.int32)
    uvr_n = np.zeros((n_dev, cap, 3), np.float32)
    s2_n = np.ones((n_dev, cap), np.float32)
    ok_n = np.zeros((n_dev, cap), bool)
    for d in range(n_dev):
        sel = np.nonzero(ok & (shard_of == d))[0]
        k = len(sel)
        kf_n[d, :k] = kf[sel]
        lm_n[d, :k] = lm[sel]
        uvr_n[d, :k] = uvr[sel]
        s2_n[d, :k] = s2[sel]
        ok_n[d, :k] = True
    up = lambda a: torch.from_numpy(a).to(dev)
    obs = ba_mod.Observations(kf=up(kf_n.reshape(O_new)), lm=up(lm_n.reshape(O_new)),
                              uvr=up(uvr_n.reshape(O_new, 3)), sigma2=up(s2_n.reshape(O_new)),
                              valid=up(ok_n.reshape(O_new)))
    return prob._replace(obs=obs)


def landmark_sharded_bundle_adjust(
    mesh: Mesh,
    K: Intrinsics,
    prob: ba_mod.BAProblem,
    iters: int = 6,
    damping: float = 1e-3,
    axis: str = "data",
) -> Tuple[ba_mod.BAProblem, torch.Tensor]:
    """Map-block-sharded BA: landmarks, their observations, Hll blocks, bl
    and the coupling tensor Y are sharded; only the (K, 6) / (K, K, 6, 6)
    pose-side terms cross the ranks. A rank's Y is 1/n of the
    observation-sharded variant's (K, L, 6, 3). The observation table must be
    pre-routed with ``shard_problem_by_landmark``.

    Returns (problem with the full points on every rank, chi2 history)."""
    n_dev = mesh.shape[axis]
    L = prob.points.shape[0]
    O = prob.obs.valid.shape[0]
    assert L % n_dev == 0, f"landmark capacity {L} not divisible by {n_dev}"
    assert O % n_dev == 0, f"obs capacity {O} not divisible by {n_dev}"
    Lb = L // n_dev
    shard = data_sharding(mesh, axis)
    obs_shard = shard(prob.obs)
    points_blk, fixed_lm_blk = shard(prob.points), shard(prob.fixed_lm)
    fixed_kf = prob.fixed_kf
    d = mesh.axis_index(axis)
    # localize landmark indices into this shard's block
    lm_local = torch.clamp(obs_shard.lm - d * Lb, 0, Lb - 1).to(torch.int32)
    obs_local = obs_shard._replace(lm=lm_local)
    K_n = prob.T_cw.t.shape[0]
    plans = ba_mod.sum_plans(obs_local, K_n, Lb)
    reduce = lambda x: psum(mesh, x, axis)

    def blocks_of(T_cw, points):
        prob_l = ba_mod.BAProblem(T_cw=T_cw, points=points, obs=obs_local,
                                  fixed_kf=fixed_kf, fixed_lm=fixed_lm_blk)
        res, J_pose, J_point, w, ok, chi2 = ba_mod.linearize(K, prob_l)
        w = torch.where(ok, w, torch.zeros_like(w))
        Hpp, Hll, bp, bl, Y = ba_mod.schur_blocks(prob_l, res, J_pose, J_point, w, plans)
        # pose-side reductions cross landmark shards; every observation of a
        # landmark lives on its owner, so the landmark-side blocks stay local
        return reduce(Hpp), Hll, reduce(bp), bl, Y, reduce(ba_mod.robust_chi2(ok, chi2))

    T_cw, points = prob.T_cw, points_blk
    chis = []
    for _ in range(iters):
        blocks = blocks_of(T_cw, points)
        # the Schur complement and its b-term: partial over the local block,
        # then one reduction each
        dp, dl = ba_mod.reduced_step(fixed_kf, fixed_lm_blk, blocks, damping, reduce=reduce)
        T_new = lie.compose(lie.se3_exp(dp), T_cw)
        pts_new = points + dl
        # residual-only candidate chi2: the local sum is exact before the
        # reduction, every observation of a landmark lives on its owner
        c_new = reduce(ba_mod.chi2_residuals(K, T_new, pts_new, obs_local))
        c_old = blocks[-1]
        T_cw, points = _accept(c_new, c_old, T_new, T_cw, pts_new, points)
        chis.append(c_old)
    return prob._replace(T_cw=T_cw, points=mesh.all_gather(points, axis)), torch.stack(chis)
