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

The reference compiles each solve into one program; here the device work
between two reductions is a captured region (``utils/jit.py``), a CUDA
graph replayed once an iteration, and the reductions run between the
regions, outside every graph (gloo cannot be captured; nccl's collectives
stay outside too, so both backends run one path):

- observation-sharded: ``obs_blocks`` (the previous iteration's accept,
  the shard's blocks and chi2, flat) -> psum -> ``obs_step`` (the step, the
  candidate, its local chi2) -> psum;
- landmark-sharded: ``lm_blocks`` -> the Hpp, bp and chi2 reductions ->
  ``lm_schur`` (``ba.schur_terms``) -> the S_l and b_l reductions ->
  ``lm_solve`` (``ba.schur_solve``, the candidate, its local chi2) -> the
  candidate chi2's reduction.

The chain's poses, points and candidate live in the slot's buffers, which
the regions write in place; the solve's first accept is a no-op (its
candidate chi2 is +inf) and its last runs eagerly, into fresh tensors that
the caller keeps. The slot lives on the mesh (``Mesh.solver_state``): its
first ``EAGER_SOLVES`` solves run the regions eagerly, the next captures
them and every later solve of the same shapes replays them.
``capture=False`` runs the same region functions as plain PyTorch; the two
are bit-equal.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from fitslam_tpu_torch.ops import ba as ba_mod
from fitslam_tpu_torch.ops import lie
from fitslam_tpu_torch.ops.geometry import Intrinsics
from fitslam_tpu_torch.parallel.mesh import Mesh, data_sharding, psum

# the solves of a mesh's slot (one a problem shape) whose regions run as
# plain PyTorch before the next solve captures them: over gloo on one card a
# replay saved no wall time while a capture cost its solve ~0.4 s (PERF.md
# §6, PR 17), so a shape solved once (a loop correction's GBA, whose
# observation shards change size with the map) is never captured
EAGER_SOLVES = 1


def _accept(c_new, c_old, T_new, T_cw, pts_new, points):
    accept = torch.isfinite(c_new) & (c_new < c_old)
    T_out = lie.SE3(torch.where(accept, T_new.R, T_cw.R), torch.where(accept, T_new.t, T_cw.t))
    return T_out, torch.where(accept, pts_new, points)


def _chain(prob: ba_mod.BAProblem, points: torch.Tensor) -> dict:
    """The fields a solve's regions chain through: the poses and (local)
    points, the candidate of the last step and the two chi2 that accept it
    (+inf for the candidate's: nothing to accept before the first step)."""
    inf = torch.full((), float("inf"), device=points.device)
    return dict(T=prob.T_cw, points=points, cand_T=prob.T_cw, cand_points=points,
                c_new=inf, c_old=inf)


def _linearized_blocks(K, T, points, obs, plans, fixed_kf, fixed_lm):
    """The shard's normal-equation blocks and robust chi2 at (T, points)."""
    prob = ba_mod.BAProblem(T_cw=T, points=points, obs=obs, fixed_kf=fixed_kf, fixed_lm=fixed_lm)
    res, J_pose, J_point, w, ok, chi2 = ba_mod.linearize(K, prob)
    w = torch.where(ok, w, torch.zeros_like(w))
    Hpp, Hll, bp, bl, Y = ba_mod.schur_blocks(prob, res, J_pose, J_point, w, plans)
    return Hpp, Hll, bp, bl, Y, ba_mod.robust_chi2(ok, chi2)


# ---------------------------------------------------------------------------
# Observation-sharded BA
# ---------------------------------------------------------------------------


def obs_blocks_region(K, T, points, cand_T, cand_points, c_new, c_old, obs, plans, fixed_kf,
                      fixed_lm):
    """Region ``obs_blocks``: the previous step accepted or not, then this
    shard's blocks (Hpp, Hll, bp, bl, Y) and robust chi2 in one flat buffer,
    summed over the ranks in one reduction. Writes T and points."""
    T, points = _accept(c_new, c_old, cand_T, T, cand_points, points)
    out = _linearized_blocks(K, T, points, obs, plans, fixed_kf, fixed_lm)
    return (None, T, points), torch.cat([x.reshape(-1) for x in out])


def obs_step_region(K, T, points, cand_T, cand_points, flat, obs, fixed_kf, fixed_lm, *,
                    damping: float):
    """Region ``obs_step``: the reduced step from the summed blocks, the
    candidate and its residual-only chi2 on this shard (one more reduction).
    Writes the candidate."""
    K_n, L_n = T.t.shape[0], points.shape[0]
    shapes = ((K_n, 6, 6), (L_n, 3, 3), (K_n, 6), (L_n, 3), (K_n, L_n, 6, 3))
    parts = torch.split(flat, [int(np.prod(s)) for s in shapes] + [1])
    blocks = [b.reshape(s) for b, s in zip(parts, shapes)]
    dp, dl = ba_mod.reduced_step(fixed_kf, fixed_lm, blocks, damping)
    T_new = lie.compose(lie.se3_exp(dp), T)
    pts_new = points + dl
    return (None, None, None, T_new, pts_new), ba_mod.chi2_residuals(K, T_new, pts_new, obs)


def distributed_bundle_adjust(
    mesh: Mesh,
    K: Intrinsics,
    prob: ba_mod.BAProblem,
    iters: int = 6,
    damping: float = 1e-3,
    axis: str = "data",
    capture: bool = True,
) -> Tuple[ba_mod.BAProblem, torch.Tensor]:
    """Observation-sharded BA. The observation capacity must divide by the
    mesh axis size (pad with invalid slots). Returns (problem, chi2 history:
    the chi2 before each iteration's step). ``capture=False`` runs the
    regions as plain PyTorch."""
    n_dev = mesh.shape[axis]
    O = prob.obs.valid.shape[0]
    assert O % n_dev == 0, f"obs capacity {O} not divisible by mesh axis {n_dev}"
    obs_shard = data_sharding(mesh, axis)(prob.obs)
    K_n, L_n = prob.T_cw.t.shape[0], prob.points.shape[0]
    # the shard is fixed across iterations, so are its sums' orders
    plans = ba_mod.sum_plans(obs_shard, K_n, L_n)
    st = mesh.solver_state(
        "distributed_bundle_adjust", (K_n, L_n, O, damping), axis,
        dict(K=K, obs=obs_shard, plans=plans, fixed_kf=prob.fixed_kf, fixed_lm=prob.fixed_lm,
             **_chain(prob, prob.points)), capture)
    step = functools.partial(obs_step_region, damping=damping)
    run = functools.partial(st.run, eager=EAGER_SOLVES * iters)
    chis = []
    for _ in range(iters):
        args, flat = run(
            "obs_blocks", obs_blocks_region, st["K"], st["T"], st["points"], st["cand_T"],
            st["cand_points"], st["c_new"], st["c_old"], st["obs"], st["plans"],
            st["fixed_kf"], st["fixed_lm"])
        st["T"], st["points"] = args[1:3]
        flat = psum(mesh, flat, axis)
        args, c_local = run(
            "obs_step", step, st["K"], st["T"], st["points"], st["cand_T"], st["cand_points"],
            flat, st["obs"], st["fixed_kf"], st["fixed_lm"])
        st["cand_T"], st["cand_points"] = args[3:5]
        # candidate chi2: residual-only pass, one scalar across the ranks
        st["c_new"], st["c_old"] = psum(mesh, c_local, axis), flat[-1]
        chis.append(flat[-1])
    T_cw, points = _accept(st["c_new"], st["c_old"], st["cand_T"], st["T"], st["cand_points"],
                           st["points"])
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


def lm_blocks_region(K, T, points, cand_T, cand_points, c_new, c_old, obs, plans, fixed_kf,
                     fixed_lm):
    """Region ``lm_blocks``: the previous step accepted or not, then this
    landmark block's normal-equation blocks. Hpp, bp and the chi2 cross the
    ranks (every observation of a landmark lives on its owner, so the
    landmark-side blocks Hll, bl and Y stay local). Writes T and points;
    returns (Hpp, bp, chi2, Hll, bl, Y)."""
    T, points = _accept(c_new, c_old, cand_T, T, cand_points, points)
    Hpp, Hll, bp, bl, Y, chi2 = _linearized_blocks(K, T, points, obs, plans, fixed_kf, fixed_lm)
    return (None, T, points), (Hpp, bp, chi2, Hll, bl, Y)


def lm_schur_region(fixed_lm, Hll, bl, Y, *, damping: float):
    """Region ``lm_schur``: ``ba.schur_terms`` of this landmark block, its
    S_l and b_l partial sums to cross the ranks. Returns (S_l, b_l,
    Hll_inv)."""
    return (), ba_mod.schur_terms(fixed_lm, Hll, bl, Y, damping)


def lm_solve_region(K, T, points, cand_T, cand_points, Hpp, bp, bl, Y, S_l, b_l, Hll_inv, obs,
                    fixed_kf, fixed_lm, *, damping: float):
    """Region ``lm_solve``: ``ba.schur_solve`` from the summed terms, the
    candidate and its residual-only chi2 on this block (exact before the
    reduction: every observation of a landmark lives on its owner). Writes
    the candidate."""
    dp, dl = ba_mod.schur_solve(fixed_kf, fixed_lm, Hpp, bp, bl, Y, S_l, b_l, Hll_inv, damping)
    T_new = lie.compose(lie.se3_exp(dp), T)
    pts_new = points + dl
    return (None, None, None, T_new, pts_new), ba_mod.chi2_residuals(K, T_new, pts_new, obs)


def landmark_sharded_bundle_adjust(
    mesh: Mesh,
    K: Intrinsics,
    prob: ba_mod.BAProblem,
    iters: int = 6,
    damping: float = 1e-3,
    axis: str = "data",
    capture: bool = True,
) -> Tuple[ba_mod.BAProblem, torch.Tensor]:
    """Map-block-sharded BA: landmarks, their observations, Hll blocks, bl
    and the coupling tensor Y are sharded; only the (K, 6) / (K, K, 6, 6)
    pose-side terms cross the ranks. A rank's Y is 1/n of the
    observation-sharded variant's (K, L, 6, 3). The observation table must be
    pre-routed with ``shard_problem_by_landmark``. ``capture=False`` runs
    the regions as plain PyTorch.

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
    d = mesh.axis_index(axis)
    # localize landmark indices into this shard's block (the offset d * Lb
    # is a host number: it stays out of the regions)
    lm_local = torch.clamp(obs_shard.lm - d * Lb, 0, Lb - 1).to(torch.int32)
    obs_local = obs_shard._replace(lm=lm_local)
    K_n = prob.T_cw.t.shape[0]
    plans = ba_mod.sum_plans(obs_local, K_n, Lb)
    st = mesh.solver_state(
        "landmark_sharded_bundle_adjust", (K_n, L, O, damping), axis,
        dict(K=K, obs=obs_local, plans=plans, fixed_kf=prob.fixed_kf, fixed_lm=fixed_lm_blk,
             **_chain(prob, points_blk)), capture)
    schur = functools.partial(lm_schur_region, damping=damping)
    solve = functools.partial(lm_solve_region, damping=damping)
    reduce = lambda x: psum(mesh, x, axis)
    run = functools.partial(st.run, eager=EAGER_SOLVES * iters)
    chis = []
    for _ in range(iters):
        args, (Hpp, bp, chi2, Hll, bl, Y) = run(
            "lm_blocks", lm_blocks_region, st["K"], st["T"], st["points"], st["cand_T"],
            st["cand_points"], st["c_new"], st["c_old"], st["obs"], st["plans"],
            st["fixed_kf"], st["fixed_lm"])
        st["T"], st["points"] = args[1:3]
        Hpp, bp, c_old = reduce(Hpp), reduce(bp), reduce(chi2)
        # the Schur complement and its b-term: partial over the local block,
        # then one reduction each
        _, (S_l, b_l, Hll_inv) = run("lm_schur", schur, st["fixed_lm"], Hll, bl, Y)
        S_l, b_l = reduce(S_l), reduce(b_l)
        args, c_local = run(
            "lm_solve", solve, st["K"], st["T"], st["points"], st["cand_T"], st["cand_points"],
            Hpp, bp, bl, Y, S_l, b_l, Hll_inv, st["obs"], st["fixed_kf"], st["fixed_lm"])
        st["cand_T"], st["cand_points"] = args[3:5]
        st["c_new"], st["c_old"] = reduce(c_local), c_old
        chis.append(c_old)
    T_cw, points = _accept(st["c_new"], st["c_old"], st["cand_T"], st["T"], st["cand_points"],
                           st["points"])
    return prob._replace(T_cw=T_cw, points=mesh.all_gather(points, axis)), torch.stack(chis)
