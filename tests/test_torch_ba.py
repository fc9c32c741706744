"""Parity of the port's bundle adjustment with the reference on planted
problems (made with numpy from a seed; the reference runs under jax.jit).

Tolerances: poses within 1e-4 (float32 Gauss-Newton with LU solves; the two
frameworks sum the normal equations in different orders, ROADMAP fault F5),
chi2 within rtol 1e-3, inlier masks exactly equal. Single linear-algebra
kernels (inv3x3, linearize, chi2_residuals) are held to float32 rounding
of their inputs' magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitslam_tpu.ops import ba as jba
from fitslam_tpu.ops import geometry as jgeo
from fitslam_tpu.ops import lie as jlie
from fitslam_tpu_torch.ops import ba as tba
from fitslam_tpu_torch.utils import interop

# several pytest-xdist workers share the machine: torch's default of one
# intra-op thread per core would oversubscribe it
torch.set_num_threads(2)

FX, FY, CX, CY, BASE = 400.0, 400.0, 320.0, 240.0, 0.2


def _K():
    return jgeo.Intrinsics(*(np.float32(v) for v in (FX, FY, CX, CY, BASE)))


def _project(R, t, p):
    pc = p @ R.T + t
    u = FX * pc[:, 0] / pc[:, 2] + CX
    v = FY * pc[:, 1] / pc[:, 2] + CY
    return np.stack([u, v, u - FX * BASE / pc[:, 2]], -1)


def _se3(xi):
    T = jax.jit(jlie.se3_exp)(jnp.asarray(xi, jnp.float32))
    return np.array(T.R), np.array(T.t)


def _pose_problem(seed):
    rng = np.random.RandomState(seed)
    n = 300
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-2, 2, n), rng.uniform(2, 15, n)], -1)
    R, t = _se3(rng.normal(scale=[0.1, 0.1, 0.1, 0.05, 0.05, 0.05]))
    pts_w = ((pts - t) @ R).astype(np.float32)            # camera-frame pts -> world
    uvr = _project(R, t, pts_w) + rng.normal(scale=0.5, size=(n, 3))
    mono = rng.rand(n) < 0.3
    uvr[mono, 2] = -1.0
    outlier = rng.rand(n) < 0.1
    uvr[outlier, :2] += rng.uniform(-40, 40, (outlier.sum(), 2))
    sigma2 = (1.4142135 ** rng.randint(0, 4, n).astype(np.float32)) ** 2
    valid = rng.rand(n) < 0.95
    R0, t0 = _se3(rng.normal(scale=[0.05, 0.05, 0.05, 0.02, 0.02, 0.02]))
    R0, t0 = R0 @ R, R0 @ t + t0
    return (jlie.SE3(R0.astype(np.float32), t0.astype(np.float32)), pts_w, uvr.astype(np.float32),
            sigma2.astype(np.float32), valid)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_pose(seed):
    T0, pts, uvr, sigma2, valid = _pose_problem(seed)
    K = _K()
    T_ref, inl_ref, chi_ref = jax.tree.map(np.asarray, jba.solve_pose(K, T0, pts, uvr, sigma2, valid))
    T, inl, chi = tba.solve_pose(interop.to_torch(K), interop.to_torch(T0), torch.tensor(pts),
                                 torch.tensor(uvr), torch.tensor(sigma2), torch.tensor(valid))
    np.testing.assert_allclose(T.R.numpy(), T_ref.R, atol=1e-4)
    np.testing.assert_allclose(T.t.numpy(), T_ref.t, atol=1e-4)
    np.testing.assert_array_equal(inl.numpy(), inl_ref)
    np.testing.assert_allclose(chi.numpy(), chi_ref, rtol=1e-3)


def test_solve_pose_batch_equals_single():
    """The tracker solves its narrow and wide hypotheses as one batch."""
    T0, pts, uvr, sigma2, valid = _pose_problem(3)
    K = interop.to_torch(_K())
    T0 = interop.to_torch(T0)
    args = [torch.tensor(a) for a in (pts, uvr, sigma2, valid)]
    T1, inl1, chi1 = tba.solve_pose(K, T0, *args)
    Tb, inlb, chib = tba.solve_pose(K, type(T0)(T0.R.expand(2, 3, 3), T0.t.expand(2, 3)),
                                    *[a.expand((2,) + a.shape) for a in args])
    for k in range(2):
        torch.testing.assert_close(Tb.R[k], T1.R, atol=1e-6, rtol=0)
        torch.testing.assert_close(Tb.t[k], T1.t, atol=1e-6, rtol=0)
        assert torch.equal(inlb[k], inl1)


def _ba_problem(seed, n_kf=4, n_lm=80, n_obs=480):
    rng = np.random.RandomState(seed)
    pts = np.stack([rng.uniform(-3, 3, n_lm), rng.uniform(-2, 2, n_lm), rng.uniform(4, 10, n_lm)], -1)
    Rs, ts = _se3(np.concatenate([rng.normal(scale=0.3, size=(n_kf, 3)),
                                  rng.normal(scale=0.03, size=(n_kf, 3))], -1))
    Rs[0], ts[0] = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    kf = rng.randint(0, n_kf, n_obs).astype(np.int32)
    lm = rng.randint(0, n_lm, n_obs).astype(np.int32)
    uvr = np.concatenate([_project(Rs[k], ts[k], pts[l][None]) for k, l in zip(kf, lm)])
    uvr = uvr + rng.normal(scale=0.3, size=uvr.shape)
    uvr[rng.rand(n_obs) < 0.3, 2] = -1.0
    obs = jba.Observations(kf, lm, uvr.astype(np.float32), np.ones(n_obs, np.float32),
                           rng.rand(n_obs) < 0.97)
    Rp, tp = _se3(rng.normal(scale=0.01, size=(n_kf, 6)))
    T0 = jlie.SE3((Rp @ Rs).astype(np.float32),
                  (np.einsum("kij,kj->ki", Rp, ts) + tp).astype(np.float32))
    fixed_kf = np.zeros(n_kf, bool)
    fixed_kf[0] = True
    fixed_lm = rng.rand(n_lm) < 0.1
    points = (pts + rng.normal(scale=0.05, size=pts.shape)).astype(np.float32)
    return jba.BAProblem(T0, points, obs, fixed_kf, fixed_lm)


@pytest.mark.parametrize("seed", [0, 1])
def test_bundle_adjust(seed):
    prob = _ba_problem(seed)
    K = _K()
    out_ref, st_ref = jax.tree.map(np.asarray, jba.bundle_adjust(K, prob, iters=4, damping=1e-3))
    out, st = tba.bundle_adjust(interop.to_torch(K), interop.to_torch(prob), iters=4, damping=1e-3)
    out = interop.to_numpy(out)
    np.testing.assert_allclose(out.T_cw.R, out_ref.T_cw.R, atol=1e-4)
    np.testing.assert_allclose(out.T_cw.t, out_ref.T_cw.t, atol=1e-4)
    np.testing.assert_allclose(out.points, out_ref.points, atol=1e-4)
    np.testing.assert_allclose(st.chi2.numpy(), st_ref.chi2, rtol=1e-3)
    np.testing.assert_array_equal(st.num_inliers.numpy(), st_ref.num_inliers)
    assert st_ref.chi2[-1] < st_ref.chi2[0]


def test_linearize_and_chi2_residuals():
    prob = _ba_problem(5)
    K = _K()
    ref = jax.tree.map(np.asarray, jax.jit(jba.linearize)(K, prob))
    got = tba.linearize(interop.to_torch(K), interop.to_torch(prob))
    # residuals are small differences of ~300 px predictions: float32
    # rounding of the prediction (~4e-5 px) is amplified in chi2 = |r|^2
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-3)
    c_ref = np.asarray(jax.jit(jba.chi2_residuals)(K, prob.T_cw, prob.points, prob.obs))
    c = tba.chi2_residuals(interop.to_torch(K), interop.to_torch(prob.T_cw),
                           torch.tensor(prob.points), interop.to_torch(prob.obs))
    np.testing.assert_allclose(c.numpy(), c_ref, rtol=1e-5)


def test_inv3x3():
    rng = np.random.RandomState(4)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + np.eye(3, dtype=np.float32)
    ref = np.asarray(jax.jit(jba.inv3x3)(A))
    np.testing.assert_allclose(tba.inv3x3(torch.tensor(A)).numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rows,n,width", [(1, 1, 1), (500, 40, 9), (3000, 7, 3), (2000, 900, 18)])
def test_segment_sum_fixed_equals_sequential_sum(rows, n, width):
    """The fixed-order segment sum is bit-equal to adding each row, in row
    order, into its segment (ids outside [0, n) dropped), however the data's
    magnitudes mix, and a plan built once gives the same."""
    from fitslam_tpu_torch.ops.numerics import segment_plan, segment_sum_fixed

    rng = np.random.RandomState(rows + n)
    data = (rng.standard_normal((rows, width))
            * 10.0 ** rng.uniform(-4, 4, (rows, 1))).astype(np.float32)
    ids = rng.randint(-2, n + 2, rows)
    ref = np.zeros((n, width), np.float32)
    for row, i in zip(data, ids):
        if 0 <= i < n:
            ref[i] = ref[i] + row
    got = segment_sum_fixed(torch.tensor(data), torch.tensor(ids), n)
    np.testing.assert_array_equal(got.numpy(), ref)
    plan = segment_plan(torch.tensor(ids), n)
    shaped = segment_sum_fixed(torch.tensor(data).reshape(rows, width, 1), None, n, plan)
    np.testing.assert_array_equal(shaped.numpy()[..., 0], ref)


def test_global_ba_matches_reference():
    """slam_map.global_ba on a map holding the planted problem: keyframe 0 is
    the gauge, every valid landmark moves, the anchor-frame positions are
    refreshed; poses within 1e-4, points within 1e-4 (as bundle_adjust)."""
    from fitslam_tpu.models import slam_map as jsm
    from fitslam_tpu_torch.models import slam_map as tsm

    prob = _ba_problem(3)
    n_kf, n_lm = prob.T_cw.t.shape[0], prob.points.shape[0]
    K_cap, L_cap, O = n_kf + 2, n_lm + 5, prob.obs.kf.shape[0]
    m = jsm.empty_map(K_cap, L_cap, O, signature_dim=8)
    m = m._replace(
        kf_T_cw=jlie.SE3(m.kf_T_cw.R.at[:n_kf].set(prob.T_cw.R),
                         m.kf_T_cw.t.at[:n_kf].set(prob.T_cw.t)),
        kf_valid=jnp.arange(K_cap) < n_kf, n_kf=jnp.int32(n_kf),
        lm_pos=m.lm_pos.at[:n_lm].set(prob.points),
        lm_valid=jnp.arange(L_cap) < n_lm,
        lm_anchor_kf=jnp.asarray(np.random.RandomState(0).randint(0, n_kf, L_cap), jnp.int32),
        obs_kf=jnp.asarray(prob.obs.kf), obs_lm=jnp.asarray(prob.obs.lm),
        obs_uvr=jnp.asarray(prob.obs.uvr), obs_sigma2=jnp.asarray(prob.obs.sigma2),
        obs_valid=jnp.asarray(prob.obs.valid))
    K = _K()
    ref, st_ref = jax.tree.map(np.asarray, jsm.global_ba(m, K, iters=4))
    got, st = tsm.global_ba(interop.to_torch(jax.tree.map(np.asarray, m)), interop.to_torch(K),
                            iters=4)
    got = interop.to_numpy(got)
    np.testing.assert_allclose(got.kf_T_cw.R, ref.kf_T_cw.R, atol=1e-4)
    np.testing.assert_allclose(got.kf_T_cw.t, ref.kf_T_cw.t, atol=1e-4)
    np.testing.assert_allclose(got.lm_pos, ref.lm_pos, atol=1e-4)
    np.testing.assert_allclose(got.lm_pos_anchor, ref.lm_pos_anchor, atol=1e-4)
    np.testing.assert_allclose(st.chi2.numpy(), st_ref.chi2, rtol=1e-3)
    np.testing.assert_array_equal(got.kf_T_cw.t[0], np.asarray(m.kf_T_cw.t[0]))
    assert st_ref.chi2[-1] < st_ref.chi2[0]
