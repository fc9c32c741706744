"""Parity of the port's pose-graph optimization (``ops/pgo.py``) with the
reference, and the port's copies of ``tests/test_pgo.py``.

The inputs are made once (with numpy, or with the reference's own functions
as its tests make them) and handed to both packages as numpy arrays.
Tolerances: edge Jacobians 1e-4 (the port differentiates in float64 and
rounds once, the reference in float32); covisibility edges' i / j / valid
exactly (integer counts, the same tie order); relative poses and weights
1e-5; optimized poses 1e-3 (float32 Gauss-Newton with a dense LU solve,
ROADMAP F5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitslam_tpu.ops import lie as jlie
from fitslam_tpu.ops import pgo as jpgo
from fitslam_tpu_torch.ops import lie as tlie
from fitslam_tpu_torch.ops import pgo as tpgo

# several pytest-xdist workers share the machine
torch.set_num_threads(2)


def _t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _se3(T):
    return tlie.SE3(_t(T.R), _t(T.t))


def _edges(e):
    return tpgo.PoseGraphEdges(_t(e.i, torch.int32), _t(e.j, torch.int32), _se3(e.T_ij),
                               _t(e.weight, torch.float32), _t(e.valid, torch.bool))


def _circle_poses(n, radius=5.0):
    s = jnp.linspace(0, 2 * np.pi, n, endpoint=False)
    t = jnp.stack([radius * jnp.cos(s), radius * jnp.sin(s), jnp.zeros_like(s)], -1)
    return jlie.SE3(jlie.yaw_to_rotmat(s), t)


def test_yaw_to_rotmat_matches_reference():
    yaw = np.random.RandomState(0).uniform(-4, 4, (5, 7)).astype(np.float32)
    np.testing.assert_allclose(tlie.yaw_to_rotmat(torch.tensor(yaw)).numpy(),
                               np.asarray(jlie.yaw_to_rotmat(jnp.asarray(yaw))), atol=1e-6)


def test_edge_residual_zero_for_consistent():
    T = _se3(_circle_poses(8))
    Ti, Tj = tlie.SE3(T.R[0], T.t[0]), tlie.SE3(T.R[1], T.t[1])
    r = tpgo.edge_residual(Ti, Tj, tlie.compose(Ti, tlie.inverse(Tj)))
    np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_edge_jacobians_match_reference(seed):
    rng = np.random.RandomState(seed)
    E = 24
    poses = []
    for _ in range(3):
        xi = rng.normal(scale=[1.0, 1.0, 1.0, 0.6, 0.6, 0.6], size=(E, 6)).astype(np.float32)
        poses.append(jax.jit(jlie.se3_exp)(jnp.asarray(xi)))
    poses[2] = jlie.SE3(poses[2].R.at[:4].set(jnp.eye(3)), poses[2].t.at[:4].set(0.0))
    r, Ji, Jj = jax.jit(jax.vmap(jpgo._edge_res_jac))(*poses)
    Ti, Tj, Tij = (_se3(T) for T in poses)
    Ji_t, Jj_t = tpgo.edge_jacobians(Ti, Tj, Tij)
    np.testing.assert_allclose(Ji_t.numpy(), np.asarray(Ji), atol=1e-4)
    np.testing.assert_allclose(Jj_t.numpy(), np.asarray(Jj), atol=1e-4)
    np.testing.assert_allclose(tpgo.edge_residual(Ti, Tj, Tij).numpy(), np.asarray(r), atol=1e-5)


def _drifted_circle(n=16):
    """tests/test_pgo.py's problem: biased odometry and one perfect loop edge."""
    T_gt = _circle_poses(n)
    rel_gt = jlie.compose(jlie.SE3(T_gt.R[:-1], T_gt.t[:-1]),
                          jlie.inverse(jlie.SE3(T_gt.R[1:], T_gt.t[1:])))
    bias = jnp.concatenate([jnp.array([0.02, -0.01, 0.0, 0.0, 0.0, 0.01])[None, :]] * (n - 1))
    rel_noisy = jlie.compose(jlie.se3_exp(bias), rel_gt)
    Rs, ts = [T_gt.R[0]], [T_gt.t[0]]
    for k in range(n - 1):
        T_next = jlie.compose(jlie.inverse(jlie.SE3(rel_noisy.R[k], rel_noisy.t[k])),
                              jlie.SE3(Rs[-1], ts[-1]))
        Rs.append(T_next.R)
        ts.append(T_next.t)
    T_init = jlie.SE3(jnp.stack(Rs), jnp.stack(ts))
    i = jnp.concatenate([jnp.arange(n - 1), jnp.array([0])]).astype(jnp.int32)
    j = jnp.concatenate([jnp.arange(1, n), jnp.array([n - 1])]).astype(jnp.int32)
    T_loop = jlie.compose(jlie.SE3(T_gt.R[0], T_gt.t[0]),
                          jlie.inverse(jlie.SE3(T_gt.R[-1], T_gt.t[-1])))
    T_ij = jlie.SE3(jnp.concatenate([rel_noisy.R, T_loop.R[None]]),
                    jnp.concatenate([rel_noisy.t, T_loop.t[None]]))
    weight = jnp.concatenate([jnp.ones((n - 1,)), jnp.array([10.0])])
    edges = jpgo.PoseGraphEdges(i, j, T_ij, weight, jnp.ones((n,), bool))
    return T_gt, T_init, edges


def test_pose_graph_closes_loop():
    n = 16
    T_gt, T_init, edges = _drifted_circle(n)
    drift0 = float(jnp.linalg.norm(T_init.t[-1] - T_gt.t[-1]))
    assert drift0 > 0.2
    fixed = np.zeros(n, bool)
    fixed[0] = True
    T_opt, chis = tpgo.optimize_pose_graph(_se3(T_init), torch.ones(n, dtype=torch.bool),
                                           _edges(edges), torch.tensor(fixed), iters=20)
    chis = chis.numpy()
    assert chis[-1] < chis[0]
    drift1 = float(np.linalg.norm(T_opt.t[-1].numpy() - np.asarray(T_gt.t[-1])))
    assert drift1 < drift0 * 0.35, (drift0, drift1)
    np.testing.assert_allclose(T_opt.t[0].numpy(), np.asarray(T_gt.t[0]), atol=1e-6)
    # the reference on the same graph
    T_ref, chis_ref = jpgo.optimize_pose_graph(T_init, jnp.ones((n,), bool), edges,
                                               jnp.asarray(fixed), iters=20)
    np.testing.assert_allclose(T_opt.t.numpy(), np.asarray(T_ref.t), atol=1e-3)
    np.testing.assert_allclose(T_opt.R.numpy(), np.asarray(T_ref.R), atol=1e-3)
    np.testing.assert_allclose(chis, np.asarray(chis_ref), rtol=1e-3, atol=1e-6)


def test_invalid_edges_ignored():
    n = 6
    T_gt = _se3(_circle_poses(n))
    odo = tpgo.odometry_edges(T_gt, torch.tensor(n, dtype=torch.int32), n - 1)
    bad = tpgo.PoseGraphEdges(
        i=torch.tensor([0], dtype=torch.int32), j=torch.tensor([3], dtype=torch.int32),
        T_ij=tlie.se3_exp(torch.tensor([[5.0, 5, 5, 1, 1, 1]])),
        weight=torch.tensor([100.0]), valid=torch.tensor([False]))
    fixed = torch.arange(n) == 0
    T_opt, _ = tpgo.optimize_pose_graph(T_gt, torch.ones(n, dtype=torch.bool),
                                        tpgo.concat_edges(odo, bad), fixed, iters=5)
    np.testing.assert_allclose(T_opt.t.numpy(), T_gt.t.numpy(), atol=1e-4)


def test_odometry_edges_consistent():
    Tj_ = _circle_poses(8)
    T = _se3(Tj_)
    edges = tpgo.odometry_edges(T, torch.tensor(8, dtype=torch.int32), 10)
    assert int(edges.valid.sum()) == 7
    r = tpgo.edge_residual(tlie.SE3(T.R[edges.i.long()], T.t[edges.i.long()]),
                           tlie.SE3(T.R[edges.j.long()], T.t[edges.j.long()]), edges.T_ij)
    np.testing.assert_allclose(r[edges.valid].numpy(), 0.0, atol=1e-5)
    ref = jpgo.odometry_edges(Tj_, jnp.int32(8), 10)
    for a, b in ((edges.i, ref.i), (edges.j, ref.j), (edges.valid, ref.valid)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(edges.T_ij.t.numpy(), np.asarray(ref.T_ij.t), atol=1e-5)


@pytest.mark.parametrize("with_tail", [False, True])
def test_covisibility_edges_match_reference(with_tail):
    """Planted co-observations with tied counts; the loop-tail branch takes
    the corrected pose of a tail keyframe far enough from its partner."""
    rng = np.random.RandomState(3)
    K, L, O = 12, 300, 2000
    obs_kf = rng.randint(0, 10, O).astype(np.int32)
    # neighbouring keyframes see overlapping landmark ranges, keyframe 9
    # revisits keyframe 1's
    base = np.where(obs_kf == 9, 25, obs_kf * 25)
    obs_lm = (base + rng.randint(0, 60, O)).clip(0, L - 1).astype(np.int32)
    obs_valid = rng.rand(O) < 0.9
    kf_valid = np.arange(K) < 10
    xi = rng.normal(scale=0.3, size=(K, 6)).astype(np.float32)
    T = jax.jit(jlie.se3_exp)(jnp.asarray(xi))
    T_corr = jax.jit(jlie.se3_exp)(jnp.asarray(xi + 0.05))
    tail = (np.arange(K) > 6) & kf_valid
    kw = dict(n_landmarks=L, max_edges=20, min_shared=5)
    extra = dict(kf_T_cw_corr=T_corr, tail=jnp.asarray(tail), loop_gap=5) if with_tail else {}
    ref = jpgo.covisibility_edges(T, jnp.asarray(kf_valid), jnp.asarray(obs_kf),
                                  jnp.asarray(obs_lm), jnp.asarray(obs_valid), **kw, **extra)
    extra_t = (dict(kf_T_cw_corr=_se3(T_corr), tail=torch.tensor(tail), loop_gap=5)
               if with_tail else {})
    got = tpgo.covisibility_edges(_se3(T), torch.tensor(kf_valid), torch.tensor(obs_kf),
                                  torch.tensor(obs_lm), torch.tensor(obs_valid), **kw, **extra_t)
    for a, b in ((got.i, ref.i), (got.j, ref.j), (got.valid, ref.valid)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got.valid.sum()) > 5
    np.testing.assert_allclose(got.weight.numpy(), np.asarray(ref.weight), rtol=1e-6)
    np.testing.assert_allclose(got.T_ij.R.numpy(), np.asarray(ref.T_ij.R), atol=1e-5)
    np.testing.assert_allclose(got.T_ij.t.numpy(), np.asarray(ref.T_ij.t), atol=1e-5)
