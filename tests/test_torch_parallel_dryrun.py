"""The port's N-rank dry run (``python -m fitslam_tpu_torch.parallel.dryrun``,
``parallel/dryrun.py``) on two gloo ranks on the CPU, beside the reference's
``__graft_entry__.dryrun_multichip(2)`` stage for stage.

The reference's whole dry run takes over a minute to compile on this CPU, so
its stages 1-6 run here through the reference's functions on its own inputs
(drawn as it draws them); its stages 7-9 (the backend step, the stage
pipeline and the live GBA) are held to the reference in
``test_torch_parallel_pipeline.py``, ``test_torch_parallel_loop.py`` and
``test_torch_parallel_ba.py``.

Tolerances: the BA chi2 histories within 1e-4 relative or absolute, PGO's
within 1e-3 relative or 1e-6 absolute near zero (ROADMAP F5); the
descriptors, the known-cell count and the arrival information exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fitslam_tpu.ops import orb as jorb
from fitslam_tpu_torch.parallel import dryrun
from tests.test_torch_parallel_mesh import in_background

torch.set_num_threads(2)


def _reference_dryrun_stages(n):
    """Stages 1-6 of ``__graft_entry__.dryrun_multichip(n)`` through the
    reference's functions, on its own inputs (drawn as it draws them)."""
    from fitslam_tpu.ops import ba as jba
    from fitslam_tpu.ops import grid as jgr
    from fitslam_tpu.ops import lie as jlie
    from fitslam_tpu.ops import pgo as jpgo
    from fitslam_tpu.ops.geometry import Intrinsics
    from fitslam_tpu.parallel import dist_ba as jdist
    from fitslam_tpu.parallel import dist_stages as jds
    from fitslam_tpu.parallel import mesh as jmesh

    mesh = jmesh.make_mesh(n)
    K = Intrinsics(fx=jnp.float32(100.0), fy=jnp.float32(100.0), cx=jnp.float32(64.0),
                   cy=jnp.float32(48.0), baseline=jnp.float32(0.1))
    key = jax.random.PRNGKey(0)
    n_kf, n_lm, n_obs = 4, 64, 64 * n
    pts = jax.random.uniform(key, (n_lm, 3), minval=-3.0, maxval=3.0) + jnp.array([0, 0, 6.0])
    T_cw = jlie.se3_exp(0.05 * jax.random.normal(jax.random.fold_in(key, 1), (n_kf, 6)))
    kf_idx = jax.random.randint(jax.random.fold_in(key, 2), (n_obs,), 0, n_kf)
    lm_idx = jax.random.randint(jax.random.fold_in(key, 3), (n_obs,), 0, n_lm)
    p_c = (T_cw.R[kf_idx] @ pts[lm_idx][..., None])[..., 0] + T_cw.t[kf_idx]
    z = jnp.maximum(p_c[:, 2], 0.5)
    uvr = jnp.stack([K.fx * p_c[:, 0] / z + K.cx, K.fy * p_c[:, 1] / z + K.cy,
                     K.fx * p_c[:, 0] / z + K.cx - K.bf / z], axis=-1)
    obs = jba.Observations(kf=kf_idx.astype(jnp.int32), lm=lm_idx.astype(jnp.int32), uvr=uvr,
                           sigma2=jnp.ones((n_obs,)), valid=jnp.ones((n_obs,), bool))
    prob = jba.BAProblem(
        T_cw=T_cw, obs=obs,
        points=pts + 0.05 * jax.random.normal(jax.random.fold_in(key, 4), pts.shape),
        fixed_kf=jnp.zeros((n_kf,), bool).at[0].set(True), fixed_lm=jnp.zeros((n_lm,), bool))
    # each sharded function jitted: the reference's shard_map run eagerly
    # compiles op by op
    sharded = lambda fn, *a, **kw: jax.jit(functools.partial(fn, mesh, *a, **kw))
    _, chis = sharded(jdist.distributed_bundle_adjust, iters=3)(K, prob)
    _, chis_lm = sharded(jdist.landmark_sharded_bundle_adjust, iters=3)(
        K, jdist.shard_problem_by_landmark(prob, n))
    imgs = jax.random.uniform(jax.random.fold_in(key, 5), (n, 96, 128), minval=0.0,
                              maxval=255.0)
    desc = jax.jit(jax.vmap(lambda im: jorb.extract_orb(im, num_features=64, num_levels=1)))(
        imgs).desc
    spec = jgr.GridSpec2D(size=32, resolution=0.25, origin_x=-4.0, origin_y=-4.0)
    pts_w = jax.random.uniform(jax.random.fold_in(key, 6), (128 * n, 3), minval=-3.0,
                               maxval=3.0)
    grid = sharded(jds.sharded_fuse_clouds, spec)(pts_w, jnp.ones((128 * n,), bool))
    occ = jnp.where(jax.random.bernoulli(jax.random.fold_in(key, 7), 0.1, (32, 32)),
                    jnp.uint8(jgr.LETHAL), jnp.uint8(jgr.FREE))
    fxy = jax.random.uniform(jax.random.fold_in(key, 8), (8 * n, 2), minval=-3.0, maxval=3.0)
    _, arrival = sharded(jds.sharded_arrival_information, spec)(occ, fxy,
                                                                jnp.ones((8 * n,), bool))
    T_gt = jlie.se3_exp(0.3 * jax.random.normal(jax.random.fold_in(key, 9), (8, 6)))
    T0 = jlie.compose(jlie.se3_exp(0.05 * jax.random.normal(jax.random.fold_in(key, 10),
                                                            (8, 6))), T_gt)
    _, chis_pgo = sharded(jds.distributed_pose_graph, iters=4)(
        T0, jnp.ones((8,), bool), jpgo.odometry_edges(T_gt, jnp.int32(8), 2 * n),
        jnp.zeros((8,), bool).at[0].set(True))
    return dict(chis=np.asarray(chis), chis_lm=np.asarray(chis_lm),
                desc=np.asarray(desc.astype(jnp.float32)),
                grid_known=int((grid.cost != jgr.UNKNOWN).sum()), arrival=np.asarray(arrival),
                chis_pgo=np.asarray(chis_pgo))


def test_dryrun_two_ranks_matches_reference(capsys):
    """The nine stages on two ranks pass the reference's asserts; stages 1-6
    agree with the reference's functions on the reference dry run's own
    inputs (its stages 7-9, the backend step, the stage pipeline and the
    live GBA, are held to the reference in test_torch_parallel_pipeline.py,
    test_torch_parallel_loop.py and test_torch_parallel_ba.py)."""
    # the ranks run in the background while the reference runs here
    port = in_background(functools.partial(dryrun.dryrun, device="cpu"), 2)
    ref = _reference_dryrun_stages(2)
    results = port.result()
    assert "[dryrun] mesh=(('data', 2),)" in capsys.readouterr().out
    r = results[0]
    np.testing.assert_allclose(r["chis"], ref["chis"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(r["chis_lm"], ref["chis_lm"], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(r["desc"].numpy(), ref["desc"])
    assert r["grid_known"] == ref["grid_known"]
    np.testing.assert_array_equal(r["arrival"], ref["arrival"])
    np.testing.assert_allclose(r["chis_pgo"], ref["chis_pgo"], rtol=1e-3, atol=1e-6)
    assert r["backend_inliers"] > 0
    assert r["pipe_inliers"] > 0 and results[1]["pipe_inliers"] == r["pipe_inliers"]
