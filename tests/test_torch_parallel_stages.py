"""Parity of the port's frontier-sharded arrival raycast and edge-sharded
pose-graph optimization (``parallel/dist_stages.py``) with the reference's
on the conftest's 8-device virtual CPU mesh, with as many gloo ranks on the
CPU as the reference has devices (2 and 4; one launch of 4 ranks, each mesh
the first n of them).

Inputs are made once with numpy (seed 0) and given to both packages: a 64 x
64 occupancy of free, lethal and unknown cells at 0.25 m with 32 frontiers,
and a 16-keyframe ring with odometry and loop edges (32 edges).

Tolerances: the raycast exactly (independent per frontier); PGO's poses
within 1e-3 and its chi2 history within 1e-3 relative or 1e-6 absolute, as
``tests/test_torch_pgo.py`` holds the single-device solver (ROADMAP F5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitslam_tpu.ops import grid as jg
from fitslam_tpu.ops import lie as jlie
from fitslam_tpu.ops import pgo as jpgo
from fitslam_tpu.parallel import dist_stages as jds
from fitslam_tpu.parallel import mesh as jmesh
from fitslam_tpu_torch.ops import grid as tg
from fitslam_tpu_torch.ops import pgo as tpgo
from fitslam_tpu_torch.ops import raycast as traycast
from fitslam_tpu_torch.utils import interop
from tests.test_torch_parallel_mesh import in_background, launch, rank_stages

torch.set_num_threads(2)

SPEC_J = jg.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)
SPEC_T = tg.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)
N_FR, K_PGO, PGO_ITERS = 32, 16, 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    occ = rng.choice(np.array([jg.FREE, jg.LETHAL, jg.UNKNOWN], np.uint8), (64, 64),
                     p=[0.6, 0.1, 0.3])
    fxy = rng.uniform(-7, 7, (N_FR, 2)).astype(np.float32)
    f_valid = rng.rand(N_FR) > 0.2
    # a ring of keyframes, perturbed; odometry and loop edges from the truth
    s = np.linspace(0, 2 * np.pi, K_PGO, endpoint=False)
    T_gt = jlie.SE3(jlie.yaw_to_rotmat(jnp.asarray(s, jnp.float32)),
                    jnp.asarray(np.stack([5 * np.cos(s), 5 * np.sin(s), 0 * s], -1), jnp.float32))
    T0 = jlie.compose(jlie.se3_exp(jnp.asarray(0.05 * rng.randn(K_PGO, 6), jnp.float32)), T_gt)
    T0 = jlie.SE3(T0.R.at[0].set(T_gt.R[0]), T0.t.at[0].set(T_gt.t[0]))
    odo = jpgo.odometry_edges(T_gt, jnp.int32(K_PGO), K_PGO)
    li = jnp.asarray(rng.randint(0, K_PGO, 16), jnp.int32)
    lj = jnp.asarray((np.asarray(li) + rng.randint(2, K_PGO - 1, 16)) % K_PGO, jnp.int32)
    T_ij = jlie.compose(jlie.SE3(T_gt.R[li], T_gt.t[li]),
                        jlie.inverse(jlie.SE3(T_gt.R[lj], T_gt.t[lj])))
    loops = jpgo.PoseGraphEdges(li, lj, T_ij, jnp.full((16,), 2.0), jnp.asarray(rng.rand(16) > 0.25))
    edges = jax.tree.map(lambda a, b: jnp.concatenate([a, b]), odo, loops)
    kf_valid = jnp.ones((K_PGO,), bool)
    fixed = jnp.arange(K_PGO) == 0
    return dict(occ=occ, fxy=fxy, f_valid=f_valid, T0=_np(T0), edges=_np(edges),
                kf_valid=np.asarray(kf_valid), fixed=np.asarray(fixed))


SIZES = (4, 2)


@pytest.fixture(scope="module")
def runs(inputs):
    """Each rank's results for both n in one launch of 4 ranks, in the
    background; ``runs.result()[n]`` waits for them."""
    d, to = inputs, interop.to_torch

    def go():
        res = launch(rank_stages, max(SIZES), SIZES, SPEC_T, torch.tensor(d["occ"]),
                     torch.tensor(d["fxy"]), torch.tensor(d["f_valid"]), to(d["T0"]),
                     torch.tensor(d["kf_valid"]), to(d["edges"]), torch.tensor(d["fixed"]),
                     PGO_ITERS)
        return {size: [r[size] for r in res[:size]] for size in SIZES}
    return in_background(go)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_arrival_information_exact(inputs, runs, n):
    d = inputs
    # jitted, as the reference's shard_map run eagerly compiles op by op
    ray = jax.jit(functools.partial(jds.sharded_arrival_information, jmesh.make_mesh(n), SPEC_J))
    ref = _np(ray(jnp.asarray(d["occ"]), jnp.asarray(d["fxy"]), jnp.asarray(d["f_valid"])))
    single = traycast.arrival_information(SPEC_T, torch.tensor(d["occ"]), torch.tensor(d["fxy"]),
                                          torch.tensor(d["f_valid"]))
    for res in runs.result()[n]:
        heading, info = res["ray"]
        np.testing.assert_array_equal(heading.numpy(), ref[0])
        np.testing.assert_array_equal(info.numpy(), ref[1])
        assert torch.equal(heading, single[0]) and torch.equal(info, single[1])
    assert float(info.max()) > 0


@pytest.mark.parametrize("n", [2, 4])
def test_distributed_pose_graph_matches_reference(inputs, runs, n):
    d = inputs
    T0, edges = jax.tree.map(jnp.asarray, (d["T0"], d["edges"]))
    pgo = jax.jit(functools.partial(jds.distributed_pose_graph, jmesh.make_mesh(n),
                                    iters=PGO_ITERS))
    T_ref, chis_ref = _np(pgo(T0, jnp.asarray(d["kf_valid"]), edges, jnp.asarray(d["fixed"])))
    to = interop.to_torch
    T_single, chis_single = tpgo.optimize_pose_graph(
        to(d["T0"]), torch.tensor(d["kf_valid"]), to(d["edges"]), torch.tensor(d["fixed"]),
        iters=PGO_ITERS)
    ranks = runs.result()[n]
    T, chis = ranks[0]["pgo"]
    for res in ranks[1:]:
        assert torch.equal(res["pgo"][0].t, T.t) and torch.equal(res["pgo"][1], chis)
    np.testing.assert_allclose(T.R.numpy(), T_ref.R, atol=1e-3)
    np.testing.assert_allclose(T.t.numpy(), T_ref.t, atol=1e-3)
    np.testing.assert_allclose(chis.numpy(), chis_ref, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(T.t.numpy(), T_single.t.numpy(), atol=1e-3)
    np.testing.assert_allclose(chis.numpy(), chis_single.numpy(), rtol=1e-3, atol=1e-6)
    assert float(chis[-1]) < 0.5 * float(chis[0])
    # H and b in one reduction an iteration, the two chi2 in one more
    assert ranks[0]["pgo_collectives"] == 2 * PGO_ITERS
