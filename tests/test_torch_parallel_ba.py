"""Parity of the port's sharded bundle adjustment (``parallel/dist_ba.py``,
``slam_map.global_ba_dist``) with the reference's on the conftest's 8-device
virtual CPU mesh, with the same number of ranks as devices: 2 and 4, and 8
for the observation-sharded solver (as ``tests/test_dist_ba.py`` runs it).
One launch of 8 ranks serves every n: each mesh is the first n of them.

The inputs are the reference tests' own: ``tests/test_ba.py::_make_problem``
(4 keyframes, 128 landmarks, 1024 observations) and
``tests/test_slam_map.py::_multiview_map``, handed to the port through
``utils.interop``. The port's ranks are gloo processes on the CPU.

Tolerances: ``shard_problem_by_landmark`` exactly. The solvers' poses and
points within 1e-4 of the reference's at the same n and of the port's
single-rank solvers, and the chi2 histories within 1e-4 relative (the
reference's own sharded-versus-single tests allow 5e-3 and 2e-2; float32
sums split over the ranks in another order than XLA's agree far closer).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from fitslam_tpu.models import slam_map as jsm
from fitslam_tpu.parallel import dist_ba as jdist
from fitslam_tpu.parallel import mesh as jmesh
from fitslam_tpu_torch.models import slam_map as tsm
from fitslam_tpu_torch.ops import ba as tba
from fitslam_tpu_torch.ops import lie as tlie
from fitslam_tpu_torch.parallel import dist_ba as tdist
from fitslam_tpu_torch.utils import interop
from tests.test_ba import K as K_BA
from tests.test_ba import _make_problem
from tests.test_slam_map import K as K_MAP
from tests.test_slam_map import _multiview_map
from tests.test_torch_parallel_mesh import in_background, launch, rank_ba

ATOL = 1e-4
CHI2_RTOL = 1e-4
ITERS = 6
SIZES = (8, 4, 2)

torch.set_num_threads(2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return interop.to_torch(_np(tree))


@pytest.fixture(scope="module")
def problem():
    # jitted: eagerly it compiles op by op (~6 s); the values agree to 5e-7
    make = jax.jit(_make_problem, static_argnames=("n_kf", "n_lm", "n_obs"))
    prob, T_gt, _ = make(jax.random.PRNGKey(7), n_kf=4, n_lm=128, n_obs=1024)
    _problem_gt["T"] = T_gt
    return prob


@pytest.fixture(scope="module")
def multiview():
    m, _, _ = _multiview_map(jax.random.PRNGKey(7))
    return m


_problem_gt = {}


def _launch_all(problem, multiview):
    """The port's solvers for every n in one launch of 8 ranks, each mesh
    the first n of them; {n: rank 0's results}, every rank of a mesh
    checked equal to rank 0."""
    res = launch(rank_ba, max(SIZES), SIZES, _port(K_BA), _port(problem), _port(K_MAP),
                 _port(multiview), ITERS)
    out = {}
    for size in SIZES:
        for r in res[1:size]:
            for a, b in zip(_leaves(r[size]), _leaves(res[0][size])):
                assert torch.equal(a, b)
        out[size] = res[0][size]
    return out


@pytest.fixture(scope="module")
def runs(problem, multiview):
    """The ranks run in the background while the tests compute the
    reference's side; ``runs.result()[n]`` waits for them."""
    return in_background(_launch_all, problem, multiview)


def _jit_ref(fn, n, **kw):
    """The reference's sharded function on n devices, jitted: its shard_map
    run eagerly compiles op by op."""
    return jax.jit(functools.partial(fn, jmesh.make_mesh(n), **kw))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_problem_by_landmark_bit_equal(problem, runs, n):
    ref = _np(jdist.shard_problem_by_landmark(problem, n).obs)
    got = interop.to_numpy(tdist.shard_problem_by_landmark(_port(problem), n).obs)
    for name in ref._fields:
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert int(got.valid.sum()) == int(np.asarray(problem.obs.valid).sum())


@pytest.mark.parametrize("n", [2, 4, 8])
def test_observation_sharded_matches_reference(problem, runs, n):
    """The observation-sharded solver on n ranks against the reference's on
    n devices and the port's single-rank solver."""
    ref, chis_ref = _np(_jit_ref(jdist.distributed_bundle_adjust, n, iters=ITERS)(K_BA,
                                                                                  problem))
    T, pts, chis = runs.result()[n]["obs"]
    np.testing.assert_allclose(T.t.numpy(), ref.T_cw.t, atol=ATOL)
    np.testing.assert_allclose(T.R.numpy(), ref.T_cw.R, atol=ATOL)
    np.testing.assert_allclose(pts.numpy(), ref.points, atol=ATOL)
    np.testing.assert_allclose(chis.numpy(), chis_ref, rtol=CHI2_RTOL)
    # and the port's own single-rank solver: its history is the chi2 after
    # each step, the sharded one's the chi2 before it
    single, stats = tba.bundle_adjust(_port(K_BA), _port(problem), iters=ITERS, damping=1e-3)
    np.testing.assert_allclose(T.t.numpy(), single.T_cw.t.numpy(), atol=ATOL)
    np.testing.assert_allclose(pts.numpy(), single.points.numpy(), atol=ATOL)
    np.testing.assert_allclose(chis.numpy()[1:], stats.chi2.numpy()[:-1], rtol=CHI2_RTOL)
    # tests/test_dist_ba.py's bound on the poses' error to the truth
    T_gt = _port(_problem_gt["T"])
    err = torch.linalg.norm(tlie.se3_log(tlie.compose(T, tlie.inverse(T_gt))), dim=-1)
    assert float(err[1:].max()) < 0.03


@pytest.mark.parametrize("n", [2, 4])
def test_landmark_sharded_matches_reference(problem, runs, n):
    packed = jdist.shard_problem_by_landmark(problem, n)
    ref, chis_ref = _np(_jit_ref(jdist.landmark_sharded_bundle_adjust, n, iters=ITERS)(
        K_BA, packed))
    T, pts, chis = runs.result()[n]["lm"]
    np.testing.assert_allclose(T.t.numpy(), ref.T_cw.t, atol=ATOL)
    np.testing.assert_allclose(pts.numpy(), ref.points, atol=ATOL)
    np.testing.assert_allclose(chis.numpy(), chis_ref, rtol=CHI2_RTOL)
    single, stats = tba.bundle_adjust(_port(K_BA), _port(packed), iters=ITERS, damping=1e-3)
    np.testing.assert_allclose(T.t.numpy(), single.T_cw.t.numpy(), atol=ATOL)
    np.testing.assert_allclose(pts.numpy(), single.points.numpy(), atol=ATOL)
    np.testing.assert_allclose(chis.numpy()[1:], stats.chi2.numpy()[:-1], rtol=CHI2_RTOL)


@pytest.mark.parametrize("n", [2, 4])
def test_global_ba_dist_matches_reference(multiview, runs, n):
    """The live loop-closing GBA path: the corrected map on every rank equals
    the reference's global_ba_dist at the same n and the port's global_ba."""
    ref, chis_ref = _np(jsm.global_ba_dist(multiview, K_MAP, jmesh.make_mesh(n), iters=ITERS))
    m_d, chis = runs.result()[n]["gba"]
    got = interop.to_numpy(m_d)
    val = np.asarray(multiview.lm_valid)
    np.testing.assert_allclose(got.kf_T_cw.t, ref.kf_T_cw.t, atol=ATOL)
    np.testing.assert_allclose(got.kf_T_cw.R, ref.kf_T_cw.R, atol=ATOL)
    np.testing.assert_allclose(got.lm_pos[val], ref.lm_pos[val], atol=ATOL)
    np.testing.assert_allclose(got.lm_pos_anchor[val], ref.lm_pos_anchor[val], atol=ATOL)
    np.testing.assert_array_equal(got.lm_pos[~val], np.asarray(multiview.lm_pos)[~val])
    np.testing.assert_allclose(chis.numpy(), chis_ref, rtol=CHI2_RTOL)
    single, _ = tsm.global_ba(_port(multiview), _port(K_MAP), iters=ITERS)
    np.testing.assert_allclose(got.kf_T_cw.t, single.kf_T_cw.t.numpy(), atol=ATOL)
    np.testing.assert_allclose(got.lm_pos[val], single.lm_pos.numpy()[val], atol=ATOL)


def test_reductions_per_iteration(runs):
    """Exactly the reference's reductions: observation-sharded, the block
    tuple and the candidate chi2 (2 an iteration); landmark-sharded, Hpp, bp,
    the chi2, the Schur complement, its b-term and the candidate chi2 (6 an
    iteration), then the points' all-gather."""
    run = runs.result()[2]
    assert run["obs_collectives"] == 2 * ITERS
    assert run["lm_collectives"] == 6 * ITERS + 1
