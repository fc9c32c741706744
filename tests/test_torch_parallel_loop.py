"""The mesh hooks of the loop closer (``LoopCloser.mesh``) and of
``StereoSlam.refine_map`` over two gloo ranks on the CPU, beside the
reference's with a 2-device mesh of the conftest's virtual CPU devices: both
take the sharded branch, ``slam_map.global_ba_dist``.

The loop closer runs ``tests/test_loop_closing.py``'s drifted revisit
(``tests/test_torch_loop_closing.py::revisit``) with GBA on; ``refine_map``
runs two cycles of 4 GBA iterations on ``tests/test_slam_map.py::_multiview_map``.

Tolerances: the loop closer's inliers exactly and its corrected poses within
1e-3 (PGO and GBA in float32 summed in another order, as
``tests/test_torch_loop_closing.py`` holds the single-device closer, ROADMAP
F5); the refined map's poses and points within 1e-4 of the reference's, its
chi2 within 1e-3 relative or 1e-5 absolute (the converged chi2, ~0.008, is
float32 round-off of residuals near zero).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitslam_tpu.models import loop_closing as jlc
from fitslam_tpu.models import tracking as jtr
from fitslam_tpu.models.slam import StereoSlam as JSlam
from fitslam_tpu.parallel import mesh as jmesh
from fitslam_tpu.utils.config import FitSlamConfig as JConfig
from fitslam_tpu_torch.utils import interop
from fitslam_tpu_torch.utils.config import FitSlamConfig
from tests.test_slam_map import K as K_MAP
from tests.test_slam_map import _multiview_map
from tests.test_torch_loop_closing import KJ, _loop_cfg, revisit  # noqa: F401 (a fixture)
from tests.test_torch_parallel_mesh import in_background, launch, rank_loop

torch.set_num_threads(2)

REFINE_KW = dict(cycles=2, gba_iters=4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return interop.to_torch(_np(tree))


@pytest.fixture(scope="module")
def loop_runs(revisit):  # noqa: F811 (the imported fixture)
    r = revisit
    m_mv, _, _ = _multiview_map(jax.random.PRNGKey(7))
    cfg = _loop_cfg(FitSlamConfig, run_global_ba=True)
    # the ranks run in the background while the reference runs here
    ranks = in_background(launch, rank_loop, 2, cfg, _port(KJ), _port(r.m), _port(r.frame9),
                          _port(r.T_est), r.kf9, _port(K_MAP), _port(m_mv), REFINE_KW)
    # the reference with a 2-device mesh: its closer and refine_map run GBA
    # landmark-sharded (global_ba_dist)
    mesh = jmesh.make_mesh(2)
    closer = jlc.LoopCloser(_loop_cfg(JConfig, run_global_ba=True), KJ)
    closer.mesh = mesh
    state = jtr.mark_keyframe(jtr.init_track_state()._replace(T_cw=r.T_est), jnp.int32(0))
    slam = type("Slam", (), {})()
    slam.map, slam.last_frame, slam.state = r.m, r.frame9, state
    info = closer.on_keyframe(slam, r.kf9)
    engine = JSlam(_loop_cfg(JConfig, run_global_ba=True))
    engine.K, engine.map = K_MAP, m_mv
    engine.loop_closer.mesh = mesh
    chi2 = engine.refine_map(**REFINE_KW)
    ref = dict(info=info, map=_np(slam.map), refined=_np(engine.map), chi2=float(chi2), kf=r.kf9)
    return ranks.result(), ref


def test_loop_closer_with_mesh_matches_reference(loop_runs):
    ranks, ref = loop_runs
    for res in ranks:
        assert res["closer_collectives"] > 0          # the sharded GBA ran
        assert res["info"]["loop_to"] == ref["info"]["loop_to"] == 0
        assert res["info"]["inliers"] == ref["info"]["inliers"]
        assert res["info"]["gba_chi2"] is not None
        got = interop.to_numpy(res["map"])
        np.testing.assert_allclose(got.kf_T_cw.t, ref["map"].kf_T_cw.t, atol=1e-3)
        np.testing.assert_allclose(got.kf_T_cw.R, ref["map"].kf_T_cw.R, atol=1e-3)
        np.testing.assert_allclose(float(res["info"]["gba_chi2"]),
                                   float(ref["info"]["gba_chi2"]), rtol=1e-3, atol=1e-3)
        # the tracker follows the revisiting keyframe's corrected pose
        np.testing.assert_allclose(res["state_t"].numpy(), got.kf_T_cw.t[ref["kf"]], atol=1e-6)


def test_refine_map_with_mesh_matches_reference(loop_runs):
    ranks, ref = loop_runs
    val = ref["refined"].lm_valid
    for res in ranks:
        # two cycles of one sharded GBA each, every iteration 6 reductions
        # and one all-gather
        assert res["refine_collectives"] == REFINE_KW["cycles"] * (6 * REFINE_KW["gba_iters"] + 1)
        got = interop.to_numpy(res["refined"])
        np.testing.assert_allclose(got.kf_T_cw.t, ref["refined"].kf_T_cw.t, atol=1e-4)
        np.testing.assert_allclose(got.kf_T_cw.R, ref["refined"].kf_T_cw.R, atol=1e-4)
        np.testing.assert_allclose(got.lm_pos[val], ref["refined"].lm_pos[val], atol=1e-4)
        np.testing.assert_allclose(float(res["refine_chi2"]), ref["chi2"], rtol=1e-3, atol=1e-5)
