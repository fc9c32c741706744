"""Parity of the port's frontend | backend stage pipeline
(``parallel/dist_stages.stage_pipelined_slam``) over two gloo ranks on the
CPU with the reference's on a 2-device ``stage`` mesh of the conftest's
virtual CPU devices, and with the port's sequential path.

The case is ``tests/test_stage_pipeline.py``'s: 320x240, 256 features, 2
levels, 6 frames of the corridor world of seed 0 (rendered by the
reference) after a bootstrap keyframe.

Tolerances: poses within 1e-4 of the reference's pipeline and of the port's
sequential path (the reference test's own bound); the keyframe pattern, the
keyframe count and the inlier counts exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitslam_tpu.data import synthetic as jsyn
from fitslam_tpu.models import slam_map as jsm
from fitslam_tpu.models import tracking as jtr
from fitslam_tpu.ops import lie as jlie
from fitslam_tpu.ops.geometry import Intrinsics as JIntrinsics
from fitslam_tpu.parallel import dist_stages as jds
from fitslam_tpu.parallel import mesh as jmesh
from fitslam_tpu.utils.config import FitSlamConfig as JConfig
from fitslam_tpu_torch.models import tracking as ttr
from fitslam_tpu_torch.models.slam_step import _backend_body
from fitslam_tpu_torch.utils import interop
from tests.test_stage_pipeline import BACKEND_KW, NF, NL, T_FRAMES, H, W
from tests.test_torch_parallel_mesh import in_background, launch, rank_pipeline

torch.set_num_threads(2)

ORB_KW = dict(num_features=NF, num_levels=NL, scale_factor=1.4142135, fast_threshold=12.0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return interop.to_torch(_np(tree))


@pytest.fixture(scope="module")
def stream():
    """tests/test_stage_pipeline.py's setup: the bootstrap map and state and
    frames 1..T; the port's pipeline on two ranks, started in the background,
    and the reference's pipeline over them."""
    cfg = JConfig()
    cfg = dataclasses.replace(cfg, camera=dataclasses.replace(
        cfg.camera, width=W, height=H, fx=0.625 * W, fy=0.625 * W, cx=W / 2, cy=H / 2,
        baseline=0.2))
    K = JIntrinsics.from_config(cfg.camera)
    world = jsyn.corridor_world(jax.random.PRNGKey(0), num=2000, length=20.0, width=5.0)
    T_gt = jsyn.straight_trajectory(T_FRAMES + 1, length=(T_FRAMES + 1) * 0.15, height=1.2,
                                    start_x=0.5)
    imgs = [jnp.stack(jsyn.render_stereo(K, world, jlie.SE3(T_gt.R[i], T_gt.t[i]), width=W,
                                         height=H)) for i in range(T_FRAMES + 1)]
    frame0 = jtr.process_stereo(K, imgs[0][0], imgs[0][1], **ORB_KW)
    m = jsm.empty_map(8, 2048, 4096)
    m = jsm.insert_keyframe(m, K, jlie.SE3.identity(), frame0.feats, frame0.depth,
                            -jnp.ones((NF,), jnp.int32), jnp.int32(0), jnp.zeros((256,)))
    st = jtr.mark_keyframe(jtr.init_track_state(), jnp.int32(0))
    frames = jnp.stack(imgs[1:])
    port_in = (_port(K), _port(m), _port(st), torch.tensor(np.asarray(frames)))
    ranks = in_background(launch, rank_pipeline, 2, *port_in, ORB_KW, BACKEND_KW)
    # jitted: half the time of the eager call, the same outputs
    pipeline = jax.jit(functools.partial(jds.stage_pipelined_slam,
                                         jmesh.make_mesh(2, axis_names=("stage",)), **ORB_KW,
                                         backend_kwargs=BACKEND_KW))
    ref = _np(pipeline(K, m, st, frames))
    return port_in, ref, ranks


@pytest.fixture(scope="module")
def pipeline_ranks(stream):
    return stream[2].result()


def test_pipeline_matches_reference(stream, pipeline_ranks):
    _, (m_ref, st_ref, outs_ref), _ = stream
    for res in pipeline_ranks:
        m_out, st_out, outs = res["out"]
        assert outs.pose_wc.shape == (T_FRAMES, 4, 4)
        np.testing.assert_allclose(outs.pose_wc.numpy(), outs_ref.pose_wc, atol=1e-4)
        assert outs.was_keyframe.tolist() == outs_ref.was_keyframe.tolist()
        np.testing.assert_array_equal(outs.n_inliers.numpy(), outs_ref.n_inliers)
        assert int(m_out.n_kf) == int(m_ref.n_kf)
        np.testing.assert_allclose(st_out.T_cw.t.numpy(), st_ref.T_cw.t, atol=1e-4)
    # both ranks return the backend's results; the handoff is one broadcast
    # a frame and the results one more
    a, b = (mesh_leaves(r["out"]) for r in pipeline_ranks)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert [r["broadcasts"] for r in pipeline_ranks] == [T_FRAMES + 1] * 2
    # the reference test's sanity: the poses follow the forward motion
    z = pipeline_ranks[0]["out"][2].pose_wc[:, 2, 3].numpy()
    assert z[-1] > z[0] + 0.45
    assert (pipeline_ranks[0]["out"][2].n_inliers >= 10).all()


def mesh_leaves(tree):
    from fitslam_tpu_torch.parallel.mesh import leaves

    return leaves(tree)


def test_pipeline_matches_sequential_port(stream, pipeline_ranks):
    """The port's sequential path on one rank (process_stereo, then the
    backend, frame after frame) gives what the pipeline gives."""
    (K, m, st, frames), _, _ = stream
    poses, kfs, inl = [], [], []
    initialized = bool(st.initialized)
    for t in range(frames.shape[0]):
        f = ttr.process_stereo(K, frames[t, 0], frames[t, 1], **ORB_KW)
        m, st, o, inserted, _ = _backend_body(K, m, st, f, t, initialized=initialized,
                                              **BACKEND_KW)
        initialized = initialized or inserted
        poses.append(o.pose_wc)
        kfs.append(bool(o.was_keyframe))
        inl.append(int(o.n_inliers))
    _, st_p, outs = pipeline_ranks[1]["out"]
    np.testing.assert_allclose(outs.pose_wc.numpy(), torch.stack(poses).numpy(), atol=1e-4)
    assert outs.was_keyframe.tolist() == kfs
    assert outs.n_inliers.tolist() == inl
    np.testing.assert_allclose(st_p.T_cw.t.numpy(), st.T_cw.t.numpy(), atol=1e-4)
