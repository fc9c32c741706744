"""The loop-closing slice as a whole on the CPU: a small ring run through
both packages' ``StereoSlam`` with loop closing on, and the data the slice
reads (the committed ring worlds, the port's vocabulary, the ring
trajectory, the ATE with scale and the RPE).

The ring is ``bench_suite.py::bench_loop_slam(small=True)``'s configuration
(320x240, 2 levels, 384 features, loop gap 15 keyframes, score 0.22, two
consistent keyframes, 40 inliers; the asynchronous path with a pipelined
poll every 4 frames) on the committed world of seed 1, 100 frames and the
4-frame re-entry overlap: the fewest frames at which the reference closes a
loop (one, 52 keyframes). Its map capacity is cut from 128 keyframes /
20480 landmarks / 65536 observations to 64 / 4096 / 16384: at full capacity
each package's CPU run takes minutes (the dense global BA couples every
keyframe with every landmark slot). Each package renders the frames from
the same ground-truth poses (its own renderer; the two agree to 1e-3 grey
levels). Bounds: both close a loop between the same keyframes within
``consistency_radius_kf`` (5); their loop counts are equal; the uncorrected
and the corrected ATE agree within 0.02 m (a 100-frame run of float32
Gauss-Newton in two frameworks, ROADMAP F5), and the correction lowers the
port's ATE.
"""

import dataclasses
import hashlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitslam_tpu.data import synthetic as jsyn
from fitslam_tpu.models.slam import StereoSlam as JSlam
from fitslam_tpu.ops import lie as jlie
from fitslam_tpu.ops.geometry import Intrinsics as JIntrinsics
from fitslam_tpu.utils import evaluation as jev
from fitslam_tpu.utils.config import FitSlamConfig as JConfig
from fitslam_tpu_torch.data import synthetic as tsyn
from fitslam_tpu_torch.models.slam import StereoSlam
from fitslam_tpu_torch.ops import lie as tlie
from fitslam_tpu_torch.ops.geometry import Intrinsics
from fitslam_tpu_torch.utils import evaluation as tev
from fitslam_tpu_torch.utils.config import FitSlamConfig

# several pytest-xdist workers share the machine
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
N_FRAMES = 100
POLL = 4
ATE_TOL_M = 0.02


def _config(cls):
    W, H = 320, 240
    cfg = cls()
    R = dataclasses.replace
    return R(cfg,
             camera=R(cfg.camera, width=W, height=H, fx=0.625 * W, fy=0.625 * W, cx=W / 2,
                      cy=H / 2, baseline=0.2),
             orb=R(cfg.orb, num_features=384, num_levels=2, fast_threshold=12.0),
             tracking=R(cfg.tracking, min_inliers=10, keyframe_min_interval=2,
                        keyframe_translation=0.3, keyframe_rotation=0.15),
             mapping=R(cfg.mapping, max_keyframes=64, max_landmarks=4096,
                       max_observations=16384, local_window=4, ba_iters=3,
                       close_depth_factor=35.0),
             loop=R(cfg.loop, enabled=True, min_gap_keyframes=15, min_score=0.22,
                    consistency_threshold=2, min_matches=40))


def _ring_poses():
    T = jsyn.loop_trajectory(N_FRAMES, radius=8.0)
    ov = max(4, N_FRAMES // 25)
    return jlie.SE3(jnp.concatenate([T.R, T.R[:ov]]), jnp.concatenate([T.t, T.t[:ov]]))


def _run(slam, frames):
    """bench_loop_slam's run: the asynchronous step, a pipelined poll every
    POLL frames, a flushing poll and finalize at the end."""
    for i, (l, r) in enumerate(frames):
        slam.process_frame_async(l, r)
        if i % POLL == 0 and i > 0:
            slam.poll_keyframe_events(flush=False)
    slam.poll_keyframe_events()
    slam.finalize()
    return slam


@pytest.fixture(scope="module")
def rings():
    T = _ring_poses()
    gt = [np.asarray(jlie.SE3(T.R[i], T.t[i]).matrix()) for i in range(T.t.shape[0])]
    world = np.load(ROOT / "tests" / "data" / "ring_worlds.npz")["seed_1"]
    cfg = _config(JConfig)
    Kj = JIntrinsics.from_config(cfg.camera)
    frames = [jsyn.render_stereo(Kj, jsyn.World(jnp.asarray(world)), jlie.SE3(T.R[i], T.t[i]),
                                 width=320, height=240, max_depth=14.0)
              for i in range(T.t.shape[0])]
    ref = _run(JSlam(cfg), frames)
    cfg_t = _config(FitSlamConfig)
    Kt = Intrinsics.from_config(cfg_t.camera, "cpu")
    R, t = torch.tensor(np.asarray(T.R)), torch.tensor(np.asarray(T.t))
    frames_t = [tsyn.render_stereo(Kt, torch.tensor(world), tlie.SE3(R[i], t[i]), width=320,
                                   height=240, max_depth=14.0) for i in range(R.shape[0])]
    port = _run(StereoSlam(cfg_t, "cpu"), frames_t)
    return ref, port, gt


def test_ring_closes_the_same_loop(rings):
    ref, port, _ = rings
    assert len(ref.loop_events) >= 1 and len(port.loop_events) == len(ref.loop_events)
    radius = port.cfg.loop.consistency_radius_kf
    for a, b in zip(ref.loop_events, port.loop_events):
        assert abs(a["loop_from"] - b["loop_from"]) <= radius
        assert abs(a["loop_to"] - b["loop_to"]) <= radius
        assert b["inliers"] >= port.cfg.loop.min_matches
        # finalize() turned the device scalars into numbers
        assert isinstance(b["pgo_chi2"], float) and np.isfinite(b["pgo_chi2"])
    assert abs(int(port.map.n_kf) - int(ref.map.n_kf)) <= 3


def test_ring_corrected_ate_matches_reference(rings):
    ref, port, gt = rings
    ate = [(jev.ate_rmse(s.trajectory, gt), jev.ate_rmse(s.corrected_trajectory(), gt))
           for s in (ref, port)]
    (ref_raw, ref_corr), (raw, corr) = ate
    assert abs(raw - ref_raw) < ATE_TOL_M, ate
    assert abs(corr - ref_corr) < ATE_TOL_M, ate
    assert corr < raw, ate
    # the port's evaluation helpers agree with the reference's on these runs
    est = port.corrected_trajectory()
    for kw in ({}, {"with_scale": True}):
        np.testing.assert_allclose(tev.ate_rmse(est, gt, **kw), jev.ate_rmse(est, gt, **kw),
                                   rtol=1e-12)
    np.testing.assert_allclose(tev.rpe_rmse(est, gt, delta=3), jev.rpe_rmse(est, gt, delta=3),
                               rtol=1e-12)


def test_ring_worlds_file_regenerates():
    """tests/data/ring_worlds.npz holds the reference's ring worlds of seeds
    1-3 exactly, as bench_loop_slam draws them."""
    committed = np.load(ROOT / "tests" / "data" / "ring_worlds.npz")
    for seed in (1, 2, 3):
        world = jsyn.ring_world(jax.random.PRNGKey(seed), num=5000, radius=8.0, width=5.0)
        np.testing.assert_array_equal(committed[f"seed_{seed}"], np.asarray(world.landmarks))
        np.testing.assert_array_equal(tsyn.load_ring_world(seed, device="cpu").numpy(),
                                      committed[f"seed_{seed}"])


def test_port_vocabulary_is_the_reference_file():
    ours = ROOT / "fitslam_tpu_torch" / "data" / "vocab_kmeans_256.npz"
    theirs = ROOT / "fitslam_tpu" / "data" / "vocab_kmeans_256.npz"
    assert hashlib.sha256(ours.read_bytes()).digest() == hashlib.sha256(theirs.read_bytes()).digest()
    from fitslam_tpu_torch.ops import place

    assert place.VOCAB_FILE == ours


@pytest.mark.parametrize("n", [1, 2, 100, 156])
def test_loop_trajectory_matches_reference(n):
    """The angles are bit-equal; sines and cosines within an ulp."""
    Tj = jsyn.loop_trajectory(n, radius=8.0)
    Tt = tsyn.loop_trajectory(n, radius=8.0, device="cpu")
    np.testing.assert_allclose(Tt.t.numpy(), np.asarray(Tj.t), rtol=0, atol=1e-6)
    np.testing.assert_allclose(Tt.R.numpy(), np.asarray(Tj.R), rtol=0, atol=1e-7)
