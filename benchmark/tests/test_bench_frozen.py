"""The frozen copies equal the port's originals at one seed: the host draws,
the worlds, the camera paths, the rendered frames, the trajectory error and
the kernels' byte and operation counts."""

import numpy as np
import torch

from benchmark.frozen import evaluation, kernel_counts, prng, worlds

SEED = 2**31 + 17


def test_prng_equals_the_port():
    from fitslam_tpu_torch.utils import prng as port

    k = prng.prng_key(SEED)
    assert np.array_equal(k, port.prng_key(SEED))
    for a, b in ((prng.split(k, 3), port.split(k, 3)),
                 (prng.uniform(k, (257,), -2.0, 3.0), port.uniform(k, (257,), -2.0, 3.0)),
                 (prng.normal(k, (257,)), port.normal(k, (257,))),
                 (prng.fold_in(k, 7), port.fold_in(k, 7)),
                 (prng.bernoulli(k, 0.5, (64,)), port.bernoulli(k, 0.5, (64,))),
                 (prng.randint(k, (9,), 0, 1000), port.randint(k, (9,), 0, 1000))):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_worlds_paths_and_frames_equal_the_port():
    from fitslam_tpu_torch.data import synthetic
    from fitslam_tpu_torch.ops import lie
    from fitslam_tpu_torch.ops.geometry import Intrinsics
    from fitslam_tpu_torch.utils import prng as port
    from fitslam_tpu_torch.utils.config import CameraConfig

    corridor = synthetic.corridor_world(port.prng_key(SEED), 3000, 40.0, 5.0, device="cpu")
    assert torch.equal(torch.as_tensor(worlds.corridor_world(SEED, 3000, 40.0, 5.0)),
                       corridor.landmarks)
    T = synthetic.straight_trajectory(20, 3.0, 1.2, 0.5, device="cpu")
    R, t = worlds.straight_trajectory(20, 3.0, 1.2, 0.5, "cpu")
    assert torch.equal(T.R, R) and torch.equal(T.t, t)
    cam = CameraConfig(width=320, height=240, fx=200.0, fy=200.0, cx=160.0, cy=120.0,
                       baseline=0.2)
    K = Intrinsics.from_config(cam, "cpu")
    Kf = worlds.Camera(200.0, 200.0, 160.0, 120.0, 0.2, "cpu")
    for i in (0, 11):
        a = synthetic.render_stereo(K, corridor.landmarks, lie.SE3(R[i], t[i]), 320, 240)
        b = worlds.render_stereo(Kf, corridor.landmarks, R[i], t[i], 320, 240)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_ate_equals_the_port():
    from fitslam_tpu_torch.utils import evaluation as port

    rng = np.random.RandomState(3)
    gt = [np.eye(4) for _ in range(30)]
    est = [np.eye(4) for _ in range(30)]
    for i in range(30):
        gt[i][:3, 3] = [0.15 * i, 0.0, 1.2]
        est[i][:3, 3] = gt[i][:3, 3] + rng.normal(0, 0.01, 3)
    assert evaluation.ate_rmse(est, gt) == port.ate_rmse(est, gt)


def test_kernel_counts_equal_the_port():
    from fitslam_tpu_torch import bench_suite as port

    levels = port.DESCRIBE_LEVELS
    assert kernel_counts.k1_bytes_ops(levels, 1024) == port.describe_bytes_ops(levels, 1024)
    for mode in (0, 1, 2):
        assert kernel_counts.k2_bytes(1024, 20480, mode) == port.k2_bytes(1024, 20480, mode)
    b = port.bound(*port.describe_bytes_ops(levels, 1024), "f32")["bound_ms"]
    assert abs(kernel_counts.k1_bound_s(levels, 1024) * 1e3 - b) < 1e-12
    assert kernel_counts.HBM_BYTES_PER_S == port.HBM_BYTES_PER_S
    assert kernel_counts.PEAK_OPS_PER_S == port.PEAK_OPS_PER_S
