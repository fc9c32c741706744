"""The port's Fisher-information oracle (``ops/fisher.py``) against the
reference on the CPU, on the same numpy inputs made from a seed.

Tolerances: the closed-form information, pose and path sums within 1e-5
relative (their float32 sums are taken in another order); ``voxel_key``,
the waypoint fractions, the lookup table's axes and every byte of its
``.dat`` file exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitslam_tpu.ops import fisher as jf
from fitslam_tpu_torch.ops import fisher as tf

torch.set_num_threads(2)

RTOL = 1e-5


def _points(seed, n, lo=-6.0, hi=6.0, z=(0.2, 16.0)):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.uniform(lo, hi, (n, 2)), rng.uniform(*z, (n, 1))],
                          axis=-1).astype(np.float32)


def test_bearing_jacobian_and_point_information_equal_reference():
    p = _points(0, 500)
    p[:3] = [[0.0, 0.0, 1e-7], [1e-3, 0.0, 0.0], [0.0, -2.0, 0.5]]   # near the clamp
    np.testing.assert_allclose(tf.bearing_jacobian_local(torch.tensor(p)).numpy(),
                               np.asarray(jf.bearing_jacobian_local(jnp.asarray(p))),
                               rtol=RTOL, atol=1e-6)
    for var in (0.01, 0.3):
        np.testing.assert_allclose(tf.point_information_local(torch.tensor(p), var).numpy(),
                                   np.asarray(jf.point_information_local(jnp.asarray(p), var)),
                                   rtol=RTOL)


@pytest.mark.parametrize("scale", [1.0, 40.0, 3000.0])
def test_voxel_key_equals_reference_with_int32_wrap(scale):
    rng = np.random.RandomState(1)
    p = (rng.uniform(-1, 1, (4000, 3)) * scale).astype(np.float32)
    p[:200] *= 3.0 / np.linalg.norm(p[:200], axis=-1, keepdims=True)     # near tier
    got = tf.voxel_key(torch.tensor(p)).numpy()
    ref = np.asarray(jf.voxel_key(jnp.asarray(p)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    if scale > 1.0:
        # the hash products overflowed int32: the wrap is where the keys agree
        q = np.round(p / 0.3).astype(np.int64)
        assert np.abs(q[:, 0] * 73856093).max() > 2 ** 31


def _pose_cases():
    rng = np.random.RandomState(2)
    spread = _points(3, 800)
    # landmarks stacked in a few voxels (rank saturation), near and far
    centres = np.array([[1.0, 0.5, 2.5], [-0.7, 0.2, 3.1], [2.0, -1.0, 9.0]], np.float32)
    clustered = (centres[rng.randint(0, 3, 600)]
                 + rng.normal(scale=0.004, size=(600, 3))).astype(np.float32)
    mixed = np.concatenate([spread[:300], clustered[:300]])
    return {"spread": spread, "clustered": clustered, "mixed": mixed}


@pytest.mark.parametrize("case", ["spread", "clustered", "mixed"])
@pytest.mark.parametrize("max_distance", [14.0, 6.0])
def test_pose_information_equals_reference(case, max_distance):
    p = _pose_cases()[case]
    valid = np.random.RandomState(4).rand(p.shape[0]) < 0.85
    kw = dict(noise_var=0.01, max_distance=max_distance, saturation_exponent=0.8)
    ref = float(jf.pose_information(jnp.asarray(p), jnp.asarray(valid), **kw))
    got = tf.pose_information(torch.tensor(p), torch.tensor(valid), **kw)
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), ref, rtol=RTOL)
    assert bool(tf.is_pose_safe(got, 5.0)) == bool(jf.is_pose_safe(jnp.float32(ref), 5.0))


def test_pose_information_saturates_in_one_voxel():
    rng = np.random.RandomState(10)
    cl = (np.array([1.0, 0.5, 2.5], np.float32)
          + rng.normal(scale=1e-4, size=(32, 3))).astype(np.float32)
    assert len(np.unique(jf.voxel_key(jnp.asarray(cl)))) == 1
    ok = torch.ones(32, dtype=torch.bool)
    one = float(tf.pose_information(torch.tensor(cl[:1]), ok[:1]))
    all_ = float(tf.pose_information(torch.tensor(cl), ok))
    assert one < all_ < 4 * one


def _frontier_problem(seed, n_lm=400, n_f=37):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-10, 10, (n_lm, 2)).astype(np.float32)
    info = rng.uniform(0.5, 40.0, n_lm).astype(np.float32)
    valid = rng.rand(n_lm) < 0.8
    pose = rng.uniform(-6, 6, (n_f, 2)).astype(np.float32)
    tgt = rng.uniform(-9, 9, (n_f, 2)).astype(np.float32)
    return pts, info, valid, pose, tgt


@pytest.mark.parametrize("seed", [5, 6])
def test_frontier_pair_information_equals_reference(seed):
    pts, info, valid, pose, tgt = _frontier_problem(seed)
    kw = dict(fov_half_angle=0.52, max_range=14.0)
    ref = np.asarray(jf.frontier_pair_information(*(jnp.asarray(a) for a in
                                                      (pts, info, valid, pose, tgt)), **kw))
    got = tf.frontier_pair_information(*(torch.tensor(a) for a in
                                         (pts, info, valid, pose, tgt)), **kw).numpy()
    assert (ref > 0).sum() > 5
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("num", [1, 2, 5, 6, 7, 8, 11, 21])
def test_waypoint_fractions_equal_jnp_linspace(num):
    np.testing.assert_array_equal(tf.waypoint_fractions(num).numpy(),
                                  np.asarray(jnp.linspace(0.0, 1.0, num)))


@pytest.mark.parametrize("num_waypoints", [6, 4])
def test_path_information_equals_reference_with_goal_masks(num_waypoints):
    pts, info, valid, goals, _ = _frontier_problem(7, n_f=64)
    robot = np.array([0.3, -0.8], np.float32)
    goal_valid = np.random.RandomState(8).rand(64) < 0.7
    kw = dict(num_waypoints=num_waypoints, fov_half_angle=0.52, max_range=14.0)
    args = (pts, info, valid, robot, goals, goal_valid)
    ref = np.asarray(jf.path_information(*(jnp.asarray(a) for a in args), **kw))
    got = tf.path_information(*(torch.tensor(a) for a in args), **kw).numpy()
    assert (got[~goal_valid] == 0).all() and (ref[goal_valid] > 0).sum() > 10
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-4)


TABLE = dict(x_range=(0.0, 4.2), yz_half=2.1, step=0.3, noise_var=0.01)


def test_lookup_table_equals_reference():
    rv, raxes = jf.generate_lookup_table(**TABLE)
    tv, taxes = tf.generate_lookup_table(**TABLE, device="cpu")
    for a, b in zip(taxes, raxes):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), rtol=RTOL)


def test_lookup_table_files_cross_load(tmp_path):
    """A table written by one package loads in the other: the same bytes."""
    rv, raxes = jf.generate_lookup_table(**TABLE)
    jf.save_lookup_table(str(tmp_path / "ref.dat"), rv, raxes)
    tf.save_lookup_table(str(tmp_path / "port.dat"),
                         torch.tensor(np.asarray(rv)), [torch.tensor(np.asarray(a)) for a in raxes])
    assert (tmp_path / "ref.dat").read_bytes() == (tmp_path / "port.dat").read_bytes()
    tv, taxes = tf.load_lookup_table(str(tmp_path / "ref.dat"), device="cpu")
    jv, jaxes = jf.load_lookup_table(str(tmp_path / "port.dat"))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for a, b in zip(taxes, jaxes):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    (tmp_path / "bad.dat").write_bytes(b"\0" * 64)
    with pytest.raises(ValueError):
        tf.load_lookup_table(str(tmp_path / "bad.dat"), device="cpu")


def test_lookup_information_equals_reference():
    rv, raxes = jf.generate_lookup_table(**TABLE)
    amin = np.array([a[0] for a in raxes], np.float32)
    astep = np.array([a[1] - a[0] for a in raxes], np.float32)
    p = _points(9, 2000, lo=-3.0, hi=3.0, z=(-0.5, 5.0))    # inside and outside the table
    ref = np.asarray(jf.lookup_information(rv, jnp.asarray(amin), jnp.asarray(astep),
                                           jnp.asarray(p)))
    got = tf.lookup_information(torch.tensor(np.asarray(rv)), torch.tensor(amin),
                                torch.tensor(astep), torch.tensor(p)).numpy()
    assert (ref == 0).sum() > 50 and (ref > 0).sum() > 500
    np.testing.assert_array_equal(got, ref)
