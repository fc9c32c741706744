"""The port's traversability fusion (the fusion half of ``ops/grid.py``)
against the reference on the CPU: the cloud ring buffer, per-cell
statistics (full and incremental), the classified grid, its threshold and
``depth_image_to_cloud``.

Clouds: frustum clouds of the rooms world (walls meeting the floor, as the
active-SLAM loop fuses them) and random clouds, through keyframe poses with
generic rotations.

Tolerances: counts, z_min, z_max and the per-cell sums are exactly equal
(the port adds each cell's points in the reference's order and rounds the
point transform as the reference's compiler does); the grid's float fields
within 1e-6 absolute of the reference's jitted entry (they come out equal),
the cost within 1 and the thresholded occupancy exactly equal. Incremental fusion against a full re-stitch of the same
clouds: counts, z_min and z_max exact, sums within 1e-5 relative (their
order differs by design, in both packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitslam_tpu.data import synthetic as jsyn
from fitslam_tpu.models import sim_robot as jsim
from fitslam_tpu.models.active_slam import camera_pose_from_robot as jcam
from fitslam_tpu.ops import grid as jg
from fitslam_tpu.ops import lie as jl
from fitslam_tpu.ops.geometry import Intrinsics as JK
from fitslam_tpu_torch.ops import grid as tg
from fitslam_tpu_torch.ops import lie as tl
from fitslam_tpu_torch.utils import interop

torch.set_num_threads(2)

SPEC_T = tg.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)
SPEC_J = jg.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)
W, H = 320, 240
P = 4096
# robot poses (x, y, yaw) inside the rooms world's free space
ROBOT_POSES = [(-5.0, -5.0, 0.3), (-3.2, -4.1, 1.1), (-1.5, -5.5, -0.4), (-4.4, -2.0, 2.0),
               (0.5, -3.0, 0.9)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _K():
    return JK(jnp.float32(200.0), jnp.float32(200.0), jnp.float32(W / 2), jnp.float32(H / 2),
              jnp.float32(0.2))


def _kf_poses(seed, n):
    """(n,) keyframe camera-from-world poses: the robot's camera poses with
    a small generic rotation on top (no zero entries in R)."""
    rng = np.random.RandomState(seed)
    Rs, ts = [], []
    for k in range(n):
        T = jcam(*ROBOT_POSES[k % len(ROBOT_POSES)])
        dR = jl.so3_exp(jnp.asarray(rng.normal(scale=0.05, size=3).astype(np.float32)))
        T = jl.SE3(T.R @ dR, T.t)
        Tcw = jl.inverse(T)
        Rs.append(np.asarray(Tcw.R))
        ts.append(np.asarray(Tcw.t))
    return jl.SE3(jnp.asarray(np.stack(Rs)), jnp.asarray(np.stack(ts)))


@pytest.fixture(scope="module")
def clouds():
    """{source: ((n, P, 3) camera-frame points, (n, P) masks)} for the rooms
    world's frustum clouds and for random clouds."""
    occ = jsim.make_rooms_world(SPEC_J, seed=3)
    world = jsyn.world_from_occupancy(occ, SPEC_J, jax.random.PRNGKey(5), wall_height=2.0,
                                      points_per_wall_cell=4, floor_points=4000)
    poses = _kf_poses(0, len(ROBOT_POSES))
    frustum = [jsyn.frustum_cloud(_K(), world, jl.inverse(jl.SE3(poses.R[k], poses.t[k])),
                                  max_points=P, max_depth=8.0, width=W, height=H)
               for k in range(len(ROBOT_POSES))]
    rng = np.random.RandomState(1)
    n = len(ROBOT_POSES)
    rnd = np.concatenate([rng.uniform(-4, 4, (n, P, 2)), rng.uniform(0.3, 8.0, (n, P, 1))],
                         axis=-1).astype(np.float32)
    return {
        "rooms_frustum": (np.stack([np.asarray(p) for p, _ in frustum]),
                          np.stack([np.asarray(v) for _, v in frustum])),
        "random": (rnd, rng.rand(n, P) < 0.9),
    }


def _buffers(pts, valid, n_slots):
    """The same clouds pushed through both ring buffers of ``n_slots``."""
    jb = jg.empty_cloud_buffer(n_slots, P)
    tb = tg.empty_cloud_buffer(n_slots, P, device="cpu")
    for k in range(pts.shape[0]):
        jb = jg.add_cloud(jb, jnp.asarray(pts[k]), jnp.asarray(valid[k]), jnp.int32(k))
        tb = tg.add_cloud(tb, torch.tensor(pts[k]), torch.tensor(valid[k]), k)
    return jb, tb


def test_frustum_clouds_see_walls_and_floor(clouds):
    pts, valid = clouds["rooms_frustum"]
    assert valid.sum(axis=1).min() > 500
    y = pts[..., 1][valid]               # camera y is down: floor is about +0.8 m
    assert (y > 0.7).sum() > 1000 and (y < 0).sum() > 300


@pytest.mark.parametrize("n_slots", [3, 8])
def test_add_cloud_ring_wraps_like_reference(clouds, n_slots):
    pts, valid = clouds["random"]
    jb, tb = _buffers(pts, valid, n_slots)
    got, ref = interop.to_numpy(tb), _np(jb)
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
    assert int(got.n_clouds) == pts.shape[0]


@pytest.mark.parametrize("source", ["rooms_frustum", "random"])
def test_buffer_cell_stats_equal_reference(clouds, source):
    pts, valid = clouds[source]
    jb, tb = _buffers(pts, valid, 8)
    poses = _kf_poses(2, pts.shape[0])
    ref = _np(jg.buffer_cell_stats(SPEC_J, jb, poses))
    got = interop.to_numpy(tg.buffer_cell_stats(SPEC_T, tb, interop.to_torch(_np(poses))))
    assert isinstance(got, tuple) and len(got) == 5
    assert ref[0].sum() > 1000
    for name, a, b in zip(("count", "sum z", "sum z^2", "max z", "min z"), got, ref):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("source", ["rooms_frustum", "random"])
def test_incremental_stats_equal_reference_and_full_restitch(clouds, source):
    pts, valid = clouds[source]
    poses = _kf_poses(3, pts.shape[0])
    tposes = interop.to_torch(_np(poses))
    js = jg.empty_cell_stats(SPEC_J)
    ts = tg.empty_cell_stats(SPEC_T, device="cpu")
    for k in range(pts.shape[0]):
        js = jg.scatter_cloud_stats(SPEC_J, js, jnp.asarray(pts[k]), jnp.asarray(valid[k]),
                                    jl.SE3(poses.R[k], poses.t[k]))
        ts = tg.scatter_cloud_stats(SPEC_T, ts, torch.tensor(pts[k]), torch.tensor(valid[k]),
                                    tl.SE3(tposes.R[k], tposes.t[k]))
    ref, got = _np(js), interop.to_numpy(ts)
    for name, a, b in zip(("count", "sum z", "sum z^2", "max z", "min z"), got, ref):
        np.testing.assert_array_equal(a, b, err_msg=name)
    _, tb = _buffers(pts, valid, 8)
    full = interop.to_numpy(tg.buffer_cell_stats(SPEC_T, tb, tposes))
    for k in (0, 3, 4):
        np.testing.assert_array_equal(got[k], full[k])
    for k in (1, 2):
        np.testing.assert_allclose(got[k], full[k], rtol=1e-5, atol=1e-5)


def _assert_grid_equal(got, ref):
    for name in ("count", "z_min", "z_max"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
    for name in ("elevation", "roughness", "slope"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name), rtol=0, atol=1e-6,
                                   err_msg=name)
    d = np.abs(got.cost.astype(np.int32) - ref.cost.astype(np.int32))
    assert d.max() <= 1, f"cost differs by up to {d.max()}"


@pytest.mark.parametrize("source", ["rooms_frustum", "random"])
def test_stats_to_grid_and_threshold_equal_reference(clouds, source):
    pts, valid = clouds[source]
    jb, tb = _buffers(pts, valid, 8)
    poses = _kf_poses(4, pts.shape[0])
    stats = _np(jg.buffer_cell_stats(SPEC_J, jb, poses))
    kw = dict(max_slope=0.7, ground_clearance=0.17, robot_height=1.5, security_distance=0.6)
    # the reference's jitted entry (its compiler fuses the multiply-adds,
    # which the eager op-by-op path does not)
    ref = jg.grid_from_stats(SPEC_J, stats, **kw)
    got = tg.stats_to_grid(SPEC_T, interop.to_torch(stats), **kw)
    _assert_grid_equal(interop.to_numpy(got), _np(ref))
    assert (np.asarray(ref.cost) == jg.LETHAL).sum() > 10
    # the jitted incremental tail is the same function
    got2 = interop.to_numpy(tg.grid_from_stats(SPEC_T, interop.to_torch(stats), **kw))
    np.testing.assert_array_equal(got2.cost, interop.to_numpy(got).cost)
    for thr in (55, 200):
        np.testing.assert_array_equal(tg.threshold_grid(got, thr).numpy(),
                                      np.asarray(jg.threshold_grid(ref, thr)))


@pytest.mark.parametrize("source", ["rooms_frustum", "random"])
def test_fuse_clouds_equal_reference(clouds, source):
    pts, valid = clouds[source]
    jb, tb = _buffers(pts, valid, 4)      # 5 clouds into 4 slots: the first is overwritten
    poses = _kf_poses(5, pts.shape[0])
    ref = _np(jg.fuse_clouds(SPEC_J, jb, poses))
    got = interop.to_numpy(tg.fuse_clouds(SPEC_T, tb, interop.to_torch(_np(poses))))
    _assert_grid_equal(got, ref)
    np.testing.assert_array_equal(
        tg.threshold_grid(interop.to_torch(got), 55).numpy(),
        np.asarray(jg.threshold_grid(jg.TraversabilityGrid(*ref), 55)))


def test_stats_to_grid_shifts_do_not_wrap():
    """A ramp across the whole map: no phantom slope along the borders."""
    G = SPEC_T.size
    z = np.tile(np.linspace(0.0, 3.0, G, dtype=np.float32), (G, 1)).reshape(-1)
    stats = (np.ones(G * G, np.float32), z, z * z, z, z)
    ref = _np(jg.grid_from_stats(SPEC_J, stats))
    got = interop.to_numpy(tg.stats_to_grid(SPEC_T, interop.to_torch(stats)))
    _assert_grid_equal(got, ref)
    assert got.slope[:, 0].max() < 0.1 and got.slope[:, -1].max() < 0.1


@pytest.mark.parametrize("stride", [4, 3])
def test_depth_image_to_cloud_equals_reference(stride):
    occ = jsim.make_rooms_world(SPEC_J, seed=3)
    world = jsyn.world_from_occupancy(occ, SPEC_J, jax.random.PRNGKey(5), floor_points=4000)
    _, depth = jsyn.render_rgbd(_K(), world, jcam(-5.0, -5.0, 0.3), width=W, height=H,
                                max_depth=12.0)
    depth = np.asarray(depth)
    assert (depth > 0).mean() > 0.05
    rp, rok = jg.depth_image_to_cloud(_K(), jnp.asarray(depth), stride=stride, max_depth=8.0)
    tp, tok = tg.depth_image_to_cloud(interop.to_torch(_np(_K())), torch.tensor(depth),
                                      stride=stride, max_depth=8.0)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(rok))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))
