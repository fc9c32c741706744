"""The simulation's and the tick tail's captured programs (``utils/jit.py``)
on the CPU, where every region runs eagerly through the same static input,
state and output buffers a CUDA graph replays from: the reveal sensor
(``RevealSensor``'s ``reveal``), the simulated camera (``SimCamera``'s
``camera`` / ``camera+rgbd``: images and frustum cloud), the exploration
tick's tail (``ExplorationServer``'s ``publish``, ``los``, ``goal_cell``,
``recovery``, ``evict``, ``wedge`` and ``clear``) and the re-stitch
(``ActiveSlamSystem``'s ``restitch``); and on the card, captured against
eager.

- Capture safety: each region's operations, output shapes and types, as a
  ``TorchDispatchMode`` records them, are the same on two calls of different
  content, with no host read, no operation whose output shape depends on
  the data and no host-to-device upload after its first call.
- Through the buffers: 40 steps of the G = 64 ablation world (explored map,
  plans, goals, published paths), 12 frames of the active loop at 160x120
  (images, clouds, trajectory, grid), a forced recovery, an eviction, a
  wedge mark and its clear, and re-stitches after forced corrections equal
  ``capture=False`` bit for bit.
- Against the reference: ``RevealSensor`` over 40 steps exactly;
  ``SimCamera``'s images within tests/test_torch_slam_e2e.py's and
  tests/test_torch_active_slam.py's bounds (1e-3 grey levels: scatter-adds
  sum in another order; the depth image exactly) and its cloud exactly; the
  published path of the captured server exactly, beside the reference
  server's on the same roadmap, BF row and grid.
- Held views: a pending cloud held across 4 later frames keeps its values;
  a revealed map reaches the next plan.

The card test imports no JAX:

    python3 -m pytest --noconftest -m gpu tests/test_torch_jit_sim.py
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fitslam_tpu_torch import bench_suite
from fitslam_tpu_torch.data import synthetic as tsyn
from fitslam_tpu_torch.models import active_slam as tas
from fitslam_tpu_torch.models import exploration as tex
from fitslam_tpu_torch.models import nav as navx
from fitslam_tpu_torch.models import sim_robot as tsim
from fitslam_tpu_torch.models.active_slam import camera_pose_from_robot
from fitslam_tpu_torch.models.exploration import ExplorationServer
from fitslam_tpu_torch.models.sim_nav import SimNavInterface
from fitslam_tpu_torch.ops import grid as tg
from fitslam_tpu_torch.ops import lie
from fitslam_tpu_torch.ops.geometry import Intrinsics
from fitslam_tpu_torch.utils import jit
from fitslam_tpu_torch.utils.config import FitSlamConfig

# several pytest-xdist workers share the machine
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SPEC = tg.GridSpec2D(**bench_suite.ABLATION_SPEC)
FORBIDDEN = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select", "aten.unique")
UPLOADS = ("aten.lift_fresh",)      # torch.tensor(host data): a host->device copy on the card
REGIONS = ["reveal", "camera", "camera+rgbd", "publish", "los", "goal_cell", "recovery",
           "evict", "wedge", "clear", "restitch"]
NAV_STEPS = 40
ACTIVE_FRAMES = 12
W, H = 160, 120                     # the active loop's frames
CLOUD = 512                         # frustum cloud points a frame
IMAGE_TOL = 1e-3                    # tests/test_torch_slam_e2e.py: grey levels
POSES = [(-5.0, -5.0, 0.3), (-4.6, -4.9, 0.42), (-4.1, -4.6, 0.6), (-3.8, -4.2, 0.9),
         (-3.5, -3.9, 1.1)]


def _leaves(tree):
    return jit.flatten(tree)[0]


def _equal_trees(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# Set-ups
# ---------------------------------------------------------------------------


def _explore(capture, steps=NAV_STEPS, device="cpu"):
    """bench_suite.explore_run's G = 64 ablation loop for ``steps`` steps:
    each step's explored map, each controller window's (robot pose, path,
    plans, status) and every published path."""
    record, published = [], []
    box = {}

    def window(w, step, fn):
        out = fn()
        if w == "ctrl":
            nav = box["nav"]
            path = None if nav._path is None else nav._path.copy()
            record.append((np.array([nav.robot.x, nav.robot.y, nav.robot.yaw]), path,
                           nav.plans, nav.status(), box["sensor"].explored.clone()))
        return out

    real_nav, real_sensor = SimNavInterface.__init__, tsim.RevealSensor.__init__
    real_publish = ExplorationServer._build_published_path

    def nav_init(self, *args, **kwargs):
        real_nav(self, *args, **kwargs)
        box["nav"] = self

    def sensor_init(self, *args, **kwargs):
        real_sensor(self, *args, **kwargs)
        box["sensor"] = self

    def publish(self, goal_xy, occ, robot_xy):
        out = real_publish(self, goal_xy, occ, robot_xy)
        published.append(None if out is None else out.copy())
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(SimNavInterface, "__init__", nav_init)
    mp.setattr(tsim.RevealSensor, "__init__", sensor_init)
    mp.setattr(ExplorationServer, "_build_published_path", publish)
    try:
        run = bench_suite.explore_run(bench_suite.ablation_config(), SPEC,
                                      bench_suite.ABLATION_START, steps, device,
                                      window=window, capture=capture)
    finally:
        mp.undo()
    run.update(record=record, published=published)
    return run


def _tail(server, explored):
    """The tail's rare programs driven on ``server`` at its grid: two
    recovery probes, two goal-cell probes, an eviction of 70 circles through
    the blacklist buffer, two wedge marks and a ClearCostmap disc. Returns
    what each read or wrote."""
    occ = server._overlaid(explored)
    out = {"free": [np.array(server._free_distances(occ, xy, yaw))
                    for xy, yaw in (((-5.0, -5.0), 0.3), ((2.0, 1.5), -2.0))],
           "cell": [server._goal_cell(occ, np.array(g)) for g in ((-4.0, -4.5), (6.0, 6.0))]}
    rng = np.random.RandomState(3)
    server.blacklist_xy += [np.float32([x, y, 0.5]) for x, y in rng.uniform(-7, 7, (70, 2))]
    server._blacklist_buffer()
    out["overlay"] = server.lethal_overlay.clone()
    server._mark_wedge((-3.0, -3.0), 0.7)
    server._mark_wedge((1.0, 2.0), -1.9)
    out["marked"] = server.wedge_age.clone()
    server._clear_disc((-3.5, -3.0))
    out["cleared"] = server.wedge_age.clone()
    return out


def _world(floor_points=2000):
    return bench_suite.rooms_world(SPEC, "cpu", floor_points=floor_points).landmarks


def _K(width=W, height=H, f=100.0):
    cam = dataclasses.replace(FitSlamConfig().camera, width=width, height=height, fx=f, fy=f,
                              cx=width / 2, cy=height / 2, baseline=0.2)
    return Intrinsics.from_config(cam, "cpu")


def _active(capture, landmarks, frames=ACTIVE_FRAMES):
    """bench_suite.active_loop at 160x120 (256 features, 2 levels): every
    frame's images and cloud as the camera rendered them, the system and the
    nav."""
    cfg = bench_suite.active_config(W, H, 256, 2, fx=100.0)
    robot = tsim.DiffDriveRobot(x=-5.0, y=-5.0, yaw=0.3, v_max=0.8, w_max=1.0)
    system, nav = bench_suite.active_system(cfg, SPEC, robot, "cpu", capture=capture)
    frames_seen, box = [], {}
    real = tsyn.SimCamera.frame

    def frame(self, T_wc):
        out = real(self, T_wc)
        frames_seen.append(jit.clone(out))
        box["camera"] = self
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(tsyn.SimCamera, "frame", frame)
    try:
        _, cams = bench_suite.active_loop(system, nav, landmarks, frames)
    finally:
        mp.undo()
    system.finalize()
    return dict(system=system, nav=nav, robot=robot, frames=frames_seen, cams=cams,
                camera=box["camera"])


def _correct(system, k):
    """A forced loop correction: keyframe poses moved by a k-dependent
    shift, then the re-stitch of the next grid read. Returns (statistics,
    grid)."""
    m = system.slam.map
    shift = torch.tensor([0.03 * k, -0.02 * k, 0.01], dtype=torch.float32)
    system.slam.map = m._replace(kf_T_cw=lie.SE3(m.kf_T_cw.R.clone(), m.kf_T_cw.t + shift))
    system._restitch = True
    occ = system.occupancy()
    return jit.clone(system._fstats), occ.clone()


# ---------------------------------------------------------------------------
# (a) capture safety
# ---------------------------------------------------------------------------


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func.overloadpacket._qualified_op_name).replace("::", ".")
        bool_index = func.overloadpacket in (torch.ops.aten.index, torch.ops.aten.index_put,
                                             torch.ops.aten.index_put_) and any(
            isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
            for i in (args[1] if len(args) > 1 and isinstance(args[1], (list, tuple)) else ()))
        outs = [o for o in (out if isinstance(out, (tuple, list)) else (out,))
                if isinstance(o, torch.Tensor)]
        self.ops.append((name, bool_index, tuple((tuple(o.shape), o.dtype) for o in outs)))
        return out


def _fusion_system():
    """An ActiveSlamSystem whose cloud buffer holds three clouds of seeded
    points on three keyframes (no frame tracked): enough for the re-stitch."""
    cfg = bench_suite.active_config(W, H, 256, 2, fx=100.0)
    nav = SimNavInterface(cfg, SPEC, tsim.DiffDriveRobot(), lambda: None, device="cpu")
    system = tas.ActiveSlamSystem(cfg, SPEC, nav, get_robot_pose=lambda: (np.zeros(2), 0.0),
                                  device="cpu")
    system.set_world_anchor(camera_pose_from_robot(-5.0, -5.0, 0.3, device="cpu"))
    rng = np.random.RandomState(4)
    P = cfg.traversability.max_points_per_cloud
    m = system.slam.map
    for k in range(3):
        pts = torch.tensor(rng.uniform([-2, -1, 0.5], [2, 1, 6], (P, 3)), dtype=torch.float32)
        system.clouds = tg.add_cloud(system.clouds, pts, torch.ones(P, dtype=torch.bool),
                                     torch.tensor(k, dtype=torch.int32))
    T = lie.se3_exp(torch.tensor(rng.normal(scale=0.1, size=(m.kf_T_cw.t.shape[0], 6)),
                                 dtype=torch.float32))
    system.slam.map = m._replace(kf_T_cw=T, kf_valid=torch.arange(T.t.shape[0]) < 3,
                                 n_kf=torch.tensor(3, dtype=torch.int32))
    return system


def _record_runs():
    keep = []
    run = _explore(True, steps=24)
    keep.append(_tail(run["server"], run["explored"]))
    _tail(run["server"], run["explored"])
    landmarks = _world()
    for rgbd in (False, True):
        cam = tsyn.SimCamera(_K(), landmarks, W, H, max_depth=12.0, cloud_points=CLOUD,
                             cloud_depth=8.0, rgbd=rgbd)
        for pose in POSES[:2]:
            cam.frame(camera_pose_from_robot(*pose, device="cpu"))
        keep.append(cam)
    system = _fusion_system()
    for k in (1, 2):
        _correct(system, k)
    keep += [run, system]
    return keep


@pytest.fixture(scope="module")
def recorded():
    """{region: {slot: [op sequence of each call]}} of this slice's regions."""
    calls, running = {}, []
    real, real_call = jit._run_region, jit.CapturedStep.__call__

    def call(region, *args):
        running.append(region)
        try:
            return real_call(region, *args)
        finally:
            running.pop()

    def recording(fn, args):
        region = running[-1]
        if region.name not in REGIONS:
            return real(fn, args)
        with _Recorder() as rec:
            result = real(fn, args)
        calls.setdefault(region.name, {}).setdefault(id(region.slot), []).append(rec.ops)
        return result

    mp = pytest.MonkeyPatch()
    mp.setattr(jit.CapturedStep, "__call__", call)
    mp.setattr(jit, "_run_region", recording)
    try:
        keep = _record_runs()
    finally:
        mp.undo()
    del keep
    return calls


@pytest.mark.parametrize("region", REGIONS)
def test_regions_are_capture_safe(recorded, region):
    """Each new region, on two calls of different content, runs the same
    operations with the same output shapes and types, none of them a host
    read, a data-dependent shape or (after its first call, which fills the
    lazily built constant tables) an upload."""
    slots = recorded[region]
    for seqs in slots.values():
        assert len(seqs) >= 2, (region, [len(q) for q in slots.values()])
        assert seqs[-2] == seqs[-1], f"region {region}: operations differ between two calls"
        bad = {op[0] for seq in seqs for op in seq if op[1] or op[0].startswith(FORBIDDEN)}
        assert not bad, f"region {region} holds {sorted(bad)}"
        uploads = {op[0] for seq in seqs[1:] for op in seq if op[0].startswith(UPLOADS)}
        assert not uploads, f"region {region} uploads host data at every call: {uploads}"


# ---------------------------------------------------------------------------
# (b) through the buffers, against capture=False
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def explored_pair():
    return _explore(True), _explore(False)


def test_ablation_world_through_buffers_equals_eager(explored_pair):
    got, want = explored_pair
    assert len(got["record"]) == len(want["record"]) == NAV_STEPS
    for (pa, patha, na, sa, ea), (pb, pathb, nb, sb, eb) in zip(got["record"], want["record"]):
        np.testing.assert_array_equal(pa, pb)
        assert (patha is None) == (pathb is None)
        if patha is not None:
            np.testing.assert_array_equal(patha, pathb)
        assert na == nb and sa == sb
        assert torch.equal(ea, eb)
    # explore_run schedules CleanupRoadmap on the simulation's clock, so the
    # cleanups fall on the same steps in both runs
    diag = [vars(r["server"].diag) for r in (got, want)]
    assert diag[0] == diag[1]
    assert got["server"].diag.goals_sent >= 2
    assert len(got["published"]) == len(want["published"]) >= 2
    for a, b in zip(got["published"], want["published"]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert torch.equal(got["known"], want["known"])
    assert got["server"].host_syncs == want["server"].host_syncs
    stats = {**got["sensor"].capture_stats, **got["server"].capture_stats}
    assert stats["reveal"]["calls"] >= NAV_STEPS
    # calls count from the slot's first owner (an earlier test's server, maybe)
    assert stats["publish"]["calls"] == stats["los"]["calls"] >= len(got["published"])
    assert not want["sensor"].capture_stats and not want["server"].capture_stats


def test_forced_tail_through_buffers_equals_eager(explored_pair):
    """A forced recovery (through ``tick``), the recovery and goal-cell
    probes, an eviction of 70 blacklist circles, two wedge marks and a
    ClearCostmap disc on the servers of both runs."""
    outs = []
    for run in explored_pair:
        server = run["server"]
        out = _tail(server, run["explored"])
        server._start_recovery()
        ticks = []
        for _ in range(3):
            server.tick()
            ticks.append((server.state, tuple(run["robot"].trajectory[-1])))
        out["recovery_ticks"] = ticks
        outs.append(out)
    got, want = outs
    for a, b in zip(got["free"], want["free"]):
        np.testing.assert_array_equal(a, b)
    assert got["cell"] == want["cell"]
    assert got["recovery_ticks"] == want["recovery_ticks"]
    for key in ("overlay", "marked", "cleared"):
        assert torch.equal(got[key], want[key]), key
    assert bool(got["overlay"].any()) and int((got["marked"] >= 0).sum()) > 0
    assert int((got["cleared"] >= 0).sum()) < int((got["marked"] >= 0).sum())
    stats = explored_pair[0]["server"].capture_stats
    assert {"recovery", "goal_cell", "evict", "wedge", "clear"} <= set(stats)
    assert stats["recovery"]["calls"] >= 4


@pytest.fixture(scope="module")
def active_pair():
    landmarks = _world()
    return _active(True, landmarks), _active(False, landmarks)


def test_active_loop_through_buffers_equals_eager(active_pair):
    got, want = active_pair
    assert len(got["frames"]) == len(want["frames"]) == ACTIVE_FRAMES
    for a, b in zip(got["frames"], want["frames"]):
        assert _equal_trees(a, b)
    sg, sw = got["system"], want["system"]
    assert len(sg.slam.trajectory) == ACTIVE_FRAMES
    for x, y in zip(sg.slam.trajectory, sw.slam.trajectory):
        np.testing.assert_array_equal(x, y)
    assert got["robot"].trajectory == want["robot"].trajectory
    assert torch.equal(sg.occupancy(), sw.occupancy())
    assert _equal_trees(sg.clouds, sw.clouds) and _equal_trees(sg._fstats, sw._fstats)
    assert int(sg.slam.map.n_kf) >= 2 and bool(sg.clouds.valid.any())
    assert got["camera"].capture_stats["camera"]["calls"] >= ACTIVE_FRAMES
    assert not want["camera"].capture_stats


def test_restitch_through_buffers_equals_eager_and_plain(active_pair):
    """Re-stitches after three forced corrections on the active systems:
    the statistics and the grid equal between the captured and the eager
    system, and equal to buffer_cell_stats -> stats_to_grid ->
    threshold_grid through the corrected, world-anchored poses."""
    got, want = active_pair
    sg, sw = got["system"], want["system"]
    tcfg = sg.cfg.traversability
    for k in (1, 2, 3):
        (stats_g, occ_g), (stats_w, occ_w) = _correct(sg, k), _correct(sw, k)
        assert _equal_trees(stats_g, stats_w) and torch.equal(occ_g, occ_w)
        kf, _ = sw.kf_poses_world()
        stats = tg.buffer_cell_stats(SPEC, sw.clouds, kf)
        assert _equal_trees(stats_w, stats)
        grid = tg.stats_to_grid(SPEC, stats, max_slope=tcfg.max_slope,
                                ground_clearance=tcfg.ground_clearance,
                                robot_height=tcfg.robot_height,
                                security_distance=tcfg.security_distance)
        assert torch.equal(occ_w, tg.threshold_grid(grid, tcfg.lethal_threshold))
    assert sg.capture_stats["restitch"]["calls"] >= 3
    assert "restitch" not in sw.capture_stats


# ---------------------------------------------------------------------------
# (c) against the reference
# ---------------------------------------------------------------------------


def test_reveal_sensor_owner_equals_reference():
    jnp = pytest.importorskip("jax.numpy")
    from fitslam_tpu.models import sim_robot as jsim
    from fitslam_tpu.ops import grid as jgrid

    js = jgrid.GridSpec2D(*SPEC)
    gt = jsim.make_rooms_world(js, seed=1)
    sensor = tsim.RevealSensor(SPEC, gt, "cpu", range_m=3.0)
    ej = jnp.full((64, 64), jgrid.UNKNOWN, jnp.uint8)
    robot = tsim.DiffDriveRobot(x=-5.0, y=-5.0)
    commands = [(0.8, 0.0), (0.8, 0.6), (0.5, -1.0), (1.0, 0.2), (0.9, -0.4)] * 8
    for v, w in commands:
        robot.step(v, w, 0.15)
        et = sensor.reveal(robot.xy)
        ej = jsim.reveal_sensor(js, jnp.asarray(gt), ej,
                                jnp.asarray(np.asarray(robot.xy, np.float32)), range_m=3.0)
        np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    # calls count from the slot's first owner (an earlier test's sensor, maybe)
    assert len(commands) == 40 and sensor.capture_stats["reveal"]["calls"] >= 40
    assert (et.numpy() != tg.UNKNOWN).mean() > 0.1


@pytest.mark.parametrize("rgbd", [False, True])
def test_sim_camera_equals_reference(rgbd):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fitslam_tpu.data import synthetic as jsyn
    from fitslam_tpu.models.active_slam import camera_pose_from_robot as jcam
    from fitslam_tpu.ops.geometry import Intrinsics as JK

    world = np.load(ROOT / "tests" / "data" / "bench_corridor_world.npz")["landmarks"]
    Kt = _K(320, 240, 200.0)
    Kj = JK(*(np.float32(float(v)) for v in Kt))
    cam = tsyn.SimCamera(Kt, torch.tensor(world), 320, 240, max_depth=12.0, cloud_points=CLOUD,
                         cloud_depth=8.0, rgbd=rgbd)
    render = jsyn.render_rgbd if rgbd else jsyn.render_stereo
    for pose in ((2.0, 0.0, 0.0), (3.5, 0.3, 0.1), (5.0, -0.2, -0.05)):
        a, b, pts, mask = cam.frame(camera_pose_from_robot(*pose, device="cpu"))
        ra, rb = render(Kj, jsyn.World(jnp.asarray(world)), jcam(*pose), width=320, height=240,
                        max_depth=12.0)
        rp, rm = jsyn.frustum_cloud(Kj, jsyn.World(jnp.asarray(world)), jcam(*pose), CLOUD,
                                    max_depth=8.0, width=320, height=240)
        np.testing.assert_allclose(a.numpy(), np.asarray(ra), rtol=0, atol=IMAGE_TOL)
        if rgbd:
            np.testing.assert_array_equal(b.numpy(), np.asarray(rb))
            assert (b.numpy() > 0).mean() > 0.01
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(rb), rtol=0, atol=IMAGE_TOL)
        np.testing.assert_array_equal(pts.numpy(), np.asarray(rp))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(rm))
        assert float(a.max()) > 100.0 and int(mask.sum()) > 50
    assert cam.capture_stats[cam.name]["calls"] >= 3


def test_published_path_equals_reference(explored_pair):
    """The captured server's published path beside the reference server's
    ``_build_published_path`` on the same roadmap, BF row and grid, for its
    last goal and three other goals: exactly equal."""
    jnp = pytest.importorskip("jax.numpy")
    from fitslam_tpu.models import exploration as jex
    from fitslam_tpu.models import roadmap as jrm
    from fitslam_tpu.ops import grid as jgrid

    run = explored_pair[0]
    server = run["server"]
    occ = server._overlaid(run["explored"])
    parent, src = server._bf
    ref = jex.ExplorationServer(bench_suite.ablation_config(), jgrid.GridSpec2D(*SPEC),
                                lambda: None, nav=None, get_robot_pose=lambda: None)
    ref.roadmap = jrm.Roadmap(*(jnp.asarray(getattr(server.roadmap, f).numpy())
                                for f in jrm.Roadmap._fields))
    ref._bf_parent = jnp.asarray(parent.numpy())
    ref._bf_src = int(src)
    robot_xy = run["robot"].xy
    goals = [server._goal_xy if server._goal_xy is not None else np.array([4.0, 4.0])]
    goals += [np.array(g) for g in ((4.0, -5.0), (-5.5, 5.0), (6.0, 6.2))]
    lengths = []
    for goal in goals:
        got = server._build_published_path(goal, occ, robot_xy)
        want = ref._build_published_path(goal, jnp.asarray(occ.numpy()), robot_xy)
        np.testing.assert_array_equal(got, want)
        lengths.append(len(got))
    assert max(lengths) >= 3


# ---------------------------------------------------------------------------
# (d) held views
# ---------------------------------------------------------------------------


def test_pending_cloud_survives_later_frames():
    """A frame's cloud pending its keyframe in ActiveSlamSystem (no tick
    polls the keyframes) keeps its values across 4 later frames of the
    captured camera, whose buffer those frames overwrite."""
    landmarks = _world()
    cfg = bench_suite.active_config(W, H, 256, 2, fx=100.0)
    robot = tsim.DiffDriveRobot(x=-5.0, y=-5.0, yaw=0.3)
    system, _ = bench_suite.active_system(cfg, SPEC, robot, "cpu")
    K = Intrinsics.from_config(cfg.camera, "cpu")
    cams = {c: tsyn.SimCamera(K, landmarks, W, H, max_depth=12.0, cloud_points=4096,
                              cloud_depth=8.0, capture=c) for c in (True, False)}
    first, views = None, None
    for i, pose in enumerate(POSES):
        T = camera_pose_from_robot(*pose, device="cpu")
        left, right, cloud, valid = cams[True].frame(T)
        if i == 0:
            first = cams[False].frame(T)[2:]
            views = (cloud, valid)
        system.process_frame(left, right, cloud, valid)
    held = system._pending_cloud[0]
    assert _equal_trees(held, first) and bool(first[1].any())
    # the camera's own views of frame 0 now hold frame 4's cloud
    assert not _equal_trees(views, first)
    assert sorted(system._pending_cloud) == list(range(len(POSES)))


def test_revealed_map_reaches_the_next_plan():
    """Each reveal reaches the nav's next plan from the same robot pose: its
    global costmap is the composition of the newly revealed map, and the
    plans equal the eager run's."""
    gt = tsim.make_rooms_world(SPEC, seed=1)
    cfg = FitSlamConfig()
    paths = {}
    for capture in (True, False):
        sensor = tsim.RevealSensor(SPEC, gt, "cpu", range_m=3.0, capture=capture)
        robot = tsim.DiffDriveRobot(x=-5.0, y=-5.0, yaw=0.0)
        nav = SimNavInterface(cfg, SPEC, robot, lambda: sensor.explored, device="cpu",
                              capture=capture)
        got = []
        for where in ((-5.0, -5.0), (-2.0, -5.0), (1.0, -4.0), (4.0, -5.0)):
            sensor.reveal(where)
            robot.x, robot.y, robot.yaw = -5.0, -5.0, 0.0
            nav.send_goal(np.array([5.0, -5.0]), 0.0)
            nav.step()
            got.append(nav._path.copy())
            fresh = navx.Costmap(SPEC, cfg.costmaps.global_map, lambda: sensor.explored.clone(),
                                 capture=False)
            assert torch.equal(nav.global_costmap.grid()[0], fresh.grid()[0])
        paths[capture] = got
        assert not np.array_equal(got[0], got[-1])
    for a, b in zip(paths[True], paths[False]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# (e) on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_captured_equals_eager_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    dev = torch.device("cuda", 0)
    monkeypatch.setattr(tex, "RARE_EAGER_CALLS", dict.fromkeys(tex.RARE_EAGER_CALLS, 0))
    monkeypatch.setattr(tas, "RESTITCH_EAGER_CALLS", 0)
    runs = [_explore(c, device=dev) for c in (False, True)]
    eager, captured = runs
    for a, b in zip(eager["record"], captured["record"]):
        np.testing.assert_array_equal(a[0], b[0])
        assert torch.equal(a[4], b[4])
    for a, b in zip(eager["published"], captured["published"]):
        assert (a is None and b is None) or np.array_equal(a, b)
    stats = {**captured["sensor"].capture_stats, **captured["server"].capture_stats}
    assert stats["reveal"]["captured"] and stats["publish"]["captured"]
    tails = []
    for run in runs:
        out = {}
        for _ in range(3):                       # warm-up, capture, replay
            out = _tail(run["server"], run["explored"])
        tails.append(out)
    for key in ("overlay", "marked", "cleared"):
        assert torch.equal(tails[0][key], tails[1][key]), key
    for a, b in zip(tails[0]["free"], tails[1]["free"]):
        np.testing.assert_array_equal(a, b)
    assert tails[0]["cell"] == tails[1]["cell"]
    assert all(captured["server"].capture_stats[k]["captured"]
               for k in ("recovery", "goal_cell", "evict", "wedge", "clear"))

    landmarks = bench_suite.rooms_world(SPEC, dev).landmarks
    K = _K(640, 480, 400.0)
    K = Intrinsics(*(v.to(dev) for v in K))
    for rgbd in (False, True):
        want = []
        cam = tsyn.SimCamera(K, landmarks, 640, 480, max_depth=12.0, cloud_points=4096,
                             cloud_depth=8.0, rgbd=rgbd, capture=False)
        for pose in POSES:
            want.append(jit.clone(cam.frame(camera_pose_from_robot(*pose, device=dev))))
        cam = tsyn.SimCamera(K, landmarks, 640, 480, max_depth=12.0, cloud_points=4096,
                             cloud_depth=8.0, rgbd=rgbd)
        for pose, w in zip(POSES, want):
            assert _equal_trees(cam.frame(camera_pose_from_robot(*pose, device=dev)), w)
        assert cam.capture_stats[cam.name]["captured"]
