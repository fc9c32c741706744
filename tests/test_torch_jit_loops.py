"""The active-SLAM loop's other captured programs (``utils/jit.py``) on the
CPU, where every region runs eagerly through the same static input, state
and output buffers a CUDA graph replays from: the EKF's windows
(``DualEkf``'s ``ekf_odom`` / ``ekf_map``), the exploration tick
(``ExplorationServer``'s ``overlay`` and ``tick`` variants, the FI oracle's
device work inside ``tick``) and the traversability fusion
(``ActiveSlamSystem``'s ``fuse_keyframe`` / ``fuse_grid``); and on the card,
captured against eager.

- Capture safety: each region's operations, output shapes and types, as a
  ``TorchDispatchMode`` records them, are the same on two calls of different
  content, with no host read, no operation whose output shape depends on
  the data and no host-to-device upload after its first call.
- Through the buffers, a ``DualEkf`` flushed with 1, 64, 65 and 130 rows, a
  30-tick explorer loop (tests/test_torch_exploration.py's set-up, the
  RandomCosts ablation's too) and the active loop with the EKF, the FI gate
  and the fusion on (tests/test_torch_ekf_active.py's set-up) equal
  ``capture=False`` bit for bit. The reference-parity tests of
  test_torch_localization.py and test_torch_exploration.py run through the
  buffers too: ``capture`` is the default.
- Host values (the search radius, the tick count, the blacklist, the robot
  pose, RandomCosts' draw) reach the regions as inputs, and writers outside
  them (assigning ``roadmap`` or ``lethal_overlay``, a checkpoint's load,
  the EKF's first fix) reach the next call.
- Two live owners of one configuration never share state.

The card test imports no JAX:

    python3 -m pytest --noconftest -m gpu tests/test_torch_jit_loops.py
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fitslam_tpu_torch.data import synthetic as tsyn
from fitslam_tpu_torch.models import costs as cx
from fitslam_tpu_torch.models import exploration as tex
from fitslam_tpu_torch.models import localization as loc
from fitslam_tpu_torch.models import nav as navx
from fitslam_tpu_torch.models import sim_robot as tsim
from fitslam_tpu_torch.models.active_slam import ActiveSlamSystem, camera_pose_from_robot
from fitslam_tpu_torch.models.localization import DualEkf, TwistMux
from fitslam_tpu_torch.models.sim_nav import SimNavInterface
from fitslam_tpu_torch.ops import grid as tg
from fitslam_tpu_torch.ops import pallas_grid
from fitslam_tpu_torch.ops.geometry import Intrinsics
from fitslam_tpu_torch.utils import checkpoint, jit, prng
from fitslam_tpu_torch.utils.config import FitSlamConfig
from fitslam_tpu_torch.utils.profiling import SimClock

# several pytest-xdist workers share the machine
torch.set_num_threads(2)

SPEC = tg.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)
FORBIDDEN = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select", "aten.unique")
UPLOADS = ("aten.lift_fresh",)      # torch.tensor(host data): a host->device copy on the card
FRAME_STEP = {"frontend_stereo", "track_uninitialized", "track", "keyframe", "compact",
              "finish", "finish_keyframe"}
W, H = 320, 240
ACTIVE_FRAMES = 14
EXPLORE_STEPS = 60                    # a tick every other step: 30 ticks


def _leaves(tree):
    return jit.flatten(tree)[0]


def _equal_trees(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# Set-ups
# ---------------------------------------------------------------------------


def _explore_config(methods=None):
    """tests/test_exploration_e2e.py's configuration (cleanup every 5 s of
    the simulation's clock)."""
    cfg = FitSlamConfig()
    R = dataclasses.replace
    cfg = R(cfg,
            frontier_search=R(cfg.frontier_search, search_radius_m=6.0, max_frontiers=64),
            roadmap=R(cfg.roadmap, max_nodes=256, cleanup_period_s=5.0),
            nav=R(cfg.nav, wavefront_iters=192, desired_speed=0.8),
            exploration_bt=R(cfg.exploration_bt, nav2_goal_timeout_s=30.0),
            fisher_information=R(cfg.fisher_information, enabled=False))
    if methods is not None:
        cfg = R(cfg, cost_assigner=R(cfg.cost_assigner, cost_calculation_methods=methods))
    return cfg


class _Explorer:
    """tests/test_torch_exploration.py's loop (rooms world of seed 1, reveal
    sensor, wavefront nav on the CPU) on the simulation's clock, the server
    on ``device``, each tick's packed scalars recorded in ``reads``."""

    def __init__(self, capture, methods=None, device="cpu"):
        self.cfg = _explore_config(methods)
        self.gt = torch.tensor(tsim.make_rooms_world(SPEC, seed=1))
        self.state = {"explored": torch.full((64, 64), tg.UNKNOWN, dtype=torch.uint8)}
        self.robot = tsim.DiffDriveRobot(x=-5.0, y=-5.0, yaw=0.0, v_max=1.2, w_max=2.5)
        self.nav = SimNavInterface(self.cfg, SPEC, self.robot, lambda: self.state["explored"],
                                   dt=0.15, device="cpu")
        self.nav.controller.max_omega = 2.0
        self.clock = SimClock()
        self.server = tex.ExplorationServer(
            self.cfg, SPEC, lambda: self.state["explored"].to(device), self.nav,
            get_robot_pose=lambda: (self.robot.xy, self.robot.yaw), event_logger=self.clock,
            device=device, capture=capture)
        self.reads = []
        tick_device = self.server._tick_device

        def recording(*args):
            out = tick_device(*args)
            self.reads.append(out[0].cpu().numpy().copy())
            return out

        self.server._tick_device = recording

    def run(self, steps=EXPLORE_STEPS):
        for step in range(steps):
            self.state["explored"] = tsim.reveal_sensor(
                SPEC, self.gt, self.state["explored"],
                torch.tensor(self.robot.xy, dtype=torch.float32), range_m=3.0)
            if step % 2 == 0:
                self.server.tick()
            for _ in range(4):
                self.nav.step()
            self.clock.sim_s += 0.6
        return self


def _active_config():
    """tests/test_ekf_integration.py's configuration with the FI gate on."""
    cfg = FitSlamConfig()
    R = dataclasses.replace
    return R(
        cfg,
        camera=R(cfg.camera, width=W, height=H, fx=200.0, fy=200.0, cx=W / 2, cy=H / 2,
                 baseline=0.2),
        orb=R(cfg.orb, num_features=320, num_levels=2, fast_threshold=12.0),
        tracking=R(cfg.tracking, min_inliers=10, keyframe_min_interval=2,
                   keyframe_translation=0.25),
        mapping=R(cfg.mapping, max_keyframes=32, max_landmarks=2048, max_observations=6144,
                  local_window=4, ba_iters=3),
        loop=R(cfg.loop, enabled=False),
        traversability=R(cfg.traversability, max_points_per_cloud=4096, max_clouds=32),
        localization=R(cfg.localization, enabled=True),
        roadmap=R(cfg.roadmap, max_nodes=256, cleanup_period_s=100.0),
        fisher_information=R(cfg.fisher_information, enabled=True, threshold=1.0),
    )


@pytest.fixture(scope="module")
def world():
    return tsyn.world_from_occupancy(
        tsim.make_rooms_world(SPEC, seed=3), SPEC, tsyn.ROOMS_WORLD_SEED, wall_height=2.0,
        points_per_wall_cell=4, floor_points=3000, device="cpu").landmarks


class _Active:
    """The active loop of bench_suite.active_loop at 320x240: a stereo frame
    and its frustum cloud every step, a tick every 4th, a controller step and
    the EKF's estimate read every step, on a ``SimClock``."""

    def __init__(self, capture, landmarks):
        self.cfg = _active_config()
        self.K = Intrinsics.from_config(self.cfg.camera, "cpu")
        self.landmarks = landmarks
        self.robot = tsim.DiffDriveRobot(x=-5.0, y=-5.0, yaw=0.3, v_max=0.8, w_max=1.0)
        box = {}
        self.nav = SimNavInterface(self.cfg, SPEC, self.robot, lambda: box["s"].occupancy(),
                                   dt=0.15, twist_mux=TwistMux(), device="cpu")
        self.system = ActiveSlamSystem(self.cfg, SPEC, self.nav, device="cpu",
                                       event_logger=SimClock(), capture=capture,
                                       get_robot_pose=lambda: box["s"].estimated_robot_pose())
        box["s"] = self.system
        self.poses, self.step_ = [], 0

    def run(self, frames):
        s, r = self.system, self.robot
        for _ in range(frames):
            cam = camera_pose_from_robot(r.x, r.y, r.yaw, device="cpu")
            if self.step_ == 0:
                s.set_world_anchor(cam)
            left, right = tsyn.render_stereo(self.K, self.landmarks, cam, width=W, height=H,
                                             max_depth=12.0)
            cloud, valid = tsyn.frustum_cloud(self.K, self.landmarks, cam, max_points=4096,
                                              max_depth=8.0, width=W, height=H)
            s.process_frame(left, right, cloud, valid)
            if self.step_ % 4 == 3:
                s.tick_exploration()
            self.nav.step()
            xy, yaw = s.estimated_robot_pose()
            self.poses.append(np.array([xy[0], xy[1], yaw]))
            s.log.sim_s += 0.15
            self.step_ += 1
        return self


def _same_active(a: _Active, b: _Active):
    sa, sb = a.system, b.system
    np.testing.assert_array_equal(np.array(a.poses), np.array(b.poses))
    for x, y in zip(sa.slam.trajectory, sb.slam.trajectory):
        np.testing.assert_array_equal(x, y)
    assert _equal_trees(sa.ekf.odom_state, sb.ekf.odom_state)
    assert _equal_trees(sa.ekf.map_state, sb.ekf.map_state)
    assert vars(sa.explorer.diag) == vars(sb.explorer.diag)
    assert _equal_trees(sa.explorer.roadmap, sb.explorer.roadmap)
    assert torch.equal(sa.occupancy(), sb.occupancy())
    assert _equal_trees(sa.clouds, sb.clouds)
    assert _equal_trees(sa._fstats, sb._fstats)
    assert _equal_trees(sa.slam.map, sb.slam.map)


def _rows(rng, n):
    """``n`` random sensor rows: odometry, IMU rates and orientation, SLAM
    poses (gated), GPS."""
    rows = []
    while len(rows) < n:
        k = rng.integers(4)
        if k == 0:
            rows.append(loc.sensor_row(loc.ODOM_MASK, rng.normal(size=2), np.full(2, 0.01),
                                       0.1))
        elif k == 1:
            rows.append(loc.sensor_row(loc.IMU_MASK, rng.normal(size=3) * 0.1,
                                       np.full(3, 0.005), 0.0))
        elif k == 2:
            rows.append(loc.sensor_row(loc.POSE_MASK, rng.normal(size=3), np.full(3, 0.02),
                                       0.0, 3.0))
        else:
            rows.append(loc.sensor_row(loc.IMU_ORI_MASK, rng.normal(size=3) * 0.2,
                                       np.full(3, 0.01), 0.0, 0.8))
    return rows


def _flushed(capture, n_rows, seed=0, device="cpu"):
    dual = DualEkf(device=device, capture=capture)
    rng = np.random.default_rng(seed)
    for _ in range(2):                         # two flushes: the second starts mid-stream
        dual._odom_rows = _rows(rng, n_rows)
        dual._map_rows = _rows(rng, n_rows)
        out = dual.flush()
    return dual, out


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


def _recorded_regions(monkeypatch, runs):
    """{region: {slot: [op sequence of each call]}} of the regions outside
    the frame step while ``runs()`` drives them (a region of one name in
    slots of other keys, as the local and the global costmap's, runs other
    operations: one record a slot)."""
    calls = {}
    real = jit._run_region

    def recording(fn, args):
        slot, name = next((s, n) for s in jit.slots() for n, r in s.regions.items()
                          if r.fn is fn)
        if name in FRAME_STEP:
            return real(fn, args)
        with _Recorder() as rec:
            result = real(fn, args)
        calls.setdefault(name, {}).setdefault(id(slot), []).append(rec.ops)
        return result

    monkeypatch.setattr(jit, "_run_region", recording)
    runs()
    return calls


def test_regions_are_capture_safe(world, monkeypatch):
    """Every new region, on two calls of different content, runs the same
    operations with the same output shapes and types, none of them a host
    read, a data-dependent shape or (after its first call, which fills the
    lazily built constant tables) an upload."""
    def runs():
        _Active(True, world).run(ACTIVE_FRAMES)
        _Explorer(True).run(24)
        _Explorer(True, methods=("RandomCosts",)).run(8)
        for n in (5, 70):
            _flushed(True, n)

    calls = _recorded_regions(monkeypatch, runs)
    names = set(calls)
    assert {"ekf_odom", "ekf_map", "overlay", "fuse_keyframe", "fuse_grid"} <= names, names
    ticks = {n for n in names if n.startswith("tick")}
    # the active loop's tick (the FI oracle inside, its inputs a tree of 9
    # leaves), the explorer's and CleanupRoadmap's variant
    assert {"tick+fi/9", "tick/0", "tick+reanchor/0"} <= ticks, ticks
    for name, slots in calls.items():
        for seqs in slots.values():
            assert len(seqs) >= 2, (name, [len(q) for q in slots.values()])
            assert seqs[-2] == seqs[-1], f"region {name}: operations differ between two calls"
            bad = {op[0] for seq in seqs for op in seq if op[1] or op[0].startswith(FORBIDDEN)}
            assert not bad, f"region {name} holds {sorted(bad)}"
            uploads = {op[0] for seq in seqs[1:] for op in seq if op[0].startswith(UPLOADS)}
            assert not uploads, f"region {name} uploads host data at every call: {uploads}"


# ---------------------------------------------------------------------------
# (b) the buffers give the eager results
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_rows", [1, 64, 65, 130])
def test_dual_ekf_through_buffers_equals_eager(n_rows):
    got, got_out = _flushed(True, n_rows, seed=n_rows)
    want, want_out = _flushed(False, n_rows, seed=n_rows)
    for a, b in zip(got_out, want_out):
        np.testing.assert_array_equal(a, b)
    assert _equal_trees(got.odom_state, want.odom_state)
    assert _equal_trees(got.map_state, want.map_state)
    assert got.windows == want.windows == 4 * -(-n_rows // DualEkf.WINDOW_CAP)
    assert got.host_syncs == want.host_syncs == 2
    assert got.capture_stats["ekf_map"]["calls"] >= 2 * -(-n_rows // DualEkf.WINDOW_CAP)
    # the states are the slot's buffers, updated in place
    assert got._slot_state.slot.owns(got.map_state.P) and not want.capture_stats
    assert DualEkf(device="cpu").capture          # the reference-parity tests' default


@pytest.mark.parametrize("methods", [None, ("RandomCosts",)], ids=["default", "random"])
def test_explorer_loop_through_buffers_equals_eager(methods):
    got = _Explorer(True, methods).run()
    want = _Explorer(False, methods).run()
    assert len(got.reads) == len(want.reads) > 10
    for a, b in zip(got.reads, want.reads):
        np.testing.assert_array_equal(a, b)
    assert vars(got.server.diag) == vars(want.server.diag)
    assert got.server.diag.loop_corrections >= 2 and got.server.diag.goals_sent >= 1
    assert _equal_trees(got.server.roadmap, want.server.roadmap)
    np.testing.assert_array_equal(np.array(got.robot.trajectory), np.array(want.robot.trajectory))
    assert got.server._slot_state.slot.owns(got.server.roadmap.adj)
    stats = got.server.capture_stats
    assert stats["overlay"]["calls"] >= len(got.reads)


def test_active_loop_through_buffers_equals_eager(world):
    """The active loop with the EKF, the FI gate and the fusion on."""
    got = _Active(True, world).run(ACTIVE_FRAMES)
    want = _Active(False, world).run(ACTIVE_FRAMES)
    _same_active(got, want)
    stats = got.system.capture_stats
    for name in ("ekf_odom", "ekf_map", "overlay", "fuse_keyframe", "fuse_grid", "track"):
        assert stats[name]["calls"] >= 2, (name, stats)
    assert stats["tick+fi/9"]["calls"] >= 2
    assert not want.system.capture_stats
    assert got.system.explorer.diag.goals_sent >= 1


# ---------------------------------------------------------------------------
# (c) host values reach the regions
# ---------------------------------------------------------------------------


def _frozen_pair(methods=None):
    """A captured and an eager explorer on one explored map (the loop's
    state after 20 steps), each ticked once."""
    base = _Explorer(False, methods).run(20)
    explored = base.state["explored"].clone()
    pair = []
    for capture in (True, False):
        e = _Explorer(capture, methods)
        e.state["explored"] = explored
        e.robot.x, e.robot.y, e.robot.yaw = base.robot.x, base.robot.y, base.robot.yaw
        e.server.roadmap = jit.clone(base.server.roadmap)
        e.server._last_cleanup = 1e18
        e.server.tick()
        pair.append(e)
    return pair


def _tick_both(pair, change):
    for e in pair:
        change(e)
        e.server.tick()
    a, b = (e.reads[-1] for e in pair)
    np.testing.assert_array_equal(a, b)
    return a


@pytest.mark.parametrize("what", ["radius", "ticks", "blacklist", "pose", "random_draw"])
def test_host_values_reach_the_tick(what):
    pair = _frozen_pair(("RandomCosts",) if what == "random_draw" else None)
    before = pair[0].reads[-1]
    if what == "radius":
        after = _tick_both(pair, lambda e: setattr(e.server, "_search_radius", 0.5))
        assert after[0] < before[0]                       # fewer frontiers in reach
    elif what == "ticks":
        # an FI wedge marked now, in force for 2 ticks, then expired
        for e in pair:
            s = e.server
            s.wedge_age = navx.mark_wedge_age(SPEC, s.wedge_age, s._upload_xy(e.robot.xy),
                                              float(np.float32(e.robot.yaw)), s.diag.ticks)
        ttl = pair[0].cfg.fisher_information.lethal_wedge_ttl_ticks
        occs = []
        for dt in (0, ttl + 1):
            got = []
            for e in pair:
                e.server.diag.ticks += dt
                got.append(e.server._overlaid(e.state["explored"]).clone())
            assert torch.equal(got[0], got[1])
            occs.append(got[0])
        assert (occs[0] == tg.LETHAL).sum() > (occs[1] == tg.LETHAL).sum()
    elif what == "blacklist":
        goal = before[3:5].astype(np.float64)
        after = _tick_both(pair, lambda e: e.server.blacklist_xy.append(
            np.array([goal[0], goal[1], 0.6], np.float32)))
        assert not np.array_equal(after[3:5], before[3:5])
    elif what == "pose":
        def move(e):
            e.robot.x, e.robot.y = e.robot.x + 1.5, e.robot.y + 0.5
        after = _tick_both(pair, move)
        assert not np.array_equal(after, before)
    else:
        # the draw decides the goal only among more than five locals, which
        # this map lacks: the region's staged input holds each tick's draw
        F = pair[0].cfg.frontier_search.max_frontiers
        for _ in range(2):
            _tick_both(pair, lambda e: e.nav.cancel())
            s = pair[0].server
            region = s._slot_state.slot.regions["tick/0"]
            staged = jit.unflatten(region.in_spec, region.static_in)[2]   # the host vector
            want = cx.random_draw(prng.prng_key(s.diag.ticks), F)
            np.testing.assert_array_equal(staged[-F:].numpy(), want)


# ---------------------------------------------------------------------------
# (d) writers outside the regions reach the next call
# ---------------------------------------------------------------------------


def test_roadmap_and_overlay_writers_reach_the_next_tick():
    pair = _frozen_pair()
    other = _Explorer(False).run(8).server.roadmap
    disc = np.zeros((tex.BLACKLIST_CAP, 3), np.float32)
    disc[:, :2] = 1e9
    disc[0] = [pair[0].robot.x + 1.0, pair[0].robot.y, 1.0]
    views = []
    for e in pair:
        s = e.server
        views.append(s.lethal_overlay)
        s.roadmap = jit.clone(other)
        s.lethal_overlay = navx.mark_lethal_discs(SPEC, s.lethal_overlay, torch.tensor(disc))
        assert _equal_trees(s.roadmap, other)
    # a new overlay object at every change: the costmaps cache against it
    assert pair[0].server.lethal_overlay is not views[0]
    assert pair[0].server._slot_state.slot.owns(pair[0].server.lethal_overlay)
    _tick_both(pair, lambda e: None)
    assert _equal_trees(pair[0].server.roadmap, pair[1].server.roadmap)
    occ = [e.server._overlaid(e.state["explored"]) for e in pair]
    assert torch.equal(occ[0], occ[1]) and int((occ[0] == tg.LETHAL).sum()) > 0


def test_ekf_writers_reach_the_next_flush():
    """The first fix's write (both states at a datum), as
    ``ActiveSlamSystem._fuse_slam_pose`` makes it, after a flush."""
    x0 = np.zeros(loc.STATE_DIM, np.float32)
    x0[[loc.X, loc.Y, loc.YAW]] = [1.5, -2.0, 0.4]
    duals = []
    for capture in (True, False):
        dual, _ = _flushed(capture, 20, seed=3)
        dual.odom_state = loc.initial_state(x0, device="cpu")
        dual.map_state = loc.initial_state(x0, device="cpu")
        dual._odom_rows = _rows(np.random.default_rng(4), 30)
        dual._map_rows = _rows(np.random.default_rng(5), 30)
        duals.append((dual, dual.flush()))
    (a, out_a), (b, out_b) = duals
    np.testing.assert_array_equal(out_a[1], out_b[1])
    assert abs(out_a[1][0] - 1.5) < 1.0
    assert _equal_trees(a.map_state, b.map_state) and _equal_trees(a.odom_state, b.odom_state)


def test_load_active_system_reaches_the_next_step(world, tmp_path):
    src = _Active(False, world).run(8)
    path = str(tmp_path / "active.npz")
    checkpoint.save_active_system(path, src.system)
    runs = []
    for capture in (True, False):
        a = _Active(capture, world).run(4)              # buffers and regions in use first
        checkpoint.load_active_system(path, a.system)
        a.robot.x, a.robot.y, a.robot.yaw = src.robot.x, src.robot.y, src.robot.yaw
        a.step_, a.poses = 8, []
        runs.append(a.run(4))
    _same_active(*runs)
    assert runs[0].system.explorer.diag.ticks == src.system.explorer.diag.ticks + 1


# ---------------------------------------------------------------------------
# (e) two live owners never share
# ---------------------------------------------------------------------------


def test_live_owners_do_not_share():
    jit.release_idle()                               # earlier tests' owners are gone
    a = _Explorer(True).run(6)
    b = _Explorer(True)
    b.robot.x, b.robot.y = 4.0, 4.0
    b.run(6)
    assert a.server._slot_state.slot is not b.server._slot_state.slot
    assert not _equal_trees(a.server.roadmap, b.server.roadmap)
    d1, _ = _flushed(True, 10, seed=1)
    d2, _ = _flushed(True, 10, seed=2)
    assert d1._slot_state.slot is not d2._slot_state.slot
    assert not torch.equal(d1.map_state.x, d2.map_state.x)
    # a dead owner's slot goes to the next owner of its key, with that
    # owner's fresh state
    slot = d2._slot_state.slot
    del d2
    d3, out = _flushed(True, 10, seed=7)
    _, want = _flushed(False, 10, seed=7)
    assert d3._slot_state.slot is slot
    np.testing.assert_array_equal(out[1], want[1])


# ---------------------------------------------------------------------------
# (f) on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_captured_equals_eager_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    dev = torch.device("cuda", 0)
    for n_rows in (1, 130):
        got, out_got = _flushed(True, n_rows, seed=n_rows, device=dev)
        want, out_want = _flushed(False, n_rows, seed=n_rows, device=dev)
        np.testing.assert_array_equal(out_got[1], out_want[1])
        assert torch.equal(got.map_state.P, want.map_state.P)
    assert got.capture_stats["ekf_map"]["captured"]

    runs = []
    for capture in (False, True):
        sweeps = pallas_grid.wavefront_sweeps.launches
        e = _Explorer(capture, device=dev).run(24)
        torch.cuda.synchronize()
        runs.append((e, pallas_grid.wavefront_sweeps.launches - sweeps))
    (eager, n_eager), (captured, n_captured) = runs
    assert captured.server.capture_stats["tick/0"]["captured"]
    assert len(eager.reads) == len(captured.reads) > 5
    for a, b in zip(eager.reads, captured.reads):
        np.testing.assert_array_equal(a, b)
    assert n_eager == n_captured > 0
    assert _equal_trees(eager.server.roadmap, captured.server.roadmap)
