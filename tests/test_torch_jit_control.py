"""The controller's, the loop closer's and the fleet's captured programs
(``utils/jit.py``) on the CPU, where every region runs eagerly through the
same static input, state and output buffers a CUDA graph replays from: the
costmaps' composition (``Costmap``'s ``costmap`` / ``costmap+overlay``) and
the plan (``SimNavInterface``'s ``plan``), the loop correction (the engine's
``loop_detect``, ``loop_verify``, ``loop_correct[...]`` and ``refine_map``'s
``refine_cycle``) and the fleet (``MultiRobotCoordinator``'s
``coordinator``, ``TaskAllocator``'s ``minpos``, ``auction_setup`` and
``auction_chunk/n``); and on the card, captured against eager.

- Capture safety: each region's operations, output shapes and types, as a
  ``TorchDispatchMode`` records them, are the same on two calls of different
  content, with no host read, no operation whose output shape depends on
  the data and no host-to-device upload after its first call.
- Through the buffers: 40 steps of the G = 64 ablation world, the
  coordinator's first 10 ticks (2 and 4 rovers, each allocator), the
  auction on seeded problems and the loop correction and ``refine_map`` on
  the drifted revisit (tests/test_loop_closing.py's scene: its retrieval,
  GBA with re-triangulation or the scale search, without GBA, and across two
  Atlas maps) equal ``capture=False`` bit for bit.
- Against the reference: a plan exactly (min-plus sweeps, cell centres);
  the auction's assignment and rounds exactly; the correction's inliers
  exactly, keyframe poses within 1e-3 and PGO's chi2 within 1e-3 relative
  (tests/test_torch_loop_closing.py's bounds), without GBA (on the exact
  revisit its chi2 is float32 noise); refine_map's re-triangulation and GBA
  on the revisit with pixel noise: poses within 1e-3 and the chi2 within
  1e-2 relative (test_torch_loop_closing.py's refine_map bounds).
- A changed occupancy or overlay reaches the next plan; a composed grid held
  across a recomposition keeps its values.

The card test imports no JAX:

    python3 -m pytest --noconftest -m gpu tests/test_torch_jit_control.py
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fitslam_tpu_torch import bench_suite, run_multirobot
from fitslam_tpu_torch.models import allocation as al
from fitslam_tpu_torch.models import loop_closing
from fitslam_tpu_torch.models import nav as navx
from fitslam_tpu_torch.models import sim_robot as tsim
from fitslam_tpu_torch.models import slam as slam_module
from fitslam_tpu_torch.models import slam_map as sm
from fitslam_tpu_torch.models import tracking as tr
from fitslam_tpu_torch.models.sim_nav import SimNavInterface
from fitslam_tpu_torch.models.slam import StereoSlam
from fitslam_tpu_torch.ops import grid as tg
from fitslam_tpu_torch.ops import lie, pallas_grid, pallas_matching
from fitslam_tpu_torch.ops.geometry import Intrinsics, project_stereo
from fitslam_tpu_torch.ops.orb import FrameFeatures
from fitslam_tpu_torch.ops.place import signature_from_descriptors
from fitslam_tpu_torch.utils import jit
from fitslam_tpu_torch.utils.config import FitSlamConfig

# several pytest-xdist workers share the machine
torch.set_num_threads(2)

SPEC = tg.GridSpec2D(**bench_suite.ABLATION_SPEC)
FORBIDDEN = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select", "aten.unique")
UPLOADS = ("aten.lift_fresh",)      # torch.tensor(host data): a host->device copy on the card
NEW = ("costmap", "plan", "coordinator", "minpos", "auction_", "loop_", "refine_cycle")
N = 128                             # features a revisit frame
NAV_STEPS = 40
FLEET_TICKS = 10
PGO_TOL = 1e-3                      # tests/test_torch_loop_closing.py: poses after a correction
CHI2_RTOL = 1e-3                    # ... and PGO's chi2 (atol 1e-4)
GBA_RTOL = 1e-2                     # its refine_map bound on the chi2


def _leaves(tree):
    return jit.flatten(tree)[0]


def _equal_trees(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# Set-ups
# ---------------------------------------------------------------------------


def _explore(capture, steps=NAV_STEPS, device="cpu"):
    """bench_suite.explore_run's G = 64 ablation loop for ``steps`` steps,
    each controller window's nav state recorded: (robot pose, path, plans,
    status)."""
    record = []
    box = {}

    def window(w, step, fn):
        out = fn()
        if w == "ctrl":
            nav = box["nav"]
            path = None if nav._path is None else nav._path.copy()
            record.append((np.array([nav.robot.x, nav.robot.y, nav.robot.yaw]), path,
                           nav.plans, nav.status()))
        return out

    real = SimNavInterface.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        box["nav"] = self

    SimNavInterface.__init__ = init
    try:
        run = bench_suite.explore_run(bench_suite.ablation_config(), SPEC,
                                      bench_suite.ABLATION_START, steps, device,
                                      window=window, capture=capture)
    finally:
        SimNavInterface.__init__ = real
    run["record"] = record
    return run


def _problem(seed, R, F, forbid=0.0):
    rng = np.random.RandomState(seed)
    cost = rng.uniform(0, 10, (R, F)).astype(np.float32)
    cost[rng.rand(R, F) < forbid] = al.BIG
    return cost


def _scarce():
    """More rows than feasible columns: the auction runs to max_rounds."""
    cost = np.full((4, 64), al.BIG, np.float32)
    cost[:, 3] = [1.0, 2.0, 3.0, 4.0]
    cost[:, 9] = [4.0, 3.0, 2.0, 1.0]
    return cost


def _contended():
    """16 rows that all prefer the same 3 of 64 columns: a price war that a
    cap of 40 rounds cuts short."""
    cost = _problem(7, 16, 64) * 0.5 + 5.0
    cost[:, :3] = np.random.RandomState(8).uniform(0.0, 0.1, (16, 3))
    return cost.astype(np.float32)


AUCTIONS = {"r_lt_f": (lambda: _problem(1, 6, 20), 1024),
            "scarce": (_scarce, 1024),
            "cut_at_40": (_contended, 40)}


def _auction(cost, max_rounds, capture, device="cpu", eps=None):
    owner = al.TaskAllocator("auction", device=device, capture=capture)
    stats = {}
    state = owner.slot_state(*cost.shape)
    got = al.auction_assign(torch.tensor(cost, device=device), eps=eps, max_rounds=max_rounds,
                            stats=stats, state=state)
    return got.cpu().numpy(), stats, owner


def _fleet(R, allocator, capture, device="cpu"):
    """run_multirobot's fleet for its first FLEET_TICKS ticks, one
    controller step a rover a step (the example's 3 would only add plans),
    each tick's (cost matrix, assignment) recorded."""
    calls = []
    real = al.TaskAllocator.allocate

    def allocate(self, cost, frontier_xy, peer_goals=None):
        out = real(self, cost, frontier_xy, peer_goals)
        calls.append((np.array(cost, copy=True), np.array(out, copy=True)))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(al.TaskAllocator, "allocate", allocate)
    mp.setattr(run_multirobot, "NAV_STEPS", 1)
    try:
        run = run_multirobot.run(R, run_multirobot.TICK_EVERY * FLEET_TICKS, allocator,
                                 device=device, verbose=False, capture=capture)
    finally:
        mp.undo()
    return run, calls


def _revisit(drift=(0.5, 0.2, 0.0, 0.0, 0.0, 0.05), second_map=False, seed=0, noise=0.0):
    """tests/test_loop_closing.py's scene built with the port's functions:
    keyframe 0 at the origin, seven far-away keyframes, keyframe 8 revisiting
    keyframe 0's view from a drifted pose (in Atlas map 1 with
    ``second_map``). Descriptors and points from numpy's ``seed``. With
    ``noise`` keyframe 8 re-observes keyframe 0's landmarks instead of
    spawning its own, and every observation's pixels get that much Gaussian
    noise: the map's chi2 is then more than float32 noise."""
    rng = np.random.default_rng(seed)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    K = Intrinsics(f32(200.0), f32(200.0), f32(160.0), f32(120.0), f32(0.2))
    pts_w = torch.tensor(rng.uniform(-4.0, 4.0, (N, 3)), dtype=torch.float32) + f32([0, 0, 8.0])

    def desc():
        return torch.tensor(np.where(rng.random((N, 256)) < 0.5, 1.0, -1.0)).to(torch.bfloat16)

    def frame_at(T_cw, pts, d):
        p_c = (T_cw.R @ pts[..., None])[..., 0] + T_cw.t
        uvr, ok = project_stereo(K, p_c)
        feats = FrameFeatures(xy=uvr[:, :2], response=torch.ones((N,)), angle=torch.zeros((N,)),
                              level=torch.zeros((N,), dtype=torch.int32), desc=d,
                              valid=ok & (p_c[..., 2] > 0.5))
        return tr.StereoFrame(feats, p_c[..., 2] * feats.valid)

    none = -torch.ones((N,), dtype=torch.int32)
    T0 = lie.SE3.identity()
    d0 = desc()
    f0 = frame_at(T0, pts_w, d0)
    sig0 = signature_from_descriptors(d0, f0.feats.valid)
    m = sm.empty_map(16, 512, 2048, device="cpu")
    m = sm.insert_keyframe(m, K, T0, f0.feats, f0.depth, none, i32(0), sig0)
    for k in range(1, 8):
        T_k = lie.se3_exp(f32([5.0 * k, 0, 0, 0, 0, 0]))
        dk = desc()
        fk = frame_at(T_k, pts_w + 100.0, dk)
        m = sm.insert_keyframe(m, K, T_k, fk.feats, fk.depth, none, i32(k),
                               signature_from_descriptors(dk, fk.feats.valid))
    T_est = lie.compose(lie.se3_exp(f32(list(drift))), T0)
    map_id = i32(1 if second_map else 0)
    match = none
    if noise:
        spawned = f0.feats.valid & (f0.depth > 1e-3)
        match = torch.where(spawned, torch.cumsum(spawned.int(), 0) - 1, -1).to(torch.int32)
    m = sm.insert_keyframe(m, K, T_est, f0.feats, f0.depth, match, i32(8), sig0, map_id=map_id)
    if noise:
        jitter = torch.tensor(np.random.default_rng(seed + 1).normal(
            scale=noise, size=tuple(m.obs_uvr.shape)), dtype=torch.float32)
        jitter[:, 2] = torch.where(m.obs_uvr[:, 2] > 0, jitter[:, 0], 0.0)
        m = m._replace(obs_uvr=m.obs_uvr + jitter * m.obs_valid[:, None])
    state = tr.mark_keyframe(tr.init_track_state("cpu")._replace(T_cw=T_est, map_id=map_id),
                             i32(0))
    return SimpleNamespace(K=K, m=m, frame=f0, state=state, T_est=T_est, kf=8)


def _loop_cfg(cls=FitSlamConfig, **loop):
    cfg = cls()
    R = dataclasses.replace
    return R(cfg,
             camera=R(cfg.camera, width=320, height=240, fx=200.0, fy=200.0, cx=160.0,
                      cy=120.0, baseline=0.2),
             mapping=R(cfg.mapping, max_keyframes=16, max_landmarks=512, max_observations=2048),
             loop=R(cfg.loop, min_gap_keyframes=3, min_score=0.1, min_matches=20,
                    consistency_threshold=1, **loop))


def _to(tree, device):
    leaves, spec = jit.flatten(tree)
    return jit.unflatten(spec, [x.to(device) for x in leaves])


LOOPS = {"gba_retri": {}, "no_gba": dict(run_global_ba=False),
         "scale": dict(scale_search_halfrange=0.1, scale_search_points=5),
         "merge": dict(second_map=True)}


def _closed(capture, variant="gba_retri", device="cpu", refine=True, retrieve=False,
            drift=(0.5, 0.2, 0.0, 0.0, 0.0, 0.05), noise=0.0):
    """An engine on the revisit, its loop closed at keyframe 8 (retrieved
    here with ``retrieve``, else the step's candidate 0), then refined by
    ``refine_map(cycles=2, gba_iters=5)``. Returns (engine, record, chi2)."""
    loop = dict(LOOPS[variant])
    scene = _revisit(drift=drift, second_map=loop.pop("second_map", False), noise=noise)
    slam = StereoSlam(_loop_cfg(**loop), device, capture=capture)
    slam.map = _to(scene.m, device)
    slam.state = _to(scene.state, device)
    slam._track_initialized = slam._initialized = True
    slam.last_frame = _to(scene.frame, device)
    if retrieve:
        info = slam.loop_closer.on_keyframe(slam, scene.kf)
    else:
        info = slam.loop_closer.on_keyframe(slam, scene.kf, cand_idx=0, score=1.0)
    chi2 = slam.refine_map(cycles=2, gba_iters=5) if refine else None
    return slam, info, chi2


def _jax_leaf(x):
    """A port tensor (or SE3) as the reference's array (bfloat16 kept)."""
    import jax.numpy as jnp
    from fitslam_tpu.ops import lie as jlie

    if isinstance(x, lie.SE3):
        return jlie.SE3(_jax_leaf(x.R), _jax_leaf(x.t))
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _summary(closed):
    """What a closed revisit left, copied off its engine: the map, the
    tracker state, the record, refine_map's chi2, the loop edges' T_ij and
    the engine's slot and region statistics."""
    slam, info, chi2 = closed
    return SimpleNamespace(map=jit.clone(slam.map), state=jit.clone(slam.state), info=info,
                           chi2=chi2, edges=[e[2] for e in slam.loop_closer.loop_edges],
                           slot=slam._slot_state.slot, stats=slam.capture_stats)


def _same_closed(a, b):
    ia, ib = a.info, b.info
    assert ia is not None and ib is not None
    assert {k: v for k, v in ia.items() if not isinstance(v, torch.Tensor)} == \
        {k: v for k, v in ib.items() if not isinstance(v, torch.Tensor)}
    for k in ("pgo_chi2", "gba_chi2", "scale_correction"):
        assert (ia[k] is None) == (ib[k] is None), k
        if ia[k] is not None:
            assert torch.equal(ia[k], ib[k]), k
    assert _equal_trees(a.map, b.map) and _equal_trees(a.state, b.state)
    assert (a.chi2 is None) == (b.chi2 is None) and (a.chi2 is None or torch.equal(a.chi2, b.chi2))
    assert _equal_trees(a.edges, b.edges)


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


def _overlay_costmap():
    """A global costmap over two sources and two overlays."""
    cfg = FitSlamConfig()
    occ = torch.tensor(tsim.make_rooms_world(SPEC, seed=2))
    overlay = torch.zeros((64, 64), dtype=torch.bool)
    src = {"occ": occ, "overlay": overlay}
    cm = navx.Costmap(SPEC, cfg.costmaps.global_map, lambda: src["occ"],
                      lambda: src["overlay"])
    cm.grid()
    src["overlay"] = overlay.clone()
    src["overlay"][30:34, 10:20] = True
    src["occ"] = torch.where(occ == 0, torch.full_like(occ, 40), occ)
    cm.grid()
    return cm


def _record_runs():
    # the fleet's navs compose both costmaps and plan; its coordinator and
    # allocator run theirs
    keep = [_overlay_costmap(), run_multirobot.run(2, 6, "minpos", device="cpu", verbose=False)]
    owner = al.TaskAllocator("auction", device="cpu")
    for scale, eps in ((1.0, None), (2.0, None), (1.0, 0.05), (3.0, 0.02)):
        # more rows than feasible columns: every chunk up to max_rounds runs
        al.auction_assign(torch.tensor(_scarce() * scale), eps=eps, max_rounds=40,
                          state=owner.slot_state(4, 64))
    for variant in LOOPS:
        for drift in ((0.5, 0.2, 0.0, 0.0, 0.0, 0.05), (0.4, 0.1, 0.05, 0.0, 0.02, 0.0)):
            # each engine dead before the next: the next one takes its slot
            _closed(True, variant, retrieve=variant == "gba_retri",
                    refine=variant == "gba_retri", drift=drift)
    return keep, owner


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
        if not region.name.startswith(NEW):
            return real(fn, args)
        with _Recorder() as rec:
            result = real(fn, args)
        # a region of one name in slots of other keys (the local and the
        # global costmap) runs other operations: one record a slot
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


REGIONS = ["costmap", "costmap+overlay", "plan", "coordinator", "minpos", "auction_setup",
           "auction_setup+eps", "auction_chunk/16", "auction_chunk/8", "loop_detect",
           "loop_verify", "loop_correct+fuse+gba+retri", "loop_correct+fuse",
           "loop_correct+fuse+gba+scale", "loop_correct+merge+fuse+gba+retri",
           "refine_cycle/5/1.0"]


@pytest.mark.parametrize("region", REGIONS)
def test_regions_are_capture_safe(recorded, region):
    """Each new region, on two calls of different content, runs the same
    operations with the same output shapes and types, none of them a host
    read, a data-dependent shape or (after its first call, which fills the
    lazily built constant tables) an upload."""
    assert set(recorded) <= set(REGIONS), sorted(set(recorded) - set(REGIONS))
    slots = recorded[region]
    for seqs in slots.values():
        assert len(seqs) >= 2, (region, [len(q) for q in slots.values()])
        assert seqs[-2] == seqs[-1], f"region {region}: operations differ between two calls"
        bad = {op[0] for seq in seqs for op in seq if op[1] or op[0].startswith(FORBIDDEN)}
        assert not bad, f"region {region} holds {sorted(bad)}"
        uploads = {op[0] for seq in seqs[1:] for op in seq if op[0].startswith(UPLOADS)}
        assert not uploads, f"region {region} uploads host data at every call: {uploads}"


def test_rare_regions_run_eagerly_for_each_owners_first_calls():
    """A region given ``eager`` calls (the loop closer's, refine_map's
    cycle) counts them per owner: the slot's owner's first ``eager`` calls
    run eagerly and the next one captures; a new owner of the slot counts
    again, and once the region is captured every call replays."""
    class Owner:
        pass

    a, b = Owner(), Owner()
    slot, _ = jit.claim(a, "rare", "cpu", dict)
    region = jit.CapturedStep(jit.pure(lambda: torch.zeros(())), "rare", slot)
    region.eager = 2
    assert [region.eager_now() for _ in range(3)] == [True, True, False]
    del a                                        # the slot goes idle
    again, new = jit.claim(b, "rare", "cpu", dict)
    assert again is slot and not new
    assert [region.eager_now() for _ in range(3)] == [True, True, False]
    region.graph = object()                      # captured: no call runs eagerly
    assert not region.eager_now()
    del b
    jit.release_idle()


# ---------------------------------------------------------------------------
# (b) the controller
# ---------------------------------------------------------------------------


def test_sim_nav_through_buffers_equals_eager():
    got, want = _explore(True), _explore(False)
    assert len(got["record"]) == len(want["record"]) == NAV_STEPS
    for (pa, patha, na, sa), (pb, pathb, nb, sb) in zip(got["record"], want["record"]):
        np.testing.assert_array_equal(pa, pb)
        assert (patha is None) == (pathb is None)
        if patha is not None:
            np.testing.assert_array_equal(patha, pathb)
        assert na == nb and sa == sb
    assert got["nav"].plans >= 5 and got["nav"].plans == want["nav"].plans
    assert got["nav"].host_syncs == want["nav"].host_syncs
    stats = got["nav"].capture_stats
    # calls count from the slot's first owner (an earlier test's nav, maybe)
    assert stats["plan"]["calls"] >= got["nav"].plans and "global/costmap" in stats
    assert not want["nav"].capture_stats


def test_plan_equals_reference():
    """One plan through the buffers on a seeded G = 64 occupancy (free,
    costed, lethal and unknown cells) against the reference's
    clear_robot_footprint + wavefront_potential + descend_potential as JAX
    on the CPU: the path exactly."""
    jnp = pytest.importorskip("jax.numpy")
    from fitslam_tpu.models import nav as jnav
    from fitslam_tpu.ops import grid as jgrid

    rng = np.random.RandomState(5)
    occ = tsim.make_rooms_world(SPEC, seed=4).astype(np.uint8)
    occ = np.where((occ == 0) & (rng.rand(64, 64) < 0.2), rng.randint(1, 90, (64, 64)),
                   occ).astype(np.uint8)
    occ[40:, :20] = tg.UNKNOWN
    cfg = FitSlamConfig()
    robot = tsim.DiffDriveRobot(x=-5.0, y=-5.0, yaw=0.0)
    nav = SimNavInterface(cfg, SPEC, robot, lambda: torch.tensor(occ), device="cpu")
    nav.send_goal(np.array([5.2, 4.9]), 0.0)
    nav.step()
    assert nav.plans == 1 and nav.capture_stats["plan"]["calls"] == 1
    js = jgrid.GridSpec2D(*SPEC)
    grid, _ = nav.global_costmap.grid()
    robot_xy = jnp.asarray(np.float32([-5.0, -5.0]))
    occ_plan = jnav.clear_robot_footprint(js, jnp.asarray(grid.numpy()), robot_xy)
    pot = jnav.wavefront_potential(js, occ_plan, jnp.asarray(np.float32([5.2, 4.9])),
                                   iters=cfg.nav.wavefront_iters,
                                   allow_unknown=cfg.nav.allow_unknown)
    path, ok = jnav.descend_potential(js, pot, robot_xy)
    want = np.asarray(path)[np.asarray(ok)]
    assert len(want) > 20
    np.testing.assert_array_equal(nav._path, want)


def test_map_changes_reach_the_next_plan_and_held_grids_keep_their_values():
    occ = torch.tensor(tsim.make_rooms_world(SPEC, seed=1))
    overlay = torch.zeros((64, 64), dtype=torch.bool)
    src = {"occ": occ, "overlay": overlay}
    cfg = FitSlamConfig()
    navs = {c: SimNavInterface(cfg, SPEC, tsim.DiffDriveRobot(x=-5.0, y=-5.0, yaw=0.0),
                               lambda: src["occ"], get_overlay=lambda: src["overlay"],
                               device="cpu", capture=c) for c in (True, False)}
    paths = {c: [] for c in navs}
    held = {c: [] for c in navs}
    goal = np.array([3.1, -5.1])
    for change in ("none", "occupancy", "overlay"):
        if change == "occupancy":
            wall = occ.clone()
            wall[:, 26:28] = tg.LETHAL                    # a wall across the way
            wall[2:12, 26:28] = 0                         # with one wide door
            src["occ"] = wall
        elif change == "overlay":
            # the cells where the last plan crossed the door marked lethal
            rows = [int((y - SPEC.origin_y) / SPEC.resolution) for x, y in paths[True][-1]
                    if 26 <= int((x - SPEC.origin_x) / SPEC.resolution) < 28]
            assert rows and all(2 <= r < 12 for r in rows)
            src["overlay"] = overlay.clone()
            src["overlay"][min(rows) - 1:max(rows) + 2, 24:30] = True
        for c, nav in navs.items():
            nav.send_goal(goal, 0.0)
            nav.step()
            paths[c].append(nav._path.copy())
            g, _ = nav.global_costmap.grid()
            held[c].append((g, g.clone()))
    for c in navs:
        # each change moved the plan
        assert not np.array_equal(paths[c][0], paths[c][1])
        assert not np.array_equal(paths[c][1], paths[c][2])
        # a grid handed out before a recomposition keeps its values
        for g, copy in held[c]:
            assert torch.equal(g, copy)
        assert held[c][0][0] is not held[c][1][0] is not held[c][2][0]
    for a, b in zip(paths[True], paths[False]):
        np.testing.assert_array_equal(a, b)
    stats = navs[True].capture_stats
    assert stats["global/costmap+overlay"]["calls"] >= 3 and stats["plan"]["calls"] >= 3


# ---------------------------------------------------------------------------
# (c) the fleet
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(AUCTIONS))
def test_auction_through_buffers_equals_eager_and_reference(case):
    jnp = pytest.importorskip("jax.numpy")
    from fitslam_tpu.models import allocation as jal

    make, max_rounds = AUCTIONS[case]
    cost = make()
    got, stats, owner = _auction(cost, max_rounds, True)
    want, stats_e, _ = _auction(cost, max_rounds, False)
    np.testing.assert_array_equal(got, want)
    assert stats == stats_e
    assert stats["syncs"] == -(-stats["rounds"] // al.AUCTION_CHUNK) or stats["rounds"] == 0
    regions = owner.capture_stats
    assert {f"auction_setup@{cost.shape[0]}x{cost.shape[1]}"} <= set(regions)
    # the reference: the same assignment, and its while_loop's round count is
    # this one (cut one round earlier, it leaves a row unassigned)
    ref = lambda r: np.asarray(jal.auction_assign(jnp.asarray(cost), max_rounds=r))
    np.testing.assert_array_equal(got, ref(max_rounds))
    rounds = stats["rounds"]
    if case == "r_lt_f":
        assert 0 < rounds < max_rounds and (ref(rounds - 1) == -1).sum() > (got == -1).sum()
        np.testing.assert_array_equal(ref(rounds), got)
    else:
        assert rounds == max_rounds                 # the reference's loop runs to its cap
    if case == "cut_at_40":
        assert {"auction_chunk/16@16x64", "auction_chunk/8@16x64"} <= set(regions)


@pytest.mark.parametrize("R,allocator", [(2, "hungarian"), (2, "minpos"), (2, "auction"),
                                         (4, "hungarian"), (4, "minpos"), (4, "auction")])
def test_coordinator_ticks_through_buffers_equal_eager(R, allocator):
    (got, calls_g), (want, calls_w) = _fleet(R, allocator, True), _fleet(R, allocator, False)
    assert len(calls_g) == len(calls_w) == FLEET_TICKS
    for (cg, ag), (cw, aw) in zip(calls_g, calls_w):
        np.testing.assert_array_equal(cg, cw)
        np.testing.assert_array_equal(ag, aw)
    assert got["coord"].host_syncs == want["coord"].host_syncs
    for a, b in zip(got["robots"], want["robots"]):
        np.testing.assert_array_equal(np.array(a.trajectory), np.array(b.trajectory))
    stats = got["coord"].capture_stats
    assert stats["coordinator"]["calls"] == got["coord"].ticks
    if allocator != "hungarian":
        assert any(k.startswith("minpos" if allocator == "minpos" else "auction_chunk")
                   for k in stats)
    assert not want["coord"].capture_stats


# ---------------------------------------------------------------------------
# (d) loop closing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", sorted(LOOPS))
def test_loop_correction_and_refine_through_buffers_equal_eager(variant):
    jit.release_idle()
    retrieve = variant == "gba_retri"
    first = _summary(_closed(True, variant, retrieve=retrieve))
    want = _summary(_closed(False, variant, retrieve=retrieve))
    # the first engine is gone: the second takes its slot
    again = _summary(_closed(True, variant, retrieve=retrieve))
    assert again.slot is first.slot and want.slot is None
    _same_closed(first, want)
    _same_closed(again, want)
    correct = [k for k in again.stats if k.startswith("loop_correct")]
    assert len(correct) == 1 and again.stats["loop_verify"]["calls"] >= 2
    assert ("+merge" in correct[0]) == (variant == "merge")
    assert ("+gba" in correct[0]) == (variant != "no_gba")
    assert again.stats["refine_cycle/5/1.0"]["calls"] >= 4
    if variant == "merge":
        assert again.info["merged_maps"] == (1, 0) and int(again.state.map_id) == 0
        assert int(again.map.kf_map_id[8]) == 0
    # a record's device scalars stay as they were after later replays
    pgo = again.info["pgo_chi2"].clone()
    _closed(True, variant, drift=(0.3, 0.0, 0.1, 0.02, 0.0, 0.0))
    assert torch.equal(again.info["pgo_chi2"], pgo)


def test_loop_correction_through_buffers_equals_reference():
    """The captured engine's correction without GBA on the revisit beside
    the reference's closer on the same arrays (retrieval included):
    verify_loop's inliers exactly, keyframe poses after PGO within 1e-3 and
    PGO's chi2 within 1e-3 relative. (GBA is held to the reference through
    refine_map below: on this exact revisit its chi2 is float32 noise.)"""
    jnp = pytest.importorskip("jax.numpy")
    from fitslam_tpu.models import loop_closing as jlc
    from fitslam_tpu.models import slam_map as jsm
    from fitslam_tpu.models import tracking as jtr
    from fitslam_tpu.ops.geometry import Intrinsics as JIntrinsics
    from fitslam_tpu.ops.orb import FrameFeatures as JFeatures
    from fitslam_tpu.utils.config import FitSlamConfig as JConfig

    scene = _revisit()
    jx = lambda tree, cls: cls(*(_jax_leaf(getattr(tree, f)) for f in cls._fields))
    frame_j = jtr.StereoFrame(jx(scene.frame.feats, JFeatures), _jax_leaf(scene.frame.depth))
    state_j = jtr.mark_keyframe(jtr.init_track_state()._replace(T_cw=_jax_leaf(scene.T_est)),
                                jnp.int32(0))
    K_j = JIntrinsics(*(jnp.float32(float(v)) for v in scene.K))
    closer_j = jlc.LoopCloser(_loop_cfg(JConfig, run_global_ba=False), K_j)
    slam_j = SimpleNamespace(map=jx(scene.m, jsm.SlamMap), last_frame=frame_j, state=state_j)
    info_j = closer_j.on_keyframe(slam_j, scene.kf)

    slam, info, _ = _closed(True, "no_gba", refine=False, retrieve=True)
    assert info["inliers"] == info_j["inliers"] > 50
    assert info["gba_chi2"] is None
    np.testing.assert_allclose(slam.map.kf_T_cw.t.numpy(), np.asarray(slam_j.map.kf_T_cw.t),
                               atol=PGO_TOL)
    np.testing.assert_allclose(slam.map.kf_T_cw.R.numpy(), np.asarray(slam_j.map.kf_T_cw.R),
                               atol=PGO_TOL)
    np.testing.assert_allclose(float(info["pgo_chi2"]), float(info_j["pgo_chi2"]),
                               rtol=CHI2_RTOL, atol=1e-4)


def test_refine_map_through_buffers_equals_reference():
    """refine_map(cycles=2, gba_iters=5) (re-triangulation and GBA) through
    the buffers on the revisit with 0.5 px of pixel noise and keyframe 8
    re-observing keyframe 0's landmarks, beside the reference's refine_map on
    the same map (its engine's ``map`` replaced): poses within 1e-3, GBA's
    chi2 within 1e-2 relative."""
    pytest.importorskip("jax")
    from fitslam_tpu.models import slam as jslam
    from fitslam_tpu.utils.config import FitSlamConfig as JConfig

    scene = _revisit(noise=0.5)
    slam, _, chi2 = _closed(True, "no_gba", refine=False, noise=0.5)
    before = jit.clone(slam.map)
    chi2 = slam.refine_map(cycles=2, gba_iters=5)
    ref = jslam.StereoSlam(_loop_cfg(JConfig))
    ref.map = type(ref.map)(*(_jax_leaf(getattr(before, f)) for f in ref.map._fields))
    ref.state = ref.state._replace(T_cw=_jax_leaf(slam.state.T_cw))
    chi2_j = ref.refine_map(cycles=2, gba_iters=5)
    np.testing.assert_allclose(slam.map.kf_T_cw.t.numpy(), np.asarray(ref.map.kf_T_cw.t),
                               atol=PGO_TOL)
    assert float(chi2_j) > 1.0                     # pixel noise, not float32 noise
    np.testing.assert_allclose(float(chi2), float(chi2_j), rtol=GBA_RTOL)
    assert scene.kf == int(slam.map.n_kf) - 1


# ---------------------------------------------------------------------------
# (e) on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_captured_equals_eager_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    dev = torch.device("cuda", 0)
    runs = []
    for capture in (False, True):
        sweeps = pallas_grid.wavefront_sweeps.launches
        r = _explore(capture, device=dev)
        torch.cuda.synchronize()
        runs.append((r, pallas_grid.wavefront_sweeps.launches - sweeps))
    (eager, n_eager), (captured, n_captured) = runs
    assert captured["nav"].capture_stats["plan"]["captured"]
    for a, b in zip(eager["record"], captured["record"]):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[2:] == b[2:]
    assert n_eager == n_captured > 0

    for case, (make, max_rounds) in AUCTIONS.items():
        cost = make()
        want, stats_w, _ = _auction(cost, max_rounds, False, dev)
        for _ in range(3):                       # warm-up, capture, replay
            got, stats_g, owner = _auction(cost, max_rounds, True, dev)
            np.testing.assert_array_equal(got, want)
            assert stats_g == stats_w, case
    assert any(s["captured"] for s in owner.capture_stats.values())

    fleets = [_fleet(2, "auction", c, dev) for c in (False, True)]
    for (cw, aw), (cg, ag) in zip(fleets[0][1], fleets[1][1]):
        np.testing.assert_array_equal(cw, cg)
        np.testing.assert_array_equal(aw, ag)
    assert fleets[1][0]["coord"].capture_stats["coordinator"]["captured"]

    top2 = pallas_matching.hamming_top2.launches
    want = _summary(_closed(False, device=dev))
    n_eager = pallas_matching.hamming_top2.launches - top2
    # by default a fresh engine's loop regions and refine cycles run eagerly
    got = _summary(_closed(True, device=dev))
    _same_closed(got, want)
    assert not any(s["captured"] for k, s in got.stats.items()
                   if k.startswith(("loop_", "refine_cycle")))
    # captured from an engine's first correction on (warm-up, capture,
    # replay), and refine_map's second cycle (the first eager)
    monkeypatch.setattr(loop_closing, "EAGER_CALLS", 0)
    monkeypatch.setattr(slam_module, "REFINE_EAGER_CYCLES", 1)
    jit.release_idle()
    for _ in range(3):                           # warm-up, capture, replay
        top2 = pallas_matching.hamming_top2.launches
        got = _summary(_closed(True, device=dev))
        assert pallas_matching.hamming_top2.launches - top2 == n_eager > 0
        _same_closed(got, want)
    assert got.stats["loop_correct+fuse+gba+retri"]["captured"]
    assert got.stats["refine_cycle/5/1.0"]["captured"]
