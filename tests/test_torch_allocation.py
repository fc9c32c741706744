"""The port's multi-robot task allocation (``models/allocation.py``) and
shared-map fleet (``run_multirobot.py``) against the reference on the CPU:
the counterparts of every case of tests/test_allocation.py, then each solver,
the allocator and the coordinator's tick beside the reference on the same
inputs, and the two-rover run through both packages.

Tolerances: every assignment exactly equal (Hungarian, auction, MinPos,
the allocator, the coordinator); the Voronoi labels exactly equal at robot
positions where no cell centre is equidistant from two robots (at a
symmetric position a tie's label follows the last bit of two square roots,
which the two packages may round apart); the coordinator's cost matrix
within 1e-4 (wavefront sums in float32); the two-rover runs' final
coverages within 0.02 of each other, with every tick of the first 10
assigning the same goals.
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitslam_tpu.models import allocation as jal
from fitslam_tpu.models import sim_robot as jsim
from fitslam_tpu.models.sim_nav import SimNavInterface as JNav
from fitslam_tpu.ops import grid as jgr
from fitslam_tpu.utils.config import FitSlamConfig as JConfig
from fitslam_tpu_torch import run_multirobot
from fitslam_tpu_torch.models import allocation as al
from fitslam_tpu_torch.models import sim_robot as sim
from fitslam_tpu_torch.ops import grid as gr
from fitslam_tpu_torch.utils.evaluation import coverage_fraction

torch.set_num_threads(2)

SPEC = gr.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)
JSPEC = jgr.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)
PARITY_TICKS = 10


def brute_force(cost):
    R, F = cost.shape
    best, best_cost = None, np.inf
    for perm in itertools.permutations(range(F), R):
        c = sum(cost[r, perm[r]] for r in range(R))
        if c < best_cost:
            best_cost, best = c, perm
    return np.array(best), best_cost


def _problem(seed, R, F, forbid=0.0, contended=False):
    """Uniform costs with a share of forbidden entries; or, contended, every
    row preferring the same columns, so the auction runs for dozens of
    rounds (several chunks)."""
    r = np.random.RandomState(seed)
    cost = r.uniform(0, 10, (R, F))
    if contended:
        cost = np.linspace(0, 10, F)[None, :] + cost / 20
    cost = cost.astype(np.float32)
    cost[r.rand(R, F) < forbid] = al.BIG
    return cost


# ---------------------------------------------------------------------------
# tests/test_allocation.py's cases through the port
# ---------------------------------------------------------------------------


def test_hungarian_matches_brute_force():
    rng = np.random.RandomState(0)
    for _ in range(20):
        R, F = rng.randint(2, 5), rng.randint(4, 7)
        cost = rng.uniform(0, 10, (R, F))
        a = al.hungarian_assign(cost)
        _, opt = brute_force(cost)
        got = cost[np.arange(R), a].sum()
        assert np.isclose(got, opt, atol=1e-9), (got, opt)


def test_hungarian_forbidden_column():
    cost = np.array([[1.0, al.BIG], [al.BIG, al.BIG]])
    a = al.hungarian_assign(cost)
    assert a[0] == 0 and a[1] == -1


def test_auction_near_optimal():
    for seed in range(10):
        cost = _problem(seed, 3, 6)
        R, F = cost.shape
        a = al.auction_assign(torch.tensor(cost)).numpy()
        assert (a >= 0).all()
        assert len(set(a.tolist())) == R            # one object per bidder
        _, opt = brute_force(cost)
        got = cost[np.arange(R), a].sum()
        # eps-optimality: within R * (range / 4F) of the true optimum
        assert got <= opt + R * 10.0 / (4 * F) + 1e-4, (got, opt)


def test_auction_unassignable_row():
    cost = torch.tensor(np.array([[1.0, 2.0], [al.BIG, al.BIG], [3.0, 1.0]], np.float32))
    a = al.auction_assign(cost).numpy()
    assert a[1] == -1
    assert a[0] >= 0 and a[2] >= 0 and a[0] != a[2]


def test_minpos_rank_semantics():
    # robot 0 closest to frontier 0; robot 1 closest to frontier 1
    a = al.minpos_assign(torch.tensor([[1.0, 5.0], [4.0, 2.0]])).numpy()
    assert a.tolist() == [0, 1]
    # all frontiers infeasible for robot 1
    a = al.minpos_assign(torch.tensor([[1.0, 2.0], [al.BIG, al.BIG]])).numpy()
    assert a[0] == 0 and a[1] == -1


def test_voronoi_partition_covers_and_separates():
    spec = gr.GridSpec2D(size=32, resolution=0.5, origin_x=-8.0, origin_y=-8.0)
    xy = torch.tensor([[-4.0, 0.0], [4.0, 0.0]])
    lbl = al.voronoi_partition(spec, xy, torch.ones(2, dtype=torch.bool)).numpy()
    assert set(np.unique(lbl)) == {0, 1}
    # left half belongs to robot 0, right half to robot 1
    assert (lbl[:, :8] == 0).all()
    assert (lbl[:, 24:] == 1).all()


def test_goal_sharing_penalty():
    alloc = al.TaskAllocator(method="hungarian", share_radius_m=1.0, device="cpu")
    cost = np.array([[1.0, 2.0]])
    fxy = np.array([[0.0, 0.0], [5.0, 0.0]])
    # a peer already drives at frontier 0 -> robot must take frontier 1
    a = alloc.allocate(cost, fxy, peer_goals=[np.array([0.2, 0.1])])
    assert a[0] == 1


# ---------------------------------------------------------------------------
# Each solver beside the reference
# ---------------------------------------------------------------------------


def test_hungarian_equals_reference():
    rng = np.random.RandomState(3)
    for _ in range(20):
        R, F = rng.randint(1, 9), rng.randint(8, 20)
        cost = rng.uniform(0, 10, (R, F))
        cost[rng.rand(R, F) < 0.15] = al.BIG
        np.testing.assert_array_equal(al.hungarian_assign(cost), jal.hungarian_assign(cost))


@pytest.mark.parametrize("shape,forbid,contended,seeds", [
    ((3, 6), 0.0, False, range(10)), ((16, 64), 0.3, False, range(4)),
    ((16, 64), 0.1, True, range(4))])
def test_auction_equals_reference(shape, forbid, contended, seeds, monkeypatch):
    for seed in seeds:
        cost = _problem(seed, *shape, forbid=forbid, contended=contended)
        stats = {}
        got = al.auction_assign(torch.tensor(cost), stats=stats).numpy()
        np.testing.assert_array_equal(got, np.asarray(jal.auction_assign(jnp.asarray(cost))))
        # one read a chunk of rounds
        assert stats["syncs"] == max(1, -(-stats["rounds"] // al.AUCTION_CHUNK))
        # the chunk changes no answer: one round between reads gives the same
        with monkeypatch.context() as m:
            m.setattr(al, "AUCTION_CHUNK", 1)
            np.testing.assert_array_equal(al.auction_assign(torch.tensor(cost)).numpy(), got)


def test_auction_stops_at_max_rounds_as_reference():
    """A cut loop: the chunks stop at exactly max_rounds, as the reference's
    while_loop does, mid-auction."""
    cost = _problem(7, 16, 64, forbid=0.1, contended=True)
    for max_rounds in (1, 3, 17, 40):
        stats = {}
        got = al.auction_assign(torch.tensor(cost), max_rounds=max_rounds, stats=stats).numpy()
        ref = np.asarray(jal.auction_assign(jnp.asarray(cost), max_rounds=max_rounds))
        np.testing.assert_array_equal(got, ref)
        assert stats["rounds"] == max_rounds        # every cut falls mid-auction


def test_auction_with_fewer_reachable_columns_than_rows_mirrors_reference():
    """More rows than feasible columns: the rows left over keep bidding, so
    the auction runs to max_rounds in both packages (ROADMAP F6), and
    returns the same partial assignment. The port reads its condition once a
    chunk: 1024 / 16 reads."""
    cost = np.full((4, 64), al.BIG, np.float32)
    cost[:, 3] = [1.0, 2.0, 3.0, 4.0]
    cost[:, 9] = [4.0, 3.0, 2.0, 1.0]
    stats = {}
    got = al.auction_assign(torch.tensor(cost), stats=stats).numpy()
    np.testing.assert_array_equal(got, np.asarray(jal.auction_assign(jnp.asarray(cost))))
    assert got.tolist() == [-1, 3, 9, -1]
    assert stats == {"rounds": 1024, "syncs": 1024 // al.AUCTION_CHUNK}


@pytest.mark.parametrize("seed", range(4))
def test_minpos_equals_reference(seed):
    rng = np.random.RandomState(seed)
    dist = rng.uniform(0, 12, (4, 32)).astype(np.float32)
    dist[rng.rand(4, 32) < 0.2] = al.BIG
    dist[:, 5] = dist[0, 5]             # a column where every robot ties
    np.testing.assert_array_equal(al.minpos_assign(torch.tensor(dist)).numpy(),
                                  np.asarray(jal.minpos_assign(jnp.asarray(dist))))


def test_minpos_coarsening_mirrors_reference():
    """ROADMAP F6: at rank >= 1 the float32 score rounds the distance away,
    so robot 0 takes the frontier 7 m away over the one 3 m away."""
    dist = np.array([[7.0, 3.0], [1.0, 1.0]], np.float32)
    ref = np.asarray(jal.minpos_assign(jnp.asarray(dist)))
    assert ref.tolist() == [0, 0]
    assert al.minpos_assign(torch.tensor(dist)).numpy().tolist() == [0, 0]


@pytest.mark.parametrize("xy,valid", [
    ([[-4.1, 0.3], [3.7, 0.2]], [True, True]),
    ([[-5.3, -2.9], [4.4, 3.3], [0.7, 6.1]], [True, True, True]),
    ([[-5.3, -2.9], [4.4, 3.3], [0.7, 6.1]], [True, False, True]),
    ([[1.1, 1.3]], [False]),
])
def test_voronoi_equals_reference_at_asymmetric_positions(xy, valid):
    xy = np.array(xy, np.float32)
    valid = np.array(valid)
    got = al.voronoi_partition(SPEC, torch.tensor(xy), torch.tensor(valid)).numpy()
    ref = np.asarray(jal.voronoi_partition(JSPEC, jnp.asarray(xy), jnp.asarray(valid)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("method", ["hungarian", "minpos", "auction"])
def test_task_allocator_with_peer_goals_equals_reference(method):
    rng = np.random.RandomState(5)
    cost = rng.uniform(0, 10, (3, 24)).astype(np.float32)
    fxy = rng.uniform(-6, 6, (24, 2)).astype(np.float32)
    peers = [fxy[2] + 0.3, fxy[9] - 0.2]
    port = al.TaskAllocator(method=method, device="cpu")
    got = port.allocate(cost, fxy, peer_goals=peers)
    ref = jal.TaskAllocator(method=method).allocate(cost, fxy, peer_goals=peers)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert not {2, 9} & set(got.tolist())
    # the host reads back: none for the host Hungarian, one result read for
    # MinPos, the chunk reads and the result read for the auction
    expect = {"hungarian": 0, "minpos": 1}.get(method)
    if expect is not None:
        assert port.host_syncs == expect
    else:
        assert port.host_syncs >= 2 and len(port.auction_rounds) == 1


# ---------------------------------------------------------------------------
# The coordinator and the two-rover run beside the reference
# ---------------------------------------------------------------------------


def _ref_config(method):
    cfg = JConfig()
    return dataclasses.replace(
        cfg,
        nav=dataclasses.replace(cfg.nav, wavefront_iters=192, desired_speed=1.0),
        multi_robot=dataclasses.replace(cfg.multi_robot, allocator=method))


class _Recorder:
    """Wraps a TaskAllocator class's ``allocate`` to keep each call's cost
    matrix and assignment."""

    def __init__(self, monkeypatch, cls):
        self.calls = []
        real = cls.allocate

        def allocate(alloc, cost, fxy, peer_goals=None):
            a = real(alloc, cost, fxy, peer_goals)
            self.calls.append((np.array(cost, np.float32), np.asarray(a).astype(np.int64)))
            return a

        monkeypatch.setattr(cls, "allocate", allocate)


class _StillNav:
    """A nav that never moves: the coordinator's goals are only recorded."""

    def __init__(self):
        self.goals = []

    def send_goal(self, goal, heading):
        self.goals.append(np.asarray(goal))

    def cancel(self):
        pass

    def status(self):
        from fitslam_tpu_torch.models.exploration import GoalStatus

        return GoalStatus.NONE


@pytest.mark.parametrize("method", ["hungarian", "minpos", "auction"])
def test_coordinator_tick_equals_reference(method, monkeypatch):
    """One tick on the same partly explored map and poses: the cost matrix
    within 1e-4, the same assignment and the same goals sent."""
    gt = sim.make_rooms_world(SPEC, seed=2)
    explored = torch.full((64, 64), gr.UNKNOWN, dtype=torch.uint8)
    poses = [(np.array([-5.0, -5.0]), 0.0), (np.array([4.6, 5.2]), 3.0),
             (np.array([-4.4, 4.9]), -1.5)]
    for xy, _ in poses:
        explored = sim.reveal_sensor(SPEC, torch.tensor(gt), explored,
                                     torch.tensor(xy, dtype=torch.float32), range_m=3.0)
    rec_t = _Recorder(monkeypatch, al.TaskAllocator)
    rec_j = _Recorder(monkeypatch, jal.TaskAllocator)
    navs_t, navs_j = [_StillNav() for _ in poses], [_StillNav() for _ in poses]
    cfg = run_multirobot.fleet_config(method)
    coord = al.MultiRobotCoordinator(cfg, SPEC, lambda: explored, navs_t, lambda: poses,
                                     device="cpu")
    jcoord = jal.MultiRobotCoordinator(_ref_config(method), JSPEC,
                                       lambda: jnp.asarray(explored.numpy()), navs_j,
                                       lambda: poses)
    coord.tick()
    jcoord.tick()
    (ct, at), (cj, aj) = rec_t.calls[0], rec_j.calls[0]
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-4)
    assert (cj < al.BIG / 2).sum() > 10
    np.testing.assert_array_equal(at, aj)
    for nt, nj in zip(navs_t, navs_j):
        assert len(nt.goals) == len(nj.goals) == 1
        np.testing.assert_array_equal(nt.goals[0], nj.goals[0])
    # the goals and the cost matrix in one read a tick, plus the solver's
    assert coord.host_syncs == 1 + coord.allocator.host_syncs


def _ref_run(method, steps=120):
    """tests/test_allocation.py's two-rover loop through the reference."""
    cfg = _ref_config(method)
    gt = jnp.asarray(jsim.make_rooms_world(JSPEC, seed=2))
    state = {"explored": jnp.full((64, 64), jgr.UNKNOWN, jnp.uint8)}
    robots = [jsim.DiffDriveRobot(x=-5.0, y=-5.0, yaw=0.0, v_max=1.2, w_max=2.5),
              jsim.DiffDriveRobot(x=5.0, y=5.0, yaw=3.0, v_max=1.2, w_max=2.5)]
    navs = [JNav(cfg, JSPEC, r, lambda: state["explored"], dt=0.15) for r in robots]
    for n in navs:
        n.controller.max_omega = 2.0
    coord = jal.MultiRobotCoordinator(cfg, JSPEC, lambda: state["explored"], navs,
                                      get_poses=lambda: [(r.xy, r.yaw) for r in robots])
    for step in range(steps):
        for r in robots:
            state["explored"] = jsim.reveal_sensor(
                JSPEC, gt, state["explored"], jnp.asarray(r.xy, jnp.float32), range_m=3.0)
        if step % 2 == 0:
            coord.tick()
        for _ in range(3):
            for n in navs:
                n.step()
        if coord.done:
            break
    return coverage_fraction(np.asarray(state["explored"]) != jgr.UNKNOWN), robots


@pytest.fixture(scope="module", params=["hungarian", "minpos"])
def two_rover_runs(request):
    method = request.param
    mp = pytest.MonkeyPatch()
    try:
        rec_t = _Recorder(mp, al.TaskAllocator)
        rec_j = _Recorder(mp, jal.TaskAllocator)
        port = run_multirobot.run(2, 120, method, seed=2, device="cpu", verbose=False)
        ref_cov, ref_robots = _ref_run(method)
    finally:
        mp.undo()
    return method, port, rec_t.calls, ref_cov, ref_robots, rec_j.calls


def test_two_rover_shared_map_exploration(two_rover_runs):
    """tests/test_allocation.py's bounds on the port's run."""
    _, port, _, _, _, _ = two_rover_runs
    known = port["explored"] != gr.UNKNOWN
    assert coverage_fraction(known) > 0.4
    # both rovers contributed motion
    for r in port["robots"]:
        traj = np.array([(x, y) for x, y, _ in r.trajectory])
        assert np.ptp(traj[:, 0]) + np.ptp(traj[:, 1]) > 1.5


def test_two_rover_run_equals_reference(two_rover_runs):
    method, port, calls_t, ref_cov, _, calls_j = two_rover_runs
    assert len(calls_t) >= PARITY_TICKS and len(calls_j) >= PARITY_TICKS
    for k in range(PARITY_TICKS):
        (ct, at), (cj, aj) = calls_t[k], calls_j[k]
        np.testing.assert_array_equal(at, aj, err_msg=f"{method} tick {k}")
        np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-4, err_msg=f"{method} tick {k}")
    got = float(port["coverage"][-1])
    print(f"{method}: final coverage port {got:.4f}, reference {ref_cov:.4f}")
    assert abs(got - ref_cov) <= 0.02
    # one read a tick for the goals and the cost matrix, plus the solver's
    coord = port["coord"]
    assert coord.host_syncs == coord.ticks + coord.allocator.host_syncs


def test_run_multirobot_entry_point_equals_reference_example(tmp_path):
    """``python -m fitslam_tpu_torch.run_multirobot --cpu --record DIR`` and
    the reference's examples/run_multirobot.py with the same arguments: both
    exit 0, and the rendered fleet.ppm files are byte-equal."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    args = ["--cpu", "--steps", "40", "--robots", "3"]
    port = subprocess.run([sys.executable, "-m", "fitslam_tpu_torch.run_multirobot", *args,
                           "--record", str(tmp_path / "port")], cwd=root,
                          capture_output=True, text=True, timeout=300)
    ref = subprocess.run([sys.executable, str(root / "examples" / "run_multirobot.py"), *args,
                          "--record", str(tmp_path / "ref")], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert port.returncode == 0, port.stderr[-2000:]
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert "final coverage" in port.stdout
    assert (tmp_path / "port" / "fleet.ppm").read_bytes() == \
        (tmp_path / "ref" / "fleet.ppm").read_bytes()
