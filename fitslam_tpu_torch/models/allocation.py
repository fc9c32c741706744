"""Multi-robot task allocation: assignment solvers and the shared-map
coordinator (port of ``fitslam_tpu/models/allocation.py``).

- ``hungarian_assign``: the exact host-side shortest-augmenting-path
  Hungarian, a numpy copy of the reference's;
- ``auction_assign``: Bertsekas' forward auction on device tensors. The
  reference's ``lax.while_loop`` becomes a host loop over fixed chunks of
  rounds with one read of the loop's condition a chunk: once the condition
  is false a round changes nothing (no row bids, owner and price stay), so
  the extra rounds of the last chunk are no-ops, and the chunks stop at
  exactly ``max_rounds``;
- ``minpos_assign``: MinPos ranks, with the reference's float32 score
  ``rank * BIG / 4 + dist``, which rounds ``dist`` away at rank >= 1 (ROADMAP
  F6: equal ranks then fall to the first index, mirrored);
- ``voronoi_partition``: the nearest valid robot of each grid cell;
- ``TaskAllocator``: the cost matrix with the peer-goal penalty, then one
  solver;
- ``MultiRobotCoordinator``: one frontier search from the fleet's centroid,
  one wavefront (K3) a robot, one assignment a tick. The (R, F) cost matrix
  is gathered on the device and read back once with the frontiers' goals.

Every read back to the host is counted (ROADMAP F8): ``host_syncs`` of the
allocator and of the coordinator, and the auction's rounds and chunk reads
in the ``stats`` dict a caller passes.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fitslam_tpu_torch.models import nav as navx
from fitslam_tpu_torch.models.exploration import GoalStatus
from fitslam_tpu_torch.ops import frontier as fx
from fitslam_tpu_torch.ops.grid import GridSpec2D
from fitslam_tpu_torch.ops.numerics import div_const, fma32
from fitslam_tpu_torch.utils import jit, profiling
from fitslam_tpu_torch.utils.transfer import upload

BIG = 1e9
# rounds of the auction between two reads of its loop condition
AUCTION_CHUNK = 16


# ---------------------------------------------------------------------------
# Exact Hungarian (host): shortest augmenting path with potentials, O(n^3).
# ---------------------------------------------------------------------------

def hungarian_assign(cost: np.ndarray) -> np.ndarray:
    """Minimum-cost assignment of R rows to F columns (R <= F).

    Returns (R,) column index per row, -1 where a row has no finite-cost
    column. Entries >= BIG/2 are treated as forbidden.
    """
    cost = np.asarray(cost, np.float64)
    R, F = cost.shape
    assert R <= F, "more rows than columns; transpose first"
    INF = float("inf")
    c = np.where(cost >= BIG / 2, INF, cost)

    # Jonker-Volgenant style: u[i], v[j] potentials; p[j] = row matched to j.
    u = np.zeros(R + 1)
    v = np.zeros(F + 1)
    p = np.full(F + 1, R)        # F is a virtual "free" column slot at index F
    way = np.zeros(F + 1, np.int64)
    for i in range(R):
        p[F] = i
        j0 = F
        minv = np.full(F + 1, INF)
        used = np.zeros(F + 1, bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            delta = INF
            j1 = -1
            for j in range(F):
                if used[j]:
                    continue
                cur = c[i0, j] - u[i0] - v[j]
                if cur < minv[j]:
                    minv[j] = cur
                    way[j] = j0
                if minv[j] < delta:
                    delta = minv[j]
                    j1 = j
            if not np.isfinite(delta):
                # row unassignable through any augmenting path
                j1 = -1
                break
            for j in range(F + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == R:
                break
        if j1 == -1:
            continue
        while j0 != F:
            j2 = way[j0]
            p[j0] = p[j2]
            j0 = j2
    out = np.full(R, -1, np.int64)
    for j in range(F):
        if p[j] != R and np.isfinite(c[p[j], j]):
            out[p[j]] = j
    return out


# ---------------------------------------------------------------------------
# Auction algorithm (device)
# ---------------------------------------------------------------------------

def _rows_assigned(owner: torch.Tensor, R: int) -> torch.Tensor:
    """(R,) bool: rows that own an object. Unowned objects route to an extra
    slot R, sliced off (the reference's dropped out-of-bounds index)."""
    idx = torch.where(owner >= 0, owner, R).long()
    out = torch.zeros(R + 1, dtype=torch.bool, device=owner.device)
    return out.index_fill_(0, idx, True)[:R]


def auction_setup_region(owner, price, rounds, cost, eps=None):
    """Region ``auction_setup[+eps]``: the auction's constants from the
    (R, F) ``cost`` (value, feasibility, the rows that must be assigned and
    eps: the given 0-d one, else cost_range / (4F)); writes the cleared
    ``owner``, ``price`` and ``rounds``."""
    F = cost.shape[1]
    cost = cost.to(torch.float32)
    feasible = cost < BIG / 2
    if eps is None:
        fin = torch.where(feasible, cost, 0.0)
        rng_c = fin.amax() - torch.where(feasible, cost, BIG).amin()
        eps = div_const(torch.clamp_min(rng_c, 1e-3), 4.0 * F)
    consts = (-cost, feasible, feasible.any(dim=1), eps)      # maximize value
    return (torch.full_like(owner, -1), torch.zeros_like(price), torch.zeros_like(rounds)), consts


def auction_chunk_region(owner, price, rounds, value, feasible, must_assign, eps, *, n: int):
    """Region ``auction_chunk/n``: ``n`` rounds of the auction (a round
    after convergence changes nothing: no row bids). Writes ``owner``,
    ``price`` and ``rounds``; returns ([more rounds needed, rounds] int32,
    the (R,) int32 assignment so far)."""
    R, F = value.shape
    dev = value.device
    cols = torch.arange(F, device=dev)
    rows = torch.arange(R, dtype=torch.int32, device=dev)
    for _ in range(n):
        assigned_rows = _rows_assigned(owner, R)
        bids_ok = ~assigned_rows & must_assign
        rounds = rounds + bids_ok.any().to(torch.int32)
        gain = torch.where(feasible, value - price[None, :], -BIG)   # (R, F)
        best_j = torch.argmax(gain, dim=1)     # the first of equal maxima
        best = gain.amax(dim=1)
        second = torch.where(cols[None, :] == best_j[:, None], -BIG, gain).amax(dim=1)
        bid = price[best_j] + (best - torch.clamp_min(second, -BIG / 2)) + eps
        # each object keeps the single highest bid
        bid_val = torch.where(bids_ok, bid, -BIG)
        obj_best_bid = torch.full((F,), -BIG, device=dev).scatter_reduce(
            0, best_j, bid_val, "amax")
        wins = bids_ok & (bid_val >= obj_best_bid[best_j] - 1e-12)
        # tie-break: lowest row index wins; losers route to slot F
        first_winner = torch.full((F + 1,), R, dtype=torch.int32, device=dev).scatter_reduce(
            0, torch.where(wins, best_j, F), torch.where(wins, rows, R), "amin")[:F]
        won = first_winner < R
        owner = torch.where(won, first_winner, owner)
        price = torch.where(won, obj_best_bid, price)
    # the reference's loop condition and the round count
    more = (must_assign & ~_rows_assigned(owner, R)).any()
    idx = torch.where(owner >= 0, owner, R).long()
    out = torch.full((R + 1,), -1, dtype=torch.int32, device=dev)
    assign = out.scatter_(0, idx, torch.arange(F, dtype=torch.int32, device=dev))[:R]
    return (owner, price, rounds), (torch.stack([more.to(torch.int32), rounds]), assign)


def auction_state(R: int, F: int, device) -> Dict[str, torch.Tensor]:
    """The auction's state (owner, price, rounds) for an (R, F) problem."""
    return {"owner": torch.full((F,), -1, dtype=torch.int32, device=device),
            "price": torch.zeros((F,), dtype=torch.float32, device=device),
            "rounds": torch.zeros((), dtype=torch.int32, device=device)}


def auction_assign(
    cost: torch.Tensor,           # (R, F) float32; >= BIG/2 = forbidden
    eps: Optional[float] = None,
    max_rounds: int = 1024,
    stats: Optional[Dict[str, int]] = None,
    state: Optional[jit.SlotState] = None,
) -> torch.Tensor:
    """Bertsekas forward auction for min-cost assignment (R <= F).

    All unassigned bidders bid simultaneously each round; each object goes to
    its highest bidder (ties: the lowest row). eps-complementary-slackness
    gives a solution within R*eps of optimal; eps defaults to
    cost_range/(4F). Returns (R,) int32 column per row (-1 unassignable) on
    the cost's device. The loop condition is read once every
    ``AUCTION_CHUNK`` rounds, with the count of rounds in which a row bid (the reference's
    loop count); ``stats`` (if given) receives that count (``rounds``) and
    the reads (``syncs``). With ``state`` (a ``jit.SlotState`` holding
    ``auction_state(R, F)``, as ``TaskAllocator`` keeps one) the set-up and
    each chunk of rounds run as its captured regions; without it, eagerly."""
    R, F = cost.shape
    if state is None:
        run, keep, st = jit.run_eagerly, (lambda t: t), auction_state(R, F, cost.device)
    else:
        run, st = state.run, state
        keep = state.claim().snapshot if state.capture else (lambda t: t)
    extra = () if eps is None else (upload([eps], cost.device, torch.float32).reshape(()),)
    (owner, price, rounds, *_), consts = run(
        "auction_setup" + ("+eps" if extra else ""), auction_setup_region,
        st["owner"], st["price"], st["rounds"], cost, *extra)
    done_rounds, syncs = 0, 0
    while done_rounds < max_rounds:
        chunk = min(AUCTION_CHUNK, max_rounds - done_rounds)
        (owner, price, rounds, *_), (flags, assign) = run(
            f"auction_chunk/{chunk}", functools.partial(auction_chunk_region, n=chunk),
            owner, price, rounds, *consts)
        done_rounds += chunk
        # the reference's loop condition and the round count, read once a chunk
        with profiling.host_read("auction_assign.chunk", flags.device):
            more_n, rounds_n = flags.cpu().tolist()
        syncs += 1
        if not more_n:
            break
    if stats is not None:
        stats["rounds"] = rounds_n
        stats["syncs"] = syncs
    return keep(assign)


# ---------------------------------------------------------------------------
# MinPos (rank-based greedy, Bautin et al.)
# ---------------------------------------------------------------------------

def minpos_assign(dist: torch.Tensor) -> torch.Tensor:
    """Each robot picks the frontier where the number of closer robots is
    minimal, "ties by own distance" as the reference promises; but its
    float32 score ``rank * BIG / 4 + dist`` has a step of 16 near 2.5e8, so at
    rank >= 1 ``dist`` is rounded away and equal ranks fall to the first
    index (ROADMAP F6; ``[[7, 3], [1, 1]]`` gives [0, 0]), mirrored here.
    (R, F) -> (R,) int32; -1 if no finite frontier. Robots may share a
    frontier: that is MinPos semantics."""
    dist = dist.to(torch.float32)
    feasible = dist < BIG / 2
    # closer[r, r', f]: robot r' is strictly closer to frontier f than r
    closer = (dist[None, :, :] < dist[:, None, :]) & feasible[None, :, :]
    rank = closer.sum(dim=1)  # (R, F)
    score = torch.where(feasible, rank.to(torch.float32) * BIG / 4 + dist, BIG)
    pick = torch.argmin(score, dim=1)
    ok = torch.gather(feasible, 1, pick[:, None])[:, 0]
    return torch.where(ok, pick.to(torch.int32), -1)


# ---------------------------------------------------------------------------
# Voronoi partition of the grid between robots
# ---------------------------------------------------------------------------

def voronoi_partition(
    spec: GridSpec2D,
    robot_xy: torch.Tensor,       # (R, 2)
    robot_valid: torch.Tensor,    # (R,) bool
) -> torch.Tensor:
    """(G, G) int32 label grid: nearest valid robot per cell (-1 if none).
    A cell equidistant from two robots takes the lower index, unless the
    last bit of the two distances differs from the reference's."""
    G = spec.size
    dev = robot_xy.device
    ii = torch.arange(G, dtype=torch.float32, device=dev) + 0.5
    res = torch.full((), spec.resolution, dtype=torch.float32, device=dev)
    # the reference's compiler fuses each cell centre's multiply-add (F13)
    x = fma32(ii, res, torch.full((), spec.origin_x, dtype=torch.float32, device=dev))
    y = fma32(ii, res, torch.full((), spec.origin_y, dtype=torch.float32, device=dev))
    cy, cx = torch.meshgrid(y, x, indexing="ij")
    centers = torch.stack([cx, cy], dim=-1)                       # (G, G, 2)
    diff = centers[:, :, None, :] - robot_xy.to(torch.float32)[None, None, :, :]
    d = torch.sqrt((diff * diff).sum(dim=-1))
    d = torch.where(robot_valid[None, None, :], d, BIG)
    lbl = torch.argmin(d, dim=-1).to(torch.int32)
    return torch.where(robot_valid.any(), lbl, -1)


# ---------------------------------------------------------------------------
# TaskAllocator + goal sharing
# ---------------------------------------------------------------------------

class TaskAllocator:
    """Builds the robots x frontiers cost matrix and assigns goals.

    Rows are robots, columns frontier goals; the method comes from the
    config (``multi_robot.allocator``). Shared goals from peers are
    penalized so two robots do not chase the same frontier. The matrix is
    host numpy, as the reference's; the MinPos and auction solvers run on
    ``device`` and their result is read back once (``host_syncs``; the
    auction's chunk reads too, with its rounds in ``auction_rounds``).
    With ``capture`` (the default) they run as captured programs
    (``utils/jit.py``): regions ``minpos``, and ``auction_setup`` and
    ``auction_chunk/n`` (n rounds), of a slot a problem shape (R, F), the
    uploaded matrix their staged input."""

    def __init__(self, method: str = "hungarian", share_radius_m: float = 1.5,
                 share_penalty: float = BIG, device="cuda", capture: bool = True):
        assert method in ("hungarian", "minpos", "auction")
        self.method = method
        self.share_radius_m = share_radius_m
        self.share_penalty = share_penalty
        self.device = torch.device(device)
        self.capture = capture
        self.host_syncs = 0
        self.auction_rounds: List[int] = []     # the rounds of each auction solve
        self._states: Dict[Tuple[int, int], jit.SlotState] = {}

    def slot_state(self, R: int, F: int) -> jit.SlotState:
        """The state of this allocator's (R, F) problems: the auction's
        buffers and the regions of its slot."""
        if (R, F) not in self._states:
            self._states[(R, F)] = jit.SlotState(
                self, ("TaskAllocator", R, F), self.device, auction_state(R, F, self.device),
                self.capture)
        return self._states[(R, F)]

    @property
    def capture_stats(self) -> Dict[str, Dict]:
        """{region: calls, captured, capture seconds, graph pool bytes} over
        the problem shapes solved so far; empty on the eager path."""
        return {f"{name}@{R}x{F}": v for (R, F), st in self._states.items()
                for name, v in st.stats().items()}

    def allocate(
        self,
        cost: np.ndarray,                    # (R, F) path/utility costs
        frontier_xy: np.ndarray,             # (F, 2)
        peer_goals: Optional[Sequence[np.ndarray]] = None,
    ) -> np.ndarray:
        cost = np.array(cost, np.float32, copy=True)
        if peer_goals:
            pg = np.stack([np.asarray(g) for g in peer_goals])     # (P, 2)
            d = np.linalg.norm(
                np.asarray(frontier_xy)[:, None, :] - pg[None, :, :], axis=-1
            )
            near = (d < self.share_radius_m).any(axis=1)           # (F,)
            cost[:, near] += self.share_penalty
        if self.method == "hungarian":
            return hungarian_assign(cost)
        cost_dev = upload(cost, self.device)
        state = self.slot_state(*cost.shape)
        if self.method == "minpos":
            assign = state.run("minpos", jit.pure(minpos_assign), cost_dev)[1]
        else:
            stats: Dict[str, int] = {}
            assign = auction_assign(cost_dev, stats=stats, state=state)
            self.host_syncs += stats["syncs"]
            self.auction_rounds.append(stats["rounds"])
        self.host_syncs += 1
        # a copy: on the CPU the read is a view of the region's output buffer
        with profiling.host_read("TaskAllocator.assign", self.device):
            return assign.cpu().numpy().copy()


def cost_matrix(spec: GridSpec2D, cfg, occ: torch.Tensor, robots_xy: torch.Tensor,
                fr: fx.Frontiers) -> torch.Tensor:
    """(R, F) path costs on the device: one wavefront (K3) from each robot,
    read at every frontier's goal cell (BIG off the grid or at an invalid
    frontier)."""
    G = spec.size
    c, okc = spec.world_to_cell(fr.goal_xy)
    # a gather clamps out-of-grid cells, as the reference's does
    flat = (torch.clamp(c[:, 1], 0, G - 1) * G + torch.clamp(c[:, 0], 0, G - 1)).long()
    rows = []
    for r in range(robots_xy.shape[0]):
        pot = navx.wavefront_potential(
            spec, occ, robots_xy[r],
            iters=cfg.nav.wavefront_iters, allow_unknown=True,
        )
        d = torch.where(okc, pot.reshape(-1)[flat], BIG)
        rows.append(torch.where(fr.valid, d, BIG))
    return torch.stack(rows)


def coordinator_region(occ: torch.Tensor, host: torch.Tensor, *, spec: GridSpec2D, cfg):
    """Region ``coordinator``: the frontier search from the fleet's centroid
    and the (R, F) cost matrix, packed as [valid (F,), goals (F * 2), costs
    (R * F)] float32. ``host`` is [robots' x, y (R * 2), centroid x, y]."""
    fcfg = cfg.frontier_search
    robots = host[:-2].reshape(-1, 2)
    fr = fx.extract_frontiers(
        spec, occ, host[-2:], spec.extent,
        max_cells=4096,
        max_frontiers=fcfg.max_frontiers,
        max_cluster_size=fcfg.max_frontier_cluster_size,
        min_cluster_size=fcfg.min_frontier_cluster_size,
        cc_iters=fcfg.cc_iters,
    )
    cost_d = cost_matrix(spec, cfg, occ, robots, fr)
    return (), torch.cat([fr.valid.to(torch.float32), fr.goal_xy.reshape(-1),
                          cost_d.reshape(-1)])


class MultiRobotCoordinator:
    """Shared-map multi-robot exploration: one frontier search, one cost
    matrix, one assignment per tick (the GetAllocatedGoal BT node of the
    reference). The frontier goals and the cost matrix come back in one
    read a tick (``host_syncs``, the allocator's reads included), where the
    reference reads each robot's row; the wavefronts run before that read,
    so the tick that finds no frontier has run them too (the reference
    skips them). With ``capture`` (the default) the device work up to that
    read is region ``coordinator`` (``utils/jit.py``), the robots' positions
    and the centroid its staged input, and the allocator's solvers are
    captured too; ``capture=False`` runs both as plain PyTorch."""

    def __init__(self, cfg, spec: GridSpec2D, get_occupancy, navs: List,
                 get_poses: Callable[[], List[Tuple[np.ndarray, float]]],
                 device="cuda", capture: bool = True):
        self.cfg = cfg
        self.spec = spec
        self.device = torch.device(device)
        self.get_occupancy = get_occupancy
        self.navs = navs
        self.get_poses = get_poses
        self.capture = capture
        self.allocator = TaskAllocator(method=cfg.multi_robot.allocator, device=self.device,
                                       capture=capture)
        self._slot_state = jit.SlotState(
            self, ("MultiRobotCoordinator", repr(cfg), spec, len(navs)), self.device, {},
            capture)
        self._goals: List[Optional[np.ndarray]] = [None] * len(navs)
        self.done = False
        self._syncs = 0
        self.ticks = 0

    @property
    def host_syncs(self) -> int:
        return self._syncs + self.allocator.host_syncs

    @property
    def capture_stats(self) -> Dict[str, Dict]:
        """{region: calls, captured, capture seconds, graph pool bytes} of the
        coordinator's and its allocator's regions; empty on the eager path."""
        return {**self._slot_state.stats(), **self.allocator.capture_stats}

    def tick(self):
        if self.done:
            return
        self.ticks += 1
        occ = self.get_occupancy()
        poses = self.get_poses()
        R = len(self.navs)
        xy = np.stack([np.asarray(p, np.float32) for p, _ in poses])
        # one frontier set on the shared map, searched from the fleet centroid
        centroid = np.mean([p for p, _ in poses], axis=0)
        host = upload(np.concatenate([xy.reshape(-1), np.asarray(centroid, np.float32)]),
                      self.device)
        # the per-robot path costs (NavFn rows), the goals and the valid
        # mask in ONE read
        _, packed = self._slot_state.run(
            "coordinator", functools.partial(coordinator_region, spec=self.spec, cfg=self.cfg),
            occ, host)
        # a copy: on the CPU the read is a view of the region's output buffer
        with profiling.host_read("MultiRobotCoordinator.tick", self.device):
            pk = packed.cpu().numpy().copy()
        self._syncs += 1
        F = (pk.shape[0]) // (3 + R)
        valid = pk[:F] > 0.5
        if not valid.any():
            for nav in self.navs:
                nav.cancel()
            self.done = True
            return
        fxy = pk[F:3 * F].reshape(F, 2)
        cost = pk[3 * F:].reshape(R, F)

        assign = self.allocator.allocate(cost, fxy)
        for r, nav in enumerate(self.navs):
            j = int(assign[r])
            if j < 0 or cost[r, j] >= BIG / 2:
                continue
            goal = fxy[j]
            cur = self._goals[r]
            if (cur is not None and nav.status() == GoalStatus.ACTIVE
                    and np.linalg.norm(goal - cur) < 0.5):
                continue
            nav.send_goal(goal, 0.0)
            self._goals[r] = goal
