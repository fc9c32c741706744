"""Frontier cost assignment and full-path (TSP) goal optimization (port of
``fitslam_tpu/models/costs.py``).

- FrontierCostCalculator / FrontierCostsManager / CostAssigner: per-frontier
  arrival information (360° sweep), path cost from the roadmap planner (and
  the wavefront potential), utility u = alpha * info_norm + (1 - alpha) *
  (1 - time_norm), weighted cost 1 / (beta * u), infinite for blacklisted
  or unachievable frontiers.
- FullPathOptimizer: split achievable frontiers into <= 5 locals + the
  closest global; exhaustive TSP over the locals, all 120 permutations in
  one gather + sum.

Everything stays on the device; the exploration server reads the result
back in its one packed pull per tick.
"""

from __future__ import annotations

import math
from itertools import permutations
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from fitslam_tpu_torch.models.roadmap import INF, _dist
from fitslam_tpu_torch.ops import raycast
from fitslam_tpu_torch.ops.frontier import Frontiers
from fitslam_tpu_torch.ops.grid import LETHAL, UNKNOWN, GridSpec2D
from fitslam_tpu_torch.utils import prng
from fitslam_tpu_torch.utils.transfer import upload


class FrontierCosts(NamedTuple):
    """Per-frontier cost record (the Frontier data model fields of E4)."""

    arrival_info: torch.Tensor     # (F,)
    best_heading: torch.Tensor     # (F,)
    path_length: torch.Tensor      # (F,) meters via roadmap (INF unreachable)
    utility: torch.Tensor          # (F,)
    weighted_cost: torch.Tensor    # (F,) 1/(beta*u); INF if excluded
    achievable: torch.Tensor       # (F,) bool
    node_idx: torch.Tensor         # (F,) int32 nearest roadmap node
    path_fi: torch.Tensor          # (F,) fisher_information_in_path (E4/E5)


def assign_costs(
    spec: GridSpec2D,
    occ: torch.Tensor,
    fr: Frontiers,
    rm_xy: torch.Tensor,           # (N, 2) roadmap node positions
    rm_valid: torch.Tensor,        # (N,) bool
    robot_dist: torch.Tensor,      # (N,) BF distances from robot node
    blacklisted: torch.Tensor,     # (F,) bool
    alpha: float = 0.25,
    beta: float = 1.0,
    v_max: float = 0.5,
    w_max: float = 0.5,
    factor_of_max_info: float = 0.7,
    raycast_depth_m: float = 2.0,
    grid_pot: torch.Tensor | None = None,  # (G, G) wavefront potential from robot
    n_rays: int = 64,
    n_steps: int = 16,
    fov_rad: float = 1.04,
    path_fi: torch.Tensor | None = None,   # (F,) fisher_information_in_path
    min_path_info: float = 0.0,            # exclude below this path FI (0 = off)
    robot_xy: torch.Tensor | None = None,  # (2,) for closeness rejection
    closeness_rejection: float = 0.5,
    methods: Tuple[str, ...] = ("RoadmapPlannerDistance", "ArrivalInformation"),
    rng_key: np.ndarray | None = None,     # (2,) uint32 for the RandomCosts ablation
) -> FrontierCosts:
    """Full cost pipeline for all frontiers at once.

    `methods` selects the cost calculation: the default utility combines
    roadmap distance + arrival information; the ablation baselines are
    "RandomCosts" (a uniform random cost per frontier, the reference's
    ``jax.random`` draw reproduced bit for bit on the host by
    ``utils/prng.py`` and uploaded once) and "ClosestFrontier" (pure
    Euclidean distance); exclusion rules still apply in every mode."""
    F = fr.valid.shape[0]

    heading, info = raycast.arrival_information(
        spec, occ, fr.goal_xy, fr.valid, depth_m=raycast_depth_m,
        n_rays=n_rays, n_steps=n_steps, fov_rad=fov_rad,
    )

    # roadmap path length: snap each frontier to its nearest node
    d_nodes = _dist(fr.goal_xy[:, None, :], rm_xy[None, :, :])
    d_nodes = torch.where(rm_valid[None, :], d_nodes, INF)
    node = torch.argmin(d_nodes, dim=1)
    snap_d = d_nodes.amin(dim=1)
    path_len = robot_dist[node] + snap_d
    if grid_pot is not None:
        # NavFn-equivalent fallback: a wavefront potential from the robot
        # prices every frontier even before the roadmap has connectable edges
        G = spec.size
        c, okc = spec.world_to_cell(fr.goal_xy)
        # the reference's gather clamps out-of-grid cells
        flat = torch.clamp(c[..., 1], 0, G - 1) * G + torch.clamp(c[..., 0], 0, G - 1)
        gd = torch.where(okc, grid_pot.reshape(-1)[flat.long()], INF)
        path_len = torch.minimum(path_len, gd)
    reachable = fr.valid & (path_len < INF / 2)

    # achievability: not in lethal, info above the STATIC floor (the
    # reference's setMaxArrivalInformation ceiling in closed form)
    cell_occ = raycast._sample_occ(spec, occ, fr.goal_xy)
    not_lethal = ~((cell_occ != UNKNOWN) & (cell_occ >= LETHAL))
    fov_w = max(1, int(round(fov_rad / (2.0 * math.pi / n_rays))))
    # The floor uses the UNINFLATED attainable max (fov_w * n_steps), not
    # the 1.2x normalization ceiling (see the reference for the derivation)
    info_floor = factor_of_max_info * fov_w * n_steps
    achievable = fr.valid & not_lethal & reachable & (info > 0.0)
    if robot_xy is not None:
        # closeness rejection: a frontier the robot already stands on can
        # never be re-dispatched
        d_robot = _dist(fr.goal_xy, robot_xy[None, :])
        achievable = achievable & (d_robot > closeness_rejection)

    # normalized utility; normalization stats come from the pre-floor
    # achievable set so the floor doesn't feed back into its own scale
    info_max = torch.clamp_min(torch.where(achievable, info, 0.0).amax(), 1e-6)
    info_norm = torch.clamp(info / info_max, 0.0, 1.0)
    time_cost = path_len / v_max + math.pi / (2.0 * w_max)  # travel + nominal turn
    t_max = torch.where(achievable, time_cost, 0.0).amax()
    t_min = torch.where(achievable, time_cost, INF).amin()
    time_norm = (time_cost - t_min) / torch.clamp_min(t_max - t_min, 1e-6)
    u = alpha * info_norm + (1.0 - alpha) * (1.0 - torch.clamp(time_norm, 0.0, 1.0))
    weighted = 1.0 / torch.clamp_min(beta * u, 1e-6)

    if "RandomCosts" in methods:
        # setRandomMetaData: every frontier gets a uniform random cost, the
        # lower bound for method comparison
        key = prng.prng_key(0) if rng_key is None else rng_key
        weighted = upload(prng.uniform(key, (F,), 1.0, 100.0), occ.device)
        u = 1.0 / weighted
    elif "ClosestFrontier" in methods:
        # setClosestFrontierMetaData: greedy nearest-frontier
        d_r = (_dist(fr.goal_xy, robot_xy[None, :]) if robot_xy is not None else path_len)
        weighted = d_r
        u = 1.0 / torch.clamp_min(d_r, 1e-6)

    achievable = achievable & (info >= info_floor)
    if path_fi is None:
        path_fi = torch.zeros((F,), dtype=torch.float32, device=occ.device)
    elif min_path_info > 0.0:
        # fisher_information_in_path gate
        achievable = achievable & (path_fi >= min_path_info)
    excluded = ~achievable | blacklisted
    weighted = torch.where(excluded, INF, weighted)
    return FrontierCosts(
        arrival_info=info,
        best_heading=heading,
        path_length=torch.where(reachable, path_len, INF),
        utility=u,
        weighted_cost=weighted,
        achievable=achievable,
        node_idx=node.to(torch.int32),
        path_fi=path_fi,
    )


# ---------------------------------------------------------------------------
# Full-path TSP
# ---------------------------------------------------------------------------

MAX_LOCAL = 5
_PERMS = np.array(list(permutations(range(MAX_LOCAL))), np.int64)  # (120, 5)
# roadmap-unreachable legs cost a large FINITE penalty so the TSP still
# orders what it can reach (reference: LOCAL_FRONTIER_SEARCH_RADIUS * 100000)
UNREACHABLE_LEG = 1.2e6

_perms_on: Dict[str, torch.Tensor] = {}


def _perms(device) -> torch.Tensor:
    """The (120, 5) permutation table, uploaded once per device."""
    key = str(device)
    if key not in _perms_on:
        _perms_on[key] = upload(_PERMS, device)
    return _perms_on[key]


class PathPlan(NamedTuple):
    order: torch.Tensor        # (MAX_LOCAL,) frontier indices in visit order (-1 pad)
    n_local: torch.Tensor      # () int32
    goal_idx: torch.Tensor     # () int32 — first frontier to navigate to
    total_length: torch.Tensor # () float32
    has_goal: torch.Tensor     # () bool


def optimize_full_path(
    costs: FrontierCosts,
    fr: Frontiers,
    blacklisted: torch.Tensor,          # (F,) bool
    pairwise_dist: torch.Tensor,        # (MAX_LOCAL+1, N) BF distances: row 0 =
                                        # from robot node, rows 1.. = from the
                                        # selected local frontiers' nodes
    local_sel: torch.Tensor,            # (MAX_LOCAL,) int32 frontier idx of rows
    local_valid: torch.Tensor,          # (MAX_LOCAL,) bool
    closest_global_node: torch.Tensor,  # () int32 node of the closest global (-1 none)
) -> PathPlan:
    """Exhaustive TSP over the local set, evaluated for all 120 permutations
    in one gather+sum (FullPathOptimizer::getBestFullPath)."""
    perms = _perms(pairwise_dist.device)                # (P, 5)
    P = perms.shape[0]
    pairwise_dist = torch.where(pairwise_dist >= INF / 2, UNREACHABLE_LEG, pairwise_dist)

    # distance robot -> first local of each perm
    first = perms[:, 0]
    node_of = costs.node_idx[local_sel.long()].long()    # (5,) node per local row
    d_robot = pairwise_dist[0]                           # (N,)
    d_first = d_robot[node_of[first]]                    # (P,)

    # consecutive legs: local i -> local j uses row (i+1) of pairwise_dist
    legs = torch.zeros((P,), dtype=torch.float32, device=perms.device)
    for k in range(MAX_LOCAL - 1):
        a = perms[:, k]
        b = perms[:, k + 1]
        leg = pairwise_dist[a + 1, node_of[b]]
        both_ok = local_valid[a] & local_valid[b]
        legs = legs + torch.where(both_ok, leg, 0.0)

    # tail: last valid local -> closest global (optional)
    has_global = closest_global_node >= 0
    g_node = torch.clamp_min(closest_global_node, 0).long().reshape(1)
    last = perms[:, -1]
    tail = torch.where(has_global & local_valid[last], pairwise_dist[last + 1, g_node], 0.0)

    # permutations must order valid locals first (invalid slots at the end)
    valid_at = local_valid[perms]                        # (P, 5)
    n_local = local_valid.sum(dtype=torch.int32)
    pos = torch.arange(MAX_LOCAL, device=perms.device)[None, :]
    proper = (valid_at == (pos < n_local)).all(dim=1)

    total = torch.where(
        proper, d_first * torch.where(local_valid[first], 1.0, 0.0) + legs + tail, INF)
    # indices stay 1-d: indexing with a 0-d device tensor reads it back
    best = torch.argmin(total).reshape(1)
    best_perm = perms[best][0]
    best_total = total[best][0]
    order = torch.where(local_valid[best_perm], local_sel[best_perm], -1)
    has_goal = (n_local > 0) & (best_total < INF / 2)
    goal_idx = torch.where(has_goal, order[0], -1)
    return PathPlan(
        order=order,
        n_local=n_local,
        goal_idx=goal_idx.to(torch.int32),
        total_length=best_total,
        has_goal=has_goal,
    )


def select_locals(
    costs: FrontierCosts,
    fr: Frontiers,
    blacklisted: torch.Tensor,
    local_path_threshold: float = 12.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split achievable frontiers into <= MAX_LOCAL locals (shortest paths)
    and pick the closest global (FullPathOptimizer::getFilteredFrontiersN).

    Returns (local_sel (5,) frontier idx, local_valid (5,), closest_global
    frontier idx or -1)."""
    eligible = costs.achievable & ~blacklisted
    is_local = eligible & (costs.path_length <= local_path_threshold)
    # top-5 locals by weighted cost (lowest); lax.top_k's tie order (lower
    # index first) is a stable descending sort's
    score = torch.where(is_local, -costs.weighted_cost, -INF)
    sel = torch.sort(score, descending=True, stable=True).indices[:MAX_LOCAL]
    sel_valid = is_local[sel]

    is_global = eligible & (costs.path_length > local_path_threshold)
    g_score = torch.where(is_global, -costs.path_length, -INF)
    g_idx = torch.argmax(g_score)
    has_g = is_global[g_idx.reshape(1)][0]
    return (sel.to(torch.int32), sel_valid,
            torch.where(has_g, g_idx, -1).to(torch.int32))


def goal_hysteresis(prev_goal_xy, new_goal_xy, prev_valid, new_valid,
                    robot_xy, switch_threshold_m: float = 3.0):
    """Goal stickiness (HysterisisControl): keep the previous goal unless the
    new one is >= threshold closer. Host math."""
    if not prev_valid:
        return new_goal_xy, new_valid
    if not new_valid:
        return prev_goal_xy, prev_valid
    d_prev = float(np.linalg.norm(np.asarray(prev_goal_xy) - np.asarray(robot_xy)))
    d_new = float(np.linalg.norm(np.asarray(new_goal_xy) - np.asarray(robot_xy)))
    if d_new < d_prev - switch_threshold_m:
        return new_goal_xy, True
    return prev_goal_xy, True


# ---------------------------------------------------------------------------
# Glue for the exploration tick: fixed-shape device helpers
# ---------------------------------------------------------------------------


def blacklist_mask(goal_xy: torch.Tensor, circles: torch.Tensor) -> torch.Tensor:
    """(F, 2) frontier goals vs (B, 3) FIXED-CAPACITY blacklist circles
    (x, y, radius; pad unused rows with (1e9, 1e9, 0)) -> (F,) bool mask."""
    d = _dist(goal_xy[:, None, :], circles[None, :, :2])
    return (d < circles[None, :, 2]).any(dim=1)


def snap_to_nodes(goal_xy: torch.Tensor, rm_xy: torch.Tensor,
                  rm_valid: torch.Tensor) -> torch.Tensor:
    """Nearest valid roadmap node per frontier goal."""
    d = _dist(goal_xy[:, None, :], rm_xy[None, :, :])
    d = torch.where(rm_valid[None, :], d, INF)
    return torch.argmin(d, dim=1).to(torch.int32)


def make_bf_sources(robot_xy: torch.Tensor, goal_xy: torch.Tensor,
                    sel: torch.Tensor) -> torch.Tensor:
    """Row 0 = robot, rows 1.. = selected locals (BF source stack)."""
    return torch.cat([robot_xy[None, :].to(torch.float32), goal_xy[sel.long()]], dim=0)


def global_node(node_idx: torch.Tensor, g_idx: torch.Tensor) -> torch.Tensor:
    return torch.where(g_idx >= 0, node_idx[torch.clamp_min(g_idx, 0).long().reshape(1)][0],
                       -1).to(torch.int32)


def finalize_goal(plan_has_goal: torch.Tensor, plan_goal_idx: torch.Tensor,
                  g_idx: torch.Tensor):
    """Closest-global fallback (getFilteredFrontiersN), branchless."""
    has = plan_has_goal | (g_idx >= 0)
    gi = torch.where(plan_has_goal, plan_goal_idx, torch.clamp_min(g_idx, 0)).to(torch.int32)
    return has, gi
