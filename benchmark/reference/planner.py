"""Plain reference of the grid planner: NavFn's wavefront potential from the
goal over a costmap and the check that a path descends it.

The costmap's cells are 0-252 costs, 253 inscribed, 254 lethal, 255 unknown.
The robot's own disc of 0.3 m (its cell distance from the robot's cell) is
cleared first. A cell is passable unless lethal (>= 254 and not unknown), or
unknown where unknown space is not allowed; entering a passable cell costs
resolution * (1 + 0.02 * cost), twice that for an unknown cell. The
potential is 0 at the goal's cell and is relaxed ``iters`` times at once
over the 4 neighbours (a Jacobi sweep): p <- min(p, min_nb(p) + cost), 1e9
where unreached. A path is a walk of cells from the robot's cell, each step
to one of the 8 neighbours, a diagonal step charged (sqrt 2 - 1) *
resolution more; each step must take the lowest of the 8 and lower the
potential. ``dtype``: float64 here; the control relaxes in bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch

UNKNOWN, LETHAL = 255, 254
BIG = 1e9


def _cell(xy, res, ox, oy):
    """(column, row) of a world point given as float32, the grid's rounding."""
    f = np.float32
    return tuple(int(np.floor((f(v) - f(o)) / f(res))) for v, o in ((xy[0], ox), (xy[1], oy)))


def potential(occ: torch.Tensor, res: float, ox: float, oy: float, robot_xy, goal_xy,
              iters: int, allow_unknown: bool = True, dtype=torch.float64) -> torch.Tensor:
    G = occ.shape[0]
    o = occ.to(torch.int64)
    rc, rr = _cell(robot_xy, res, ox, oy)
    ii = torch.arange(G, device=occ.device)
    disc = ((ii[:, None] - rr) ** 2 + (ii[None, :] - rc) ** 2) <= (0.3 / res) ** 2
    o = torch.where(disc, torch.zeros_like(o), o)
    unknown = o == UNKNOWN
    lethal = ~unknown & (o >= LETHAL)
    passable = ~lethal & (torch.tensor(allow_unknown, device=occ.device) | ~unknown)
    cost = res * (1.0 + 0.02 * torch.where(unknown, torch.zeros_like(o), o).to(dtype))
    cost = torch.where(unknown, cost * 2.0, cost)
    gc, gr = _cell(goal_xy, res, ox, oy)
    flat = min(max(gr * G + gc, 0), G * G - 1)
    p = torch.full((G * G,), BIG, dtype=dtype, device=occ.device)
    p[flat] = 0
    p = p.reshape(G, G)
    big = torch.tensor(BIG, dtype=dtype, device=occ.device)
    for _ in range(iters):
        q = torch.nn.functional.pad(p[None, None].float() if dtype == torch.bfloat16
                                    else p[None, None], (1, 1, 1, 1), value=BIG)[0, 0].to(dtype)
        nb = torch.minimum(torch.minimum(q[:-2, 1:-1], q[2:, 1:-1]),
                           torch.minimum(q[1:-1, :-2], q[1:-1, 2:]))
        p = torch.minimum(p, torch.where(passable, nb + cost, big))
    return p


def descent_excess(pot: torch.Tensor, res: float, ox: float, oy: float, path_xy) -> float:
    """How far (m) a path's steps fall short of descending ``pot``: the
    largest, over its steps, of the step's cost above the best of the 8
    moves and of the potential it fails to shed; 0 for a path that descends
    exactly, inf for one that leaves the grid or jumps. ``path_xy`` starts
    at the robot's position, then the centres of the cells walked."""
    G = pot.shape[0]
    p = pot.double().cpu()
    diag = (math.sqrt(2.0) - 1.0) * res
    worst = 0.0
    cells = [_cell(xy, res, ox, oy) for xy in path_xy]
    cells[0] = tuple(min(max(v, 0), G - 1) for v in cells[0])
    for (c0, r0), (c1, r1) in zip(cells[:-1], cells[1:]):
        if not (0 <= r1 < G and 0 <= c1 < G) or max(abs(r1 - r0), abs(c1 - c0)) != 1:
            return math.inf
        best = math.inf
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                if dr == dc == 0:
                    continue
                r, c = min(max(r0 + dr, 0), G - 1), min(max(c0 + dc, 0), G - 1)
                best = min(best, float(p[r, c]) + (diag if dr and dc else 0.0))
        step = float(p[r1, c1]) + (diag if (r1 - r0) and (c1 - c0) else 0.0)
        worst = max(worst, step - best, step - float(p[r0, c0]))
    return worst


def descend(pot: torch.Tensor, res: float, ox: float, oy: float, start_xy,
            max_steps: int = 256):
    """The walk down ``pot`` from the start's cell: to the lowest of the 8
    neighbours (diagonals charged extra) while that is below the current
    cell's potential and the cell is not the goal's; the cell centres."""
    G = pot.shape[0]
    p = pot.double().cpu()
    diag = (math.sqrt(2.0) - 1.0) * res
    c, r = (min(max(v, 0), G - 1) for v in _cell(start_xy, res, ox, oy))
    out = []
    for _ in range(max_steps):
        if float(p[r, c]) <= 1e-6:
            break
        best, nxt = float(p[r, c]), None
        for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (-1, 1), (1, -1), (-1, -1)):
            rr, cc = min(max(r + dr, 0), G - 1), min(max(c + dc, 0), G - 1)
            v = float(p[rr, cc]) + (diag if dr and dc else 0.0)
            if v < best:
                best, nxt = v, (rr, cc)
        if nxt is None:
            break
        r, c = nxt
        out.append(((c + 0.5) * res + ox, (r + 0.5) * res + oy))
    return out
