"""Frozen copies of the port's rooms world: the ground-truth occupancy of a
bordered arena with walls and doorways (``fitslam_tpu_torch/models/
sim_robot.py:145-165``) and the 3D landmark world built from it, textured
walls and floor (``fitslam_tpu_torch/data/synthetic.py:447-491``), both
numpy draws from an integer seed. ``benchmark/tests/test_bench_frozen.py``
holds them equal to the port's."""

from __future__ import annotations

import numpy as np

LETHAL = 254


# models/sim_robot.py:145-165
def rooms_occupancy(size: int, seed: int) -> np.ndarray:
    """(size, size) uint8: 0 free, 254 wall."""
    G = size
    occ = np.zeros((G, G), np.uint8)
    occ[:2, :] = LETHAL
    occ[-2:, :] = LETHAL
    occ[:, :2] = LETHAL
    occ[:, -2:] = LETHAL
    rng = np.random.RandomState(seed)
    for frac in (0.35, 0.65):
        col = int(G * frac)
        occ[:, col] = LETHAL
        door = rng.randint(G // 5, G - G // 5)
        occ[max(0, door - 4): door + 4, col] = 0
    row = int(G * 0.5)
    occ[row, : int(G * 0.35)] = LETHAL
    door = rng.randint(4, int(G * 0.3))
    occ[row, max(0, door - 4): door + 4] = 0
    return occ


# data/synthetic.py:447-491
def world_from_occupancy(occ: np.ndarray, resolution: float, origin_x: float, origin_y: float,
                         seed: int, wall_height: float, points_per_wall_cell: int,
                         floor_points: int) -> np.ndarray:
    """(L, 3) float32 landmarks: jittered points on the wall cells up to
    ``wall_height`` and ``floor_points`` on free cells near z = 0."""
    rng = np.random.RandomState(seed)
    wall_cells = np.argwhere(occ >= 200)
    pts = []
    if len(wall_cells):
        reps = np.repeat(wall_cells, points_per_wall_cell, axis=0)
        jitter = rng.uniform(0, 1, (len(reps), 2))
        xy = np.stack([(reps[:, 1] + jitter[:, 0]) * resolution + origin_x,
                       (reps[:, 0] + jitter[:, 1]) * resolution + origin_y], axis=-1)
        z = rng.uniform(0.0, wall_height, (len(reps), 1))
        pts.append(np.concatenate([xy, z], axis=-1))
    free_cells = np.argwhere(occ < 200)
    sel = free_cells[rng.randint(0, len(free_cells), floor_points)]
    jitter = rng.uniform(0, 1, (floor_points, 2))
    xy = np.stack([(sel[:, 1] + jitter[:, 0]) * resolution + origin_x,
                   (sel[:, 0] + jitter[:, 1]) * resolution + origin_y], axis=-1)
    z = np.abs(rng.normal(0.0, 0.02, (floor_points, 1)))
    pts.append(np.concatenate([xy, z], axis=-1))
    return np.concatenate(pts, axis=0).astype(np.float32)
