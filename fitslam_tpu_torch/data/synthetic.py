"""Procedural worlds and frames (port of ``fitslam_tpu/data/synthetic.py``):
a straight corridor trajectory, a Gaussian-blob stereo renderer and an RGB-D
sensor model of a landmark world, per-keyframe frustum clouds, 3D worlds
built from an occupancy grid, and the marsyard heightfield world.

Worlds the reference draws with ``jax.random`` come from files, since torch
cannot reproduce that stream (ROADMAP fault F4): the bench world is
committed as ``tests/data/bench_corridor_world.npz`` (``load_world``).
``world_from_occupancy`` draws from a numpy ``RandomState`` whose integer
seed the reference takes from ``jax.random``; the port takes that integer
(``ROOMS_WORLD_SEED`` is the reference's for ``PRNGKey(5)``).
``marsyard_world`` is numpy in both packages.

Functions that render or cull take the world's (L, 3) landmark tensor.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import NamedTuple, Tuple

import numpy as np
import torch

from fitslam_tpu_torch.ops import lie
from fitslam_tpu_torch.ops.geometry import Intrinsics, project_stereo
from fitslam_tpu_torch.ops.numerics import top_k_stable

BENCH_WORLD = Path(__file__).resolve().parents[2] / "tests" / "data" / "bench_corridor_world.npz"
# the integer the reference's world_from_occupancy seeds its RandomState
# with for jax.random.PRNGKey(5): int(jax.random.randint(key, (), 0, 2**31 - 1))
ROOMS_WORLD_SEED = 359975681


class World(NamedTuple):
    landmarks: torch.Tensor   # (L, 3) world points
    terrain_fn: object = None


def load_world(path=BENCH_WORLD, device="cuda") -> torch.Tensor:
    """(L, 3) float32 world landmarks from an npz with a ``landmarks`` array."""
    return torch.as_tensor(np.load(path)["landmarks"].astype(np.float32), device=device)


def straight_trajectory(num_frames: int, length: float = 30.0, height: float = 1.2,
                        start_x: float = 2.0, device="cuda") -> lie.SE3:
    """Camera moving along +x looking forward (corridor sequence), T_wc."""
    x = torch.linspace(start_x, start_x + length, num_frames, device=device)
    t_wc = torch.stack([x, torch.zeros_like(x), torch.full_like(x, height)], dim=-1)
    fwd = torch.tensor([1.0, 0.0, 0.0], device=device).expand(t_wc.shape)
    down = torch.tensor([0.0, 0.0, -1.0], device=device).expand(t_wc.shape)
    right = torch.linalg.cross(down, fwd)
    R_wc = torch.stack([right, down, fwd], dim=-1)
    return lie.SE3(R_wc, t_wc)


def _hash01(i: torch.Tensor) -> torch.Tensor:
    """The reference's uint32 hash, in int64 arithmetic masked to 32 bits."""
    x = (i.long() * 2654435761) & 0xFFFFFFFF
    x = x ^ 0x9E3779B9
    x = x ^ (x >> 16)
    return (x & 0xFFFF).float() / 65535.0


def _splat(u, v, lum, height, width, sigma):
    """Scatter-add Gaussian blobs: a 7x7 stamp per landmark. ``sigma`` is a
    scalar or a per-landmark (L,) tensor."""
    R = 3
    dev = u.device
    iu = torch.round(u).long()
    iv = torch.round(v).long()
    offs = torch.arange(-R, R + 1, device=dev)
    dy, dx = torch.meshgrid(offs, offs, indexing="ij")
    sig = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
    sig = sig[:, None, None] if sig.dim() == 1 else sig
    w = torch.exp(-(dx ** 2 + dy ** 2) / (2 * sig * sig))
    w = torch.broadcast_to(w, (u.shape[0], 2 * R + 1, 2 * R + 1))
    rows = iv[:, None, None] + dy[None]
    cols = iu[:, None, None] + dx[None]
    vals = lum[:, None, None] * w
    inb = (rows >= 0) & (rows < height) & (cols >= 0) & (cols < width)
    flat = torch.where(inb, rows * width + cols, height * width)
    img = torch.zeros((height * width + 1,), dtype=torch.float32, device=dev)
    img.index_add_(0, flat.reshape(-1), torch.where(inb, vals, 0.0).reshape(-1))
    return torch.clamp(img[: height * width].reshape(height, width), 0.0, 255.0)


def _eye_image(K: Intrinsics, landmarks: torch.Tensor, T_cam: lie.SE3, lum, sig,
               width: int, height: int, max_depth: float) -> torch.Tensor:
    p_c = lie.apply(lie.inverse(T_cam), landmarks)
    uvr, z_ok = project_stereo(K, p_c)
    vis = z_ok & (p_c[..., 2] < max_depth)
    return _splat(uvr[..., 0], uvr[..., 1], torch.where(vis, lum, 0.0), height, width, sig)


def _blob_style(landmarks: torch.Tensor, splat_sigma: float):
    """Per-landmark deterministic intensity and blob width."""
    idx = torch.arange(landmarks.shape[0], device=landmarks.device)
    return 60.0 + 195.0 * _hash01(idx), splat_sigma * (0.6 + 1.4 * _hash01(idx + 77777))


def render_dense(K: Intrinsics, landmarks: torch.Tensor, T_wc: lie.SE3, width: int = 640,
                 height: int = 480, splat_sigma: float = 1.5,
                 max_depth: float = 25.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render (left, right) grayscale images: landmarks splatted as Gaussian
    blobs with per-landmark deterministic intensity and size."""
    lum, sig = _blob_style(landmarks, splat_sigma)
    left = _eye_image(K, landmarks, T_wc, lum, sig, width, height, max_depth)
    # right camera: offset by +baseline along the camera x-axis
    right = _eye_image(K, landmarks, lie.SE3(T_wc.R, T_wc.t + T_wc.R[..., :, 0] * K.baseline),
                       lum, sig, width, height, max_depth)
    return left, right


def render_stereo(K: Intrinsics, landmarks: torch.Tensor, T_wc: lie.SE3,
                  width: int = 640, height: int = 480, splat_sigma: float = 1.2,
                  max_depth: float = 18.0):
    """Stereo rendering with the reference's ``render_stereo`` defaults."""
    return render_dense(K, landmarks, T_wc, width=width, height=height,
                        splat_sigma=splat_sigma, max_depth=max_depth)


def render_rgbd(K: Intrinsics, landmarks: torch.Tensor, T_wc: lie.SE3,
                width: int = 640, height: int = 480, splat_sigma: float = 1.2,
                max_depth: float = 18.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """RGB-D sensor model: the left intensity image + a registered depth
    image (z-buffered point splats; 0 = no return). The depth camera analog
    of the reference's RGB-D input (orb_slam3 rgbd.launch.py)."""
    lum, sig = _blob_style(landmarks, splat_sigma)
    img = _eye_image(K, landmarks, T_wc, lum, sig, width, height, max_depth)
    p_c = lie.apply(lie.inverse(T_wc), landmarks)
    uvr, z_ok = project_stereo(K, p_c)
    vis = z_ok & (p_c[..., 2] < max_depth)
    depth = _splat_depth(uvr[..., 0], uvr[..., 1],
                         torch.where(vis, p_c[..., 2], math.inf), height, width)
    return img, depth


def _splat_depth(u, v, z, height, width):
    """Scatter-min z over a 5x5 stamp per landmark (z-buffer); the minimum
    is exact in any order."""
    R = 2
    dev = u.device
    iu = torch.round(u).long()
    iv = torch.round(v).long()
    offs = torch.arange(-R, R + 1, device=dev)
    dy, dx = torch.meshgrid(offs, offs, indexing="ij")
    rows = iv[:, None, None] + dy[None]
    cols = iu[:, None, None] + dx[None]
    inb = (rows >= 0) & (rows < height) & (cols >= 0) & (cols < width)
    flat = torch.where(inb, rows * width + cols, height * width)
    vals = torch.where(inb, z[:, None, None].expand(flat.shape), math.inf)
    zbuf = torch.full((height * width + 1,), math.inf, dtype=torch.float32, device=dev)
    zbuf = zbuf.scatter_reduce_(0, flat.reshape(-1), vals.reshape(-1), "amin")
    zbuf = zbuf[: height * width].reshape(height, width)
    return torch.where(torch.isfinite(zbuf), zbuf, 0.0)


# ---------------------------------------------------------------------------
# Marsyard heightfield world (rough-terrain rover scenario)
# ---------------------------------------------------------------------------


class MarsyardWorld(NamedTuple):
    """Heightfield terrain world (the marsyard scenario of the reference,
    README.md:3-12): a rover must route around slope-lethal ridge flanks and
    roughness-lethal boulder fields, through a safe corridor.

    `world` feeds the visual frontend and frustum clouds; `gt_lethal` is the
    ground-truth untraversable cell mask under the traversabilityParams.yaml:8-16
    semantics (max_slope 0.7, ground_clearance-scaled roughness)."""

    world: World
    gt_lethal: np.ndarray       # (G, G) bool
    gt_height: np.ndarray       # (G, G) float cell-mean height
    ridge_x: float
    corridor_y: float


def _marsyard_height(x, y, rocks_xyhr):
    """Analytic terrain height (numpy, broadcasts): gentle undulation + a
    ridge wall along x=ridge_x with a flat corridor gap at y~corridor_y +
    boulder clusters."""
    base = 0.12 * np.sin(0.45 * x) * np.cos(0.35 * y)
    # ridge: steep gaussian wall crossing the arena, gap near y=0
    ridge = 1.8 * np.exp(-((x - 1.0) / 1.1) ** 2)
    gap = 1.0 - np.exp(-(y / 1.8) ** 2)
    h = base + ridge * gap
    # boulders: tall narrow bumps (slope- and roughness-lethal)
    for (rx, ry, rh, rr) in rocks_xyhr:
        d2 = (x - rx) ** 2 + (y - ry) ** 2
        h = h + rh * np.exp(-d2 / (rr * rr))
    return h


def marsyard_world(
    spec,                       # GridSpec2D
    seed: int = 0,
    points_per_cell: int = 12,
    max_slope: float = 0.7,
    ground_clearance: float = 0.17,
    robot_height: float = 1.5,
    lethal_threshold: int = 55,
    device="cuda",
) -> MarsyardWorld:
    """Procedural marsyard: heightfield surface sampled into a dense point
    world (visual features + traversability clouds) + ground-truth lethal
    classification for assertions (numpy, as the reference's).

    The ridge flanks exceed `max_slope` (lethal by slope), the boulder
    clusters exceed the roughness bound (lethal by roughness/step), and the
    corridor at y~0 stays traversable — reference scenario parameters from
    traversabilityParams.yaml:8-16."""
    rng = np.random.RandomState(seed)
    G = spec.size
    ext = spec.extent

    # boulder clusters on the rover's side of the ridge
    rocks = []
    for (cx, cy) in [(-3.5, 3.5), (-4.0, -3.8)]:
        for _ in range(10):
            rocks.append((
                cx + rng.uniform(-1.2, 1.2),
                cy + rng.uniform(-1.2, 1.2),
                rng.uniform(0.6, 1.0),      # height
                rng.uniform(0.14, 0.22),    # radius
            ))

    # dense surface sampling: points_per_cell uniform samples per grid cell
    n_pts = G * G * points_per_cell
    xs = spec.origin_x + rng.uniform(0.0, ext, n_pts)
    ys = spec.origin_y + rng.uniform(0.0, ext, n_pts)
    zs = _marsyard_height(xs, ys, rocks)
    pts = np.stack([xs, ys, zs], axis=-1).astype(np.float32)

    # ground-truth per-cell classification with the SAME semantics the fused
    # grid applies (ops/grid.stats_to_grid + threshold_grid at
    # lethal_threshold): cost01 = max(slope/max_slope, rough/clearance,
    # step/robot_height), untraversable where round(cost01*200) >= threshold
    ci = np.clip(((xs - spec.origin_x) / spec.resolution).astype(int), 0, G - 1)
    cj = np.clip(((ys - spec.origin_y) / spec.resolution).astype(int), 0, G - 1)
    flat = cj * G + ci
    cnt = np.bincount(flat, minlength=G * G).astype(np.float64)
    s_z = np.bincount(flat, weights=zs, minlength=G * G)
    s_z2 = np.bincount(flat, weights=zs * zs, minlength=G * G)
    mean_z = (s_z / np.maximum(cnt, 1.0)).reshape(G, G)
    var_z = (s_z2 / np.maximum(cnt, 1.0)).reshape(G, G) - mean_z ** 2
    rough = np.sqrt(np.maximum(var_z, 0.0))
    z_mx = np.full(G * G, -np.inf)
    np.fmax.at(z_mx, flat, zs)
    z_mn = np.full(G * G, np.inf)
    np.fmin.at(z_mn, flat, zs)
    step = np.where(cnt > 0, z_mx - z_mn, 0.0).reshape(G, G)
    gy, gx = np.gradient(mean_z, spec.resolution)
    slope = np.sqrt(gx * gx + gy * gy)
    cost01 = np.maximum.reduce([
        np.clip(slope / max_slope, 0.0, 1.0),
        np.clip(rough / ground_clearance, 0.0, 1.0),
        np.clip(step / robot_height, 0.0, 1.0),
    ])
    hard = (slope > max_slope) | (step > robot_height * 0.5) | (
        rough > 2.0 * ground_clearance)
    gt_lethal = (np.round(cost01 * 200.0) >= lethal_threshold) | hard

    return MarsyardWorld(
        world=World(torch.as_tensor(pts, device=device)),
        gt_lethal=gt_lethal,
        gt_height=mean_z,
        ridge_x=1.0,
        corridor_y=0.0,
    )


def marsyard_surface_z(x: float, y: float, mw: MarsyardWorld, spec) -> float:
    """Terrain height under (x, y) from the ground-truth cell means (host
    helper for placing the rover's camera on the surface)."""
    G = spec.size
    ci = int(np.clip((x - spec.origin_x) / spec.resolution, 0, G - 1))
    cj = int(np.clip((y - spec.origin_y) / spec.resolution, 0, G - 1))
    return float(mw.gt_height[cj, ci])


# ---------------------------------------------------------------------------
# 3D worlds derived from occupancy grids (active-SLAM simulation)
# ---------------------------------------------------------------------------


def world_from_occupancy(
    occ,                       # (G, G) uint8 ground-truth grid {0 free, 254 wall}
    spec,                      # GridSpec2D
    seed: int,
    wall_height: float = 2.0,
    points_per_wall_cell: int = 6,
    floor_points: int = 3000,
    device="cuda",
) -> World:
    """Build a 3D landmark world from a 2D grid: textured wall surfaces at
    lethal cells + textured floor. Serves both the visual frontend (rendered
    blobs) and traversability (frustum clouds). ``seed`` seeds the numpy
    RandomState (the reference draws it from its jax key; ``ROOMS_WORLD_SEED``
    is the value for ``PRNGKey(5)``)."""
    occ = occ.cpu().numpy() if isinstance(occ, torch.Tensor) else np.asarray(occ)
    rng = np.random.RandomState(seed)
    wall_cells = np.argwhere(occ >= 200)  # (W, 2) as (row, col)
    pts = []
    if len(wall_cells):
        reps = np.repeat(wall_cells, points_per_wall_cell, axis=0)
        jitter = rng.uniform(0, 1, (len(reps), 2))
        xy = np.stack(
            [
                (reps[:, 1] + jitter[:, 0]) * spec.resolution + spec.origin_x,
                (reps[:, 0] + jitter[:, 1]) * spec.resolution + spec.origin_y,
            ],
            axis=-1,
        )
        z = rng.uniform(0.0, wall_height, (len(reps), 1))
        pts.append(np.concatenate([xy, z], axis=-1))
    # floor texture points on free cells
    free_cells = np.argwhere(occ < 200)
    sel = free_cells[rng.randint(0, len(free_cells), floor_points)]
    jitter = rng.uniform(0, 1, (floor_points, 2))
    xy = np.stack(
        [
            (sel[:, 1] + jitter[:, 0]) * spec.resolution + spec.origin_x,
            (sel[:, 0] + jitter[:, 1]) * spec.resolution + spec.origin_y,
        ],
        axis=-1,
    )
    z = np.abs(rng.normal(0.0, 0.02, (floor_points, 1)))
    pts.append(np.concatenate([xy, z], axis=-1))
    return World(torch.as_tensor(np.concatenate(pts, axis=0).astype(np.float32),
                                 device=device))


def frustum_cloud(
    K: Intrinsics,
    landmarks: torch.Tensor,
    T_wc: lie.SE3,
    max_points: int,
    max_depth: float = 10.0,
    width: int = 640,
    height: int = 480,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame point cloud of world points inside the view frustum —
    the slam_keyframe_pcl_simulator equivalent (SURVEY.md §2.1 S6): the
    per-keyframe cloud source for traversability without a depth sensor.
    Returns ((max_points, 3) camera-frame points, (max_points,) mask): the
    nearest points first (``lax.top_k``'s order, ties by index), padding
    invalid."""
    p_c = lie.apply(lie.inverse(T_wc), landmarks)
    z = p_c[..., 2]
    z_ok = z > 0.2
    zs = torch.where(z_ok, z, torch.ones_like(z))
    u = K.fx * p_c[..., 0] / zs + K.cx
    v = K.fy * p_c[..., 1] / zs + K.cy
    vis = z_ok & (z < max_depth) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    score = torch.where(vis, -z, -math.inf)
    # worlds may carry fewer points than the cloud capacity: select what
    # exists and pad the rest as invalid
    k = min(max_points, score.shape[0])
    _, idx = top_k_stable(score, k)
    pts, mask = p_c[idx], vis[idx]
    if k < max_points:
        pad = max_points - k
        pts = torch.cat([pts, pts.new_zeros((pad, 3))], dim=0)
        mask = torch.cat([mask, mask.new_zeros((pad,))], dim=0)
    return pts, mask
