"""Procedural worlds and frames (port of ``fitslam_tpu/data/synthetic.py``):
straight corridor and ring loop trajectories, a Gaussian-blob stereo
renderer and an RGB-D sensor model of a landmark world, per-keyframe frustum
clouds, 3D worlds built from an occupancy grid, and the marsyard heightfield
world. A rendered frame is the same on every run of the card and equals the
CPU's (ROADMAP fault F18): overlapping blobs add a pixel in a fixed order
(``numerics.segment_sum_fixed``), the camera transform is written out as
fused multiply-adds in a fixed order (``numerics.fma32``), the blob weights'
``exp`` is taken in float64 and rounded once, and the blob style divides
truly (``numerics.true_div``).

The worlds the reference draws with ``jax.random`` (``make_landmark_field``,
``corridor_world``, ``ring_world`` and ``render_sparse``'s noise) are drawn
bit for bit by ``utils/prng.py`` on the host and uploaded (ROADMAP F4,
closed): each takes the raw key of ``prng.prng_key(seed)``. Their float32
arithmetic is the reference's operation for operation; the ring's sines and
cosines are the C library's ``sinf`` / ``cosf``, which XLA's CPU calls too.
The tests regenerate the reference's worlds committed under ``tests/data/``
(bench.py's corridor, the loop bench's rings, the ``--record`` corridor).
``world_from_occupancy`` draws from a numpy ``RandomState`` whose integer
seed the reference takes from ``jax.random.randint``; ``ROOMS_WORLD_SEED`` is
that integer for ``PRNGKey(5)``, derived by ``prng.randint``.
``marsyard_world`` is numpy in both packages.

Functions that render or cull take the world's (L, 3) landmark tensor.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from fitslam_tpu_torch.ops import lie
from fitslam_tpu_torch.ops.geometry import Intrinsics, project_stereo
from fitslam_tpu_torch.ops.numerics import fma32, segment_sum_fixed, top_k_stable, true_div
from fitslam_tpu_torch.utils import jit, profiling, prng
from fitslam_tpu_torch.utils.transfer import upload

# the integer the reference's world_from_occupancy seeds its RandomState
# with for jax.random.PRNGKey(5): int(jax.random.randint(key, (), 0, 2**31 - 1))
ROOMS_WORLD_SEED = int(prng.randint(prng.prng_key(5), (), 0, 2**31 - 1))


class World(NamedTuple):
    landmarks: torch.Tensor   # (L, 3) world points
    terrain_fn: object = None


def make_landmark_field(key, num: int, extent_xy: float = 30.0,
                        z_range: Tuple[float, float] = (0.0, 2.5), device="cuda") -> World:
    """Uniform landmark cloud in a box (corridor/field scene stand-in);
    ``key`` is a raw ``prng`` key."""
    k1, k2 = prng.split(key)
    xy = prng.uniform(k1, (num, 2), -extent_xy, extent_xy)
    z = prng.uniform(k2, (num, 1), z_range[0], z_range[1])
    return World(torch.as_tensor(np.concatenate([xy, z], axis=-1), device=device))


def _wall_offsets(k_side, k_noise, num: int, base: float, width: float) -> np.ndarray:
    """base + side * width / 2 + 0.05 * normal, float32 in the reference's
    order (side from a fair coin); XLA keeps the last product and sum apart."""
    side = np.where(prng.bernoulli(k_side, 0.5, (num,)), np.float32(1), np.float32(-1))
    wall = np.float32(base) + side * np.float32(width) / np.float32(2)
    return wall + np.float32(0.05) * prng.normal(k_noise, (num,))


def corridor_world(key, num: int = 4096, length: float = 40.0, width: float = 4.0,
                   device="cuda") -> World:
    """Landmarks on the two walls of a corridor along +x (indoor sequence);
    ``key`` is a raw ``prng`` key."""
    k1, k2, k3 = prng.split(key, 3)
    x = prng.uniform(k1, (num,), 0.0, length)
    y = _wall_offsets(k2, k3, num, 0.0, width)
    z = prng.uniform(prng.fold_in(key, 7), (num,), 0.0, 2.5)
    return World(torch.as_tensor(np.stack([x, y, z], axis=-1), device=device))


def _libm_f32(name: str):
    fn = getattr(ctypes.CDLL(ctypes.util.find_library("m")), name)
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return np.frompyfunc(fn, 1, 1)


def ring_world(key, num: int = 6000, radius: float = 12.0, width: float = 5.0,
               device="cuda") -> World:
    """Landmarks on the two walls of a ring corridor (the loop sequence):
    a camera driving the ring sees both walls ahead, and the loop trajectory
    revisits its start. ``key`` is a raw ``prng`` key; the angle's sine and
    cosine are the C library's float32 ``sinf`` / ``cosf``, as XLA's CPU
    takes them."""
    k1, k2, k3, k4 = prng.split(key, 4)
    ang = prng.uniform(k1, (num,), 0.0, 2.0 * math.pi)
    r = _wall_offsets(k2, k3, num, radius, width)
    z = prng.uniform(k4, (num,), 0.0, 2.5)
    cos = _libm_f32("cosf")(ang).astype(np.float32)
    sin = _libm_f32("sinf")(ang).astype(np.float32)
    return World(torch.as_tensor(np.stack([r * cos, r * sin, z], axis=-1), device=device))


def loop_trajectory(num_frames: int, radius: float = 12.0, height: float = 1.2,
                    device="cuda") -> lie.SE3:
    """Camera going around a circle, facing along it: closes a loop. Returns
    world-from-camera poses (T_wc), camera +z forward, +x right, +y down.
    The angles are ``jnp.linspace``'s float32 values as its compiler folds
    them (i times the float32 constant stop * (1 / (n - 1)), the last one
    stop), and the sines and cosines are correctly rounded, so the poses are
    the same on either device and within an ulp of the reference's."""
    stop = np.float32(2.0 * math.pi)
    if num_frames > 1:
        step = float(stop * (np.float32(1.0) / np.float32(num_frames - 1)))
        s = torch.cat([torch.arange(num_frames - 1, dtype=torch.float32, device=device) * step,
                       torch.full((1,), float(stop), dtype=torch.float32, device=device)])
    else:
        s = torch.zeros((num_frames,), dtype=torch.float32, device=device)

    def cos(x):
        return torch.cos(x.double()).float()

    def sin(x):
        return torch.sin(x.double()).float()

    cx = radius * cos(s)
    cy = radius * sin(s)
    cz = torch.full_like(s, height)
    yaw = s + math.pi / 2   # tangent direction
    fwd = torch.stack([cos(yaw), sin(yaw), torch.zeros_like(yaw)], dim=-1)
    # camera y (down in the image) is world -z
    down = torch.tensor([0.0, 0.0, -1.0], device=device).expand(fwd.shape)
    right = torch.linalg.cross(down, fwd)
    R_wc = torch.stack([right, down, fwd], dim=-1)   # columns: camera axes in world
    return lie.SE3(R_wc, torch.stack([cx, cy, cz], dim=-1))


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


class SparseFrame(NamedTuple):
    """Ground-truth-projected landmark observations for one frame."""

    uvr: torch.Tensor       # (M, 3) [u, v, u_r] noisy pixel observations
    lm_id: torch.Tensor     # (M,) int32 landmark index (ground truth association)
    valid: torch.Tensor     # (M,) bool


def sparse_noise(key, max_obs: int, noise_px: float = 0.5) -> np.ndarray:
    """``render_sparse``'s (max_obs, 3) float32 pixel noise: ``noise_px``
    times a normal draw, u_r's column correlated with u's."""
    noise = np.float32(noise_px) * prng.normal(key, (max_obs, 3))
    noise[:, 2] = noise[:, 2] * np.float32(0.5) + noise[:, 0]
    return noise


def render_sparse(K: Intrinsics, landmarks: torch.Tensor, T_wc: lie.SE3, key, max_obs: int,
                  noise_px: float = 0.5, width: int = 640, height: int = 480,
                  max_depth: float = 14.0) -> SparseFrame:
    """Project all landmarks into the camera; keep up to ``max_obs`` visible
    ones, the closest first (``lax.top_k``'s order, ties by index), with a
    validity mask, plus ``sparse_noise(key)``: deterministic given the raw
    ``prng`` key."""
    p_c = lie.apply(lie.inverse(T_wc), landmarks)
    uvr, z_ok = project_stereo(K, p_c)
    u, v = uvr[..., 0], uvr[..., 1]
    vis = (z_ok & (p_c[..., 2] < max_depth) & (u >= 1) & (u < width - 1)
           & (v >= 1) & (v < height - 1) & (uvr[..., 2] >= 1))
    score = torch.where(vis, -p_c[..., 2], -math.inf)   # prefer close landmarks
    _, idx = top_k_stable(score, max_obs)
    obs = uvr[idx] + upload(sparse_noise(key, max_obs, noise_px), landmarks.device)
    return SparseFrame(obs, idx.to(torch.int32), vis[idx])


def _hash01(i: torch.Tensor) -> torch.Tensor:
    """The reference's uint32 hash, in int64 arithmetic masked to 32 bits,
    scaled to [0, 1] by a true division on either device."""
    x = (i.long() * 2654435761) & 0xFFFFFFFF
    x = x ^ 0x9E3779B9
    x = x ^ (x >> 16)
    return true_div((x & 0xFFFF).float(), 65535.0)


def _splat(u, v, lum, height, width, sigma):
    """Scatter-add Gaussian blobs: a 7x7 stamp per landmark, each pixel's
    stamps added in landmark order. ``sigma`` is a scalar or a per-landmark
    (L,) tensor."""
    R = 3
    dev = u.device
    iu = torch.round(u).long()
    iv = torch.round(v).long()
    offs = torch.arange(-R, R + 1, device=dev)
    dy, dx = torch.meshgrid(offs, offs, indexing="ij")
    sig = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
    sig = sig[:, None, None] if sig.dim() == 1 else sig
    # float64 exp rounded once: the float32 exp of the CPU and of the card
    # differ in the last bit
    w = torch.exp((-(dx ** 2 + dy ** 2) / (2 * sig * sig)).double()).float()
    w = torch.broadcast_to(w, (u.shape[0], 2 * R + 1, 2 * R + 1))
    rows = iv[:, None, None] + dy[None]
    cols = iu[:, None, None] + dx[None]
    vals = lum[:, None, None] * w
    inb = (rows >= 0) & (rows < height) & (cols >= 0) & (cols < width)
    flat = torch.where(inb, rows * width + cols, height * width)
    img = segment_sum_fixed(torch.where(inb, vals, 0.0).reshape(-1), flat.reshape(-1),
                            height * width)
    return torch.clamp(img.reshape(height, width), 0.0, 255.0)


def _dot3(a0, b0, a1, b1, a2, b2):
    """a0 b0 + a1 b1 + a2 b2 as a product and two fused multiply-adds in that
    order (``numerics.fma32``), the rounding of the CPU's matrix product."""
    return fma32(a2, b2, fma32(a1, b1, a0 * b0))


def _to_camera(T_wc: lie.SE3, pts: torch.Tensor) -> torch.Tensor:
    """``lie.apply(lie.inverse(T_wc), pts)`` for (N, 3) world points, equal
    to the CPU's matrix products bit for bit and rounded alike on the card,
    whose matrix product sums in its library's order."""
    R, t = T_wc.R, T_wc.t
    t_inv = [-_dot3(R[0, i], t[0], R[1, i], t[1], R[2, i], t[2]) for i in range(3)]
    return torch.stack([_dot3(pts[:, 0], R[0, i], pts[:, 1], R[1, i], pts[:, 2], R[2, i])
                        + t_inv[i] for i in range(3)], dim=-1)


def _eye_image(K: Intrinsics, landmarks: torch.Tensor, T_cam: lie.SE3, lum, sig,
               width: int, height: int, max_depth: float) -> torch.Tensor:
    p_c = _to_camera(T_cam, landmarks)
    uvr, z_ok = project_stereo(K, p_c)
    vis = z_ok & (p_c[..., 2] < max_depth)
    return _splat(uvr[..., 0], uvr[..., 1], torch.where(vis, lum, 0.0), height, width, sig)


def _blob_style(landmarks: torch.Tensor, splat_sigma: float):
    """Per-landmark deterministic intensity and blob width."""
    idx = torch.arange(landmarks.shape[0], device=landmarks.device)
    return 60.0 + 195.0 * _hash01(idx), splat_sigma * (0.6 + 1.4 * _hash01(idx + 77777))


def _stereo_images(K: Intrinsics, landmarks: torch.Tensor, T_wc: lie.SE3, lum, sig,
                   width: int, height: int, max_depth: float):
    left = _eye_image(K, landmarks, T_wc, lum, sig, width, height, max_depth)
    # right camera: offset by +baseline along the camera x-axis
    right = _eye_image(K, landmarks, lie.SE3(T_wc.R, T_wc.t + T_wc.R[..., :, 0] * K.baseline),
                       lum, sig, width, height, max_depth)
    return left, right


def render_dense(K: Intrinsics, landmarks: torch.Tensor, T_wc: lie.SE3, width: int = 640,
                 height: int = 480, splat_sigma: float = 1.5,
                 max_depth: float = 25.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render (left, right) grayscale images: landmarks splatted as Gaussian
    blobs with per-landmark deterministic intensity and size."""
    lum, sig = _blob_style(landmarks, splat_sigma)
    return _stereo_images(K, landmarks, T_wc, lum, sig, width, height, max_depth)


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
    return _rgbd_images(K, landmarks, T_wc, lum, sig, width, height, max_depth)


def _rgbd_images(K: Intrinsics, landmarks: torch.Tensor, T_wc: lie.SE3, lum, sig,
                 width: int, height: int, max_depth: float):
    img = _eye_image(K, landmarks, T_wc, lum, sig, width, height, max_depth)
    p_c = _to_camera(T_wc, landmarks)
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


# ---------------------------------------------------------------------------
# The simulated camera as a captured program
# ---------------------------------------------------------------------------


def camera_region(landmarks, lum, sig, K, T_wc, *, width: int, height: int, max_depth: float,
                  rgbd: bool, cloud_points: int, cloud_depth: float):
    """Region ``camera`` / ``camera+rgbd``: the frame at the staged pose
    ``T_wc`` (left and right images, or the image and its depth image) and,
    with ``cloud_points``, ``frustum_cloud``'s points and mask. Writes
    nothing."""
    images = (_rgbd_images if rgbd else _stereo_images)(K, landmarks, T_wc, lum, sig, width,
                                                        height, max_depth)
    if not cloud_points:
        return (), images
    return (), images + frustum_cloud(K, landmarks, T_wc, cloud_points, max_depth=cloud_depth,
                                      width=width, height=height)


class SimCamera:
    """The simulated stereo (or, with ``rgbd``, RGB-D) camera over one
    landmark world, with its frustum cloud of ``cloud_points`` points out to
    ``cloud_depth`` when that is not 0: the reference's compiled
    ``render_stereo`` / ``render_rgbd`` (and ``frustum_cloud`` on the same
    pose) as region ``camera`` / ``camera+rgbd`` of its slot
    (``utils/jit.py``; a CUDA graph on a CUDA device). The landmarks, their
    blob style and the intrinsics live in the slot's buffers, so a frame
    copies in only its pose. ``frame`` returns views of the region's output
    buffer, which the next frame overwrites: a caller that keeps one across
    frames (a cloud pending a keyframe) takes ``jit.hold`` of it.
    ``capture=False`` runs the region as plain PyTorch, the same functions
    as ``render_stereo``, ``render_rgbd`` and ``frustum_cloud``."""

    def __init__(self, K: Intrinsics, landmarks: torch.Tensor, width: int = 640,
                 height: int = 480, max_depth: float = 18.0, cloud_points: int = 0,
                 cloud_depth: float = 10.0, rgbd: bool = False, splat_sigma: float = 1.2,
                 capture: bool = True):
        self.device = landmarks.device
        self.capture = capture
        self.name = "camera+rgbd" if rgbd else "camera"
        self._fn = functools.partial(camera_region, width=width, height=height,
                                     max_depth=max_depth, rgbd=rgbd, cloud_points=cloud_points,
                                     cloud_depth=cloud_depth)
        lum, sig = _blob_style(landmarks, splat_sigma)
        key = ("SimCamera", width, height, max_depth, splat_sigma, cloud_points, cloud_depth,
               rgbd, landmarks.shape[0])
        self._slot_state = jit.SlotState(self, key, self.device, {
            "world": (landmarks, lum, sig),
            "K": Intrinsics(*(torch.as_tensor(v, dtype=torch.float32).to(self.device)
                              for v in K)),
        }, capture)

    @property
    def capture_stats(self):
        """{region: calls, captured, capture seconds, graph pool bytes}; empty
        on the eager path."""
        return self._slot_state.stats()

    @profiling.layer("SimCamera.frame")
    def frame(self, T_wc: lie.SE3):
        """The frame at the world-from-camera pose ``T_wc`` (device
        tensors): (left, right) or (image, depth), then (cloud points, mask)
        with a cloud."""
        if self.capture:
            self._slot_state.claim()     # the region then reads its buffers
        world = self._slot_state["world"]
        _, out = self._slot_state.run(self.name, self._fn, *world, self._slot_state["K"], T_wc)
        return out
