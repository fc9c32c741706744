"""Fisher-information viewpoint safety as batched closed-form tensors (port
of ``fitslam_tpu/ops/fisher.py``).

Reference capability (SURVEY.md §2.2 F1-F3):
- FisherInformationHelpers.cpp:50-91: bearing-measurement Jacobian of the
  unit-vector observation of a landmark, chained with the pose derivative
  (translation -I, rotation [p]x) into a 3x6 Jacobian; FIM = J^T Q^-1 J
  (:93-96); scalar information = trace(FIM) (:98-123).
- FisherInfoManager.cpp:287-324: per-landmark information accumulated with a
  per-voxel saturation factor exp(1 - count^0.8) so dense voxels don't
  over-count.

The trace has a closed form, so it is evaluated directly; the voxel lookup
table is kept for parity (its ``.dat`` file is byte for byte the
reference's). Voxel saturation uses the rank within a voxel from one stable
sort. A division by a configured number is a product with its float32
reciprocal (``div_const``), as the reference's compiler makes it, which
rounds alike on the CPU and the card (ROADMAP F15), and the waypoints of
``path_information`` are rounded as the reference's compiler rounds them
(its linspace and fused multiply-add, F13): a waypoint on a field-of-view
edge would otherwise flip.
"""

from __future__ import annotations

import math
import time
from typing import Tuple

import numpy as np
import torch

from fitslam_tpu_torch.ops import lie
from fitslam_tpu_torch.ops.numerics import div_const, fma32
from fitslam_tpu_torch.utils import logging as logx

_INT32_MAX = 0x7FFFFFFF


def bearing_jacobian_local(p_c: torch.Tensor) -> torch.Tensor:
    """(..., 3) camera-frame point -> (..., 3, 6) Jacobian of the unit-bearing
    observation w.r.t. the local pose perturbation [translation, rotation].

    Reference: computeJacobianForPointLocal, FisherInformationHelpers.cpp:50-91.
    """
    n = torch.clamp_min(torch.linalg.norm(p_c, dim=-1, keepdim=True)[..., None], 1e-6)
    eye = torch.eye(3, dtype=p_c.dtype, device=p_c.device).expand(p_c.shape[:-1] + (3, 3))
    ppT = p_c[..., :, None] * p_c[..., None, :]
    df_dp = eye / n - ppT / (n ** 3)                  # (..., 3, 3)
    # dp_c/d xi: translation -> -I, rotation -> [p]x
    dp_dxi = torch.cat([-eye, lie.skew(p_c)], dim=-1)  # (..., 3, 6)
    return df_dp @ dp_dxi


def point_information_local(p_c: torch.Tensor, noise_var: float = 0.01) -> torch.Tensor:
    """trace(J^T Q^-1 J) per camera-frame point (..., 3) -> (...).

    Reference: computeInformationOfPointLocal, FisherInformationHelpers.cpp:98-123.
    """
    J = bearing_jacobian_local(p_c)
    return div_const(torch.sum(J * J, dim=(-2, -1)), noise_var)


def voxel_key(p_c: torch.Tensor, step_min: float = 0.09, step_max: float = 0.3,
              near_dist: float = 4.0) -> torch.Tensor:
    """Two-resolution voxel id per camera-frame point (..., 3) -> (...) int32.

    Reference: getVoxelCoordinate + LookupKey hashing,
    FisherInfoManager.hpp:25-58 (fine voxels near the camera, coarse far).
    The hash products overflow int32 and wrap, as the reference's do: they
    are taken in int64 and folded back to 32 bits.
    """
    d = torch.linalg.norm(p_c, dim=-1, keepdim=True)
    near = d < near_dist
    step = torch.where(near, torch.full_like(d, step_min), torch.full_like(d, step_max))
    q = torch.round(p_c / step).to(torch.int32).long()
    h = (q[..., 0] * 73856093) ^ (q[..., 1] * 19349663) ^ (q[..., 2] * 83492791)
    # fold the resolution tier into the key so near/far voxels never collide
    h = (h ^ ((~near[..., 0]).long() * 0x5BD1E995)) & 0xFFFFFFFF
    return torch.where(h > _INT32_MAX, h - (1 << 32), h).to(torch.int32)


def pose_information(
    p_c: torch.Tensor,         # (L, 3) camera-frame landmark positions
    valid: torch.Tensor,       # (L,) bool
    noise_var: float = 0.01,
    max_distance: float = 14.0,
    saturation_exponent: float = 0.8,
) -> torch.Tensor:
    """Total saturated Fisher information of a pose given visible landmarks,
    as a 0-d device tensor.

    Per-landmark contribution: info(p) * exp(1 - rank^0.8), rank = 1-based
    arrival order within the landmark's voxel (FisherInfoManager.cpp:287-324,
    FisherInfoManager.hpp:102-106).
    """
    L = p_c.shape[0]
    d = torch.linalg.norm(p_c, dim=-1)
    ok = valid & (d > 1e-3) & (d < max_distance)
    zero = torch.zeros((), dtype=p_c.dtype, device=p_c.device)
    info = torch.where(ok, point_information_local(p_c, noise_var), zero)

    keys = torch.where(ok, voxel_key(p_c), _INT32_MAX)
    keys_s, order = torch.sort(keys, stable=True)
    ar = torch.arange(L, device=p_c.device)
    new_voxel = torch.ones_like(ok)
    new_voxel[1:] = keys_s[1:] != keys_s[:-1]
    seg_start = torch.cummax(torch.where(new_voxel, ar, 0), dim=0).values
    rank = (ar - seg_start + 1).to(torch.float32)   # 1-based
    sat = torch.exp(1.0 - rank ** saturation_exponent)
    return torch.sum(info[order] * sat * ok[order])


def is_pose_safe(total_info: torch.Tensor, threshold: float) -> torch.Tensor:
    """Threshold test (FisherInfoManager.cpp:112-114)."""
    return total_info > threshold


def frontier_pair_information(
    points_xy: torch.Tensor,   # (L, 2) landmark ground-plane positions (world)
    info: torch.Tensor,        # (L,) per-landmark information
    valid: torch.Tensor,       # (L,) bool
    pose_xy: torch.Tensor,     # (F, 2) candidate poses
    target_xy: torch.Tensor,   # (F, 2) frontiers the poses look toward
    fov_half_angle: float = 0.52,
    max_range: float = 14.0,
) -> torch.Tensor:
    """Sum of landmark information inside the 2D FOV triangle from each pose
    toward its frontier (computeInformationFrontierPair,
    FisherInformationHelpers.cpp:125-143 + triangle test hpp:28-45).
    Batched over (F poses x L landmarks)."""
    d = target_xy - pose_xy                              # (F, 2)
    heading = torch.atan2(d[:, 1], d[:, 0])              # (F,)
    rel = points_xy[None, :, :] - pose_xy[:, None, :]    # (F, L, 2)
    rng = torch.linalg.norm(rel, dim=-1)
    ang = torch.atan2(rel[..., 1], rel[..., 0])
    # jnp.mod floors (the result takes the divisor's sign), as remainder does
    two_pi = torch.full((), 2 * math.pi, dtype=ang.dtype, device=ang.device)
    dang = torch.abs(torch.remainder(ang - heading[:, None] + math.pi, two_pi) - math.pi)
    inside = (dang < fov_half_angle) & (rng < max_range) & valid[None, :]
    return torch.sum(torch.where(inside, info[None, :], torch.zeros_like(info[None, :])),
                     dim=-1)


def waypoint_fractions(num_waypoints: int, device=None) -> torch.Tensor:
    """``jnp.linspace(0, 1, num_waypoints)`` in float32 to the last bit: its
    compiler turns i / (S - 1) into i * float32(1 / (S - 1)), and the last
    value is the endpoint 1 itself (``torch.linspace`` computes the second
    half from the end and differs)."""
    if num_waypoints < 2:
        return torch.zeros((num_waypoints,), dtype=torch.float32, device=device)
    recip = float(np.float32(1.0) / np.float32(num_waypoints - 1))
    ts = torch.arange(num_waypoints - 1, dtype=torch.float32, device=device) * recip
    return torch.cat([ts, torch.ones((1,), dtype=torch.float32, device=device)])


def path_information(
    points_xy: torch.Tensor,   # (L, 2) landmark ground-plane positions (world)
    info: torch.Tensor,        # (L,) per-landmark information
    valid: torch.Tensor,       # (L,) bool
    robot_xy: torch.Tensor,    # (2,)
    goal_xy: torch.Tensor,     # (F, 2) candidate frontier goals
    goal_valid: torch.Tensor,  # (F,) bool
    num_waypoints: int = 6,
    fov_half_angle: float = 0.52,
    max_range: float = 14.0,
) -> torch.Tensor:
    """Per-frontier `fisher_information_in_path`: mean FOV-triangle landmark
    information over waypoints along the robot->frontier segment, each
    waypoint looking toward the next (the path-FI accumulation of
    setPlanForFrontier, CostCalculator.cpp:330-389, on a fixed number of
    straight-segment waypoints)."""
    F_ = goal_xy.shape[0]
    ts = waypoint_fractions(num_waypoints, goal_xy.device)
    delta = goal_xy[:, None, :] - robot_xy[None, None, :]
    shape = (F_, num_waypoints, 2)
    wp = fma32(ts[None, :, None].expand(shape), delta.expand(shape),
               robot_xy[None, None, :].expand(shape))            # (F, S, 2)
    pose = wp[:, :-1, :].reshape(-1, 2)
    tgt = wp[:, 1:, :].reshape(-1, 2)
    seg = frontier_pair_information(
        points_xy, info, valid, pose, tgt,
        fov_half_angle=fov_half_angle, max_range=max_range,
    ).reshape(F_, num_waypoints - 1)
    mean = div_const(torch.sum(seg, dim=1), num_waypoints - 1)
    return torch.where(goal_valid, mean, torch.zeros_like(mean))


# ---------------------------------------------------------------------------
# Precomputed voxel table (gen_fi_lookup equivalent)
# ---------------------------------------------------------------------------


def generate_lookup_table(
    x_range: Tuple[float, float] = (0.0, 21.0),
    yz_half: float = 14.722,   # 8.5 * sqrt(3)
    step: float = 0.3,
    noise_var: float = 0.01,
    device="cuda",
):
    """Offline voxel-grid information table (gen_fi_lookup equivalent,
    GenerateLookupMain.cpp:5-17 / FisherInfoManager.cpp:117-229).

    Returns (grid values (Nx, Ny, Nz) float32, axes); the axes are the
    reference's float32 ``arange`` samples."""
    xs, ys, zs = (torch.as_tensor(np.arange(a, b + step / 2, step, dtype=np.float32),
                                  device=device)
                  for a, b in (x_range, (-yz_half, yz_half), (-yz_half, yz_half)))
    X, Y, Z = torch.meshgrid(xs, ys, zs, indexing="ij")
    # the reference sweeps x forward (optical axis z in our convention)
    pts = torch.stack([Y, Z, X], dim=-1).reshape(-1, 3)
    vals = point_information_local(pts, noise_var).reshape(X.shape)
    return vals, (xs, ys, zs)


_LOOKUP_MAGIC = 0x46495431  # "FIT1"


def save_lookup_table(path: str, vals, axes) -> None:
    """Write the table as a binary .dat, byte for byte the reference's
    format: int32 header {magic, Nx, Ny, Nz}, float32 {x0, x1, y0, y1, z0,
    z1, step}, then the float32 grid."""
    vals = np.asarray(torch.as_tensor(vals).cpu(), np.float32)
    xs, ys, zs = (np.asarray(torch.as_tensor(a).cpu(), np.float32) for a in axes)
    with open(path, "wb") as f:
        np.array([_LOOKUP_MAGIC, *vals.shape], np.int32).tofile(f)
        np.array(
            [xs[0], xs[-1], ys[0], ys[-1], zs[0], zs[-1],
             xs[1] - xs[0] if len(xs) > 1 else 1.0],
            np.float32,
        ).tofile(f)
        vals.tofile(f)


def load_lookup_table(path: str, device="cuda"):
    """Read a table written by either package's save_lookup_table and log
    the reference's stats (entry count, min/max/mean/var, load ms —
    FisherInfoManager.cpp:231-262). Returns (vals (Nx, Ny, Nz), axes) on
    ``device``."""
    t0 = time.perf_counter()
    with open(path, "rb") as f:
        head = np.fromfile(f, np.int32, 4)
        if head[0] != _LOOKUP_MAGIC:
            raise ValueError(f"{path}: not a FIM lookup table")
        nx, ny, nz = (int(v) for v in head[1:])
        rng = np.fromfile(f, np.float32, 7)
        vals = np.fromfile(f, np.float32, nx * ny * nz).reshape(nx, ny, nz)
    xs = np.linspace(rng[0], rng[1], nx, dtype=np.float32)
    ys = np.linspace(rng[2], rng[3], ny, dtype=np.float32)
    zs = np.linspace(rng[4], rng[5], nz, dtype=np.float32)
    ms = (time.perf_counter() - t0) * 1e3
    logx.info(
        f"FIM lookup: {vals.size} entries, "
        f"min {vals.min():.3g} max {vals.max():.3g} "
        f"mean {vals.mean():.3g} var {vals.var():.3g}, loaded in {ms:.1f} ms"
    )
    return (torch.as_tensor(vals, device=device),
            tuple(torch.as_tensor(a, device=device) for a in (xs, ys, zs)))


def lookup_information(
    table: torch.Tensor,       # (Nx, Ny, Nz) float32 grid
    axes_min: torch.Tensor,    # (3,) first sample of each axis
    axes_step: torch.Tensor,   # (3,) axis spacing
    p_c: torch.Tensor,         # (..., 3) camera-frame points
) -> torch.Tensor:
    """Nearest-voxel table evaluation (the lookup-table runtime path of the
    reference, FisherInfoManager.cpp:287-324). Points outside the table
    return 0 (the reference's hash-miss behavior)."""
    # table axes are (forward, y, z) in the reference's sweep order: forward
    # = our optical z, table (y, z) = our camera (x, y)
    coords = torch.stack([p_c[..., 2], p_c[..., 0], p_c[..., 1]], dim=-1)
    idx = torch.round((coords - axes_min) / axes_step).to(torch.int32)
    inb = torch.ones(idx.shape[:-1], dtype=torch.bool, device=idx.device)
    cols = []
    for k, n in enumerate(table.shape):
        inb = inb & (idx[..., k] >= 0) & (idx[..., k] < n)
        cols.append(torch.clamp(idx[..., k], 0, n - 1).long())
    vals = table[cols[0], cols[1], cols[2]]
    return torch.where(inb, vals, torch.zeros_like(vals))
