"""Plain reference of the FI gate's value: the Fisher information of a
camera pose from the landmarks it sees (FIT-SLAM's isPoseSafe).

The query: a robot at (x, y) with heading yaw carries its camera 0.8 m up,
looking along the heading (+z forward, +y down). A landmark is seen when it
lies in front of the camera (depth over 1e-3 m), closer than
``max_distance`` and projects inside the image. Each seen landmark at p
(camera frame, |p| = n) gives trace(J^T J) / noise, where J = (I / n - p
p^T / n^3) [-I | [p]x] is the Jacobian of its unit bearing with respect to
the pose's translation and rotation. Landmarks share voxels, 0.09 m wide
nearer than 4 m and 0.3 m beyond (the cell of round(p / width), named by the
reference's hash of its three indices and its tier); the k-th landmark of a
voxel, in the map's order, counts exp(1 - k^0.8) times. The value is the
sum. ``dtype`` sets the precision of the geometry and the sum (float64
here; the control runs it in bfloat16).
"""

from __future__ import annotations

import math

import torch


def camera_pose(x: float, y: float, yaw: float, height: float = 0.8, dtype=torch.float64,
                device="cpu"):
    """World-from-camera (R, t) of the robot's camera."""
    fwd = torch.tensor([math.cos(yaw), math.sin(yaw), 0.0], dtype=dtype, device=device)
    down = torch.tensor([0.0, 0.0, -1.0], dtype=dtype, device=device)
    right = torch.linalg.cross(down, fwd)
    return torch.stack([right, down, fwd], -1), torch.tensor([x, y, height], dtype=dtype,
                                                             device=device)


def information(lm_pos, lm_valid, R_wc, t_wc, K, width, height, max_distance, noise_var,
                saturation_exponent, dtype=torch.float64) -> float:
    """The pose's information from the landmarks ``lm_pos`` (L, 3) where
    ``lm_valid``, all in one frame with the camera pose (``R_wc``,
    ``t_wc``); ``K`` = (fx, fy, cx, cy)."""
    fx, fy, cx, cy = K
    R, t = R_wc.to(dtype), t_wc.to(dtype)
    p = (lm_pos.to(dtype) - t) @ R               # camera frame = R^T (p - t)
    z = p[:, 2]
    zs = torch.where(z > 1e-3, z, torch.ones_like(z))
    u, v = fx * p[:, 0] / zs + cx, fy * p[:, 1] / zs + cy
    n = torch.linalg.norm(p, dim=-1)
    ok = (lm_valid & (z > 1e-3) & (n < max_distance) & (n > 1e-3) & (u >= 0) & (u < width)
          & (v >= 0) & (v < height))
    p, n = p[ok], n[ok]
    eye = torch.eye(3, dtype=dtype, device=p.device).expand(p.shape[0], 3, 3)
    df = eye / n[:, None, None] - p[:, :, None] * p[:, None, :] / n[:, None, None] ** 3
    zero = torch.zeros_like(p[:, 0])
    skew = torch.stack([torch.stack([zero, -p[:, 2], p[:, 1]], -1),
                        torch.stack([p[:, 2], zero, -p[:, 0]], -1),
                        torch.stack([-p[:, 1], p[:, 0], zero], -1)], -2)
    J = df @ torch.cat([-eye, skew], -1)
    info = (J * J).sum((-2, -1)) / noise_var
    # voxels: the reference's hash of the cell indices and the tier
    near = n < 4.0
    width_v = torch.full_like(n, 0.3).masked_fill(near, 0.09)
    q = torch.round(p / width_v[:, None]).double().long()
    h = (q[:, 0] * 73856093) ^ (q[:, 1] * 19349663) ^ (q[:, 2] * 83492791)
    h = (h ^ ((~near).long() * 0x5BD1E995)) & 0xFFFFFFFF
    order = torch.argsort(h, stable=True)
    hs = h[order]
    first = torch.ones_like(hs, dtype=torch.bool)
    first[1:] = hs[1:] != hs[:-1]
    ar = torch.arange(hs.numel(), device=hs.device)
    start = torch.cummax(torch.where(first, ar, 0), 0).values
    rank = (ar - start + 1).to(dtype)
    sat = torch.exp(1.0 - rank ** saturation_exponent)
    return float((info[order] * sat).sum())
