"""Plain reference of frame tracking against a landmark map: match a frame's
ORB features to the map's landmarks projected by a camera pose, and refine
that pose by Gauss-Newton on the robust reprojection error.

The reference starts from the pose the program reported and the map the
program holds after the frame, so it checks that the pose is the optimum of
the frame's own reprojection error against that map (a stale, shifted or
imprecise pose moves away from it), not how the program got there. Matching:
each feature takes the landmark of lowest Hamming distance among the valid
landmarks that project within ``radius`` pixels, if the distance is at most
``max_hamming`` and below ``ratio`` times the second lowest. The error of a
match is its pixel residual over the feature's pyramid-level scale, with a
Huber weight at ``huber`` (sqrt of the 95 % chi-square bound of 2 degrees
of freedom). ``dtype`` sets the precision of every step (float64 here; the
control runs it in bfloat16, the linear solve in float32).
"""

from __future__ import annotations

import math

import torch

HUBER = math.sqrt(5.991)


def _hat(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _exp_so3(w: torch.Tensor) -> torch.Tensor:
    th = torch.linalg.norm(w)
    W = _hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    if float(th) < 1e-12:
        return eye + W
    return eye + torch.sin(th) / th * W + (1 - torch.cos(th)) / th ** 2 * (W @ W)


def project(R, t, p, fx, fy, cx, cy):
    pc = p @ R.T + t
    z = pc[:, 2]
    return pc, torch.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy], -1), z


def match(xy, desc, lm_pos, lm_desc, lm_valid, R, t, K, width, height,
          radius=8.0, max_hamming=64, ratio=0.8, dtype=torch.float64):
    """(feature index, landmark index) of the accepted matches."""
    fx, fy, cx, cy = K
    pc, uv, z = project(R, t, lm_pos.to(dtype), fx, fy, cx, cy)
    vis = lm_valid & (z > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < width) & (uv[:, 1] >= 0) \
        & (uv[:, 1] < height)
    ids = torch.nonzero(vis).reshape(-1)
    if ids.numel() < 2:
        return ids[:0], ids[:0]
    a = desc.to(torch.float32) * 2 - 1
    b = lm_desc[ids].to(torch.float32) * 2 - 1
    ham = (256 - a @ b.T) / 2                                   # exact integers
    d2 = ((xy.to(dtype)[:, None, :] - uv[ids][None, :, :]) ** 2).sum(-1)
    ham = torch.where(d2 <= radius * radius, ham, torch.full_like(ham, 1e9))
    two = torch.topk(ham, 2, dim=1, largest=False)
    best, second = two.values[:, 0], two.values[:, 1]
    ok = (best <= max_hamming) & (best < ratio * second)
    # one feature a landmark: the closest in Hamming distance, none on a tie
    lm = two.indices[:, 0]
    big = torch.full((ids.numel(),), 1e9, dtype=best.dtype, device=best.device)
    low = big.scatter_reduce(0, lm[ok], best[ok], "amin")
    n_low = torch.zeros_like(big).scatter_add(0, lm[ok], (best[ok] == low[lm[ok]]).to(big.dtype))
    ok = ok & (best == low[lm]) & (n_low[lm] == 1)
    f = torch.nonzero(ok).reshape(-1)
    return f, ids[lm[f]]


def refine_pose(R, t, uvr_obs, sigma, p_w, K, bf, iters=10, dtype=torch.float64):
    """Gauss-Newton on T_cw = (R, t) from the given start: left increments
    (translation, rotation), Huber-weighted residuals over ``sigma``; a row
    whose right-image column ``uvr_obs[:, 2]`` is positive has the stereo
    residual too. Two rounds: the second without the rows whose error
    passes the 95 % chi-square bound (2 or 3 degrees of freedom) after the
    first."""
    keep = torch.ones_like(sigma, dtype=torch.bool)
    for _ in range(2):
        R, t, chi2 = _gauss_newton(R, t, uvr_obs[keep], sigma[keep], p_w[keep], K, bf, iters,
                                   dtype)
        _, _, chi2 = _gauss_newton(R, t, uvr_obs, sigma, p_w, K, bf, 0, dtype)
        keep = chi2 < torch.where(uvr_obs[:, 2] > 0, 7.815, 5.991)
    return R, t


def _gauss_newton(R, t, uvr_obs, sigma, p_w, K, bf, iters, dtype):
    """``iters`` steps; returns (R, t, each row's chi2 at the result)."""
    fx, fy, cx, cy = K
    solve_t = torch.float32 if dtype == torch.bfloat16 else dtype
    R, t = R.to(dtype), t.to(dtype)
    p_w, uvr_obs, sigma = p_w.to(dtype), uvr_obs.to(dtype), sigma.to(dtype)
    stereo = (uvr_obs[:, 2] > 0).to(dtype)
    for _ in range(iters):
        pc, uv, z = project(R, t, p_w, fx, fy, cx, cy)
        ur = uv[:, 0] - bf / z
        r = torch.cat([uv - uvr_obs[:, :2], ((ur - uvr_obs[:, 2]) * stereo)[:, None]], -1)
        r = r / sigma[:, None]
        e = torch.linalg.norm(r.float(), dim=-1).to(dtype)
        w = torch.where(e <= HUBER, torch.ones_like(e), HUBER / e)
        x, y = pc[:, 0], pc[:, 1]
        zero = torch.zeros_like(z)
        J_p = torch.stack([torch.stack([fx / z, zero, -fx * x / z ** 2], -1),
                           torch.stack([zero, fy / z, -fy * y / z ** 2], -1),
                           torch.stack([fx / z, zero, (-fx * x + bf) / z ** 2], -1)
                           * stereo[:, None]], -2)
        J_p = J_p / sigma[:, None, None]
        eye = torch.eye(3, dtype=dtype, device=pc.device).expand(pc.shape[0], 3, 3)
        J = J_p @ torch.cat([eye, -_hat(pc)], -1)               # (M, 3, 6)
        Jw = J * w[:, None, None]
        H = torch.einsum("mki,mkj->ij", Jw, J).to(solve_t)
        g = torch.einsum("mki,mk->i", Jw, r).to(solve_t)
        dx = -torch.linalg.solve(H + 1e-9 * torch.eye(6, dtype=solve_t, device=H.device), g)
        dR = _exp_so3(dx[3:]).to(dtype)
        R = dR @ R
        t = dR @ t + dx[:3].to(dtype)
    pc, uv, z = project(R, t, p_w, fx, fy, cx, cy)
    r = torch.cat([uv - uvr_obs[:, :2], ((uv[:, 0] - bf / z - uvr_obs[:, 2]) * stereo)[:, None]],
                  -1) / sigma[:, None]
    return R, t, (r.double() ** 2).sum(-1)


def pose_check(T_wc, feats_uvr, feats_level, feats_desc, scale_factor, lm_pos, lm_desc,
               lm_valid, K, bf, width, height, dtype=torch.float64):
    """The reference's refinement of the reported world-from-camera pose
    ``T_wc`` (4x4): (gap of the camera position in m, gap of the rotation in
    rad, matches used). ``feats_*`` are the reference frontend's features
    ([u, v, right-image u or -1]); ``lm_*`` the map's landmarks
    (``lm_desc`` bool)."""
    T_wc = torch.as_tensor(T_wc, dtype=torch.float64, device=lm_pos.device)
    R0 = T_wc[:3, :3].T.contiguous()
    t0 = -(R0 @ T_wc[:3, 3])
    Kd = tuple(float(k) for k in K)
    f, l = match(feats_uvr[:, :2], feats_desc, lm_pos, lm_desc, lm_valid, R0.to(dtype),
                 t0.to(dtype), Kd, width, height, dtype=dtype)
    if f.numel() < 6:
        return math.inf, math.inf, int(f.numel())
    sigma = scale_factor ** feats_level[f].to(torch.float64)
    R, t = refine_pose(R0, t0, feats_uvr[f], sigma, lm_pos[l], Kd, bf, dtype=dtype)
    R, t = R.double(), t.double()
    c_ref, c_rep = -(R.T @ t), T_wc[:3, 3]
    M = R @ R0.T
    sin = torch.linalg.norm(torch.stack([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0],
                                         M[1, 0] - M[0, 1]])) / 2
    angle = torch.atan2(sin, (torch.trace(M) - 1) / 2)
    return float(torch.linalg.norm(c_ref - c_rep)), float(angle), int(f.numel())


def triangulate(uv, disp, K, bf, R_cw, t_cw, dtype=torch.float64):
    """World points of stereo observations: pixel ``uv`` (M, 2) of the left
    image with disparity ``disp`` (M,) (px) seen from the camera-from-world
    pose (``R_cw``, ``t_cw``): depth bf / disparity, back-projected through
    the pinhole ``K`` = (fx, fy, cx, cy), moved into the world. Every step
    in ``dtype``."""
    fx, fy, cx, cy = K
    uv, disp = uv.to(dtype), disp.to(dtype)
    R, t = R_cw.to(dtype), t_cw.to(dtype)
    z = bf / disp
    p_c = torch.stack([(uv[:, 0] - cx) * z / fx, (uv[:, 1] - cy) * z / fy, z], -1)
    return (p_c - t) @ R
