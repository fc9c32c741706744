"""A frozen copy of the port's trajectory error (``fitslam_tpu_torch/utils/
evaluation.py:12-53``, without the Sim(3) branch): absolute trajectory
error RMSE over camera positions after a best-fit SE(3) alignment, in
float64 numpy on the host."""

from __future__ import annotations

import numpy as np


# utils/evaluation.py:12-23
def umeyama_alignment(est: np.ndarray, gt: np.ndarray):
    """Best-fit SE(3) (R, t) aligning est -> gt (no scale); (N, 3) arrays."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    U, _, Vt = np.linalg.svd(E.T @ G)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1.0
    R = (U @ S @ Vt).T
    return R, mu_g - R @ mu_e


# utils/evaluation.py:26-53
def ate_rmse(traj_est, traj_gt, align: bool = True) -> float:
    """RMSE of the positions of two lists of 4x4 world-from-camera matrices
    (or (N, 3) arrays), the estimate aligned to the truth first."""
    p_e = _positions(traj_est)
    p_g = _positions(traj_gt)
    n = min(len(p_e), len(p_g))
    p_e, p_g = p_e[:n], p_g[:n]
    if align and n >= 3:
        R, t = umeyama_alignment(p_e, p_g)
        p_e = p_e @ R.T + t
    return float(np.sqrt(np.mean(np.sum((p_e - p_g) ** 2, axis=1))))


# utils/evaluation.py:72-83
def _positions(traj) -> np.ndarray:
    arr = np.asarray(traj, dtype=np.float64)
    if arr.ndim == 3 and arr.shape[-2:] == (4, 4):
        return arr[:, :3, 3]
    if arr.ndim == 2 and arr.shape[-1] == 3:
        return arr
    raise ValueError(f"unsupported trajectory shape {arr.shape}")
