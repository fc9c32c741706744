"""Absolute and relative trajectory error, path length and coverage (port of
``fitslam_tpu/utils/evaluation.py``), in numpy on the host: evaluation never
touches device state. The tests hold them equal to the reference."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def umeyama_alignment(est: np.ndarray, gt: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Best-fit SE(3) (R, t) aligning est -> gt (no scale). (N, 3) arrays."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    U, _, Vt = np.linalg.svd(E.T @ G)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1.0
    R = (U @ S @ Vt).T
    t = mu_g - R @ mu_e
    return R, t


def ate_rmse(traj_est: Sequence[np.ndarray], traj_gt: Sequence[np.ndarray],
             align: bool = True, with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE over positions, after an SE(3)
    alignment, or a Sim(3) one with ``with_scale`` (the TUM/evo ``--scale``
    mode: the gap between the two isolates a uniform map-scale error, which
    loop closure cannot observe). Inputs: lists of 4x4 world-from-camera
    matrices or (N, 3) position arrays."""
    p_e = _positions(traj_est)
    p_g = _positions(traj_gt)
    n = min(len(p_e), len(p_g))
    p_e, p_g = p_e[:n], p_g[:n]
    if align and n >= 3:
        if with_scale:
            mu_e, mu_g = p_e.mean(0), p_g.mean(0)
            E, G = p_e - mu_e, p_g - mu_g
            U, D, Vt = np.linalg.svd(E.T @ G)
            S = np.eye(3)
            if np.linalg.det(U @ Vt) < 0:
                S[2, 2] = -1.0
            R = (U @ S @ Vt).T
            var_e = np.mean(np.sum(E * E, axis=1))
            s = float(np.sum(D * np.diag(S)) / (len(E) * var_e))
            p_e = (s * (E @ R.T)) + mu_g
        else:
            R, t = umeyama_alignment(p_e, p_g)
            p_e = p_e @ R.T + t
    return float(np.sqrt(np.mean(np.sum((p_e - p_g) ** 2, axis=1))))


def rpe_rmse(traj_est, traj_gt, delta: int = 1) -> float:
    """Relative pose error (translation) RMSE over ``delta``-frame increments."""
    p_e = _positions(traj_est)
    p_g = _positions(traj_gt)
    n = min(len(p_e), len(p_g))
    de = p_e[delta:n] - p_e[: n - delta]
    dg = p_g[delta:n] - p_g[: n - delta]
    return float(np.sqrt(np.mean(np.sum((de - dg) ** 2, axis=1))))


def path_length(traj) -> float:
    p = _positions(traj)
    return float(np.sum(np.linalg.norm(np.diff(p, axis=0), axis=1)))


def coverage_fraction(grid_known: np.ndarray) -> float:
    """Fraction of cells whose state is known (reference: explored_map_counter)."""
    return float(np.mean(grid_known))


def _positions(traj) -> np.ndarray:
    arr = np.asarray(traj, dtype=np.float64)
    if arr.ndim == 3 and arr.shape[-2:] == (4, 4):
        return arr[:, :3, 3]
    if arr.ndim == 2 and arr.shape[-1] == 3:
        return arr
    if arr.ndim == 2 and arr.shape[-1] == 2:
        # planar (x, y) trajectory (exploration robots): z = 0
        return np.concatenate([arr, np.zeros((arr.shape[0], 1))], axis=1)
    raise ValueError(f"unsupported trajectory shape {arr.shape}")
