"""Batched SO(3)/SE(3) Lie-group operations (port of ``fitslam_tpu/ops/lie.py``).

Poses are plain tensors — rotation matrices ``R (..., 3, 3)`` and translations
``t (..., 3)`` — broadcasting over arbitrary batch dimensions. Tangent vectors
follow the [rho, phi] = [translation, rotation] convention with the *left*
perturbation ``T' = exp(xi) @ T`` used by the Gauss-Newton solvers in
``ops/ba.py``.

Small-angle branches use the same Taylor expansions and "safe where" pattern
as the reference; every product is float32 (the port never enables TF32).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_EPS = 1e-8


class SE3(NamedTuple):
    """A (batch of) rigid transform(s): x_out = R @ x + t."""

    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)

    @property
    def batch_shape(self):
        return self.t.shape[:-1]

    def matrix(self) -> torch.Tensor:
        """(..., 4, 4) homogeneous matrices."""
        top = torch.cat([self.R, self.t[..., :, None]], dim=-1)
        bot = torch.zeros(self.t.shape[:-1] + (1, 4), dtype=self.t.dtype,
                          device=self.t.device)
        bot[..., 0, 3].fill_(1.0)   # fill_: no host-to-device copy of the scalar
        return torch.cat([top, bot], dim=-2)

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device=None) -> "SE3":
        R = torch.eye(3, dtype=dtype, device=device).expand(
            tuple(batch_shape) + (3, 3)).clone()
        t = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device)
        return SE3(R, t)

    @staticmethod
    def from_matrix(T: torch.Tensor) -> "SE3":
        return SE3(T[..., :3, :3], T[..., :3, 3])


def skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix [w]x."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    rows = [
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def _safe_div(num, den, alt):
    safe = den.abs() > _EPS
    den_ = torch.where(safe, den, torch.ones_like(den))
    return torch.where(safe, num / den_, alt)


def _sin_theta_over_theta(theta2):
    t2 = torch.where(theta2 > _EPS, theta2, torch.ones_like(theta2))
    theta = torch.sqrt(t2)
    return torch.where(theta2 > _EPS, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)


def _one_minus_cos_over_theta2(theta2):
    t2 = torch.where(theta2 > _EPS, theta2, torch.ones_like(theta2))
    theta = torch.sqrt(t2)
    return torch.where(theta2 > _EPS, (1.0 - torch.cos(theta)) / t2,
                       0.5 - theta2 / 24.0)


def _theta_minus_sin_over_theta3(theta2):
    t2 = torch.where(theta2 > _EPS, theta2, torch.ones_like(theta2))
    theta = torch.sqrt(t2)
    return torch.where(theta2 > _EPS, (theta - torch.sin(theta)) / (t2 * theta),
                       1.0 / 6.0 - theta2 / 120.0)


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) rotation vector -> (..., 3, 3) rotation matrix."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    K = skew(phi)
    KK = K @ K
    return (_eye_like(K) + _sin_theta_over_theta(theta2) * K
            + _one_minus_cos_over_theta2(theta2) * KK)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 3) rotation vector, with the
    diagonal-based axis extraction near theta = pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    vee = 0.5 * torch.stack(
        [R[..., 2, 1] - R[..., 1, 2],
         R[..., 0, 2] - R[..., 2, 0],
         R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_theta = torch.sqrt(torch.sum(vee * vee, dim=-1) + 1e-24)
    theta = torch.atan2(sin_theta, cos_theta)
    scale = _safe_div(theta, sin_theta, 1.0 + theta * theta / 6.0)[..., None]
    generic = scale * vee

    B = (R + torch.eye(3, dtype=R.dtype, device=R.device)) * 0.5
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    col = torch.take_along_dim(B, k[..., None, None], dim=-1)[..., 0]
    nrm = torch.sqrt(torch.clamp(
        torch.take_along_dim(diag, k[..., None], dim=-1)[..., 0], min=_EPS))
    axis = col / nrm[..., None]
    sign = torch.where(torch.sum(axis * vee, dim=-1) < 0.0, -1.0, 1.0)
    near_pi = (sign * theta)[..., None] * axis

    use_pi = (math.pi - theta) < 1e-3
    return torch.where(use_pi[..., None], near_pi, generic)


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    K = skew(phi)
    KK = K @ K
    return (_eye_like(K) + _one_minus_cos_over_theta2(theta2) * K
            + _theta_minus_sin_over_theta3(theta2) * KK)


def so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    t2 = torch.where(theta2 > _EPS, theta2, torch.ones_like(theta2))
    theta = torch.sqrt(t2)
    K = skew(phi)
    KK = K @ K
    half_theta = 0.5 * theta
    cot_term = torch.where(
        theta2 > _EPS,
        (1.0 - half_theta * torch.cos(half_theta) / torch.sin(half_theta)) / t2,
        1.0 / 12.0 + theta2 / 720.0,
    )
    return _eye_like(K) - 0.5 * K + cot_term * KK


def se3_exp(xi: torch.Tensor) -> SE3:
    """(..., 6) [rho, phi] -> SE3. R = exp(phi), t = J_l(phi) @ rho."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = (so3_left_jacobian(phi) @ rho[..., :, None])[..., 0]
    return SE3(R, t)


def se3_log(T: SE3) -> torch.Tensor:
    """SE3 -> (..., 6) [rho, phi]."""
    phi = so3_log(T.R)
    rho = (so3_left_jacobian_inv(phi) @ T.t[..., :, None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def compose(A: SE3, B: SE3) -> SE3:
    """A then-applied-after B: (A*B)(x) = A(B(x))."""
    return SE3(A.R @ B.R, (A.R @ B.t[..., :, None])[..., 0] + A.t)


def inverse(T: SE3) -> SE3:
    Rt = T.R.transpose(-1, -2)
    return SE3(Rt, -(Rt @ T.t[..., :, None])[..., 0])


def apply(T: SE3, pts: torch.Tensor) -> torch.Tensor:
    """Transform points. T batch (...,), pts (..., N, 3) or (..., 3)."""
    if pts.dim() == T.t.dim():
        return (T.R @ pts[..., :, None])[..., 0] + T.t
    return pts @ T.R.transpose(-1, -2) + T.t[..., None, :]


def yaw_to_rotmat(yaw: torch.Tensor) -> torch.Tensor:
    """(...) yaw about +z -> (..., 3, 3). Planar-rover helper."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    rows = [
        torch.stack([c, -s, z], dim=-1),
        torch.stack([s, c, z], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ]
    return torch.stack(rows, dim=-2)
