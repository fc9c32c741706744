"""Plain reference of the dual EKF's flush: robot_localization's extended
Kalman filter over the 15-dim omnidirectional state [x y z, roll pitch yaw,
vx vy vz, wx wy wz, ax ay az], as ``ekf_with_gps.yaml`` configures it.

Each measurement row (dt, z, mask, var, gate) first predicts by dt with the
3D kinematic model (body-frame velocities rotated into the world by the ZYX
roll-pitch-yaw rotation, constant linear acceleration, Euler rates from body
rates through the gimbal matrix), x <- F x and P <- F P F^T + Q max(dt, 0);
then updates with H = I over the masked dims: the innovation (angles
wrapped to [-pi, pi)), S = P + R, the Mahalanobis test innov^T S^-1 innov
<= gate^2 (a gate <= 0 always accepts), K = P S^-1, the Joseph form for P.
Rows that mask nothing with dt = 0 change nothing and are skipped (the
program pads its windows with them). ``dtype`` is the precision of every
step (float64 here; the control runs bfloat16, its solves in float32).
"""

from __future__ import annotations

import math

import torch

DIM = 15
X, Y, Z, ROLL, PITCH, YAW, VX, VY, VZ, WX, WY, WZ, AX, AY, AZ = range(DIM)
# robot_localization's process_noise_covariance diagonal (ekf_with_gps.yaml)
Q_DIAG = (0.05, 0.05, 0.06, 0.03, 0.03, 0.06, 0.025, 0.025, 0.04,
          0.01, 0.01, 0.02, 0.01, 0.01, 0.015)
BIG_VAR = 1e12


def _wrap(a):
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def _wrap_rpy(x):
    return torch.cat([x[:ROLL], _wrap(x[ROLL:YAW + 1]), x[YAW + 1:]])


def transition(x, dt):
    cr, cp, cy = torch.cos(x[ROLL]), torch.cos(x[PITCH]), torch.cos(x[YAW])
    sr, sp, sy = torch.sin(x[ROLL]), torch.sin(x[PITCH]), torch.sin(x[YAW])
    R = torch.stack([torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr]),
                     torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr]),
                     torch.stack([-sp, cp * sr, cp * cr])])
    near = cp.abs() < 1e-6
    tp = torch.where(near, torch.zeros_like(sp), sp / cp)
    cps = torch.where(near, torch.full_like(cp, 1e-6), cp)
    one, zero = torch.ones_like(cr), torch.zeros_like(cr)
    G = torch.stack([torch.stack([one, sr * tp, cr * tp]),
                     torch.stack([zero, cr, -sr]),
                     torch.stack([zero, sr / cps, cr / cps])])
    F = torch.eye(DIM, dtype=x.dtype, device=x.device)
    F[X:Z + 1, VX:VZ + 1] = R * dt
    F[X:Z + 1, AX:AZ + 1] = R * (0.5 * dt * dt)
    F[VX:VZ + 1, AX:AZ + 1] = torch.eye(3, dtype=x.dtype, device=x.device) * dt
    F[ROLL:YAW + 1, WX:WZ + 1] = G * dt
    return F


def run_rows(x, P, rows, dtype=torch.float64):
    """The state after the rows, each a (dt, z, mask, var, gate) tuple of
    host values. Returns (x, P) in ``dtype``."""
    solve_t = torch.float32 if dtype == torch.bfloat16 else dtype
    dev = x.device
    x, P = x.to(dtype), P.to(dtype)
    Q = torch.diag(torch.tensor(Q_DIAG, dtype=dtype, device=dev))
    eye = torch.eye(DIM, dtype=dtype, device=dev)
    for dt, z, mask, var, gate in rows:
        mask = torch.as_tensor(mask, device=dev)
        if float(dt) == 0.0 and not bool(mask.any()):
            continue
        dt = torch.tensor(float(dt), dtype=dtype, device=dev)
        F = transition(x, dt)
        x = _wrap_rpy(F @ x)
        P = F @ P @ F.T + Q * torch.clamp(dt, min=0)
        z = torch.as_tensor(z, device=dev).to(dtype)
        var = torch.as_tensor(var, device=dev).to(dtype)
        innov = torch.where(mask, _wrap_rpy(z - x), torch.zeros_like(x))
        Rd = torch.where(mask, torch.clamp(var, min=1e-12), torch.full_like(var, BIG_VAR))
        S = (P + torch.diag(Rd)).to(solve_t)
        sol = torch.linalg.solve(S, innov.to(solve_t))
        m2 = float(innov.to(solve_t) @ sol)
        if float(gate) > 0 and m2 > float(gate) ** 2:
            continue                       # rejected: the prediction stands
        K = torch.linalg.solve(S.T, P.to(solve_t).T).T.to(dtype)
        x = _wrap_rpy(x + K @ innov)
        IK = eye - K
        P = IK @ P @ IK.T + (K * Rd[None, :]) @ K.T
    return x, P
