"""State-estimation layer: the dual EKF and the command multiplexer (port of
``fitslam_tpu/models/localization.py``; SURVEY.md §2.4 N5).

The reference configures two robot_localization EKF instances over the
standard 15-dim omnidirectional state [x y z, roll pitch yaw, vx vy vz,
wx wy wz, ax ay az] (``ekf_with_gps.yaml``): an odom-frame filter fusing
wheel-odometry twist and IMU orientation and rates, and a map-frame filter
that also fuses an absolute reference (GPS, or here the SLAM pose). Per-sensor
boolean masks select the fused dims; a Mahalanobis threshold gates an update.
``twist_mux.yaml`` multiplexes command sources by priority and timeout.

The filter is a pure function of (state, measurement window): each row
carries a fixed-size 15-dim measurement and its mask, and masked dims are
fused with a variance of ``BIG_VAR`` (a vanishing gain) instead of a branch.
The reference scans a window in one ``lax.scan``; here the scan is a Python
loop over rows of float32 PyTorch operations that never reads a value back,
so a whole window is queued without a host sync. The 15x15 products run in
float32 (the reference multiplies at HIGHEST precision; TF32 stays off, as
the SLAM engine sets it), and the two solves of an update share one LU
factorization of S. ``run_ekf_fleet`` is the reference's ``vmap`` over
robots: the same loop over a leading robot dimension.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fitslam_tpu_torch.utils.transfer import upload

STATE_DIM = 15
# state layout (robot_localization order)
X, Y, Z, ROLL, PITCH, YAW, VX, VY, VZ, WX, WY, WZ, AX, AY, AZ = range(STATE_DIM)

BIG_VAR = 1e12  # variance assigned to unmeasured dims => zero gain
# pi and 2 pi as the reference's trace rounds them (float32)
_PI = float(np.float32(math.pi))
_TWO_PI = float(np.float32(2.0 * math.pi))


class EkfState(NamedTuple):
    x: torch.Tensor  # (..., 15)
    P: torch.Tensor  # (..., 15, 15)


class MeasurementBatch(NamedTuple):
    """A fixed-size window of time-ordered sensor measurements.

    z/mask/var follow robot_localization's per-sensor config-mask model
    (ekf_with_gps.yaml odom0_config/imu0_config): mask[i] selects whether
    state dim i is observed by this row. `gate` is the Mahalanobis rejection
    threshold (<=0 disables, matching unset *_rejection_threshold).
    """

    dt: torch.Tensor    # (..., T) seconds since previous row
    z: torch.Tensor     # (..., T, 15) measurement in state coordinates
    mask: torch.Tensor  # (..., T, 15) bool — which dims this row observes
    var: torch.Tensor   # (..., T, 15) per-dim measurement variance
    gate: torch.Tensor  # (..., T) Mahalanobis threshold per row


def initial_state(x0=None, p0: float = 1e-9, p0_dynamic: float = 1.0,
                  device="cuda") -> EkfState:
    """Initial filter state. Pose dims start at `p0` (robot_localization's
    1e-9 initial_estimate_covariance); velocity/rate/acceleration dims start
    at `p0_dynamic` so the first Mahalanobis-gated measurement of a dim the
    initial state says nothing about is accepted instead of rejected until
    process noise inflates P. Built on the host and sent up in one copy."""
    x = np.zeros(STATE_DIM, np.float32) if x0 is None else np.asarray(x0, np.float32)
    diag = np.full(STATE_DIM, p0, np.float32)
    diag[VX:] = p0_dynamic
    v = upload(np.concatenate([x, np.diag(diag).reshape(-1)]), device)
    return EkfState(x=v[:STATE_DIM], P=v[STATE_DIM:].reshape(STATE_DIM, STATE_DIM))


def default_process_noise(device="cuda") -> torch.Tensor:
    """robot_localization's default Q diagonal (ekf_with_gps.yaml
    process_noise_covariance)."""
    q = np.array(
        [0.05, 0.05, 0.06, 0.03, 0.03, 0.06, 0.025, 0.025, 0.04,
         0.01, 0.01, 0.02, 0.01, 0.01, 0.015],
        np.float32,
    )
    return upload(np.diag(q), device)


def _wrap_angle(a: torch.Tensor) -> torch.Tensor:
    # torch.remainder takes the divisor's sign, as jnp.mod does (fmod would not)
    return torch.remainder(a + _PI, _TWO_PI) - _PI


def _wrap_rpy(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[..., :ROLL], _wrap_angle(x[..., ROLL:YAW + 1]), x[..., YAW + 1:]], -1)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., n, m) @ (..., m)."""
    return (M @ v.unsqueeze(-1)).squeeze(-1)


# The transition Jacobian is assembled by gathers from one vector of its
# factors, so a row costs a few launches and not one a matrix entry; every
# entry is the reference's product of the same factors in the same order
# (a sign is carried by a negated factor, and a missing factor is 1 or 0).
# Factors: cos and sin of (roll, pitch, yaw), -sin of them, 1, 0, and for the
# gimbal matrix tan(pitch) and the guarded cos(pitch).
_CR, _CP, _CY, _SR, _SP, _SY, _NSR, _NSP, _NSY, _ONE, _ZERO, _TP, _CPS = range(13)
# R (ZYX body->world, row-major) = a * b * c + d * e
_R_FACTORS = np.array([
    # a    b     c      d      e
    [_CY, _CP, _ONE, _ZERO, _ZERO],      # cy cp
    [_CY, _SP, _SR, _NSY, _CR],          # cy sp sr - sy cr
    [_CY, _SP, _CR, _SY, _SR],           # cy sp cr + sy sr
    [_SY, _CP, _ONE, _ZERO, _ZERO],      # sy cp
    [_SY, _SP, _SR, _CY, _CR],           # sy sp sr + cy cr
    [_SY, _SP, _CR, _CY, _NSR],          # sy sp cr - cy sr
    [_NSP, _ONE, _ONE, _ZERO, _ZERO],    # -sp
    [_CP, _SR, _ONE, _ZERO, _ZERO],      # cp sr
    [_CP, _CR, _ONE, _ZERO, _ZERO],      # cp cr
]).T
# G (Euler rates from body rates, row-major) = a * b / c
_G_FACTORS = np.array([
    [_ONE, _ONE, _ONE], [_SR, _TP, _ONE], [_CR, _TP, _ONE],
    [_ZERO, _ONE, _ONE], [_CR, _ONE, _ONE], [_NSR, _ONE, _ONE],
    [_ZERO, _ONE, _ONE], [_SR, _ONE, _CPS], [_CR, _ONE, _CPS],
]).T


def _f_layout() -> np.ndarray:
    """Index into [1, 0, R*dt (9), R*dt^2/2 (9), dt, G*dt (9)] of each entry
    of the (15, 15) F."""
    idx = np.full((STATE_DIM, STATE_DIM), 1)
    idx[np.arange(STATE_DIM), np.arange(STATE_DIM)] = 0
    rows = np.arange(3)[:, None]
    cols = np.arange(3)[None, :]
    idx[X + rows, VX + cols] = 2 + 3 * rows + cols
    idx[X + rows, AX + cols] = 11 + 3 * rows + cols
    idx[VX + np.arange(3), AX + np.arange(3)] = 20
    idx[ROLL + rows, WX + cols] = 21 + 3 * rows + cols
    return idx.reshape(-1)


_F_LAYOUT = _f_layout()
_CONSTANTS = {"one_zero": np.array([1.0, 0.0], np.float32), "r": _R_FACTORS, "g": _G_FACTORS,
              "f": _F_LAYOUT, "eye": np.eye(STATE_DIM, dtype=np.float32)}
_device_constants: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def _on_device(name: str, device) -> torch.Tensor:
    """A module constant on ``device``, uploaded once and without a wait."""
    key = (name, torch.device(device))
    if key not in _device_constants:
        _device_constants[key] = upload(_CONSTANTS[name], device)
    return _device_constants[key]


def _transition_jacobian(x: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """Omnidirectional 3D kinematic model F = d f / d x (robot_localization's
    EKF motion model: body-frame velocities rotated into the world by the
    current RPY, constant acceleration on the linear dims)."""
    d = x.device
    s = torch.sin(x[..., ROLL:YAW + 1])
    v = torch.cat([torch.cos(x[..., ROLL:YAW + 1]), s, -s,
                   _on_device("one_zero", d).expand(*x.shape[:-1], 2)], -1)
    f = v[..., _on_device("r", d)]                          # (..., 5, 9)
    R = f[..., 0, :] * f[..., 1, :] * f[..., 2, :] + f[..., 3, :] * f[..., 4, :]
    # Euler-angle rates from body angular velocity (gimbal matrix), guarded
    # at cos(pitch) ~ 0 as the reference guards it
    cp, sp = v[..., _CP:_CP + 1], v[..., _SP:_SP + 1]
    near = cp.abs() < 1e-6
    u = torch.cat([v, torch.where(near, 0.0, sp / cp), torch.where(near, 1e-6, cp)], -1)
    g = u[..., _on_device("g", d)]                          # (..., 3, 9)
    G = g[..., 0, :] * g[..., 1, :] / g[..., 2, :]
    dt = dt[..., None]
    vals = torch.cat([v[..., _ONE:_ZERO + 1], R * dt, R * (0.5 * dt * dt), dt, G * dt], -1)
    return vals[..., _on_device("f", d)].reshape(*x.shape[:-1], STATE_DIM, STATE_DIM)


def ekf_predict(state: EkfState, dt: torch.Tensor, Q: torch.Tensor) -> EkfState:
    F = _transition_jacobian(state.x, dt)
    x = _wrap_rpy(_mv(F, state.x))
    P = F @ state.P @ F.mT + Q * torch.clamp_min(dt, 0.0)[..., None, None]
    return EkfState(x=x, P=P)


def ekf_update(
    state: EkfState,
    z: torch.Tensor,
    mask: torch.Tensor,
    var: torch.Tensor,
    gate: torch.Tensor,
) -> Tuple[EkfState, torch.Tensor]:
    """Masked full-rank update: H = I, unmeasured dims get BIG_VAR so their
    Kalman gain vanishes — branch-free equivalent of robot_localization's
    config-mask row selection. Returns (state, accepted); nothing is read
    back (``accepted`` stays a device tensor)."""
    innov = torch.where(mask, _wrap_rpy(z - state.x), 0.0)   # the angle dims wrapped
    Rd = torch.where(mask, torch.clamp_min(var, 1e-12), BIG_VAR)
    S = state.P + torch.diag_embed(Rd)
    # the reference's two solves, S^-1 innov and S^-T P^T, as one batched LU
    # solve of [S, S^T] (innov padded to a (15, 15) right-hand side with
    # zero columns, which do not touch its own column): S carries BIG_VAR
    # beside O(1) entries, so it is S^T's own factors (and not S's,
    # transposed) that give the reference's gain. check_errors=False keeps
    # the host from waiting on the factorization's status.
    rhs = torch.nn.functional.pad(innov.unsqueeze(-1), (0, STATE_DIM - 1))
    sols, _ = torch.linalg.solve_ex(torch.stack([S, S.mT], -3),
                                    torch.stack([rhs, state.P.mT], -3), check_errors=False)
    sol = sols[..., 0, :, 0]
    # Mahalanobis gate over the measured dims: squared distance vs nsigmas^2,
    # exactly robot_localization's checkMahalanobisThreshold (no dimension
    # scaling; *_rejection_threshold semantics)
    m2 = (innov.unsqueeze(-2) @ sol.unsqueeze(-1))[..., 0, 0]
    accepted = (gate <= 0.0) | (m2 <= gate * gate)
    K = sols[..., 1, :, :].mT * accepted[..., None, None]     # P S^-1, zero when rejected
    x = _wrap_rpy(state.x + _mv(K, innov))
    I_KH = _on_device("eye", K.device) - K
    # Joseph form for numerical symmetry
    P = I_KH @ state.P @ I_KH.mT + (K * Rd.unsqueeze(-2)) @ K.mT
    return EkfState(x=x, P=P), accepted


def run_ekf(
    state: EkfState,
    batch: MeasurementBatch,
    Q: torch.Tensor,
) -> Tuple[EkfState, Tuple[torch.Tensor, torch.Tensor]]:
    """Fuse a whole measurement window, row by row (the reference's
    ``lax.scan``). Returns (final state, (trajectory (..., T, 15), accepted
    (..., T) bool)); leading dims of state and batch are robots."""
    xs, oks = [], []
    rows = zip(batch.dt.unbind(-1), batch.z.unbind(-2), batch.mask.unbind(-2),
               batch.var.unbind(-2), batch.gate.unbind(-1))
    for dt, z, mask, var, gate in rows:
        state = ekf_predict(state, dt, Q)
        state, ok = ekf_update(state, z, mask, var, gate)
        xs.append(state.x)
        oks.append(ok)
    return state, (torch.stack(xs, -2), torch.stack(oks, -1))


#: Fleet variant: a leading robot dim on (state, batch) — the reference's
#: ``vmap`` over robots (multi-robot EKF-per-namespace parity).
run_ekf_fleet = run_ekf


# ---------------------------------------------------------------------------
# Sensor-row builders (host side): odometry / IMU / GPS -> config-masked rows
# ---------------------------------------------------------------------------

ODOM_MASK = np.zeros(STATE_DIM, np.bool_)
ODOM_MASK[[VX, VY]] = True  # odom0_config: fuse vx, vy
IMU_MASK = np.zeros(STATE_DIM, np.bool_)
IMU_MASK[[WX, WY, WZ]] = True  # imu0_config: angular-rate part
IMU_ORI_MASK = np.zeros(STATE_DIM, np.bool_)
IMU_ORI_MASK[[ROLL, PITCH, YAW]] = True  # imu0_config: absolute orientation part
GPS_MASK = np.zeros(STATE_DIM, np.bool_)
GPS_MASK[[X, Y, Z]] = True
POSE_MASK = np.zeros(STATE_DIM, np.bool_)
POSE_MASK[[X, Y, YAW]] = True  # planar absolute pose (SLAM map->base)


def sensor_row(mask: np.ndarray, values: np.ndarray, var: np.ndarray,
               dt: float, gate: float = 0.0):
    """Pack one sensor reading into (dt, z, mask, var, gate) numpy row."""
    z = np.zeros(STATE_DIM, np.float32)
    v = np.full(STATE_DIM, BIG_VAR, np.float32)
    idx = np.nonzero(mask)[0]
    z[idx] = np.asarray(values, np.float32)
    v[idx] = np.asarray(var, np.float32)
    return (np.float32(dt), z, mask.copy(), v, np.float32(gate))


def noop_row():
    """A filler row: dt=0 (no prediction), mask all false, gate off. In
    float32 it is not an exact no-op on P: the gain P S^-1 with S = P +
    BIG_VAR I is ~1e-12, not zero (the reference's rows do the same)."""
    return (np.float32(0.0), np.zeros(STATE_DIM, np.float32),
            np.zeros(STATE_DIM, np.bool_),
            np.full(STATE_DIM, BIG_VAR, np.float32), np.float32(0.0))


def pack_rows(rows, capacity: Optional[int] = None, device="cuda") -> MeasurementBatch:
    """Stack rows into a batch on ``device`` (one host->device copy),
    optionally padded with no-op rows to a fixed `capacity`, as the
    reference pads every dispatch to one compiled shape."""
    if capacity is not None:
        if len(rows) > capacity:
            raise ValueError(f"{len(rows)} rows > window capacity {capacity}")
        rows = list(rows) + [noop_row()] * (capacity - len(rows))
    dt, z, mask, var, gate = (np.stack([r[i] for r in rows]) for i in range(5))
    D = STATE_DIM
    v = upload(np.concatenate([dt[:, None], z, mask.astype(np.float32), var, gate[:, None]],
                              axis=1).astype(np.float32), device)
    return MeasurementBatch(dt=v[:, 0], z=v[:, 1:1 + D], mask=v[:, 1 + D:1 + 2 * D] > 0.5,
                            var=v[:, 1 + 2 * D:1 + 3 * D], gate=v[:, 1 + 3 * D])


class NavsatTransform:
    """GPS (lat, lon, alt) -> local metric ENU, datum from the first fix
    (navsat_transform equivalent — the map-frame EKF's GPS input path)."""

    EARTH_R = 6371000.0

    def __init__(self):
        self.datum: Optional[Tuple[float, float, float]] = None

    def to_enu(self, lat: float, lon: float, alt: float = 0.0) -> np.ndarray:
        if self.datum is None:
            self.datum = (lat, lon, alt)
        lat0, lon0, alt0 = self.datum
        x = math.radians(lon - lon0) * self.EARTH_R * math.cos(math.radians(lat0))
        y = math.radians(lat - lat0) * self.EARTH_R
        return np.array([x, y, alt - alt0], np.float32)


class DualEkf:
    """Dual-filter wiring of ekf_with_gps.yaml: an odom-frame filter (odom +
    IMU, continuous) and a map-frame filter (same + GPS or the SLAM pose,
    jump-corrected). Rows accumulate on the host; ``flush`` fuses them in
    windows of ``WINDOW_CAP`` rows on ``device`` and reads both poses back in
    one copy, counted in ``host_syncs``."""

    def __init__(self, Q: Optional[torch.Tensor] = None, gps_var: float = 1.0,
                 device="cuda"):
        self.device = torch.device(device)
        self.Q = default_process_noise(self.device) if Q is None else Q.to(self.device)
        self.odom_state = initial_state(device=self.device)
        self.map_state = initial_state(device=self.device)
        self.navsat = NavsatTransform()
        self.gps_var = gps_var
        self._odom_rows: list = []
        self._map_rows: list = []
        self.host_syncs = 0       # device->host reads so far (one a flush)
        self.flushes = 0          # flush() calls so far
        self.windows = 0          # run_ekf windows fused so far

    def add_odom(self, vx: float, vy: float, dt: float, var: float = 0.01):
        row = sensor_row(ODOM_MASK, np.array([vx, vy]), np.full(2, var), dt)
        self._odom_rows.append(row)
        self._map_rows.append(row)

    def add_imu(self, wx: float, wy: float, wz: float, dt: float,
                roll: Optional[float] = None, pitch: float = 0.0,
                yaw: float = 0.0, var: float = 0.005,
                ori_var: float = 0.01, gate: float = 0.8):
        """One IMU reading: angular rates, and — when `roll` is given —
        absolute roll/pitch/yaw orientation, matching imu0_config which fuses
        orientation in both filters (ekf_with_gps.yaml).

        The Mahalanobis `gate` applies ONLY to the absolute-orientation row:
        the rate row is the filter's only angular-rate source, and gating it
        against a converged rate covariance would reject every genuine step
        change in omega (unset *_rejection_threshold semantics for primary
        sensors)."""
        row = sensor_row(IMU_MASK, np.array([wx, wy, wz]), np.full(3, var),
                         dt, 0.0)
        self._odom_rows.append(row)
        self._map_rows.append(row)
        if roll is not None:
            ori = sensor_row(IMU_ORI_MASK, np.array([roll, pitch, yaw]),
                             np.full(3, ori_var), 0.0, gate)
            self._odom_rows.append(ori)
            self._map_rows.append(ori)

    def add_gps(self, lat: float, lon: float, alt: float, dt: float):
        enu = self.navsat.to_enu(lat, lon, alt)
        row = sensor_row(GPS_MASK, enu, np.full(3, self.gps_var), dt)
        self._map_rows.append(row)  # GPS only reaches the map-frame filter

    def add_pose(self, x: float, y: float, yaw: float, dt: float = 0.0,
                 var: float = 0.02, gate: float = 3.0):
        """Planar absolute pose (the SLAM engine's map->base estimate) fused
        into the MAP-frame filter only — the role GPS plays in
        ekf_with_gps.yaml, so the odom-frame estimate stays continuous. The
        Mahalanobis gate keeps loop-closure-sized jumps out of the filter."""
        row = sensor_row(POSE_MASK, np.array([x, y, yaw]),
                         np.full(3, var), dt, gate)
        self._map_rows.append(row)

    #: fixed flush window, as the reference's one compiled shape
    WINDOW_CAP = 64

    def _flush_one(self, state: EkfState, rows: list) -> EkfState:
        cap = self.WINDOW_CAP
        for i in range(0, len(rows), cap):
            state, _ = run_ekf(state, pack_rows(rows[i:i + cap], cap, self.device), self.Q)
            self.windows += 1
        return state

    def flush(self) -> Tuple[np.ndarray, np.ndarray]:
        """Fuse all buffered rows; returns (odom_pose, map_pose) as
        [x, y, z, roll, pitch, yaw], read back in one copy. Rows are padded
        to WINDOW_CAP-sized chunks with no-op filler, as the reference pads
        them."""
        if self._odom_rows:
            self.odom_state = self._flush_one(self.odom_state, self._odom_rows)
            self._odom_rows.clear()
        if self._map_rows:
            self.map_state = self._flush_one(self.map_state, self._map_rows)
            self._map_rows.clear()
        v = torch.cat([self.odom_state.x[:6], self.map_state.x[:6]]).cpu().numpy()
        self.host_syncs += 1
        self.flushes += 1
        return v[:6], v[6:]


# ---------------------------------------------------------------------------
# Twist multiplexer (twist_mux.yaml)
# ---------------------------------------------------------------------------


@dataclass
class _TwistSource:
    priority: int
    timeout: float
    last_cmd: Tuple[float, float] = (0.0, 0.0)
    last_time: float = -math.inf


class TwistMux:
    """Priority command multiplexer: highest-priority non-stale source wins
    (twist_mux.yaml: navigation prio 10 / joystick prio 100, timeout 0.5 s)."""

    def __init__(self, sources: Optional[Dict[str, Tuple[int, float]]] = None):
        sources = sources or {"navigation": (10, 0.5), "joystick": (100, 0.5)}
        self._src = {
            name: _TwistSource(priority=p, timeout=t)
            for name, (p, t) in sources.items()
        }

    def push(self, source: str, v: float, omega: float,
             now: Optional[float] = None):
        s = self._src[source]
        s.last_cmd = (v, omega)
        s.last_time = time.monotonic() if now is None else now

    def output(self, now: Optional[float] = None) -> Tuple[float, float]:
        t = time.monotonic() if now is None else now
        live = [s for s in self._src.values() if t - s.last_time <= s.timeout]
        if not live:
            return (0.0, 0.0)
        return max(live, key=lambda s: s.priority).last_cmd
