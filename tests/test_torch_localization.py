"""The port's state-estimation layer (``models/localization.py``) on the CPU:
the reference's tests (``tests/test_localization.py``) on the port, and the
port held to the reference (JAX on the CPU) on the same seeded inputs.

Tolerances: the transition Jacobian, one predict and one update, rtol 1e-5
and atol 1e-6 on x and P, with the gate's ``accepted`` flags equal (the
update's two solves are LU solves on both sides, S's and S^T's, so the
gain's tiny entries against BIG_VAR round alike); a 64-row window, a fleet of
3 robots and a DualEkf stream that flushes in two windows, 1e-4 on the
states, every row's ``accepted`` equal. The row builders, the navsat
transform and the twist mux are numpy / Python on both sides and exactly
equal.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitslam_tpu.models import localization as jloc
from fitslam_tpu_torch.models import localization as loc
from fitslam_tpu_torch.ops import ekf_window as ew
from fitslam_tpu_torch.utils import interop

torch.set_num_threads(2)

STEP_TOL = dict(rtol=1e-5, atol=1e-6)
RUN_TOL = dict(rtol=0.0, atol=1e-4)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _state_pair(x, P):
    return jloc.EkfState(jnp.asarray(x), jnp.asarray(P)), interop.ekf_state_from_reference(x, P)


def _random_state(rng, yaw=None, pitch=None):
    x = rng.normal(size=loc.STATE_DIM).astype(np.float32)
    x[loc.ROLL:loc.YAW + 1] = rng.uniform(-math.pi, math.pi, 3)
    if yaw is not None:
        x[loc.YAW] = yaw
    if pitch is not None:
        x[loc.PITCH] = pitch
    A = rng.normal(size=(loc.STATE_DIM, loc.STATE_DIM)).astype(np.float32)
    P = (0.05 * A @ A.T + 0.01 * np.eye(loc.STATE_DIM)).astype(np.float32)
    return x, P


def _rows(rng, n):
    """A seeded mix of the sensors the system fuses: odometry, IMU rates,
    gated IMU orientation (angles anywhere in (-pi, pi]) and gated SLAM poses."""
    rows = []
    for i in range(n):
        k = i % 4
        if k == 0:
            rows.append(jloc.sensor_row(jloc.ODOM_MASK, rng.normal(0.4, 0.1, 2),
                                        np.full(2, 1e-2), 0.05))
        elif k == 1:
            rows.append(jloc.sensor_row(jloc.IMU_MASK, rng.normal(0, 0.3, 3),
                                        np.full(3, 5e-3), 0.0))
        elif k == 2:
            rows.append(jloc.sensor_row(jloc.IMU_ORI_MASK, rng.uniform(-math.pi, math.pi, 3),
                                        np.full(3, 1e-2), 0.0, 0.8))
        else:
            rows.append(jloc.sensor_row(jloc.POSE_MASK, rng.normal(0, 0.5, 3),
                                        np.full(3, 2e-2), 0.0, 3.0))
    return rows


# ---------------------------------------------------------------------------
# tests/test_localization.py on the port
# ---------------------------------------------------------------------------


def _drive_circle(T=200, dt=0.05, v=0.5, w=0.4):
    """Ground-truth planar circle + noisy odom/imu rows."""
    rng = np.random.default_rng(0)
    rows, gt = [], []
    x = y = yaw = 0.0
    for _ in range(T):
        x += v * math.cos(yaw) * dt
        y += v * math.sin(yaw) * dt
        yaw = (yaw + w * dt + math.pi) % (2 * math.pi) - math.pi
        gt.append((x, y, yaw))
        rows.append(loc.sensor_row(
            loc.ODOM_MASK, np.array([v + rng.normal(0, 0.01), 0.0]),
            np.array([1e-3, 1e-3]), dt))
        rows.append(loc.sensor_row(
            loc.IMU_MASK, np.array([0.0, 0.0, w + rng.normal(0, 0.01)]),
            np.full(3, 1e-3), 0.0))
    return rows, np.array(gt)


def test_ekf_tracks_circle():
    rows, gt = _drive_circle()
    final, (xs, ok) = loc.run_ekf(loc.initial_state(device="cpu"),
                                  loc.pack_rows(rows, device="cpu"),
                                  loc.default_process_noise("cpu"))
    est = final.x.numpy()
    assert abs(est[loc.X] - gt[-1, 0]) < 0.25
    assert abs(est[loc.Y] - gt[-1, 1]) < 0.25
    dyaw = (est[loc.YAW] - gt[-1, 2] + math.pi) % (2 * math.pi) - math.pi
    assert abs(dyaw) < 0.1
    assert bool(ok.all()) and xs.shape == (len(rows), loc.STATE_DIM)


def test_mahalanobis_gate_rejects_outlier():
    rows = [loc.sensor_row(loc.ODOM_MASK, np.array([0.5, 0.0]),
                           np.array([1e-4, 1e-4]), 0.05) for _ in range(20)]
    rows.append(loc.sensor_row(loc.ODOM_MASK, np.array([50.0, 0.0]),
                               np.array([1e-4, 1e-4]), 0.05, gate=3.0))
    final, (xs, ok) = loc.run_ekf(loc.initial_state(device="cpu"),
                                  loc.pack_rows(rows, device="cpu"),
                                  loc.default_process_noise("cpu"))
    ok = ok.numpy()
    assert ok[:-1].all() and not ok[-1]
    assert abs(float(final.x[loc.VX]) - 0.5) < 0.1


def test_fleet_vmap_matches_single():
    rows, _ = _drive_circle(T=50)
    batch = loc.pack_rows(rows, device="cpu")
    Q = loc.default_process_noise("cpu")
    s0 = loc.initial_state(device="cpu")
    single, _ = loc.run_ekf(s0, batch, Q)
    fleet_states = loc.EkfState(x=torch.stack([s0.x, s0.x]), P=torch.stack([s0.P, s0.P]))
    fleet_batch = loc.MeasurementBatch(*(torch.stack([f, f]) for f in batch))
    fleet, _ = loc.run_ekf_fleet(fleet_states, fleet_batch, Q)
    np.testing.assert_allclose(fleet.x[0].numpy(), single.x.numpy(), rtol=1e-5, atol=1e-5)


def test_dual_ekf_gps_corrects_map_frame():
    dual = loc.DualEkf(gps_var=0.01, device="cpu")
    for k in range(10):
        dual.add_odom(0.0, 0.0, dt=0.1)
        dual.add_gps(lat=0.0, lon=k * 1e-5, alt=0.0, dt=0.0)
    odom_pose, map_pose = dual.flush()
    assert abs(odom_pose[0]) < 0.05
    assert map_pose[0] > 0.3
    enu = dual.navsat.to_enu(0.0, 9e-5, 0.0)
    assert abs(enu[0] - math.radians(9e-5) * loc.NavsatTransform.EARTH_R) < 1e-3
    assert dual.host_syncs == 1 and dual.flushes == 1 and dual.windows == 2


def test_imu_orientation_bounds_yaw_drift():
    true_yaw, biased_rate = 0.9, 0.5
    dual_ori, dual_rate_only = loc.DualEkf(device="cpu"), loc.DualEkf(device="cpu")
    for _ in range(60):
        dual_ori.add_imu(0.0, 0.0, biased_rate, dt=0.05,
                         roll=0.0, pitch=0.0, yaw=true_yaw, gate=0.0)
        dual_rate_only.add_imu(0.0, 0.0, biased_rate, dt=0.05, gate=0.0)
    o_ori, _ = dual_ori.flush()
    o_rate, _ = dual_rate_only.flush()
    assert abs(o_ori[5] - true_yaw) < 0.1
    assert abs(o_rate[5] - true_yaw) > 0.4


def test_flush_pads_to_fixed_shape():
    rows = [loc.sensor_row(loc.ODOM_MASK, np.array([0.5, 0.0]),
                           np.array([1e-3, 1e-3]), 0.05) for _ in range(7)]
    s0 = loc.initial_state(device="cpu")
    Q = loc.default_process_noise("cpu")
    plain, _ = loc.run_ekf(s0, loc.pack_rows(rows, device="cpu"), Q)
    padded, _ = loc.run_ekf(s0, loc.pack_rows(rows, capacity=64, device="cpu"), Q)
    np.testing.assert_allclose(padded.x.numpy(), plain.x.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="capacity"):
        loc.pack_rows(rows, capacity=6, device="cpu")


def test_twist_mux_priority_and_timeout():
    mux = loc.TwistMux()
    mux.push("navigation", 0.5, 0.1, now=0.0)
    assert mux.output(now=0.1) == (0.5, 0.1)
    mux.push("joystick", 0.0, 0.9, now=0.2)
    assert mux.output(now=0.3) == (0.0, 0.9)
    mux.push("navigation", 0.5, 0.1, now=0.6)
    assert mux.output(now=0.8) == (0.5, 0.1)
    assert mux.output(now=5.0) == (0.0, 0.0)


# ---------------------------------------------------------------------------
# The port against the reference on the same inputs
# ---------------------------------------------------------------------------


def test_constants_masks_and_rows_equal_reference():
    names = ["STATE_DIM", "BIG_VAR", "X", "Y", "Z", "ROLL", "PITCH", "YAW", "VX", "VY", "VZ",
             "WX", "WY", "WZ", "AX", "AY", "AZ"]
    assert [getattr(loc, n) for n in names] == [getattr(jloc, n) for n in names]
    for m in ("ODOM_MASK", "IMU_MASK", "IMU_ORI_MASK", "GPS_MASK", "POSE_MASK"):
        assert np.array_equal(getattr(loc, m), getattr(jloc, m))
    rng = np.random.default_rng(4)
    vals, var = rng.normal(size=3), rng.uniform(0, 1, 3)
    for a, b in ((loc.sensor_row(loc.POSE_MASK, vals, var, 0.1, 3.0),
                  jloc.sensor_row(jloc.POSE_MASK, vals, var, 0.1, 3.0)),
                 (loc.noop_row(), jloc.noop_row())):
        assert all(np.array_equal(u, v) and np.asarray(u).dtype == np.asarray(v).dtype
                   for u, v in zip(a, b))
    rows = _rows(rng, 9)
    port, ref = loc.pack_rows(rows, capacity=16, device="cpu"), jloc.pack_rows(rows, capacity=16)
    for u, v in zip(port, ref):
        assert u.numpy().dtype == np.asarray(v).dtype and np.array_equal(u.numpy(), np.asarray(v))
    s, js = loc.initial_state(np.arange(15), device="cpu"), jloc.initial_state(np.arange(15.0))
    assert np.array_equal(s.x.numpy(), np.asarray(js.x))
    assert np.array_equal(s.P.numpy(), np.asarray(js.P))
    assert np.array_equal(loc.default_process_noise("cpu").numpy(),
                          np.asarray(jloc.default_process_noise()))


def test_wrap_angle_equals_reference():
    a = np.concatenate([np.random.default_rng(0).uniform(-30, 30, 20000),
                        np.array([-math.pi, math.pi, 0.0, 3 * math.pi, -3 * math.pi])])
    a = a.astype(np.float32)
    assert np.array_equal(loc._wrap_angle(_t(a)).numpy(), np.asarray(jloc._wrap_angle(jnp.asarray(a))))


@pytest.mark.parametrize("pitch", [None, math.pi / 2, -math.pi / 2 + 1e-8])
def test_transition_jacobian_matches_reference(pitch):
    """Including pitch at +-pi/2, where the gimbal matrix's guards take over."""
    rng = np.random.default_rng(11)
    for _ in range(5):
        x, _ = _random_state(rng, pitch=pitch)
        dt = np.float32(rng.uniform(0.0, 0.2))
        np.testing.assert_allclose(loc._transition_jacobian(_t(x), _t(dt)).numpy(),
                                   np.asarray(jloc._transition_jacobian(jnp.asarray(x),
                                                                        jnp.asarray(dt))),
                                   **STEP_TOL)


def test_predict_matches_reference():
    rng = np.random.default_rng(12)
    for yaw in (None, math.pi - 1e-3, -math.pi + 1e-3):
        x, P = _random_state(rng, yaw=yaw)
        x[loc.WZ] = 0.5 if yaw is None or yaw > 0 else -0.5   # carries yaw over +-pi
        js, ts = _state_pair(x, P)
        dt = np.float32(0.1)
        jo = jloc.ekf_predict(js, jnp.asarray(dt), jloc.default_process_noise())
        to = loc.ekf_predict(ts, _t(dt), loc.default_process_noise("cpu"))
        np.testing.assert_allclose(to.x.numpy(), np.asarray(jo.x), **STEP_TOL)
        np.testing.assert_allclose(to.P.numpy(), np.asarray(jo.P), **STEP_TOL)


@pytest.mark.parametrize("case", ["accepted", "rejected", "masked", "straddles_pi", "ungated"])
def test_update_matches_reference(case):
    rng = np.random.default_rng(13)
    x, P = _random_state(rng, yaw=3.1 if case == "straddles_pi" else None)
    mask = loc.POSE_MASK.copy()
    z = x.copy()
    z[[loc.X, loc.Y, loc.YAW]] += np.float32(0.05)
    var = np.full(loc.STATE_DIM, 0.02, np.float32)
    gate = np.float32(3.0)
    if case == "rejected":
        z[loc.X] += 50.0
    elif case == "masked":
        mask = np.zeros(loc.STATE_DIM, np.bool_)
        mask[[loc.VX, loc.WZ]] = True
        z[loc.X] += 50.0          # on an unmeasured dim: no effect
    elif case == "straddles_pi":
        z[loc.YAW] = -3.1         # 0.083 rad across +-pi
    elif case == "ungated":
        gate = np.float32(0.0)
        z[loc.Y] += 10.0
    js, ts = _state_pair(x, P)
    (jo, jok), (to, tok) = (jloc.ekf_update(js, *map(jnp.asarray, (z, mask, var, gate))),
                            loc.ekf_update(ts, *map(_t, (z, mask, var, gate))))
    assert bool(tok) == bool(jok) == (case != "rejected")
    np.testing.assert_allclose(to.x.numpy(), np.asarray(jo.x), **STEP_TOL)
    np.testing.assert_allclose(to.P.numpy(), np.asarray(jo.P), **STEP_TOL)


def test_run_ekf_window_matches_reference():
    rng = np.random.default_rng(14)
    rows = _rows(rng, 64)
    jf, (jxs, jok) = jloc.run_ekf(jloc.initial_state(), jloc.pack_rows(rows),
                                  jloc.default_process_noise())
    tf, (txs, tok) = loc.run_ekf(loc.initial_state(device="cpu"),
                                 loc.pack_rows(rows, device="cpu"),
                                 loc.default_process_noise("cpu"))
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    assert 0 < int(tok.sum()) < 64          # both gates fire both ways
    np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), **RUN_TOL)
    np.testing.assert_allclose(txs.numpy(), np.asarray(jxs), **RUN_TOL)
    np.testing.assert_allclose(tf.P.numpy(), np.asarray(jf.P), **RUN_TOL)


# ---------------------------------------------------------------------------
# ekf_window: one kernel launch a window on the card, run_ekf on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [1, 3, 64])
def test_ekf_window_on_the_cpu_is_run_ekf(T):
    """On CPU tensors ``ekf_window`` is its plain twin: bit-equal to
    ``run_ekf`` on the same rows (filler rows among them), written into the
    state in place, and no kernel launch counted."""
    rng = np.random.default_rng(40 + T)
    x, P = _random_state(rng, yaw=math.pi - 1e-3)
    rows = torch.tensor(loc.rows_array(_rows(rng, max(1, T - 8)), T))
    Q = loc.default_process_noise("cpu")
    want, _ = loc.run_ekf(interop.ekf_state_from_reference(x, P), loc.batch_from_array(rows), Q)
    state = interop.ekf_state_from_reference(x, P)
    before = ew.ekf_window.launches
    got = ew.ekf_window(state, rows, Q)
    assert got is state and ew.ekf_window.launches == before
    assert torch.equal(state.x, want.x) and torch.equal(state.P, want.P)


def _window_args(bad):
    state = loc.initial_state(device="cpu")
    rows = torch.tensor(loc.rows_array([loc.noop_row()] * 4))
    Q = loc.default_process_noise("cpu")
    if bad == "width":
        rows = rows[:, :-1].contiguous()
    elif bad == "dtype":
        rows = rows.double()
    elif bad == "no rows":
        rows = rows[:0]
    elif bad == "too many rows":
        rows = torch.zeros(ew.MAX_ROWS + 1, ew.ROW_WIDTH)
    elif bad == "float64 state":
        state = loc.EkfState(state.x.double(), state.P)
    elif bad == "not contiguous":
        state = loc.EkfState(state.x, state.P.t())
    elif bad == "devices":
        rows = rows.to("meta")
    return state, rows, Q


@pytest.mark.parametrize("bad", ["width", "dtype", "no rows", "too many rows", "float64 state",
                                 "not contiguous", "devices"])
def test_ekf_window_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        ew.ekf_window(*_window_args(bad))


def test_run_ekf_fleet_matches_reference():
    """Three robots, each its own start and rows: the reference's vmap
    against the port's leading robot dimension."""
    rng = np.random.default_rng(15)
    starts = [_random_state(rng) for _ in range(3)]
    batches = [jloc.pack_rows(_rows(rng, 48)) for _ in range(3)]
    jb = jloc.MeasurementBatch(*(jnp.stack(f) for f in zip(*batches)))
    js = jloc.EkfState(jnp.stack([jnp.asarray(x) for x, _ in starts]),
                       jnp.stack([jnp.asarray(P) for _, P in starts]))
    jf, (_, jok) = jloc.run_ekf_fleet(js, jb, jloc.default_process_noise())
    ts = interop.ekf_state_from_reference(np.stack([x for x, _ in starts]),
                                          np.stack([P for _, P in starts]))
    tb = interop.to_torch(jloc.MeasurementBatch(*(np.asarray(f) for f in jb)))
    tf, (_, tok) = loc.run_ekf_fleet(ts, tb, loc.default_process_noise("cpu"))
    assert tok.shape == (3, 48) and np.array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), **RUN_TOL)
    np.testing.assert_allclose(tf.P.numpy(), np.asarray(jf.P), **RUN_TOL)


def _script(dual, rng, n_steps):
    """A scripted stream: odometry + IMU rates every step, an IMU
    orientation every 5th step, a SLAM pose every 3rd, GPS every 7th."""
    yaw = 0.0
    for k in range(n_steps):
        v, w = 0.5 + 0.05 * rng.normal(), 0.3 + 0.05 * rng.normal()
        yaw += w * 0.1
        dual.add_odom(v, 0.0, 0.1, var=0.01)
        dual.add_imu(0.0, 0.0, w, 0.0, var=0.005, gate=0.8)
        if k % 5 == 0:
            dual.add_imu(0.0, 0.0, 0.0, 0.0, roll=0.0, pitch=0.0, yaw=yaw,
                         var=0.005, ori_var=0.01, gate=0.8)
        if k % 3 == 0:
            dual.add_pose(0.05 * k + 0.02 * rng.normal(), 0.01 * k, yaw, var=0.02, gate=3.0)
        if k % 7 == 0:
            dual.add_gps(45.0 + 1e-6 * k, 7.0 + 1e-6 * k, 0.0, 0.0)


def test_dual_ekf_matches_reference():
    """More than 64 rows a filter, so that each flush runs two windows; the
    second flush starts from a state carried across mid-stream."""
    jd = jloc.DualEkf()
    _script(jd, np.random.default_rng(16), 30)
    td = interop.dual_ekf_from_reference(jd, device="cpu")
    assert len(td._odom_rows) > 64 and len(td._map_rows) > 64
    jo, jm = jd.flush()
    to, tm = td.flush()
    assert td.windows == 4 and td.host_syncs == 1
    for a, b in ((to, jo), (tm, jm)):
        np.testing.assert_allclose(a, np.asarray(b), **RUN_TOL)
    # carry the reference's flushed state across, then a second stream
    td = interop.dual_ekf_from_reference(jd, device="cpu")
    assert td.navsat.datum == jd.navsat.datum
    _script(jd, np.random.default_rng(17), 25)
    _script(td, np.random.default_rng(17), 25)
    jd.flush()
    td.flush()
    for t, j in ((td.odom_state, jd.odom_state), (td.map_state, jd.map_state)):
        np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), **RUN_TOL)
        np.testing.assert_allclose(t.P.numpy(), np.asarray(j.P), **RUN_TOL)


def test_ekf_state_interop_round_trip():
    x, P = _random_state(np.random.default_rng(18))
    s = interop.ekf_state_from_reference(x, P)
    assert s.x.dtype == s.P.dtype == torch.float32
    back = interop.ekf_state_to_numpy(s)
    assert np.array_equal(back.x, x) and np.array_equal(back.P, P)
    j = interop.to_torch(jloc.EkfState(x, P))
    assert isinstance(j, loc.EkfState) and torch.equal(j.P, s.P)


def test_twist_mux_matches_reference():
    rng = np.random.default_rng(19)
    port, ref = loc.TwistMux(), jloc.TwistMux()
    t = 0.0
    for _ in range(200):
        t += float(rng.uniform(0.0, 0.4))
        if rng.uniform() < 0.6:
            src = "navigation" if rng.uniform() < 0.7 else "joystick"
            v, w = float(rng.normal()), float(rng.normal())
            port.push(src, v, w, now=t)
            ref.push(src, v, w, now=t)
        q = t + float(rng.uniform(0.0, 0.8))
        assert port.output(now=q) == ref.output(now=q)
