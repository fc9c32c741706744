"""The active-SLAM mission driver and its references at a tiny size on the
CPU: the reference EKF beside the port's dual EKF, the reference potential
beside the port's plan, a short run whose comparison comes out correct, and
the comparison failing the control and runs broken underneath: a plan whose
K3 sweeps return an earlier potential, an EKF whose flush leaves its state
unchanged, half of a keyframe's cloud left out of the fusion, and the
grid's lethal cells dropped where the grid is produced."""

import numpy as np
import pytest
import torch

from benchmark import core, report
from benchmark.reference import ekf as ref_ekf
from benchmark.reference import planner as ref_plan


def tiny_active():
    cell = core.resolve("active_slam_rooms64_ekf.missions")
    s = cell.config["settings"]
    s["camera"].update(width=320, height=240, fx=200.0, fy=200.0, cx=160.0, cy=120.0)
    s["orb"].update(num_features=320, num_levels=2)
    cell.traffic.update(steps=16, warm_missions=0, sample_frames=2, sample_ekf=3,
                        sample_ticks=2, sample_fusions=2, sample_grids=2, sample_within=12,
                        ticks_within=3)
    cell.limits.update(TINY_ACTIVE_LIMITS)
    return cell


# the tiny cell's limits where they differ from the cell's: the counts its
# shorter missions sample
TINY_ACTIVE_LIMITS = {"sampled_frames": {"min": 2}, "sampled_ekf": {"min": 2},
                      "sampled_plans": {"min": 2}, "sampled_fusions": {"min": 2},
                      "sampled_grids": {"min": 2}, "sampled_fi": {"min": 1}}


def test_reference_ekf_follows_the_port():
    from fitslam_tpu_torch.models.localization import DualEkf, initial_state

    ekf = DualEkf(device="cpu", capture=False)
    x0 = np.zeros(15, np.float32)
    x0[[0, 1, 5]] = [1.0, -2.0, 0.3]
    ekf.odom_state = initial_state(x0, device="cpu")
    ekf.map_state = initial_state(x0, device="cpu")
    pre = [t.clone() for t in (ekf.map_state.x, ekf.map_state.P)]
    for k in range(20):
        ekf.add_odom(0.5, 0.0, 0.15)
        ekf.add_imu(0.0, 0.0, 0.2, 0.0, gate=0.8)
        ekf.add_pose(1.0 + 0.07 * k, -2.0 + 0.01 * k, 0.3 + 0.03 * k, gate=3.0)
    rows = list(ekf._map_rows)
    ekf.flush()
    x, _ = ref_ekf.run_rows(pre[0].double(), pre[1].double(), rows)
    assert float(torch.linalg.norm(x[:2] - ekf.map_state.x[:2].double())) < 1e-5
    low, _ = ref_ekf.run_rows(pre[0].double(), pre[1].double(), rows, torch.bfloat16)
    assert float(torch.linalg.norm(low.double()[:2] - x[:2])) > 1e-3


def test_reference_potential_matches_the_plan():
    from fitslam_tpu_torch.models import nav
    from fitslam_tpu_torch.ops.grid import GridSpec2D

    spec = GridSpec2D(32, 0.25, -4.0, -4.0)
    rng = np.random.RandomState(1)
    occ = np.where(rng.rand(32, 32) < 0.1, 254, rng.randint(0, 120, (32, 32))).astype(np.uint8)
    occ[rng.rand(32, 32) < 0.05] = 255
    robot, goal = np.array([-3.1, -3.3], np.float32), np.array([2.9, 3.2], np.float32)
    o = torch.as_tensor(occ)
    pot = nav.wavefront_potential(spec, nav.clear_robot_footprint(spec, o, torch.as_tensor(robot)),
                                  torch.as_tensor(goal), iters=96)
    path, ok = nav.descend_potential(spec, pot, torch.as_tensor(robot))
    ref = ref_plan.potential(o, 0.25, -4.0, -4.0, robot, goal, 96)
    assert torch.allclose(ref, pot.double(), rtol=0, atol=1e-4)
    walk = [robot] + [p for p, v in zip(path.numpy(), ok.numpy()) if v]
    assert len(walk) > 10 and ref_plan.descent_excess(ref, 0.25, -4.0, -4.0, walk) < 1e-5
    mine = ref_plan.descend(ref, 0.25, -4.0, -4.0, robot)
    assert ref_plan.descent_excess(ref, 0.25, -4.0, -4.0, [robot] + mine) < 1e-9
    shifted = [robot] + [(x + 0.25, y) for x, y in walk[1:]]
    assert ref_plan.descent_excess(ref, 0.25, -4.0, -4.0, shifted) > 0.01


def _run(seed=2**31 + 21):
    return report.run_cell(tiny_active(), seed, 8.0, False, 0.0, device="cpu")


def test_short_missions_are_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["checks"]["camera_gap"]["value"] == 0.0
    assert r["checks"]["ekf_gap_mm"]["value"] < 0.01
    assert r["checks"]["grid_cells_off"]["value"] == 0
    assert r["checks"]["fuse_cells_off"]["value"] == 0
    assert r["notes"]["plan_excess_m"] < 1e-5
    assert set(r["metrics"]) == {"active_frames_per_s", "active_step_ms_p95", "setup_s"}


def test_control_is_not_correct():
    cell = tiny_active()
    _, ctl = core.driver(cell).control_run(cell, 2**31 + 22, torch.device("cpu"))
    verdict = report.judge({k: ctl[k] for k in ("pot_gap_m", "fuse_gap_mm", "fi_gap")},
                           {k: cell.limits[k] for k in ("pot_gap_m", "fuse_gap_mm", "fi_gap")})
    assert not any(v["ok"] for v in verdict.values()), verdict


def test_plan_from_a_stale_potential(monkeypatch):
    from fitslam_tpu_torch.models import nav, sim_nav

    cell = tiny_active()
    core.driver(cell).install_potential_tap()
    tap, real, prev = sim_nav.plan_region.bench_tap, nav.wavefront_sweeps, {}

    def stale(*a, **k):
        new = real(*a, **k)
        if not tap["on"]:
            return new
        old = prev.get("pot", new)             # the plan before's potential
        prev["pot"] = new
        return old

    monkeypatch.setattr(nav, "wavefront_sweeps", stale)
    r = _run()
    assert not r["correct"]
    assert r["checks"]["pot_gap_m"]["value"] > r["checks"]["pot_gap_m"]["limit"]


def test_ekf_flush_that_leaves_its_state_unchanged(monkeypatch):
    from fitslam_tpu_torch.models import localization as loc

    def unchanged(self):
        self._odom_rows.clear()
        self._map_rows.clear()
        return (self.odom_state.x[:6].cpu().numpy().astype(np.float64),
                self.map_state.x[:6].cpu().numpy().astype(np.float64))

    monkeypatch.setattr(loc.DualEkf, "flush", unchanged)
    r = _run()
    assert not r["correct"]
    assert r["checks"]["ekf_gap_mm"]["value"] > r["checks"]["ekf_gap_mm"]["limit"]


def test_half_a_cloud_left_out(monkeypatch):
    from fitslam_tpu_torch.ops import grid as gridops

    real = gridops.scatter_cloud_stats

    def half(spec, stats, points_c, valid, T):
        valid = valid.clone()
        valid[1::2] = False
        return real(spec, stats, points_c, valid, T)

    monkeypatch.setattr(gridops, "scatter_cloud_stats", half)
    r = _run()
    assert not r["correct"]
    assert r["checks"]["fuse_cells_off"]["value"] > r["checks"]["fuse_cells_off"]["limit"]


@pytest.mark.parametrize("where", ["grid", "fi"])
def test_answer_altered_where_produced(monkeypatch, where):
    if where == "grid":
        from fitslam_tpu_torch.ops import grid as gridops

        real = gridops.threshold_grid

        def dropped(*a, **k):
            occ = real(*a, **k)
            return torch.where(occ == gridops.LETHAL, torch.zeros_like(occ), occ)

        monkeypatch.setattr(gridops, "threshold_grid", dropped)
        check = "grid_cells_off"
    else:
        from fitslam_tpu_torch.ops import fisher

        real = fisher.pose_information
        monkeypatch.setattr(fisher, "pose_information", lambda *a, **k: real(*a, **k) * 1.05)
        check = "fi_gap"
    r = _run()
    assert not r["correct"]
    assert r["checks"][check]["value"] > r["checks"][check]["limit"]
