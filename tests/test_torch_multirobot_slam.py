"""The port's multi-robot active SLAM (``run_multirobot_slam.py``) on the CPU:
two rovers, each with its OWN full SLAM stack, sharing current goals
through the ``peer_goals`` seam, against one rover alone, held to
tests/test_multirobot_slam.py's three asserts (per rover >= 4 keyframes and
>= 200 landmarks; the fleet's union coverage above the solo's plus 0.05;
both rovers moved and ended more than 2 m apart). The runs are whole loops,
held to bounds and not to per-frame equality with the reference (ROADMAP
F5); tests/test_torch_multirobot_slam_parity.py holds a short run of both
packages frame by frame.
"""

import numpy as np
import pytest
import torch

from fitslam_tpu_torch.run_multirobot_slam import run_fleet

torch.set_num_threads(2)

STEPS = 100


@pytest.fixture(scope="module")
def fleet_vs_solo():
    fleet, fleet_cov = run_fleet(2, STEPS, verbose=False, device="cpu")
    solo, solo_cov = run_fleet(1, STEPS, verbose=False, device="cpu")
    return fleet, fleet_cov, solo, solo_cov


def test_both_rovers_slam(fleet_vs_solo):
    fleet, fleet_cov, _, _ = fleet_vs_solo
    for i, (robot, nav, system) in enumerate(fleet):
        assert int(system.slam.map.n_kf) >= 4, f"rover {i} made no keyframes"
        assert int(system.slam.map.n_lm) >= 200, f"rover {i} mapped nothing"


def test_fleet_beats_solo_coverage(fleet_vs_solo):
    _, fleet_cov, _, solo_cov = fleet_vs_solo
    print(f"fleet {fleet_cov[-1]:.4f} vs solo {solo_cov[-1]:.4f}")
    assert fleet_cov[-1] > solo_cov[-1] + 0.05, (
        f"fleet {fleet_cov[-1]:.3f} vs solo {solo_cov[-1]:.3f}")


def test_rovers_explored_separately(fleet_vs_solo):
    fleet, _, _, _ = fleet_vs_solo
    (r0, _, s0), (r1, _, s1) = fleet
    # both moved, and they stayed apart (goal sharing prevents convergence
    # on the same frontier)
    t0 = np.array([(x, y) for x, y, _ in r0.trajectory])
    t1 = np.array([(x, y) for x, y, _ in r1.trajectory])
    assert np.ptp(t0, axis=0).sum() > 1.0
    assert np.ptp(t1, axis=0).sum() > 1.0
    assert np.linalg.norm([r0.x - r1.x, r0.y - r1.y]) > 2.0
