"""The port's counterpart of ``tests/test_recovery_clear.py``: aged FI
wedges expire, the ClearCostmap recovery rung frees a wedge-ringed robot, a
durable blacklist disc survives both, and a goal's success resets the
failure counter; on the CPU with the reference's assertions."""

import dataclasses
import math

import numpy as np
import torch

from fitslam_tpu_torch.models import nav as navx
from fitslam_tpu_torch.models.exploration import ExplorationServer, GoalStatus, NavInterface
from fitslam_tpu_torch.ops import grid as gr
from fitslam_tpu_torch.utils.config import FitSlamConfig

# several pytest-xdist workers share the machine
torch.set_num_threads(2)

SPEC = gr.GridSpec2D(size=48, resolution=0.25, origin_x=-6.0, origin_y=-6.0)


class _StubNav(NavInterface):
    def __init__(self):
        self._status = GoalStatus.NONE

    def send_goal(self, goal_xy, heading=0.0):
        self._status = GoalStatus.ACTIVE

    def cancel(self):
        self._status = GoalStatus.NONE

    def status(self):
        return self._status


def _server(**bt_over):
    cfg = FitSlamConfig()
    cfg = dataclasses.replace(
        cfg,
        fisher_information=dataclasses.replace(cfg.fisher_information, enabled=False,
                                               lethal_wedge_ttl_ticks=50),
        exploration_bt=dataclasses.replace(cfg.exploration_bt, clear_costmap_failures=3,
                                           clear_costmap_radius_m=4.0, **bt_over),
    )
    occ = torch.zeros((SPEC.size, SPEC.size), dtype=torch.uint8)  # all free
    return ExplorationServer(cfg, SPEC, get_occupancy=lambda: occ, nav=_StubNav(),
                             get_robot_pose=lambda: (np.array([0.0, 0.0]), 0.0), device="cpu")


def _blocked_fraction(server, xy=(0.0, 0.0), r=3.0):
    occ = navx.apply_overlay(server.get_occupancy(), server._overlay())
    G = SPEC.size
    yy, xx = np.meshgrid(np.arange(G), np.arange(G), indexing="ij")
    wx = (xx + 0.5) * SPEC.resolution + SPEC.origin_x
    wy = (yy + 0.5) * SPEC.resolution + SPEC.origin_y
    near = (wx - xy[0]) ** 2 + (wy - xy[1]) ** 2 <= r * r
    o = occ.numpy()
    return float((o[near] >= gr.LETHAL).mean())


def _ring_with_wedges(server, tick):
    """Mark wedges in all directions around the robot (the over-marked
    pocket a stream of spurious FI failures produces)."""
    for k in range(8):
        yaw = 2 * math.pi * k / 8
        server.wedge_age = navx.mark_wedge_age(
            SPEC, server.wedge_age, torch.tensor([0.0, 0.0]), torch.tensor(yaw),
            torch.tensor(tick, dtype=torch.int32), apex_angle_rad=math.radians(60.0),
            height_m=3.0)


def test_wedges_expire_after_ttl():
    server = _server()
    _ring_with_wedges(server, tick=10)
    server.diag.ticks = 11
    assert _blocked_fraction(server) > 0.5, "wedges should block terrain"
    # the TTL is 50 ticks: at tick 61 the marks have aged out with no other event
    server.diag.ticks = 61
    assert _blocked_fraction(server) == 0.0, "aged wedges must expire"


def test_clear_costmap_rung_frees_ringed_robot():
    server = _server()
    server.diag.ticks = 10
    _ring_with_wedges(server, tick=10)
    assert _blocked_fraction(server) > 0.5
    # three consecutive failures trigger the ClearCostmap equivalent
    for _ in range(3):
        server._note_failure_for_clear(np.array([0.0, 0.0]))
    assert _blocked_fraction(server) == 0.0, \
        "ClearCostmap rung must clear wedges around the robot"


def test_durable_overlay_survives_clearing():
    server = _server()
    server.diag.ticks = 10
    # a durable blacklist-eviction disc and an aged wedge at the same spot
    circles = np.full((4, 3), 1e9, np.float32)
    circles[0] = [1.0, 0.0, 0.5]
    server.lethal_overlay = navx.mark_lethal_discs(SPEC, server.lethal_overlay,
                                                   torch.from_numpy(circles))
    _ring_with_wedges(server, tick=10)
    for _ in range(3):
        server._note_failure_for_clear(np.array([0.0, 0.0]))
    server.diag.ticks = 100   # also past the wedge TTL
    frac = _blocked_fraction(server, xy=(1.0, 0.0), r=0.4)
    assert frac > 0.5, "durable blacklist disc must survive clearing + TTL"


def test_goal_success_resets_clear_counter():
    server = _server()
    server._clear_failures = 2
    server.nav._status = GoalStatus.DONE
    server.tick()
    assert server._clear_failures == 0
