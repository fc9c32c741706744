"""The port's counterpart of ``tests/test_blacklist_durable.py``: circles
evicted from the fixed-capacity blacklist buffer are rasterized into the
persistent lethal overlay, so an old blacklisted goal stays excluded for the
whole mission; on the CPU with the reference's assertions."""

import dataclasses

import numpy as np
import torch

from fitslam_tpu_torch.models import costs as cx
from fitslam_tpu_torch.models import nav as navx
from fitslam_tpu_torch.models import sim_robot as sim
from fitslam_tpu_torch.models.exploration import ExplorationServer
from fitslam_tpu_torch.models.sim_nav import SimNavInterface
from fitslam_tpu_torch.ops import frontier as fx
from fitslam_tpu_torch.ops import grid as gr
from fitslam_tpu_torch.utils.config import FitSlamConfig

# several pytest-xdist workers share the machine
torch.set_num_threads(2)

SPEC = gr.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)


def _make_server():
    cfg = FitSlamConfig()
    cfg = dataclasses.replace(
        cfg,
        exploration_bt=dataclasses.replace(cfg.exploration_bt, bootstrap_enabled=False),
        fisher_information=dataclasses.replace(cfg.fisher_information, enabled=False),
    )
    occ = torch.full((SPEC.size, SPEC.size), gr.UNKNOWN, dtype=torch.uint8)
    robot = sim.DiffDriveRobot(x=0.0, y=0.0, yaw=0.0)
    nav = SimNavInterface(cfg, SPEC, robot, lambda: occ, dt=0.1, device="cpu")
    server = ExplorationServer(cfg, SPEC, lambda: occ, nav,
                               get_robot_pose=lambda: (robot.xy, robot.yaw), device="cpu")
    return server, cfg


def _frontiers_at(points):
    F = 16
    goal = np.full((F, 2), 1e6, np.float32)
    valid = np.zeros((F,), bool)
    for i, p in enumerate(points):
        goal[i] = p
        valid[i] = True
    return fx.Frontiers(uid=torch.zeros((F,), dtype=torch.int32), goal_xy=torch.from_numpy(goal),
                        centroid_xy=torch.from_numpy(goal),
                        size=torch.ones((F,), dtype=torch.int32), valid=torch.from_numpy(valid))


def test_evicted_blacklist_goal_stays_excluded():
    server, cfg = _make_server()
    cap = server.BLACKLIST_CAP
    oldest = np.array([-5.0, -5.0], np.float32)

    # push the oldest circle, then flood the buffer with > cap others far away
    server.blacklist_xy.append(oldest)
    for i in range(cap + 20):
        # spread within the grid so each rasterizes to real cells
        x = -7.0 + 0.12 * i
        server.blacklist_xy.append(np.array([x, 6.5], np.float32))

    fr = _frontiers_at([oldest, np.array([5.0, -5.0], np.float32)])
    mask = cx.blacklist_mask(fr.goal_xy, torch.from_numpy(server._blacklist_buffer())).numpy()

    # eviction happened: the buffer is bounded, the overlay gained lethal cells
    assert len(server.blacklist_xy) <= cap
    overlay = server.lethal_overlay.numpy()
    assert overlay.any(), "evicted circles were not rasterized"

    # the oldest circle is durable: still in the circle mask or covered by
    # the lethal overlay at its cell
    cell, ok = SPEC.world_to_cell(torch.from_numpy(oldest))
    cell = cell.numpy()
    assert bool(ok)
    covered = bool(mask[0]) or bool(overlay[cell[1], cell[0]])
    assert covered, "oldest blacklisted goal silently came back"

    # a never-blacklisted goal is unaffected
    cell2, _ = SPEC.world_to_cell(torch.tensor([5.0, -5.0]))
    cell2 = cell2.numpy()
    assert not bool(mask[1])
    assert not bool(overlay[cell2[1], cell2[0]])

    # the overlay feeds the tick's occupancy: the region can never be a
    # frontier again (lethal cells disqualify frontier candidacy)
    occ = navx.apply_overlay(torch.full((SPEC.size, SPEC.size), gr.UNKNOWN, dtype=torch.uint8),
                             server.lethal_overlay)
    assert occ.numpy()[cell[1], cell[0]] == gr.LETHAL or bool(mask[0])


def test_mark_lethal_discs_padding_rows_never_match():
    overlay = torch.zeros((SPEC.size, SPEC.size), dtype=torch.bool)
    buf = np.zeros((8, 3), np.float32)
    buf[:, :2] = 1e9
    buf[0] = [0.0, 0.0, 0.6]
    out = navx.mark_lethal_discs(SPEC, overlay, torch.from_numpy(buf)).numpy()
    cell, _ = SPEC.world_to_cell(torch.tensor([0.0, 0.0]))
    cell = cell.numpy()
    assert out[cell[1], cell[0]]
    # only a small disc, not the padding blowing up the whole grid
    assert out.sum() < 40
