"""Multi-robot active SLAM: each rover runs its OWN full SLAM stack (the
port's counterpart of the reference's ``examples/run_multirobot_slam.py``).

Usage:
    python -m fitslam_tpu_torch.run_multirobot_slam [--robots N] [--steps S] [--cpu]

Each rover owns a complete ``ActiveSlamSystem`` (stereo frontend and
backend, cloud fusion, FI-gated exploration) at 320x240 with 320 features
on 2 levels, so K1, K2 and K3 run for every rover; the goal-sharing seam is
the ``peer_goals`` callback: peers' active goals act as blacklist circles in
frontier selection. The world is the rooms world of seed 3 lifted to 3D
with the seed the reference derives from ``PRNGKey(5)``
(``synthetic.ROOMS_WORLD_SEED``). Every rover runs on the simulation's
clock (``SimClock``, 0.15 s a step), so periodic work (the roadmap's
cleanup) falls on the same steps on any host; the reference reads the
host's clock. All rovers share one process and one device: the port's
module-level state is constants cached per device, the kernels' launch
counters and the kernel build, none of which one rover's work changes for
another. Prints per-rover SLAM stats and the fleet's union coverage. The
run is on the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from contextlib import nullcontext

import numpy as np
import torch

from fitslam_tpu_torch.data import synthetic
from fitslam_tpu_torch.models import sim_robot as simr
from fitslam_tpu_torch.models.active_slam import ActiveSlamSystem, camera_pose_from_robot
from fitslam_tpu_torch.models.sim_nav import SimNavInterface
from fitslam_tpu_torch.ops import grid as gr
from fitslam_tpu_torch.ops.geometry import Intrinsics
from fitslam_tpu_torch.utils.config import FitSlamConfig
from fitslam_tpu_torch.utils.profiling import SimClock

SPEC = gr.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)
STARTS = ((-5.0, -5.0, 0.3), (5.0, 5.0, -2.6), (-5.0, 5.0, -0.8))
TICK_EVERY = 4
DT = 0.15


def fleet_cfg(W: int, H: int) -> FitSlamConfig:
    """The reference's per-rover configuration."""
    cfg = FitSlamConfig()
    return dataclasses.replace(
        cfg,
        camera=dataclasses.replace(cfg.camera, width=W, height=H, fx=200.0,
                                   fy=200.0, cx=W / 2, cy=H / 2, baseline=0.2),
        orb=dataclasses.replace(cfg.orb, num_features=320, num_levels=2,
                                fast_threshold=12.0),
        tracking=dataclasses.replace(cfg.tracking, min_inliers=10,
                                     keyframe_min_interval=2,
                                     keyframe_translation=0.25),
        mapping=dataclasses.replace(cfg.mapping, max_keyframes=48,
                                    max_landmarks=3072, max_observations=8192,
                                    local_window=4, ba_iters=3),
        loop=dataclasses.replace(cfg.loop, enabled=False),
        traversability=dataclasses.replace(cfg.traversability,
                                           max_points_per_cloud=4096,
                                           max_clouds=48),
        frontier_search=dataclasses.replace(cfg.frontier_search,
                                            search_radius_m=6.0,
                                            max_frontiers=64),
        roadmap=dataclasses.replace(cfg.roadmap, max_nodes=256,
                                    cleanup_period_s=5.0),
        nav=dataclasses.replace(cfg.nav, wavefront_iters=192,
                                desired_speed=0.7),
        fisher_information=dataclasses.replace(cfg.fisher_information,
                                               threshold=5.0),
    )


def build_rover(cfg, spec, start, peer_goal_fn, device="cuda", clock=None, capture=True):
    """One complete rover: sim body + nav stack + full ActiveSlamSystem
    (``capture=False``: their captured programs run as plain PyTorch)."""
    robot = simr.DiffDriveRobot(x=start[0], y=start[1], yaw=start[2],
                                v_max=0.8, w_max=1.0)
    box = {}
    nav = SimNavInterface(cfg, spec, robot, lambda: box["s"].occupancy(),
                          dt=DT, device=device, capture=capture)
    nav.controller.max_omega = 0.9
    system = ActiveSlamSystem(
        cfg, spec, nav,
        get_robot_pose=lambda: box["s"].estimated_robot_pose(),
        event_logger=clock,
        peer_goals=peer_goal_fn,
        device=device,
        capture=capture,
    )
    box["s"] = system
    return robot, nav, system


def run_fleet(n_robots, steps, seed=3, W=320, H=240, verbose=True, device="cuda",
              timer=None, capture=True):
    """Run ``n_robots`` full-SLAM rovers for ``steps`` frames; returns
    (fleet of (robot, nav, system), union coverage every TICK_EVERY steps).
    ``timer(window, rover)``, if given, returns a context manager wrapped
    around each rover's frame step (``"frame"``, its rendering outside),
    tick (``"tick"``) and controller step (``"ctrl"``). ``capture=False``
    builds the rovers eager."""
    device = torch.device(device)
    timer = timer or (lambda window, rover: nullcontext())
    spec = SPEC
    cfg = fleet_cfg(W, H)
    K = Intrinsics.from_config(cfg.camera, device)
    occ_gt = simr.make_rooms_world(spec, seed=seed)
    world = synthetic.world_from_occupancy(
        occ_gt, spec, synthetic.ROOMS_WORLD_SEED, wall_height=2.0,
        points_per_wall_cell=4, floor_points=4000, device=device).landmarks

    # one camera for the fleet: a rover's pending cloud is held by its system
    camera = synthetic.SimCamera(K, world, W, H, max_depth=12.0,
                                 cloud_points=cfg.traversability.max_points_per_cloud,
                                 cloud_depth=8.0, capture=capture)
    fleet, clocks = [], []

    def peers_of(i):
        # the reference's multirobot_send_current_goal: peers' current goals
        def get():
            return [fleet[j][2].explorer._goal_xy
                    for j in range(len(fleet)) if j != i]
        return get

    for i in range(n_robots):
        clocks.append(SimClock())
        fleet.append(build_rover(cfg, spec, STARTS[i], peers_of(i), device, clocks[i],
                                 capture))

    coverage = []
    for step in range(steps):
        for i, (robot, nav, system) in enumerate(fleet):
            cam = camera_pose_from_robot(robot.x, robot.y, robot.yaw, device=device)
            if step == 0:
                system.set_world_anchor(cam)
            left, right, cloud, cvalid = camera.frame(cam)
            with timer("frame", i):
                system.process_frame(left, right, cloud, cvalid)
            if step % TICK_EVERY == TICK_EVERY - 1:
                with timer("tick", i):
                    system.tick_exploration()
            with timer("ctrl", i):
                nav.step()
            clocks[i].sim_s += DT
        if step % TICK_EVERY == TICK_EVERY - 1:
            known = torch.zeros((spec.size, spec.size), dtype=torch.bool, device=device)
            for (_, _, system) in fleet:
                known |= system.occupancy() != gr.UNKNOWN
            coverage.append(known.to(torch.float32).mean())
            if verbose and step % 20 == 19:
                print(f"[fleet] step {step + 1}: union coverage {float(coverage[-1]):.3f}")
    coverage = torch.stack(coverage).cpu().numpy().astype(np.float64).tolist() if coverage else []
    return fleet, coverage


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--robots", type=int, default=2, choices=range(1, len(STARTS) + 1))
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    fleet, coverage = run_fleet(args.robots, args.steps, device="cpu" if args.cpu else "cuda")
    print(f"[fleet] final union coverage: {coverage[-1]:.3f}")
    for i, (robot, nav, system) in enumerate(fleet):
        m = system.slam.map
        d = system.explorer.diag
        print(f"[rover {i}] keyframes={int(m.n_kf)} landmarks={int(m.n_lm)} "
              f"goals_sent={d.goals_sent} pos=({robot.x:+.1f},{robot.y:+.1f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
