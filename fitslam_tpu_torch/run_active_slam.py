"""Run the full active-SLAM loop on a simulated rooms world (the port's
counterpart of the reference's ``examples/run_active_slam.py``).

Usage:
    python -m fitslam_tpu_torch.run_active_slam --cpu --frames 60   # small CPU run
    python -m fitslam_tpu_torch.run_active_slam --frames 160        # on the card
    python -m fitslam_tpu_torch.run_active_slam --checkpoint run.npz --record out/ --live 0

The complete stack of the reference's ``active_slam`` launch mode in one
process: stereo SLAM -> per-keyframe clouds -> traversability grid ->
frontier exploration with the Fisher-information gate -> simulated Nav2 +
rover, at the example's configuration (320x240, 320 features on 2 levels,
48 keyframes / 3072 landmarks, G = 64 at 0.25 m over the rooms world of
seed 3, FI threshold 5, loop closing off). Prints the coverage-vs-time
curve, ATE, keyframes, the exploration diagnostics, frames/s, the kernels'
launches and the profiler's table. ``--checkpoint PATH`` writes the full
system state at the end (``utils/checkpoint.py``, the reference's file
format; resuming is ``checkpoint.load_active_system``), ``--record DIR``
writes ``streams.npz``, ``coverage.csv``, ``world.ppm`` and ``map.pgm``,
``--live PORT`` serves the live view during the run (0: any free port),
``--bootstrap`` runs the initialization wiggle first and ``--ekf`` turns
on the dual-EKF state estimator. The run is on the card unless ``--cpu`` is
given, and on the simulation's clock (0.15 s a frame), so periodic work
falls on the same frames on any host; the reference reads the host's clock.
It exits 1 above the example's 0.5 m ATE bound.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch

from fitslam_tpu_torch.data import synthetic
from fitslam_tpu_torch.models import sim_robot as simr
from fitslam_tpu_torch.models.active_slam import ActiveSlamSystem, camera_pose_from_robot
from fitslam_tpu_torch.models.localization import TwistMux
from fitslam_tpu_torch.models.sim_nav import SimNavInterface
from fitslam_tpu_torch.ops import grid as gr
from fitslam_tpu_torch.ops import orb, pallas_grid, pallas_matching, pallas_patches
from fitslam_tpu_torch.ops.geometry import Intrinsics
from fitslam_tpu_torch.utils import checkpoint, evaluation as ev, viz
from fitslam_tpu_torch.utils.config import FitSlamConfig
from fitslam_tpu_torch.utils.liveview import LiveView
from fitslam_tpu_torch.utils.profiling import SimClock

W, H = 320, 240
SPEC = gr.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)
START = (-5.0, -5.0, 0.3)
DT = 0.15
TICK_EVERY = 4
ATE_BOUND_M = 0.5


def active_config(bootstrap: bool = False, ekf: bool = False) -> FitSlamConfig:
    """The reference example's configuration."""
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
        exploration_bt=dataclasses.replace(cfg.exploration_bt,
                                           bootstrap_enabled=bootstrap),
        localization=dataclasses.replace(cfg.localization, enabled=ekf),
    )


def build_system(cfg: FitSlamConfig, device="cuda", clock=None, capture=True):
    """(robot, nav, system): the simulated rover, its nav stack and the
    ActiveSlamSystem, the robot's pose read from the system's estimate
    (``capture=False``: their captured programs run as plain PyTorch)."""
    robot = simr.DiffDriveRobot(x=START[0], y=START[1], yaw=START[2], v_max=0.8, w_max=1.0)
    box = {}
    nav = SimNavInterface(
        cfg, SPEC, robot, lambda: box["s"].occupancy(), dt=DT,
        get_overlay=lambda: box["s"].explorer.lethal_overlay,
        twist_mux=TwistMux() if cfg.localization.enabled else None, device=device,
        capture=capture)
    nav.controller.max_omega = 0.9
    system = ActiveSlamSystem(cfg, SPEC, nav,
                              get_robot_pose=lambda: box["s"].estimated_robot_pose(),
                              event_logger=clock, device=device, capture=capture)
    box["s"] = system
    return robot, nav, system


def rooms_world(seed: int, device="cuda") -> torch.Tensor:
    """The rooms world of ``seed`` lifted to 3D as the example lifts it."""
    return synthetic.world_from_occupancy(
        simr.make_rooms_world(SPEC, seed=seed), SPEC, synthetic.ROOMS_WORLD_SEED,
        wall_height=2.0, points_per_wall_cell=4, floor_points=4000, device=device).landmarks


def robot_cell(robot) -> np.ndarray:
    """The rover's grid cell (x, y), on the host."""
    xy = torch.tensor([robot.x, robot.y], dtype=torch.float32)
    return SPEC.world_to_cell(xy)[0].numpy()


def kernel_launches() -> dict:
    """The kernels' launch counters: K1's two entry points (the fused
    describe and the standalone gather), K2 and K3."""
    return {"describe": orb.describe_keypoints.launches,
            "gather": pallas_patches.gather_patches.launches,
            "top2": pallas_matching.hamming_top2.launches,
            "sweep": pallas_grid.wavefront_sweeps.launches}


def start_live_view(rec, system, robot, port: int = 0):
    """The live view over ``rec``'s latest snapshots, with the explorer's
    pause / resume; returns (view, bound port). Its status reads host values
    only: the keyframe count is the loop's last published snapshot."""
    ex = system.explorer
    live = LiveView(
        rec,
        get_status=lambda: {
            "state": ex.state.name, "tick": ex.diag.ticks,
            "goals_sent": ex.diag.goals_sent,
            "keyframes": int(rec.latest("keyframes") or 0),
            "robot": [round(robot.x, 2), round(robot.y, 2)],
        },
        on_pause=ex.pause, on_resume=ex.resume, port=port)
    return live, live.start()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=110)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--checkpoint", type=str, default="")
    ap.add_argument("--record", type=str, default="",
                    help="directory for run artifacts: streams npz, coverage CSV, rendered "
                         "world PPM and the map PGM")
    ap.add_argument("--bootstrap", action="store_true",
                    help="run the InitializationSequence wiggle first")
    ap.add_argument("--live", type=int, default=-1, metavar="PORT",
                    help="serve a live inspection page on this port (0 = auto)")
    ap.add_argument("--ekf", action="store_true",
                    help="enable the dual-EKF + twist-mux state-estimation layer")
    return ap


def device_of(args: argparse.Namespace) -> str:
    return "cpu" if args.cpu else "cuda"


def run(args: argparse.Namespace, device="cuda", on_step=None) -> dict:
    """The example's loop for ``args.frames`` frames; returns its figures.
    ``on_step(step, system, live_port)``, if given, runs after each frame."""
    device = torch.device(device)
    cfg = active_config(args.bootstrap, args.ekf)
    K = Intrinsics.from_config(cfg.camera, device)
    world3d = rooms_world(args.seed, device)
    clock = SimClock()
    robot, nav, system = build_system(cfg, device, clock)
    camera = synthetic.SimCamera(K, world3d, W, H, max_depth=12.0,
                                 cloud_points=cfg.traversability.max_points_per_cloud,
                                 cloud_depth=8.0)
    rec = viz.ArtifactRecorder(enabled=bool(args.record) or args.live >= 0)
    live, port = start_live_view(rec, system, robot, args.live) if args.live >= 0 else (None, None)
    if live is not None:
        print(f"[active_slam] live view: http://127.0.0.1:{port}/")
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[active_slam] {args.frames} frames @ {W}x{H} on {where}; world seed {args.seed}")
    launches0 = kernel_launches()
    gt_traj, coverage = [], []
    t0 = None
    try:
        for step in range(args.frames):
            cam = camera_pose_from_robot(robot.x, robot.y, robot.yaw, device=device)
            if step == 0:
                system.set_world_anchor(cam)
            left, right, cloud, cvalid = camera.frame(cam)
            if step == 1:
                t0 = time.monotonic()
            system.process_frame(left, right, cloud, cvalid)
            gt_traj.append(cam.matrix())
            if step % TICK_EVERY == TICK_EVERY - 1:
                system.tick_exploration()
            nav.step()
            clock.sim_s += DT
            occ = system.occupancy()
            coverage.append((occ != gr.UNKNOWN).float().mean())
            if rec.enabled:
                occ_now = occ.cpu().numpy()
                t = step * DT
                rec.publish_pose(np.array([robot.x, robot.y, robot.yaw]), t)
                rec.record_coverage(occ_now, t)
                if system.explorer.current_goal is not None:
                    rec.publish("goal", system.explorer.current_goal, t)
                rec.publish("occupancy", occ_now, t)
                rec.publish("robot_cell", robot_cell(robot), t)
                rec.publish("keyframes", system.slam.map.n_kf.cpu().numpy(), t)
            if step % 10 == 0:
                print(f"  step {step:4d} coverage={float(coverage[-1]):.3f} "
                      f"kf={int(system.slam.map.n_kf)} "
                      f"goals={system.explorer.diag.goals_sent} "
                      f"state={system.explorer.state.name}")
            if on_step is not None:
                on_step(step, system, port)
    finally:
        if live is not None:
            live.stop()
    wall = time.monotonic() - (t0 or time.monotonic())
    system.finalize()   # drain keyframe events + read the trajectory back
    launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
    gt_traj = list(torch.stack(gt_traj).cpu().numpy().astype(np.float64))
    anchored = [gt_traj[0] @ T for T in system.slam.trajectory]
    return {"system": system, "robot": robot, "recorder": rec,
            "coverage": torch.stack(coverage).cpu().numpy().astype(np.float64).tolist(),
            "ate": ev.ate_rmse(anchored, gt_traj, align=False),
            "keyframes": int(system.slam.map.n_kf),
            "fps": (args.frames - 1) / max(wall, 1e-9), "launches": launches}


def write_artifacts(out: Path, r: dict) -> None:
    """streams.npz, coverage.csv, world.ppm and map.pgm of a run."""
    system, robot, rec = r["system"], r["robot"], r["recorder"]
    out.mkdir(parents=True, exist_ok=True)
    rec.export_npz(str(out / "streams.npz"))
    rec.export_coverage_csv(str(out / "coverage.csv"))
    occ_now = system.occupancy().cpu().numpy()
    rm = system.explorer.roadmap
    rm_cells = SPEC.world_to_cell(rm.xy)[0][rm.valid].cpu().numpy()
    rcell = robot_cell(robot)
    viz.render_world_ppm(occ_now, str(out / "world.ppm"),
                         robot_cell=(int(rcell[0]), int(rcell[1])), roadmap_cells=rm_cells)
    viz.grid_to_pgm(occ_now, str(out / "map.pgm"))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    r = run(args, device_of(args))
    system, cov = r["system"], r["coverage"]
    d = system.explorer.diag
    print(f"\n[active_slam] coverage curve (every 10 frames): {[round(c, 3) for c in cov[::10]]}")
    print(f"[active_slam] final coverage = {cov[-1]:.3f}; ATE RMSE = {r['ate'] * 100:.1f} cm; "
          f"keyframes = {r['keyframes']}")
    print(f"[active_slam] goals={d.goals_sent} replans={d.replans} "
          f"fi_rejections={d.fi_rejections} recoveries={d.recoveries} "
          f"blacklisted={d.blacklisted}")
    print(f"[active_slam] throughput = {r['fps']:.2f} frames/s (full loop incl. exploration "
          f"ticks, excl. the first frame)")
    n = r["launches"]
    print(f"[active_slam] kernel launches: K1 describe {n['describe']}, K1 gather "
          f"{n['gather']}, K2 top-2 {n['top2']}, K3 sweep {n['sweep']}")
    print()
    print(system.log.summary())
    if args.checkpoint:
        checkpoint.save_active_system(args.checkpoint, system)
        print(f"[active_slam] checkpointed full system -> {args.checkpoint}")
    if args.record:
        write_artifacts(Path(args.record), r)
        print(f"[active_slam] artifacts -> {args.record}/ (streams.npz, coverage.csv, "
              f"world.ppm, map.pgm)")
    if r["ate"] > ATE_BOUND_M:
        print("[active_slam] WARNING: ATE above 50 cm bound")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
