"""The port's benchmark suite (port of the repo-level ``bench_suite.py``):
one mode a configuration, each printing ONE JSON line
``{"metric", "value", "unit", "vs_baseline", "extra"}`` as the reference's do.

    python -m fitslam_tpu_torch.bench_suite --mode all|<mode> [--small] [--cpu]
        [--out FILE] [--backend gloo|nccl]

  loop_slam    stereo SLAM with loop closing, PGO and GBA on the ring of
               seeds 1-3 (frames/s includes loop closing), then refine_map
  kernels      the port's own kernel bench: K1's fused describe, K2 at the
               window, stereo and verification shapes, K3 at three grids,
               each beside its plain twin, a library yardstick and its bound
  rgbd_fusion  RGB-D SLAM + cloud fusion + thresholded grid + frontiers
  active_slam  the full active-SLAM loop (SLAM, clouds, grid, FI-gated
               exploration, simulated nav), frames of the loop a second
  marsyard     the active-SLAM loop on the rough-terrain heightfield
  ablation     three frontier cost methods on one rooms world
  ba           bundle-adjustment iterations/s at local and global sizes
  scaling      landmark-sharded BA over 1, 2 and 8 ranks (torch.distributed)

Every mode runs on the card unless ``--cpu`` is given; without a card and
without ``--cpu`` the command fails, nothing falls back to the CPU. A mode
that raises prints no line; the others run on, and the command then exits 1
naming the failed modes on stderr. Times are taken on the host clock between
two ``torch.cuda.synchronize`` calls (frame and step rates) or by CUDA events
(kernels), never on the host clock alone. Every record's ``extra`` carries
``platform`` ("gpu" or "cpu") and ``device``: the card's
``nvidia-smi --query-gpu=name,power.limit`` line. Files the modes write go
under ``build/bench/`` (git-ignored); ``--out`` has no default. The loops'
programs run captured (``utils/jit.py``: the camera, the reveal sensor, the
frame step, the tick, the plan); the functions of the active_slam,
marsyard and ablation modes take ``capture=False`` for the eager run.

Baselines are the reference's: no published numbers, so SLAM modes are held
to 60 frames/s (2x a 30 frames/s CPU ORB-SLAM3), the active-SLAM modes to the
reference's 5 Hz rapid-mode pipeline rate and scaling to the north star's
70 % efficiency. None of them is a TPU figure.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import functools
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
ARTIFACTS = REPO / "build" / "bench"

BASELINE_FPS = 60.0         # 2x a 30 frames/s CPU ORB-SLAM3 tracking rate
BASELINE_TICK_HZ = 5.0      # the reference's rapid-mode pipeline rate
TARGET_EFFICIENCY = 0.70    # the north star's scaling efficiency

# NVIDIA's published peaks of one H100 SXM at its 700 W limit (dense): a
# kernel's bound is the larger of its bytes (each input read once, each output
# written once) over the memory rate and its operations over their type's rate
# (the float32 rate counts an FMA as two operations: instructions that do one,
# as K3's adds and mins do, issue at no more than half of it)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "f32": 67e12}

POLL = 4   # frames between two pipelined keyframe-event polls


def _call(name: str, step: int, fn):
    """The loops' default window: run fn. A caller that measures the loops
    (``chip_smoke.py``) passes its own ``window(name, step, fn)``, which
    must call fn once and return its result."""
    return fn()


# ---------------------------------------------------------------------------
# Devices, clocks and records
# ---------------------------------------------------------------------------


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device must exist (no mode falls
    back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bench runs on the card (--cpu for the CPU)")
    return dev


def barrier(device) -> None:
    """Wait until the device has done everything queued on it."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def clock(device) -> float:
    """The host clock (s) after a barrier: a span between two such readings
    is the device's time for the work queued between them, or the host's
    where the host is slower."""
    barrier(device)
    return time.perf_counter()


@functools.lru_cache(maxsize=None)
def device_info(device: str) -> str:
    """The card's ``nvidia-smi --query-gpu=name,power.limit`` line ("cpu" on
    the CPU)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[dev.index or 0]


def _tagged(extra: dict, device) -> dict:
    """``extra`` with the run's platform (the reference's vocabulary) and card."""
    dev = torch.device(device)
    return {**extra, "platform": "gpu" if dev.type == "cuda" else "cpu",
            "device": device_info(str(dev))}


def _emit(metric, value, unit, vs, extra) -> dict:
    """Print and return one record, rounded as the reference rounds it."""
    rec = {"metric": metric, "value": round(value, 3), "unit": unit,
           "vs_baseline": round(vs, 3), "extra": extra}
    print(json.dumps(rec), flush=True)
    return rec


def cuda_time_ms(fn, reps: int = 50, warmup: int = 5):
    """(device ms, wall ms) per call of fn().

    Device: CUDA events around ``reps`` calls queued behind a ~0.1 s device
    spin, so the device runs them back to back however long the host takes
    to enqueue them. Wall: the host clock around ``reps`` calls and a
    synchronize, i.e. the larger of the host's and the device's cost."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, wall_ms


def bound(n_bytes: float, n_ops: float = 0.0, op_type: str = "f32") -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak of their type, whichever is larger."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_OPS_PER_S[op_type] * 1e3
    if by_bytes >= by_ops:
        return {"bound_ms": by_bytes, "bound_by": "bytes"}
    return {"bound_ms": by_ops, "bound_by": "operations"}


def _slam_cfg(small: bool):
    """The SLAM modes' configuration (the reference's ``_slam_cfg``)."""
    from fitslam_tpu_torch.utils.config import FitSlamConfig

    cfg = FitSlamConfig()
    if small:
        W, H, feats, levels = 320, 240, 384, 2
    else:
        W, H, feats, levels = 640, 480, 1024, 4
    return dataclasses.replace(
        cfg,
        camera=dataclasses.replace(cfg.camera, width=W, height=H, fx=0.625 * W, fy=0.625 * W,
                                   cx=W / 2, cy=H / 2, baseline=0.2),
        orb=dataclasses.replace(cfg.orb, num_features=feats, num_levels=levels,
                                fast_threshold=12.0),
        tracking=dataclasses.replace(cfg.tracking, min_inliers=10, keyframe_min_interval=2,
                                     keyframe_translation=0.3, keyframe_rotation=0.15),
        # the ring creates ~160 landmarks a keyframe for ~100 keyframes: the
        # capacity holds the whole loop; close points within 35 baselines
        mapping=dataclasses.replace(cfg.mapping, max_keyframes=128, max_landmarks=20480,
                                    max_observations=65536, local_window=4, ba_iters=3,
                                    close_depth_factor=35.0),
    ), (W, H)


def loop_config(small: bool):
    """The loop_slam mode's configuration: ``_slam_cfg`` with loop closing
    on at the reference's detection thresholds (true revisits score
    0.37-1.0 against a ~0.09 background; two consecutive keyframes agree)."""
    cfg, _ = _slam_cfg(small)
    return dataclasses.replace(cfg, loop=dataclasses.replace(
        cfg.loop, enabled=True, min_gap_keyframes=15, min_score=0.22, consistency_threshold=2,
        min_matches=40))


def _gt_matrices(T) -> list:
    """(N,) SE3 -> N float64 4x4 matrices on the host."""
    return list(T.matrix().cpu().numpy().astype(np.float64))


# ---------------------------------------------------------------------------
# loop_slam
# ---------------------------------------------------------------------------


def ring_run(slam, frames, gt, device, refine_cycles: int = 10, window=_call) -> dict:
    """One run of the ring on ``slam`` (a fresh StereoSlam): frame 0, then
    the other frames by ``process_frame_async`` with a pipelined
    keyframe-event poll every POLL frames and a flushing one at the end,
    timed from frame 1 on; then ``finalize``, the ATEs, and ``refine_map``
    (``refine_cycles`` cycles of re-triangulation + 15 GBA iterations) timed
    apart. ``window`` runs frame 0 ("first") and the timed frames with their
    polls ("frames"). Returns frames/s, the three ATEs (uncorrected,
    corrected before and after the refine), the refine's seconds and the
    trajectory before the refine."""
    from fitslam_tpu_torch.utils import evaluation as ev

    n_total = len(frames)
    window("first", 0, lambda: slam.process_frame_async(*frames[0]))
    t0 = clock(device)

    def rest():
        for i in range(1, n_total):
            slam.process_frame_async(*frames[i])
            if i % POLL == 0:
                slam.poll_keyframe_events(flush=False)
        slam.poll_keyframe_events()

    window("frames", 1, rest)
    fps = (n_total - 1) / (clock(device) - t0)
    slam.finalize()
    trajectory = [T.copy() for T in slam.trajectory]
    ate = ev.ate_rmse(slam.trajectory, gt)
    ate_pre = ev.ate_rmse(slam.corrected_trajectory(), gt)
    t0 = clock(device)
    if refine_cycles:
        slam.refine_map(cycles=refine_cycles, gba_iters=15)
    refine_s = clock(device) - t0
    return dict(fps=fps, ate_uncorrected=ate, ate_pre_refine=ate_pre,
                ate=ev.ate_rmse(slam.corrected_trajectory(), gt), refine_s=refine_s,
                trajectory=trajectory)


def bench_loop_slam(small: bool, n_frames: int = 200, as_dict: bool = False,
                    seeds=(1, 2, 3), device="cuda", refine_cycles: int = 10):
    """Loop closing on the ring: a full circle (360 degrees of rotation) and
    a re-entry overlap, loop closing + PGO + global BA on, the asynchronous
    frame path with a pipelined keyframe-event poll every POLL frames. The
    run repeats over the ring worlds of ``seeds`` (drawn as ``jax.random``
    draws them, ``utils/prng.py``); the record holds the median frames/s, the
    median and largest post-refine ATE, the fewest loops closed and each
    seed's figures. ``refine_map`` (``refine_cycles`` cycles of
    re-triangulation + 15 GBA iterations) runs after the timed frames and is
    timed apart. With
    ``as_dict`` the payload is returned and nothing is printed."""
    from fitslam_tpu_torch.data import synthetic
    from fitslam_tpu_torch.models.slam import StereoSlam
    from fitslam_tpu_torch.ops import lie
    from fitslam_tpu_torch.ops.geometry import Intrinsics
    from fitslam_tpu_torch.utils import prng

    dev = resolve_device(device)
    cfg = loop_config(small)
    W, H = cfg.camera.width, cfg.camera.height
    K = Intrinsics.from_config(cfg.camera, dev)
    ring = synthetic.loop_trajectory(n_frames, radius=8.0, device=dev)
    overlap = max(4, n_frames // 25)
    T_gt = lie.SE3(torch.cat([ring.R, ring.R[:overlap]]), torch.cat([ring.t, ring.t[:overlap]]))
    n_total = n_frames + overlap
    gt = _gt_matrices(T_gt)

    def render_world(seed):
        world = synthetic.ring_world(prng.prng_key(seed), num=5000, radius=8.0, width=5.0,
                                     device=dev).landmarks
        return [synthetic.render_stereo(K, world, lie.SE3(T_gt.R[i], T_gt.t[i]), width=W,
                                        height=H, max_depth=14.0)
                for i in range(n_total)]

    per_seed = []
    for k, seed in enumerate(seeds):
        frames = render_world(seed)
        if k == 0:   # warm pass: first calls of every path, the refine's too
            ring_run(StereoSlam(cfg, dev), frames, gt, dev, refine_cycles=min(refine_cycles, 1))
        slam = StereoSlam(cfg, dev)
        r = ring_run(slam, frames, gt, dev, refine_cycles)
        per_seed.append({
            "seed": seed, "fps": round(r["fps"], 2),
            "ate_rmse_m": round(r["ate"], 4),
            "ate_rmse_pre_refine_m": round(r["ate_pre_refine"], 4),
            "ate_rmse_uncorrected_m": round(r["ate_uncorrected"], 4),
            "refine_s": round(r["refine_s"], 2),
            "loops_closed": len(slam.loop_events),
            "n_keyframes": int(slam.map.n_kf),
        })
        del frames, slam, r

    fps_med = float(np.median([r["fps"] for r in per_seed]))
    payload = dict(
        metric="loop_slam_frames_per_s_per_chip", value=fps_med, unit="frames/s",
        vs=fps_med / BASELINE_FPS, extra=_tagged({
            "ate_rmse_m": round(float(np.median([r["ate_rmse_m"] for r in per_seed])), 4),
            "ate_rmse_m_max": round(max(r["ate_rmse_m"] for r in per_seed), 4),
            "ate_rmse_uncorrected_m": round(float(np.median(
                [r["ate_rmse_uncorrected_m"] for r in per_seed])), 4),
            "loops_closed_min": min(r["loops_closed"] for r in per_seed),
            "seeds_with_loops": sum(r["loops_closed"] > 0 for r in per_seed),
            "n_seeds": len(seeds),
            "per_seed": per_seed,
            "loop_closing_included": True,
            "rotation_deg_total": 360,
            "resolution": f"{W}x{H}",
        }, dev))
    if as_dict:
        return payload
    return _emit(**payload)


# ---------------------------------------------------------------------------
# rgbd_fusion
# ---------------------------------------------------------------------------


def bench_rgbd_fusion(small: bool, n_frames: int = 60, device="cuda"):
    """RGB-D frontend + incremental cloud fusion + thresholded traversability
    grid + frontier extraction a keyframe, on a 128x128 grid at 0.25 m. The
    fusion runs from the keyframe events of pipelined polls (a keyframe's
    fusion may lag the camera by up to POLL frames); no per-frame read."""
    from fitslam_tpu_torch.data import synthetic
    from fitslam_tpu_torch.models.slam import StereoSlam
    from fitslam_tpu_torch.ops import frontier as fx
    from fitslam_tpu_torch.ops import grid as gridops
    from fitslam_tpu_torch.ops import lie
    from fitslam_tpu_torch.ops.geometry import Intrinsics
    from fitslam_tpu_torch.ops.grid import GridSpec2D
    from fitslam_tpu_torch.utils import prng

    dev = resolve_device(device)
    cfg, (W, H) = _slam_cfg(small)
    cfg = dataclasses.replace(
        cfg,
        camera=dataclasses.replace(cfg.camera, rgbd=True),
        loop=dataclasses.replace(cfg.loop, enabled=False),
        traversability=dataclasses.replace(cfg.traversability, max_points_per_cloud=4096,
                                           max_clouds=64),
    )
    tcfg = cfg.traversability
    K = Intrinsics.from_config(cfg.camera, dev)
    spec = GridSpec2D(size=128, resolution=0.25, origin_x=-16.0, origin_y=-16.0)
    world = synthetic.corridor_world(prng.prng_key(3), num=4000, length=24.0, width=5.0,
                                     device=dev).landmarks
    T_gt = synthetic.straight_trajectory(n_frames, length=n_frames * 0.15, height=1.2,
                                         start_x=0.5, device=dev)
    frames = []
    for i in range(n_frames):
        Ti = lie.SE3(T_gt.R[i], T_gt.t[i])
        img, depth = synthetic.render_rgbd(K, world, Ti, width=W, height=H, max_depth=12.0)
        cloud, cvalid = synthetic.frustum_cloud(K, world, Ti, max_points=tcfg.max_points_per_cloud,
                                                max_depth=8.0, width=W, height=H)
        frames.append((img, depth, cloud, cvalid))

    def run():
        slam = StereoSlam(cfg, dev)
        state = {"clouds": gridops.empty_cloud_buffer(tcfg.max_clouds, tcfg.max_points_per_cloud,
                                                      dev),
                 "stats": gridops.empty_cell_stats(spec, dev), "occ": None, "fr": None}
        cloud_ring = {}

        def on_kf(s, kf_idx):
            cloud, cvalid = cloud_ring.get(s.last_keyframe_frame_id, (None, None))
            if cloud is None:
                return
            state["clouds"] = gridops.add_cloud(state["clouds"], cloud, cvalid, kf_idx)
            # incremental fusion: only this keyframe's cloud enters the
            # running statistics (loop closing is off in this configuration)
            T_kf = lie.SE3(s.map.kf_T_cw.R[kf_idx], s.map.kf_T_cw.t[kf_idx])
            state["stats"] = gridops.scatter_cloud_stats(spec, state["stats"], cloud, cvalid,
                                                         T_kf)
            g = gridops.grid_from_stats(spec, state["stats"], max_slope=tcfg.max_slope,
                                        ground_clearance=tcfg.ground_clearance,
                                        robot_height=tcfg.robot_height,
                                        security_distance=tcfg.security_distance)
            state["occ"] = gridops.threshold_grid(g, tcfg.lethal_threshold)
            state["fr"] = fx.extract_frontiers(spec, state["occ"], s.map.kf_T_cw.t[0][:2], 12.0,
                                               max_cells=4096, max_frontiers=64,
                                               max_cluster_size=20)

        slam.keyframe_events.append(on_kf)
        t0 = clock(dev)
        for i, (img, depth, cloud, cvalid) in enumerate(frames):
            cloud_ring[i] = (cloud, cvalid)
            slam.process_rgbd_frame_async(img, depth)
            if i % POLL == POLL - 1:
                slam.poll_keyframe_events(flush=False)
        slam.poll_keyframe_events()
        wall = clock(dev) - t0
        n_front = int(state["fr"].valid.sum()) if state["fr"] is not None else 0
        return wall, slam, n_front

    run()                       # warm pass
    wall, slam, n_front = run()
    fps = n_frames / wall
    return _emit("rgbd_fusion_frames_per_s_per_chip", fps, "frames/s", fps / BASELINE_FPS,
                 _tagged({"n_keyframes": int(slam.map.n_kf), "grid": "128x128@0.25",
                          "frontiers_final": n_front, "resolution": f"{W}x{H}"}, dev))


# ---------------------------------------------------------------------------
# active_slam and marsyard
# ---------------------------------------------------------------------------


def active_config(W: int, H: int, features: int, levels: int, fx: float):
    """The active-SLAM modes' configuration (G = 64 at 0.25 m, 48 keyframes,
    48 clouds of 4096 points, FI threshold 5)."""
    from fitslam_tpu_torch.utils.config import FitSlamConfig

    cfg = FitSlamConfig()
    R = dataclasses.replace
    return R(
        cfg,
        camera=R(cfg.camera, width=W, height=H, fx=fx, fy=fx, cx=W / 2, cy=H / 2, baseline=0.2),
        orb=R(cfg.orb, num_features=features, num_levels=levels, fast_threshold=12.0),
        tracking=R(cfg.tracking, min_inliers=10, keyframe_min_interval=2,
                   keyframe_translation=0.25),
        mapping=R(cfg.mapping, max_keyframes=48, max_landmarks=3072, max_observations=8192,
                  local_window=4, ba_iters=3),
        loop=R(cfg.loop, enabled=False),
        traversability=R(cfg.traversability, max_points_per_cloud=4096, max_clouds=48),
        frontier_search=R(cfg.frontier_search, search_radius_m=6.0, max_frontiers=64),
        roadmap=R(cfg.roadmap, max_nodes=256, cleanup_period_s=5.0),
        nav=R(cfg.nav, wavefront_iters=192, desired_speed=0.7),
        fisher_information=R(cfg.fisher_information, threshold=5.0),
    )


SIM_DT = 0.15       # simulated seconds a step of the active loop
TICK_EVERY = 4      # frames between two exploration ticks of the active loop


def rooms_world(spec, device, floor_points: int = 4000):
    """The rooms world of seed 3 as 3D landmarks (walls 2 m high, 4 points a
    wall cell, the reference's ``jax.random.PRNGKey(5)`` draws)."""
    from fitslam_tpu_torch.data import synthetic
    from fitslam_tpu_torch.models.sim_robot import make_rooms_world

    return synthetic.world_from_occupancy(make_rooms_world(spec, seed=3), spec,
                                          synthetic.ROOMS_WORLD_SEED, wall_height=2.0,
                                          points_per_wall_cell=4, floor_points=floor_points,
                                          device=device)


def active_system(cfg, spec, robot, device, max_omega=None, twist_mux=None, capture=True):
    """An ActiveSlamSystem over a simulated robot and its SimNavInterface
    (0.15 s a controller step), scheduled on the simulation's clock (a
    ``SimClock``), not the host's: on the host's clock the roadmap's periodic
    cleanup falls on other steps on a faster or slower host, and the run's
    goals and path differ. ``capture=False`` builds the eager system.
    Returns (system, nav)."""
    from fitslam_tpu_torch.models.active_slam import ActiveSlamSystem
    from fitslam_tpu_torch.models.sim_nav import SimNavInterface
    from fitslam_tpu_torch.utils.profiling import SimClock

    box = {}
    nav = SimNavInterface(cfg, spec, robot, lambda: box["s"].occupancy(), dt=SIM_DT,
                          twist_mux=twist_mux, device=device, capture=capture)
    if max_omega is not None:
        nav.controller.max_omega = max_omega
    system = ActiveSlamSystem(cfg, spec, nav, device=device, event_logger=SimClock(),
                              get_robot_pose=lambda: box["s"].estimated_robot_pose(),
                              capture=capture)
    box["s"] = system
    return system, nav


def active_loop(system, nav, landmarks, n_frames: int, surface_z=None, window=_call):
    """The active-SLAM loop of both modes: a stereo frame and its frustum
    cloud every step (a ``SimCamera``, captured as the system is), a tick
    every TICK_EVERY steps, a controller step every step, and the
    simulation's clock advanced by a step. ``window`` runs the frame
    ("frame"), the tick ("tick"), the controller step ("ctrl") and, with the
    EKF on, the read of its estimate ("pose"). Returns (frames a second from
    step 8 on, the first steps being set-up; the camera poses)."""
    from fitslam_tpu_torch.data import synthetic
    from fitslam_tpu_torch.models.active_slam import camera_pose_from_robot
    from fitslam_tpu_torch.ops.geometry import Intrinsics

    if n_frames <= 8:
        raise ValueError(f"the loop is timed from its step 8 on: {n_frames} frames are too few")
    cfg, dev, robot = system.cfg, system.device, nav.robot
    W, H = cfg.camera.width, cfg.camera.height
    camera = synthetic.SimCamera(Intrinsics.from_config(cfg.camera, dev), landmarks, W, H,
                                 max_depth=12.0,
                                 cloud_points=cfg.traversability.max_points_per_cloud,
                                 cloud_depth=8.0, capture=system.capture)
    t0, cams = None, []
    for step in range(n_frames):
        z = 0.8 if surface_z is None else surface_z(robot.x, robot.y) + 0.8
        cam = camera_pose_from_robot(robot.x, robot.y, robot.yaw, height=z, device=dev)
        if step == 0:
            system.set_world_anchor(cam)
        left, right, cloud, cvalid = camera.frame(cam)
        if step == 8:
            t0 = clock(dev)
        else:
            barrier(dev)
        window("frame", step, lambda: system.process_frame(left, right, cloud, cvalid))
        cams.append(cam)
        if step % TICK_EVERY == TICK_EVERY - 1:
            window("tick", step, system.tick_exploration)
        window("ctrl", step, nav.step)
        if system.ekf is not None:
            window("pose", step, system.estimated_robot_pose)
        system.log.sim_s += SIM_DT
    return (n_frames - 8) / (clock(dev) - t0), cams


def ate_world(trajectory, gt) -> float:
    """ATE of a SLAM trajectory anchored at the first ground-truth camera
    pose (``gt``: float64 4x4 matrices), without alignment, as the
    reference's active modes and tests take it."""
    from fitslam_tpu_torch.utils import evaluation as ev

    return ev.ate_rmse([gt[0] @ T for T in trajectory], gt, align=False)


def camera_matrices(cams) -> list:
    """The loop's camera poses as float64 4x4 matrices."""
    from fitslam_tpu_torch.ops import lie

    return _gt_matrices(lie.SE3(torch.stack([c.R for c in cams]), torch.stack([c.t for c in cams])))


def lethal_scores(occ, gt_lethal, spec, traj_xy):
    """The marsyard's terrain scores: the grid's known lethal cells, their
    precision against the ground truth's lethal cells dilated by 3 cells,
    and the ground-truth lethal cells the robot's path (x, y) crossed."""
    from fitslam_tpu_torch.ops import grid as gr

    grid_lethal = (occ != gr.UNKNOWN) & (occ >= gr.INSCRIBED)
    gt_dil, r = np.zeros_like(gt_lethal), 3
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            gt_dil |= np.roll(np.roll(gt_lethal, dy, axis=0), dx, axis=1)
    precision = float((grid_lethal & gt_dil).sum() / max(grid_lethal.sum(), 1))
    cells = np.clip(((traj_xy - [spec.origin_x, spec.origin_y]) / spec.resolution).astype(int),
                    0, spec.size - 1)
    return grid_lethal, precision, int(gt_lethal[cells[:, 1], cells[:, 0]].sum()), cells


def bench_active_slam(small: bool, n_frames: int = 80, device="cuda", capture: bool = True):
    """The full loop: stereo SLAM, a cloud a keyframe, the traversability
    grid, FI-gated exploration and simulated nav over the rooms world of
    seed 3 (G = 64), frames of the loop a second (the reference's
    "ticks/s"). ``capture=False`` runs the loop's captured programs (the
    camera's among them) as plain PyTorch."""
    from fitslam_tpu_torch.models import sim_robot as simr
    from fitslam_tpu_torch.ops import grid as gr

    dev = resolve_device(device)
    W, H = (320, 240) if small else (640, 480)
    spec = gr.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)
    cfg = active_config(W, H, 320 if small else 1024, 2 if small else 4, fx=0.625 * W)
    robot = simr.DiffDriveRobot(x=-5.0, y=-5.0, yaw=0.3, v_max=0.8, w_max=1.0)
    system, nav = active_system(cfg, spec, robot, dev, capture=capture)
    ticks, cams = active_loop(system, nav, rooms_world(spec, dev).landmarks, n_frames)
    system.finalize()
    ate = ate_world(system.slam.trajectory, camera_matrices(cams))
    coverage = float((system.occupancy() != gr.UNKNOWN).float().mean())
    d = system.explorer.diag
    return _emit("active_slam_ticks_per_s", ticks, "ticks/s", ticks / BASELINE_TICK_HZ, _tagged({
        "ate_rmse_m": round(ate, 4),
        "coverage": round(coverage, 3),
        "goals_sent": d.goals_sent,
        "fi_rejections": d.fi_rejections,
        "n_keyframes": int(system.slam.map.n_kf),
        "includes": "slam+clouds+grid+exploration+nav",
    }, dev))


def bench_marsyard(small: bool, n_frames: int = 150, device="cuda", capture: bool = True):
    """The active-SLAM loop on the marsyard heightfield (seed 3, 320x240):
    frames a second, the grid's lethal cells against the ground truth's
    (dilated 3 cells), lethal cells driven through and coverage. Writes the
    coverage curve and the trajectory over the final grid under
    build/bench/. ``capture=False`` runs the loop's captured programs as
    plain PyTorch."""
    from fitslam_tpu_torch.data import synthetic
    from fitslam_tpu_torch.models import sim_robot as simr
    from fitslam_tpu_torch.ops import grid as gr
    from fitslam_tpu_torch.utils import viz

    dev = resolve_device(device)
    spec = gr.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)
    cfg = active_config(320, 240, 320, 2, fx=200.0)
    mw = synthetic.marsyard_world(spec, seed=3, points_per_cell=6, device=dev)
    robot = simr.DiffDriveRobot(x=-5.0, y=-0.5, yaw=0.2, v_max=0.8, w_max=1.0)
    system, nav = active_system(cfg, spec, robot, dev, max_omega=0.9, capture=capture)
    coverage = []

    def window(name, step, fn):
        out = fn()
        if name == "tick":
            coverage.append(float((system.occupancy() != gr.UNKNOWN).float().mean()))
        return out

    ticks, _ = active_loop(system, nav, mw.world.landmarks, n_frames,
                           surface_z=lambda x, y: synthetic.marsyard_surface_z(x, y, mw, spec),
                           window=window)
    occ = system.occupancy().cpu().numpy()
    grid_lethal, precision, viol, cells = lethal_scores(
        occ, mw.gt_lethal, spec, np.array([(x, y) for x, y, _ in robot.trajectory]))
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    csv, ppm = ARTIFACTS / "MARSYARD_COVERAGE.csv", ARTIFACTS / "MARSYARD_TRAJECTORY.ppm"
    with open(csv, "w") as f:
        f.write("tick,coverage\n")
        for i, c in enumerate(coverage):
            f.write(f"{i},{c:.4f}\n")
    viz.render_world_ppm(occ, str(ppm), robot_cell=tuple(cells[-1]), path_cells=cells)
    return _emit("marsyard_ticks_per_s", ticks, "ticks/s", ticks / BASELINE_TICK_HZ, _tagged({
        "terrain_lethal_cells": int(grid_lethal.sum()),
        "lethal_precision_vs_gt": round(precision, 3),
        "gt_lethal_violations": viol,
        "final_coverage": round(coverage[-1] if coverage else 0.0, 3),
        "goals_sent": system.explorer.diag.goals_sent,
        "world": "marsyard heightfield seed=3",
        "artifacts": [str(p.relative_to(REPO)) for p in (csv, ppm)],
    }, dev))


# ---------------------------------------------------------------------------
# ablation
# ---------------------------------------------------------------------------

ABLATION_METHODS = {"arrival_info_roadmap": ("ArrivalInformation", "RoadmapPlannerDistance"),
                    "random": ("RandomCosts",), "closest": ("ClosestFrontier",)}


def ablation_config(methods=ABLATION_METHODS["arrival_info_roadmap"]):
    """The ablation's G = 64 configuration with one frontier cost method (by
    default arrival information + roadmap, tests/test_exploration_e2e.py's)."""
    from fitslam_tpu_torch.utils.config import FitSlamConfig

    cfg = FitSlamConfig()
    R = dataclasses.replace
    return R(cfg,
             frontier_search=R(cfg.frontier_search, search_radius_m=6.0, max_frontiers=64),
             roadmap=R(cfg.roadmap, max_nodes=256, cleanup_period_s=5.0),
             nav=R(cfg.nav, wavefront_iters=192, desired_speed=0.8),
             exploration_bt=R(cfg.exploration_bt, nav2_goal_timeout_s=30.0),
             fisher_information=R(cfg.fisher_information, enabled=False),
             cost_assigner=R(cfg.cost_assigner, cost_calculation_methods=methods))


def _plot_ablation(curves, png_path) -> None:
    """The coverage curves as a PNG, where matplotlib is installed."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    colors = ["#2a78d6", "#eb6834", "#1baf7a"]
    fig, ax = plt.subplots(figsize=(7, 4), dpi=120)
    for (name, cov), c in zip(curves.items(), colors):
        ax.plot(range(len(cov)), cov, color=c, linewidth=2, label=name)
        ax.annotate(name, (len(cov) - 1, cov[-1]), textcoords="offset points", xytext=(4, 0),
                    fontsize=8, color="#52514e")
    ax.set_xlabel("simulation step")
    ax.set_ylabel("coverage fraction")
    ax.set_title("Exploration method ablation — coverage vs time")
    ax.set_ylim(0, 1)
    ax.grid(color="#e6e5e0", linewidth=0.6)
    ax.spines[["top", "right"]].set_visible(False)
    ax.legend(frameon=False, fontsize=8, loc="lower right")
    fig.tight_layout()
    fig.savefig(png_path, facecolor="#fcfcfb", bbox_inches="tight")
    plt.close(fig)


def explore_run(cfg, spec, start_xy, n_steps: int, device, window=_call,
                capture: bool = True) -> dict:
    """The exploration loop of the ablation (tests/test_exploration_e2e.py's)
    on the rooms world of seed 1, the explored map its occupancy: a 3 m
    reveal a step, a tick every second step (past DONE too, which keeps the
    curves comparable) and 4 controller steps a step. ``window`` runs the
    tick ("tick") and the step's 4 controller steps ("ctrl"). Returns the
    known cells after each step (an int64 tensor on the device, read by the
    caller once), the server, the nav, the robot, the explored map and the
    reveal sensor. ``capture=False`` runs the sensor's, the server's and the
    nav's captured programs as plain PyTorch.

    The server schedules on the simulation's clock (a ``SimClock``, SIM_DT a
    step, as ``active_system``'s), not the host's: the roadmap's periodic
    cleanup then falls on the same steps on every host and in every mode.
    The reference's loop schedules on the host's clock."""
    from fitslam_tpu_torch.models import sim_robot as sim
    from fitslam_tpu_torch.models.exploration import ExplorationServer
    from fitslam_tpu_torch.models.sim_nav import SimNavInterface
    from fitslam_tpu_torch.ops import grid as gr
    from fitslam_tpu_torch.utils.profiling import SimClock

    dev = torch.device(device)
    sensor = sim.RevealSensor(spec, torch.as_tensor(sim.make_rooms_world(spec, seed=1),
                                                    device=dev),
                              dev, range_m=3.0, capture=capture)
    robot = sim.DiffDriveRobot(x=start_xy[0], y=start_xy[1], yaw=0.0, v_max=1.2, w_max=2.5)
    nav = SimNavInterface(cfg, spec, robot, lambda: sensor.explored, dt=0.15, device=dev,
                          capture=capture)
    nav.controller.max_omega = 2.0
    server = ExplorationServer(cfg, spec, lambda: sensor.explored, nav,
                               get_robot_pose=lambda: (robot.xy, robot.yaw), device=dev,
                               event_logger=SimClock(), capture=capture)

    def controller_steps():
        for _ in range(4):
            nav.step()

    known = torch.zeros(n_steps, dtype=torch.int64, device=dev)
    for step in range(n_steps):
        explored = sensor.reveal(robot.xy)
        if step % 2 == 0:
            window("tick", step, server.tick)
        window("ctrl", step, controller_steps)
        known[step] = (explored != gr.UNKNOWN).sum()
        server.log.sim_s += SIM_DT
    return dict(known=known, server=server, nav=nav, robot=robot, explored=sensor.explored,
                sensor=sensor)


ABLATION_SPEC = dict(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)
ABLATION_START = (-5.0, -5.0)


def bench_ablation(small: bool, n_steps: int = 300, device="cuda", capture: bool = True):
    """One rooms world (seed 1, G = 64) explored with each frontier cost
    method (arrival information + roadmap, RandomCosts, ClosestFrontier):
    final coverage, steps to 50 % and path length of each; the curves go to
    build/bench/ABLATION_COVERAGE.csv (and .png where matplotlib is)."""
    from fitslam_tpu_torch.ops import grid as gr
    from fitslam_tpu_torch.utils.evaluation import path_length

    dev = resolve_device(device)
    spec = gr.GridSpec2D(**ABLATION_SPEC)
    curves, finals = {}, {}
    for name, meth in ABLATION_METHODS.items():
        run = explore_run(ablation_config(meth), spec, ABLATION_START, n_steps, dev,
                          capture=capture)
        # the fraction of known cells a step, read once at the end
        cov = (run["known"].cpu().numpy() / float(spec.size * spec.size)).tolist()
        curves[name] = cov
        finals[name] = {
            "final_coverage": round(cov[-1], 3),
            "steps_to_50pct": next((i for i, c in enumerate(cov) if c >= 0.5), -1),
            "path_length_m": round(path_length(np.array([(x, y) for x, y, _ in
                                                         run["robot"].trajectory])), 1),
        }
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    out = ARTIFACTS / "ABLATION_COVERAGE.csv"
    with open(out, "w") as f:
        f.write("step," + ",".join(curves) + "\n")
        for i in range(n_steps):
            f.write(f"{i}," + ",".join(f"{curves[m][i]:.4f}" for m in curves) + "\n")
    _plot_ablation(curves, out.with_suffix(".png"))
    best = max(finals, key=lambda m: finals[m]["final_coverage"])
    return _emit("ablation_best_final_coverage", finals[best]["final_coverage"], "fraction",
                 finals[best]["final_coverage"] / max(finals["random"]["final_coverage"], 1e-9),
                 _tagged({"methods": finals, "best": best, "csv": str(out.relative_to(REPO)),
                          "world": "rooms seed=1", "steps": n_steps}, dev))


# ---------------------------------------------------------------------------
# ba and scaling
# ---------------------------------------------------------------------------

BA_SIZES = {"local": dict(n_kf=8, n_lm=2048, n_obs=8192),
            "global": dict(n_kf=256, n_lm=8192, n_obs=32768)}
BA_SIZES_SMALL = {"local": BA_SIZES["local"], "global": dict(n_kf=64, n_lm=4096, n_obs=16384)}


def ba_intrinsics(device):
    """The BA problems' camera (``tests/test_ba.py``'s ``K``)."""
    from fitslam_tpu_torch.ops.geometry import Intrinsics

    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return Intrinsics(fx=f32(320.0), fy=f32(320.0), cx=f32(320.0), cy=f32(240.0),
                      baseline=f32(0.12))


def make_ba_problem(key, n_kf: int = 4, n_lm: int = 256, n_obs: int = 1024,
                    noise_px: float = 0.4, pose_noise: float = 0.05, point_noise: float = 0.05,
                    device="cuda"):
    """A ground-truth landmark field seen by ``n_kf`` cameras from y = -12,
    random (keyframe, landmark) observations with pixel noise, and a
    perturbed start (keyframe 0 fixed): ``tests/test_ba.py``'s
    ``_make_problem``, its random draws ``jax.random``'s bit for bit
    (``key`` is a ``utils/prng.py`` key). Returns (problem, T_cw truth,
    points truth)."""
    from fitslam_tpu_torch.data import synthetic
    from fitslam_tpu_torch.ops import ba, lie
    from fitslam_tpu_torch.ops.geometry import project_stereo
    from fitslam_tpu_torch.utils import prng

    K = ba_intrinsics(device)
    kw, kt, ko, kp, kq = prng.split(key, 5)
    pts = synthetic.make_landmark_field(kw, n_lm, extent_xy=8.0, z_range=(0.0, 3.0),
                                        device=device).landmarks
    x = torch.linspace(-3.0, 3.0, n_kf, device=device)
    t_wc = torch.stack([x, torch.full_like(x, -12.0), torch.full_like(x, 1.5)], dim=-1)
    fwd = torch.tensor([0.0, 1.0, 0.0], device=device).expand(n_kf, 3)
    down = torch.tensor([0.0, 0.0, -1.0], device=device).expand(n_kf, 3)
    right = torch.linalg.cross(down, fwd)
    T_cw_gt = lie.inverse(lie.SE3(torch.stack([right, down, fwd], dim=-1), t_wc))

    up = lambda a: torch.from_numpy(a).to(device)
    kf_idx = up(prng.randint(ko, (n_obs,), 0, n_kf))
    lm_idx = up(prng.randint(prng.fold_in(ko, 1), (n_obs,), 0, n_lm))
    kf, lm = kf_idx.long(), lm_idx.long()
    p_c = lie.apply(lie.SE3(T_cw_gt.R[kf], T_cw_gt.t[kf]), pts[lm])
    uvr, ok = project_stereo(K, p_c)
    vis = ok & (p_c[..., 2] > 0.5) & (p_c[..., 2] < 20.0)
    uvr = uvr + up(np.float32(noise_px) * prng.normal(kq, tuple(uvr.shape)))
    obs = ba.Observations(kf=kf_idx.to(torch.int32), lm=lm_idx.to(torch.int32), uvr=uvr,
                          sigma2=torch.full((n_obs,), noise_px ** 2 + 0.25, device=device),
                          valid=vis)
    # everything perturbed but keyframe 0 (the gauge)
    dT = lie.se3_exp(up(np.float32(pose_noise) * prng.normal(kt, (n_kf, 6))))
    T_init = lie.compose(dT, T_cw_gt)
    R0, t0 = T_init.R.clone(), T_init.t.clone()
    R0[0], t0[0] = T_cw_gt.R[0], T_cw_gt.t[0]
    pts_init = pts + up(np.float32(point_noise) * prng.normal(kp, tuple(pts.shape)))
    fixed_kf = torch.arange(n_kf, device=device) == 0
    fixed_lm = torch.zeros((n_lm,), dtype=torch.bool, device=device)
    return ba.BAProblem(lie.SE3(R0, t0), pts_init, obs, fixed_kf, fixed_lm), T_cw_gt, pts


def bench_ba(small: bool, device="cuda", capture: bool = True):
    """Gauss-Newton iterations a second of ``ops/ba.bundle_adjust`` (8
    iterations a solve, 3 solves timed after two untimed: the captured
    solve's warm-up and capture) at the local-window and the global-map
    sizes of ``make_ba_problem`` (key 7), through ``ba.BundleAdjuster``:
    one captured program a solve, as the reference compiles one
    (``capture=False``: plain PyTorch)."""
    from fitslam_tpu_torch.ops import ba
    from fitslam_tpu_torch.utils import prng

    dev = resolve_device(device)
    K = ba_intrinsics(dev)
    table = BA_SIZES_SMALL if small else BA_SIZES
    extra, iters, reps = {}, 8, 3
    for name, sz in table.items():
        prob, _, _ = make_ba_problem(prng.prng_key(7), **sz, device=dev)
        solve = ba.BundleAdjuster(dev, sz["n_kf"], sz["n_lm"], sz["n_obs"], iters=iters,
                                  capture=capture)
        for _ in range(2):
            solve(K, prob)
        t0 = clock(dev)
        for _ in range(reps):
            _, stats = solve(K, prob)
        wall = clock(dev) - t0
        extra[name] = {"iters_per_s": round(reps * iters / wall, 2), **sz,
                       "final_chi2": round(float(stats.chi2[-1]), 2)}
    return _emit("ba_iters_per_s_local", extra["local"]["iters_per_s"], "iters/s",
                 extra["local"]["iters_per_s"] / 10.0, _tagged(extra, dev))


SCALING_RANKS = (1, 2, 8)
SCALING_ITERS = 6


def scaling_rank(ranks, n_kf, n_lm, n_obs, iters, capture=True):
    """On every rank of a launch: for each n of ``ranks``, the landmark-
    sharded BA on the first n ranks (two untimed solves: the mesh's regions
    run eagerly in the first and are captured in the second; then 3 timed,
    or 1 at the largest n), then one solve with ``Mesh.timed`` set for the
    collectives' count and time.
    ``capture=False``: the solver as plain PyTorch. Returns {n: figures, the
    captured regions' stats among them} on the meshes' first rank, {}
    elsewhere."""
    from fitslam_tpu_torch.parallel import dist_ba
    from fitslam_tpu_torch.parallel import mesh as mesh_mod
    from fitslam_tpu_torch.utils import prng

    out, prob = {}, None
    for n in ranks:
        mesh = mesh_mod.make_mesh(n)
        if mesh.rank < 0:
            continue
        if prob is None:
            K = ba_intrinsics(mesh.device)
            prob, _, _ = make_ba_problem(prng.prng_key(7), n_kf, n_lm, n_obs, device=mesh.device)
        reps = 1 if n == max(ranks) else 3
        packed = dist_ba.shard_problem_by_landmark(prob, n)
        solve = lambda: dist_ba.landmark_sharded_bundle_adjust(mesh, K, packed, iters=iters,
                                                               capture=capture)
        for _ in range(2):
            solve()
        t0 = clock(mesh.device)
        for _ in range(reps):
            _, chis = solve()
        t = (clock(mesh.device) - t0) / reps
        mesh.timed, mesh.stats = True, {"collectives": 0, "seconds": 0.0}
        solve()
        if mesh.rank == 0:
            out[n] = {"t_s": t, "chi2": float(chis[-1]),
                      "collectives_per_iter": mesh.stats["collectives"] / iters,
                      "collectives_ms_per_iter": mesh.stats["seconds"] / iters * 1e3,
                      "regions": {name: owner.state.stats()
                                  for name, owner in mesh.solvers.items()}}
    return out


def bench_scaling(small: bool, device="cuda", backend: str = "gloo", ranks=SCALING_RANKS,
                  capture: bool = True):
    """Landmark-sharded BA (``parallel/dist_ba``) over 1, 2 and 8 ranks
    spawned by ``parallel/mesh.launch`` (one launch; the mesh of n is its
    first n ranks; with nccl at most one a card) on the reference's problem (256 / 8192 / 32768; --small
    64 / 4096 / 16384): the time of a solve on 1 and 2 ranks,
    ``efficiency_2dev = t1 / t2 / 2``, chi2 at every size, the coupling
    tensor's bytes a rank, the bytes summed over the ranks an iteration, and
    the port's collectives' count and ms an iteration. With gloo every rank
    shares card 0 (``ranks_share_card``: the ranks time-slice one card, so
    the efficiency is not a scaling figure); with nccl rank r owns card r."""
    from fitslam_tpu_torch.parallel import mesh as mesh_mod

    dev = resolve_device(device)
    kf, lm, obs = (64, 4096, 16384) if small else (256, 8192, 32768)
    if dev.type == "cuda" and backend == "nccl":
        # one rank a card: the largest mesh is as many ranks as the host has cards
        n_cards = torch.cuda.device_count()
        ranks = tuple(sorted({r for r in ranks if r <= n_cards} | {min(max(ranks), n_cards)}))
    n_max = max(ranks)
    if dev.type == "cpu":
        rank_device, note = "cpu", "ranks on the CPU, one thread each"
    elif backend == "nccl":
        rank_device, note = "cuda", "one rank a card"
    else:
        rank_device = str(torch.device("cuda", dev.index or 0))
        note = ("every rank shares card 0 over gloo, whose collectives pass through the "
                "host: the ranks time-slice one card, so the efficiency is not a scaling "
                "figure")
    share = rank_device.startswith("cuda:") and n_max > 1
    res = mesh_mod.launch(scaling_rank, n_max, tuple(ranks), kf, lm, obs, SCALING_ITERS,
                          capture, backend=backend, device=rank_device, timeout=1500)[0]
    t1, t2 = res[1]["t_s"], res[2]["t_s"]
    stats = {"t1_s": round(t1, 3), "t2_s": round(t2, 3), "speedup_2dev": round(t1 / t2, 3),
             "efficiency_2dev": round(t1 / t2 / 2, 3),
             **{f"chi2_{n}dev": round(res[n]["chi2"], 2) for n in ranks}}
    # a rank's share of the coupling tensor Y (K, L/n, 6, 3) float32: the
    # memory the landmark sharding exists to cut
    y_bytes = kf * lm * 6 * 3 * 4
    chis = [res[n]["chi2"] for n in ranks]
    return _emit("dist_ba_scaling_efficiency_2dev", stats["efficiency_2dev"], "fraction",
                 stats["efficiency_2dev"] / TARGET_EFFICIENCY, _tagged({
                     **stats,
                     "problem": {"n_kf": kf, "n_lm": lm, "n_obs": obs},
                     "coupling_Y_bytes_per_dev": {"1dev": y_bytes,
                                                  f"{n_max}dev": y_bytes // n_max},
                     # one blocks pass and one scalar chi2 an iteration cross the ranks
                     "bytes_psum_per_iter": {
                         "Hpp_K66": kf * 36 * 4, "bp_K6": kf * 6 * 4,
                         "S_KK66": kf * kf * 36 * 4, "b_schur_K6": kf * 6 * 4,
                         "chi2_scalars": 8,
                         "total": kf * 36 * 4 + kf * 6 * 4 + kf * kf * 36 * 4 + kf * 6 * 4 + 8,
                     },
                     "chi2_parity_all_mesh_sizes": max(chis) - min(chis) < 1.0,
                     "collectives_per_iter": {f"{n}dev": res[n]["collectives_per_iter"]
                                              for n in ranks},
                     "collectives_ms_per_iter": {
                         f"{n}dev": round(res[n]["collectives_ms_per_iter"], 3) for n in ranks},
                     "backend": backend,
                     "ranks_share_card": share,
                     "note": note,
                 }, dev))


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

# ((H, W), keypoints) of the bench's four pyramid levels (1024 features at 640x480)
DESCRIBE_LEVELS = (((480, 640), 546), ((336, 448), 273), ((240, 320), 137), ((168, 224), 68))
DESCRIBE_LEVELS_SMALL = (((240, 320), 256), ((168, 224), 128))
EDGE = 16   # ops/orb.py's border margin
K3_CASES = ((64, 192), (320, 512), (512, 512))


def _time_ms(fn, dev, reps: int = 50, warmup: int = 5) -> float:
    """Device ms a call of fn(): CUDA events with the queue pre-filled on the
    card; on the CPU the host clock (the CPU is the device there)."""
    if dev.type == "cuda":
        return cuda_time_ms(fn, reps, warmup)[0]
    fn()
    reps = min(reps, 3)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def _describe_inputs(dev, levels, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    imgs, xys = [], []
    for (h, w), n in levels:
        imgs.append((torch.rand((h, w), generator=g) * 255.0).to(dev))
        xys.append(torch.stack([torch.randint(EDGE, w - EDGE, (n,), generator=g),
                                torch.randint(EDGE, h - EDGE, (n,), generator=g)], -1))
    return imgs, torch.cat(xys).to(torch.int32).to(dev).contiguous(), [n for _, n in levels]


def describe_bytes_ops(levels, n):
    """Bytes (level images, keypoints, angle and bf16 descriptor out) and
    operations of the fused describe: per keypoint the blur (40x32 + 32x32
    outputs of 7 taps), its two bf16 roundings, the moments and the 256 bit
    tests."""
    n_bytes = sum(h * w * 4 for (h, w), _ in levels) + n * 8 + n * (4 + 256 * 2)
    per_kp = (40 * 32 + 32 * 32) * 13 + (40 * 40 + 32 * 32) + 4 * 1024 + 256
    return n_bytes, n * per_kp


def _k2_inputs(dev, na, nb, valid_b=None, seed=2):
    """Random packed descriptors, positions within a 640x480 image and
    pyramid levels; every row valid, the columns of ``valid_b`` valid."""
    from fitslam_tpu_torch.ops.orb import pack_descriptors

    rng = np.random.RandomState(seed)
    t = lambda x: torch.as_tensor(x, device=dev).contiguous()
    pm1 = lambda n: t(np.where(rng.rand(n, 256) < 0.5, 1.0, -1.0).astype(np.float32))
    vb = np.ones(nb, bool) if valid_b is None else valid_b
    return dict(a_bits=pack_descriptors(pm1(na).to(torch.bfloat16)), valid_a=t(np.ones(na, bool)),
                b_bits=pack_descriptors(pm1(nb).to(torch.bfloat16)), valid_b=t(vb),
                xy_a=t(rng.uniform(0, 640, (na, 2)).astype(np.float32)),
                xy_b=t(rng.uniform(0, 640, (nb, 2)).astype(np.float32)),
                level_a=t(rng.randint(0, 4, na).astype(np.int32)),
                level_b=t(rng.randint(0, 4, nb).astype(np.int32)))


def k2_bytes(na, nb, mode):
    """Bytes K2 must move: packed descriptors, validity, positions (gated
    modes), levels (stereo), the gate, and the four outputs."""
    per_row = 32 + 1 + (8 if mode else 0) + (4 if mode == 2 else 0)
    return (na + nb) * per_row + (8 if mode else 0) + 3 * 4 * na + 4 * nb


def bench_kernels(small: bool, device="cuda"):
    """Device time of each hand-written kernel at the main path's shapes (CUDA
    events, the queue pre-filled), beside its plain twin (the tests' path),
    a library yardstick where one exists (K2: the bf16 +-1 ``torch.matmul``
    of its distance product, not the gated top-2) and its bound: K1's fused
    ORB describe (one eye, the bench's four levels), K2 at the window
    (1024x8192), stereo (1024x1024) and loop-verification (1024x20480, no
    gate, 300 valid columns) shapes, K3 at (64, 192), (320, 512) and (512,
    512). Every kernel's result equals its twin's. The metric is K2's window
    time in us (the reference's ``kernel_match_us_at_map_capacity``);
    ``vs_baseline`` is bound / time."""
    from fitslam_tpu_torch.ops import orb
    from fitslam_tpu_torch.ops import pallas_grid as pg
    from fitslam_tpu_torch.ops import pallas_matching as pm

    dev = resolve_device(device)
    out = {}

    def record(name, kernel, plain, b, library=None, reps=50, plain_reps=5):
        k_out, p_out = kernel(), plain()
        same = all(torch.equal(x, y) for x, y in zip(k_out, p_out))
        if not same:
            raise AssertionError(f"{name}: the kernel's result differs from its plain twin's")
        out[name] = {"ms": _time_ms(kernel, dev, reps),
                     "plain_ms": _time_ms(plain, dev, plain_reps),
                     "library_ms": None if library is None else _time_ms(library, dev, reps),
                     **b}

    # K1: the fused describe of one eye
    levels = DESCRIBE_LEVELS_SMALL if small else DESCRIBE_LEVELS
    imgs, xy, counts = _describe_inputs(dev, levels, 99)
    record("K1 describe", lambda: orb.describe_keypoints(imgs, xy, counts),
           lambda: orb.describe_keypoints_plain(imgs, xy, counts),
           bound(*describe_bytes_ops(levels, xy.shape[0]), "f32"))
    out["K1 describe"]["shape"] = (f"one eye, {len(levels)} levels {levels[0][0][0]}x"
                                   f"{levels[0][0][1]}..., N={xy.shape[0]}")

    # K2 at its three callers' shapes
    na = 256 if small else 1024
    gates = {pm.GATE_WINDOW: torch.tensor([24.0 * 24.0, 0.0], device=dev),
             pm.GATE_STEREO: torch.tensor([2.0, 0.2 * 400.0 / 0.3], device=dev),
             pm.GATE_NONE: None}
    verify_valid = np.zeros(20480, bool)
    verify_valid[np.random.RandomState(20480).choice(20480, 300, replace=False)] = True
    k2_cases = (("K2 window", 2048 if small else 8192, pm.GATE_WINDOW, None),
                ("K2 stereo", na, pm.GATE_STEREO, None),
                ("K2 verify", 20480, pm.GATE_NONE, verify_valid))
    for name, nb, mode, vb in k2_cases:
        p = _k2_inputs(dev, na, nb, vb)
        gate = gates[mode]
        a_pm1 = pm._unpack_pm1(p["a_bits"]).to(torch.bfloat16)
        b_pm1 = pm._unpack_pm1(p["b_bits"]).to(torch.bfloat16).T.contiguous()
        record(name, lambda: pm.hamming_top2(**p, mode=mode, gate=gate),
               lambda: pm.hamming_top2_plain(**p, mode=mode, gate=gate),
               bound(k2_bytes(na, nb, mode), 2 * na * nb * 256, "int8"),
               library=lambda: torch.matmul(a_pm1, b_pm1))
        out[name]["shape"] = f"{na}x{nb}"

    # K3: iters Jacobi min-plus sweeps
    for G, iters in (((64, 192),) if small else K3_CASES):
        rng = np.random.RandomState(G)
        step = torch.as_tensor(rng.uniform(0.25, 0.55, (G, G)).astype(np.float32), device=dev)
        passable = torch.as_tensor(rng.rand(G, G) < 0.9, device=dev)
        pot0 = torch.full((G, G), pg.BIG, device=dev)
        pot0[0, 0] = 0.0
        # bytes: pot0, step, out (4 each), passable (1); 5 operations a cell and sweep
        record(f"K3 G={G}", lambda: (pg.wavefront_sweeps(pot0, step, passable, iters),),
               lambda: (pg.wavefront_sweeps_plain(pot0, step, passable, iters),),
               bound(G * G * 13, 5 * G * G * iters, "f32"), reps=20, plain_reps=3)
        out[f"K3 G={G}"]["shape"] = f"({G}, {G}), {iters} sweeps"

    window = out["K2 window"]
    extra = {name: {k: (round(v, 6) if isinstance(v, float) else v) for k, v in r.items()}
             for name, r in out.items()}
    return _emit("kernel_match_us_at_map_capacity", window["ms"] * 1e3, "us",
                 window["bound_ms"] / max(window["ms"], 1e-12), _tagged(extra, dev))


MODES = {
    "loop_slam": bench_loop_slam,
    "kernels": bench_kernels,
    "rgbd_fusion": bench_rgbd_fusion,
    "active_slam": bench_active_slam,
    "marsyard": bench_marsyard,
    "ablation": bench_ablation,
    "ba": bench_ba,
    "scaling": bench_scaling,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The port's benchmark suite: one JSON line a mode.")
    ap.add_argument("--mode", default="all", choices=["all", *MODES])
    ap.add_argument("--small", action="store_true", help="reduced shapes")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--out", default=None, help="also write every record to this JSON file")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo",
                    help="scaling's ranks: gloo (every rank on card 0) or nccl (a card a rank)")
    args = ap.parse_args(argv)
    if args.out and Path(args.out).resolve() == REPO / "BENCH_SUITE.json":
        ap.error("BENCH_SUITE.json is the reference's record; write elsewhere")
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("[bench_suite] no CUDA device: the bench runs on the card (--cpu for the CPU)",
              file=sys.stderr)
        return 1
    records, failed = [], {}
    for name, fn in MODES.items():
        if args.mode not in ("all", name):
            continue
        kw = {"backend": args.backend} if name == "scaling" else {}
        try:
            records.append(fn(args.small, device=device, **kw))
        except Exception as e:   # a mode that fails prints no line; the others run on
            failed[name] = f"{type(e).__name__}: {e}"
            print(f"[bench_suite] mode {name} FAILED: {failed[name]}\n{traceback.format_exc()}",
                  file=sys.stderr)
    if args.out:
        payload = {"recorded_utc": datetime.datetime.now(datetime.timezone.utc).isoformat(
                       timespec="seconds"),
                   "platform": "gpu" if device == "cuda" else "cpu",
                   "device": device_info(device), "small": bool(args.small),
                   "results": records, "failed_modes": failed}
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"[bench_suite] wrote {len(records)} records -> {args.out}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
