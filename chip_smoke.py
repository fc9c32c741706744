"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits non-zero):
  1. environment: torch / CUDA versions, the card's name and power limit, and
     the nvcc build of the four kernels (fitslam_tpu_torch/csrc/*.cu, one
     nvcc per source) and the g++ build of the native host runtime
     (csrc/runtime.cc), all started together;
  2. (two lines) K1's standalone patch gather against its plain twin at the
     bench's four pyramid level shapes, including clamped borders: bit-equal;
     then K1's fused ORB describe (gather, blur, orientation and rBRIEF in one
     launch for all levels) against its twin at the bench's and the golden
     level shapes, with keypoints at and past the border, a level without
     keypoints, one keypoint and a width of 250: angle and descriptor
     bit-equal; timed per eye at the bench's shapes beside the parent
     commit's describe path (K1's gather per level + the PyTorch tail), in
     turns;
  3. K2 (gated Hamming top-2), both designs of its distance product (the
     shipped single-bit tensor-core one and the +-1 int8 one), against its
     plain twin in all three gate modes at 1024 x 8192 and 1024 x 1024 with
     planted matches and ties, and at ragged shapes: exactly equal; both
     designs timed at the main path's two shapes, and the shipped one at
     several column splits;
  4. golden replay of tests/data/corridor_seq through StereoSlam.process_frame:
     ATE <= 0.025 m, 10-30 keyframes, the fused describe and K2 launched;
  5. the headline (fitslam_tpu_torch/bench.py: its configuration, 640x480,
     4 levels, 1024 features, 8192 landmarks, its 60 frames rendered on the
     card, its timed pass): one untimed pass, then three timed passes and
     finalize, each held to ATE <= 0.025 m and 2 fused-describe launches per
     frame (one per eye, no standalone gather); the descriptor bits in which
     the fused kernel and the parent's describe path differ on the 120 images;
  6. K3 (wavefront sweeps) against its plain twin at (G, iters) = (64, 192),
     (320, 512) and (512, 512), on random step costs and on a rooms-world
     maze, through the kernel its size rule picks and through the tiled
     kernel (the first port's), and with the resident kernel's bands
     exchanging rows every 2, 4 or 8 sweeps, and at ragged shapes through the
     size rule's kernel and the grouped exchanges: exactly equal; all timed
     at the main-path shapes, and at G = 64 the resident kernel as one block;
  7. (five lines) rapid-mode exploration at full width (the configured 80 m
     global map at 0.25 m, G = 320, FitSlamConfig.preset("rapid")) through
     ExplorationServer.tick() and SimNavInterface.step() for 300 steps, then
     the G = 64 configuration of bench_suite.py::bench_ablation with each of
     its three cost methods (arrival info + roadmap, RandomCosts,
     ClosestFrontier), each held to tests/test_exploration_e2e.py's bounds
     beside the reference's final coverage, the RandomCosts run's draws
     bit-equal to the reference's (tests/data/random_costs_draws.npz);
  8. (two lines) the full active-SLAM loop through ActiveSlamSystem
     (bench_suite.py::bench_active_slam: 640x480, 4 levels, 1024 features,
     48 keyframes / 3072 landmarks, 48 clouds of 4096 points, G = 64 at
     0.25 m over the rooms world of seed 3, a tick every 4 frames, FI
     threshold 5), run on from the bench's 80 frames to the 150 of
     tests/test_active_slam_e2e.py: frames, ticks, keyframes, world-anchored
     ATE, coverage, goals, FI rejections and the largest FI value, and at
     frame 80 beside the reference's own figures; K1/K2/K3 launches and host
     syncs (the engine's count, and torch's with the CUDA-event waits it
     does not report) a frame, tick and controller step, host ms of each, grid fusion
     kernel time, launches and host time a keyframe; the run's clouds fused twice on the card and once
     on the CPU (identical, and the same occupancy), and the card/CPU gap of
     pose_information and path_information; held to
     tests/test_active_slam_e2e.py's bounds. Then bench_suite.py::
     bench_marsyard's loop (320x240, 150 frames) held to
     tests/test_marsyard_e2e.py's bounds;
  9. the RGB-D arc of tests/test_rgbd_e2e.py at 640x480, 4 levels and 1024
     features (process_rgbd_frame, depth_image_to_cloud a keyframe,
     fuse_clouds, threshold_grid, extract_frontiers) held to that file's
     bounds;
 10. (four lines) bench_suite.py::bench_loop_slam's ring at full width
     (seeds 1-3, seed 1 twice and bit-equal), K2's loop-verification call,
     tests/test_atlas.py's scenarios and global BA (card = card, card vs CPU);
 11. corridor_seq through the port's native prefetching reader (byte-equal
     to read_pgm), run_dataset.replay in this process and ``python -m
     fitslam_tpu_torch.run_dataset`` as a subprocess on the card (ATE <=
     0.025 m, an events.csv of more than 10 spans), then the committed
     indoor_tum through TumRgbdSequence and process_rgbd_frame held to
     tests/test_dataset_external.py's bounds (ATE <= 0.13 m, 8-30 keyframes);
 12. phase 8's active cell for 80 frames with the EKF on (the robot's pose
     from its estimate, twists through a TwistMux), once (phase 18 holds
     three more runs of it bit-equal), held to tests/test_ekf_integration.py's
     bounds and the active bounds at frame 80, the EKF window kernel's
     launches over the run equal to the windows fused, then that file's
     dropout at full width; (a second line) the EKF window kernel beside
     its twin on the card, one 64-row window: x within 1e-5, P within rtol
     1e-5 / atol 1e-6, the device us a window of the kernel and of the
     twin's captured graph, that graph's kernels and the window's bound;
     the cost of a flush (2 filters x 64 rows) and the host ms beside
     phase 8's;
 13. (seven lines) the multi-robot fleet through the port's entry points:
     ``run_multirobot.run`` (one MultiRobotCoordinator, R wavefronts a
     tick) for tests/test_allocation.py's two-rover runs (hungarian,
     minpos; 80 of its 120 steps) and four rovers (hungarian, and the
     auction through the config, 60 steps each), each with coverage, path
     lengths, host ms, host syncs and K3
     launches a tick, the auction's rounds and syncs a solve, and its first
     10 ticks' cost matrices and assignments equal to the same run's on the
     CPU; the auction alone on 32 (16, 256) problems within R eps of the
     Hungarian's optimum; then ``run_multirobot_slam.run_fleet`` (a full
     ActiveSlamSystem a rover) for 2 and 1 rovers held to
     tests/test_multirobot_slam.py's bounds, and for 3, with each rover's
     host ms, K1 / K2 / K3 launches and host syncs a frame and a tick;
 14. (five lines) the user entry points: ``python -m
     fitslam_tpu_torch.run_active_slam --frames 60 --checkpoint --record``
     as a subprocess (exit 0, i.e. the example's ATE < 0.5 m; coverage,
     ATE, keyframes, goals, frames/s and the kernels' launches it prints;
     the checkpoint and the four artifacts written); resume in process
     (StereoSlam saved at frame 40 and a fresh engine tracking the next 20
     frames within 1e-5 of the uninterrupted one, bit-equality reported;
     the active system saved at frame 40 and restored: occupancy, roadmap,
     frame id and ticks equal after both re-stitch, the next frame tracked
     with > 10 inliers; file MB, save and load ms); the live view on port 0
     during a 6-frame run (status, map.png, pause and resume reaching the
     explorer); ``python -m fitslam_tpu_torch.run_vo`` at its defaults, then
     its ``--export-dataset`` replayed with ``--dataset`` (ATE < 0.10 m
     aligned, < 0.3 m unaligned, the replay's keyframes equal the synthetic
     run's); the three committed worlds drawn again on the host by
     ``utils/prng.py`` equal to their files.
 15. (five lines) the sharded solvers of fitslam_tpu_torch/parallel/ over
     ranks spawned on the card (gloo, every rank on card 0): on phase 10's
     seed-1 map, slam_map.global_ba_dist over 2 and 4 ranks against
     global_ba on one (ms an iteration, the collectives' ms in it, peak
     memory a rank), the observation-sharded BA against bundle_adjust,
     edge-sharded PGO on the map's odometry, covisibility and loop edges
     against optimize_pose_graph, each solver over 2 ranks eager and
     captured in one launch (every solve bit-equal, host ms an iteration,
     host kernel and graph launches a solve, each region's capture s and
     pool MB; the GBA over 4 ranks captured only);
     phase 8's clouds fused
     point-sharded (counts, z extrema and cost equal to one rank's) and its
     frontiers raycast frontier-sharded (exact), each 3 times eager and 3
     captured (bit-equal; host ms a call, warm-up, capture and replay);
     stage_pipelined_slam at bench width over 20 frames eager and captured
     (bit-equal) against the sequential path on one rank, eager and a
     StereoSlam replaying (poses within 1e-4, keyframes and inliers equal,
     K1 exactly 2 a frame on rank 0; frames/s of each, host kernel and graph
     launches a frame on each rank); phase 10's held correction and a
     3-cycle refine_map on engines whose loop closer has a 2-rank mesh
     (eager; captured, eager counts 1: bit-equal; host ms of each); two ``python -m
     fitslam_tpu_torch.parallel.multihost`` processes and ``python -m
     fitslam_tpu_torch.parallel.dryrun 2``.
 16. (ten lines) the measurement entry points: ``python -m
     fitslam_tpu_torch.bench`` as a subprocess (exit 0, one JSON line with
     the reference's keys, ATE <= 0.025 m, a loop closed in its loop_slam
     block; frames/s beside phase 5's), ``python -m
     fitslam_tpu_torch.bench_suite --mode ba`` (captured) as a subprocess
     and ``ba.BundleAdjuster`` bit-equal to ``bundle_adjust``, the scaling
     mode in full (captured; the regions' capture s and pool MB a rank at 1,
     2 and 8 ranks; ``tools/solvers_ab.py`` holds both modes against
     ``capture=False``), the kernels mode in full and rgbd_fusion,
     active_slam, marsyard and
     ablation at full width and cut depth in this process (each record's
     keys the reference's, platform gpu, the modes' K1/K2/K3 launches
     counted, the reference's committed artifacts byte-identical after),
     then graft_entry.entry()'s step on the card against the CPU's (F5's
     tolerances; 2 describes and K2 a step).
 17. (three lines) the captured frame step (fitslam_tpu_torch/utils/jit.py:
     StereoSlam's five regions as CUDA graphs) at the headline's
     configuration (640x480, 4 levels, 1024 features, 8192 landmarks, loop
     closing and relocalization on) over its 60 frames through
     bench.timed_pass, eager (``capture=False``) and captured in turns
     (eager, captured, captured; the second captured engine takes the first
     one's graphs): poses bit-equal, the final maps and the outs_log
     values equal, K1 and K2 launches equal; frames/s and host ms a frame of
     each pass, each region's calls, capture seconds and graph pool GB; then
     torch.profiler over frames 20-39 of each mode: kernels and host
     launches (kernels, graphs) a frame and the device's busy share.
 18. (five lines) the active loop's other captured programs (DualEkf's
     windows, ExplorationServer's overlay and tick, ActiveSlamSystem's
     fusion) in phase 12's cell, ActiveSlamSystem(capture=False), then
     capture=True twice (the second system takes the first one's graphs):
     the EKF trajectory and P, the goals, the explorer's counts and roadmap,
     the grid, the SLAM poses and K3's launches bit-equal; host ms a flush,
     tick, frame and keyframe's fusion in each mode; torch.profiler over
     flushes and ticks of each mode (kernels, host launches, the launches
     after the tick's packed read, the flush's top kernels); the bytes a
     captured tick copies in; each new region's capture seconds and pool
     MB;
 19. (three lines) the controller's, the loop closer's and the fleet's
     captured programs (SimNavInterface's plan and both costmaps' composition,
     the loop closer's verification and correction and refine_map's cycle,
     the coordinator's region and the allocator's auction and MinPos), each
     area with capture=False, then captured twice (the second owner takes
     the first one's graphs): phase 7's G = 320 loop over steps 0-129
     (poses, path, goals, counts, coverage, plans, K3 launches bit-equal;
     host ms a controller step and a tick over steps 80-119; torch.profiler
     over steps 120-129: kernels and host launches, kernels and graphs, a
     step, busy share); phase 10's first correction of seed 1 again from
     the map and state it had just before, and a 3-cycle refine_map, eager
     then warm-up, capture and replay (map, state, records, loop edges, chi2,
     K2 launches bit-equal; host ms), PGO and GBA alone on that map (host ms
     an iteration eager and replayed); phase 13's four-rover auction fleet
     for 20 ticks and its 32 (16, 256) auction problems (cost matrices,
     assignments, rounds, paths bit-equal; host ms a tick, a solve, a
     round); each new region's capture seconds and pool.
 20. (five lines) the simulation's and the tick tail's captured programs
     (RevealSensor's reveal, SimCamera's camera and camera+rgbd, the
     server's publish, los, goal_cell, recovery, evict, wedge and clear,
     ActiveSlamSystem's restitch) against capture=False: the G = 64
     ablation world for 120 steps (poses, paths, plans, goals, explored maps
     and published paths bit-equal; host ms a reveal, a published path, a
     tick), the tail's regions alone on its servers (reads and writes
     bit-equal; host ms eager, warm-up, capture and replay, and the calls
     after which a capture pays), the 640x480 camera alone (stereo with its
     cloud, RGB-D; bit-equal, a held cloud and depth image unchanged 4
     frames on), phase 8's loop for 40 frames with 5 forced re-stitches
     (path, trajectory, goals, clouds, statistics and grids bit-equal;
     frames/s, host ms), and ``--mode active_slam`` / ``marsyard`` cut to
     40 frames (frames/s of each mode); each new region's capture seconds
     and pool.
Every phase from 4 on runs StereoSlam, the EKF, the tick and its tail, the
fusion and the re-stitch, the costmaps, the plan, loop closing, the
coordinator, the allocators, the simulated camera and the reveal sensor
captured, their default.
Phases 5, 7, 8, 10 and 12 drive the bench's own loops (bench.timed_pass,
bench_suite.explore_run, active_loop and ring_run) and measure them through
the loops' ``window`` hook, so the loop a mode times is the loop a phase
holds to its bounds.
Then a JSON line with every kernel's launches (K1/K2 from the last timed
pass of phase 5, K3 from the G = 320 run of phase 7, the EKF window from
phase 12's run; ``launches_by_path``
gives each path's run: bench, explore, ablation, active, marsyard, rgbd,
loop, dataset, tum, ekf, fleet, fleet_slam, active_entry, vo, stage: the
pipeline's ranks summed, bench_modes: phase 16's in-process modes,
graft_step: one entry() step, captured: phase 17's second captured
pass, loops: phase 18's last captured pass, control: phase 19's last
captured pass of each area, and sim: phase 20's captured loop), error,
device times (CUDA events; level-0, one eye's four levels, window 1024x8192, G = 320
and one 64-row EKF window shapes) of the kernel,
its plain twin, the first port's kernel where it is still in the tree (K3's
tiled kernel) and a PyTorch yardstick where one exists, and its bound; the card's
``nvidia-smi`` line; and as the last line ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --profile [--tree DIR]

runs phase 1 and, instead of phases 2-7, ``torch.profiler`` windows, each
twice: over bench frames 20-39 of phase 5's loop (kernel launches a frame,
the device's busy share, the describe path's share and the top kernels by
time) and over steps 120-159 of phase 7's G = 320 loop (busy share, kernel
launches a step, K3's share of the kernel time, top kernels). ``--tree DIR``
imports the package from DIR instead, e.g. the parent commit unpacked by
``git archive``, for a before/after in one call.

There is no CPU path: without a CUDA device the script exits with an error.
"""

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
import warnings
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np
import torch

# the smoke run and the bench time and bound kernels in one way, build
# the same configurations, and the phases drive the bench's own loops, their
# windows measured through the loops' ``window`` hook
from fitslam_tpu_torch.bench import headline_config, headline_frames, timed_pass
from fitslam_tpu_torch.bench_suite import (ABLATION_METHODS, ABLATION_SPEC, ABLATION_START, EDGE,
                                           TICK_EVERY, ablation_config, active_config,
                                           active_loop, active_system, ate_world, bound,
                                           camera_matrices, cuda_time_ms, describe_bytes_ops,
                                           explore_run, k2_bytes, lethal_scores, loop_config,
                                           ring_run, rooms_world)

ROOT = Path(__file__).resolve().parent
ATE_BOUND_M = 0.025
GOLDEN_KF_RANGE = (10, 30)
# tests/test_dataset_external.py's golden bounds for indoor_tum (its golden:
# 0.063 m, 18 keyframes)
TUM_ATE_BOUND_M = 0.13
TUM_KF_RANGE = (8, 30)
N_BENCH_FRAMES = 60
N_TIMED_PASSES = 3
KERNELS = ("patch_gather", "hamming_top2", "wavefront_sweep", "ekf_window")
K3_CASES = ((64, 192), (320, 512), (512, 512))
# (H, W, iters): non-square, one cell, one row, iters not a multiple of the
# tiled kernel's 8, and 513 x 513, the first square grid past the resident size rule
K3_RAGGED = ((333, 250, 300), (1, 1, 5), (1, 300, 9), (90, 90, 64), (100, 37, 21),
             (513, 513, 37))
# the G = 64 grid as one block of 256 threads (no cluster), timed beside the
# size rule's 16-block cluster
K3_ONE_BLOCK = (64, ("resident", 4, 16, 16, 1))
# sweeps between two exchanges of the resident kernel's bands timed beside
# the rule's exchange after every sweep (each with its halo rows)
K3_GROUPS = (2, 4, 8)
# (Na, Nb): the main path's window and stereo shapes, then shapes that are
# not multiples of the tensor-core designs' 64-row and 32-column tiles
K2_SHAPES = ((1024, 8192), (1024, 1024), (1, 1), (1, 513), (37, 513), (64, 33), (1000, 8000))
K2_BLOCKS_PER_SM = (2, 4, 8)  # column splits of the shipped design timed at 1024 x 8192
EXPLORE_STEPS = 300
# ((H, W), keypoints) of each pyramid level: the bench's 4 levels (1024
# features at 640x480) and the golden replay's 2 (512 features at 320x240)
BENCH_LEVELS = (((480, 640), 546), ((336, 448), 273), ((240, 320), 137), ((168, 224), 68))
GOLDEN_LEVELS = (((240, 320), 341), ((168, 224), 171))
PROFILE_FRAMES = (20, 40)  # bench frames that --profile traces
PROFILE_WINDOW = (120, 160)  # steps of the G = 320 loop that --profile traces
# the final coverage of each of bench_suite.py::bench_ablation's three cost
# methods at step 299 in the reference's own run (the last row of
# ABLATION_COVERAGE.csv), printed beside the port's and not asserted
REFERENCE_ABLATION_COVERAGE = {"arrival_info_roadmap": 0.9302, "random": 0.9282,
                               "closest": 0.9302}
# the reference's RandomCosts draws (jax.random) for ticks 0-150 at F = 64
RANDOM_COSTS_DRAWS = ROOT / "tests" / "data" / "random_costs_draws.npz"
# phases 8-9: bench_suite.py's active-SLAM and marsyard runs and the RGB-D arc.
# The active run goes on past the bench's 80 frames to the 150 of
# tests/test_active_slam_e2e.py, whose bounds (the robot's extent above all)
# belong to that length; its figures at frame 80 stand beside the reference's.
ACTIVE_BENCH_FRAMES = 80
ACTIVE_FRAMES = 150
# the windows of a step of bench_suite.active_loop: the frame, the tick (every
# TICK_EVERY frames), the controller step and, with the EKF on, the read of
# its estimate
WINDOWS = ("frame", "tick", "ctrl", "pose")
MARSYARD_FRAMES = 150
RGBD_FRAMES = 40
# the reference's own runs of the same loops (BENCH_SUITE.json, config 4 at
# 640x480 and the marsyard run at 320x240): accuracy and coverage only,
# printed beside the port's and not asserted
REFERENCE_ACTIVE = {"ate_m": 0.0062, "coverage": 0.398, "goals": 3, "fi_rejections": 0,
                    "keyframes": 31}
REFERENCE_MARSYARD = {"lethal_precision": 1.0, "violations": 0, "coverage": 0.733, "goals": 10}
# phase 13: examples/run_multirobot.py's fleet as (allocator, rovers, steps):
# tests/test_allocation.py's two-rover runs, then four rovers with the
# Hungarian and the auction (through the config); the first ticks of each
# also on the CPU, which must give the same cost matrices and assignments.
# Depth cut to pay for phase 15's captured paths: 80 steps of the two-rover
# runs' 120 (coverage 0.93 at step 80 on the CPU), 60 of the four-rover
# Hungarian's 150
FLEET_RUNS = (("hungarian", 2, 80), ("minpos", 2, 80), ("hungarian", 4, 60),
              ("auction", 4, 60))
FLEET_PARITY_TICKS = 10
# the auction alone: (R, F) problems against the Hungarian's optimum
AUCTION_PROBLEMS = 32
AUCTION_SHAPE = (16, 256)
# examples/run_multirobot_slam.py's fleet: frames of each run
FLEET_SLAM_STEPS = 100
# phase 10: bench_suite.py::bench_loop_slam as bench.py runs it (150 ring
# frames, the committed worlds of seeds 1-3, a pipelined poll every 4 frames)
LOOP_FRAMES = 150
LOOP_SEEDS = (1, 2, 3)
# K2's loop-verification call: a keyframe's 1024 features against the whole
# landmark table, and a ragged shape
LOOP_K2_SHAPES = ((1024, 20480), (1000, 20001))
BA_ITERS = 15
# card vs CPU bundle_adjust on a small problem: poses (m), points (m)
BA_CPU_TOL = (1e-4, 1e-3)
# the reference's own loop runs (BENCH_r05.json, loop_slam.per_seed): accuracy,
# loops and keyframes only, printed beside the port's and not asserted
REFERENCE_LOOP = {
    1: {"ate_rmse_m": 0.1714, "ate_rmse_pre_refine_m": 0.2336, "ate_rmse_uncorrected_m": 0.1605,
        "loops_closed": 3, "n_keyframes": 78},
    2: {"ate_rmse_m": 0.088, "ate_rmse_pre_refine_m": 0.1413, "ate_rmse_uncorrected_m": 0.1569,
        "loops_closed": 3, "n_keyframes": 78},
    3: {"ate_rmse_m": 0.0765, "ate_rmse_pre_refine_m": 0.1505, "ate_rmse_uncorrected_m": 0.1571,
        "loops_closed": 3, "n_keyframes": 78},
}


def log(msg: str) -> None:
    print(msg, flush=True)


# seconds and calls at the start of a short profiler window spent on calls
# it does not count
PRIME_S, PRIME_CALLS = 1.0, 16
MEASURED = "chip_smoke.measured"


def prime_window(fn):
    """Inside an open profiler window, call fn() for PRIME_S seconds and at
    least PRIME_CALLS times, then synchronize, before the calls the window
    counts (which run inside ``record_function(MEASURED)``). The profiler
    drops a window's earliest device records, the more the older the process
    (four 1-ms EKF flushes ~15 minutes into this script kept none; a fresh
    process keeps all), so only the records after the mark are counted
    (``measured_since``)."""
    t0, n = time.perf_counter(), 0
    while n < PRIME_CALLS or time.perf_counter() - t0 < PRIME_S:
        fn()
        n += 1
    torch.cuda.synchronize()


def measured_since(prof) -> float:
    """The start (profiler us) of the window's MEASURED range."""
    return min(e.time_range.start for e in prof.events() if e.name == MEASURED)


def kernel_sum(fn, reps: int = 10):
    """(device ms, kernel launches) a call of fn(), summed over the kernels
    that a torch.profiler window of ``reps`` calls records (after
    ``prime_window``): the device's own work, whatever the host's pace."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        prime_window(fn)
        with torch.profiler.record_function(MEASURED):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    k = _kernel_times(prof, measured_since(prof))
    return sum(t for t, _ in k.values()) / reps / 1e3, sum(n for _, n in k.values()) / reps


def _us(t) -> str:
    return f"{t[0] * 1e3:.1f} us device / {t[1] * 1e3:.1f} us wall"


def phase_environment():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    from fitslam_tpu_torch.utils import cuda_build

    from fitslam_tpu_torch.runtime import native

    def timed(fn, *args):
        t = time.monotonic()
        fn(*args)
        return time.monotonic() - t

    t0 = time.monotonic()
    # one nvcc a kernel source and g++ for the host runtime, all started together
    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:
        host = pool.submit(timed, native.load_library)
        list(pool.map(cuda_build.load_kernel_library, KERNELS))
        host_s = host.result()
    build_s = time.monotonic() - t0
    ptxas = [ln.strip() for name in KERNELS
             for ln in cuda_build.build_log(name).splitlines() if "registers" in ln]
    log(f"[1 env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} | {smi} | kernels and the native runtime "
        f"built in {build_s:.1f} s (g++ {cuda_build.build_host_library()[0].name}: "
        f"{host_s:.1f} s); ptxas: {' / '.join(ptxas) or 'cached build'}")
    return smi


def phase_k1(dev):
    from fitslam_tpu_torch.ops.pallas_patches import gather_patches, gather_patches_plain

    g = torch.Generator(device="cpu").manual_seed(1)
    shapes = [((480, 640), 546), ((336, 448), 273), ((240, 320), 137), ((168, 224), 68)]
    worst = 0.0
    for (h, w), n in shapes:
        img = (torch.rand((h, w), generator=g) * 255.0).to(dev)
        # keypoints across the whole image and beyond it: starts are clamped
        xy = torch.stack([torch.randint(-30, w + 30, (n,), generator=g),
                          torch.randint(-30, h + 30, (n,), generator=g)], dim=-1)
        xy = xy.to(torch.int32).to(dev).contiguous()
        got = gather_patches(img, xy, 40)
        ref = gather_patches_plain(img, xy, 40)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"K1 differs from its twin at {(h, w)} N={n}: "
                                 f"max |d| {(got - ref).abs().max().item()}")
        worst = max(worst, (got - ref).abs().max().item())
    # time at the main path's level shapes (keypoints inside the EDGE margin)
    times = []
    for (h, w), n in shapes:
        img = (torch.rand((h, w), generator=g) * 255.0).to(dev)
        xy = torch.stack([torch.randint(16, w - 16, (n,), generator=g),
                          torch.randint(16, h - 16, (n,), generator=g)], -1).to(torch.int32).to(dev)
        # yardstick: one advanced-indexing call on the pre-padded image, its
        # index tensors built outside the timing
        padded = torch.nn.functional.pad(img, (20, 20, 20, 20))
        off = torch.arange(40, device=dev)
        rows = (xy[:, 1].long()[:, None] + off)[:, :, None]
        cols = (xy[:, 0].long()[:, None] + off)[:, None, :]
        if not torch.equal(padded[rows, cols], gather_patches(img, xy, 40)):
            raise AssertionError(f"K1's indexing yardstick computes another function at {(h, w)}")
        times.append((cuda_time_ms(lambda: gather_patches(img, xy, 40)),
                      cuda_time_ms(lambda: gather_patches_plain(img, xy, 40)),
                      cuda_time_ms(lambda: padded[rows, cols])))
    per_level = "; ".join(f"{h}x{w} N={n}: kernel {_us(k)}, plain {_us(p)}, indexing {_us(x)}"
                          for ((h, w), n), (k, p, x) in zip(shapes, times))
    (h, w), n = shapes[0]
    b = bound(h * w * 4 + n * 2 * 4 + n * 40 * 40 * 4)
    log(f"[2 K1] bit-equal to its twin at 4 level shapes (tolerance 0, max |d| {worst}); "
        f"{per_level}; bound at {h}x{w} N={n} {b['bound_ms'] * 1e3:.2f} us ({b['bound_by']})")
    return {"max_abs_err": worst, "ms": times[0][0][0], "plain_ms": times[0][1][0], **b,
            "library_ms": times[0][2][0],
            "library_call": "padded[rows, cols], index tensors built outside the timing"}


def _describe_problem(dev, levels, seed, integer=False, border=False):
    """Level images of random grey levels (8-bit with ``integer``) and their
    keypoints inside the EDGE margin; with ``border`` the first of each level
    sit on the margin (windows reach 4 pixels past the image), on the image's
    edge and 30 pixels beyond it (windows clamped as lax.dynamic_slice does)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    imgs, xys = [], []
    for (h, w), n in levels:
        img = torch.rand((h, w), generator=g) * 255.0
        imgs.append((img.floor() if integer else img).to(dev))
        xy = torch.stack([torch.randint(EDGE, max(EDGE + 1, w - EDGE), (n,), generator=g),
                          torch.randint(EDGE, max(EDGE + 1, h - EDGE), (n,), generator=g)], -1)
        if border:
            edge = torch.tensor([(EDGE, EDGE), (w - 1 - EDGE, h - 1 - EDGE), (EDGE, h - 1 - EDGE),
                                 (w - 1 - EDGE, EDGE), (0, 0), (w - 1, h - 1), (-30, h // 2),
                                 (w + 30, h // 2), (w // 2, -30), (w // 2, h + 30)])[:n]
            xy[:len(edge)] = edge
        xys.append(xy)
    xy = torch.cat(xys).to(torch.int32).to(dev).contiguous()
    return imgs, xy, [n for _, n in levels]


def parent_describe(levels, xy, counts, consts):
    """The parent commit's describe path, timed and compared beside the fused
    kernel: per level K1's standalone gather, then ops/orb.py's PyTorch tail
    as it was (bf16 round trip, the blur as two einsums, the crop, the
    centroid as a float32 matmul, atan2, the bin, the pair gathers)."""
    from fitslam_tpu_torch.ops.pallas_patches import gather_patches

    blur, w_centroid, pairs_all = consts
    angs, descs = [], []
    for img, xy_l in zip(levels, torch.split(xy, list(counts))):
        patches_g = gather_patches(img, xy_l, 40)
        pg = patches_g.to(torch.bfloat16).float()
        smooth = torch.einsum("npq,qs->nps", pg, blur)
        smooth = torch.einsum("nps,pr->nrs", smooth, blur)
        raw = patches_g[:, 4:36, 4:36]
        m = raw.reshape(raw.shape[0], 1024) @ w_centroid
        ang = torch.atan2(m[:, 1], m[:, 0])
        bin_f = torch.round(ang / (2.0 * math.pi) * 30).long() % 30
        flat = smooth.reshape(raw.shape[0], 1024).to(torch.bfloat16).float()
        pairs = pairs_all[bin_f]
        sel = torch.gather(flat, 1, pairs[:, :, 0]) - torch.gather(flat, 1, pairs[:, :, 1])
        angs.append(ang)
        descs.append(torch.where(sel < 0, 1.0, -1.0).to(torch.bfloat16))
    return torch.cat(angs), torch.cat(descs)


def parent_constants(dev):
    from fitslam_tpu_torch.ops import orb

    return (torch.as_tensor(orb._BLUR_MATRIX, device=dev).bfloat16().float(),
            torch.as_tensor(orb._W_CENTROID, device=dev),
            torch.as_tensor(orb._ROTATED_PAIRS, device=dev))


def phase_describe(dev):
    from fitslam_tpu_torch.ops import orb

    cases = [("bench", BENCH_LEVELS, dict(border=True)),
             ("bench 8-bit", BENCH_LEVELS, dict(integer=True, border=True)),
             ("golden", GOLDEN_LEVELS, dict(border=True)),
             ("golden 8-bit", GOLDEN_LEVELS, dict(integer=True)),
             ("empty level", (BENCH_LEVELS[0], (BENCH_LEVELS[1][0], 0)) + BENCH_LEVELS[2:], {}),
             ("N=1", (((480, 640), 1),), {}),
             ("width 250", (((333, 250), 300), ((235, 177), 60), ((100, 37), 5)),
              dict(border=True))]
    worst, cases_n = 0.0, []
    for k, (name, levels, kw) in enumerate(cases):
        imgs, xy, counts = _describe_problem(dev, levels, 10 + k, **kw)
        before = orb.describe_keypoints.launches
        got = orb.describe_keypoints(imgs, xy, counts)
        torch.cuda.synchronize()
        if orb.describe_keypoints.launches != before + 1:
            raise AssertionError(f"fused describe did not count one launch at {name}")
        ref = orb.describe_keypoints_plain(imgs, xy, counts)
        worst = max(worst, (got[0] - ref[0]).abs().max().item(),
                    (got[1].float() - ref[1].float()).abs().max().item())
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise AssertionError(
                f"fused describe differs from its twin at {name}: "
                f"{int((got[0] != ref[0]).sum())} angles, "
                f"{int((got[1] != ref[1]).any(dim=1).sum())} descriptors")
        cases_n.append(f"{name} N={xy.shape[0]}")
        if name == "bench":
            # the twin on the CPU against the twin on the card (atan2 of two libraries)
            cpu = orb.describe_keypoints_plain([i.cpu() for i in imgs], xy.cpu(), counts)
            twin_cpu = (f"card twin vs CPU twin at bench: {int((cpu[0] != ref[0].cpu()).sum())} "
                        f"angles differ (max {(cpu[0] - ref[0].cpu()).abs().max().item():.1e} rad), "
                        f"{int((cpu[1] != ref[1].cpu()).any(dim=1).sum())} descriptors")
    # PyTorch's division by a CPU scalar on the card (the reciprocal) against
    # a true division, over the angles atan2 returns
    a = torch.linspace(-math.pi, math.pi, 2_000_001, device=dev)
    true_div = a / torch.full_like(a, 2.0 * math.pi)
    by_scalar = a / (2.0 * math.pi)
    cpu_div = a.cpu() / (2.0 * math.pi)
    division = (f"a / 2pi on the card by CPU scalar differs from the true division in "
                f"{int((by_scalar != true_div).sum())} of {a.numel()} angles, the CPU's scalar "
                f"division in {int((cpu_div != true_div.cpu()).sum())}")

    # timing at the bench's shapes, keypoints inside the margin: the parent's
    # path and the fused kernel in turns
    imgs, xy, counts = _describe_problem(dev, BENCH_LEVELS, 99)
    consts = parent_constants(dev)
    fused = lambda: orb.describe_keypoints(imgs, xy, counts)
    parent = lambda: parent_describe(imgs, xy, counts, consts)
    p_out, f_out = parent(), fused()
    rows = (p_out[1] != f_out[1]).any(dim=1)
    times = {"parent": [], "fused": []}
    for who in ("parent", "fused", "fused", "parent"):
        # the parent's ~100 launches a call take the host ~3 ms: 10 calls
        # keep the queue ahead of the device behind cuda_time_ms's spin
        times[who].append(cuda_time_ms(fused) if who == "fused"
                          else cuda_time_ms(parent, reps=10))
    plain = cuda_time_ms(lambda: orb.describe_keypoints_plain(imgs, xy, counts), reps=10)
    n_bytes, n_ops = describe_bytes_ops(BENCH_LEVELS, xy.shape[0])
    b = bound(n_bytes, n_ops, "f32")
    best = {k: min(t[0] for t in v) for k, v in times.items()}
    log(f"[2 K1 describe] fused kernel bit-equal to its twin (angle and descriptor, "
        f"tolerance 0) at {', '.join(cases_n)}; {twin_cpu}; {division}; per eye at the bench's 4 levels "
        f"(N={xy.shape[0]}), parent / fused / fused / parent: "
        + " / ".join(f"{_us(t)}" for t in (times['parent'][0], times['fused'][0],
                                            times['fused'][1], times['parent'][1]))
        + f"; plain twin {_us(plain)}; bound {b['bound_ms'] * 1e3:.3f} us ({b['bound_by']}: "
        f"{n_bytes / 1e6:.3f} MB, {n_ops / 1e6:.2f} M operations); parent path vs fused on "
        f"these inputs: {int(rows.sum())} descriptors ({int((p_out[1] != f_out[1]).sum())} "
        f"bits) differ, max |d angle| {(p_out[0] - f_out[0]).abs().max().item():.1e} rad")
    return {"max_abs_err": worst, "ms": best["fused"], "plain_ms": plain[0], **b,
            "library_ms": None,
            "library_call": "none: no PyTorch call computes the ORB describe",
            "shape": "one eye, 4 levels 480x640..168x224, N=1024",
            "parent_ms": best["parent"],
            "parent_ms_note": "the parent commit's describe path (K1 gather a level + the "
                              "PyTorch tail) at the same inputs, best of two turns"}


def _k2_problem(dev, na=1024, nb=8192):
    """Random descriptors with planted matches (half the rows, as far as the
    columns allow), planted row ties (two equal columns, up to 64 rows) and
    column ties (the last up to 32 rows repeat the first)."""
    from fitslam_tpu_torch.ops.orb import pack_descriptors

    rng = np.random.RandomState(2)
    a = np.where(rng.rand(na, 256) < 0.5, 1.0, -1.0).astype(np.float32)
    b = np.where(rng.rand(nb, 256) < 0.5, 1.0, -1.0).astype(np.float32)
    xy_a = rng.randint(0, 640, (na, 2)).astype(np.float32) + 0.5
    xy_b = rng.randint(0, 640, (nb, 2)).astype(np.float32) + 0.5
    perm = rng.permutation(nb)
    n_match = min(na // 2, nb // 2)
    for i in range(n_match):                      # planted matches, 0-12 flipped bits
        j = perm[i]
        flip = rng.rand(256) < rng.uniform(0.0, 0.05)
        b[j] = np.where(flip, -a[i], a[i])
        xy_b[j] = xy_a[i] + rng.uniform(-3, 3, 2).astype(np.float32)
        xy_b[j, 0] = xy_a[i, 0] - rng.uniform(1.0, 60.0)   # positive disparity
    n_tie = max(0, min(64, na - n_match, (nb - n_match) // 2))
    for i in range(n_match, n_match + n_tie):     # planted row ties: two equal columns
        j1, j2 = perm[i], perm[i + n_tie]
        b[j1] = b[j2] = a[i]
        xy_b[j1] = xy_b[j2] = xy_a[i] + np.float32(24.0) * np.array([1, 0], np.float32)
    n_dup = min(32, na // 2)
    if n_dup:                                     # planted column ties: duplicate rows
        a[na - n_dup:] = a[:n_dup]
        xy_a[na - n_dup:] = xy_a[:n_dup]
    lvl_a = rng.randint(0, 4, na).astype(np.int32)
    lvl_b = rng.randint(0, 4, nb).astype(np.int32)
    va = rng.rand(na) < 0.95
    vb = rng.rand(nb) < 0.95

    def t(x):
        return torch.as_tensor(x, device=dev).contiguous()

    return dict(a_bits=pack_descriptors(t(a).to(torch.bfloat16)), valid_a=t(va),
                b_bits=pack_descriptors(t(b).to(torch.bfloat16)), valid_b=t(vb),
                xy_a=t(xy_a), xy_b=t(xy_b), level_a=t(lvl_a), level_b=t(lvl_b))


def phase_k2(dev):
    from fitslam_tpu_torch.ops import pallas_matching as pm

    gates = {
        pm.GATE_NONE: None,
        pm.GATE_WINDOW: torch.tensor([24.0 * 24.0, 0.0], device=dev),
        pm.GATE_STEREO: torch.tensor([2.0, 0.2 * 400.0 / 0.3], dtype=torch.float32, device=dev),
    }
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst, found, problems, plans = 0, {}, {}, []
    for na, nb in K2_SHAPES:
        p = problems[na, nb] = _k2_problem(dev, na, nb)
        for mode, gate in gates.items():
            ref = pm.hamming_top2_plain(**p, mode=mode, gate=gate)
            for design in pm.DESIGNS:
                got = pm.hamming_top2(**p, mode=mode, gate=gate, design=design)
                torch.cuda.synchronize()
                for f in pm.Top2._fields:
                    x, y = getattr(got, f), getattr(ref, f)
                    worst = max(worst, int((x - y).abs().max().item()))
                    if not torch.equal(x, y):
                        raise AssertionError(
                            f"K2 {design} mode {mode} at {na}x{nb}: {f} differs from its "
                            f"twin in {int((x != y).sum())} entries")
            if (na, nb) == K2_SHAPES[0]:
                found[mode] = int((ref.best < 64).sum())
        plans.append(f"{na}x{nb} {tuple(pm.top2_plan(na, nb, sms))}")
    if found[pm.GATE_NONE] < 400:
        raise AssertionError(f"planted matches not found: {found}")

    def timed(na, nb, mode, design):
        p, gate = problems[na, nb], gates[mode]
        if design == "plain":
            return cuda_time_ms(lambda: pm.hamming_top2_plain(**p, mode=mode, gate=gate), reps=10)
        return cuda_time_ms(lambda: pm.hamming_top2(**p, mode=mode, gate=gate, design=design))

    # both main-path shapes, every design, in turns (shipped, others, shipped)
    order = [pm.DEFAULT_DESIGN] + [d for d in pm.DESIGNS if d != pm.DEFAULT_DESIGN]
    cases = (((1024, 8192), pm.GATE_WINDOW, "window"), ((1024, 1024), pm.GATE_STEREO, "stereo"))
    times = {}
    for shape, mode, name in cases:
        for design in order + order[::-1] + ["plain"]:
            t = timed(*shape, mode, design)
            times.setdefault((name, design), []).append(t)
    dev_ms = {k: min(t[0] for t in v) for k, v in times.items()}
    # the shipped design's column split at several blocks a SM, at both
    # main-path shapes, each checked, in turns
    split_ms = {}
    for shape, mode, name in cases:
        p, gate = problems[shape], gates[mode]
        ref = pm.hamming_top2_plain(**p, mode=mode, gate=gate)
        for k in K2_BLOCKS_PER_SM + K2_BLOCKS_PER_SM[::-1]:
            plan = pm.top2_plan(*shape, sms, k)
            if (name, k) not in split_ms:
                got = pm.hamming_top2(**p, mode=mode, gate=gate, plan=plan)
                if any(not torch.equal(getattr(got, f), getattr(ref, f))
                       for f in pm.Top2._fields):
                    raise AssertionError(f"K2 {pm.DEFAULT_DESIGN} differs from its twin "
                                         f"with {plan} at {shape}")
            t = cuda_time_ms(lambda: pm.hamming_top2(**p, mode=mode, gate=gate, plan=plan))
            split_ms[name, k] = min(split_ms.get((name, k), t), t)
    # yardstick: the +-1 product at K2's core as one bf16 matmul, at both
    # main-path shapes; it is not the gated top-2 (no PyTorch call computes that)
    lib_at = {}
    for shape in ((1024, 8192), (1024, 1024)):
        p = problems[shape]
        a_pm1 = pm._unpack_pm1(p["a_bits"]).to(torch.bfloat16)
        b_pm1 = pm._unpack_pm1(p["b_bits"]).to(torch.bfloat16).T.contiguous()
        lib_at[shape] = cuda_time_ms(lambda: torch.matmul(a_pm1, b_pm1))
    lib, lib_st = lib_at[1024, 8192], lib_at[1024, 1024]
    b_win = bound(k2_bytes(1024, 8192, pm.GATE_WINDOW), 2 * 1024 * 8192 * 256, "int8")
    b_st = bound(k2_bytes(1024, 1024, pm.GATE_STEREO), 2 * 1024 * 1024 * 256, "int8")
    label = {pm.DEFAULT_DESIGN: " (shipped)"}
    parts = "; ".join(
        f"{name} {'x'.join(map(str, shape))}: " + ", ".join(
            f"{d}{label.get(d, '')} {dev_ms[name, d] * 1e3:.1f} us" for d in order + ["plain"])
        for shape, _, name in cases)
    log(f"[3 K2] idx/best/second/col_best exactly equal to its twin for every design "
        f"({', '.join(pm.DESIGNS)}) in modes none/window/stereo at {', '.join(plans)} "
        f"(Na x Nb (columns a block, column splits); tolerance 0; rows with best < 64 at "
        f"1024x8192: {found}); device time, best of two turns: {parts}; bound window "
        f"{b_win['bound_ms'] * 1e3:.2f} us ({b_win['bound_by']}), stereo "
        f"{b_st['bound_ms'] * 1e3:.2f} us ({b_st['bound_by']}); {pm.DEFAULT_DESIGN} (default "
        f"{pm.BLOCKS_PER_SM} blocks/SM) at " + "; ".join(
            f"{name}: " + ", ".join(f"{k} blocks/SM {tuple(pm.top2_plan(*shape, sms, k))} "
                                    f"{split_ms[name, k][0] * 1e3:.1f} us"
                                    for k in K2_BLOCKS_PER_SM)
            for shape, _, name in cases)
        + f" (best of two turns, each exactly equal); bf16 +-1 matmul 1024x256 @ 256x8192 "
        f"{_us(lib)}, 1024x256 @ 256x1024 {_us(lib_st)}")
    return {"max_abs_err": worst, "ms": dev_ms["window", pm.DEFAULT_DESIGN],
            "plain_ms": dev_ms["window", "plain"], **b_win, "library_ms": lib[0],
            "library_call": "bf16 +-1 torch.matmul (1024x256) @ (256x8192), the product "
                            "at K2's core; no PyTorch call computes the gated top-2",
            "shape": "window 1024x8192", "design": pm.DEFAULT_DESIGN,
            "pr2_ms": None,
            "pr2_ms_note": "the first port's K2 kernel is not in this tree; PERF.md gives its "
                           "time from a run of the parent commit in the same call",
            "stereo_ms": dev_ms["stereo", pm.DEFAULT_DESIGN],
            "stereo_bound_ms": b_st["bound_ms"], "stereo_library_ms": lib_st[0],
            "design_ms": {f"{name} {d}": dev_ms[name, d] for _, _, name in cases for d in order}}


def _counted():
    """{kernel: its wrapper, which counts the kernel's launches}. A package
    from before the fused describe (``--tree``) has no describe wrapper, one
    from before the EKF window kernel no ``ops/ekf_window.py``."""
    from fitslam_tpu_torch.ops import orb, pallas_grid, pallas_matching, pallas_patches

    try:
        from fitslam_tpu_torch.ops.ekf_window import ekf_window
    except ImportError:
        ekf_window = None
    wrappers = {"gather": pallas_patches.gather_patches,
                "describe": getattr(orb, "describe_keypoints", None),
                "top2": pallas_matching.hamming_top2, "sweep": pallas_grid.wavefront_sweeps,
                "ekf": ekf_window}
    return {k: f for k, f in wrappers.items() if f is not None}


def _reset_counts():
    for f in _counted().values():
        f.launches = 0


def _counts():
    """{kernel: launches since the last reset}."""
    return {k: f.launches for k, f in _counted().items()}


def phase_golden(dev):
    from fitslam_tpu_torch.data.tum import read_pgm
    from fitslam_tpu_torch.models.slam import StereoSlam
    from fitslam_tpu_torch.utils import evaluation as ev
    from fitslam_tpu_torch.utils.config import FitSlamConfig

    seq = ROOT / "tests" / "data" / "corridor_seq"
    W, H = 320, 240
    cfg = FitSlamConfig()
    cfg = dataclasses.replace(
        cfg,
        camera=dataclasses.replace(cfg.camera, width=W, height=H, fx=200.0, fy=200.0,
                                   cx=W / 2, cy=H / 2, baseline=0.2),
        orb=dataclasses.replace(cfg.orb, num_features=512, num_levels=2, fast_threshold=12.0),
        tracking=dataclasses.replace(cfg.tracking, min_inliers=10, keyframe_min_interval=2,
                                     keyframe_translation=0.3, reloc_enabled=False),
        mapping=dataclasses.replace(cfg.mapping, max_keyframes=64, max_landmarks=4096,
                                    max_observations=12288, local_window=4, ba_iters=3),
        loop=dataclasses.replace(cfg.loop, enabled=False),
    )
    pairs = list(zip(sorted((seq / "left").glob("*.pgm")), sorted((seq / "right").glob("*.pgm"))))
    if len(pairs) != 40:
        raise AssertionError(f"corridor_seq has {len(pairs)} frames, expected 40")
    frames = [(torch.as_tensor(read_pgm(lp).astype(np.float32), device=dev),
               torch.as_tensor(read_pgm(rp).astype(np.float32), device=dev)) for lp, rp in pairs]
    slam = StereoSlam(cfg, dev)
    _reset_counts()
    for l, r in frames:
        slam.process_frame(l, r)
    n = _counts()
    gt = list(np.load(seq / "gt_poses.npy"))
    ate = ev.ate_rmse(slam.trajectory, gt)
    n_kf = int(slam.map.n_kf)
    log(f"[4 golden] corridor_seq 40 frames 320x240: ATE {ate:.4f} m, {n_kf} keyframes, "
        f"K1 describe {n['describe']} / K1 gather {n['gather']} / K2 {n['top2']} launches")
    if not ate <= ATE_BOUND_M:
        raise AssertionError(f"golden ATE {ate} > {ATE_BOUND_M}")
    if not GOLDEN_KF_RANGE[0] <= n_kf <= GOLDEN_KF_RANGE[1]:
        raise AssertionError(f"golden keyframes {n_kf} outside {GOLDEN_KF_RANGE}")
    if n["describe"] != 2 * len(frames) or n["gather"] or n["top2"] <= 0:
        raise AssertionError(f"kernel launches on the main path: {n}, expected 2 fused "
                             f"describes a frame, no gather and some K2")


def bench_config():
    """The headline configuration without loop closing and relocalization,
    which phase 15's stage pipeline does not run."""
    cfg = headline_config()
    return dataclasses.replace(
        cfg, tracking=dataclasses.replace(cfg.tracking, reloc_enabled=False),
        loop=dataclasses.replace(cfg.loop, enabled=False))


def _describe_calls(frames, o):
    """The describe calls of extract_orb on both eyes of every frame, as
    (levels, xy, counts), recorded by wrapping the module's function."""
    from fitslam_tpu_torch.ops import orb

    calls, fused = [], orb.describe_keypoints

    def record(levels, xy, counts):
        calls.append((levels, xy, counts))
        return fused(levels, xy, counts)

    # the wrapper counts its launches on the module's name, ``record`` here
    record.launches = fused.launches
    orb.describe_keypoints = record
    try:
        for pair in frames:
            for img in pair:
                orb.extract_orb(img, o.num_features, o.num_levels, o.scale_factor,
                                o.fast_threshold)
    finally:
        orb.describe_keypoints = fused
        fused.launches = record.launches
    return calls


def phase_bench(dev):
    from fitslam_tpu_torch.models import tracking as tr
    from fitslam_tpu_torch.models.slam import StereoSlam
    from fitslam_tpu_torch.ops import orb
    from fitslam_tpu_torch.ops.geometry import Intrinsics
    from fitslam_tpu_torch.utils import evaluation as ev

    cfg = headline_config()
    W, H = cfg.camera.width, cfg.camera.height
    K = Intrinsics.from_config(cfg.camera, dev)
    frames, gt = headline_frames(cfg, dev)

    # untimed pass: first calls, and torch's own count of synchronising calls
    warm = StereoSlam(cfg, dev)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            timed_pass(warm, frames, dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch_syncs = sum("synchroniz" in str(w.message) for w in caught)
    warm.finalize()

    # frontend alone (both eyes' ORB + stereo matching), timed
    o = cfg.orb
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for l, r in frames:
        tr.process_stereo(K, l, r, num_features=o.num_features, num_levels=o.num_levels,
                          scale_factor=o.scale_factor, fast_threshold=o.fast_threshold)
    torch.cuda.synchronize()
    frontend_ms = (time.monotonic() - t0) / N_BENCH_FRAMES * 1e3

    # the fused kernel against the parent commit's describe path on the
    # keypoints of every bench image
    consts = parent_constants(dev)
    bits = rows = n_kp = 0
    d_ang = 0.0
    for levels, xy, counts in _describe_calls(frames, o):
        fa, fd = orb.describe_keypoints(levels, xy, counts)
        pa, pd = parent_describe(levels, xy, counts, consts)
        bits += int((fd != pd).sum())
        rows += int((fd != pd).any(dim=1).sum())
        n_kp += xy.shape[0]
        d_ang = max(d_ang, (fa - pa).abs().max().item())

    # timed passes of the headline (bench.timed_pass): the host clock varies
    # between passes (the step is host-bound), so every pass is reported
    fps = []
    for _ in range(N_TIMED_PASSES):
        slam = StereoSlam(cfg, dev)
        _reset_counts()
        fps.append(timed_pass(slam, frames, dev))
        n = _counts()
        syncs = slam.host_syncs
        stats = slam.finalize()
        ate = ev.ate_rmse(slam.trajectory, gt)
        n_kf = int(slam.map.n_kf)
        if n["describe"] != 2 * N_BENCH_FRAMES or n["gather"]:
            raise AssertionError(f"K1 launches {n}: expected 2 fused describes a frame (one an "
                                 f"eye) and no standalone gather")
        if n["top2"] <= 0:
            raise AssertionError("K2 never launched on the main path")
        if not ate <= ATE_BOUND_M:
            raise AssertionError(f"bench ATE {ate} > {ATE_BOUND_M}")
    log(f"[5 bench] {N_BENCH_FRAMES} frames {W}x{H}, {o.num_features} features, "
        f"{o.num_levels} levels, {cfg.mapping.max_landmarks} landmarks: "
        f"{sorted(fps)[len(fps) // 2]:.2f} frames/s median of passes "
        f"{', '.join(f'{f:.2f}' for f in fps)} (frontend alone {frontend_ms:.2f} ms/frame), "
        f"ATE {ate:.4f} m, {n_kf} keyframes ({len(stats['keyframes'])} in outputs), "
        f"host syncs/frame {syncs / N_BENCH_FRAMES:.2f} (torch-reported syncs/frame in the "
        f"untimed pass {torch_syncs / N_BENCH_FRAMES:.2f}), K1 fused describe "
        f"{n['describe'] / N_BENCH_FRAMES:.2f} / K1 gather {n['gather'] / N_BENCH_FRAMES:.2f} / "
        f"K2 {n['top2'] / N_BENCH_FRAMES:.2f} launches/frame; fused vs the parent's describe "
        f"path on the {2 * N_BENCH_FRAMES} images: {bits} of {n_kp * 256} descriptor bits in "
        f"{rows} of {n_kp} descriptors differ, max |d angle| {d_ang:.1e} rad")
    return n, fps


def _k3_problems(G):
    """Two (pot0, step, passable) problems at G: random step costs in
    [0.25, 0.55] on 90 % passable cells with the goal at corner cell (0, 0),
    and the rooms-world maze (step 0.25 m, walls impassable) with the goal
    at the corner cell of its free area, (2, 2)."""
    from fitslam_tpu_torch.models.sim_robot import make_rooms_world
    from fitslam_tpu_torch.ops.grid import LETHAL, GridSpec2D
    from fitslam_tpu_torch.ops.pallas_grid import BIG

    maze = make_rooms_world(GridSpec2D(G, 0.25, 0.0, 0.0), seed=1)
    maze_pot0 = np.full((G, G), BIG, np.float32)
    maze_pot0[2, 2] = 0.0
    return [_k3_random(G, G, G, (0, 0)),
            (maze_pot0, np.full((G, G), 0.25, np.float32), maze != LETHAL)]


def _k3_random(H, W, seed, goal):
    """Random step costs in [0.25, 0.55] on 90 % passable cells, goal at ``goal``."""
    from fitslam_tpu_torch.ops.pallas_grid import BIG

    rng = np.random.RandomState(seed)
    step = rng.uniform(0.25, 0.55, (H, W)).astype(np.float32)
    passable = rng.rand(H, W) < 0.9
    pot0 = np.full((H, W), BIG, np.float32)
    pot0[goal] = 0.0
    return pot0, step, passable


def phase_k3(dev):
    from fitslam_tpu_torch.ops import pallas_grid as pg

    worst = 0.0

    def check(pot0, step, passable, iters, plan, what):
        nonlocal worst
        got = pg.wavefront_sweeps(pot0, step, passable, iters, plan=plan)
        ref = pg.wavefront_sweeps_plain(pot0, step, passable, iters)
        torch.cuda.synchronize()
        worst = max(worst, (got - ref).abs().max().item())
        if not torch.equal(got, ref):
            raise AssertionError(f"K3 {plan.design} differs from its twin at {what}: "
                                 f"{int((got != ref).sum())} cells, max |d| "
                                 f"{(got - ref).abs().max().item()}")
        return ref

    def grouped(H, W):
        """The resident plans that exchange every K3_GROUPS sweeps, where
        the grid has them."""
        plans = []
        for k in K3_GROUPS:
            try:
                plans.append((f"group {k}", pg.sweep_plan(H, W, k)))
            except ValueError:
                pass
        return plans

    parts, times = [], {}
    for G, iters in K3_CASES:
        rule = pg.sweep_plan(G, G)
        # beside the rule's kernel: the tiled one, the resident one with its
        # bands exchanging every k sweeps, and at G = 64 as one block
        others = [("tiled", pg.TILED)] + grouped(G, G)
        if G == K3_ONE_BLOCK[0]:
            others.append(("one block", pg.SweepPlan(*K3_ONE_BLOCK[1])))
        problems = [tuple(torch.as_tensor(a, device=dev) for a in p) for p in _k3_problems(G)]
        for k, (pot0, step, passable) in enumerate(problems):
            for name, plan in [("rule", rule)] + others:
                ref = check(pot0, step, passable, iters, plan,
                            f"G={G} iters={iters} problem {k} ({name})")
            reached = int((ref < pg.BIG).sum())
            if reached < G:
                raise AssertionError(f"K3 problem {k} at G={G}: the wavefront reached "
                                     f"only {reached} cells")
        pot0, step, passable = problems[0]
        # in turns: the rule's kernel, the others, the others backwards, the
        # rule's again; then the twin
        runs = {}
        for name, plan in [("rule", rule)] + others + others[::-1] + [("rule", rule)]:
            t = cuda_time_ms(lambda: pg.wavefront_sweeps(pot0, step, passable, iters, plan=plan),
                             reps=20)
            runs[name] = min(runs.get(name, t), t)
        plain = cuda_time_ms(lambda: pg.wavefront_sweeps_plain(pot0, step, passable, iters),
                             reps=3, warmup=1)
        # bytes: pot0, step, out (4 each) and passable (1); operations: 5 a
        # cell and sweep (3 fminf over the neighbours, the add, the fminf
        # with the old value)
        b = bound(G * G * 13, 5 * G * G * iters, "f32")
        times[G] = (runs, plain, b)
        parts.append(f"G={G} iters={iters}: rule {rule.design} {tuple(rule[1:])} "
                     f"{runs['rule'][0]:.4f} ms device / {runs['rule'][1]:.4f} ms wall, "
                     + ", ".join(f"{name} {tuple(plan[1:]) if plan.design == 'resident' else ''} "
                                 f"{runs[name][0]:.4f} / {runs[name][1]:.4f} ms"
                                 for name, plan in others)
                     + f", plain {plain[0]:.2f} / {plain[1]:.2f} ms, bound "
                     f"{b['bound_ms'] * 1e3:.2f} us ({b['bound_by']})")
    ragged = []
    for H, W, iters in K3_RAGGED:
        pot0, step, passable = (torch.as_tensor(a, device=dev)
                                for a in _k3_random(H, W, H * 7 + W, (H // 3, W - 1)))
        for name, plan in [("rule", pg.sweep_plan(H, W))] + grouped(H, W):
            check(pot0, step, passable, iters, plan, f"({H}, {W}) iters={iters} ({name})")
            ragged.append(f"({H}, {W}, {iters}) {plan.design}"
                          + (f" {tuple(plan[1:])}" if plan.design == "resident" else ""))
    log(f"[6 K3] exactly equal to its twin (tolerance 0, max |d| {worst}) on random and "
        f"rooms-maze problems at {K3_CASES} through the size rule's kernel, the tiled one and "
        f"the grouped exchanges, and at ragged (H, W, iters) through the size rule's and the "
        f"grouped ones: {', '.join(ragged)} (resident plans: rows a thread, threads across, "
        f"threads down, blocks of the cluster, sweeps between exchanges); device time, best "
        f"of two turns: " + "; ".join(parts))
    runs, plain, b = times[320]
    return {"max_abs_err": worst, "ms": runs["rule"][0], "plain_ms": plain[0], **b,
            "library_ms": None,
            "library_call": "none: no PyTorch call computes min-plus sweeps",
            "shape": "(320, 320), 512 sweeps", "design": pg.sweep_plan(320, 320).design,
            "pr2_ms": runs["tiled"][0],
            "pr2_ms_note": "the tiled kernel, the first port's, at the same shape",
            "design_ms": {f"G={G} {name}": t[0] for G, (runs, _, _) in times.items()
                          for name, t in runs.items()}}


def _call_site() -> str:
    """file:line of the innermost caller outside torch, the warnings module
    and this script's own sync-counting helpers."""
    torch_dir = str(Path(torch.__file__).parent)
    for fr in reversed(traceback.extract_stack()):
        if fr.filename.startswith(torch_dir) or fr.filename.endswith("warnings.py") or \
                fr.name in ("_call_site", "_seen", "counted_wait"):
            continue
        return f"{Path(fr.filename).name}:{fr.lineno}"
    return "?"


@contextmanager
def _torch_syncs(tally: dict, key: str, sites: Counter = None):
    """Add to ``tally[key]`` torch's own count of synchronising calls made
    inside the block (sync debug mode "warn" only there), and the block's
    waits on a CUDA event, which that mode does not report
    (``torch.cuda.Event.synchronize``, counted by wrapping it). ``sites``
    gathers the file:line of the caller outside torch of each."""
    real_wait = torch.cuda.Event.synchronize
    found = []

    def _seen(message, *args, **kwargs):
        # torch's one-time notice that the mode is a prototype names no sync
        if "synchroniz" in str(message) and "prototype" not in str(message):
            found.append(_call_site())

    def counted_wait(event):
        found.append(_call_site() + " (event)")
        return real_wait(event)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = _seen
        torch.cuda.Event.synchronize = counted_wait
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.Event.synchronize = real_wait
    tally[key] += len(found)
    if sites is not None:
        sites.update(found)


def explore(dev, spec, cfg, start_xy, n_steps=EXPLORE_STEPS, profile_window=None,
            capture=True, time_window=None):
    """bench_suite.explore_run (the ablation mode's loop, that of
    tests/test_exploration_e2e.py) measured through its windows: calls, host
    seconds, K3 launches and torch's count of host syncs of the ticks and of
    the controller steps. Returns a dict of what the run measured. With
    ``profile_window`` = (first, end) the run stops at step ``end`` and a
    ``torch.profiler`` traces steps first..end-1 from the first window of
    step ``first`` on (returned as ``prof``, with the window's host seconds as
    ``window_s``). ``capture=False`` runs the server's and the nav's regions
    eagerly; with ``time_window`` = (first, end) the windows of those steps
    are also summed apart (``tick_w_*``, ``ctrl_w_*``)."""
    from fitslam_tpu_torch.models import sim_robot as sim
    from fitslam_tpu_torch.ops.grid import UNKNOWN

    # per window (tick / controller): calls, seconds, K3 launches, torch syncs
    r = {f"{w}_{k}": 0 for w in ("tick", "ctrl", "tick_w", "ctrl_w")
         for k in ("n", "s", "k3", "torch_syncs")}

    def window(w, step, fn):
        if profile_window and step == profile_window[0] and "prof" not in r:
            torch.cuda.synchronize()
            r["prof"] = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                           torch.profiler.ProfilerActivity.CUDA])
            r["prof"].__enter__()
            r["window_s"] = time.perf_counter()
        torch.cuda.synchronize()
        k3, t0 = _counts()["sweep"], time.perf_counter()
        with _torch_syncs(r, f"{w}_torch_syncs"):
            out = fn()
        torch.cuda.synchronize()
        for key in (w, f"{w}_w") if time_window and time_window[0] <= step < time_window[1] \
                else (w,):
            r[f"{key}_n"] += 1 if w == "tick" else 4
            r[f"{key}_s"] += time.perf_counter() - t0
            r[f"{key}_k3"] += _counts()["sweep"] - k3
        return out

    _reset_counts()
    steps = profile_window[1] if profile_window else n_steps
    run = explore_run(cfg, spec, start_xy, steps, dev, window=window, capture=capture)
    if profile_window:
        torch.cuda.synchronize()
        r["window_s"] = time.perf_counter() - r["window_s"]
        r["prof"].__exit__(None, None, None)
    launches = _counts()
    cov = run["known"].cpu().numpy() / float(spec.size * spec.size)
    explored = run["explored"].cpu().numpy()
    known = explored != UNKNOWN
    server, nav = run["server"], run["nav"]
    r.update(
        steps=steps, coverage=cov, goals=server.diag.goals_sent, launches=launches,
        agree=float((explored[known] == sim.make_rooms_world(spec, seed=1)[known]).mean()),
        plans=nav.plans, tick_syncs=server.host_syncs, ctrl_syncs=nav.host_syncs,
        nodes=int(server.roadmap.n_nodes), traj=np.array(run["robot"].trajectory),
        diag=dict(vars(server.diag)), path=None if nav._path is None else nav._path.copy(),
        capture_stats={**nav.capture_stats, **server.capture_stats,
                       **run["sensor"].capture_stats})
    return r


@contextmanager
def _recorded_draws(draws: list):
    """Keep every RandomCosts draw (tick, values) made inside the block: the
    tick is the key's low word (``prng_key(ticks)``)."""
    from fitslam_tpu_torch.utils import prng

    real = prng.uniform

    def uniform(key, shape, minval=0.0, maxval=1.0):
        out = real(key, shape, minval, maxval)
        draws.append((int(key[1]), out.copy()))
        return out

    prng.uniform = uniform
    try:
        yield
    finally:
        prng.uniform = real


def phase_explore(dev, n_steps=EXPLORE_STEPS):
    from fitslam_tpu_torch.models import nav
    from fitslam_tpu_torch.ops.grid import GridSpec2D
    from fitslam_tpu_torch.utils.config import FitSlamConfig
    from fitslam_tpu_torch.utils.transfer import upload

    t_phase = time.monotonic()
    cfg = FitSlamConfig.preset("rapid")
    spec = GridSpec2D(int(round(cfg.traversability.global_size_m / cfg.traversability.resolution)),
                      cfg.traversability.resolution, -cfg.traversability.global_size_m / 2,
                      -cfg.traversability.global_size_m / 2)
    start_xy = (spec.origin_x + 3.0, spec.origin_y + 3.0)     # (-37, -37) at G = 320
    r = explore(dev, spec, cfg, start_xy, n_steps)
    cov = r["coverage"]
    # one descend_potential call at this width, from the start on a plan to
    # the map's centre
    from fitslam_tpu_torch.models import sim_robot as sim

    occ = torch.as_tensor(sim.make_rooms_world(spec, seed=1), device=dev)
    start = upload(np.array(start_xy, np.float32), dev)
    centre = np.array([spec.origin_x, spec.origin_y], np.float32) + spec.extent / 2
    pot = nav.wavefront_potential(spec, occ, upload(centre, dev), iters=cfg.nav.wavefront_iters)
    descend = cuda_time_ms(lambda: nav.descend_potential(spec, pot, start), reps=20)
    n_t, n_c = max(r["tick_n"], 1), max(r["ctrl_n"], 1)
    log(f"[7 explore] G={spec.size} at {spec.resolution} m, preset rapid "
        f"(wavefront_iters {cfg.nav.wavefront_iters}, max_frontiers "
        f"{cfg.frontier_search.max_frontiers}, roadmap {cfg.roadmap.max_nodes} nodes), "
        f"{r['steps']} steps: {r['tick_n'] / r['tick_s']:.2f} ticks/s "
        f"({r['tick_s'] / n_t * 1e3:.1f} ms/tick), {r['ctrl_n'] / r['ctrl_s']:.1f} controller "
        f"steps/s ({r['ctrl_s'] / n_c * 1e3:.2f} ms/step, {r['plans']} plans); "
        f"descend_potential {_us(descend)}; coverage {cov[min(10, len(cov) - 1)]:.4f} at step 10, "
        f"{cov[-1]:.4f} at step {r['steps']}; {r['goals']} goals, {r['nodes']} roadmap nodes; "
        f"K3 launches {r['tick_k3'] / n_t:.2f}/tick, {r['ctrl_k3'] / max(r['plans'], 1):.2f}/plan; "
        f"host syncs {r['tick_syncs'] / n_t:.2f}/tick and {r['ctrl_syncs'] / n_c:.3f}/controller "
        f"step (torch's count {r['tick_torch_syncs'] / n_t:.2f} and "
        f"{r['ctrl_torch_syncs'] / n_c:.3f}); explored map agrees with the ground truth "
        f"{r['agree']:.4f}")
    if r["tick_k3"] < r["tick_n"] or r["ctrl_k3"] < r["plans"] or r["plans"] < 1:
        raise AssertionError(f"K3 not launched on every tick and plan: {r['tick_k3']} over "
                             f"{r['tick_n']} ticks, {r['ctrl_k3']} over {r['plans']} plans")
    if not cov[-1] > cov[min(10, len(cov) - 1)]:
        raise AssertionError(f"coverage did not grow: {cov[10]} -> {cov[-1]}")
    if r["goals"] < 2:
        raise AssertionError(f"only {r['goals']} goals sent")
    if not r["agree"] > 0.97:
        raise AssertionError(f"explored map agrees with the ground truth {r['agree']}")
    if (r["tick_syncs"], r["ctrl_syncs"]) != (r["tick_torch_syncs"], r["ctrl_torch_syncs"]):
        raise AssertionError(f"host sync counts differ: engine {r['tick_syncs']} / "
                             f"{r['ctrl_syncs']}, torch {r['tick_torch_syncs']} / "
                             f"{r['ctrl_torch_syncs']} (ticks / controller steps)")
    launches = r["launches"]

    ablation = run_ablation(dev, n_steps)
    log(f"[7 explore] phase {time.monotonic() - t_phase:.1f} s")
    return launches, ablation


def run_ablation(dev, n_steps=EXPLORE_STEPS):
    """bench_suite.py::bench_ablation's three cost methods on the G = 64
    rooms world, each held to tests/test_exploration_e2e.py's coverage
    bounds and printed beside the reference's own final coverage; the
    RandomCosts run's draws equal the reference's committed jax.random
    draws. Returns the kernels' launches over the three runs."""
    from fitslam_tpu_torch.ops.grid import GridSpec2D

    small = GridSpec2D(**ABLATION_SPEC)
    committed = np.load(RANDOM_COSTS_DRAWS)["draws"]
    ablation = Counter()
    for name, methods in ABLATION_METHODS.items():
        t_run, draws = time.monotonic(), []
        with _recorded_draws(draws):
            a = explore(dev, small, ablation_config(methods), ABLATION_START, n_steps)
        ablation.update(a["launches"])
        acov = a["coverage"]
        ticks = [t for t, _ in draws]
        same = all(t < len(committed) and np.array_equal(d.view(np.uint32),
                                                         committed[t].view(np.uint32))
                   for t, d in draws)
        log(f"[7 explore] G=64 bench_ablation, {name} costs {methods}, {a['steps']} steps: "
            f"final coverage {acov[-1]:.4f} (reference {REFERENCE_ABLATION_COVERAGE[name]} at "
            f"step 299, ABLATION_COVERAGE.csv), {acov[10]:.4f} at step 10, {a['goals']} goals, "
            f"{a['tick_n'] / a['tick_s']:.2f} ticks/s, {a['ctrl_n'] / a['ctrl_s']:.1f} "
            f"controller steps/s, K3 {a['launches']['sweep']} launches"
            + (f"; {len(draws)} RandomCosts draws (ticks {min(ticks)}-{max(ticks)}) bit-equal "
               f"to the reference's jax.random draws in {RANDOM_COSTS_DRAWS.name}: {same}"
               if name == "random" else "")
            + f"; {time.monotonic() - t_run:.1f} s")
        if not (acov[-1] > 0.5 and acov[-1] > acov[10] + 0.2):
            raise AssertionError(f"G=64 {name} coverage {acov[10]} -> {acov[-1]} misses the "
                                 f"bounds")
        if name == "random" and not (draws and same and ticks == sorted(set(ticks))):
            raise AssertionError(f"RandomCosts draws differ from the reference's at ticks "
                                 f"{ticks}")
        if name != "random" and draws:
            raise AssertionError(f"{name} drew RandomCosts at ticks {ticks}")
        if a["launches"]["sweep"] <= 0:
            raise AssertionError(f"G=64 {name}: K3 was not launched")
    return dict(ablation)


# ---------------------------------------------------------------------------
# Phases 8-9: the active-SLAM loop, the marsyard run and the RGB-D arc
# ---------------------------------------------------------------------------


def run_active(dev, cfg, spec, landmarks, start, n_frames, max_omega=None, surface_z=None,
               snapshot_at=None, twist_mux=None, capture=True):
    """bench_suite.active_loop (the active_slam and marsyard modes' loop) on
    a robot at ``start``, measured through its windows: each frame, tick and
    controller step (and, with the EKF on, the read of its estimate, as
    tests/test_ekf_integration.py reads it: ``r["ekf"]``, beside the robot's
    true poses, ``r["truth"]``) runs between two synchronizes and is counted:
    host seconds, the engine's and torch's host syncs (with torch's call
    sites), and kernel launches. After each tick, outside the window, the
    FI oracle's value at the robot's true pose is read. After
    ``snapshot_at`` frames the coverage, goals, FI rejections and keyframes
    are noted as ``r["snapshot"]``. The goals the explorer sends are kept
    as ``r["goals_sent"]``; ``capture=False`` runs the eager system."""
    from fitslam_tpu_torch.models import sim_robot as sim
    from fitslam_tpu_torch.ops.grid import UNKNOWN

    robot = sim.DiffDriveRobot(x=start[0], y=start[1], yaw=start[2], v_max=0.8, w_max=1.0)
    system, nav = active_system(cfg, spec, robot, dev, max_omega=max_omega, twist_mux=twist_mux,
                                capture=capture)
    goals_sent, send_goal = [], nav.send_goal

    def recording_send(goal_xy, heading):
        goals_sent.append((np.asarray(goal_xy, np.float64).copy(), float(heading)))
        return send_goal(goal_xy, heading)

    nav.send_goal = recording_send

    def engine_syncs():
        return (system.slam.host_syncs + nav.host_syncs + system.explorer.host_syncs
                + system.host_syncs)

    r = {f"{w}_{k}": 0 for w in WINDOWS
         for k in ("n", "s", "syncs", "torch_syncs", "describe", "top2", "sweep")}
    r.update({f"{w}_sites": Counter() for w in WINDOWS})
    fi_values, infos, ekf, truth = [], [], [], []

    def window(w, step, fn):
        torch.cuda.synchronize()
        before, launches, t0 = engine_syncs(), _counts(), time.perf_counter()
        with _torch_syncs(r, f"{w}_torch_syncs", r[f"{w}_sites"]):
            out = fn()
        torch.cuda.synchronize()
        r[f"{w}_s"] += time.perf_counter() - t0
        r[f"{w}_n"] += 1
        r[f"{w}_syncs"] += engine_syncs() - before
        for k, v in _counts().items():
            if f"{w}_{k}" in r:
                r[f"{w}_{k}"] += v - launches[k]
        if w == "frame":
            infos.append(out)
        elif w == "tick":
            fi_values.append(system.fisher_information_of_pose(robot.xy, robot.yaw))
        elif w == "pose":
            ekf.append(out)
        elif w == "ctrl":
            truth.append((robot.x, robot.y, robot.yaw))
            if step + 1 == snapshot_at:
                d = system.explorer.diag
                r["snapshot"] = dict(
                    coverage=float((system.occupancy() != UNKNOWN).float().mean()),
                    goals=d.goals_sent, fi_rejections=d.fi_rejections,
                    n_kf=int(system.slam.map.n_kf))
        return out

    windows0 = system.ekf.windows if system.ekf is not None else 0
    _reset_counts()
    fps, cams = active_loop(system, nav, landmarks, n_frames, surface_z=surface_z,
                            window=window)
    launches = _counts()
    # the EKF windows fused in the run: ekf_window's launches must equal it
    r["ekf_windows"] = system.ekf.windows - windows0 if system.ekf is not None else 0
    system.finalize()
    gt = camera_matrices(cams)
    occ = system.occupancy().cpu().numpy()
    traj = np.array([(x, y) for x, y, _ in robot.trajectory])
    r.update(system=system, robot=robot, nav=nav, gt=gt, occ=occ, fi=fi_values, infos=infos,
             fps=fps,
             ekf=ekf, truth=np.array(truth), goals_sent=goals_sent,
             launches=launches, n_kf=int(system.slam.map.n_kf),
             extent=float(np.ptp(traj[:, 0]) + np.ptp(traj[:, 1])), traj=traj,
             ate=ate_world(system.slam.trajectory, gt))
    return r


def _per(r, w, key):
    return r[f"{w}_{key}"] / max(r[f"{w}_n"], 1)


def _window_line(r):
    return (f"K1 {_per(r, 'frame', 'describe'):.2f} / K2 {_per(r, 'frame', 'top2'):.2f} launches "
            f"a frame, K3 {_per(r, 'tick', 'sweep'):.2f} a tick and "
            f"{_per(r, 'ctrl', 'sweep'):.3f} a controller step; host syncs a frame "
            f"{_per(r, 'frame', 'syncs'):.3f} (torch {_per(r, 'frame', 'torch_syncs'):.3f}), "
            f"a tick {_per(r, 'tick', 'syncs'):.2f} (torch {_per(r, 'tick', 'torch_syncs'):.2f}), "
            f"a controller step {_per(r, 'ctrl', 'syncs'):.3f} (torch "
            f"{_per(r, 'ctrl', 'torch_syncs'):.3f}); host ms a frame "
            f"{_per(r, 'frame', 's') * 1e3:.1f}, a tick {_per(r, 'tick', 's') * 1e3:.1f} "
            f"({r['tick_n'] / max(r['tick_s'], 1e-9):.2f} ticks/s), a controller step "
            f"{_per(r, 'ctrl', 's') * 1e3:.2f}")


def _check_windows(r, what):
    """Every kernel of the path launched in the run, and the engine's and
    torch's counts of host syncs equal in every window."""
    if min(r["launches"][k] for k in ("describe", "top2", "sweep")) <= 0:
        raise AssertionError(f"{what}: a kernel of the path was not launched: {r['launches']}")
    for w in WINDOWS:
        if r[f"{w}_syncs"] != r[f"{w}_torch_syncs"]:
            raise AssertionError(f"{what}: host syncs differ in the {w} window: engine "
                                 f"{r[w + '_syncs']}, torch {r[w + '_torch_syncs']} at "
                                 f"{dict(r[w + '_sites'])}")


def fusion_check(dev, system, spec, tcfg):
    """buffer_cell_stats -> stats_to_grid -> threshold_grid on the run's
    clouds and world-anchored keyframe poses, twice on the card and once on
    the CPU: (card runs identical, occupancy equal to the CPU's, cells whose
    statistics differ between card and CPU)."""
    from fitslam_tpu_torch.ops import grid as gr
    from fitslam_tpu_torch.ops import lie

    kf, _ = system.kf_poses_world()

    def fuse(d):
        buf = gr.CloudBuffer(*(t.to(d) for t in system.clouds))
        stats = gr.buffer_cell_stats(spec, buf, lie.SE3(kf.R.to(d), kf.t.to(d)))
        grid = gr.stats_to_grid(spec, stats, max_slope=tcfg.max_slope,
                                ground_clearance=tcfg.ground_clearance,
                                robot_height=tcfg.robot_height,
                                security_distance=tcfg.security_distance)
        return [t.cpu() for t in (*stats, *grid, gr.threshold_grid(grid, tcfg.lethal_threshold))]

    a, b, c = fuse(dev), fuse(dev), fuse("cpu")
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    cells = int(sum((x != y).reshape(-1) for x, y in zip(a[:5], c[:5])).gt(0).sum())
    return same, torch.equal(a[-1], c[-1]), cells, int((a[-1] != gr.UNKNOWN).sum())


def oracle_gaps(dev, system, spec, robot):
    """Largest relative gap between the card's and the CPU's pose_information
    (at the robot's pose) and path_information (toward the frontiers of the
    final grid) on the same inputs."""
    from fitslam_tpu_torch.models.active_slam import camera_pose_from_robot
    from fitslam_tpu_torch.ops import fisher, lie
    from fitslam_tpu_torch.ops import frontier as fx
    from fitslam_tpu_torch.utils.transfer import upload

    fcfg = system.cfg.fisher_information
    T = lie.compose(lie.inverse(system.T_anchor),
                    camera_pose_from_robot(robot.x, robot.y, robot.yaw, device=dev))
    p_c, ok = system.slam.get_landmarks_in_view(T, max_distance=fcfg.max_landmark_distance)
    robot_xy = upload(np.asarray(robot.xy, np.float32), dev)
    fr = fx.extract_frontiers(spec, system.occupancy(), robot_xy, spec.extent, max_frontiers=64)
    lm = system.landmark_map_world()
    gaps = []
    for fn, args in ((fisher.pose_information, (p_c, ok)),
                     (fisher.path_information, (*lm, robot_xy, fr.goal_xy, fr.valid))):
        card = fn(*args).double().cpu()
        cpu = fn(*(a.cpu() for a in args)).double()
        gaps.append(float(((card - cpu).abs().max() / cpu.abs().max().clamp_min(1e-30))))
    return gaps, int(fr.valid.sum())


def phase_active(dev):
    from fitslam_tpu_torch.ops import grid as gr
    from fitslam_tpu_torch.ops.grid import GridSpec2D

    t_phase = time.monotonic()
    spec = GridSpec2D(64, 0.25, -8.0, -8.0)
    W, H = 640, 480
    cfg = active_config(W, H, 1024, 4, fx=0.625 * W)
    world = rooms_world(spec, dev, floor_points=4000)
    # the bench's robot and controller (max_omega at its default of 1.0)
    r = run_active(dev, cfg, spec, world.landmarks, (-5.0, -5.0, 0.3), ACTIVE_FRAMES,
                   snapshot_at=ACTIVE_BENCH_FRAMES)
    at80 = r["snapshot"]
    ate80 = ate_world(r["system"].slam.trajectory[:ACTIVE_BENCH_FRAMES],
                       r["gt"][:ACTIVE_BENCH_FRAMES])
    system, known = r["system"], r["occ"] != gr.UNKNOWN
    d = system.explorer.diag
    lethal = int((r["occ"][known] == gr.LETHAL).sum())
    tcfg = cfg.traversability
    same, occ_equal, cells, n_known = fusion_check(dev, system, spec, tcfg)
    gaps, n_fr = oracle_gaps(dev, system, spec, r["robot"])
    # grid fusion a keyframe: one cloud into the running statistics, the
    # classified grid and its threshold (ActiveSlamSystem._on_keyframe +
    # occupancy()), and the full re-stitch of the 48 x 4096 buffer. Their
    # device time is the sum of their kernels in a profiler window: the
    # CUDA-event time of these many small launches follows the host's pace
    kf, _ = system.kf_poses_world()
    slot = (int(system.clouds.n_clouds) - 1) % tcfg.max_clouds
    kf_idx = system.clouds.kf_idx[slot:slot + 1].long()
    T_kf = type(kf)(kf.R[kf_idx][0], kf.t[kf_idx][0])
    kw = dict(max_slope=tcfg.max_slope, ground_clearance=tcfg.ground_clearance,
              robot_height=tcfg.robot_height, security_distance=tcfg.security_distance)

    def scatter_one():
        return gr.scatter_cloud_stats(spec, system._fstats, system.clouds.points[slot],
                                      system.clouds.valid[slot], T_kf)

    def classify(stats):
        return gr.threshold_grid(gr.grid_from_stats(spec, stats, **kw), tcfg.lethal_threshold)

    def restitch():
        return gr.buffer_cell_stats(spec, system.clouds, kf)

    fuse_wall = cuda_time_ms(lambda: classify(scatter_one()), reps=20)[1]
    restitch_wall = cuda_time_ms(restitch, reps=10)[1]
    (stats_ms, stats_n), (grid_ms, grid_n), (re_ms, re_n) = (
        kernel_sum(fn) for fn in (scatter_one, lambda: classify(system._fstats), restitch))
    ref = REFERENCE_ACTIVE
    log(f"[8 active] {W}x{H}, {cfg.orb.num_features} features, {cfg.orb.num_levels} levels, "
        f"G={spec.size} at {spec.resolution} m, rooms world seed 3 ({world.landmarks.shape[0]} "
        f"points), {ACTIVE_FRAMES} frames, a tick every {TICK_EVERY}: {r['frame_n']} "
        f"frames, {r['tick_n']} ticks, {r['n_kf']} keyframes, world-anchored ATE "
        f"{r['ate']:.4f} m, coverage {known.mean():.4f}, {lethal} lethal cells, {d.goals_sent} "
        f"goals, {d.fi_rejections} FI rejections, max FI {max(r['fi']):.1f}, robot extent "
        f"{r['extent']:.2f} m; at frame {ACTIVE_BENCH_FRAMES}: ATE {ate80:.4f} m, coverage "
        f"{at80['coverage']:.4f}, {at80['goals']} goals, {at80['fi_rejections']} FI "
        f"rejections, {at80['n_kf']} keyframes (reference, its own {ACTIVE_BENCH_FRAMES}-frame "
        f"run: ATE {ref['ate_m']} m, coverage {ref['coverage']}, {ref['goals']} goals, "
        f"{ref['fi_rejections']} FI rejections, {ref['keyframes']} keyframes); "
        f"{_window_line(r)}; grid fusion a keyframe: kernels "
        f"{(stats_ms + grid_ms) * 1e3:.1f} us in {stats_n + grid_n:.0f} launches (the cloud's "
        f"statistics {stats_ms * 1e3:.1f} us in {stats_n:.0f}, the grid and its threshold "
        f"{grid_ms * 1e3:.1f} us in {grid_n:.0f}), {fuse_wall * 1e3:.1f} us host wall; the full "
        f"re-stitch of {tcfg.max_clouds}x{tcfg.max_points_per_cloud}: kernels {re_ms * 1e3:.1f} "
        f"us in {re_n:.0f} launches, {restitch_wall * 1e3:.1f} us host wall; fused grid of the run's {int(system.clouds.n_clouds)} clouds: card "
        f"runs identical {same}, occupancy equal to the CPU's {occ_equal} ({n_known} known "
        f"cells, {cells} cells whose statistics differ from the CPU's); largest card/CPU "
        f"relative gap: pose_information {gaps[0]:.2e}, path_information {gaps[1]:.2e} "
        f"({n_fr} frontiers); phase {time.monotonic() - t_phase:.1f} s")
    _check_windows(r, "[8 active]")
    if not (r["n_kf"] >= 5 and r["ate"] < 0.5 and known.mean() > 0.08 and lethal > 10
            and max(r["fi"]) > 5.0 and r["extent"] > 2.0 and d.goals_sent >= 1):
        raise AssertionError("[8 active] misses the bounds of tests/test_active_slam_e2e.py")
    if not (same and occ_equal):
        raise AssertionError(f"[8 active] fused grid: card runs identical {same}, occupancy "
                             f"equal to the CPU's {occ_equal}")
    return r


def phase_marsyard(dev):
    """bench_suite.py::bench_marsyard's loop, held to tests/test_marsyard_e2e.py's bounds."""
    from fitslam_tpu_torch.data import synthetic
    from fitslam_tpu_torch.ops import grid as gr
    from fitslam_tpu_torch.ops.grid import GridSpec2D

    t_phase = time.monotonic()
    spec = GridSpec2D(64, 0.25, -8.0, -8.0)
    cfg = active_config(320, 240, 320, 2, fx=200.0)
    mw = synthetic.marsyard_world(spec, seed=3, points_per_cell=6, device=dev)
    r = run_active(dev, cfg, spec, mw.world.landmarks, (-5.0, -0.5, 0.2), MARSYARD_FRAMES,
                   max_omega=0.9, surface_z=lambda x, y: synthetic.marsyard_surface_z(x, y, mw, spec))
    known = r["occ"] != gr.UNKNOWN
    grid_lethal, precision, violations, _ = lethal_scores(r["occ"], mw.gt_lethal, spec, r["traj"])
    d = r["system"].explorer.diag
    ref = REFERENCE_MARSYARD
    log(f"[8 marsyard] 320x240, {MARSYARD_FRAMES} frames, marsyard_world(seed=3, "
        f"points_per_cell=6) ({mw.world.landmarks.shape[0]} points): {r['n_kf']} keyframes, "
        f"ATE {r['ate']:.4f} m, known {known.mean():.4f}, {int(grid_lethal.sum())} lethal cells, "
        f"lethal precision {precision:.3f}, {violations} lethal-cell violations, robot extent "
        f"{r['extent']:.2f} m, {d.goals_sent} goals, {d.fi_rejections} FI rejections "
        f"(reference, its own run: precision {ref['lethal_precision']}, {ref['violations']} "
        f"violations, coverage {ref['coverage']}, {ref['goals']} goals); {_window_line(r)}; "
        f"phase {time.monotonic() - t_phase:.1f} s")
    _check_windows(r, "[8 marsyard]")
    if not (known.mean() > 0.05 and grid_lethal.sum() >= 10 and precision > 0.7
            and violations == 0 and r["extent"] > 2.0 and d.goals_sent >= 1):
        raise AssertionError("[8 marsyard] misses the bounds of tests/test_marsyard_e2e.py")
    return r["launches"]


def phase_rgbd(dev):
    """The arc of tests/test_rgbd_e2e.py at the bench's 640x480, 4 levels and
    1024 features, held to that file's bounds: process_rgbd_frame, a
    depth_image_to_cloud per keyframe (stride 8: the 320x240 test's 4800
    points), fuse_clouds, threshold_grid and extract_frontiers."""
    from fitslam_tpu_torch.data import synthetic
    from fitslam_tpu_torch.models.active_slam import camera_pose_from_robot
    from fitslam_tpu_torch.models.slam import StereoSlam
    from fitslam_tpu_torch.ops import frontier as fx
    from fitslam_tpu_torch.ops import grid as gr
    from fitslam_tpu_torch.ops import lie
    from fitslam_tpu_torch.ops.geometry import Intrinsics
    from fitslam_tpu_torch.ops.grid import GridSpec2D
    from fitslam_tpu_torch.utils import jit
    from fitslam_tpu_torch.utils.config import FitSlamConfig
    from fitslam_tpu_torch.utils.transfer import upload

    t_phase = time.monotonic()
    spec = GridSpec2D(64, 0.25, -8.0, -8.0)
    W, H = 640, 480
    cfg = FitSlamConfig()
    R = dataclasses.replace
    cfg = R(cfg,
            camera=R(cfg.camera, width=W, height=H, fx=0.625 * W, fy=0.625 * W, cx=W / 2,
                     cy=H / 2, baseline=0.2, rgbd=True),
            orb=R(cfg.orb, num_features=1024, num_levels=4, fast_threshold=12.0),
            tracking=R(cfg.tracking, min_inliers=10, keyframe_min_interval=2,
                       keyframe_translation=0.25, reloc_enabled=False),
            mapping=R(cfg.mapping, max_keyframes=32, max_landmarks=3072,
                      max_observations=8192, local_window=4, ba_iters=3),
            loop=R(cfg.loop, enabled=False),
            traversability=R(cfg.traversability, max_points_per_cloud=4800, max_clouds=32))
    K = Intrinsics.from_config(cfg.camera, dev)
    world = rooms_world(spec, dev, floor_points=5000)
    slam = StereoSlam(cfg, dev)
    tcfg = cfg.traversability
    box = {"clouds": gr.empty_cloud_buffer(tcfg.max_clouds, tcfg.max_points_per_cloud, dev)}

    def on_kf(s, kf_idx):
        pts, ok = gr.depth_image_to_cloud(K, box["depth"], stride=8, max_depth=8.0)
        box["clouds"] = gr.add_cloud(box["clouds"], pts, ok, kf_idx)

    slam.keyframe_events.append(on_kf)
    camera = synthetic.SimCamera(K, world.landmarks, W, H, max_depth=12.0, rgbd=True)
    x, y, yaw = -5.0, -5.0, 0.3
    cams = []
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(RGBD_FRAMES):
        cam = camera_pose_from_robot(x, y, yaw, device=dev)
        cams.append(cam)
        img, depth = camera.frame(cam)
        # the keyframe callback reads the depth: held, as the next frame
        # overwrites the camera's buffer
        box["depth"] = jit.hold(depth)
        slam.process_rgbd_frame(img, box["depth"])
        if step >= 2:
            yaw += 0.04
            x += 0.12 * math.cos(yaw)
            y += 0.12 * math.sin(yaw)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    n = _counts()
    kf_world = lie.compose(slam.map.kf_T_cw, lie.inverse(cams[0]))
    grid = gr.fuse_clouds(spec, box["clouds"], kf_world, max_slope=tcfg.max_slope,
                          ground_clearance=tcfg.ground_clearance,
                          robot_height=tcfg.robot_height, security_distance=tcfg.security_distance)
    occ_t = gr.threshold_grid(grid, tcfg.lethal_threshold)
    fr = fx.extract_frontiers(spec, occ_t, upload(np.array([-5.0, -5.0], np.float32), dev),
                              spec.extent, max_cells=4096, max_frontiers=64, max_cluster_size=20,
                              min_cluster_size=2, cc_iters=48)
    occ = occ_t.cpu().numpy()
    known = occ != gr.UNKNOWN
    gt = list(lie.SE3(torch.stack([c.R for c in cams]), torch.stack([c.t for c in cams]))
              .matrix().cpu().numpy().astype(np.float64))
    ate = ate_world(slam.trajectory, gt)
    n_kf, n_lm, n_fr = int(slam.map.n_kf), int(slam.map.n_lm), int(fr.valid.sum())
    free = int((occ[known] == gr.FREE).sum())
    log(f"[9 rgbd] {W}x{H}, {cfg.orb.num_features} features, {cfg.orb.num_levels} levels, "
        f"{RGBD_FRAMES} frames of the arc through process_rgbd_frame: {RGBD_FRAMES / loop_s:.2f} "
        f"frames/s, {n_kf} keyframes, {n_lm} landmarks, ATE {ate:.4f} m, known "
        f"{known.mean():.4f}, {free} free cells, {n_fr} frontiers; K1 {n['describe'] / RGBD_FRAMES:.2f}"
        f" / K2 {n['top2'] / RGBD_FRAMES:.2f} launches a frame, host syncs a frame "
        f"{slam.host_syncs / RGBD_FRAMES:.2f}; phase {time.monotonic() - t_phase:.1f} s")
    if n["describe"] != RGBD_FRAMES or n["top2"] <= 0:
        raise AssertionError(f"[9 rgbd] kernel launches {n}: expected one describe a frame "
                             f"and some K2")
    if not (n_kf >= 4 and ate < 0.3 and n_lm > 200 and known.mean() > 0.05 and free > 50
            and n_fr >= 1):
        raise AssertionError("[9 rgbd] misses the bounds of tests/test_rgbd_e2e.py")
    return n


def loop_poses(dev):
    """The ring of LOOP_FRAMES poses (radius 8 m) and the re-entry overlap
    (bench_loop_slam: max(4, n // 25) frames of the start again)."""
    from fitslam_tpu_torch.data import synthetic
    from fitslam_tpu_torch.ops import lie

    ring = synthetic.loop_trajectory(LOOP_FRAMES, radius=8.0, device=dev)
    ov = max(4, LOOP_FRAMES // 25)
    return lie.SE3(torch.cat([ring.R, ring.R[:ov]]), torch.cat([ring.t, ring.t[:ov]]))


@contextmanager
def _stage_timers(spans):
    """Record CUDA events around every optimize_pose_graph and global_ba call
    (by wrapping the names loop_closing and slam_map call) that runs eagerly:
    the loop closer's and refine_map's calls before their regions capture
    (loop_closing.EAGER_CALLS, slam.REFINE_EAGER_CYCLES), which on phase 10's
    ring are all of them; a call under capture is not timed (phase 19 times
    replays). ``spans`` gets (stage, start event, end event, iterations) for
    each; read them after a synchronize."""
    from fitslam_tpu_torch.models import loop_closing, slam_map
    from fitslam_tpu_torch.ops import pgo

    real_pgo, real_gba = pgo.optimize_pose_graph, slam_map.global_ba

    def timed(stage, fn, iters_default):
        def wrapper(*args, **kwargs):
            if torch.cuda.is_current_stream_capturing():
                return fn(*args, **kwargs)       # a capture: its replays are not timed here
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans.append((stage, start, end, kwargs.get("iters", iters_default)))
            return out
        return wrapper

    pgo.optimize_pose_graph = timed("pgo", real_pgo, 12)
    slam_map.global_ba = timed("gba", real_gba, 8)
    try:
        yield
    finally:
        pgo.optimize_pose_graph, slam_map.global_ba = real_pgo, real_gba


def _span_ms(spans, stage):
    """(device ms an iteration, calls) of a stage's recorded spans."""
    got = [(s.elapsed_time(e), n) for st, s, e, n in spans if st == stage]
    if not got:
        return float("nan"), 0
    return sum(t for t, _ in got) / sum(n for _, n in got), len(got)


def _held_corrections(slam, held):
    """Wrap ``slam``'s loop closer so that ``held`` gets, once, the inputs of
    its first correction (copies of the map, the tracker state, the last
    frame and the closer's fields, taken just before the call; the call's
    keyframe, candidate and score) and its record."""
    from fitslam_tpu_torch.utils import jit

    closer = slam.loop_closer
    real = closer.on_keyframe
    fields = ("loop_edges", "_edge_table", "last_loop_kf", "_consist_cand", "_consist_count",
              "_last_gba_kf")

    def on_keyframe(engine, kf_idx, cand_idx=None, score=None):
        if "info" in held:
            return real(engine, kf_idx, cand_idx, score)
        before = dict(map=jit.clone(engine.map), state=jit.clone(engine.state),
                      frame=None if engine.last_frame is None else jit.clone(engine.last_frame),
                      closer={f: (list(v) if isinstance(v, list) else v)
                              for f, v in ((f, getattr(closer, f)) for f in fields)},
                      args=(kf_idx, cand_idx, score))
        info = real(engine, kf_idx, cand_idx, score)
        if info is not None:
            held.update(before, info=info)
        return info

    closer.on_keyframe = on_keyframe


def run_loop(dev, cfg, frames, gt, torch_syncs=None, refine=True, held=None):
    """bench_suite.ring_run (the loop_slam mode's run) on a fresh engine,
    with (``refine``) or without its refine_map(cycles=10, gba_iters=15),
    measured through its windows: K1/K2 launches, host syncs and peak memory
    from frame 0 to the last poll and, with ``torch_syncs`` (a Counter),
    torch's own count of synchronising calls in the timed frames and their
    call sites; PGO and GBA device time from their CUDA events. ``held``
    (a dict), where given, gets the first loop correction's inputs
    (``_held_corrections``)."""
    from fitslam_tpu_torch.models.slam import StereoSlam
    from fitslam_tpu_torch.utils import evaluation as ev

    slam = StereoSlam(cfg, dev)
    if held is not None:
        _held_corrections(slam, held)
    spans, tally, got = [], {"n": 0}, {}

    def window(name, step, fn):
        if name == "first":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            _reset_counts()
            out = fn()
            torch.cuda.synchronize()
            got["syncs0"] = slam.host_syncs
            return out
        guard = _torch_syncs(tally, "n", torch_syncs) if torch_syncs is not None else nullcontext()
        with guard:
            out = fn()
        torch.cuda.synchronize()
        got.update(launches=_counts(), syncs=slam.host_syncs - got["syncs0"],
                   run_peak=torch.cuda.max_memory_allocated(dev))
        return out

    with _stage_timers(spans):
        r = ring_run(slam, frames, gt, dev, refine_cycles=10 if refine else 0, window=window)
    n_total = len(frames)
    pgo_ms, n_pgo = _span_ms(spans, "pgo")
    gba_ms, n_gba = _span_ms(spans, "gba")
    return dict(
        slam=slam, fps=r["fps"], traj=r["trajectory"], launches=got["launches"],
        syncs=got["syncs"] / (n_total - 1), torch_syncs=tally["n"] / (n_total - 1),
        ate_uncorrected=r["ate_uncorrected"], ate_pre_refine=r["ate_pre_refine"], ate=r["ate"],
        ate_scale=ev.ate_rmse(slam.corrected_trajectory(), gt, with_scale=True),
        refine_s=r["refine_s"], loops=len(slam.loop_events), n_kf=int(slam.map.n_kf),
        events=[(e["loop_from"], e["loop_to"], e["inliers"], e["pgo_chi2"], e["gba_chi2"])
                for e in slam.loop_events],
        pgo_ms=pgo_ms, n_pgo=n_pgo, gba_ms=gba_ms, n_gba=n_gba,
        peak_gb=max(got["run_peak"], torch.cuda.max_memory_allocated(dev)) / 1e9,
        run_peak_gb=got["run_peak"] / 1e9)


def phase_loop(dev):
    """[10 loop]: bench_loop_slam's protocol on the port at full width, the
    ring worlds of seeds 1-3 (drawn by utils/prng.py) rendered on the card;
    seed 1 twice, which must repeat bit for bit (F17, F18)."""
    from fitslam_tpu_torch.data import synthetic
    from fitslam_tpu_torch.ops import lie
    from fitslam_tpu_torch.ops.geometry import Intrinsics
    from fitslam_tpu_torch.utils import prng

    t_phase = time.monotonic()
    cfg = loop_config(False)
    W, H = cfg.camera.width, cfg.camera.height
    K = Intrinsics.from_config(cfg.camera, dev)
    T_gt = loop_poses(dev)
    n_total = T_gt.t.shape[0]
    gt = list(T_gt.matrix().cpu().numpy().astype(np.float64))

    def render(seed, device, frames=None):
        Kd = Intrinsics.from_config(cfg.camera, device)
        world = synthetic.ring_world(prng.prng_key(seed), num=5000, radius=8.0, width=5.0,
                                     device=device).landmarks
        R, t = T_gt.R.to(device), T_gt.t.to(device)
        return [synthetic.render_stereo(Kd, world, lie.SE3(R[i], t[i]), width=W, height=H,
                                        max_depth=14.0)
                for i in (range(n_total) if frames is None else frames)]

    # F18: one ring frame rendered twice on the card and once on the CPU
    i_probe = [n_total // 3]
    (l1, r1), (l2, r2) = render(1, dev, i_probe)[0], render(1, dev, i_probe)[0]
    lc, rc = render(1, torch.device("cpu"), i_probe)[0]
    render_same = torch.equal(l1, l2) and torch.equal(r1, r2)
    render_cpu = torch.equal(l1.cpu(), lc) and torch.equal(r1.cpu(), rc)
    runs, warm = {}, None
    for seed in LOOP_SEEDS:
        frames = render(seed, dev)
        torch.cuda.synchronize()
        if seed == LOOP_SEEDS[0]:
            sites, held = Counter(), {}
            warm = run_loop(dev, cfg, frames, gt, torch_syncs=sites, held=held)
            warm["sites"] = sites
            runs[seed] = run_loop(dev, cfg, frames, gt)
        else:
            runs[seed] = run_loop(dev, cfg, frames, gt)
        del frames
    first, again = warm, runs[LOOP_SEEDS[0]]
    same_traj = len(first["traj"]) == len(again["traj"]) and all(
        np.array_equal(a, b) for a, b in zip(first["traj"], again["traj"]))
    same_events = first["events"] == again["events"]
    for seed, r in runs.items():
        ref = REFERENCE_LOOP[seed]
        log(f"[10 loop] seed {seed}: {LOOP_FRAMES}+{n_total - LOOP_FRAMES} frames {W}x{H}, "
            f"{r['fps']:.2f} frames/s (host clock), ATE uncorrected {r['ate_uncorrected']:.4f} / "
            f"pre-refine {r['ate_pre_refine']:.4f} / post-refine {r['ate']:.4f} m (Sim(3) "
            f"{r['ate_scale']:.4f}), {r['loops']} loops {[e[:3] for e in r['events']]}, "
            f"{r['n_kf']} keyframes, refine {r['refine_s']:.2f} s, host syncs a frame "
            f"{r['syncs']:.3f}, K2 {r['launches']['top2']} launches "
            f"({r['launches']['top2'] / n_total:.2f} a frame), K1 describe "
            f"{r['launches']['describe']}, PGO {r['pgo_ms']:.2f} ms an "
            f"iteration ({r['n_pgo']} eager calls), GBA {r['gba_ms']:.2f} ms an iteration "
            f"({r['n_gba']} eager calls, refine included), peak memory {r['run_peak_gb']:.2f} GB in the "
            f"frames, {r['peak_gb']:.2f} GB with the refine (reference, its own run: ATE "
            f"uncorrected {ref['ate_rmse_uncorrected_m']} / pre-refine "
            f"{ref['ate_rmse_pre_refine_m']} / post-refine {ref['ate_rmse_m']} m, "
            f"{ref['loops_closed']} loops, {ref['n_keyframes']} keyframes)")
    med = {k: float(np.median([r[k] for r in runs.values()]))
           for k in ("ate", "ate_uncorrected", "ate_pre_refine", "fps")}
    log(f"[10 loop] medians over seeds {list(runs)}: {med['fps']:.2f} frames/s, ATE post-refine "
        f"{med['ate']:.4f} m (max {max(r['ate'] for r in runs.values()):.4f}), pre-refine "
        f"{med['ate_pre_refine']:.4f}, uncorrected {med['ate_uncorrected']:.4f} (reference: 0.088 / "
        f"max 0.1714 / uncorrected 0.1571); seed {LOOP_SEEDS[0]} twice: trajectories bit-equal "
        f"{same_traj}, loop events identical {same_events}; first run's host syncs a frame: "
        f"engine {first['syncs']:.3f}, torch {first['torch_syncs']:.3f} "
        f"({dict(first['sites'].most_common(6))}); a ring frame rendered twice on the card "
        f"bit-equal {render_same}, equal to the CPU render {render_cpu}; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    if not all(r["loops"] >= 1 for r in runs.values()):
        raise AssertionError(f"[10 loop] a seed closed no loop: "
                             f"{ {s: r['loops'] for s, r in runs.items()} }")
    if not med["ate"] < med["ate_uncorrected"]:
        raise AssertionError("[10 loop] median post-refine ATE is not below the uncorrected one")
    if not (same_traj and same_events):
        raise AssertionError("[10 loop] seed 1's two runs differ")
    if not (render_same and render_cpu):
        raise AssertionError("[10 loop] the card's render does not repeat or differs from the CPU's")
    if any(r["launches"]["top2"] <= 0 or r["launches"]["describe"] != 2 * n_total
           for r in runs.values()):
        raise AssertionError("[10 loop] K1 / K2 launches on the path: "
                             f"{[r['launches'] for r in runs.values()]}")
    if "info" not in held:
        raise AssertionError("[10 loop] seed 1's first run closed no loop to hold")
    runs[LOOP_SEEDS[0]]["held"] = dict(held, cfg=cfg)
    return runs[LOOP_SEEDS[0]]


def phase_k2_verify(dev):
    """[10 K2 verify]: K2's ungated call of loop verification, (1024, 20480)
    with a sparse landmark mask of ~300 columns and a ragged shape, against
    its twin (tolerance 0), match_ratio_fused's selection on the card against
    the CPU's, and the call timed beside its bound and the bf16 product."""
    from fitslam_tpu_torch.ops import pallas_matching as pm

    out = {}
    for na, nb in LOOP_K2_SHAPES:
        p = _k2_problem(dev, na, nb)
        rng = np.random.RandomState(nb)
        mask = np.zeros(nb, bool)
        mask[rng.choice(nb, 300, replace=False)] = True
        p["valid_b"] = torch.as_tensor(mask, device=dev)
        args = (p["a_bits"], p["valid_a"], p["b_bits"], p["valid_b"])
        got = pm.hamming_top2(*args, pm.GATE_NONE)
        ref = pm.hamming_top2_plain(*args, pm.GATE_NONE)
        torch.cuda.synchronize()
        for f in pm.Top2._fields:
            if not torch.equal(getattr(got, f), getattr(ref, f)):
                raise AssertionError(f"[10 K2 verify] {f} differs from the twin at {na}x{nb}")
        mt = pm.match_ratio_fused(*args, max_distance=64, ratio=0.85, mutual=True)
        mc = pm.match_ratio_fused(*(a.cpu() for a in args), max_distance=64, ratio=0.85,
                                  mutual=True)
        for x, y in zip(mt, mc):
            if not torch.equal(x.cpu(), y):
                raise AssertionError(f"[10 K2 verify] match_ratio_fused differs from the "
                                     f"CPU's at {na}x{nb}")
        out[na, nb] = (p, int(mt.valid.sum()))
    p, n_ok = out[LOOP_K2_SHAPES[0]]
    args = (p["a_bits"], p["valid_a"], p["b_bits"], p["valid_b"])
    na, nb = LOOP_K2_SHAPES[0]
    k = cuda_time_ms(lambda: pm.hamming_top2(*args, pm.GATE_NONE))
    plain = cuda_time_ms(lambda: pm.hamming_top2_plain(*args, pm.GATE_NONE), reps=5)
    a_pm1 = pm._unpack_pm1(p["a_bits"]).to(torch.bfloat16)
    b_pm1 = pm._unpack_pm1(p["b_bits"]).to(torch.bfloat16).T.contiguous()
    lib = cuda_time_ms(lambda: torch.matmul(a_pm1, b_pm1))
    b = bound(k2_bytes(na, nb, pm.GATE_NONE), 2 * na * nb * 256, "int8")
    log(f"[10 K2 verify] none gate + mutual check at {', '.join(f'{a}x{c}' for a, c in LOOP_K2_SHAPES)} "
        f"with 300 valid columns: idx/best/second/col_best exactly equal to the twin, "
        f"match_ratio_fused's matches equal to the CPU's ({n_ok} kept at {na}x{nb}); "
        f"{_us(k)} (bound {b['bound_ms'] * 1e3:.2f} us, {b['bound_by']}), plain twin "
        f"{_us(plain)}, bf16 +-1 matmul {na}x256 @ 256x{nb} {_us(lib)}")
    return {"verify_ms": k[0], "verify_plain_ms": plain[0], "verify_bound_ms": b["bound_ms"],
            "verify_library_ms": lib[0], "verify_shape": f"none {na}x{nb}, 300 valid columns"}


def phase_atlas(dev):
    """[10 atlas]: tests/test_atlas.py's two scenarios through the
    synchronous StereoSlam on the card: a teleport without relocalization
    opens map 1; with it, the return re-locks map 0 within 0.5 m."""
    from fitslam_tpu_torch.data import synthetic
    from fitslam_tpu_torch.models.active_slam import camera_pose_from_robot
    from fitslam_tpu_torch.models.slam import StereoSlam
    from fitslam_tpu_torch.ops.geometry import Intrinsics
    from fitslam_tpu_torch.ops.grid import GridSpec2D
    from fitslam_tpu_torch.utils.config import FitSlamConfig

    spec = GridSpec2D(64, 0.25, -8.0, -8.0)
    W, H = 320, 240
    world = rooms_world(spec, dev, floor_points=4000).landmarks

    def cfg_of(reloc):
        cfg = FitSlamConfig()
        R = dataclasses.replace
        return R(cfg,
                 camera=R(cfg.camera, width=W, height=H, fx=200.0, fy=200.0, cx=W / 2,
                          cy=H / 2, baseline=0.2),
                 orb=R(cfg.orb, num_features=320, num_levels=2, fast_threshold=12.0),
                 tracking=R(cfg.tracking, min_inliers=10, keyframe_min_interval=2,
                            keyframe_translation=0.25, reinit_after_lost=3,
                            reloc_enabled=reloc, reloc_after_lost=1, reloc_min_inliers=15),
                 mapping=R(cfg.mapping, max_keyframes=24, max_landmarks=2048,
                           max_observations=6144, local_window=4, ba_iters=2),
                 loop=R(cfg.loop, enabled=False))

    def step(slam, K, x, y, yaw):
        cam = camera_pose_from_robot(x, y, yaw, device=dev)
        left, right = synthetic.render_stereo(K, world, cam, width=W, height=H, max_depth=12.0)
        return slam.process_frame(left, right)

    def creep(slam, K):
        x, y, yaw = -5.0, -5.0, 0.3
        for _ in range(8):
            step(slam, K, x, y, yaw)
            x += 0.15 * math.cos(yaw)
            y += 0.15 * math.sin(yaw)

    cfg = cfg_of(False)
    K = Intrinsics.from_config(cfg.camera, dev)
    slam = StereoSlam(cfg, dev)
    creep(slam, K)
    first_max = int(slam.map.kf_map_id.max())
    for i in range(8):
        step(slam, K, 5.0 + 0.1 * i, 5.0, -2.6)
    ids = slam.map.kf_map_id[slam.map.kf_valid]
    teleport = (first_max, int(ids.max()), int(slam.state.map_id))

    cfg = cfg_of(True)
    slam = StereoSlam(cfg, dev)
    creep(slam, K)
    for i in range(6):
        step(slam, K, 5.0 + 0.1 * i, 5.0, -2.6)
    kidnap_map = int(slam.state.map_id)
    back = [step(slam, K, -5.0, -5.0, 0.3) for _ in range(5)]
    T = slam.current_pose_wc.matrix().cpu().numpy()
    anchor = camera_pose_from_robot(-5.0, -5.0, 0.3, device=dev).matrix().cpu().numpy()
    err = float(np.linalg.norm((anchor @ T)[:2, 3] - np.array([-5.0, -5.0])))
    relocked = [bool(b.get("relocalized")) for b in back]
    log(f"[10 atlas] teleport without relocalization: map ids {teleport[0]} before, up to "
        f"{teleport[1]} after, tracker on map {teleport[2]}; with relocalization: kidnap "
        f"opened map {kidnap_map}, relocalized on return frames {relocked}, tracker on map "
        f"{int(slam.state.map_id)}, last frame {back[-1]['n_inliers']} inliers, position error "
        f"{err:.3f} m (bound 0.5 m)")
    if not (teleport[0] == 0 and teleport[1] >= 1 and teleport[2] >= 1):
        raise AssertionError("[10 atlas] the teleport did not open a new map")
    if not (kidnap_map >= 1 and any(relocked) and int(slam.state.map_id) == 0
            and back[-1]["n_inliers"] >= 15 and err < 0.5):
        raise AssertionError("[10 atlas] relocalization did not re-lock map 0 within 0.5 m")


def phase_ba(dev, loop_run):
    """[10 BA]: global_ba on the loop run's map at bench capacity twice
    (bit-equal), timed with its peak memory; bundle_adjust on the card
    beside the CPU on a small planted problem."""
    from fitslam_tpu_torch.models import slam_map as sm
    from fitslam_tpu_torch.ops import ba, lie

    slam = loop_run["slam"]
    m, K = slam.map, slam.K
    outs = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        out, stats = sm.global_ba(m, K, iters=BA_ITERS)
        torch.cuda.synchronize()
        outs.append((out, stats, (torch.cuda.max_memory_allocated(dev) - base) / 1e9))
    (a, sa, peak), (b, sb, _) = outs
    same = all(torch.equal(x, y) for x, y in ((a.kf_T_cw.R, b.kf_T_cw.R), (a.kf_T_cw.t, b.kf_T_cw.t),
                                               (a.lm_pos, b.lm_pos), (sa.chi2, sb.chi2)))
    t = cuda_time_ms(lambda: sm.global_ba(m, K, iters=BA_ITERS), reps=3, warmup=1)
    # small planted problem: 6 keyframes x 300 landmarks, made with numpy
    rng = np.random.RandomState(7)
    n_kf, n_lm = 6, 300
    pts = np.stack([rng.uniform(-4, 4, n_lm), rng.uniform(-2, 2, n_lm),
                    rng.uniform(4, 12, n_lm)], -1).astype(np.float32)
    xi = np.concatenate([np.stack([0.3 * np.arange(n_kf), 0.05 * np.arange(n_kf),
                                   np.zeros(n_kf)], -1), np.zeros((n_kf, 3))], -1)
    T_true = lie.se3_exp(torch.tensor(xi, dtype=torch.float32))
    kf = np.repeat(np.arange(n_kf), n_lm)
    lm = np.tile(np.arange(n_lm), n_kf)
    pc = (T_true.R.numpy()[kf] @ pts[lm][..., None])[..., 0] + T_true.t.numpy()[kf]
    u = 400 * pc[:, 0] / pc[:, 2] + 320
    v = 400 * pc[:, 1] / pc[:, 2] + 240
    uvr = (np.stack([u, v, u - 80.0 / pc[:, 2]], -1)
           + rng.normal(scale=0.5, size=(len(kf), 3))).astype(np.float32)
    T0 = lie.compose(lie.se3_exp(torch.tensor(rng.normal(scale=0.02, size=(n_kf, 6)),
                                              dtype=torch.float32)), T_true)
    pts0 = pts + rng.normal(scale=0.05, size=pts.shape).astype(np.float32)

    def solve(d):
        obs = ba.Observations(torch.tensor(kf, dtype=torch.int32, device=d),
                              torch.tensor(lm, dtype=torch.int32, device=d),
                              torch.tensor(uvr, device=d), torch.ones(len(kf), device=d),
                              torch.ones(len(kf), dtype=torch.bool, device=d))
        prob = ba.BAProblem(lie.SE3(T0.R.to(d), T0.t.to(d)), torch.tensor(pts0, device=d), obs,
                            torch.arange(n_kf, device=d) == 0,
                            torch.zeros(n_lm, dtype=torch.bool, device=d))
        Kd = type(K)(*(x.to(d) for x in K))
        return ba.bundle_adjust(Kd, prob, iters=6)[0]

    pc_out, pg_out, pg_again = solve(torch.device("cpu")), solve(dev), solve(dev)
    dpose = float((pg_out.T_cw.t.cpu() - pc_out.T_cw.t).abs().max())
    dpt = float((pg_out.points.cpu() - pc_out.points).abs().max())
    small_same = torch.equal(pg_out.T_cw.t, pg_again.T_cw.t) and torch.equal(pg_out.points,
                                                                             pg_again.points)
    n_kf_map, n_lm_map = int(m.n_kf), int(m.n_lm)
    log(f"[10 BA] global_ba at {tuple(m.kf_valid.shape)[0]} keyframes x {m.lm_valid.shape[0]} "
        f"landmarks ({n_kf_map} / {n_lm_map} in use), {BA_ITERS} iterations: two calls "
        f"bit-equal {same}, {t[0]:.2f} ms device ({t[0] / BA_ITERS:.2f} ms an iteration), peak "
        f"memory {peak:.2f} GB above the map; bundle_adjust 6 keyframes x {n_lm} landmarks: two "
        f"card calls bit-equal {small_same}, card vs CPU max |d t| {dpose:.2e} m, max |d point| "
        f"{dpt:.2e} m (tolerance {BA_CPU_TOL}: float32 LU solves and products of another "
        f"order)")
    if not (same and small_same):
        raise AssertionError("[10 BA] BA on the card does not repeat")
    if not (dpose < BA_CPU_TOL[0] and dpt < BA_CPU_TOL[1]):
        raise AssertionError("[10 BA] BA on the card differs from the CPU's")



# ---------------------------------------------------------------------------
# Phases 11-12: recorded datasets through the native runtime, and the EKF
# ---------------------------------------------------------------------------


def tum_config():
    """tests/test_dataset_external.py's configuration, unchanged:
    relocalization on, loop closing off."""
    from fitslam_tpu_torch.utils.config import FitSlamConfig

    cfg = FitSlamConfig()
    R = dataclasses.replace
    return R(cfg,
             camera=R(cfg.camera, width=320, height=240, fx=200.0, fy=200.0, cx=160.0,
                      cy=120.0, baseline=0.2, rgbd=True, depth_max=14.0),
             orb=R(cfg.orb, num_features=512, num_levels=3, fast_threshold=10.0),
             tracking=R(cfg.tracking, min_inliers=10, keyframe_min_interval=2,
                        keyframe_translation=0.3),
             mapping=R(cfg.mapping, max_keyframes=64, max_landmarks=4096,
                       max_observations=12288, local_window=4, ba_iters=3),
             loop=R(cfg.loop, enabled=False))


def phase_dataset(dev):
    """The golden corridor_seq through the port's native reader (byte-equal
    to read_pgm, and the reader's own frames/s), ``run_dataset.replay`` in
    this process (the path's launches) and ``python -m
    fitslam_tpu_torch.run_dataset`` as a subprocess on the card (exit 0,
    ATE within the golden bound, an events.csv of more than 10 rows), then
    the committed indoor_tum through TumRgbdSequence and process_rgbd_frame
    held to tests/test_dataset_external.py's bounds. Returns the launches of
    the replay and of the indoor_tum run."""
    import re

    from fitslam_tpu_torch import run_dataset
    from fitslam_tpu_torch.data import tum
    from fitslam_tpu_torch.models.slam import StereoSlam
    from fitslam_tpu_torch.runtime.native import PgmSequenceReader
    from fitslam_tpu_torch.utils import evaluation as ev

    t_phase = time.monotonic()
    seq = run_dataset.DEFAULT_SEQUENCE
    read_s, n_read = 0.0, 0
    for eye in ("left", "right"):
        files = sorted((seq / eye).glob("*.pgm"))
        reader = PgmSequenceReader(seq / eye, prefetch=8)
        t0 = time.perf_counter()
        got = list(reader)
        read_s += time.perf_counter() - t0
        reader.close()
        n_read += len(got)
        if len(got) != len(files) or not all(np.array_equal(g, tum.read_pgm(f))
                                              for g, f in zip(got, files)):
            raise AssertionError(f"[11 dataset] the native reader's {eye} frames differ from "
                                 f"read_pgm's")
    # in process: the path's launches and host syncs
    _reset_counts()
    rep = run_dataset.replay(seq, run_dataset.dataset_config(), device=dev)
    n_ds = _counts()
    # the entry point a user runs, on the card by default
    (seq / "events.csv").unlink(missing_ok=True)
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", "fitslam_tpu_torch.run_dataset"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    sub_s = time.monotonic() - t0
    m = re.search(r"ATE RMSE = ([0-9.]+) cm", proc.stdout)
    fps = re.search(r"throughput = ([0-9.]+) frames/s", proc.stdout)
    rows = (seq / "events.csv").read_text().strip().splitlines() if (seq / "events.csv").exists() \
        else []
    if proc.returncode != 0 or m is None:
        raise AssertionError(f"[11 dataset] run_dataset exited {proc.returncode}:\n"
                             f"{proc.stdout}\n{proc.stderr}")
    sub_ate = float(m.group(1)) / 100
    # indoor_tum through the RGB-D step
    cfg = tum_config()
    frames = [(torch.from_numpy(f.gray).to(dev), torch.from_numpy(f.depth).to(dev), f.T_wc)
              for f in tum.TumRgbdSequence(ROOT / "tests" / "data" / "indoor_tum")]
    slam = StereoSlam(cfg, dev)
    relocalized = lost = 0
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for gray, depth, _ in frames:
        info = slam.process_rgbd_frame(gray, depth)
        relocalized += bool(info.get("relocalized"))
        lost += bool(info["lost"])
    torch.cuda.synchronize()
    tum_s = time.perf_counter() - t0
    n_tum = _counts()
    ate = ev.ate_rmse(slam.trajectory, [T for _, _, T in frames])
    n_kf, nf = int(slam.map.n_kf), len(frames)
    log(f"[11 dataset] native reader: corridor_seq's {n_read} frames byte-equal to read_pgm, "
        f"{n_read / read_s:.1f} frames/s read alone (prefetch 8); replay in process "
        f"(run_dataset.replay, 320x240): {rep['frames']} frames, {rep['fps']:.2f} frames/s, ATE "
        f"{rep['ate']:.4f} m, {rep['keyframes']} keyframes, {rep['host_syncs'] / rep['frames']:.2f}"
        f" host syncs a frame, K1 {n_ds['describe'] / rep['frames']:.2f} / K2 "
        f"{n_ds['top2'] / rep['frames']:.2f} launches a frame; python -m "
        f"fitslam_tpu_torch.run_dataset: exit {proc.returncode}, ATE {sub_ate:.4f} m, "
        f"{fps.group(1) if fps else '?'} frames/s, events.csv {len(rows) - 1} spans, "
        f"{sub_s:.1f} s with the interpreter's start; indoor_tum ({nf} RGB-D frames, "
        f"relocalization on): ATE {ate:.4f} m, {n_kf} keyframes (reference golden 0.063 m, 18 "
        f"keyframes), {nf / tum_s:.2f} frames/s, {slam.host_syncs / nf:.2f} host syncs a frame, "
        f"K1 {n_tum['describe'] / nf:.2f} / K2 {n_tum['top2'] / nf:.2f} launches a frame, {lost} "
        f"frames lost, {relocalized} relocalized; phase {time.monotonic() - t_phase:.1f} s")
    if not (rep["ate"] <= ATE_BOUND_M and sub_ate <= ATE_BOUND_M and len(rows) > 10):
        raise AssertionError(f"[11 dataset] replay ATE {rep['ate']} / {sub_ate} m (bound "
                             f"{ATE_BOUND_M}), {len(rows)} rows in events.csv")
    if n_ds["describe"] != 2 * rep["frames"] or n_ds["top2"] <= 0:
        raise AssertionError(f"[11 dataset] kernel launches {n_ds}")
    if not (ate <= TUM_ATE_BOUND_M and TUM_KF_RANGE[0] <= n_kf <= TUM_KF_RANGE[1]):
        raise AssertionError(f"[11 dataset] indoor_tum ATE {ate} m, {n_kf} keyframes: outside "
                             f"tests/test_dataset_external.py's bounds")
    if n_tum["describe"] != nf or n_tum["top2"] <= 0:
        raise AssertionError(f"[11 dataset] indoor_tum kernel launches {n_tum}")
    return n_ds, n_tum


def ekf_config():
    """Phase 8's active cell with the EKF layer on."""
    cfg = active_config(640, 480, 1024, 4, fx=0.625 * 640)
    return dataclasses.replace(cfg, localization=dataclasses.replace(cfg.localization,
                                                                     enabled=True))


def ekf_flush_cost(dev):
    """(device ms, kernel launches, host wall ms) of one flush of a frame's
    rows (odometry and IMU rates for both filters, a SLAM pose for the map
    filter): two windows of WINDOW_CAP rows."""
    from fitslam_tpu_torch.models.localization import DualEkf

    dual = DualEkf(device=dev)

    def one_flush():
        dual.add_odom(0.5, 0.0, 0.15)
        dual.add_imu(0.0, 0.0, 0.1, 0.0, gate=0.8)
        dual.add_pose(0.0, 0.0, 0.0, gate=3.0)
        dual.flush()

    dev_ms, launches = kernel_sum(one_flush, reps=2)
    return dev_ms, launches, cuda_time_ms(one_flush, reps=5, warmup=1)[1]


def ekf_window_work(T: int):
    """(bytes, float32 operations) of one EKF window of T rows: x, P, Q and
    the (T, 47) rows read, x and P written; a row's predict (F x, (F P) F^T,
    Q dt) and update (two 15x15 LUs, the solves of S and of S^T's 15
    right-hand sides, the gate, K, K innov and the Joseph form's three
    products), at two operations a multiply-add."""
    n = 15
    n_bytes = 4 * (2 * (n + n * n) + n * n + T * (3 * n + 2))
    predict = 2 * n * n + 2 * (2 * n ** 3) + 2 * n * n
    update = (2 * (2 * n ** 3 // 3) + 2 * n * n + 2 * n ** 3 + 2 * n + n * n + 2 * n * n
              + 3 * (2 * n ** 3) + 2 * n * n)
    return n_bytes, T * (predict + update)


def ekf_window_vs_twin(dev, reps: int = 50):
    """The EKF window kernel beside its plain twin on the card, at a flush's
    map-filter window (odometry, IMU rates and a gated SLAM pose, then
    filler to WINDOW_CAP rows) from a state mid-mission: the largest |x| and
    |P| differences of one window, the device ms a window of the kernel's
    one-node graph and of the twin's captured graph (``run_ekf`` as the
    parent ran it), the twin graph's kernels and the window's bound from
    ``ekf_window_work``: the kernels line's entry. Raises if x differs by
    more than 1e-5 or P by more than rtol 1e-5 / atol 1e-6."""
    from fitslam_tpu_torch.models import localization as loc
    from fitslam_tpu_torch.ops import ekf_window as ew

    x0 = np.zeros(loc.STATE_DIM, np.float32)
    x0[[loc.X, loc.Y, loc.YAW, loc.VX, loc.WZ]] = [-4.2, -4.6, 3.05, 0.4, 0.3]
    st = loc.initial_state(x0, device="cpu")
    P0 = (st.P + 0.01 * torch.eye(loc.STATE_DIM)).numpy()
    rows = loc.rows_array([loc.sensor_row(loc.ODOM_MASK, np.array([0.41, 0.0]), np.full(2, 0.01),
                                          0.15),
                           loc.sensor_row(loc.IMU_MASK, np.array([0.0, 0.0, 0.28]),
                                          np.full(3, 0.005), 0.0),
                           loc.sensor_row(loc.POSE_MASK, np.array([-4.15, -4.58, -3.12]),
                                          np.full(3, 0.02), 0.0, 3.0)],
                          loc.DualEkf.WINDOW_CAP)
    Q = loc.default_process_noise(dev)
    r = torch.tensor(rows, device=dev)

    def fresh():
        return loc.EkfState(torch.tensor(x0, device=dev), torch.tensor(P0, device=dev))

    def captured(fn, *args):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*args)                                # the twin's solver handles and workspaces
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = fn(*args)
        return g, out

    kernel_state = fresh()
    ew.ekf_window(kernel_state, r, Q)
    twin_in = fresh()
    twin_graph, (twin_out, _) = captured(lambda s: loc.run_ekf(s, loc.batch_from_array(r), Q),
                                         twin_in)
    twin_graph.replay()
    torch.cuda.synchronize()
    dx = float((kernel_state.x - twin_out.x).abs().max())
    dP = (kernel_state.P - twin_out.P).abs()
    p_ok = bool((dP <= 1e-6 + 1e-5 * twin_out.P.abs()).all())
    kernel_graph, _ = captured(ew.ekf_window, fresh(), r, Q)
    kernel_us = cuda_time_ms(kernel_graph.replay, reps=reps)[0] * 1e3
    twin_us = cuda_time_ms(twin_graph.replay, reps=max(5, reps // 10))[0] * 1e3
    _, twin_kernels = kernel_sum(twin_graph.replay, reps=1)
    T = loc.DualEkf.WINDOW_CAP
    n_bytes, n_ops = ekf_window_work(T)
    b = bound(n_bytes, n_ops, "f32")
    log(f"[12 ekf window] the kernel beside its twin on the card, one {T}-row "
        f"window: max |dx| {dx:.3g}, max |dP| {float(dP.max()):.3g} (P within rtol 1e-5 / atol "
        f"1e-6: {p_ok}); device us a window: kernel {kernel_us:.1f} (one-node graph), twin's "
        f"captured graph {twin_us:.1f} ({twin_kernels:.0f} kernels), {twin_us / kernel_us:.1f}x; "
        f"bound {b['bound_ms'] * 1e3:.3f} us ({b['bound_by']}: {n_ops / 1e6:.3f} MFLOP, "
        f"{n_bytes / 1e3:.1f} KB)")
    if not (dx <= 1e-5 and p_ok):
        raise AssertionError("[12 ekf window] the kernel and its twin differ on the card")
    return {"max_abs_err": max(dx, float(dP.max())), "ms": kernel_us / 1e3,
            "plain_ms": twin_us / 1e3, **b, "library_ms": None,
            "library_call": "none: no PyTorch call computes an EKF window",
            "shape": f"one window, {T} x {ew.ROW_WIDTH} rows",
            "plain_kernels": twin_kernels}


def ekf_dropout(dev, cfg, spec, landmarks):
    """tests/test_ekf_integration.py's dropout at full width: 12 frames
    driving straight, then 15 controller steps with no frame. Returns (error
    before, error after, distance the estimate moved)."""
    from fitslam_tpu_torch.data import synthetic
    from fitslam_tpu_torch.models import sim_robot as sim
    from fitslam_tpu_torch.models.active_slam import ActiveSlamSystem, camera_pose_from_robot
    from fitslam_tpu_torch.models.localization import TwistMux
    from fitslam_tpu_torch.models.sim_nav import SimNavInterface
    from fitslam_tpu_torch.ops.geometry import Intrinsics

    W, H = cfg.camera.width, cfg.camera.height
    K = Intrinsics.from_config(cfg.camera, dev)
    robot = sim.DiffDriveRobot(x=-5.0, y=-5.0, yaw=0.2, v_max=0.8, w_max=1.0)
    box = {}
    nav = SimNavInterface(cfg, spec, robot, lambda: box["s"].occupancy(), dt=0.15,
                          twist_mux=TwistMux(), device=dev)
    system = ActiveSlamSystem(cfg, spec, nav, device=dev,
                              get_robot_pose=lambda: box["s"].estimated_robot_pose())
    box["s"] = system
    for step in range(12):
        cam = camera_pose_from_robot(robot.x, robot.y, robot.yaw, device=dev)
        if step == 0:
            system.set_world_anchor(cam)
        left, right = synthetic.render_stereo(K, landmarks, cam, width=W, height=H,
                                              max_depth=12.0)
        system.process_frame(left, right)
        nav.drive_open_loop(0.5, 0.0)
    xy0, _ = system.estimated_robot_pose()
    err0 = float(np.linalg.norm(xy0 - robot.xy))
    for _ in range(15):
        nav.drive_open_loop(0.5, 0.05)
    xy1, _ = system.estimated_robot_pose()
    return err0, float(np.linalg.norm(xy1 - robot.xy)), float(np.linalg.norm(xy1 - xy0))


def phase_ekf(dev, active):
    """Phase 8's active cell (bench_active_slam at full width, ACTIVE_BENCH_FRAMES
    frames) with the EKF on, the robot's pose read from its estimate and the
    nav layer's twists through a TwistMux, once (phase 18 runs this cell three
    more times and holds them bit-equal), held to tests/test_ekf_integration.py's
    bounds and the active e2e bounds that apply at frame 80; then the dropout
    sub-run. Host
    ms a frame / tick / controller step stand beside phase 8's run of this
    call (``active``). Raises unless the EKF window kernel's launches over
    the run equal the windows the run's DualEkf fused. Returns the first
    run's launches and the kernels line's EKF window entry."""
    from fitslam_tpu_torch.models.localization import TwistMux
    from fitslam_tpu_torch.ops import grid as gr
    from fitslam_tpu_torch.ops.grid import GridSpec2D

    t_phase = time.monotonic()
    spec = GridSpec2D(64, 0.25, -8.0, -8.0)
    cfg = ekf_config()
    world = rooms_world(spec, dev, floor_points=4000)
    r = run_active(dev, cfg, spec, world.landmarks, (-5.0, -5.0, 0.3), ACTIVE_BENCH_FRAMES,
                   twist_mux=TwistMux())
    system = r["system"]
    est = np.array([np.array([xy[0], xy[1], yaw]) for xy, yaw in r["ekf"]])
    errs = np.linalg.norm(est[:, :2] - r["truth"][:, :2], axis=1)
    dyaw = abs((est[-1, 2] - r["truth"][-1, 2] + math.pi) % (2 * math.pi) - math.pi)
    err0, err1, moved = ekf_dropout(dev, cfg, spec, world.landmarks)
    ekfw = ekf_window_vs_twin(dev)
    flush_ms, flush_n, flush_wall = ekf_flush_cost(dev)
    known = r["occ"] != gr.UNKNOWN
    d = system.explorer.diag
    ekf = system.ekf
    reloc = sum(bool(i.get("relocalized")) for i in r["infos"])
    lost = sum(bool(i.get("lost")) for i in r["infos"])
    a = active
    log(f"[12 ekf] phase 8's cell with the EKF on ({cfg.camera.width}x{cfg.camera.height}, "
        f"{ACTIVE_BENCH_FRAMES} frames, TwistMux, the robot's pose from the EKF): mean EKF pose "
        f"error from frame 5 {errs[5:].mean():.4f} m (max {errs.max():.4f}), final yaw error "
        f"{dyaw:.4f} rad; {r['n_kf']} keyframes, ATE {r['ate']:.4f} m, coverage "
        f"{known.mean():.4f}, {d.goals_sent} goals; dropout (12 frames, 15 steps without): error {err0:.4f} -> {err1:.4f} m, the "
        f"estimate moved {moved:.3f} m; {ekf.flushes} flushes ({ekf.flushes / r['ctrl_n']:.2f} a "
        f"controller step, {r['ekf_windows']} windows of {ekf.WINDOW_CAP} rows in the run, "
        f"{r['launches']['ekf']} EKF window kernel launches), one flush of a frame's "
        f"rows (2 filters x {ekf.WINDOW_CAP} rows): {flush_n:.0f} kernel launches, "
        f"{flush_ms * 1e3:.1f} us device, {flush_wall:.2f} ms host wall; estimate read a frame "
        f"{_per(r, 'pose', 's') * 1e3:.2f} ms host, {_per(r, 'pose', 'syncs'):.3f} host syncs; "
        f"{lost} frames lost, {reloc} relocalized; {_window_line(r)}; phase 8 in this call "
        f"(EKF off): host ms a frame {_per(a, 'frame', 's') * 1e3:.1f}, a tick "
        f"{_per(a, 'tick', 's') * 1e3:.1f}, a controller step {_per(a, 'ctrl', 's') * 1e3:.2f}, "
        f"host syncs a controller step {_per(a, 'ctrl', 'syncs'):.3f}; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    _check_windows(r, "[12 ekf]")
    if not r["launches"]["ekf"] == r["ekf_windows"] > 0:
        raise AssertionError(f"[12 ekf] {r['launches']['ekf']} EKF window kernel launches for "
                             f"{r['ekf_windows']} windows fused")
    if not (errs[5:].mean() < 0.30 and dyaw < 0.3):
        raise AssertionError("[12 ekf] misses tests/test_ekf_integration.py's tracking bounds")
    if not (err1 < err0 + 0.35 and moved > 0.5):
        raise AssertionError("[12 ekf] misses tests/test_ekf_integration.py's dropout bounds")
    if not (r["n_kf"] >= 5 and r["ate"] < 0.5 and d.goals_sent >= 1):
        raise AssertionError("[12 ekf] misses tests/test_active_slam_e2e.py's bounds at frame 80")
    return r["launches"], ekfw


# ---------------------------------------------------------------------------
# Phase 13: the multi-robot fleet
# ---------------------------------------------------------------------------


class _Windows:
    """A run's timer hook: each window (a coordinator tick, a rover's frame,
    tick or controller step) between two synchronizes, with its calls, host
    seconds, torch's count of host syncs (with the CUDA-event waits it does
    not report) and kernel launches, keyed ``window`` or ``window<rover>``."""

    def __init__(self):
        self.r = Counter()
        self.sites = Counter()

    @contextmanager
    def __call__(self, window, rover=None):
        key = window if rover is None else f"{window}{rover}"
        torch.cuda.synchronize()
        launches, t0 = _counts(), time.perf_counter()
        with _torch_syncs(self.r, f"{key}_torch_syncs", self.sites):
            yield
        torch.cuda.synchronize()
        self.r[f"{key}_s"] += time.perf_counter() - t0
        self.r[f"{key}_n"] += 1
        for k, v in _counts().items():
            self.r[f"{key}_{k}"] += v - launches[k]

    def per(self, key, what):
        return self.r[f"{key}_{what}"] / max(self.r[f"{key}_n"], 1)


@contextmanager
def _recorded_allocations(calls: list):
    """Keep every TaskAllocator call's cost matrix and assignment made inside
    the block."""
    from fitslam_tpu_torch.models import allocation as al

    real = al.TaskAllocator.allocate

    def allocate(alloc, cost, fxy, peer_goals=None):
        a = real(alloc, cost, fxy, peer_goals)
        calls.append((np.array(cost, np.float32), np.asarray(a).astype(np.int64)))
        return a

    al.TaskAllocator.allocate = allocate
    try:
        yield
    finally:
        al.TaskAllocator.allocate = real


def auction_check(dev, capture=None, regions=None):
    """The auction alone on AUCTION_PROBLEMS random problems on the card
    (half with uniform costs and forbidden entries, half with every row
    preferring the same columns), each against hungarian_assign's optimum
    within R * eps: (rounds, syncs, host ms, gap, R eps, assignment) of each
    solve. With ``capture`` (True or False) the solves run through a
    ``TaskAllocator(capture=capture)``'s state, else eagerly without one;
    ``regions`` (a dict), where given, gets that allocator's region stats."""
    from fitslam_tpu_torch.models import allocation as al
    from fitslam_tpu_torch.utils.transfer import upload

    R, F = AUCTION_SHAPE
    owner = None if capture is None else al.TaskAllocator("auction", device=dev, capture=capture)
    state = None if owner is None else owner.slot_state(R, F)
    out = []
    for seed in range(AUCTION_PROBLEMS):
        rng = np.random.RandomState(1000 + seed)
        cost = rng.uniform(0, 10, (R, F))
        if seed % 2:
            cost = np.linspace(0, 10, F)[None, :] + cost / 20
        cost = cost.astype(np.float32)
        cost[rng.rand(R, F) < 0.2] = al.BIG
        feasible = cost < al.BIG / 2
        eps = max(float(cost[feasible].max() - cost[feasible].min()), 1e-3) / (4 * F)
        dev_cost = upload(cost, dev)
        torch.cuda.synchronize()
        stats, t0 = {}, time.perf_counter()
        a = al.auction_assign(dev_cost, stats=stats, state=state).cpu().numpy()
        ms = (time.perf_counter() - t0) * 1e3
        h = al.hungarian_assign(cost)
        got = float(cost.astype(np.float64)[np.arange(R), a].sum())
        opt = float(cost.astype(np.float64)[np.arange(R), h].sum())
        if (a < 0).any() or len(set(a.tolist())) != R or not feasible[np.arange(R), a].all():
            raise AssertionError(f"[13 fleet] auction problem {seed}: not a full assignment {a}")
        if not got <= opt + R * eps + 1e-3:
            raise AssertionError(f"[13 fleet] auction problem {seed}: {got} against the "
                                 f"optimum {opt} + R eps {R * eps}")
        out.append((stats["rounds"], stats["syncs"] + 1, ms, got - opt, R * eps, a))
    if regions is not None and owner is not None:
        regions.update(owner.capture_stats)
    return out


def phase_fleet(dev):
    """examples/run_multirobot.py's fleet through the port's entry point:
    tests/test_allocation.py's two-rover runs (hungarian, minpos; 80 of its
    120 steps) and four rovers for 60 steps (hungarian, and the auction
    through the config), each beside the same run's first FLEET_PARITY_TICKS ticks on
    the CPU (cost matrices and assignments equal); then the auction alone.
    Returns the kernels' launches over the card's fleet runs."""
    from fitslam_tpu_torch import run_multirobot as rm
    from fitslam_tpu_torch.models import allocation as al
    from fitslam_tpu_torch.ops.grid import UNKNOWN
    from fitslam_tpu_torch.utils.evaluation import path_length

    t_phase = time.monotonic()
    launches = Counter()
    for method, n_rob, steps in FLEET_RUNS:
        t_run = time.monotonic()
        calls, cpu_calls, win = [], [], _Windows()
        _reset_counts()
        with _recorded_allocations(calls):
            r = rm.run(n_rob, steps, method, seed=2, device=dev, timer=win, verbose=False)
        launches.update(_counts())
        with _recorded_allocations(cpu_calls):
            rm.run(n_rob, FLEET_PARITY_TICKS * rm.TICK_EVERY, method, seed=2, device="cpu",
                   verbose=False)
        n_par = min(FLEET_PARITY_TICKS, len(calls), len(cpu_calls))
        same = [np.array_equal(calls[k][0], cpu_calls[k][0])
                and np.array_equal(calls[k][1], cpu_calls[k][1]) for k in range(n_par)]
        gap = max(float(np.abs(calls[k][0] - cpu_calls[k][0]).max()) for k in range(n_par))
        coord, navs = r["coord"], r["navs"]
        cov = r["coverage"]
        moved = [float(np.ptp(np.array([(x, y) for x, y, _ in rb.trajectory]), axis=0).sum())
                 for rb in r["robots"]]
        paths = [path_length(np.array([(x, y, 0.0) for x, y, _ in rb.trajectory]))
                 for rb in r["robots"]]
        rounds = coord.allocator.auction_rounds
        nav_syncs = sum(nv.host_syncs for nv in navs)
        plans = sum(nv.plans for nv in navs)
        log(f"[13 fleet] {n_rob} rovers, {method}, rooms seed 2, {r['steps']} of {steps} steps, "
            f"{coord.ticks} ticks: final coverage {cov[-1]:.4f} ({(r['explored'] != UNKNOWN).mean():.4f} "
            f"known), path lengths {' / '.join(f'{x:.1f}' for x in paths)} m; host ms a tick "
            f"{win.per('tick', 's') * 1e3:.2f}, a step's controller steps "
            f"{win.per('ctrl', 's') * 1e3:.2f}; host syncs a tick {coord.host_syncs / max(coord.ticks, 1):.2f} "
            f"(torch {win.per('tick', 'torch_syncs'):.2f}), a controller step "
            f"{nav_syncs / max(win.r['ctrl_n'] * n_rob * rm.NAV_STEPS, 1):.3f} (torch "
            f"{win.r['ctrl_torch_syncs'] / max(win.r['ctrl_n'] * n_rob * rm.NAV_STEPS, 1):.3f}); "
            f"K3 {win.per('tick', 'sweep'):.2f} launches a tick and {win.r['ctrl_sweep']} in "
            f"{plans} plans"
            + (f"; auction {np.mean(rounds):.1f} rounds a solve (max {max(rounds)}), "
               f"{coord.allocator.host_syncs / len(rounds):.2f} host syncs a solve (a read "
               f"a chunk of {al.AUCTION_CHUNK} rounds, then the result's)" if rounds else "")
            + f"; card vs CPU over the first {n_par} ticks: cost matrices and assignments "
            f"equal {all(same)} (largest cost gap {gap}), assignments "
            + " ".join("/".join(str(int(j)) for j in calls[k][1]) for k in range(n_par))
            + f"; {time.monotonic() - t_run:.1f} s")
        if not (n_par == FLEET_PARITY_TICKS and all(same)):
            raise AssertionError(f"[13 fleet] {method}: card and CPU differ in the first "
                                 f"{FLEET_PARITY_TICKS} ticks: {same}")
        if win.r["tick_sweep"] != n_rob * win.r["tick_n"] or win.r["ctrl_sweep"] != plans:
            raise AssertionError(f"[13 fleet] K3 launches: {win.r['tick_sweep']} in "
                                 f"{win.r['tick_n']} ticks, {win.r['ctrl_sweep']} in {plans} plans")
        if (coord.host_syncs, nav_syncs) != (win.r["tick_torch_syncs"], win.r["ctrl_torch_syncs"]):
            raise AssertionError(f"[13 fleet] host sync counts differ: engine "
                                 f"{coord.host_syncs} / {nav_syncs}, torch "
                                 f"{win.r['tick_torch_syncs']} / {win.r['ctrl_torch_syncs']} at "
                                 f"{dict(win.sites)}")
        bound_cov = 0.4 if n_rob == 2 else 0.3
        if not (cov[-1] > bound_cov and min(moved) > 1.5):
            raise AssertionError(f"[13 fleet] {method}: coverage {cov[-1]} (bound {bound_cov}), "
                                 f"rovers moved {moved}")
        if method == "auction" and not rounds:
            raise AssertionError("[13 fleet] the auction solved nothing")
    t_auc = time.monotonic()
    auc = auction_check(dev)
    rounds, syncs, ms, gaps, reps = (np.array(c) for c in list(zip(*auc))[:5])
    log(f"[13 fleet] auction alone on {len(auc)} problems of {AUCTION_SHAPE}: all within R eps "
        f"of hungarian_assign's optimum (largest gap {gaps.max():.4f} against R eps "
        f"{reps.min():.4f}-{reps.max():.4f}); rounds a solve {rounds.mean():.1f} "
        f"({rounds.min()}-{rounds.max()}), host syncs a solve {syncs.mean():.2f} "
        f"({syncs.min()}-{syncs.max()}: a read a chunk of {al.AUCTION_CHUNK} rounds), "
        f"host ms a solve {np.median(ms):.2f} (median); {time.monotonic() - t_auc:.1f} s; "
        f"phase {time.monotonic() - t_phase:.1f} s")
    if launches["sweep"] <= 0:
        raise AssertionError("[13 fleet] K3 was not launched")
    return dict(launches)


def phase_fleet_slam(dev):
    """examples/run_multirobot_slam.py's fleet through the port's run_fleet:
    two rovers against one for FLEET_SLAM_STEPS frames, held to
    tests/test_multirobot_slam.py's three bounds, then three rovers. Per
    rover: host ms a frame, K1 / K2 launches a frame, K3 a tick and a
    controller step, host syncs a frame and a tick (the engine's, which must
    equal torch's over the run). Returns the kernels' launches over the
    three runs."""
    from fitslam_tpu_torch import run_multirobot_slam as rms

    t_phase = time.monotonic()
    launches = Counter()
    runs = {}
    for n_rob in (2, 1, 3):
        t_run = time.monotonic()
        win = _Windows()
        _reset_counts()
        fleet, cov = rms.run_fleet(n_rob, FLEET_SLAM_STEPS, device=dev, timer=win,
                                   verbose=False)
        launches.update(_counts())
        runs[n_rob] = (fleet, cov)
        parts = []
        for i, (robot, nav, system) in enumerate(fleet):
            engine = (system.slam.host_syncs + nav.host_syncs + system.explorer.host_syncs
                      + system.host_syncs)
            torch_n = sum(win.r[f"{w}{i}_torch_syncs"] for w in ("frame", "tick", "ctrl"))
            parts.append(
                f"rover {i}: {int(system.slam.map.n_kf)} keyframes, "
                f"{int(system.slam.map.n_lm)} landmarks, {system.explorer.diag.goals_sent} "
                f"goals, at ({robot.x:+.2f}, {robot.y:+.2f}); host ms a frame "
                f"{win.per(f'frame{i}', 's') * 1e3:.1f}, a tick {win.per(f'tick{i}', 's') * 1e3:.1f}, "
                f"a controller step {win.per(f'ctrl{i}', 's') * 1e3:.2f}; K1 "
                f"{win.per(f'frame{i}', 'describe'):.2f} / K2 {win.per(f'frame{i}', 'top2'):.2f} "
                f"launches a frame, K3 {win.per(f'tick{i}', 'sweep'):.2f} a tick and "
                f"{win.per(f'ctrl{i}', 'sweep'):.3f} a controller step; host syncs a frame "
                f"{win.per(f'frame{i}', 'torch_syncs'):.3f}, a tick "
                f"{win.per(f'tick{i}', 'torch_syncs'):.2f}, a controller step "
                f"{win.per(f'ctrl{i}', 'torch_syncs'):.3f} (engine {engine}, torch {torch_n} "
                f"over the run)")
            if engine != torch_n:
                raise AssertionError(f"[13 fleet slam] rover {i} of {n_rob}: host syncs differ: "
                                     f"engine {engine}, torch {torch_n} at {dict(win.sites)}")
        log(f"[13 fleet slam] {n_rob} rover(s), 320x240, {FLEET_SLAM_STEPS} frames: union "
            f"coverage {cov[-1]:.4f}; " + "; ".join(parts)
            + f"; {time.monotonic() - t_run:.1f} s")
    (fleet, fleet_cov), (_, solo_cov) = runs[2], runs[1]
    for i, (robot, nav, system) in enumerate(fleet):
        if not (int(system.slam.map.n_kf) >= 4 and int(system.slam.map.n_lm) >= 200):
            raise AssertionError(f"[13 fleet slam] rover {i} made too few keyframes or landmarks")
    (r0, _, _), (r1, _, _) = fleet
    moved = [float(np.ptp(np.array([(x, y) for x, y, _ in rb.trajectory]), axis=0).sum())
             for rb in (r0, r1)]
    apart = float(np.linalg.norm([r0.x - r1.x, r0.y - r1.y]))
    log(f"[13 fleet slam] tests/test_multirobot_slam.py's bounds: fleet coverage "
        f"{fleet_cov[-1]:.4f} against solo {solo_cov[-1]:.4f} + 0.05; rovers moved "
        f"{moved[0]:.2f} / {moved[1]:.2f} m, {apart:.2f} m apart; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    if not fleet_cov[-1] > solo_cov[-1] + 0.05:
        raise AssertionError(f"[13 fleet slam] fleet {fleet_cov[-1]} vs solo {solo_cov[-1]}")
    if not (min(moved) > 1.0 and apart > 2.0):
        raise AssertionError(f"[13 fleet slam] rovers moved {moved}, {apart} m apart")
    if min(launches[k] for k in ("describe", "top2", "sweep")) <= 0:
        raise AssertionError(f"[13 fleet slam] a kernel of the path was not launched: "
                             f"{dict(launches)}")
    return dict(launches)


ENTRY_DIR = ROOT / "build" / "entry"   # git-ignored: the entry points' files
ENTRY_ACTIVE_FRAMES = 60               # the example's default 110, cut to pay for phase 15
ENTRY_RESUME = (40, 20)                # frames before the save, frames after it
ENTRY_LIVE_FRAMES = 6
ENTRY_VO_BOUNDS = (0.10, 0.3)          # tests/test_slam_e2e.py: aligned, unaligned ATE (m)
# the committed corridor worlds: file -> (seed, corridor_world's arguments)
WORLD_FILES = {"bench_corridor_world.npz": (42, dict(num=3000, length=40.0, width=5.0)),
               "dataset_corridor_world.npz": (0, dict(num=3000, length=30.0, width=5.0))}


def _entry_run(module, args, what):
    """``python -m module args`` on the card: (stdout, seconds with the
    interpreter's start, the kernels' launches it printed)."""
    import re

    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    secs = time.monotonic() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[14 entry] {what} exited {proc.returncode}:\n{proc.stdout}\n"
                             f"{proc.stderr}")
    m = re.search(r"kernel launches: K1 describe (\d+), K1 gather (\d+), K2 top-2 (\d+), "
                  r"K3 sweep (\d+)", proc.stdout)
    launches = dict(zip(("describe", "gather", "top2", "sweep"), map(int, m.groups()))) \
        if m else None
    return proc.stdout, secs, launches


def _printed(pattern, text, what):
    import re

    m = re.search(pattern, text)
    if m is None:
        raise AssertionError(f"[14 entry] {what} printed no {pattern!r}:\n{text}")
    return float(m.group(1))


def _resume_check(dev):
    """StereoSlam at the example's config: ENTRY_RESUME[0] frames, save_slam,
    ENTRY_RESUME[1] more; a fresh engine loads the file and tracks the same
    frames. Then save_active_system / load_active_system at frame 40 of the
    active loop. Returns the line's text."""
    from fitslam_tpu_torch import run_active_slam as ras
    from fitslam_tpu_torch.data import synthetic
    from fitslam_tpu_torch.models.active_slam import camera_pose_from_robot
    from fitslam_tpu_torch.models.slam import StereoSlam
    from fitslam_tpu_torch.ops.geometry import Intrinsics
    from fitslam_tpu_torch.utils import checkpoint as ck
    from fitslam_tpu_torch.utils.profiling import SimClock

    n0, n1 = ENTRY_RESUME
    cfg = ras.active_config()
    K = Intrinsics.from_config(cfg.camera, dev)
    world = ras.rooms_world(3, dev)
    x, y, yaw, frames = -5.0, -5.0, 0.3, []
    for i in range(n0 + n1):
        if i >= 2:
            yaw += 0.05
            x += 0.1 * math.cos(yaw)
            y += 0.1 * math.sin(yaw)
        cam = camera_pose_from_robot(x, y, yaw, device=dev)
        frames.append(synthetic.render_stereo(K, world, cam, width=ras.W, height=ras.H,
                                              max_depth=12.0))
    slam_path = ENTRY_DIR / "slam.npz"
    a = StereoSlam(cfg, dev)
    for i, (l, r) in enumerate(frames):
        if i == n0:
            ck.save_slam(str(slam_path), a)
        a.process_frame(l, r)
    b = StereoSlam(cfg, dev)
    ck.load_slam(str(slam_path), b)
    for l, r in frames[n0:]:
        b.process_frame(l, r)
    pairs = list(zip(a.trajectory[n0:], b.trajectory[n0:]))
    gap = max(float(np.abs(ta - tb).max()) for ta, tb in pairs)
    bit_equal = all(np.array_equal(ta, tb) for ta, tb in pairs)
    if len(b.trajectory) != n0 + n1 or gap > 1e-5:
        raise AssertionError(f"[14 entry] resumed StereoSlam differs by {gap} (atol 1e-5)")

    # the active system at frame n0, saved and restored
    def active(n):
        clock = SimClock()
        robot, nav, system = ras.build_system(cfg, dev, clock)
        for step in range(n):
            cam = camera_pose_from_robot(robot.x, robot.y, robot.yaw, device=dev)
            if step == 0:
                system.set_world_anchor(cam)
            l, r = synthetic.render_stereo(K, world, cam, width=ras.W, height=ras.H,
                                           max_depth=12.0)
            cloud, cvalid = synthetic.frustum_cloud(
                K, world, cam, max_points=cfg.traversability.max_points_per_cloud,
                max_depth=8.0, width=ras.W, height=ras.H)
            system.process_frame(l, r, cloud, cvalid)
            if step % ras.TICK_EVERY == ras.TICK_EVERY - 1:
                system.tick_exploration()
            nav.step()
            clock.sim_s += ras.DT
        return robot, system

    robot, sys_a = active(n0)
    path = ENTRY_DIR / "active_40.npz"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save_active_system(str(path), sys_a)
    save_ms = (time.perf_counter() - t0) * 1e3
    _, sys_b = active(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.load_active_system(str(path), sys_b)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    sys_a._restitch = sys_a._grid_dirty = True
    same = {"occupancy": torch.equal(sys_a.occupancy(), sys_b.occupancy()),
            "roadmap": torch.equal(sys_a.explorer.roadmap.xy, sys_b.explorer.roadmap.xy),
            "frame_id": sys_a.slam.frame_id == sys_b.slam.frame_id == n0,
            "ticks": sys_a.explorer.diag.ticks == sys_b.explorer.diag.ticks}
    cam = camera_pose_from_robot(robot.x, robot.y, robot.yaw, device=dev)
    l, r = synthetic.render_stereo(K, world, cam, width=ras.W, height=ras.H, max_depth=12.0)
    sys_b.process_frame(l, r)
    inliers = int(sys_b.slam.outs_log[-1].n_inliers)
    if not all(same.values()) or inliers <= 10:
        raise AssertionError(f"[14 entry] restored active system: {same}, {inliers} inliers")
    return (f"resume: StereoSlam {n0}+{n1} frames, the resumed trajectory within {gap:.3g} of "
            f"the uninterrupted one (bit-equal: {bit_equal}); active system at frame {n0}: "
            f"file {path.stat().st_size / 1e6:.3f} MB, save {save_ms:.1f} ms, load "
            f"{load_ms:.1f} ms, occupancy / roadmap / frame id / ticks equal after the "
            f"re-stitch, next frame {inliers} inliers")


def _live_check(dev):
    """The live view on port 0 during a short active run: status, map, and
    pause / resume reaching the explorer."""
    import urllib.request

    from fitslam_tpu_torch import run_active_slam as ras
    from fitslam_tpu_torch.models.exploration import ExplorationState

    seen = {}

    def poke(step, system, port):
        if step != ENTRY_LIVE_FRAMES - 2:
            return
        base = f"http://127.0.0.1:{port}"
        seen["status"] = json.loads(urllib.request.urlopen(base + "/status.json",
                                                           timeout=10).read())
        seen["png"] = urllib.request.urlopen(base + "/map.png", timeout=10).read()
        for action, want in (("pause", ExplorationState.PAUSED),
                             ("resume", ExplorationState.EXPLORING)):
            urllib.request.urlopen(urllib.request.Request(base + "/" + action, data=b"",
                                                          method="POST"), timeout=10)
            seen[action] = system.explorer.state == want

    args = ras.build_parser().parse_args(["--frames", str(ENTRY_LIVE_FRAMES), "--live", "0"])
    ras.run(args, dev, on_step=poke)
    ok = (seen.get("png", b"")[:8] == b"\x89PNG\r\n\x1a\n" and seen.get("pause")
          and seen.get("resume") and "coverage_fraction" in seen.get("status", {}))
    if not ok:
        raise AssertionError(f"[14 entry] live view: {seen}")
    return (f"live view on port 0 during {ENTRY_LIVE_FRAMES} frames: status {seen['status']}, "
            f"map.png {len(seen['png'])} bytes, pause and resume reached the explorer")


def _worlds_check():
    """The three committed worlds, drawn again on the host by prng and
    synthetic, equal to their files."""
    from fitslam_tpu_torch.data import synthetic
    from fitslam_tpu_torch.utils import prng

    data = ROOT / "tests" / "data"
    for name, (seed, kw) in WORLD_FILES.items():
        got = synthetic.corridor_world(prng.prng_key(seed), device="cpu", **kw).landmarks.numpy()
        if not np.array_equal(got, np.load(data / name)["landmarks"]):
            raise AssertionError(f"[14 entry] {name} does not regenerate")
    rings = np.load(data / "ring_worlds.npz")
    for seed in (1, 2, 3):
        got = synthetic.ring_world(prng.prng_key(seed), num=5000, radius=8.0, width=5.0,
                                   device="cpu").landmarks.numpy()
        if not np.array_equal(got, rings[f"seed_{seed}"]):
            raise AssertionError(f"[14 entry] ring world {seed} does not regenerate")
    return "bench_corridor_world, dataset_corridor_world and ring_worlds (seeds 1-3) equal"


def phase_entry(dev):
    """[14 entry]: the user entry points on the card. ``python -m
    fitslam_tpu_torch.run_active_slam`` with a checkpoint and artifacts (the
    example's ATE bound, so exit 0); resume in process (StereoSlam and the
    active system); the live view during a short run; ``python -m
    fitslam_tpu_torch.run_vo`` at its defaults, then its PGM export replayed
    (tests/test_slam_e2e.py's bounds, the replay's keyframes equal the
    synthetic run's); the committed worlds drawn again on the host. Returns
    the launches of the active and VO entry points' runs."""
    import shutil

    t_phase = time.monotonic()
    shutil.rmtree(ENTRY_DIR, ignore_errors=True)
    ENTRY_DIR.mkdir(parents=True)
    rec, ckpt = ENTRY_DIR / "record", ENTRY_DIR / "active.npz"
    out, secs, n_act = _entry_run("fitslam_tpu_torch.run_active_slam",
                                  ["--frames", str(ENTRY_ACTIVE_FRAMES), "--checkpoint",
                                   str(ckpt), "--record", str(rec)], "run_active_slam")
    missing = [f for f in ("streams.npz", "coverage.csv", "world.ppm", "map.pgm")
               if not (rec / f).is_file()] + ([] if ckpt.is_file() else [ckpt.name])
    figures = {k: _printed(p, out, "run_active_slam") for k, p in (
        ("coverage", r"final coverage = ([0-9.]+)"), ("ate_cm", r"ATE RMSE = ([0-9.]+) cm"),
        ("keyframes", r"keyframes = (\d+)"), ("goals", r"\] goals=(\d+)"),
        ("fps", r"throughput = ([0-9.]+) frames/s"))}
    log(f"[14 entry] python -m fitslam_tpu_torch.run_active_slam --frames "
        f"{ENTRY_ACTIVE_FRAMES} --checkpoint --record: exit 0, coverage "
        f"{figures['coverage']:.3f}, ATE {figures['ate_cm']:.1f} cm, {figures['keyframes']:.0f} "
        f"keyframes, {figures['goals']:.0f} goals, {figures['fps']:.2f} frames/s, launches "
        f"{n_act}, checkpoint {ckpt.stat().st_size / 1e6 if ckpt.is_file() else 0:.3f} MB, "
        f"{secs:.1f} s with the interpreter's start")
    if missing or n_act is None or min(n_act["describe"], n_act["top2"], n_act["sweep"]) <= 0:
        raise AssertionError(f"[14 entry] run_active_slam: missing {missing}, launches {n_act}")
    log(f"[14 entry] {_resume_check(dev)}")
    log(f"[14 entry] {_live_check(dev)}")
    vo, vo_s, n_vo = _entry_run("fitslam_tpu_torch.run_vo", [], "run_vo")
    pgm = ENTRY_DIR / "vo_pgm"
    _entry_run("fitslam_tpu_torch.run_vo", ["--export-dataset", str(pgm)], "run_vo --export")
    rep, _, _ = _entry_run("fitslam_tpu_torch.run_vo", ["--dataset", str(pgm)],
                           "run_vo --dataset")
    runs = {}
    for name, text in (("synthetic", vo), ("replay", rep)):
        runs[name] = {k: _printed(p, text, f"run_vo {name}") for k, p in (
            ("ate_cm", r"ATE RMSE = ([0-9.]+) cm"), ("unaligned_cm", r"unaligned ([0-9.]+) cm"),
            ("keyframes", r"keyframes=(\d+)"), ("fps", r"throughput = ([0-9.]+) frames/s"))}
    log("[14 entry] python -m fitslam_tpu_torch.run_vo: " + "; ".join(
        f"{name} ATE {r['ate_cm']:.2f} cm (unaligned {r['unaligned_cm']:.2f} cm), "
        f"{r['keyframes']:.0f} keyframes, {r['fps']:.2f} frames/s" for name, r in runs.items())
        + f"; launches {n_vo}; {vo_s:.1f} s with the interpreter's start")
    for name, r in runs.items():
        if not (r["ate_cm"] / 100 < ENTRY_VO_BOUNDS[0]
                and r["unaligned_cm"] / 100 < ENTRY_VO_BOUNDS[1]):
            raise AssertionError(f"[14 entry] run_vo {name} misses tests/test_slam_e2e.py's "
                                 f"bounds: {r}")
    if runs["replay"]["keyframes"] != runs["synthetic"]["keyframes"]:
        raise AssertionError(f"[14 entry] the replay's keyframes differ: {runs}")
    if n_vo is None or min(n_vo["describe"], n_vo["top2"]) <= 0:
        raise AssertionError(f"[14 entry] run_vo launches {n_vo}")
    log(f"[14 entry] worlds drawn again on the host by utils/prng.py: {_worlds_check()}; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    return n_act, n_vo


# ---------------------------------------------------------------------------
# Phase 15: the sharded solvers of parallel/ over ranks on the card
# ---------------------------------------------------------------------------

PARALLEL_RANKS = (2, 4)        # GBA over 2 ranks, then 4, all sharing card 0 (gloo)
PARALLEL_OBS_ITERS = 3         # the observation-sharded BA's Y (189 MB) crosses every iteration
PIPELINE_FRAMES = 20           # bench frames through the stage pipeline after the bootstrap
PIPELINE_PROFILE_FRAMES = 5    # of them under torch.profiler, a mode (its trace of an eager
                               # window costs seconds a frame to read)
STAGE_CALLS = 3                # sharded fusion and raycast calls a mode (captured: warm-up,
                               # capture, replay)
MESH_REFINE_CYCLES = 3         # refine_map's cycles after a mesh correction, a pass
# a mesh correction: (label, capture, corrections an engine), as phase 19's
# CORRECTION_PASSES, the eager engine's correcting twice (its first pays the
# rank process's first calls)
MESH_CORRECTION_PASSES = (("eager", False, 2), ("first captured engine", True, 2),
                          ("second captured engine", True, 1))
SHARDED_TOL = 5e-3             # tests/test_dist_ba.py's sharded-versus-single bound (m)
PGO_TOL = 1e-3                 # tests/test_torch_pgo.py's bound on optimized poses (ROADMAP F5)
PIPELINE_TOL = 1e-4            # tests/test_stage_pipeline.py's bound on the poses


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _tree_to(tree, dev):
    from fitslam_tpu_torch.parallel.mesh import map_tree

    return map_tree(lambda x: x.to(dev), tree)


def _pipeline_start(dev, cfg, frames):
    """The bootstrap of tests/test_stage_pipeline.py at bench width: frame 0
    inserted as keyframe 0 into an empty map of the bench's capacity."""
    from fitslam_tpu_torch.models import slam_map as sm
    from fitslam_tpu_torch.models import tracking as tr
    from fitslam_tpu_torch.ops import lie
    from fitslam_tpu_torch.ops.geometry import Intrinsics

    K, o, mp = Intrinsics.from_config(cfg.camera, dev), cfg.orb, cfg.mapping
    f0 = tr.process_stereo(K, *frames[0], num_features=o.num_features, num_levels=o.num_levels,
                           scale_factor=o.scale_factor, fast_threshold=o.fast_threshold)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    m = sm.empty_map(mp.max_keyframes, mp.max_landmarks, mp.max_observations, device=dev)
    m = sm.insert_keyframe(m, K, lie.SE3.identity(device=dev), f0.feats, f0.depth,
                           torch.full((o.num_features,), -1, dtype=torch.int32, device=dev),
                           zero, torch.zeros((256,), device=dev))
    return K, m, tr.mark_keyframe(tr.init_track_state(dev), zero)


SOLVER_SOLVES = {False: 2, True: 3}   # timed solves a mode: eager (the first loads the
                                      # kernels' modules); captured (the BA regions eager in
                                      # a slot's first solve, dist_ba.EAGER_SOLVES, captured in
                                      # its second, replayed from its third)


def _solver_passes(mesh, name, solve, iters, modes=(False, True)):
    """``solve(capture)`` in each mode of ``modes`` on every rank of
    ``mesh``: SOLVER_SOLVES solves timed on the host, the device
    synchronised around each; with both modes, then one more a mode under
    torch.profiler on rank 0 for its host kernel and graph launches. Every
    timed solve's result must be bit-equal. Returns (a result, {mode: each
    solve's host ms an iteration, launches}, bit-equal, the captured
    regions' stats)."""
    dev = mesh.device
    out, results = {}, []
    for capture in modes:
        ms = []
        for _ in range(SOLVER_SOLVES[capture]):
            _sync(dev)
            t0 = time.perf_counter()
            results.append(solve(capture))
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3 / iters)
        launches = None
        if len(modes) > 1 and mesh.rank == 0:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                solve(capture)
                _sync(dev)
            launches = _host_launches(prof)
        elif len(modes) > 1:
            solve(capture)
            _sync(dev)
        out["captured" if capture else "eager"] = dict(solves_ms=ms, ms=ms[-1],
                                                       launches=launches)
    same = all(_same_tree(r, results[0]) for r in results[1:])
    return results[-1], out, same, mesh.solvers[name].state.stats()


def _solver_line(what, modes, same, regions):
    launches = lambda m: ("not profiled" if m["launches"] is None else
                          f"{m['launches'][0]} kernels + {m['launches'][1]} graphs")
    solves = lambda m: " / ".join(f"{x:.2f}" for x in m["solves_ms"])
    return (f"{what}: host ms an iteration, a solve after another, "
            + ", ".join(f"{k} {solves(m)}" for k, m in modes.items())
            + "; host launches a solve " + ", ".join(f"{k} {launches(m)}"
                                                    for k, m in modes.items())
            + f"; solves bit-equal {same}; regions (capture s, pool MB) "
            + ", ".join(f"{k} {_pool(v)}" for k, v in regions.items()))


def _timed_gba(mesh, m, K, iters, modes):
    """global_ba_dist, the GBA of a correction on a mesh, in ``modes``
    (``_solver_passes``; peak memory above the map over its solves, graph
    pools included), then once captured with its collectives timed."""
    from fitslam_tpu_torch.models import slam_map as sm

    dev = mesh.device
    _sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    (a, ca), out, same, regions = _solver_passes(
        mesh, "landmark_sharded_bundle_adjust",
        lambda c: sm.global_ba_dist(m, K, mesh, iters=iters, capture=c), iters, modes)
    peak = torch.cuda.max_memory_allocated(dev) - base
    mesh.timed, s0, c0 = True, mesh.stats["seconds"], mesh.stats["collectives"]
    sm.global_ba_dist(m, K, mesh, iters=iters)
    mesh.timed = False
    return dict(map=a, chis=ca, same=same, modes=out, regions=regions,
                ms_iter=out["captured"]["ms"],
                allreduce_ms_iter=(mesh.stats["seconds"] - s0) / iters * 1e3,
                collectives=mesh.stats["collectives"] - c0, peak_gb=peak / 1e9)


def _parallel_rank(n, dev_map, K, iters, rest):
    """One rank of phase 15. Every launch: GBA landmark-sharded over the
    ranks, captured (and eager with ``rest``). With ``rest`` (2 ranks): the
    observation-sharded BA and edge-sharded PGO, point-sharded fusion,
    frontier-sharded raycast, the stage pipeline at bench width (with this
    rank's K1 / K2 launches and host launches a frame) and the held loop
    correction and refine_map on an engine with the mesh, each eager and
    captured."""
    from fitslam_tpu_torch.ops import ba
    from fitslam_tpu_torch.parallel import dist_ba, dist_stages as ds, mesh as mesh_mod

    mesh = mesh_mod.make_mesh(n)
    dev = mesh.device
    m, K = _tree_to(dev_map, dev), _tree_to(K, dev)
    t0 = time.monotonic()
    out = dict(rank=mesh.rank,
               gba=_timed_gba(mesh, m, K, iters, (True,) if rest is None else (False, True)))
    if rest is None:
        return out
    secs = out["seconds"] = {"gba": time.monotonic() - t0}
    t0 = time.monotonic()
    # observation-sharded BA on the map's whole problem
    prob = ba.BAProblem(m.kf_T_cw, m.lm_pos, ba.Observations(m.obs_kf, m.obs_lm, m.obs_uvr,
                                                             m.obs_sigma2, m.obs_valid),
                        torch.logical_not(m.kf_valid) | (torch.arange(m.kf_valid.shape[0],
                                                                      device=dev) == 0),
                        torch.logical_not(m.lm_valid))
    (ob, ob_chis), modes, same, regions = _solver_passes(
        mesh, "distributed_bundle_adjust",
        lambda c: dist_ba.distributed_bundle_adjust(mesh, K, prob, iters=PARALLEL_OBS_ITERS,
                                                    capture=c), PARALLEL_OBS_ITERS)
    mesh.timed, s0 = True, mesh.stats["seconds"]
    dist_ba.distributed_bundle_adjust(mesh, K, prob, iters=PARALLEL_OBS_ITERS)
    mesh.timed = False
    out["obs"] = dict(T=ob.T_cw, points=ob.points, chis=ob_chis, modes=modes, same=same,
                      regions=regions,
                      allreduce_ms_iter=(mesh.stats["seconds"] - s0) / PARALLEL_OBS_ITERS * 1e3)
    secs["obs"], t0 = time.monotonic() - t0, time.monotonic()
    T0, kf_valid, edges, fixed, pgo_iters = _tree_to(rest["pgo"], dev)
    pgo_out, modes, same, regions = _solver_passes(
        mesh, "distributed_pose_graph",
        lambda c: ds.distributed_pose_graph(mesh, T0, kf_valid, edges, fixed, iters=pgo_iters,
                                            capture=c), pgo_iters)
    out["pgo"] = dict(result=pgo_out, modes=modes, same=same, regions=regions)
    secs["pgo"], t0 = time.monotonic() - t0, time.monotonic()
    spec, pts_w, ok, kw = rest["fusion"]
    pts_w, ok = pts_w.to(dev), ok.to(dev)
    spec_r, occ, fxy, f_valid = rest["raycast"]
    occ, fxy, f_valid = occ.to(dev), fxy.to(dev), f_valid.to(dev)
    out["stages"] = {
        what: _stage_calls(mesh, name, call) for what, name, call in (
            ("fusion", "sharded_fuse_clouds",
             lambda c: ds.sharded_fuse_clouds(mesh, spec, pts_w, ok, **kw, capture=c)),
            ("raycast", "sharded_arrival_information",
             lambda c: ds.sharded_arrival_information(mesh, spec_r, occ, fxy, f_valid,
                                                      capture=c)))}
    out["grid"], out["ray"] = (out["stages"][k].pop("result") for k in ("fusion", "raycast"))
    secs["stages"], t0 = time.monotonic() - t0, time.monotonic()
    # the stage pipeline: frames 1..PIPELINE_FRAMES after the bootstrap frame
    cfg, backend_kw = rest["pipeline"]
    stage = mesh_mod.make_mesh(2, axis_names=("stage",))
    frames, _ = headline_frames(cfg, dev, PIPELINE_FRAMES + 1)
    Kp, m0, st0 = _pipeline_start(dev, cfg, frames)
    stream = torch.stack([torch.stack(f) for f in frames[1:]])
    o = cfg.orb

    def pipeline(capture, frames=stream):
        return ds.stage_pipelined_slam(
            stage, Kp, m0, st0, frames, num_features=o.num_features, num_levels=o.num_levels,
            scale_factor=o.scale_factor, fast_threshold=o.fast_threshold,
            backend_kwargs=backend_kw, capture=capture)

    modes = {}
    for capture in (False, True):
        # first calls: the kernels' modules; captured, every region's capture
        # (the keyframe regions' at the second keyframe)
        pipeline(capture, stream if capture else stream[:4])
        _sync(dev)
        _reset_counts()
        t1 = time.perf_counter()
        res = pipeline(capture)
        _sync(dev)
        fps = PIPELINE_FRAMES / (time.perf_counter() - t1)
        launches = _counts()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            pipeline(capture, stream[:PIPELINE_PROFILE_FRAMES])
            _sync(dev)
        host_k, host_g = _host_launches(prof)
        modes["captured" if capture else "eager"] = dict(
            result=res, fps=fps, launches=launches,
            host=(host_k / PIPELINE_PROFILE_FRAMES, host_g / PIPELINE_PROFILE_FRAMES))
    m_p, st_p, outs = modes["captured"]["result"]
    out["pipeline"] = dict(
        outs=outs, n_kf=int(m_p.n_kf), T_cw_t=st_p.T_cw.t,
        same=_same_tree(modes["eager"].pop("result"), modes["captured"].pop("result")),
        modes=modes, launches=modes["captured"]["launches"],
        regions=stage.solvers["stage_pipelined_slam"].state.stats())
    secs["pipeline"], t0 = time.monotonic() - t0, time.monotonic()
    out["correction"] = _mesh_corrections(mesh, _tree_to(rest["correction"], dev))
    secs["correction"] = time.monotonic() - t0
    return out


def _same_tree(a, b) -> bool:
    from fitslam_tpu_torch.utils import jit

    la, lb = jit.flatten(a)[0], jit.flatten(b)[0]
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _stage_calls(mesh, name, call):
    """``call(capture)`` STAGE_CALLS times a mode, eager then captured (warm-up,
    capture, replay), the host's ms of each, the device synchronised around
    each: {result (the first captured call's), ms a mode, every result
    bit-equal, the regions' stats}."""
    results, ms = [], {}
    for capture in (False, True):
        ms["captured" if capture else "eager"] = []
        for _ in range(STAGE_CALLS):
            _sync(mesh.device)
            t0 = time.perf_counter()
            results.append(call(capture))
            _sync(mesh.device)
            ms["captured" if capture else "eager"].append((time.perf_counter() - t0) * 1e3)
    return dict(result=results[STAGE_CALLS], ms=ms,
                same=all(_same_tree(r, results[0]) for r in results[1:]),
                regions=mesh.solvers[name].state.stats())


def _mesh_corrections(mesh, held):
    """Phase 10's first correction of seed 1 on an engine whose loop closer
    has ``mesh`` (its GBA landmark-sharded over the ranks), then
    refine_map(cycles=MESH_REFINE_CYCLES), a fresh engine a pass of
    MESH_CORRECTION_PASSES (eager counts 1: the first captured engine's
    first correction eager in its slot, its second captured; the second
    engine replaying). Host ms of each, and whether each pass left the
    eager pass's map, tracker state, record and refine chi2."""
    from fitslam_tpu_torch.models import loop_closing
    from fitslam_tpu_torch.models import slam as slam_mod
    from fitslam_tpu_torch.models.slam import StereoSlam
    from fitslam_tpu_torch.utils import jit

    saved = loop_closing.EAGER_CALLS, slam_mod.REFINE_EAGER_CYCLES
    loop_closing.EAGER_CALLS = slam_mod.REFINE_EAGER_CYCLES = 1
    passes, want = [], None
    try:
        for label, capture, n_calls in MESH_CORRECTION_PASSES:
            slam = StereoSlam(held["cfg"], mesh.device, capture=capture)
            slam.loop_closer.mesh = mesh
            if capture:
                slam._slot_state.claim()         # the slot's set-up is not a correction's
            correct_ms = []
            for _ in range(n_calls):
                _restore(slam, held)
                _sync(mesh.device)
                t0 = time.perf_counter()
                info = slam.loop_closer.on_keyframe(slam, *held["args"])
                _sync(mesh.device)
                correct_ms.append((time.perf_counter() - t0) * 1e3)
                if info is None:
                    raise AssertionError("[15 parallel] the held correction did not close its "
                                         "loop on the mesh")
            t0 = time.perf_counter()
            chi2 = slam.refine_map(cycles=MESH_REFINE_CYCLES, gba_iters=15)
            _sync(mesh.device)
            refine_ms = (time.perf_counter() - t0) * 1e3
            got = (jit.clone(slam.map), jit.clone(slam.state), chi2.clone(),
                   [v for v in info.values() if isinstance(v, torch.Tensor)])
            want = want or got
            passes.append(dict(label=label, correct_ms=correct_ms, refine_ms=refine_ms,
                               same=_same_tree(got, want), stats=slam.capture_stats,
                               gba_chi2=float(info["gba_chi2"]), chi2=float(chi2)))
            del slam, info, chi2
    finally:
        loop_closing.EAGER_CALLS, slam_mod.REFINE_EAGER_CYCLES = saved
    return dict(passes=passes, kf_t=want[0].kf_T_cw.t, lm_pos=want[0].lm_pos)


def _sequential_pipeline(dev, cfg, backend_kw):
    """The port's sequential path on one rank over the pipeline's frames,
    eager (the frontend and ``_backend_body`` frame after frame) and captured
    (a StereoSlam replaying: ``process_frame_async`` from the bootstrap,
    once to capture, then timed on a fresh engine of its slot): {mode:
    (poses, keyframe flags, inliers, frames/s)}."""
    from fitslam_tpu_torch.models import tracking as tr
    from fitslam_tpu_torch.models.slam import StereoSlam
    from fitslam_tpu_torch.models.slam_step import _backend_body

    frames, _ = headline_frames(cfg, dev, PIPELINE_FRAMES + 1)
    K, m0, st0 = _pipeline_start(dev, cfg, frames)
    o = cfg.orb

    def eager(frames):
        m, st, initialized, outs = m0, st0, True, []
        for t, (l, r) in enumerate(frames):
            f = tr.process_stereo(K, l, r, num_features=o.num_features, num_levels=o.num_levels,
                                  scale_factor=o.scale_factor, fast_threshold=o.fast_threshold)
            m, st, out, inserted, _ = _backend_body(K, m, st, f, t, initialized=initialized,
                                                    **backend_kw)
            initialized = initialized or inserted
            outs.append(out)
        return outs

    def captured(frames):
        slam = StereoSlam(cfg, dev)
        slam.map, slam.state = m0, st0
        slam._track_initialized = slam._initialized = True
        return [slam.process_frame_async(l, r) for l, r in frames]

    out = {}
    for mode, run in (("eager", eager), ("captured", captured)):
        run(frames[1:])         # first calls; the captured engine's regions captured
        _sync(dev)
        t0 = time.perf_counter()
        outs = run(frames[1:])
        _sync(dev)
        fps = PIPELINE_FRAMES / (time.perf_counter() - t0)
        out[mode] = (torch.stack([o_.pose_wc for o_ in outs]).cpu(),
                     [bool(o_.was_keyframe) for o_ in outs], [int(o_.n_inliers) for o_ in outs],
                     fps)
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _parallel_entry_points(dev):
    """Two ``python -m fitslam_tpu_torch.parallel.multihost`` processes
    sharing ``dev`` over gloo, then ``python -m fitslam_tpu_torch.parallel.dryrun
    2`` on it: (the processes' results, the dry run's line, seconds)."""
    t0 = time.monotonic()
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fitslam_tpu_torch.parallel.multihost", "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(pid), "--backend",
         "gloo", "--device", str(dev)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
    results = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=300)
            if p.returncode != 0:
                raise AssertionError(f"[15 parallel] multihost exited {p.returncode}:\n{text}")
            line = [ln for ln in text.splitlines() if ln.startswith("MULTIHOST_RESULT ")]
            if not line:
                raise AssertionError(f"[15 parallel] multihost printed no result:\n{text}")
            results.append(json.loads(line[-1].split(" ", 1)[1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    proc = subprocess.run([sys.executable, "-m", "fitslam_tpu_torch.parallel.dryrun", "2",
                           "--device", str(dev)], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"[15 parallel] dryrun exited {proc.returncode}:\n{proc.stdout}\n"
                             f"{proc.stderr}")
    return results, proc.stdout.strip().splitlines()[-1], time.monotonic() - t0


def phase_parallel(dev, loop_run, active_run):
    """[15 parallel]: the sharded solvers of parallel/ over ranks spawned on
    the card (gloo, every rank on card 0). On phase 10's seed-1 map (128
    keyframes, 20480 landmarks, 65536 observations): global_ba_dist over 2
    and 4 ranks against global_ba on one, the observation-sharded BA against
    bundle_adjust, edge-sharded PGO on the map's odometry, covisibility and
    loop edges against optimize_pose_graph, each eager and captured
    (``_solver_passes``); phase 8's clouds fused
    point-sharded and its frontiers raycast frontier-sharded against the
    single-rank functions, each STAGE_CALLS times eager and captured; the
    stage pipeline at bench width over 20 frames eager and captured against
    the sequential path (eager, and a StereoSlam replaying); phase 10's held
    correction and a refine_map on engines whose loop closer has the 2-rank
    mesh, eager and captured; then two multihost processes and the 2-rank
    dry run. Returns the K1 / K2 launches of the captured pipeline's ranks."""
    from fitslam_tpu_torch.models import slam_map as sm
    from fitslam_tpu_torch.models.slam import StereoSlam
    from fitslam_tpu_torch.ops import ba, lie, pgo, raycast
    from fitslam_tpu_torch.ops import frontier as fx
    from fitslam_tpu_torch.ops import grid as gr
    from fitslam_tpu_torch.parallel import mesh as mesh_mod
    from fitslam_tpu_torch.utils.transfer import upload

    t_phase = time.monotonic()
    slam = loop_run["slam"]
    m, K, lcfg = slam.map, slam.K, slam.cfg.loop
    cpu = torch.device("cpu")
    m_cpu, K_cpu = _tree_to(m, cpu), _tree_to(K, cpu)
    # the single-rank GBA on the same map, timed alike
    _sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    wall = []
    for _ in range(2):
        t0 = time.perf_counter()
        single, single_stats = sm.global_ba(m, K, iters=BA_ITERS)
        _sync(dev)
        wall.append(time.perf_counter() - t0)
    single_peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    single_ms = min(wall) / BA_ITERS * 1e3

    # PGO: the loop closer's edge table on this map, padded to the ranks
    K_cap = m.kf_valid.shape[0]
    odo = pgo.odometry_edges(m.kf_T_cw, m.n_kf, K_cap - 1)
    covis = pgo.covisibility_edges(m.kf_T_cw, m.kf_valid, m.obs_kf, m.obs_lm, m.obs_valid,
                                   n_landmarks=m.lm_valid.shape[0],
                                   max_edges=lcfg.covis_max_edges,
                                   min_shared=lcfg.covis_min_shared)
    loops = slam.loop_closer.loop_edges
    tables = [odo, covis]
    if loops:
        tables.append(pgo.PoseGraphEdges(
            upload([e[0] for e in loops], dev, torch.int32),
            upload([e[1] for e in loops], dev, torch.int32),
            lie.SE3(torch.stack([e[2].R for e in loops]), torch.stack([e[2].t for e in loops])),
            upload([e[3] for e in loops], dev, torch.float32),
            torch.ones(len(loops), dtype=torch.bool, device=dev)))
    n_edges = sum(int(t.valid.shape[0]) for t in tables)
    pad = -n_edges % 4
    if pad:
        tables.append(pgo.PoseGraphEdges(
            torch.zeros(pad, dtype=torch.int32, device=dev),
            torch.zeros(pad, dtype=torch.int32, device=dev), lie.SE3.identity((pad,), device=dev),
            torch.ones(pad, device=dev), torch.zeros(pad, dtype=torch.bool, device=dev)))
    edges = pgo.concat_edges(*tables)
    # start PGO from the map's poses perturbed (seed 0), keyframe 0 held
    rng = np.random.RandomState(0)
    dx = upload((0.02 * rng.randn(K_cap, 6)).astype(np.float32), dev)
    dx[0] = 0.0
    T0 = lie.compose(lie.se3_exp(dx), m.kf_T_cw)
    fixed = torch.arange(K_cap, device=dev) == 0
    for _ in range(2):    # the second call is timed, as on the ranks
        _sync(dev)
        t0 = time.perf_counter()
        T_single, chis_pgo_single = pgo.optimize_pose_graph(T0, m.kf_valid, edges, fixed,
                                                            iters=lcfg.pgo_iters)
        _sync(dev)
    pgo_single_ms = (time.perf_counter() - t0) / lcfg.pgo_iters * 1e3

    # fusion and raycast on phase 8's run
    system = active_run["system"]
    spec = gr.GridSpec2D(64, 0.25, -8.0, -8.0)
    tcfg = system.cfg.traversability
    kw = dict(max_slope=tcfg.max_slope, ground_clearance=tcfg.ground_clearance,
              robot_height=tcfg.robot_height, security_distance=tcfg.security_distance)
    kf, _ = system.kf_poses_world()
    pts_w, ok = gr.cloud_points_world(system.clouds, kf)
    grid_single = gr.stats_to_grid(spec, gr.cell_stats(spec, pts_w, ok), **kw)
    occ = system.occupancy()
    robot_xy = upload(np.asarray(active_run["robot"].xy, np.float32), dev)
    fr = fx.extract_frontiers(spec, occ, robot_xy, spec.extent, max_frontiers=64)
    ray_single = raycast.arrival_information(spec, occ, fr.goal_xy, fr.valid)

    cfg = bench_config()
    backend_kw = StereoSlam(cfg, dev).backend_kwargs()
    seq = _sequential_pipeline(dev, cfg, backend_kw)
    held = loop_run["held"]
    rest = dict(pgo=_tree_to((T0, m.kf_valid, edges, fixed, lcfg.pgo_iters), cpu),
                fusion=(spec, pts_w.cpu(), ok.cpu(), kw),
                raycast=(spec, occ.cpu(), fr.goal_xy.cpu(), fr.valid.cpu()),
                pipeline=(cfg, backend_kw),
                correction=_tree_to({k: held[k] for k in ("map", "state", "frame", "closer",
                                                          "args", "cfg")}, cpu))
    runs = {}
    for n in PARALLEL_RANKS:
        t0 = time.monotonic()
        runs[n] = mesh_mod.launch(_parallel_rank, n, n, m_cpu, K_cpu, BA_ITERS,
                                  rest if n == 2 else None, backend="gloo", device=str(dev),
                                  timeout=900)
        runs[n][0]["launch_s"] = time.monotonic() - t0

    # -- checks --
    fails = []
    single_np = (single.kf_T_cw.t.cpu(), single.kf_T_cw.R.cpu(), single.lm_pos.cpu())
    val = m.lm_valid.cpu()
    gba_lines, solver_lines = [], []
    for n, res in runs.items():
        g0 = res[0]["gba"]
        for r in res[1:]:
            if not (torch.equal(r["gba"]["map"].kf_T_cw.t, g0["map"].kf_T_cw.t)
                    and torch.equal(r["gba"]["map"].lm_pos, g0["map"].lm_pos)):
                fails.append(f"GBA over {n} ranks: rank {r['rank']} differs from rank 0")
        d_t = float((g0["map"].kf_T_cw.t - single_np[0]).abs().max())
        d_R = float((g0["map"].kf_T_cw.R - single_np[1]).abs().max())
        d_p = float((g0["map"].lm_pos - single_np[2])[val].abs().max())
        if max(d_t, d_R, d_p) > SHARDED_TOL:
            fails.append(f"GBA over {n} ranks differs from global_ba: {d_t}, {d_R}, {d_p}")
        if not all(r["gba"]["same"] for r in res):
            fails.append(f"GBA over {n} ranks: its solves not bit-equal")
        if g0["collectives"] != 6 * BA_ITERS + 1:
            fails.append(f"GBA over {n} ranks: {g0['collectives']} collectives in "
                         f"{BA_ITERS} iterations")
        solver_lines.append(_solver_line(f"GBA over {n} ranks (a mesh correction's)",
                                         g0["modes"], all(r["gba"]["same"] for r in res),
                                         g0["regions"]))
        gba_lines.append(
            f"{n} ranks: {g0['ms_iter']:.2f} ms an iteration captured ({g0['allreduce_ms_iter']:.2f} ms "
            f"of it in its {g0['collectives']} collectives, timed pass), peak "
            f"{max(r['gba']['peak_gb'] for r in res):.3f} GB a rank with its graph pools (Y {K_cap * m.lm_valid.shape[0] // n * 72 / 1e9:.3f} GB), "
            f"solves bit-equal ({'/'.join(g0['modes'])}) {all(r['gba']['same'] for r in res)}, max |d| to global_ba "
            f"t {d_t:.1e} m / R {d_R:.1e} / points {d_p:.1e} m, chi2 "
            f"{float(g0['chis'][0]):.1f} -> {float(g0['chis'][-1]):.1f}, launch "
            f"{res[0]['launch_s']:.1f} s")
    two = runs[2]
    r0 = two[0]
    ob_single, ob_stats = ba.bundle_adjust(K, ba.BAProblem(
        m.kf_T_cw, m.lm_pos, ba.Observations(m.obs_kf, m.obs_lm, m.obs_uvr, m.obs_sigma2,
                                             m.obs_valid),
        torch.logical_not(m.kf_valid) | (torch.arange(K_cap, device=dev) == 0),
        torch.logical_not(m.lm_valid)), iters=PARALLEL_OBS_ITERS, damping=1e-3)
    d_ob = max(float((r0["obs"]["T"].t - ob_single.T_cw.t.cpu()).abs().max()),
               float((r0["obs"]["points"] - ob_single.points.cpu())[val].abs().max()))
    if d_ob > SHARDED_TOL:
        fails.append(f"observation-sharded BA differs from bundle_adjust by {d_ob}")
    T_pgo, chis_pgo = r0["pgo"]["result"]
    for what in ("obs", "pgo"):
        if not all(r[what]["same"] for r in two):
            fails.append(f"{what}: its eager and captured solves not bit-equal")
    solver_lines += [_solver_line(f"{what} over 2 ranks", r0[key]["modes"],
                                  all(r[key]["same"] for r in two), r0[key]["regions"])
                     for what, key in (("observation-sharded BA", "obs"),
                                       ("edge-sharded PGO", "pgo"))]
    d_pgo = max(float((T_pgo.t - T_single.t.cpu()).abs().max()),
                float((T_pgo.R - T_single.R.cpu()).abs().max()))
    if d_pgo > PGO_TOL:
        fails.append(f"distributed PGO differs from optimize_pose_graph by {d_pgo}")
    g, gs = r0["grid"], _tree_to(grid_single, cpu)
    fusion_exact = all(torch.equal(getattr(g, f), getattr(gs, f))
                       for f in ("count", "z_min", "z_max", "cost"))
    if not fusion_exact:
        fails.append("sharded fusion: counts, z extrema or cost differ from the single rank's")
    ray_exact = all(torch.equal(a, b.cpu()) for a, b in zip(r0["ray"], ray_single))
    if not ray_exact:
        fails.append("sharded raycast differs from the single rank's")
    for what in ("fusion", "raycast"):
        for r in two:
            st = r["stages"][what]
            if not (st["same"] and all(v["calls"] == STAGE_CALLS
                                       and v["captured"] for v in st["regions"].values())):
                fails.append(f"sharded {what} on rank {r['rank']}: captured equal to eager "
                             f"{st['same']}, regions {st['regions']}")
    p0, p1 = (r["pipeline"] for r in two)
    outs = p1["outs"]
    d_pose, seq_same = {}, {}
    for mode, (poses, kfs, inl, _) in seq.items():
        d_pose[mode] = float((outs.pose_wc - poses).abs().max())
        seq_same[mode] = outs.was_keyframe.tolist() == kfs and outs.n_inliers.tolist() == inl
        if d_pose[mode] > PIPELINE_TOL or not seq_same[mode]:
            fails.append(f"stage pipeline differs from the {mode} sequential path: poses "
                         f"{d_pose[mode]}, keyframes {outs.was_keyframe.tolist()} vs {kfs}, "
                         f"inliers {outs.n_inliers.tolist()} vs {inl}")
    if not all(r["pipeline"]["same"] for r in two):
        fails.append("stage pipeline: captured not bit-equal to capture=False")
    stage_counts = {k: p0["launches"][k] + p1["launches"][k] for k in p0["launches"]}
    if p0["launches"]["describe"] != 2 * PIPELINE_FRAMES or p1["launches"]["describe"] \
            or stage_counts["top2"] <= 0 \
            or any(p["modes"]["eager"]["launches"] != p["launches"] for p in (p0, p1)):
        fails.append(f"stage pipeline launches (eager, captured): rank 0 "
                     f"{p0['modes']['eager']['launches']}, {p0['launches']}, rank 1 "
                     f"{p1['modes']['eager']['launches']}, {p1['launches']}")
    if not all(r["pipeline"]["regions"] and all(v["captured"] for v in r["pipeline"]["regions"]
                                                .values() if v["calls"] >= 2) for r in two):
        fails.append("stage pipeline regions not captured: "
                     f"{[r['pipeline']['regions'] for r in two]}")
    cor = [r["correction"] for r in two]
    if not all(p["same"] for c in cor for p in c["passes"]):
        fails.append("mesh correction / refine_map: a captured engine differs from the eager one")
    if not (torch.equal(cor[0]["kf_t"], cor[1]["kf_t"])
            and torch.equal(cor[0]["lm_pos"], cor[1]["lm_pos"])):
        fails.append("mesh correction: the ranks' maps differ")
    last = cor[0]["passes"][-1]["stats"]
    mesh_regions = {k: v for k, v in last.items()
                    if k.startswith(("loop_correct", "loop_rebase", "refine"))}
    if not (any(k.startswith("loop_correct") and "+gba_dist" in k for k in mesh_regions)
            and "loop_rebase" in mesh_regions
            and all(v["captured"] for v in mesh_regions.values())):
        fails.append(f"mesh correction regions: {mesh_regions}")
    mh, dry_line, entry_s = _parallel_entry_points(dev)
    if not (all(r["n_devices"] == 2 and r["chi2_last"] < 0.2 * r["chi2_first"] for r in mh)
            and mh[0]["chi2_last"] == mh[1]["chi2_last"]):
        fails.append(f"multihost results: {mh}")
    log(f"[15 parallel] GBA landmark-sharded on the loop map ({K_cap} keyframes x "
        f"{m.lm_valid.shape[0]} landmarks x {m.obs_valid.shape[0]} observations, {BA_ITERS} "
        f"iterations, every rank on {dev} over gloo): global_ba on one rank "
        f"{single_ms:.2f} ms an iteration, peak {single_peak:.3f} GB; " + "; ".join(gba_lines))
    log(f"[15 parallel] observation-sharded BA (2 ranks, {PARALLEL_OBS_ITERS} iterations): "
        f"{r0['obs']['modes']['captured']['ms']:.2f} ms an iteration captured "
        f"({r0['obs']['allreduce_ms_iter']:.2f} ms in its all-reduces), max |d| to "
        f"bundle_adjust {d_ob:.1e}; PGO edge-sharded over {edges.valid.shape[0]} edges "
        f"({int(edges.valid.sum())} valid), {lcfg.pgo_iters} iterations: "
        f"{r0['pgo']['modes']['captured']['ms']:.2f} ms an iteration captured against "
        f"{pgo_single_ms:.2f} on "
        f"one rank, max |d| {d_pgo:.1e}, chi2 {float(chis_pgo[0]):.3e} -> "
        f"{float(chis_pgo[-1]):.3e}; fusion of phase 8's {pts_w.shape[0]} cloud points: "
        f"counts, z extrema and cost equal to one rank's {fusion_exact}; raycast of "
        f"{fr.goal_xy.shape[0]} frontiers ({int(fr.valid.sum())} valid) exact {ray_exact}")
    pm = {mode: (p0["modes"][mode], p1["modes"][mode]) for mode in ("eager", "captured")}
    host = lambda mode, r: "{:.1f} kernels + {:.1f} graphs".format(*pm[mode][r]["host"])
    log(f"[15 parallel] stage pipeline at bench width ({PIPELINE_FRAMES} frames, frontend on "
        f"rank 0, backend on rank 1, both on {dev}), frames/s: eager {pm['eager'][0]['fps']:.2f}, "
        f"captured {pm['captured'][0]['fps']:.2f}, bit-equal "
        f"{all(r['pipeline']['same'] for r in two)}; "
        f"sequential on one rank: eager {seq['eager'][3]:.2f}, captured (a StereoSlam "
        f"replaying) {seq['captured'][3]:.2f}; max |d pose| to them "
        f"{d_pose['eager']:.1e} / {d_pose['captured']:.1e}, keyframes "
        f"{int(outs.was_keyframe.sum())} "
        f"and inliers equal {seq_same['eager']} / {seq_same['captured']}; host launches a frame "
        f"(torch.profiler, frames 1-{PIPELINE_PROFILE_FRAMES}), eager: rank 0 "
        f"{host('eager', 0)}, rank 1 {host('eager', 1)}; "
        f"captured: rank 0 {host('captured', 0)}, rank 1 {host('captured', 1)}; K1 / K2 "
        f"launches rank 0 {p0['launches']}, rank 1 {p1['launches']} (eager the same); regions "
        f"(calls, capture s, pool MB): "
        + ", ".join(f"{k} {v['calls']} {_pool(v)}" for r in two
                    for k, v in r["pipeline"]["regions"].items())
        + f"; multihost (2 processes, gloo on {dev}): chi2 {mh[0]['chi2_first']:.1f} -> "
        f"{mh[0]['chi2_last']:.4f}, {mh[0]['ba_iters_per_s']:.1f} iterations/s; {dry_line}; "
        f"entry points {entry_s:.1f} s")
    ms = lambda xs: " / ".join(f"{x:.2f}" for x in xs)
    stage_line = "; ".join(
        f"{what}: host ms a call eager {ms(r0['stages'][what]['ms']['eager'])}, captured "
        f"(warm-up / capture / replay) {ms(r0['stages'][what]['ms']['captured'])}, bit-equal "
        f"{all(r['stages'][what]['same'] for r in two)}; regions "
        + ", ".join(f"{k} {v['calls']} calls {_pool(v)}"
                    for k, v in r0["stages"][what]["regions"].items())
        for what in ("fusion", "raycast"))
    cor_line = "; ".join(
        f"{p['label']}: correction {ms(p['correct_ms'])}, refine {p['refine_ms']:.2f}, "
        f"bit-equal to eager {p['same']}" for p in cor[0]["passes"])
    log(f"[15 parallel] captured sharded stages over 2 ranks on {dev} (gloo), called "
        f"{STAGE_CALLS} times a mode: {stage_line}. Phase 10's first correction of seed 1 and "
        f"refine_map({MESH_REFINE_CYCLES} cycles) on an engine whose loop closer has the 2-rank "
        f"mesh (GBA chi2 {cor[0]['passes'][0]['gba_chi2']:.4f}, refine chi2 "
        f"{cor[0]['passes'][0]['chi2']:.4f}; eager counts 1), host ms on rank 0: {cor_line}; "
        f"the ranks' maps equal; regions (capture s, pool): "
        + ", ".join(f"{k} {_pool(v)}" for k, v in mesh_regions.items())
        + "; the 2-rank launch's seconds on rank 0: "
        + ", ".join(f"{k} {v:.1f}" for k, v in r0["seconds"].items()))
    log("[15 parallel] captured solvers (eager against captured over 2 ranks), every rank on "
        f"{dev} over gloo: " + "; ".join(solver_lines)
        + f"; phase {time.monotonic() - t_phase:.1f} s")
    if fails:
        raise AssertionError("[15 parallel] " + "; ".join(fails))
    return stage_counts

# ---------------------------------------------------------------------------
# Phase 16: the measurement entry points (fitslam_tpu_torch/bench.py,
# bench_suite.py, graft_entry.py)
# ---------------------------------------------------------------------------

# the modes run in this process at full width, their frames or steps cut
BENCH_CUT = {"rgbd_fusion": dict(n_frames=20), "active_slam": dict(n_frames=24),
             "marsyard": dict(n_frames=24), "ablation": dict(n_steps=40)}
# each record's extra keys: the reference's (bench_suite.py:334-340, :430-438,
# :783-791, :673-678, :469-475, :522-566; bench.py:117-136) and the port's
# platform and device (scaling adds its collectives, backend and card sharing)
BENCH_KEYS = {
    "rgbd_fusion": {"n_keyframes", "grid", "frontiers_final", "resolution"},
    "active_slam": {"ate_rmse_m", "coverage", "goals_sent", "fi_rejections", "n_keyframes",
                    "includes"},
    "marsyard": {"terrain_lethal_cells", "lethal_precision_vs_gt", "gt_lethal_violations",
                 "final_coverage", "goals_sent", "world", "artifacts"},
    "ablation": {"methods", "best", "csv", "world", "steps"},
    "ba": {"local", "global"},
    "scaling": {"t1_s", "t2_s", "speedup_2dev", "efficiency_2dev", "chi2_1dev", "chi2_2dev",
                "chi2_8dev", "problem", "coupling_Y_bytes_per_dev", "bytes_psum_per_iter",
                "chi2_parity_all_mesh_sizes", "note", "collectives_per_iter",
                "collectives_ms_per_iter", "backend", "ranks_share_card"},
    "headline": {"ate_rmse_m", "n_keyframes", "n_landmarks", "resolution", "features", "levels",
                 "loop_slam"},
}
# the reference's artifacts at the repo root, which no mode may touch
COMMITTED_ARTIFACTS = ("ABLATION_COVERAGE.csv", "ABLATION_COVERAGE.png", "MARSYARD_COVERAGE.csv",
                       "MARSYARD_TRAJECTORY.ppm", "BENCH_SUITE.json")


def _bench_record(rec, name, what):
    """``rec`` checked: the reference's keys and the port's, platform gpu,
    finite numbers."""
    def finite(x):
        if isinstance(x, dict):
            return all(finite(v) for v in x.values())
        if isinstance(x, list):
            return all(finite(v) for v in x)
        return not isinstance(x, float) or math.isfinite(x)

    want = BENCH_KEYS[name] | {"platform", "device"}
    if set(rec) != {"metric", "value", "unit", "vs_baseline", "extra"} or set(rec["extra"]) != want:
        raise AssertionError(f"[16 bench] {what}: keys {sorted(rec)} / {sorted(rec['extra'])}, "
                             f"expected the extra keys {sorted(want)}")
    if rec["extra"]["platform"] != "gpu" or not finite(rec):
        raise AssertionError(f"[16 bench] {what}: platform {rec['extra']['platform']}, finite "
                             f"{finite(rec)}")
    return rec


def _bench_cli(args, what):
    """``python -m args`` on the card: (its one JSON record, seconds with the
    interpreter's start)."""
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    secs = time.monotonic() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"[16 bench] {what} exited {proc.returncode} with {len(lines)} "
                             f"lines:\n{proc.stdout}\n{proc.stderr[-4000:]}")
    return json.loads(lines[0]), secs


def _in_process(fn, *args, **kwargs):
    """fn's record, its printed line kept off this script's output."""
    import io
    from contextlib import redirect_stdout

    with redirect_stdout(io.StringIO()) as out:
        rec = fn(*args, **kwargs)
    if json.loads(out.getvalue()) != json.loads(json.dumps(rec)):
        raise AssertionError(f"[16 bench] {fn.__name__} printed another record than it returned")
    return rec


def _entry_check(dev):
    """graft_entry.entry()'s step on the card against the same step on the
    CPU, with ROADMAP F5's tolerances: pose within 1e-3, lm_match agreement
    >= 98 %, inliers within 2 %. The two devices' pyramids differ in float32
    ulps (F1), so near-equal corner responses may rank in another order, and
    the map's landmarks (spawned in feature order) with them: a feature's
    match is compared with that of the feature at its position (within 0.01
    px) on the other device, by the matched landmark's position (within 1e-3
    m; both unmatched agree). The card's step launches K1's describe twice
    and K2."""
    from fitslam_tpu_torch import graft_entry
    from fitslam_tpu_torch.models import tracking as tr
    from fitslam_tpu_torch.parallel.dryrun import small_setup

    def run(device):
        step, args = graft_entry.entry(device)
        cfg, K, _, _ = small_setup(320, 240, device)
        o = cfg.orb
        xy = tr.process_stereo(K, args[0], args[1], num_features=o.num_features,
                               num_levels=o.num_levels, scale_factor=o.scale_factor,
                               fast_threshold=o.fast_threshold).feats.xy
        step(*args)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
            _reset_counts()
        T, lm, n = step(*args)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        pos = torch.where((lm >= 0)[:, None], args[2].lm_pos[lm.clamp(min=0).long()],
                          torch.full((1, 3), float("nan"), device=lm.device))
        return args, xy.cpu(), T.cpu(), pos.cpu(), lm.cpu(), int(n)

    args, xy, T, pos, lm, n = run(dev)
    launches = _counts()
    args_c, xy_c, T_c, pos_c, lm_c, n_c = run("cpu")
    same_input = all(torch.equal(a.cpu(), b) for a, b in zip(args[:2], args_c[:2]))
    d_pose = (T - T_c).abs().max().item()
    dist, j = torch.cdist(xy.double(), xy_c.double()).min(dim=1)
    d_lm = (pos - pos_c[j]).abs().amax(dim=1)
    same_lm = (d_lm <= 1e-3) | (pos.isnan().all(dim=1) & pos_c[j].isnan().all(dim=1))
    agree = ((dist < 0.01) & same_lm).double().mean().item()
    same_order = (lm == lm_c).double().mean().item()
    line = (f"graft_entry.entry() step on the card vs the CPU: pose |d| {d_pose:.2e}, lm_match "
            f"agreement {agree:.4f} by position ({same_order:.4f} by index), inliers {n} vs "
            f"{n_c}, inputs bit-equal {same_input}; launches a step {launches}")
    if not (d_pose <= 1e-3 and agree >= 0.98 and abs(n - n_c) <= 0.02 * n_c and n_c > 100):
        raise AssertionError(f"[16 bench] {line}")
    if launches["describe"] != 2 or launches["top2"] < 1:
        raise AssertionError(f"[16 bench] {line}: expected 2 describes and K2")
    return line, launches


@contextmanager
def _launch_results():
    """Within the block, ``mesh.launch``'s results are also appended to the
    yielded list (a mode's figures the record leaves out: its regions)."""
    from fitslam_tpu_torch.parallel import mesh as mesh_mod

    got, real = [], mesh_mod.launch

    def launch(*args, **kwargs):
        got.append(real(*args, **kwargs))
        return got[-1]

    mesh_mod.launch = launch
    try:
        yield got
    finally:
        mesh_mod.launch = real


def _ba_captured(dev):
    """ba.BundleAdjuster at --mode ba's two sizes (8 iterations): its
    warm-up, capture and a replay against the plain bundle_adjust, bit for
    bit. Returns (all equal, {size: ba_solve's stats})."""
    from fitslam_tpu_torch import bench_suite
    from fitslam_tpu_torch.ops import ba
    from fitslam_tpu_torch.utils import jit, prng

    K = bench_suite.ba_intrinsics(dev)
    same, regions = True, {}
    for name, sz in bench_suite.BA_SIZES.items():
        prob, _, _ = bench_suite.make_ba_problem(prng.prng_key(7), **sz, device=dev)
        solve = ba.BundleAdjuster(dev, sz["n_kf"], sz["n_lm"], sz["n_obs"], iters=8)
        want = jit.flatten(ba.bundle_adjust(K, prob, iters=8))[0]
        for _ in range(3):
            got = jit.flatten(solve(K, prob))[0]
            same = same and all(torch.equal(a, b) for a, b in zip(got, want))
        regions[name] = solve.capture_stats["ba_solve"]
        del solve, got, want
    return same, regions


def phase_bench_entry(dev, bench_fps):
    """[16 bench]: ``python -m fitslam_tpu_torch.bench`` (the headline and
    its loop block; ATE <= 0.025 m, a seed with loops), the kernels, ba and
    scaling modes in full (ba through its command line), the other modes at
    full width and cut depth in this process (their launches counted), each
    record's keys checked; the reference's committed artifacts untouched;
    then graft_entry.entry()'s step against the CPU's. Returns the launches
    of the in-process modes and of the entry step."""
    import hashlib

    from fitslam_tpu_torch import bench_suite

    t_phase = time.monotonic()
    digest = lambda: {f: hashlib.sha256((ROOT / f).read_bytes()).hexdigest()
                      for f in COMMITTED_ARTIFACTS if (ROOT / f).exists()}
    before = digest()
    head, secs = _bench_cli(["fitslam_tpu_torch.bench"], "python -m fitslam_tpu_torch.bench")
    _bench_record(head, "headline", "bench")
    ex, loop = head["extra"], head["extra"]["loop_slam"]
    log(f"[16 bench] python -m fitslam_tpu_torch.bench: {head['value']} frames/s (phase 5's "
        f"passes: {', '.join(f'{f:.2f}' for f in bench_fps)}), ATE {ex['ate_rmse_m']} m, "
        f"{ex['n_keyframes']} keyframes; loop_slam {loop['frames_per_s_per_chip']} frames/s, "
        f"ATE {loop['ate_rmse_m']} m (max {loop['ate_rmse_m_max']}, uncorrected "
        f"{loop['ate_rmse_uncorrected_m']}), seeds with loops {loop['seeds_with_loops']} of "
        f"{loop['n_seeds']}; {secs:.1f} s with the interpreter's start; {ex['device']}")
    if not (ex["ate_rmse_m"] <= ATE_BOUND_M and loop["seeds_with_loops"] >= 1):
        raise AssertionError(f"[16 bench] the headline misses ATE <= {ATE_BOUND_M} m or closed "
                             f"no loop: {head}")
    ba, secs = _bench_cli(["fitslam_tpu_torch.bench_suite", "--mode", "ba"],
                          "bench_suite --mode ba")
    _bench_record(ba, "ba", "ba")
    t0 = time.monotonic()
    same, regions = _ba_captured(dev)
    log(f"[16 bench] bench_suite --mode ba (captured, its command line): " + ", ".join(
        f"{k} {v['iters_per_s']} iterations/s ({v['n_kf']}/{v['n_lm']}/{v['n_obs']}, chi2 "
        f"{v['final_chi2']})" for k, v in ba["extra"].items() if k in ("local", "global"))
        + f", {secs:.1f} s; BundleAdjuster (warm-up, capture, replay) bit-equal to "
        f"bundle_adjust {same}, ba_solve (capture s, pool MB) "
        + ", ".join(f"{k} {_pool(v)}" for k, v in regions.items())
        + f"; {time.monotonic() - t0:.1f} s")
    if not same:
        raise AssertionError("[16 bench] ba: BundleAdjuster differs from bundle_adjust")
    t0 = time.monotonic()
    with _launch_results() as res:
        sc = _bench_record(_in_process(bench_suite.bench_scaling, False, dev), "scaling",
                           "scaling")
    e = sc["extra"]
    log(f"[16 bench] scaling (captured): 1 / 2 ranks {e['t1_s']} / {e['t2_s']} s a solve, "
        f"efficiency_2dev {e['efficiency_2dev']} (ranks share card 0: {e['ranks_share_card']}, "
        f"not a scaling figure), chi2 {e['chi2_1dev']} / {e['chi2_2dev']} / {e['chi2_8dev']} "
        f"(1 / 2 / 8 ranks), collectives an iteration {e['collectives_per_iter']}, their ms "
        f"{e['collectives_ms_per_iter']}; regions a rank (capture s, pool MB) "
        + "; ".join(f"{n} ranks: " + ", ".join(
            f"{k} {_pool(v)}" for solver in r["regions"].values() for k, v in solver.items())
            for n, r in res[0][0].items())
        + f"; {time.monotonic() - t0:.1f} s")
    if not e["chi2_parity_all_mesh_sizes"]:
        raise AssertionError(f"[16 bench] scaling: chi2 differs between the meshes: {e}")
    t0 = time.monotonic()
    kr = _in_process(bench_suite.bench_kernels, False, dev)
    if kr["metric"] != "kernel_match_us_at_map_capacity" or kr["extra"]["platform"] != "gpu":
        raise AssertionError(f"[16 bench] kernels: {kr}")
    log("[16 bench] kernels (device us, queue pre-filled; plain twin; library; bound): "
        + "; ".join(f"{k} {v['ms'] * 1e3:.1f} / {v['plain_ms'] * 1e3:.1f} / "
                    + ("-" if v["library_ms"] is None else f"{v['library_ms'] * 1e3:.1f}")
                    + f" / {v['bound_ms'] * 1e3:.2f} ({v['bound_by']})"
                    for k, v in kr["extra"].items() if isinstance(v, dict))
        + f"; {time.monotonic() - t0:.1f} s")
    _reset_counts()
    for name, cut in BENCH_CUT.items():
        t0 = time.monotonic()
        rec = _bench_record(_in_process(bench_suite.MODES[name], False, device=dev, **cut), name,
                            name)
        log(f"[16 bench] {name} {cut}: {rec['value']} {rec['unit']}, "
            + json.dumps({k: v for k, v in rec["extra"].items() if k != "device"})
            + f"; {time.monotonic() - t0:.1f} s")
    modes = _counts()
    if modes["describe"] <= 0 or modes["top2"] <= 0 or modes["sweep"] <= 0 or modes["gather"]:
        raise AssertionError(f"[16 bench] the in-process modes' launches: {modes}")
    written = [p for p in ("ABLATION_COVERAGE.csv", "MARSYARD_COVERAGE.csv",
                           "MARSYARD_TRAJECTORY.ppm")
               if not (bench_suite.ARTIFACTS / p).is_file()]
    if digest() != before or written:
        raise AssertionError(f"[16 bench] the committed artifacts changed ({digest() != before}) "
                             f"or build/bench lacks {written}")
    line, step = _entry_check(dev)
    log(f"[16 bench] {line}; modes' launches {modes}; the committed artifacts byte-identical; "
        f"phase {time.monotonic() - t_phase:.1f} s")
    return modes, step



CAPTURE_PASSES = (False, True, True)   # eager, captured, captured (the second eager pass cut
                                       # to keep the script inside its time limit)


def _host_launches(prof, since=None):
    """(kernel launches, graph launches) the host made in a profiler window,
    from its CUDA runtime and driver calls; with ``since`` (profiler us),
    those made from then on."""
    kernels = graphs = 0
    if since is None:
        counts = [(e.key, e.count) for e in prof.key_averages()
                  if e.device_type != torch.autograd.DeviceType.CUDA]
    else:
        counts = [(e.name, 1) for e in prof.events()
                  if e.device_type != torch.autograd.DeviceType.CUDA
                  and e.time_range.start >= since]
    for key, count in counts:
        if key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                   "cuLaunchKernelEx"):
            kernels += count
        elif key.startswith("cudaGraphLaunch") or key.startswith("cuGraphLaunch"):
            graphs += count
    return kernels, graphs


def _profiled_frames(dev, cfg, frames, capture):
    """torch.profiler over frames PROFILE_FRAMES of a fresh engine's async
    pass: kernels a frame on the device, the host's kernel and graph
    launches a frame, the busy share and the window's host ms a frame."""
    from fitslam_tpu_torch.models.slam import StereoSlam

    slam = StereoSlam(cfg, dev, capture=capture)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    for i, (l, r) in enumerate(frames[:PROFILE_FRAMES[1]]):
        if i == PROFILE_FRAMES[0]:
            torch.cuda.synchronize()
            prof.__enter__()
            t0 = time.perf_counter()
        slam.process_frame_async(l, r)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    prof.__exit__(None, None, None)
    slam.finalize()
    n = PROFILE_FRAMES[1] - PROFILE_FRAMES[0]
    times = _kernel_times(prof)
    busy_us = sum(t for t, _ in times.values())
    host_k, host_g = _host_launches(prof)
    if busy_us <= 0:
        raise AssertionError("[17 captured] the profiler recorded no device time")
    return dict(kernels=sum(c for _, c in times.values()) / n, host_kernels=host_k / n,
                host_graphs=host_g / n, busy=busy_us / 1e4 / window_s,
                ms=window_s / n * 1e3, kernel_ms=busy_us / n / 1e3)


def phase_captured(dev, smi):
    """[17 captured]: the headline's frame step eager and captured in turns
    (CAPTURE_PASSES) through bench.timed_pass, each pass on a fresh engine:
    bit-equal poses, maps and outs_log values, equal K1 / K2 counts; then a
    profiler window of each mode, each line naming the card (``smi``).
    Returns the second captured pass's launches."""
    from fitslam_tpu_torch.models.slam import StereoSlam
    from fitslam_tpu_torch.utils import evaluation as ev
    from fitslam_tpu_torch.utils import jit

    t_phase = time.monotonic()
    cfg = headline_config()
    frames, gt = headline_frames(cfg, dev)
    jit.release_idle()           # the first captured pass captures here
    passes = []
    for capture in CAPTURE_PASSES:
        slam = StereoSlam(cfg, dev, capture=capture)
        _reset_counts()
        fps = timed_pass(slam, frames, dev)
        counts = _counts()
        outs = [torch.stack([getattr(o, f).float().reshape(-1) for o in slam.outs_log]).cpu()
                for f in slam.outs_log[0]._fields]
        stats = slam.capture_stats
        slam.finalize()
        passes.append(dict(
            capture=capture, fps=fps, counts=counts, outs=outs, stats=stats,
            traj=np.stack(slam.trajectory), ate=ev.ate_rmse(slam.trajectory, gt),
            map=[t.cpu() for t in jit.flatten(slam.map)[0]], n_kf=int(slam.map.n_kf)))
        del slam                 # the next captured engine takes its graphs
    first = passes[0]
    diff = max(float(np.abs(p["traj"] - first["traj"]).max()) for p in passes)
    same_map = all(all(torch.equal(a, b) for a, b in zip(p["map"], first["map"]))
                   for p in passes)
    same_outs = all(all(torch.equal(a, b) for a, b in zip(p["outs"], first["outs"]))
                    for p in passes)
    cap1, cap2 = [p for p in passes if p["capture"]]
    # a region the first pass captured is not captured again (one that it
    # only warmed up, such as track_uninitialized, is captured on its second call)
    reused = all(cap2["stats"][r]["calls"] > s["calls"]
                 and (not s["captured"] or cap2["stats"][r]["capture_s"] == s["capture_s"])
                 for r, s in cap1["stats"].items())
    nf = N_BENCH_FRAMES
    log(f"[17 captured] headline {cfg.camera.width}x{cfg.camera.height}, {nf} frames, passes "
        + ", ".join(f"{'captured' if p['capture'] else 'eager'} {p['fps']:.2f} frames/s "
                    f"({1e3 / p['fps']:.2f} host ms a frame)" for p in passes)
        + f"; max |pose difference| {diff}, maps equal {same_map}, outs_log values equal "
        f"{same_outs}; K1 / K2 launches a frame "
        + ", ".join(f"{p['counts']['describe'] / nf:.2f} / {p['counts']['top2'] / nf:.2f}"
                    for p in passes)
        + f"; ATE {first['ate']:.4f} m, {first['n_kf']} keyframes; the second captured engine "
        f"took the first one's graphs: {reused}; {smi}")
    log("[17 captured] regions (calls over both captured passes, capture s, graph pool GB): "
        + "; ".join(f"{r} {s['calls']}, "
                    + ("not captured" if not s["captured"] else
                       f"{s['capture_s']:.3f} s, {s['pool_bytes'] / 1e9:.3f} GB")
                    for r, s in cap2["stats"].items())
        + f"; pools {sum(s['pool_bytes'] or 0 for s in cap2['stats'].values()) / 1e9:.3f} GB; "
        f"{smi}")
    prof = {capture: _profiled_frames(dev, cfg, frames, capture) for capture in (False, True)}
    log(f"[17 captured] torch.profiler over frames {PROFILE_FRAMES[0]}-{PROFILE_FRAMES[1] - 1}: "
        + "; ".join(f"{'captured' if c else 'eager'} {r['ms']:.2f} host ms a frame, kernel time "
                    f"{r['kernel_ms']:.3f} ms a frame (busy {r['busy']:.2f} %), "
                    f"{r['kernels']:.1f} kernels a frame on the device, host launches a frame "
                    f"{r['host_kernels']:.1f} kernels + {r['host_graphs']:.1f} graphs"
                    for c, r in prof.items())
        + f"; phase {time.monotonic() - t_phase:.1f} s; {smi}")
    if diff != 0.0 or not same_map or not same_outs:
        raise AssertionError(f"[17 captured] captured and eager differ: poses {diff}, maps "
                             f"equal {same_map}, outs_log equal {same_outs}")
    if any((p["counts"]["describe"], p["counts"]["top2"])
           != (first["counts"]["describe"], first["counts"]["top2"]) for p in passes) \
            or first["counts"]["describe"] != 2 * nf or first["counts"]["top2"] <= 0:
        raise AssertionError(f"[17 captured] K1 / K2 launches: {[p['counts'] for p in passes]}")
    if not (first["ate"] <= ATE_BOUND_M and reused):
        raise AssertionError(f"[17 captured] ATE {first['ate']} or the graphs were captured "
                             f"again ({reused})")
    if prof[True]["host_graphs"] <= 0:
        raise AssertionError("[17 captured] the profiler saw no graph launch")
    return cap2["counts"]


# ---------------------------------------------------------------------------
# Phase 18: the active loop's other captured programs
# ---------------------------------------------------------------------------

LOOP_PASSES = (False, True, True)     # eager, captured (captures), captured
LOOP_PROFILE_CALLS = 4                # flushes / ticks a profiler window holds
LOOP_REGIONS = ("ekf_odom", "ekf_map", "overlay", "tick", "fuse_keyframe", "fuse_grid")
FUSION_REPS = 20                      # keyframe fusions timed a mode


def _loop_profile(system, what):
    """torch.profiler over LOOP_PROFILE_CALLS flushes of a frame's rows
    (``what`` "flush": odometry and IMU rates for both filters, a SLAM pose
    for the map filter) or exploration ticks ("tick") of a finished run's
    system: a call's host ms, kernels on the device, the host's kernel and
    graph launches, the busy share, and for a tick the host's kernel
    launches after its packed read."""
    ex = system.explorer

    def call():
        if what == "flush":
            system.ekf.add_odom(0.5, 0.0, 0.15)
            system.ekf.add_imu(0.0, 0.0, 0.1, 0.0, gate=0.8)
            system.ekf.add_pose(0.0, 0.0, 0.0, gate=3.0)
            system.ekf.flush()
        else:
            ex.tick()

    call()
    read, after = ex._read, []

    def marked_read(t, site):
        v = read(t, site)
        if not after:            # the tick's packed read: what follows is eager
            after.append(torch.profiler.record_function("after_read"))
            after[0].__enter__()
        return v

    def one():
        call()
        if after:
            after.pop().__exit__(None, None, None)

    ex._read = marked_read
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    with prof:
        prime_window(one)
        with torch.profiler.record_function(MEASURED):
            t0 = time.perf_counter()
            for _ in range(LOOP_PROFILE_CALLS):
                one()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    ex._read = read
    n = LOOP_PROFILE_CALLS
    since = measured_since(prof)
    times = _kernel_times(prof, since)
    times.pop("after_read", None)     # the marker's own range, not a kernel
    busy_us = sum(t for t, _ in times.values())
    host_k, host_g = _host_launches(prof, since)
    launch = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")

    def after_read(e):
        while e is not None:
            if e.name == "after_read":
                return True
            e = e.cpu_parent
        return False

    late = sum(1 for e in prof.events()
               if e.name in launch and e.time_range.start >= since and after_read(e))
    if busy_us <= 0:
        raise AssertionError(f"[18 loops] the profiler recorded no device time in a {what}")
    top = sorted(times.items(), key=lambda kv: -kv[1][0])[:4]
    return dict(ms=window_s / n * 1e3, kernels=sum(c for _, c in times.values()) / n,
                kernel_ms=busy_us / n / 1e3, host_kernels=host_k / n, host_graphs=host_g / n,
                after_read=late / n, busy=busy_us / 1e4 / window_s,
                top="; ".join(f"{name[:50]} {t / n:.1f} us x{c / n:.0f}"
                              for name, (t, c) in top))


def _fusion_ms(system, kf_idx):
    """Host ms of one keyframe's fusion (``fuse_keyframe``, then the grid's
    ``fuse_grid`` at the next read) on a finished run's system, its last
    cloud fused again FUSION_REPS times, each between two synchronizes."""
    cloud = system.clouds.points[0].clone()
    valid = system.clouds.valid[0].clone()
    total = 0.0
    for _ in range(FUSION_REPS):
        system._pending_cloud[system.slam.last_keyframe_frame_id] = (cloud, valid)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system._on_keyframe(system.slam, kf_idx)
        system.occupancy()
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return total / FUSION_REPS * 1e3


def phase_loops(dev, smi):
    """[18 loops]: phase 12's cell (phase 8's active cell with the EKF on,
    ACTIVE_BENCH_FRAMES frames on the simulation's clock) with
    ``ActiveSlamSystem(capture=False)`` and ``capture=True`` in turns
    (LOOP_PASSES): the EKF trajectories and final P, the goals sent, the
    explorer's counts and roadmap, the fused grid and the SLAM poses
    bit-equal, K3's launches equal; host ms a flush, a tick, a frame and a
    keyframe's fusion in each mode, a profiler window of flushes and of ticks
    in each mode, the new regions' capture seconds and pool bytes (phase 19
    profiles phase 7's G = 320 loop in both modes). Returns the last
    captured pass's launches."""
    from fitslam_tpu_torch.models.localization import TwistMux
    from fitslam_tpu_torch.ops.grid import GridSpec2D
    from fitslam_tpu_torch.utils import jit

    t_phase = time.monotonic()
    spec = GridSpec2D(64, 0.25, -8.0, -8.0)
    cfg = ekf_config()
    world = rooms_world(spec, dev, floor_points=4000)
    jit.release_idle()           # the first captured pass captures here
    passes = []
    for i, capture in enumerate(LOOP_PASSES):
        r = run_active(dev, cfg, spec, world.landmarks, (-5.0, -5.0, 0.3), ACTIVE_BENCH_FRAMES,
                       twist_mux=TwistMux(), capture=capture)
        system = r["system"]
        passes.append(dict(r=r, capture=capture, stats=system.capture_stats,
                           ekf=np.array([[xy[0], xy[1], yaw] for xy, yaw in r["ekf"]]),
                           P=system.ekf.map_state.P.cpu(),
                           roadmap=[t.cpu() for t in jit.flatten(system.explorer.roadmap)[0]],
                           traj=np.stack(system.slam.trajectory),
                           diag=dict(vars(system.explorer.diag))))
        if capture and i + 1 < len(LOOP_PASSES):
            # the next captured system takes this one's graphs
            del system
            for k in ("system", "nav", "robot"):
                r.pop(k)
    first = passes[0]
    diffs = []
    for p in passes[1:]:
        a, b = first, p
        if not np.array_equal(a["ekf"], b["ekf"]) or not torch.equal(a["P"], b["P"]):
            diffs.append("EKF")
        if len(a["r"]["goals_sent"]) != len(b["r"]["goals_sent"]) or any(
                not np.array_equal(x[0], y[0]) or x[1] != y[1]
                for x, y in zip(a["r"]["goals_sent"], b["r"]["goals_sent"])):
            diffs.append("goals")
        if a["diag"] != b["diag"] or any(not torch.equal(x, y)
                                         for x, y in zip(a["roadmap"], b["roadmap"])):
            diffs.append("explorer")
        if not np.array_equal(a["r"]["occ"], b["r"]["occ"]):
            diffs.append("grid")
        if not np.array_equal(a["traj"], b["traj"]):
            diffs.append("SLAM poses")
        if a["r"]["launches"]["sweep"] != b["r"]["launches"]["sweep"]:
            diffs.append("K3 launches")
    eager, captured = passes[0], passes[-1]
    # the last captured pass took the graphs the first one captured
    reused = all(captured["stats"][name]["calls"] > s["calls"]
                 and (not s["captured"] or captured["stats"][name]["capture_s"] == s["capture_s"])
                 for name, s in passes[1]["stats"].items() if name.startswith(LOOP_REGIONS))
    kf = int(captured["r"]["system"].slam.map.n_kf) - 1
    fusion = {p["capture"]: _fusion_ms(p["r"]["system"], kf) for p in (eager, captured)}
    prof = {(p["capture"], w): _loop_profile(p["r"]["system"], w)
            for p in (eager, captured) for w in ("flush", "tick")}
    mode = {False: "eager", True: "captured"}
    log(f"[18 loops] phase 12's cell ({cfg.camera.width}x{cfg.camera.height}, "
        f"{ACTIVE_BENCH_FRAMES} frames, EKF on, SimClock), passes "
        + ", ".join(mode[p["capture"]] for p in passes)
        + f": bit-equal EKF trajectory and P, goals, explorer counts and roadmap, fused grid, "
        f"SLAM poses and K3 launches: {not diffs} {diffs or ''}; "
        f"{len(first['r']['goals_sent'])} goals, {first['diag']['ticks']} ticks, K3 "
        f"{first['r']['launches']['sweep']} launches; host ms "
        + "; ".join(f"{mode[p['capture']]} a flush {_per(p['r'], 'pose', 's') * 1e3:.2f}, a tick "
                    f"{_per(p['r'], 'tick', 's') * 1e3:.2f}, a frame "
                    f"{_per(p['r'], 'frame', 's') * 1e3:.2f}, a controller step "
                    f"{_per(p['r'], 'ctrl', 's') * 1e3:.2f}" for p in passes)
        + f"; a keyframe's fusion eager {fusion[False]:.3f}, captured {fusion[True]:.3f}; the "
        f"last captured system took the first one's graphs: {reused}; {smi}")
    log("[18 loops] torch.profiler, a call: "
        + "; ".join(f"{mode[c]} {w} {v['ms']:.3f} host ms, {v['kernels']:.1f} kernels on the "
                    f"device ({v['kernel_ms']:.3f} ms, busy {v['busy']:.2f} %), host launches "
                    f"{v['host_kernels']:.1f} kernels + {v['host_graphs']:.1f} graphs"
                    + (f", {v['after_read']:.1f} kernel launches after the read"
                       if w == "tick" else "")
                    for (c, w), v in prof.items())
        + f"; {smi}")
    log(f"[18 loops] the captured flush's top kernels a flush (the solves' backend): "
        f"{prof[(True, 'flush')]['top']}; the captured tick's: {prof[(True, 'tick')]['top']}")
    # what a captured tick copies into its static inputs: the arguments
    # its slot does not own (the grid, the staged host values, the keyframe
    # poses and the FI oracle's landmark map)
    ex = captured["r"]["system"].explorer
    region = next(r for name, r in ex._slot_state.slot.regions.items() if name.startswith("tick"))
    copied = [x for x in region.static_in if not ex._slot_state.slot.owns(x)]
    lm = captured["r"]["system"].slam.map.lm_pos
    log(f"[18 loops] a captured tick copies {sum(x.nbytes for x in copied)} bytes into its "
        f"static inputs ({len(copied)} tensors; the landmark map's positions and validity "
        f"{lm.nbytes + lm.shape[0]} of them)")
    stats = passes[1]["stats"]
    new = {name: s for name, s in stats.items() if name.startswith(LOOP_REGIONS)}
    log("[18 loops] new regions (calls in the capturing pass, capture s, graph pool MB): "
        + "; ".join(f"{name} {s['calls']}, "
                    + ("not captured" if not s["captured"] else
                       f"{s['capture_s']:.3f} s, {s['pool_bytes'] / 1e6:.2f} MB")
                    for name, s in new.items())
        + f"; phase {time.monotonic() - t_phase:.1f} s; {smi}")
    if diffs:
        raise AssertionError(f"[18 loops] captured and eager differ: {diffs}")
    missing = [n for n in LOOP_REGIONS if not any(k.startswith(n) and s["captured"]
                                                   for k, s in new.items())]
    if missing or not reused:
        raise AssertionError(f"[18 loops] regions not captured: {missing}, or captured again "
                             f"({reused})")
    if first["r"]["launches"]["sweep"] <= 0 or not first["r"]["goals_sent"]:
        raise AssertionError("[18 loops] the run launched no K3 or sent no goal")
    if prof[(True, "tick")]["host_graphs"] <= 0 or prof[(True, "flush")]["host_graphs"] <= 0:
        raise AssertionError("[18 loops] the profiler saw no graph launch")
    _check_windows(captured["r"], "[18 loops]")
    return captured["r"]["launches"]


# ---------------------------------------------------------------------------
# Phase 19: the controller's, the loop closer's and the fleet's captured programs
# ---------------------------------------------------------------------------

CONTROL_GRID = 320                         # phase 7's grid: the rapid preset's 80 m at 0.25 m
CONTROL_PASSES = (False, True, True)       # eager, captured (captures), captured (replays)
# the correction: (label, capture, corrections an engine); the first captured
# engine's first correction runs eagerly in its slot, its second captures
CORRECTION_PASSES = (("eager", False, 1), ("first captured engine", True, 2),
                     ("second captured engine", True, 1))
CONTROL_TIME_WINDOW = (80, 120)            # G = 320 steps timed, before the profiler starts
CONTROL_PROFILE = (120, 130)               # G = 320 steps torch.profiler traces
CONTROL_REFINE_CYCLES = 3
CONTROL_FLEET_TICKS = 20
SOLVER_REPLAYS = 3                         # PGO / GBA alone: replays timed after the capture
CONTROL_REGIONS = ("plan", "global/costmap", "local/costmap", "loop_verify", "loop_correct",
                   "refine_cycle", "coordinator", "auction_setup", "auction_chunk")


def _pool(s):
    return ("not captured" if not s["captured"] else
            f"{s['capture_s']:.3f} s, {s['pool_bytes'] / 1e6:.2f} MB")


def _control_loop(dev):
    """Phase 7's G = 320 loop up to step CONTROL_PROFILE[1], a pass a mode
    of CONTROL_PASSES: the controller steps' host ms over
    CONTROL_TIME_WINDOW, torch.profiler over CONTROL_PROFILE (kernels on the
    device, the host's kernel and graph launches a step, busy share)."""
    from fitslam_tpu_torch.ops.grid import GridSpec2D
    from fitslam_tpu_torch.utils.config import FitSlamConfig

    rcfg = FitSlamConfig.preset("rapid")
    half = CONTROL_GRID * rcfg.traversability.resolution / 2
    spec = GridSpec2D(CONTROL_GRID, rcfg.traversability.resolution, -half, -half)
    n = CONTROL_PROFILE[1] - CONTROL_PROFILE[0]
    passes = []
    for capture in CONTROL_PASSES:
        g = explore(dev, spec, rcfg, (3.0 - half, 3.0 - half), CONTROL_PROFILE[1],
                    CONTROL_PROFILE, capture=capture, time_window=CONTROL_TIME_WINDOW)
        prof = g.pop("prof")
        times = _kernel_times(prof)
        busy_us = sum(t for t, _ in times.values())
        if busy_us <= 0:
            raise AssertionError("[19 control] the profiler recorded no device time")
        host_k, host_g = _host_launches(prof)
        g.update(capture=capture, dev_kernels=sum(c for _, c in times.values()) / n,
                 host_k=host_k / n,
                 host_g=host_g / n, busy=busy_us / 1e4 / g["window_s"],
                 k3_us=sum(t for k, (t, _) in times.items() if "wavefront" in k) / n)
        passes.append(g)
    return passes


def _restore(slam, held):
    from fitslam_tpu_torch.utils import jit

    slam.map = jit.clone(held["map"])
    slam.state = jit.clone(held["state"])
    slam.last_frame = jit.clone(held["frame"])
    slam._track_initialized = slam._initialized = True
    for f, v in held["closer"].items():
        setattr(slam.loop_closer, f, list(v) if isinstance(v, list) else
                jit.clone(v) if isinstance(v, tuple) else v)


def _corrections(dev, held):
    """Phase 10's first correction of seed 1 again, from the map, state,
    frame and closer it had just before, then refine_map(cycles=
    CONTROL_REFINE_CYCLES), a fresh engine a pass of CORRECTION_PASSES (the
    second captured one takes the first one's slot). The closer's and the
    refine's eager calls (loop_closing.EAGER_CALLS, slam.REFINE_EAGER_CYCLES)
    are set to 1 here, so that one engine captures: its first correction
    eager in its slot, its second captured, its refine a cycle eager, one
    captured and one replayed. Host ms of each, K2's launches, and copies of
    what each left."""
    from fitslam_tpu_torch.models import loop_closing
    from fitslam_tpu_torch.models import slam as slam_mod
    from fitslam_tpu_torch.models.slam import StereoSlam
    from fitslam_tpu_torch.utils import jit

    saved = loop_closing.EAGER_CALLS, slam_mod.REFINE_EAGER_CYCLES
    loop_closing.EAGER_CALLS = slam_mod.REFINE_EAGER_CYCLES = 1
    out = []
    try:
        for label, capture, n_calls in CORRECTION_PASSES:
            slam = StereoSlam(held["cfg"], dev, capture=capture)
            if capture:
                slam._slot_state.claim()         # the slot's set-up is not a correction's
            correct_ms = []
            for _ in range(n_calls):
                _restore(slam, held)
                torch.cuda.synchronize()
                _reset_counts()
                t0 = time.perf_counter()
                info = slam.loop_closer.on_keyframe(slam, *held["args"])
                torch.cuda.synchronize()
                correct_ms.append((time.perf_counter() - t0) * 1e3)
                if info is None:
                    raise AssertionError("[19 control] the held correction did not close its loop")
            top2 = _counts()["top2"]
            t1 = time.perf_counter()
            chi2 = slam.refine_map(cycles=CONTROL_REFINE_CYCLES, gba_iters=15)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            out.append(dict(label=label, capture=capture, correct_ms=correct_ms,
                            refine_ms=(t2 - t1) * 1e3, top2=top2, launches=_counts(),
                            map=jit.clone(slam.map), state=jit.clone(slam.state),
                            chi2=chi2.clone(),
                            record={k: (v.clone() if isinstance(v, torch.Tensor) else v)
                                    for k, v in info.items()},
                            edges=[e[2] for e in slam.loop_closer.loop_edges],
                            stats=slam.capture_stats))
            del slam, info, chi2
    finally:
        loop_closing.EAGER_CALLS, slam_mod.REFINE_EAGER_CYCLES = saved
    return out


def _solver_alone(dev, held):
    """PGO (the correction's edge table shape: odometry, covisibility and
    the padded loop-edge table) and GBA on the held map, each eager once and
    then as a captured region: warm-up, capture, SOLVER_REPLAYS replays.
    Returns {solver: (eager host ms, replay host ms (median), iterations,
    the region's stats, replay equal to eager)}."""
    from fitslam_tpu_torch.models import slam_map as sm
    from fitslam_tpu_torch.ops import lie, pgo
    from fitslam_tpu_torch.ops.geometry import Intrinsics
    from fitslam_tpu_torch.utils import jit

    cfg = held["cfg"]
    lc = cfg.loop
    m = jit.clone(held["map"])
    K = Intrinsics.from_config(cfg.camera, dev)
    K_cap = m.kf_valid.shape[0]
    E = lc.max_loop_edges
    edges = pgo.concat_edges(
        pgo.odometry_edges(m.kf_T_cw, m.n_kf, K_cap - 1),
        pgo.covisibility_edges(m.kf_T_cw, m.kf_valid, m.obs_kf, m.obs_lm, m.obs_valid,
                               n_landmarks=m.lm_valid.shape[0], max_edges=lc.covis_max_edges,
                               min_shared=lc.covis_min_shared),
        pgo.PoseGraphEdges(torch.zeros(E, dtype=torch.int32, device=dev),
                           torch.zeros(E, dtype=torch.int32, device=dev),
                           lie.SE3.identity((E,), device=dev), torch.ones(E, device=dev),
                           torch.zeros(E, dtype=torch.bool, device=dev)))
    fixed = torch.arange(K_cap, device=dev) == 0
    solvers = {
        "pgo": (lc.pgo_iters, lambda: pgo.optimize_pose_graph(m.kf_T_cw, m.kf_valid, edges, fixed,
                                                               iters=lc.pgo_iters)),
        "gba": (lc.gba_iters, lambda: sm.global_ba(m, K, iters=lc.gba_iters)),
    }
    out = {}
    for name, (iters, call) in solvers.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = call()
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3
        slot = jit.Slot(dev, {})
        ms = []
        for _ in range(2 + SOLVER_REPLAYS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, got = slot.run(name, lambda: ((), call()))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        same = all(torch.equal(a, b) for a, b in zip(jit.flatten(got)[0], jit.flatten(want)[0]))
        st = slot.stats()[name]
        out[name] = (eager_ms, float(np.median(ms[2:])), iters, st, same)
        torch.cuda.synchronize()
        del slot, got, want
    return out


def _fleet_passes(dev):
    """Phase 13's four-rover auction fleet for CONTROL_FLEET_TICKS ticks, a
    pass a mode of CONTROL_PASSES: each tick's cost matrix and assignment,
    the rounds, the rovers' paths, host ms a tick and a solve; then the
    AUCTION_PROBLEMS problems of AUCTION_SHAPE alone, a pass a mode."""
    from fitslam_tpu_torch import run_multirobot as rm
    from fitslam_tpu_torch.models import allocation as al

    fleets = []
    for capture in CONTROL_PASSES:
        calls, solves, win = [], [], _Windows()
        real = al.TaskAllocator.allocate

        def allocate(alloc, cost, fxy, peer_goals=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a = real(alloc, cost, fxy, peer_goals)
            solves.append((time.perf_counter() - t0) * 1e3)
            calls.append((np.array(cost, np.float32), np.asarray(a).astype(np.int64)))
            return a

        al.TaskAllocator.allocate = allocate
        _reset_counts()
        try:
            r = rm.run(4, CONTROL_FLEET_TICKS * rm.TICK_EVERY, "auction", seed=2, device=dev,
                       timer=win, verbose=False, capture=capture)
        finally:
            al.TaskAllocator.allocate = real
        coord = r["coord"]
        fleets.append(dict(capture=capture, calls=calls, solve_ms=solves, launches=_counts(),
                           rounds=list(coord.allocator.auction_rounds), tick_ms=win.per("tick", "s") * 1e3,
                           traj=[np.array(rb.trajectory) for rb in r["robots"]],
                           stats=coord.capture_stats, ticks=coord.ticks))
        del r, coord
    problems = []
    for capture in CONTROL_PASSES:
        regions = {}
        auc = auction_check(dev, capture, regions)
        problems.append(dict(capture=capture, rounds=[a[0] for a in auc], ms=[a[2] for a in auc],
                             assign=[a[5] for a in auc], stats=regions))
    return fleets, problems


def phase_control(dev, smi, loop_run):
    """[19 control]: the controller's, the loop closer's and the fleet's
    captured programs against their eager runs (capture=False), then
    captured twice (the second owner takes the first one's graphs): phase
    7's G = 320 loop over steps 0-129 (poses, the last path, goals and
    counts, coverage, plans and K3 launches bit-equal; host ms a controller
    step and a tick; torch.profiler over steps CONTROL_PROFILE); phase 10's
    first correction of seed 1 from the map and state it had just before,
    and a CONTROL_REFINE_CYCLES-cycle refine_map (eager, then captured as
    _corrections sets out: map, tracker state, records, loop edges, chi2 and
    K2 launches bit-equal; host ms), PGO and GBA alone on that map (host ms an
    iteration eager and replayed); phase 13's four-rover auction fleet for
    CONTROL_FLEET_TICKS ticks and the AUCTION_PROBLEMS auction problems
    (cost matrices, assignments, rounds and paths bit-equal; host ms a tick,
    a solve and a round). Each new region's capture seconds and pool.
    Returns the launches of the last captured pass of each area."""
    from fitslam_tpu_torch.utils import jit

    t_phase = time.monotonic()
    jit.release_idle()
    mode = {False: "eager", True: "captured"}
    diffs = []

    # -- the controller: phase 7's G = 320 loop -------------------------------
    ctl = _control_loop(dev)
    e, c1, c2 = ctl
    for c in (c1, c2):
        for key in ("traj", "coverage", "path"):
            if not (e[key] is None and c[key] is None or np.array_equal(e[key], c[key])):
                diffs.append(f"G=320 {key}")
        if (e["diag"], e["plans"], e["launches"]["sweep"]) != \
                (c["diag"], c["plans"], c["launches"]["sweep"]):
            diffs.append("G=320 goals, plans or K3 launches")
    reused = all(c2["capture_stats"][k]["calls"] > s["calls"]
                 and (not s["captured"] or c2["capture_stats"][k]["capture_s"] == s["capture_s"])
                 for k, s in c1["capture_stats"].items() if k in ("plan", "global/costmap",
                                                                  "local/costmap"))
    w = CONTROL_TIME_WINDOW
    log(f"[19 control] phase 7's G={CONTROL_GRID} loop, steps 0-{CONTROL_PROFILE[1] - 1}, passes "
        + ", ".join(mode[p["capture"]] for p in ctl)
        + f": poses, last path, goals and counts, coverage, plans and K3 launches bit-equal: "
        f"{not any(d.startswith('G=320') for d in diffs)}; {e['plans']} plans, "
        f"{e['diag']['goals_sent']} goals, K3 {e['launches']['sweep']} launches; host ms over "
        f"steps {w[0]}-{w[1] - 1}: "
        + "; ".join(f"{mode[p['capture']]} a controller step "
                    f"{p['ctrl_w_s'] / max(p['ctrl_w_n'], 1) * 1e3:.3f}, a tick "
                    f"{p['tick_w_s'] / max(p['tick_w_n'], 1) * 1e3:.2f}" for p in ctl)
        + f"; torch.profiler over steps {CONTROL_PROFILE[0]}-{CONTROL_PROFILE[1] - 1}, a step: "
        + "; ".join(f"{mode[p['capture']]} {p['dev_kernels']:.1f} kernels on the device "
                    f"(K3 {p['k3_us']:.1f} us), host launches {p['host_k']:.1f} kernels + "
                    f"{p['host_g']:.1f} graphs, busy {p['busy']:.2f} %" for p in ctl)
        + f"; regions (capture s, pool): "
        + "; ".join(f"{k} {_pool(s)}" for k, s in c1["capture_stats"].items()
                    if k.startswith(("plan", "global/", "local/")))
        + f"; the last captured pass took the first one's graphs: {reused}; {smi}")

    # -- the loop correction: phase 10's first one, and refine_map ------------
    held = loop_run["held"]
    corr = _corrections(dev, held)
    ce = corr[0]
    for p in corr[1:]:
        same = (all(torch.equal(a, b) for a, b in zip(jit.flatten(ce["map"])[0],
                                                      jit.flatten(p["map"])[0]))
                and all(torch.equal(a, b) for a, b in zip(jit.flatten(ce["state"])[0],
                                                          jit.flatten(p["state"])[0]))
                and torch.equal(ce["chi2"], p["chi2"]) and ce["top2"] == p["top2"]
                and len(ce["edges"]) == len(p["edges"])
                and all(torch.equal(a.R, b.R) and torch.equal(a.t, b.t)
                        for a, b in zip(ce["edges"], p["edges"]))
                and ce["record"].keys() == p["record"].keys()
                and all((a is None and b is None) or (isinstance(a, torch.Tensor)
                                                      and torch.equal(a, b)) or a == b
                        for a, b in ((ce["record"][k], p["record"][k]) for k in ce["record"])))
        if not same:
            diffs.append("correction")
    solo = _solver_alone(dev, held)
    if not all(v[4] for v in solo.values()):
        diffs.append(f"PGO / GBA alone: {[k for k, v in solo.items() if not v[4]]}")
    last = corr[-1]
    n_kf = int(held["map"].n_kf)
    log(f"[19 control] phase 10's first correction of seed {LOOP_SEEDS[0]} ({n_kf} keyframes, "
        f"keyframe {held['args'][0]} to {int(last['record']['loop_to'])}, "
        f"{last['record']['inliers']} inliers) and refine_map({CONTROL_REFINE_CYCLES} cycles), "
        f"eager counts 1: map, tracker state, records, loop edges, refine chi2 and K2 launches "
        f"({ce['top2']}) bit-equal: {'correction' not in diffs}; host ms a correction "
        f"(in turn) / a refine: "
        + ", ".join(f"{p['label']} {', '.join(f'{t:.2f}' for t in p['correct_ms'])} / "
                    f"{p['refine_ms']:.2f}" for p in corr)
        + "; alone, host ms an iteration eager / replayed (the replay bit-equal to eager): "
        + "; ".join(f"{k.upper()} {v[0] / v[2]:.3f} / {v[1] / v[2]:.3f} ({v[2]} iterations, "
                    f"{v[4]}; {_pool(v[3])})" for k, v in solo.items())
        + "; regions (capture s, pool): "
        + "; ".join(f"{k} {_pool(s)}" for k, s in corr[2]["stats"].items()
                    if k.startswith(("loop_", "refine_cycle")))
        + f"; {smi}")

    # -- the fleet: phase 13's auction fleet and the auction alone ---------------
    fleets, problems = _fleet_passes(dev)
    fe = fleets[0]
    for f in fleets[1:]:
        if not (len(f["calls"]) == len(fe["calls"])
                and all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                        for a, b in zip(fe["calls"], f["calls"]))
                and f["rounds"] == fe["rounds"]
                and all(np.array_equal(a, b) for a, b in zip(fe["traj"], f["traj"]))
                and f["launches"]["sweep"] == fe["launches"]["sweep"]):
            diffs.append("fleet")
    pe = problems[0]
    for p in problems[1:]:
        if not (p["rounds"] == pe["rounds"]
                and all(np.array_equal(a, b) for a, b in zip(pe["assign"], p["assign"]))):
            diffs.append("auction problems")
    f1 = fleets[1]
    log(f"[19 control] phase 13's four-rover auction fleet, {fe['ticks']} ticks, passes "
        + ", ".join(mode[f["capture"]] for f in fleets)
        + f": cost matrices, assignments, rounds, paths and K3 launches "
        f"({fe['launches']['sweep']}) bit-equal: {'fleet' not in diffs}; "
        f"{np.mean(fe['rounds']):.1f} rounds a solve; host ms "
        + "; ".join(f"{mode[f['capture']]} a tick {f['tick_ms']:.2f}, a solve "
                    f"{np.median(f['solve_ms']):.2f} (median), a round "
                    f"{np.sum(f['solve_ms']) / max(np.sum(f['rounds']), 1):.4f}"
                    for f in fleets)
        + f"; the {AUCTION_PROBLEMS} {AUCTION_SHAPE} problems: assignments and rounds "
        f"bit-equal {'auction problems' not in diffs}, {np.mean(pe['rounds']):.1f} rounds a "
        f"solve; host ms a solve (median) / a round "
        + "; ".join(f"{mode[p['capture']]} {np.median(p['ms']):.2f} / "
                    f"{np.sum(p['ms']) / max(np.sum(p['rounds']), 1):.4f}" for p in problems)
        + "; regions (capture s, pool): "
        + "; ".join(f"{k} {_pool(s)}" for k, s in {**f1["stats"], **problems[1]["stats"]}.items())
        + f"; phase {time.monotonic() - t_phase:.1f} s; {smi}")
    if diffs:
        raise AssertionError(f"[19 control] captured and eager differ: {diffs}")
    captured = {**c1["capture_stats"], **corr[2]["stats"], **f1["stats"], **problems[1]["stats"]}
    missing = [n for n in CONTROL_REGIONS
               if not any(k.startswith(n) and s["captured"] for k, s in captured.items())]
    if missing or not reused:
        raise AssertionError(f"[19 control] regions not captured: {missing}, or captured "
                             f"again ({reused})")
    if ce["top2"] <= 0 or e["launches"]["sweep"] <= 0 or fe["launches"]["sweep"] <= 0:
        raise AssertionError("[19 control] K2 or K3 was not launched")
    if c2["host_g"] <= 0:
        raise AssertionError("[19 control] the profiler saw no graph launch")
    return {k: c2["launches"][k] + last["launches"][k] + fleets[-1]["launches"][k]
            for k in c2["launches"]}


# ---------------------------------------------------------------------------
# Phase 20: the simulation and the tick's tail as captured programs
# ---------------------------------------------------------------------------

SIM_PASSES = (False, True)                 # eager, then captured (warm-up, capture, replays)
SIM_ABLATION_STEPS = 120                   # G = 64 ablation steps a pass
SIM_CAMERA_POSES = 8                       # 640x480 frames of the camera alone, a pass
SIM_HOLD_FRAMES = 4                        # later frames a held cloud outlives
SIM_ACTIVE_FRAMES = 40                     # frames of the active loop and of each mode, a pass
SIM_TAIL_CALLS = 6                         # calls of each tail region alone, a pass
SIM_RESTITCHES = 5                         # forced re-stitches a system
SIM_REGIONS = ("reveal", "publish", "los", "camera", "camera+rgbd", "recovery", "goal_cell",
               "evict", "wedge", "clear", "restitch")


def _timed(fn):
    """(fn(), host ms) between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _calls_line(ms, captured):
    """Host ms of a region's calls: the median eagerly, or the warm-up, the
    capture and the replays' median."""
    if not captured:
        return f"{np.median(ms):.3f}"
    return f"{ms[0]:.3f} / {ms[1]:.3f} / {np.median(ms[2:]):.3f}"


def _break_even(eager_ms, ms):
    """Calls after which capturing pays: the warm-up's and the capture's
    cost above two eager calls over what a replay saves (inf when it saves
    nothing)."""
    saved = np.median(eager_ms) - np.median(ms[2:])
    extra = ms[0] + ms[1] - 2 * np.median(eager_ms)
    return math.inf if saved <= 0 else max(extra, 0.0) / saved


def _sim_ablation(dev):
    """bench_suite.explore_run on the G = 64 ablation world for
    SIM_ABLATION_STEPS steps, a pass a mode of SIM_PASSES: each controller
    window's robot pose, path, plans and status, each step's explored map,
    every published path and the host ms of each reveal and published path."""
    from fitslam_tpu_torch.models.exploration import ExplorationServer
    from fitslam_tpu_torch.models.sim_robot import RevealSensor
    from fitslam_tpu_torch.ops.grid import GridSpec2D

    spec = GridSpec2D(**ABLATION_SPEC)
    passes = []
    for capture in SIM_PASSES:
        rec = dict(capture=capture, record=[], explored=[], published=[], reveal_ms=[],
                   publish_ms=[], tick_ms=[], ctrl_ms=[])
        real_reveal, real_publish = RevealSensor.reveal, ExplorationServer._build_published_path

        def reveal(sensor, xy):
            out, ms = _timed(lambda: real_reveal(sensor, xy))
            rec["reveal_ms"].append(ms)
            rec["explored"].append(out.clone())
            return out

        def publish(server, goal, occ, robot_xy):
            out, ms = _timed(lambda: real_publish(server, goal, occ, robot_xy))
            rec["publish_ms"].append(ms)
            rec["published"].append(None if out is None else out.copy())
            return out

        def window(w, step, fn):
            out, ms = _timed(fn)
            rec[f"{w}_ms"].append(ms)
            return out

        RevealSensor.reveal, ExplorationServer._build_published_path = reveal, publish
        _reset_counts()
        try:
            run = explore_run(ablation_config(), spec, ABLATION_START, SIM_ABLATION_STEPS, dev,
                              window=window, capture=capture)
        finally:
            RevealSensor.reveal = real_reveal
            ExplorationServer._build_published_path = real_publish
        nav = run["nav"]
        rec.update(run=run, launches=_counts(), traj=np.array(run["robot"].trajectory),
                   diag=dict(vars(run["server"].diag)), plans=nav.plans,
                   path=None if nav._path is None else nav._path.copy(),
                   known=run["known"].cpu().numpy())
        passes.append(rec)
    return passes


def _sim_camera(dev, rgbd):
    """The 640x480 camera of phase 8 (phase 9's with ``rgbd``) alone over
    SIM_CAMERA_POSES poses of the rooms world, a pass a mode of SIM_PASSES:
    each frame's outputs and host ms; in the captured pass the first frame's
    cloud (its depth image with ``rgbd``) held across SIM_HOLD_FRAMES later
    frames."""
    from fitslam_tpu_torch.data import synthetic
    from fitslam_tpu_torch.models.active_slam import camera_pose_from_robot
    from fitslam_tpu_torch.ops.geometry import Intrinsics
    from fitslam_tpu_torch.ops.grid import GridSpec2D
    from fitslam_tpu_torch.utils import jit

    W, H = 640, 480
    cfg = active_config(W, H, 1024, 4, fx=0.625 * W)
    K = Intrinsics.from_config(cfg.camera, dev)
    landmarks = rooms_world(GridSpec2D(64, 0.25, -8.0, -8.0), dev, floor_points=4000).landmarks
    poses = [(-5.0 + 0.3 * i, -5.0 + 0.1 * i, 0.3 + 0.05 * i) for i in range(SIM_CAMERA_POSES)]
    passes = []
    for capture in SIM_PASSES:
        cloud = 0 if rgbd else cfg.traversability.max_points_per_cloud
        cam = synthetic.SimCamera(K, landmarks, W, H, max_depth=12.0, cloud_points=cloud,
                                  cloud_depth=8.0, rgbd=rgbd, capture=capture)
        outs, ms, held = [], [], None
        for i, pose in enumerate(poses):
            T = camera_pose_from_robot(*pose, device=dev)
            out, t = _timed(lambda: cam.frame(T))
            ms.append(t)
            outs.append(jit.clone(out))
            if i == 0:
                held = jit.hold(out[1:] if rgbd else out[2:])
            if i == SIM_HOLD_FRAMES:
                kept = jit.clone(held)
        passes.append(dict(capture=capture, outs=outs, ms=ms, kept=kept,
                           stats=cam.capture_stats.get(cam.name), name=cam.name))
        del cam
    e, c = passes
    same = all(torch.equal(a, b) for x, y in zip(e["outs"], c["outs"]) for a, b in zip(x, y))
    first = e["outs"][0][1:] if rgbd else e["outs"][0][2:]
    held_ok = all(torch.equal(a, b) for a, b in zip(c["kept"], first))
    return passes, same, held_ok


def _sim_tail(passes):
    """The tail's regions alone on each ablation pass's server at its final
    grid (RARE_EAGER_CALLS 0, so the captured pass captures at its second
    call): SIM_TAIL_CALLS recovery probes, goal-cell probes, evictions of 64
    circles, wedge marks and ClearCostmap discs, each timed and its read or
    write kept."""
    from fitslam_tpu_torch.models import exploration as ex

    rng = np.random.RandomState(9)
    poses = [(tuple(rng.uniform(-7, 7, 2)), float(rng.uniform(-3, 3)))
             for _ in range(SIM_TAIL_CALLS)]
    ebufs = [np.concatenate([rng.uniform(-7, 7, (64, 2)), rng.uniform(0.3, 0.8, (64, 1))],
                            axis=1).astype(np.float32) for _ in range(SIM_TAIL_CALLS)]
    out = []
    saved = ex.RARE_EAGER_CALLS
    ex.RARE_EAGER_CALLS = dict.fromkeys(saved, 0)
    try:
        for p in passes:
            server, sensor = p["run"]["server"], p["run"]["sensor"]
            occ = server._overlaid(sensor.explored)
            calls = {
                "recovery": lambda xy, yaw, eb: np.array(server._free_distances(occ, xy, yaw)),
                "goal_cell": lambda xy, yaw, eb: server._goal_cell(occ, np.array(xy)),
                "evict": lambda xy, yaw, eb: (server._evict(eb), server.lethal_overlay)[1],
                "wedge": lambda xy, yaw, eb: (server._mark_wedge(xy, yaw), server.wedge_age)[1],
                "clear": lambda xy, yaw, eb: (server._clear_disc(xy), server.wedge_age)[1],
            }
            got = {}
            for name, call in calls.items():
                vals, ms = [], []
                for (xy, yaw), eb in zip(poses, ebufs):
                    v, t = _timed(lambda: call(xy, yaw, eb))
                    vals.append(v.clone() if isinstance(v, torch.Tensor) else v)
                    ms.append(t)
                got[name] = (vals, ms)
            out.append(dict(capture=p["capture"], got=got, stats=server.capture_stats))
    finally:
        ex.RARE_EAGER_CALLS = saved
    e, c = out
    def same(a, b):
        return torch.equal(a, b) if isinstance(a, torch.Tensor) else np.array_equal(a, b)

    diffs = [n for n in e["got"]
             if not all(same(a, b) for a, b in zip(e["got"][n][0], c["got"][n][0]))]
    return out, diffs


def _sim_active(dev):
    """Phase 8's active loop (640x480, 1024 features, 4 levels, the captured
    camera) for SIM_ACTIVE_FRAMES frames, a pass a mode of SIM_PASSES, then
    SIM_RESTITCHES re-stitches on each system after forced corrections
    (RESTITCH_EAGER_CALLS 0): the robot's path, the SLAM trajectory, goals,
    the cloud buffer, the statistics and the grid, frames/s and host ms."""
    from fitslam_tpu_torch.models import active_slam as act
    from fitslam_tpu_torch.ops import lie
    from fitslam_tpu_torch.ops.grid import GridSpec2D
    from fitslam_tpu_torch.utils import jit

    spec = GridSpec2D(64, 0.25, -8.0, -8.0)
    W, H = 640, 480
    cfg = active_config(W, H, 1024, 4, fx=0.625 * W)
    landmarks = rooms_world(spec, dev, floor_points=4000).landmarks
    passes = []
    saved = act.RESTITCH_EAGER_CALLS
    act.RESTITCH_EAGER_CALLS = 0
    try:
        for capture in SIM_PASSES:
            r = run_active(dev, cfg, spec, landmarks, (-5.0, -5.0, 0.3), SIM_ACTIVE_FRAMES,
                           capture=capture)
            system = r["system"]
            restitch = []
            for k in range(1, SIM_RESTITCHES + 1):
                m = system.slam.map
                shift = torch.tensor([0.02 * k, -0.01 * k, 0.005], device=dev)
                system.slam.map = m._replace(kf_T_cw=lie.SE3(m.kf_T_cw.R.clone(),
                                                             m.kf_T_cw.t + shift))
                system._restitch = True
                occ, ms = _timed(system.occupancy)
                restitch.append((ms, jit.clone(system._fstats), occ.clone()))
            passes.append(dict(
                capture=capture, fps=r["fps"], launches=r["launches"], traj=r["traj"],
                slam=np.array(system.slam.trajectory), goals=r["goals_sent"],
                clouds=jit.clone(system.clouds), n_kf=r["n_kf"], restitch=restitch,
                frame_ms=_per(r, "frame", "s") * 1e3, tick_ms=_per(r, "tick", "s") * 1e3,
                ctrl_ms=_per(r, "ctrl", "s") * 1e3,
                stats={**system.capture_stats}))
            del r, system
    finally:
        act.RESTITCH_EAGER_CALLS = saved
    e, c = passes
    same = (np.array_equal(e["traj"], c["traj"]) and np.array_equal(e["slam"], c["slam"])
            and len(e["goals"]) == len(c["goals"])
            and all(np.array_equal(a[0], b[0]) and a[1] == b[1]
                    for a, b in zip(e["goals"], c["goals"]))
            and all(torch.equal(a, b) for a, b in zip(jit.flatten(e["clouds"])[0],
                                                      jit.flatten(c["clouds"])[0]))
            and e["n_kf"] == c["n_kf"])
    same_restitch = all(
        torch.equal(a[2], b[2]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
        for a, b in zip(e["restitch"], c["restitch"]))
    return passes, same, same_restitch


def phase_sim(dev, smi):
    """[20 sim]: the simulation's and the tick tail's captured programs
    (RevealSensor's reveal, SimCamera's camera and camera+rgbd, the
    server's publish, los, goal_cell, recovery, evict, wedge and clear,
    ActiveSlamSystem's restitch) against capture=False: the G = 64 ablation
    world for SIM_ABLATION_STEPS steps (robot poses, paths, plans, goals,
    explored maps and published paths bit-equal; host ms a reveal, a
    published path, a tick, a controller window); the 640x480 camera alone
    (images, clouds and depth bit-equal, a held cloud or depth image
    unchanged SIM_HOLD_FRAMES frames on; host ms a frame); the tail's regions
    alone on the ablation servers (each read and write bit-equal; host ms,
    calls for a capture to pay); phase 8's loop for SIM_ACTIVE_FRAMES frames
    and SIM_RESTITCHES forced re-stitches (the robot's path, the SLAM
    trajectory, goals, clouds, statistics and grids bit-equal; frames/s,
    host ms); ``--mode active_slam`` and ``--mode marsyard`` cut to
    SIM_ACTIVE_FRAMES frames, frames/s of each mode. Each region's capture
    seconds and pool. Returns the captured loop's launches."""
    from fitslam_tpu_torch import bench_suite

    t_phase = time.monotonic()
    mode = {False: "eager", True: "captured"}
    diffs = []

    # -- the G = 64 ablation world -------------------------------------------
    abl = _sim_ablation(dev)
    e, c = abl
    for key in ("traj", "known"):
        if not np.array_equal(e[key], c[key]):
            diffs.append(f"ablation {key}")
    if not (len(e["explored"]) == len(c["explored"])
            and all(torch.equal(a, b) for a, b in zip(e["explored"], c["explored"]))):
        diffs.append("ablation explored maps")
    if not (len(e["published"]) == len(c["published"]) and all(
            (a is None and b is None) or (a is not None and b is not None and np.array_equal(a, b))
            for a, b in zip(e["published"], c["published"]))):
        diffs.append("ablation published paths")
    # explore_run schedules CleanupRoadmap on the simulation's clock: both
    # passes count the same cleanups
    same_diag = e["diag"] == c["diag"]
    if not (same_diag and e["plans"] == c["plans"] and e["launches"] == c["launches"]):
        diffs.append(f"ablation counts: {e['diag']}, {e['plans']} plans, {e['launches']} / "
                     f"{c['diag']}, {c['plans']}, {c['launches']}")
    cs = {**c["run"]["sensor"].capture_stats, **c["run"]["server"].capture_stats}
    log(f"[20 sim] G=64 ablation world, {SIM_ABLATION_STEPS} steps, passes "
        + ", ".join(mode[p["capture"]] for p in abl)
        + f": robot poses, paths, plans, goals, explored maps and {len(e['published'])} "
        f"published paths bit-equal: {not any(d.startswith('ablation') for d in diffs)}; "
        f"{e['diag']['goals_sent']} goals, {e['plans']} plans, K3 {e['launches']['sweep']}; "
        "host ms (eager median; captured warm-up / capture / replays' median): a reveal "
        f"{_calls_line(e['reveal_ms'], False)}; {_calls_line(c['reveal_ms'], True)}, a published "
        f"path (publish + host walk + los) {_calls_line(e['publish_ms'], False)}; "
        f"{_calls_line(c['publish_ms'], True)}; a tick {np.median(e['tick_ms']):.2f} / "
        f"{np.median(c['tick_ms']):.2f}, 4 controller steps {np.median(e['ctrl_ms']):.3f} / "
        f"{np.median(c['ctrl_ms']):.3f} (eager / captured, medians); regions (capture s, pool): "
        + "; ".join(f"{k} {_pool(cs[k])}" for k in ("reveal", "publish", "los") if k in cs)
        + f"; {smi}")

    # -- the tail's regions alone ---------------------------------------------
    tail, tail_diffs = _sim_tail(abl)
    diffs += [f"tail {n}" for n in tail_diffs]
    te, tc = tail
    log(f"[20 sim] the tick's tail alone on the ablation servers, {SIM_TAIL_CALLS} calls a "
        f"region, eager counts 0: reads and writes bit-equal: {not tail_diffs}; host ms "
        "(eager median; captured warm-up / capture / replays' median; calls for a capture "
        "to pay): "
        + "; ".join(f"{n} {_calls_line(te['got'][n][1], False)}; "
                    f"{_calls_line(tc['got'][n][1], True)}; "
                    f"{_break_even(te['got'][n][1], tc['got'][n][1]):.1f}"
                    for n in te["got"])
        + "; regions (capture s, pool): "
        + "; ".join(f"{n} {_pool(tc['stats'][n])}" for n in te["got"] if n in tc["stats"])
        + f"; {smi}")
    del abl, tail

    # -- the camera alone ------------------------------------------------------
    cams = {}
    for rgbd in (False, True):
        passes, same, held_ok = _sim_camera(dev, rgbd)
        cams[rgbd] = passes
        if not same:
            diffs.append(f"camera{'+rgbd' if rgbd else ''} outputs")
        if not held_ok:
            diffs.append(f"camera{'+rgbd' if rgbd else ''} held view")
        if not (passes[1]["stats"] or {}).get("captured"):
            diffs.append(f"camera{'+rgbd' if rgbd else ''} not captured")
    log(f"[20 sim] SimCamera alone at 640x480, {SIM_CAMERA_POSES} poses of the rooms world: "
        f"stereo + a 4096-point cloud and RGB-D (image + depth) bit-equal to capture=False: "
        f"{not any(d.startswith('camera') for d in diffs)}, a frame's cloud / depth image held "
        f"({SIM_HOLD_FRAMES} frames on) unchanged: "
        f"{not any(d.endswith('held view') for d in diffs)}; host ms a frame (eager median; "
        "captured warm-up / capture / replays' median): "
        + "; ".join(f"{p[1]['name']} {_calls_line(p[0]['ms'], False)}; "
                    f"{_calls_line(p[1]['ms'], True)}; calls for a capture to pay "
                    f"{_break_even(p[0]['ms'], p[1]['ms']):.1f}; {_pool(p[1]['stats'])}"
                    for p in cams.values())
        + f"; {smi}")
    del cams

    # -- phase 8's loop and the re-stitch --------------------------------------
    act, same, same_restitch = _sim_active(dev)
    if not same:
        diffs.append("active loop")
    if not same_restitch:
        diffs.append("restitch")
    ae, ac = act
    re_ms = [[t for t, _, _ in p["restitch"]] for p in act]
    log(f"[20 sim] phase 8's loop at 640x480, {SIM_ACTIVE_FRAMES} frames (the captured camera "
        f"and {SIM_RESTITCHES} forced re-stitches), passes "
        + ", ".join(mode[p["capture"]] for p in act)
        + f": the robot's path, SLAM trajectory, goals, clouds, statistics and grids "
        f"bit-equal: {same and same_restitch}; {ae['n_kf']} keyframes; frames/s from frame 8 "
        + " / ".join(f"{p['fps']:.2f}" for p in act)
        + " (eager / captured); host ms a frame step, tick and controller step "
        + " / ".join(f"{p['frame_ms']:.2f}, {p['tick_ms']:.2f}, {p['ctrl_ms']:.3f}"
                     for p in act)
        + f"; a re-stitch with its grid (eager median; captured warm-up / capture / "
        f"replays' median) {_calls_line(re_ms[0], False)}; {_calls_line(re_ms[1], True)}; "
        f"calls for a capture to pay {_break_even(re_ms[0], re_ms[1]):.1f}; regions "
        "(capture s, pool): "
        + "; ".join(f"{k} {_pool(s)}" for k, s in ac["stats"].items()
                    if k.startswith(("restitch", "fuse_grid")))
        + f"; {smi}")

    # -- the two modes -----------------------------------------------------------
    modes = {}
    for name, fn in (("active_slam", bench_suite.bench_active_slam),
                     ("marsyard", bench_suite.bench_marsyard)):
        modes[name] = [_in_process(fn, False, n_frames=SIM_ACTIVE_FRAMES, device=dev,
                                   capture=capture)["value"] for capture in SIM_PASSES]
    log(f"[20 sim] --mode active_slam and --mode marsyard cut to {SIM_ACTIVE_FRAMES} frames, "
        "frames/s (eager / captured): "
        + "; ".join(f"{n} {v[0]:.3f} / {v[1]:.3f}" for n, v in modes.items())
        + f"; phase {time.monotonic() - t_phase:.1f} s; {smi}")

    if diffs:
        raise AssertionError(f"[20 sim] captured and eager differ: {diffs}")
    captured = {**cs, **tc["stats"], **ac["stats"]}
    missing = [n for n in SIM_REGIONS if n not in ("camera", "camera+rgbd")
               and not any(k.startswith(n) and s["captured"] for k, s in captured.items())]
    if missing:
        raise AssertionError(f"[20 sim] regions not captured: {missing}")
    if ac["launches"]["describe"] <= 0 or ac["launches"]["sweep"] <= 0:
        raise AssertionError("[20 sim] K1 or K3 was not launched in the captured loop")
    return ac["launches"]


def _kernel_times(prof, since=None):
    """{kernel name: (device us, launches)} of a profiler's CUDA kernels;
    with ``since`` (profiler us), of those that start from then on."""
    out = {}
    if since is not None:
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.name != MEASURED \
                    and e.time_range.start >= since:
                t, n = out.get(e.name, (0.0, 0))
                out[e.name] = (t + e.time_range.elapsed_us(), n + 1)
        return out
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        t, n = out.get(e.key, (0.0, 0))
        out[e.key] = (t + us, n + e.count)
    return out


def profile_bench(dev):
    """A torch.profiler window over bench frames PROFILE_FRAMES of phase 5's
    loop (process_frame_async), twice (the spread between two runs of the
    same work): kernel launches a frame, the device's busy share, K1's share
    (the fused describe, or the parent's gathers) and the top kernels."""
    from fitslam_tpu_torch.models.slam import StereoSlam

    cfg = headline_config()
    frames, _ = headline_frames(cfg, dev)
    warm = StereoSlam(cfg, dev)
    for l, r in frames[:PROFILE_FRAMES[1]]:
        warm.process_frame_async(l, r)
    n = PROFILE_FRAMES[1] - PROFILE_FRAMES[0]
    for run in (1, 2):
        slam = StereoSlam(cfg, dev)
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        for i, (l, r) in enumerate(frames[:PROFILE_FRAMES[1]]):
            if i == PROFILE_FRAMES[0]:
                torch.cuda.synchronize()
                prof.__enter__()
                t0 = time.perf_counter()
            slam.process_frame_async(l, r)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        prof.__exit__(None, None, None)
        times = _kernel_times(prof)
        busy_us = sum(t for t, _ in times.values())
        k1 = [(t, c) for name, (t, c) in times.items()
              if "describe" in name or "patch_gather" in name]
        k1_us, k1_n = sum(t for t, _ in k1), sum(c for _, c in k1)
        top = sorted(times.items(), key=lambda kv: -kv[1][0])[:8]
        log(f"[profile] run {run}, bench frames {PROFILE_FRAMES[0]}-{PROFILE_FRAMES[1] - 1}: "
            f"window {window_s * 1e3:.1f} ms host ({window_s / n * 1e3:.2f} ms a frame), kernel "
            f"time {busy_us / 1e3:.3f} ms (busy {busy_us / 1e4 / window_s:.2f} %), "
            f"{sum(c for _, c in times.values()) / n:.1f} kernel launches a frame; K1 "
            f"{k1_us / 1e3:.4f} ms in {k1_n} launches ({k1_n / n:.1f} a frame); top kernels: "
            + "; ".join(f"{name[:60]} {t / 1e3:.3f} ms x{c}" for name, (t, c) in top))
        if busy_us <= 0:
            raise AssertionError("the profiler recorded no device time")


def phase_profile(dev):
    """torch.profiler windows over bench frames PROFILE_FRAMES, then over
    steps PROFILE_WINDOW of phase 7's G = 320 loop, each twice (the spread
    between two runs of the same work)."""
    from fitslam_tpu_torch.ops.grid import GridSpec2D
    from fitslam_tpu_torch.utils.config import FitSlamConfig

    cfg = FitSlamConfig.preset("rapid")
    spec = GridSpec2D(320, cfg.traversability.resolution, -40.0, -40.0)
    profile_bench(dev)
    n = PROFILE_WINDOW[1] - PROFILE_WINDOW[0]
    for run in (1, 2):
        r = explore(dev, spec, cfg, (-37.0, -37.0), PROFILE_WINDOW[1] + 1, PROFILE_WINDOW)
        times = _kernel_times(r["prof"])
        busy_us = sum(t for t, _ in times.values())
        k3_us = sum(t for name, (t, _) in times.items() if "wavefront" in name)
        k3_n = sum(c for name, (_, c) in times.items() if "wavefront" in name)
        top = sorted(times.items(), key=lambda kv: -kv[1][0])[:6]
        log(f"[profile] run {run}, G=320 steps {PROFILE_WINDOW[0]}-{PROFILE_WINDOW[1] - 1}: window "
            f"{r['window_s'] * 1e3:.1f} ms host, kernel time {busy_us / 1e3:.2f} ms (busy "
            f"{busy_us / 1e4 / r['window_s']:.2f} %), "
            f"{sum(c for _, c in times.values()) / n:.1f} kernel launches a step; K3 "
            f"{k3_us / 1e3:.3f} ms in {k3_n} launches ({k3_us / max(busy_us, 1e-9) * 100:.1f} % "
            f"of kernel time); ms/tick {r['tick_s'] / max(r['tick_n'], 1) * 1e3:.2f}, "
            f"ms/controller step {r['ctrl_s'] / max(r['ctrl_n'], 1) * 1e3:.3f} over steps "
            f"0-{PROFILE_WINDOW[1] - 1}; top kernels: "
            + "; ".join(f"{name[:60]} {t / 1e3:.2f} ms x{c}" for name, (t, c) in top))
        if busy_us <= 0:
            raise AssertionError("the profiler recorded no device time")


def main() -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the port on one CUDA GPU.")
    ap.add_argument("--profile", action="store_true",
                    help="profiler windows over the bench and exploration loops instead")
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="import fitslam_tpu_torch from this directory (with --profile)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on the GPU", file=sys.stderr)
        return 1
    if args.tree != ROOT and not args.profile:
        ap.error("--tree goes with --profile")
    sys.path.insert(0, str(args.tree.resolve()))
    if args.tree != ROOT:
        # the timing helpers stay this checkout's; the package under test is the tree's
        for name in [m for m in sys.modules if m.split(".")[0] == "fitslam_tpu_torch"]:
            del sys.modules[name]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_script = time.monotonic()
    smi = phase_environment()
    if args.profile:
        phase_profile(dev)
        print(smi)
        return 0
    k1 = phase_k1(dev)
    k1d = phase_describe(dev)
    k2 = phase_k2(dev)
    phase_golden(dev)
    n, bench_fps = phase_bench(dev)
    k3 = phase_k3(dev)
    paths = {"bench": n}
    paths["explore"], paths["ablation"] = phase_explore(dev)
    active = phase_active(dev)
    paths.update(active=active["launches"], marsyard=phase_marsyard(dev), rgbd=phase_rgbd(dev))
    loop = phase_loop(dev)
    paths["loop"] = loop["launches"]
    k2.update(phase_k2_verify(dev))
    phase_atlas(dev)
    phase_ba(dev, loop)
    paths["dataset"], paths["tum"] = phase_dataset(dev)
    paths["ekf"], ekfw = phase_ekf(dev, active)
    paths["fleet"] = phase_fleet(dev)
    paths["fleet_slam"] = phase_fleet_slam(dev)
    paths["active_entry"], paths["vo"] = phase_entry(dev)
    paths["stage"] = phase_parallel(dev, loop, active)
    paths["bench_modes"], paths["graft_step"] = phase_bench_entry(dev, bench_fps)
    paths["captured"] = phase_captured(dev, smi)
    paths["loops"] = phase_loops(dev, smi)
    paths["control"] = phase_control(dev, smi, loop)
    paths["sim"] = phase_sim(dev, smi)

    def by_path(kernel):
        """The kernel's launches in each path's run (counts set to 0 just
        before it, read just after; None where a path did not count it)."""
        return {path: counts.get(kernel) for path, counts in paths.items()}

    kernels = [
        {"name": "K1 patch gather", "route": "cuda",
         "source": "fitslam_tpu_torch/csrc/patch_gather.cu",
         "replaces": "fitslam_tpu/ops/pallas_patches.py:31", "launches": n["gather"],
         "launches_by_path": by_path("gather"),
         "launches_note": "off the main path since the fused describe; phase 2 holds it "
                          "against its twin", **k1},
        {"name": "K1 fused ORB describe", "route": "cuda",
         "source": "fitslam_tpu_torch/csrc/patch_gather.cu",
         "replaces": "fitslam_tpu/ops/pallas_patches.py:31", "launches": n["describe"],
         "launches_by_path": by_path("describe"), **k1d},
        {"name": "K2 gated Hamming top-2", "route": "cuda",
         "source": "fitslam_tpu_torch/csrc/hamming_top2.cu",
         "replaces": "fitslam_tpu/ops/pallas_matching.py:31", "launches": n["top2"],
         "launches_by_path": by_path("top2"), **k2},
        {"name": "K3 wavefront sweeps", "route": "cuda",
         "source": "fitslam_tpu_torch/csrc/wavefront_sweep.cu",
         "replaces": "fitslam_tpu/ops/pallas_grid.py:29", "launches": paths["explore"]["sweep"],
         "launches_by_path": by_path("sweep"), **k3},
        {"name": "EKF window", "route": "cuda", "source": "fitslam_tpu_torch/csrc/ekf_window.cu",
         "replaces": "none: the reference's lax.scan, fitslam_tpu/models/localization.py:182",
         "launches": paths["ekf"]["ekf"], "launches_by_path": by_path("ekf"),
         "launches_note": "phase 12's run: one a window its DualEkf fused", **ekfw},
    ]
    log(f"[done] phases 1-20 in {time.monotonic() - t_script:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
