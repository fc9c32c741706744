"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits non-zero):
  1. environment: torch / CUDA versions, the card's name and power limit, and
     the nvcc build of the three kernels (fitslam_tpu_torch/csrc/*.cu, one
     nvcc per source, started together);
  2. K1 (patch gather) against its plain twin at the bench's four pyramid
     level shapes, including clamped borders: bit-equal;
  3. K2 (gated Hamming top-2) against its plain twin in all three gate modes
     at 1024 x 8192 with planted matches and ties: exactly equal;
  4. golden replay of tests/data/corridor_seq through StereoSlam.process_frame:
     ATE <= 0.025 m, 10-30 keyframes, both kernels launched;
  5. bench size (640x480, 4 levels, 1024 features, 8192 landmarks, 60 frames
     rendered on the card from tests/data/bench_corridor_world.npz) through
     process_frame_async + finalize: one untimed pass, then three timed passes,
     each held to ATE <= 0.025 m and 8 K1 launches per frame;
  6. K3 (wavefront sweeps) against its plain twin at (G, iters) = (64, 192),
     (320, 512) and (512, 512), on random step costs and on a rooms-world
     maze: exactly equal;
  7. (two lines) rapid-mode exploration at full width (the configured 80 m global map at
     0.25 m, G = 320, FitSlamConfig.preset("rapid")) through
     ExplorationServer.tick() and SimNavInterface.step() for 300 steps, then
     the G = 64 configuration of bench_suite.py::bench_ablation held to
     tests/test_exploration_e2e.py's bounds.
Then a JSON line with every kernel's launches (K1/K2 from the last timed
pass of phase 5, K3 from the G = 320 run of phase 7), error and device times
(CUDA events; level-0, window 1024x8192 and G = 320 shapes), the card's
``nvidia-smi`` line, and as the last line ``{"ok": true, "device": {...}}``.

There is no CPU path: without a CUDA device the script exits with an error.
"""

import dataclasses
import json
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ATE_BOUND_M = 0.025
GOLDEN_KF_RANGE = (10, 30)
N_BENCH_FRAMES = 60
N_TIMED_PASSES = 3
KERNELS = ("patch_gather", "hamming_top2", "wavefront_sweep")
K3_CASES = ((64, 192), (320, 512), (512, 512))
EXPLORE_STEPS = 300
# final coverage of bench_suite.py::bench_ablation's arrival-info + roadmap
# method at step 299 (ABLATION_COVERAGE.csv), the reference's own run
REFERENCE_ABLATION_COVERAGE = 0.930


def log(msg: str) -> None:
    print(msg, flush=True)


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


def _us(t) -> str:
    return f"{t[0] * 1e3:.1f} us device / {t[1] * 1e3:.1f} us wall"


def phase_environment():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    from fitslam_tpu_torch.utils import cuda_build

    t0 = time.monotonic()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(cuda_build.load_kernel_library, KERNELS))
    build_s = time.monotonic() - t0
    ptxas = [ln.strip() for name in KERNELS
             for ln in cuda_build.build_log(name).splitlines() if "registers" in ln]
    log(f"[1 env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} | {smi} | kernels built in {build_s:.1f} s; "
        f"ptxas: {' / '.join(ptxas) or 'cached build'}")
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
        times.append((cuda_time_ms(lambda: gather_patches(img, xy, 40)),
                      cuda_time_ms(lambda: gather_patches_plain(img, xy, 40))))
    per_level = "; ".join(f"{h}x{w} N={n}: kernel {_us(k)}, plain {_us(p)}"
                          for ((h, w), n), (k, p) in zip(shapes, times))
    log(f"[2 K1] bit-equal to its twin at 4 level shapes (tolerance 0, max |d| {worst}); "
        f"{per_level}")
    return {"max_abs_err": worst, "ms": times[0][0][0], "plain_ms": times[0][1][0]}


def _k2_problem(dev, na=1024, nb=8192):
    from fitslam_tpu_torch.ops.orb import pack_descriptors

    rng = np.random.RandomState(2)
    a = np.where(rng.rand(na, 256) < 0.5, 1.0, -1.0).astype(np.float32)
    b = np.where(rng.rand(nb, 256) < 0.5, 1.0, -1.0).astype(np.float32)
    xy_a = rng.randint(0, 640, (na, 2)).astype(np.float32) + 0.5
    xy_b = rng.randint(0, 640, (nb, 2)).astype(np.float32) + 0.5
    perm = rng.permutation(nb)
    for i in range(na // 2):                      # planted matches, 0-12 flipped bits
        j = perm[i]
        flip = rng.rand(256) < rng.uniform(0.0, 0.05)
        b[j] = np.where(flip, -a[i], a[i])
        xy_b[j] = xy_a[i] + rng.uniform(-3, 3, 2).astype(np.float32)
        xy_b[j, 0] = xy_a[i, 0] - rng.uniform(1.0, 60.0)   # positive disparity
    for i in range(na // 2, na // 2 + 64):        # planted row ties: two equal columns
        j1, j2 = perm[i], perm[i + 64]
        b[j1] = b[j2] = a[i]
        xy_b[j1] = xy_b[j2] = xy_a[i] + np.float32(24.0) * np.array([1, 0], np.float32)
    a[na - 32:] = a[:32]                          # planted column ties: duplicate rows
    xy_a[na - 32:] = xy_a[:32]
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

    p = _k2_problem(dev)
    gates = {
        pm.GATE_NONE: None,
        pm.GATE_WINDOW: torch.tensor([24.0 * 24.0, 0.0], device=dev),
        pm.GATE_STEREO: torch.tensor([2.0, 0.2 * 400.0 / 0.3], dtype=torch.float32, device=dev),
    }
    worst, found = 0, {}
    for mode, gate in gates.items():
        got = pm.hamming_top2(**p, mode=mode, gate=gate)
        ref = pm.hamming_top2_plain(**p, mode=mode, gate=gate)
        torch.cuda.synchronize()
        for f in pm.Top2._fields:
            x, y = getattr(got, f), getattr(ref, f)
            worst = max(worst, int((x - y).abs().max().item()))
            if not torch.equal(x, y):
                raise AssertionError(f"K2 mode {mode}: {f} differs from its twin in "
                                     f"{int((x != y).sum())} entries")
        found[mode] = int((ref.best < 64).sum())
    if found[pm.GATE_NONE] < 400:
        raise AssertionError(f"planted matches not found: {found}")
    win = cuda_time_ms(lambda: pm.hamming_top2(**p, mode=pm.GATE_WINDOW, gate=gates[pm.GATE_WINDOW]))
    win_plain = cuda_time_ms(lambda: pm.hamming_top2_plain(**p, mode=pm.GATE_WINDOW,
                                                           gate=gates[pm.GATE_WINDOW]), reps=10)
    ps = _k2_problem(dev, 1024, 1024)
    st = cuda_time_ms(lambda: pm.hamming_top2(**ps, mode=pm.GATE_STEREO, gate=gates[pm.GATE_STEREO]))
    st_plain = cuda_time_ms(lambda: pm.hamming_top2_plain(**ps, mode=pm.GATE_STEREO,
                                                          gate=gates[pm.GATE_STEREO]), reps=10)
    log(f"[3 K2] idx/best/second/col_best exactly equal to its twin in modes none/window/stereo "
        f"at 1024x8192 (tolerance 0; rows with best < 64: {found}); window 1024x8192: kernel "
        f"{_us(win)}, plain {_us(win_plain)}; stereo 1024x1024: kernel {_us(st)}, "
        f"plain {_us(st_plain)}")
    return {"max_abs_err": worst, "ms": win[0], "plain_ms": win_plain[0]}


def _reset_counts():
    from fitslam_tpu_torch.ops.pallas_grid import wavefront_sweeps
    from fitslam_tpu_torch.ops.pallas_matching import hamming_top2
    from fitslam_tpu_torch.ops.pallas_patches import gather_patches

    gather_patches.launches = 0
    hamming_top2.launches = 0
    wavefront_sweeps.launches = 0


def _counts():
    """(K1, K2, K3) launches since the last reset."""
    from fitslam_tpu_torch.ops.pallas_grid import wavefront_sweeps
    from fitslam_tpu_torch.ops.pallas_matching import hamming_top2
    from fitslam_tpu_torch.ops.pallas_patches import gather_patches

    return gather_patches.launches, hamming_top2.launches, wavefront_sweeps.launches


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
    k1, k2, _ = _counts()
    gt = list(np.load(seq / "gt_poses.npy"))
    ate = ev.ate_rmse(slam.trajectory, gt)
    n_kf = int(slam.map.n_kf)
    log(f"[4 golden] corridor_seq 40 frames 320x240: ATE {ate:.4f} m, {n_kf} keyframes, "
        f"K1 {k1} / K2 {k2} launches")
    if not ate <= ATE_BOUND_M:
        raise AssertionError(f"golden ATE {ate} > {ATE_BOUND_M}")
    if not GOLDEN_KF_RANGE[0] <= n_kf <= GOLDEN_KF_RANGE[1]:
        raise AssertionError(f"golden keyframes {n_kf} outside {GOLDEN_KF_RANGE}")
    if k1 <= 0 or k2 <= 0:
        raise AssertionError(f"kernels not launched on the main path: K1 {k1}, K2 {k2}")


def bench_config():
    from fitslam_tpu_torch.utils.config import FitSlamConfig

    W, H = 640, 480
    cfg = FitSlamConfig()
    return dataclasses.replace(
        cfg,
        camera=dataclasses.replace(cfg.camera, width=W, height=H, fx=0.625 * W, fy=0.625 * W,
                                   cx=W / 2, cy=H / 2, baseline=0.2),
        orb=dataclasses.replace(cfg.orb, num_features=1024, num_levels=4, fast_threshold=12.0),
        tracking=dataclasses.replace(cfg.tracking, min_inliers=12, keyframe_min_interval=2,
                                     keyframe_translation=0.75, reloc_enabled=False),
        mapping=dataclasses.replace(cfg.mapping, max_keyframes=64, max_landmarks=8192,
                                    max_observations=32768, local_window=6, ba_iters=3),
        loop=dataclasses.replace(cfg.loop, enabled=False),
    )


def phase_bench(dev):
    from fitslam_tpu_torch.data import synthetic
    from fitslam_tpu_torch.models import tracking as tr
    from fitslam_tpu_torch.models.slam import StereoSlam
    from fitslam_tpu_torch.ops import lie
    from fitslam_tpu_torch.ops.geometry import Intrinsics
    from fitslam_tpu_torch.utils import evaluation as ev

    cfg = bench_config()
    W, H = cfg.camera.width, cfg.camera.height
    K = Intrinsics.from_config(cfg.camera, dev)
    world = synthetic.load_world(device=dev)
    T_gt = synthetic.straight_trajectory(N_BENCH_FRAMES, length=N_BENCH_FRAMES * 0.15,
                                         height=1.2, start_x=0.5, device=dev)
    frames = [synthetic.render_stereo(K, world, lie.SE3(T_gt.R[i], T_gt.t[i]), width=W, height=H)
              for i in range(N_BENCH_FRAMES)]
    gt = [m.cpu().numpy().astype(np.float64) for m in T_gt.matrix()]
    torch.cuda.synchronize()

    # untimed pass: first calls, and torch's own count of synchronising calls
    warm = StereoSlam(cfg, dev)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for l, r in frames:
                warm.process_frame_async(l, r)
            torch.cuda.synchronize()
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

    # timed passes: the host clock varies between passes (the step is
    # host-bound), so every pass is reported
    fps = []
    for _ in range(N_TIMED_PASSES):
        slam = StereoSlam(cfg, dev)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for l, r in frames:
            slam.process_frame_async(l, r)
        torch.cuda.synchronize()
        fps.append(N_BENCH_FRAMES / (time.monotonic() - t0))
        k1, k2, _ = _counts()
        syncs = slam.host_syncs
        stats = slam.finalize()
        ate = ev.ate_rmse(slam.trajectory, gt)
        n_kf = int(slam.map.n_kf)
        if k1 != 8 * N_BENCH_FRAMES:
            raise AssertionError(f"K1 launched {k1} times, expected 8 per frame")
        if k2 <= 0:
            raise AssertionError("K2 never launched on the main path")
        if not ate <= ATE_BOUND_M:
            raise AssertionError(f"bench ATE {ate} > {ATE_BOUND_M}")
    log(f"[5 bench] {N_BENCH_FRAMES} frames {W}x{H}, {o.num_features} features, "
        f"{o.num_levels} levels, {cfg.mapping.max_landmarks} landmarks: "
        f"{sorted(fps)[len(fps) // 2]:.2f} frames/s median of passes "
        f"{', '.join(f'{f:.2f}' for f in fps)} (frontend alone {frontend_ms:.2f} ms/frame), "
        f"ATE {ate:.4f} m, {n_kf} keyframes ({len(stats['keyframes'])} in outputs), "
        f"host syncs/frame {syncs / N_BENCH_FRAMES:.2f} (torch-reported syncs/frame in the "
        f"untimed pass {torch_syncs / N_BENCH_FRAMES:.2f}), "
        f"K1 {k1 / N_BENCH_FRAMES:.2f} / K2 {k2 / N_BENCH_FRAMES:.2f} launches/frame")
    return k1, k2


def _k3_problems(G):
    """Two (pot0, step, passable) problems at G: random step costs in
    [0.25, 0.55] on 90 % passable cells with the goal at corner cell (0, 0),
    and the rooms-world maze (step 0.25 m, walls impassable) with the goal
    at the corner cell of its free area, (2, 2)."""
    from fitslam_tpu_torch.models.sim_robot import make_rooms_world
    from fitslam_tpu_torch.ops.grid import LETHAL, GridSpec2D
    from fitslam_tpu_torch.ops.pallas_grid import BIG

    rng = np.random.RandomState(G)
    step = rng.uniform(0.25, 0.55, (G, G)).astype(np.float32)
    passable = rng.rand(G, G) < 0.9
    pot0 = np.full((G, G), BIG, np.float32)
    pot0[0, 0] = 0.0
    maze = make_rooms_world(GridSpec2D(G, 0.25, 0.0, 0.0), seed=1)
    maze_pot0 = np.full((G, G), BIG, np.float32)
    maze_pot0[2, 2] = 0.0
    return [(pot0, step, passable),
            (maze_pot0, np.full((G, G), 0.25, np.float32), maze != LETHAL)]


def phase_k3(dev):
    from fitslam_tpu_torch.ops.pallas_grid import BIG, wavefront_sweeps, wavefront_sweeps_plain

    worst, parts, times = 0.0, [], {}
    for G, iters in K3_CASES:
        problems = [tuple(torch.as_tensor(a, device=dev) for a in p) for p in _k3_problems(G)]
        for k, (pot0, step, passable) in enumerate(problems):
            got = wavefront_sweeps(pot0, step, passable, iters)
            ref = wavefront_sweeps_plain(pot0, step, passable, iters)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"K3 differs from its twin at G={G} iters={iters} "
                                     f"problem {k}: {int((got != ref).sum())} cells, max |d| "
                                     f"{(got - ref).abs().max().item()}")
            worst = max(worst, (got - ref).abs().max().item())
            reached = int((ref < BIG).sum())
            if reached < G:
                raise AssertionError(f"K3 problem {k} at G={G}: the wavefront reached "
                                     f"only {reached} cells")
        pot0, step, passable = problems[0]
        kern = cuda_time_ms(lambda: wavefront_sweeps(pot0, step, passable, iters), reps=20)
        plain = cuda_time_ms(lambda: wavefront_sweeps_plain(pot0, step, passable, iters),
                             reps=3, warmup=1)
        times[G] = (kern, plain)
        parts.append(f"G={G} iters={iters}: kernel {kern[0]:.3f} ms device / {kern[1]:.3f} ms "
                     f"wall, plain {plain[0]:.2f} ms device / {plain[1]:.2f} ms wall")
    log(f"[6 K3] exactly equal to its twin (tolerance 0, max |d| {worst}) on random and "
        f"rooms-maze problems at {K3_CASES}; " + "; ".join(parts))
    return {"max_abs_err": worst, "ms": times[320][0][0], "plain_ms": times[320][1][0]}


@contextmanager
def _torch_syncs(tally: dict, key: str):
    """Add to ``tally[key]`` torch's own count of synchronising calls made
    inside the block (sync debug mode "warn" only there)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
    tally[key] += sum("synchroniz" in str(w.message) for w in caught)


def explore(dev, spec, cfg, start_xy, n_steps=EXPLORE_STEPS):
    """The loop of tests/test_exploration_e2e.py through the port: reveal
    (3 m), a tick every second step, 4 controller steps per step. Returns a
    dict of what the run measured."""
    from fitslam_tpu_torch.models import sim_robot as sim
    from fitslam_tpu_torch.models.exploration import ExplorationServer, ExplorationState
    from fitslam_tpu_torch.models.sim_nav import SimNavInterface
    from fitslam_tpu_torch.ops.grid import UNKNOWN
    from fitslam_tpu_torch.utils.transfer import upload

    gt = torch.as_tensor(sim.make_rooms_world(spec, seed=1), device=dev)
    state = {"explored": torch.full((spec.size, spec.size), UNKNOWN, dtype=torch.uint8,
                                    device=dev)}
    robot = sim.DiffDriveRobot(x=start_xy[0], y=start_xy[1], yaw=0.0, v_max=1.2, w_max=2.5)
    nav = SimNavInterface(cfg, spec, robot, lambda: state["explored"], dt=0.15, device=dev)
    nav.controller.max_omega = 2.0
    server = ExplorationServer(cfg, spec, lambda: state["explored"], nav,
                               get_robot_pose=lambda: (robot.xy, robot.yaw), device=dev)
    coverage = torch.zeros(n_steps, device=dev)
    # per window (tick / controller): calls, seconds, K3 launches, torch syncs
    r = {f"{w}_{k}": 0 for w in ("tick", "ctrl") for k in ("n", "s", "k3", "torch_syncs")}
    _reset_counts()
    steps = 0
    for step in range(n_steps):
        state["explored"] = sim.reveal_sensor(
            spec, gt, state["explored"], upload(np.asarray(robot.xy, np.float32), dev),
            range_m=3.0)
        done = False
        for w in ("tick", "ctrl"):
            if (w == "tick" and step % 2) or done:
                continue
            torch.cuda.synchronize()
            k3, t0 = _counts()[2], time.perf_counter()
            with _torch_syncs(r, f"{w}_torch_syncs"):
                if w == "tick":
                    done = server.tick() == ExplorationState.DONE
                else:
                    for _ in range(4):
                        nav.step()
            torch.cuda.synchronize()
            r[f"{w}_n"] += 1 if w == "tick" else 4
            r[f"{w}_s"] += time.perf_counter() - t0
            r[f"{w}_k3"] += _counts()[2] - k3
        coverage[step] = (state["explored"] != UNKNOWN).to(torch.float32).mean()
        steps = step + 1
        if done:
            break
    cov = coverage[:steps].cpu().numpy()
    explored = state["explored"].cpu().numpy()
    known = explored != UNKNOWN
    r.update(
        steps=steps, coverage=cov, goals=server.diag.goals_sent, k3=_counts()[2],
        agree=float((explored[known] == sim.make_rooms_world(spec, seed=1)[known]).mean()),
        plans=nav.plans, tick_syncs=server.host_syncs, ctrl_syncs=nav.host_syncs,
        nodes=int(server.roadmap.n_nodes))
    return r


def ablation_config():
    """bench_suite.py::bench_ablation's G = 64 configuration (arrival info +
    roadmap costs), which is tests/test_exploration_e2e.py's."""
    from fitslam_tpu_torch.utils.config import FitSlamConfig

    cfg = FitSlamConfig()
    return dataclasses.replace(
        cfg,
        frontier_search=dataclasses.replace(cfg.frontier_search, search_radius_m=6.0,
                                            max_frontiers=64),
        roadmap=dataclasses.replace(cfg.roadmap, max_nodes=256, cleanup_period_s=5.0),
        nav=dataclasses.replace(cfg.nav, wavefront_iters=192, desired_speed=0.8),
        exploration_bt=dataclasses.replace(cfg.exploration_bt, nav2_goal_timeout_s=30.0),
        fisher_information=dataclasses.replace(cfg.fisher_information, enabled=False),
        cost_assigner=dataclasses.replace(
            cfg.cost_assigner,
            cost_calculation_methods=("ArrivalInformation", "RoadmapPlannerDistance")),
    )


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
    k3_main = r["k3"]

    small = GridSpec2D(64, 0.25, -8.0, -8.0)
    a = explore(dev, small, ablation_config(), (-5.0, -5.0), n_steps)
    acov = a["coverage"]
    log(f"[7 explore] G=64 bench_ablation config, {a['steps']} steps: final coverage "
        f"{acov[-1]:.4f} (reference {REFERENCE_ABLATION_COVERAGE} at step 299), "
        f"{acov[10]:.4f} at step 10, "
        f"{a['goals']} goals, {a['tick_n'] / a['tick_s']:.2f} ticks/s, "
        f"{a['ctrl_n'] / a['ctrl_s']:.1f} controller steps/s; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    if not (acov[-1] > 0.5 and acov[-1] > acov[10] + 0.2):
        raise AssertionError(f"G=64 coverage {acov[10]} -> {acov[-1]} misses the bounds")
    return k3_main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on the GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = phase_environment()
    k1 = phase_k1(dev)
    k2 = phase_k2(dev)
    phase_golden(dev)
    n1, n2 = phase_bench(dev)
    k3 = phase_k3(dev)
    n3 = phase_explore(dev)
    kernels = [
        {"name": "K1 patch gather", "route": "cuda",
         "source": "fitslam_tpu_torch/csrc/patch_gather.cu",
         "replaces": "fitslam_tpu/ops/pallas_patches.py:31", "launches": n1, **k1},
        {"name": "K2 gated Hamming top-2", "route": "cuda",
         "source": "fitslam_tpu_torch/csrc/hamming_top2.cu",
         "replaces": "fitslam_tpu/ops/pallas_matching.py:31", "launches": n2, **k2},
        {"name": "K3 wavefront sweeps", "route": "cuda",
         "source": "fitslam_tpu_torch/csrc/wavefront_sweep.cu",
         "replaces": "fitslam_tpu/ops/pallas_grid.py:29", "launches": n3, **k3},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
