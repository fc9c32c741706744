"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits non-zero):
  1. environment: torch / CUDA versions, the card's name and power limit, and
     the nvcc build of the three kernels (fitslam_tpu_torch/csrc/*.cu, one
     nvcc per source, started together);
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
  5. bench size (640x480, 4 levels, 1024 features, 8192 landmarks, 60 frames
     rendered on the card from tests/data/bench_corridor_world.npz) through
     process_frame_async + finalize: one untimed pass, then three timed passes,
     each held to ATE <= 0.025 m and 2 fused-describe launches per frame
     (one per eye, no standalone gather); the descriptor bits in which the
     fused kernel and the parent's describe path differ on the 120 images;
  6. K3 (wavefront sweeps) against its plain twin at (G, iters) = (64, 192),
     (320, 512) and (512, 512), on random step costs and on a rooms-world
     maze, through the kernel its size rule picks and through the tiled
     kernel (the first port's), and with the resident kernel's bands
     exchanging rows every 2, 4 or 8 sweeps, and at ragged shapes through the
     size rule's kernel and the grouped exchanges: exactly equal; all timed
     at the main-path shapes, and at G = 64 the resident kernel as one block;
  7. (two lines) rapid-mode exploration at full width (the configured 80 m
     global map at 0.25 m, G = 320, FitSlamConfig.preset("rapid")) through
     ExplorationServer.tick() and SimNavInterface.step() for 300 steps, then
     the G = 64 configuration of bench_suite.py::bench_ablation held to
     tests/test_exploration_e2e.py's bounds;
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
     bounds.
Then a JSON line with every kernel's launches (K1/K2 from the last timed
pass of phase 5, K3 from the G = 320 run of phase 7; ``launches_by_path``
gives each path's run: bench, explore, active, marsyard, rgbd), error, device times
(CUDA events; level-0, one eye's four levels, window 1024x8192 and G = 320
shapes) of the kernel,
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
EDGE = 16  # ops/orb.py's border margin: no keypoint is extracted closer to the edge
PROFILE_FRAMES = (20, 40)  # bench frames that --profile traces
PROFILE_WINDOW = (120, 160)  # steps of the G = 320 loop that --profile traces
# NVIDIA's published peaks of one H100 SXM at its 700 W limit (dense): a
# kernel's bound is the larger of its bytes (each input read once, each output
# written once) over the memory rate and its operations over their type's rate
# (the float32 rate counts an FMA as two operations: instructions that do one,
# as K3's adds and mins do, issue at no more than half of it)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "f32": 67e12}
# final coverage of bench_suite.py::bench_ablation's arrival-info + roadmap
# method at step 299 (ABLATION_COVERAGE.csv), the reference's own run
REFERENCE_ABLATION_COVERAGE = 0.930
# phases 8-9: bench_suite.py's active-SLAM and marsyard runs and the RGB-D arc.
# The active run goes on past the bench's 80 frames to the 150 of
# tests/test_active_slam_e2e.py, whose bounds (the robot's extent above all)
# belong to that length; its figures at frame 80 stand beside the reference's.
ACTIVE_BENCH_FRAMES = 80
ACTIVE_FRAMES = 150
ACTIVE_TICK_EVERY = 4
MARSYARD_FRAMES = 150
RGBD_FRAMES = 40
# the reference's own runs of the same loops (BENCH_SUITE.json, config 4 at
# 640x480 and the marsyard run at 320x240): accuracy and coverage only,
# printed beside the port's and not asserted
REFERENCE_ACTIVE = {"ate_m": 0.0062, "coverage": 0.398, "goals": 3, "fi_rejections": 0,
                    "keyframes": 31}
REFERENCE_MARSYARD = {"lethal_precision": 1.0, "violations": 0, "coverage": 0.733, "goals": 10}


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


def kernel_sum(fn, reps: int = 10):
    """(device ms, kernel launches) a call of fn(), summed over the kernels
    that a torch.profiler window of ``reps`` calls records: the device's own
    work, whatever the host's pace."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    k = _kernel_times(prof)
    return sum(t for t, _ in k.values()) / reps / 1e3, sum(n for _, n in k.values()) / reps


def _us(t) -> str:
    return f"{t[0] * 1e3:.1f} us device / {t[1] * 1e3:.1f} us wall"


def bound(n_bytes: float, n_ops: float = 0.0, op_type: str = "f32") -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak of their type, whichever is larger."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_OPS_PER_S[op_type] * 1e3
    if by_bytes >= by_ops:
        return {"bound_ms": by_bytes, "bound_by": "bytes"}
    return {"bound_ms": by_ops, "bound_by": "operations"}


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


def describe_bytes_ops(levels, n):
    """Bytes (level images, keypoints, angle and bf16 descriptor out) and
    operations a call of the fused describe must do: per keypoint the blur's
    products and adds (40x32 + 32x32 outputs of 7 taps), its two bf16
    roundings, the moments' products and adds and the 256 bit tests."""
    n_bytes = sum(h * w * 4 for (h, w), _ in levels) + n * 8 + n * (4 + 256 * 2)
    per_kp = (40 * 32 + 32 * 32) * 13 + (40 * 40 + 32 * 32) + 4 * 1024 + 256
    return n_bytes, n * per_kp


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


def _k2_bytes(na, nb, mode):
    """Bytes K2 must move: packed descriptors, validity, positions (gated
    modes), levels (stereo), the gate, and the four outputs."""
    per_row = 32 + 1 + (8 if mode else 0) + (4 if mode == 2 else 0)
    return (na + nb) * per_row + (8 if mode else 0) + 3 * 4 * na + 4 * nb


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
    p = problems[1024, 8192]
    # yardstick: the +-1 product at K2's core as one bf16 matmul; it is not
    # the gated top-2 (no PyTorch call computes that)
    a_pm1 = pm._unpack_pm1(p["a_bits"]).to(torch.bfloat16)
    b_pm1 = pm._unpack_pm1(p["b_bits"]).to(torch.bfloat16).T.contiguous()
    lib = cuda_time_ms(lambda: torch.matmul(a_pm1, b_pm1))
    b_win = bound(_k2_bytes(1024, 8192, pm.GATE_WINDOW), 2 * 1024 * 8192 * 256, "int8")
    b_st = bound(_k2_bytes(1024, 1024, pm.GATE_STEREO), 2 * 1024 * 1024 * 256, "int8")
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
        f"{_us(lib)}")
    return {"max_abs_err": worst, "ms": dev_ms["window", pm.DEFAULT_DESIGN],
            "plain_ms": dev_ms["window", "plain"], **b_win, "library_ms": lib[0],
            "library_call": "bf16 +-1 torch.matmul (1024x256) @ (256x8192), the product "
                            "at K2's core; no PyTorch call computes the gated top-2",
            "shape": "window 1024x8192", "design": pm.DEFAULT_DESIGN,
            "pr2_ms": None,
            "pr2_ms_note": "the first port's K2 kernel is not in this tree; PERF.md gives its "
                           "time from a run of the parent commit in the same call",
            "stereo_ms": dev_ms["stereo", pm.DEFAULT_DESIGN],
            "stereo_bound_ms": b_st["bound_ms"],
            "design_ms": {f"{name} {d}": dev_ms[name, d] for _, _, name in cases for d in order}}


def _counted():
    """{kernel: its wrapper, which counts the kernel's launches}. A package
    from before the fused describe (``--tree``) has no describe wrapper."""
    from fitslam_tpu_torch.ops import orb, pallas_grid, pallas_matching, pallas_patches

    wrappers = {"gather": pallas_patches.gather_patches,
                "describe": getattr(orb, "describe_keypoints", None),
                "top2": pallas_matching.hamming_top2, "sweep": pallas_grid.wavefront_sweeps}
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


def bench_frames(dev, cfg):
    """The bench's N_BENCH_FRAMES stereo pairs, rendered on the card, and the
    ground-truth camera poses as float64 matrices."""
    from fitslam_tpu_torch.data import synthetic
    from fitslam_tpu_torch.ops import lie
    from fitslam_tpu_torch.ops.geometry import Intrinsics

    W, H = cfg.camera.width, cfg.camera.height
    K = Intrinsics.from_config(cfg.camera, dev)
    world = synthetic.load_world(device=dev)
    T_gt = synthetic.straight_trajectory(N_BENCH_FRAMES, length=N_BENCH_FRAMES * 0.15,
                                         height=1.2, start_x=0.5, device=dev)
    frames = [synthetic.render_stereo(K, world, lie.SE3(T_gt.R[i], T_gt.t[i]), width=W, height=H)
              for i in range(N_BENCH_FRAMES)]
    gt = [m.cpu().numpy().astype(np.float64) for m in T_gt.matrix()]
    torch.cuda.synchronize()
    return K, frames, gt


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
    from fitslam_tpu_torch.utils import evaluation as ev

    cfg = bench_config()
    W, H = cfg.camera.width, cfg.camera.height
    K, frames, gt = bench_frames(dev, cfg)

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
    return n


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
        if "synchroniz" in str(message):
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


def explore(dev, spec, cfg, start_xy, n_steps=EXPLORE_STEPS, profile_window=None):
    """The loop of tests/test_exploration_e2e.py through the port: reveal
    (3 m), a tick every second step, 4 controller steps per step. Returns a
    dict of what the run measured. With ``profile_window`` = (first, end) a
    ``torch.profiler`` traces steps first..end-1 (returned as ``prof``, with
    the window's host seconds as ``window_s``) and the run stops there."""
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
    steps, prof = 0, None
    for step in range(n_steps):
        if profile_window and step == profile_window[0]:
            torch.cuda.synchronize()
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            r["window_s"] = time.perf_counter()
        if profile_window and step == profile_window[1]:
            torch.cuda.synchronize()
            r["window_s"] = time.perf_counter() - r["window_s"]
            prof.__exit__(None, None, None)
            r["prof"] = prof
            break
        state["explored"] = sim.reveal_sensor(
            spec, gt, state["explored"], upload(np.asarray(robot.xy, np.float32), dev),
            range_m=3.0)
        done = False
        for w in ("tick", "ctrl"):
            if (w == "tick" and step % 2) or done:
                continue
            torch.cuda.synchronize()
            k3, t0 = _counts()["sweep"], time.perf_counter()
            with _torch_syncs(r, f"{w}_torch_syncs"):
                if w == "tick":
                    done = server.tick() == ExplorationState.DONE
                else:
                    for _ in range(4):
                        nav.step()
            torch.cuda.synchronize()
            r[f"{w}_n"] += 1 if w == "tick" else 4
            r[f"{w}_s"] += time.perf_counter() - t0
            r[f"{w}_k3"] += _counts()["sweep"] - k3
        coverage[step] = (state["explored"] != UNKNOWN).to(torch.float32).mean()
        steps = step + 1
        if done:
            break
    launches = _counts()
    cov = coverage[:steps].cpu().numpy()
    explored = state["explored"].cpu().numpy()
    known = explored != UNKNOWN
    r.update(
        steps=steps, coverage=cov, goals=server.diag.goals_sent, launches=launches,
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
    launches = r["launches"]

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
    return launches


# ---------------------------------------------------------------------------
# Phases 8-9: the active-SLAM loop, the marsyard run and the RGB-D arc
# ---------------------------------------------------------------------------


def active_config(W, H, features, levels, fx):
    """bench_suite.py::bench_active_slam's configuration (that of
    tests/test_active_slam_e2e.py and tests/test_marsyard_e2e.py at 320x240)."""
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


def rooms_world(dev, spec, floor_points):
    """The rooms world of seed 3 as 3D landmarks (walls 2 m high, 4 points a
    wall cell), with the reference's seed for jax.random.PRNGKey(5)."""
    from fitslam_tpu_torch.data import synthetic
    from fitslam_tpu_torch.models.sim_robot import make_rooms_world

    return synthetic.world_from_occupancy(make_rooms_world(spec, seed=3), spec,
                                          synthetic.ROOMS_WORLD_SEED, wall_height=2.0,
                                          points_per_wall_cell=4, floor_points=floor_points,
                                          device=dev)


def run_active(dev, cfg, spec, landmarks, start, n_frames, max_omega, surface_z=None,
               snapshot_at=None):
    """The loop of bench_suite.py::bench_active_slam through the port's
    ActiveSlamSystem: a stereo frame and its frustum cloud every step, a
    tick every ACTIVE_TICK_EVERY steps (then the FI oracle's value at the
    robot's true pose, read outside the tick), a controller step every
    step. Each frame, tick and controller step runs between two
    synchronizes and is counted: host seconds, the engine's and torch's
    host syncs (with torch's call sites), and kernel launches. After
    ``snapshot_at`` frames the coverage, goals, FI rejections and keyframes
    are noted (outside the windows) as ``r["snapshot"]``.

    The system's scheduling clock is a ``SimClock`` that reads the
    simulation's time, a controller step of 0.15 s a frame, not the host's:
    on the host's clock the roadmap's periodic cleanup fires at other frames
    on a faster or slower host, and the run's goals and path differ from
    call to call."""
    from fitslam_tpu_torch.data import synthetic
    from fitslam_tpu_torch.models import sim_robot as sim
    from fitslam_tpu_torch.models.active_slam import ActiveSlamSystem, camera_pose_from_robot
    from fitslam_tpu_torch.models.sim_nav import SimNavInterface
    from fitslam_tpu_torch.ops import lie
    from fitslam_tpu_torch.ops.geometry import Intrinsics
    from fitslam_tpu_torch.ops.grid import UNKNOWN
    from fitslam_tpu_torch.utils.profiling import SimClock

    clock = SimClock()
    dt = 0.15
    W, H = cfg.camera.width, cfg.camera.height
    K = Intrinsics.from_config(cfg.camera, dev)
    robot = sim.DiffDriveRobot(x=start[0], y=start[1], yaw=start[2], v_max=0.8, w_max=1.0)
    box = {}
    nav = SimNavInterface(cfg, spec, robot, lambda: box["sys"].occupancy(), dt=dt, device=dev)
    nav.controller.max_omega = max_omega
    system = ActiveSlamSystem(cfg, spec, nav, device=dev, event_logger=clock,
                              get_robot_pose=lambda: box["sys"].estimated_robot_pose())
    box["sys"] = system

    def engine_syncs():
        return (system.slam.host_syncs + nav.host_syncs + system.explorer.host_syncs
                + system.host_syncs)

    r = {f"{w}_{k}": 0 for w in ("frame", "tick", "ctrl")
         for k in ("n", "s", "syncs", "torch_syncs", "describe", "top2", "sweep")}
    r.update({f"{w}_sites": Counter() for w in ("frame", "tick", "ctrl")})
    cams, fi_values = [], []
    _reset_counts()
    for step in range(n_frames):
        z = 0.8 if surface_z is None else surface_z(robot.x, robot.y) + 0.8
        cam = camera_pose_from_robot(robot.x, robot.y, robot.yaw, height=z, device=dev)
        if step == 0:
            system.set_world_anchor(cam)
        cams.append(cam)
        left, right = synthetic.render_stereo(K, landmarks, cam, width=W, height=H,
                                              max_depth=12.0)
        cloud, cvalid = synthetic.frustum_cloud(K, landmarks, cam,
                                                max_points=cfg.traversability.max_points_per_cloud,
                                                max_depth=8.0, width=W, height=H)
        windows = [("frame", lambda: system.process_frame(left, right, cloud, cvalid))]
        if step % ACTIVE_TICK_EVERY == ACTIVE_TICK_EVERY - 1:
            windows.append(("tick", system.tick_exploration))
        windows.append(("ctrl", nav.step))
        for w, fn in windows:
            torch.cuda.synchronize()
            before, launches, t0 = engine_syncs(), _counts(), time.perf_counter()
            with _torch_syncs(r, f"{w}_torch_syncs", r[f"{w}_sites"]):
                fn()
            torch.cuda.synchronize()
            r[f"{w}_s"] += time.perf_counter() - t0
            r[f"{w}_n"] += 1
            r[f"{w}_syncs"] += engine_syncs() - before
            for k, v in _counts().items():
                if f"{w}_{k}" in r:
                    r[f"{w}_{k}"] += v - launches[k]
            if w == "tick":
                fi_values.append(system.fisher_information_of_pose(robot.xy, robot.yaw))
        clock.sim_s += dt
        if step + 1 == snapshot_at:
            d = system.explorer.diag
            r["snapshot"] = dict(
                coverage=float((system.occupancy() != UNKNOWN).float().mean()),
                goals=d.goals_sent, fi_rejections=d.fi_rejections,
                n_kf=int(system.slam.map.n_kf))
    launches = _counts()
    system.finalize()
    Rs = torch.stack([c.R for c in cams])
    ts = torch.stack([c.t for c in cams])
    gt = list(lie.SE3(Rs, ts).matrix().cpu().numpy().astype(np.float64))
    occ = system.occupancy().cpu().numpy()
    traj = np.array([(x, y) for x, y, _ in robot.trajectory])
    r.update(system=system, robot=robot, nav=nav, gt=gt, occ=occ, fi=fi_values,
             launches=launches, n_kf=int(system.slam.map.n_kf),
             extent=float(np.ptp(traj[:, 0]) + np.ptp(traj[:, 1])), traj=traj,
             ate=_ate_world(system.slam.trajectory, gt))
    return r


def _ate_world(trajectory, gt):
    """ATE of a SLAM-frame trajectory anchored at the first ground-truth
    pose, without alignment (the reference tests' measure)."""
    from fitslam_tpu_torch.utils import evaluation as ev

    return ev.ate_rmse([gt[0] @ T for T in trajectory], gt, align=False)


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
    for w in ("frame", "tick", "ctrl"):
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
    world = rooms_world(dev, spec, floor_points=4000)
    # the bench's controller (max_omega at its default of 1.0)
    r = run_active(dev, cfg, spec, world.landmarks, (-5.0, -5.0, 0.3), ACTIVE_FRAMES,
                   max_omega=1.0, snapshot_at=ACTIVE_BENCH_FRAMES)
    at80 = r["snapshot"]
    ate80 = _ate_world(r["system"].slam.trajectory[:ACTIVE_BENCH_FRAMES],
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
        f"points), {ACTIVE_FRAMES} frames, a tick every {ACTIVE_TICK_EVERY}: {r['frame_n']} "
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
    return r["launches"]


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
    occ = r["occ"]
    known = occ != gr.UNKNOWN
    grid_lethal = known & (occ >= gr.INSCRIBED)
    gt, gt_dil = mw.gt_lethal, np.zeros_like(mw.gt_lethal)
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            gt_dil |= np.roll(np.roll(gt, dy, axis=0), dx, axis=1)
    precision = float((grid_lethal & gt_dil).sum() / max(grid_lethal.sum(), 1))
    cells = np.clip(((r["traj"] - [spec.origin_x, spec.origin_y]) / spec.resolution).astype(int),
                    0, spec.size - 1)
    violations = int(gt[cells[:, 1], cells[:, 0]].sum())
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
    world = rooms_world(dev, spec, floor_points=5000)
    slam = StereoSlam(cfg, dev)
    tcfg = cfg.traversability
    box = {"clouds": gr.empty_cloud_buffer(tcfg.max_clouds, tcfg.max_points_per_cloud, dev)}

    def on_kf(s, kf_idx):
        pts, ok = gr.depth_image_to_cloud(K, box["depth"], stride=8, max_depth=8.0)
        box["clouds"] = gr.add_cloud(box["clouds"], pts, ok, kf_idx)

    slam.keyframe_events.append(on_kf)
    x, y, yaw = -5.0, -5.0, 0.3
    cams = []
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(RGBD_FRAMES):
        cam = camera_pose_from_robot(x, y, yaw, device=dev)
        cams.append(cam)
        img, box["depth"] = synthetic.render_rgbd(K, world.landmarks, cam, width=W, height=H,
                                                  max_depth=12.0)
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
    ate = _ate_world(slam.trajectory, gt)
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


def _kernel_times(prof):
    """{kernel name: (device us, launches)} of a profiler's CUDA kernels."""
    out = {}
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

    cfg = bench_config()
    _, frames, _ = bench_frames(dev, cfg)
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = phase_environment()
    if args.profile:
        phase_profile(dev)
        print(smi)
        return 0
    k1 = phase_k1(dev)
    k1d = phase_describe(dev)
    k2 = phase_k2(dev)
    phase_golden(dev)
    n = phase_bench(dev)
    k3 = phase_k3(dev)
    paths = {"bench": n, "explore": phase_explore(dev), "active": phase_active(dev),
             "marsyard": phase_marsyard(dev), "rgbd": phase_rgbd(dev)}

    def by_path(kernel):
        """The kernel's launches in each path's run (counts set to 0 just
        before it, read just after)."""
        return {path: counts[kernel] for path, counts in paths.items()}

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
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
