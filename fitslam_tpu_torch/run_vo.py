"""Run stereo visual SLAM on a synthetic corridor sequence (the port's
counterpart of the reference's ``examples/run_vo.py``).

Usage:
    python -m fitslam_tpu_torch.run_vo --frames 24 --cpu        # small CPU run
    python -m fitslam_tpu_torch.run_vo --frames 100             # on the card
    python -m fitslam_tpu_torch.run_vo --export-dataset DIR     # render PGM pairs, exit
    python -m fitslam_tpu_torch.run_vo --dataset DIR            # replay them

The corridor world is ``corridor_world(prng_key(42), num=1500, length=30,
width=5)``, drawn bit for bit as the reference draws it, and the camera
(a captured ``SimCamera``) drives straight down it at 0.17 m a frame.
Prints per-frame tracking stats, the final ATE against the ground truth (aligned, and unaligned in the SLAM
frame anchored at the first camera), frames/s, the kernels' launches and the
profiler's table. ``--export-dataset DIR`` writes the rendered frames as
8-bit PGM pairs (``DIR/left``, ``DIR/right``); ``--dataset DIR`` replays
such pairs through the native prefetching readers instead of rendering. The
run is on the card unless ``--cpu`` is given; it exits 1 above the
example's 0.2 m ATE bound.
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
from fitslam_tpu_torch.models.slam import StereoSlam
from fitslam_tpu_torch.ops import lie
from fitslam_tpu_torch.ops.geometry import Intrinsics
from fitslam_tpu_torch.run_active_slam import kernel_launches
from fitslam_tpu_torch.runtime.native import PgmSequenceReader, write_pgm
from fitslam_tpu_torch.utils import evaluation as ev
from fitslam_tpu_torch.utils import prng
from fitslam_tpu_torch.utils.config import FitSlamConfig
from fitslam_tpu_torch.utils.transfer import upload

ATE_BOUND_M = 0.2


def vo_config(W: int, H: int, features: int, levels: int) -> FitSlamConfig:
    """The reference example's configuration."""
    cfg = FitSlamConfig()
    return dataclasses.replace(
        cfg,
        camera=dataclasses.replace(cfg.camera, width=W, height=H, fx=0.625 * W, fy=0.625 * W,
                                   cx=W / 2, cy=H / 2, baseline=0.2),
        orb=dataclasses.replace(cfg.orb, num_features=features, num_levels=levels,
                                fast_threshold=12.0),
        tracking=dataclasses.replace(cfg.tracking, min_inliers=12, keyframe_min_interval=2,
                                     keyframe_translation=0.3),
        mapping=dataclasses.replace(cfg.mapping, max_keyframes=64, max_landmarks=4096,
                                    max_observations=16384, local_window=4, ba_iters=4),
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--features", type=int, default=512)
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--dataset", type=str, default="",
                    help="directory with left/ and right/ PGM sequences; frames stream "
                         "through the native prefetch reader")
    ap.add_argument("--export-dataset", type=str, default="",
                    help="render the synthetic sequence to PGM files here and exit "
                         "(creates left/ and right/)")
    return ap


def device_of(args: argparse.Namespace) -> str:
    return "cpu" if args.cpu else "cuda"


def export_dataset(out: Path, K, world, T_gt, n_frames: int, W: int, H: int) -> None:
    """The rendered stereo frames as 8-bit PGM pairs under ``out``."""
    for eye in ("left", "right"):
        (out / eye).mkdir(parents=True, exist_ok=True)
    for i in range(n_frames):
        left, right = synthetic.render_stereo(K, world, lie.SE3(T_gt.R[i], T_gt.t[i]),
                                              width=W, height=H)
        write_pgm(str(out / "left" / f"{i:06d}.pgm"), left.cpu().numpy())
        write_pgm(str(out / "right" / f"{i:06d}.pgm"), right.cpu().numpy())


def run(args: argparse.Namespace, device="cuda") -> dict:
    """The example's run; returns its figures (``exported`` only, with
    ``--export-dataset``)."""
    device = torch.device(device)
    W, H = args.width, args.height
    cfg = vo_config(W, H, args.features, args.levels)
    K = Intrinsics.from_config(cfg.camera, device)
    world = synthetic.corridor_world(prng.prng_key(42), num=1500, length=30.0, width=5.0,
                                     device=device).landmarks
    T_gt = synthetic.straight_trajectory(args.frames, length=args.frames * 0.17, height=1.2,
                                         start_x=0.5, device=device)
    if args.export_dataset:
        export_dataset(Path(args.export_dataset), K, world, T_gt, args.frames, W, H)
        return {"exported": args.frames}
    readers = None
    n_frames = args.frames
    if args.dataset:
        readers = (PgmSequenceReader(Path(args.dataset) / "left", prefetch=8),
                   PgmSequenceReader(Path(args.dataset) / "right", prefetch=8))
        n_frames = min(n_frames, readers[0].count)
        if (readers[0].width, readers[0].height) != (W, H):
            raise ValueError("dataset resolution must match --width/--height")
    slam = StereoSlam(cfg, device)
    camera = None if readers else synthetic.SimCamera(K, world, W, H)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    src = f"dataset {args.dataset} (native prefetch)" if readers else "synthetic"
    print(f"[run_vo] {n_frames} frames @ {W}x{H}, {args.features} features, "
          f"{args.levels} pyramid levels on {where}; {src}")
    launches0 = kernel_launches()
    t0 = None
    try:
        for i in range(n_frames):
            if readers:
                left = upload(next(readers[0]), device).float()
                right = upload(next(readers[1]), device).float()
            else:
                left, right = camera.frame(lie.SE3(T_gt.R[i], T_gt.t[i]))
            if i == 1:
                t0 = time.monotonic()   # frame 0 builds the map
            info = slam.process_frame(left, right)
            if i % 5 == 0 or info["keyframe"]:
                print(f"  frame {i:4d} {'KF' if info['keyframe'] else '  '} "
                      f"inliers={info['n_inliers']:4d} lost={info['lost']}")
    finally:
        for rd in readers or ():
            rd.close()
    wall = time.monotonic() - (t0 or time.monotonic())
    gt = list(T_gt.matrix()[:n_frames].cpu().numpy().astype(np.float64))
    m = slam.map
    return {"slam": slam, "frames": n_frames, "fps": (n_frames - 1) / max(wall, 1e-9),
            "ate": ev.ate_rmse(slam.trajectory, gt),
            "ate_unaligned": ev.ate_rmse([gt[0] @ T for T in slam.trajectory], gt, align=False),
            "path_m": ev.path_length(gt), "keyframes": int(m.n_kf),
            "landmarks": int(m.n_lm), "observations": int(m.n_obs),
            "launches": {k: v - launches0[k] for k, v in kernel_launches().items()}}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    r = run(args, device_of(args))
    if "exported" in r:
        print(f"[run_vo] exported {r['exported']} stereo PGM pairs -> {args.export_dataset}")
        return 0
    print(f"\n[run_vo] keyframes={r['keyframes']} landmarks={r['landmarks']} "
          f"observations={r['observations']}")
    print(f"[run_vo] ATE RMSE = {r['ate'] * 100:.2f} cm over {r['path_m']:.1f} m "
          f"(unaligned {r['ate_unaligned'] * 100:.2f} cm)")
    print(f"[run_vo] throughput = {r['fps']:.2f} frames/s (excl. the first frame)")
    n = r["launches"]
    print(f"[run_vo] kernel launches: K1 describe {n['describe']}, K1 gather {n['gather']}, "
          f"K2 top-2 {n['top2']}, K3 sweep {n['sweep']}")
    print()
    print(r["slam"].log.summary())
    if r["ate"] > ATE_BOUND_M:
        print("[run_vo] WARNING: ATE above 20 cm bound")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
