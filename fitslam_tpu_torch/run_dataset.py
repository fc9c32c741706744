"""Run stereo SLAM over an on-disk PGM sequence through the native runtime
(the port's counterpart of the reference's ``examples/run_dataset.py``).

The camera-driver / rosbag seam closed with the native host runtime
(``csrc/runtime.cc``): a prefetching PGM reader per camera pulls frames off
disk on its own thread (never holding the GIL across IO) while the card
works on the previous frame, and a ns-resolution native event log records
each frame's ``h2d`` and ``slam_step`` spans, exported as CSV.

Usage:
    python -m fitslam_tpu_torch.run_dataset                       # committed corridor_seq
    python -m fitslam_tpu_torch.run_dataset --dataset DIR         # a recorded sequence
    python -m fitslam_tpu_torch.run_dataset --record DIR --frames 60   # record only
    python -m fitslam_tpu_torch.run_dataset --record DIR --dataset DIR --cpu

The run is on the card unless ``--cpu`` is given. ``--record`` renders the
reference's corridor world of seed 0, committed as
``tests/data/dataset_corridor_world.npz``: the reference draws that world
with ``jax.random``, whose streams torch cannot reproduce (ROADMAP F4), so
no other seed can be recorded.
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
from fitslam_tpu_torch.runtime.native import NativeEventLog, PgmSequenceReader, write_pgm
from fitslam_tpu_torch.utils import evaluation as ev
from fitslam_tpu_torch.utils.config import FitSlamConfig
from fitslam_tpu_torch.utils.transfer import upload

DEFAULT_SEQUENCE = Path(__file__).resolve().parents[1] / "tests" / "data" / "corridor_seq"
W, H = 320, 240


def dataset_config() -> FitSlamConfig:
    """The reference's run_dataset configuration (320x240, 2 levels, 512
    features, loop closing off)."""
    cfg = FitSlamConfig()
    return dataclasses.replace(
        cfg,
        camera=dataclasses.replace(cfg.camera, width=W, height=H, fx=200.0,
                                   fy=200.0, cx=W / 2, cy=H / 2, baseline=0.2),
        orb=dataclasses.replace(cfg.orb, num_features=512, num_levels=2,
                                fast_threshold=12.0),
        tracking=dataclasses.replace(cfg.tracking, min_inliers=10,
                                     keyframe_min_interval=2,
                                     keyframe_translation=0.3),
        mapping=dataclasses.replace(cfg.mapping, max_keyframes=64,
                                    max_landmarks=4096, max_observations=12288,
                                    local_window=4, ba_iters=3),
        loop=dataclasses.replace(cfg.loop, enabled=False),
    )


def record_sequence(out_dir: Path, n_frames: int, cfg: FitSlamConfig, seed: int = 0,
                    device="cuda") -> None:
    """Render a synthetic stereo corridor sequence to PGM files + GT poses
    (the rosbag-recording analog)."""
    if seed != 0:
        raise ValueError(
            f"--record renders the reference's corridor world of seed 0 only: the world "
            f"of seed {seed} is drawn by jax.random, whose streams torch cannot reproduce "
            f"(ROADMAP F4); commit that world's landmarks as an npz to record it")
    out_dir = Path(out_dir)
    K = Intrinsics.from_config(cfg.camera, device)
    world = synthetic.load_world(synthetic.DATASET_WORLD, device=device)
    T_gt = synthetic.straight_trajectory(n_frames, length=n_frames * 0.15, height=1.2,
                                         start_x=0.5, device=device)
    (out_dir / "left").mkdir(parents=True, exist_ok=True)
    (out_dir / "right").mkdir(parents=True, exist_ok=True)
    for i in range(n_frames):
        l, r = synthetic.render_stereo(K, world, lie.SE3(T_gt.R[i], T_gt.t[i]),
                                       width=cfg.camera.width, height=cfg.camera.height,
                                       max_depth=12.0)
        # renderer output is already 0..255 luminance
        write_pgm(str(out_dir / "left" / f"{i:06d}.pgm"), l.cpu().numpy())
        write_pgm(str(out_dir / "right" / f"{i:06d}.pgm"), r.cpu().numpy())
    np.save(out_dir / "gt_poses.npy", T_gt.matrix().cpu().numpy())
    print(f"[dataset] recorded {n_frames} stereo frames -> {out_dir}")


def replay(seq_dir: Path, cfg: FitSlamConfig, prefetch: int = 8, device="cuda") -> dict:
    """Replay ``seq_dir`` (``left/``, ``right/``, optional ``gt_poses.npy``)
    through ``StereoSlam.process_frame``, frames read by the native readers
    and each frame's spans in the native event log (exported to
    ``seq_dir/events.csv``). Returns the run's figures."""
    seq_dir = Path(seq_dir)
    device = torch.device(device)
    left_rd = PgmSequenceReader(seq_dir / "left", prefetch=prefetch)
    right_rd = PgmSequenceReader(seq_dir / "right", prefetch=prefetch)
    evlog = NativeEventLog()
    try:
        if (left_rd.width, left_rd.height) != (cfg.camera.width, cfg.camera.height):
            raise ValueError(f"sequence is {left_rd.width}x{left_rd.height}, the config "
                             f"{cfg.camera.width}x{cfg.camera.height}")
        slam = StereoSlam(cfg, device)
        n = min(left_rd.count, right_rd.count)
        where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        print(f"[dataset] {n} frames @ {left_rd.width}x{left_rd.height} from {seq_dir} "
              f"(native prefetch={prefetch}) on {where}")
        t0 = None
        for i, (l8, r8) in enumerate(zip(left_rd, right_rd)):
            e = evlog.begin("h2d")
            # each reader frame is a fresh array: the queued copy reads it alone
            l = upload(l8, device).float()
            r = upload(r8, device).float()
            evlog.end(e)
            e = evlog.begin("slam_step")
            slam.process_frame(l, r)
            evlog.end(e)
            if i == 0:
                t0 = time.monotonic()
        wall = time.monotonic() - (t0 or time.monotonic())
        gt_path = seq_dir / "gt_poses.npy"
        ate = (ev.ate_rmse(slam.trajectory, list(np.load(gt_path))[:n])
               if gt_path.exists() else None)
        csv_path = seq_dir / "events.csv"
        n_events = evlog.export_csv(str(csv_path))
    finally:
        left_rd.close()
        right_rd.close()
        evlog.close()
    return {"frames": n, "fps": (n - 1) / max(wall, 1e-9), "ate": ate,
            "keyframes": int(slam.map.n_kf), "events": n_events, "csv": csv_path,
            "host_syncs": slam.host_syncs}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", type=str, default="",
                    help=f"sequence directory (default: {DEFAULT_SEQUENCE})")
    ap.add_argument("--record", type=str, default="",
                    help="render the seed-0 corridor sequence into this directory first")
    ap.add_argument("--frames", type=int, default=40, help="frames to record")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--prefetch", type=int, default=8)
    return ap


def device_of(args: argparse.Namespace) -> str:
    return "cpu" if args.cpu else "cuda"


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = device_of(args)
    cfg = dataset_config()
    seq_dir = Path(args.dataset or args.record or DEFAULT_SEQUENCE)
    if args.record or not (seq_dir / "left").exists():
        record_sequence(seq_dir, args.frames, cfg, device=device)
        if args.record and not args.dataset:
            return 0
    r = replay(seq_dir, cfg, prefetch=args.prefetch, device=device)
    print(f"[dataset] throughput = {r['fps']:.2f} frames/s; keyframes = {r['keyframes']}"
          + (f"; ATE RMSE = {r['ate'] * 100:.2f} cm" if r["ate"] is not None else ""))
    print(f"[dataset] native event log: {r['events']} spans -> {r['csv']}")
    if r["ate"] is not None and r["ate"] > 0.5:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
