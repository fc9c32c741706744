"""The headline benchmark (port of the repo-level ``bench.py``): end-to-end
stereo-SLAM frames a second on one card over a synthetic corridor, with the
run's ATE and the ``loop_slam`` block of ``bench_suite`` beside it.

    python -m fitslam_tpu_torch.bench [--cpu]

Prints ONE JSON line ``{"metric", "value", "unit", "vs_baseline", "extra"}``.
The 60 frames (640x480, rendered on the card) go once through an untimed
``StereoSlam``, then twice through a fresh one by ``process_frame_async``
with no per-frame read; the clock stops on a barrier after the last frame
and the better of the two passes counts. Only then come ``finalize``, the
ATE and the loop block. The baseline is the reference's 60 frames/s (2x a 30
frames/s CPU ORB-SLAM3). Without a card and without ``--cpu`` the command
fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

W, H = 640, 480
N_FRAMES = 60
N_FEATURES = 1024
N_LEVELS = 4


def headline_config():
    """The reference's headline configuration: 640x480, 4 levels, 1024
    features, a keyframe every ~5 frames with a 6-keyframe BA window."""
    from fitslam_tpu_torch.utils.config import FitSlamConfig

    cfg = FitSlamConfig()
    return dataclasses.replace(
        cfg,
        camera=dataclasses.replace(cfg.camera, width=W, height=H, fx=0.625 * W, fy=0.625 * W,
                                   cx=W / 2, cy=H / 2, baseline=0.2),
        orb=dataclasses.replace(cfg.orb, num_features=N_FEATURES, num_levels=N_LEVELS,
                                fast_threshold=12.0),
        tracking=dataclasses.replace(cfg.tracking, min_inliers=12, keyframe_min_interval=2,
                                     keyframe_translation=0.75),
        mapping=dataclasses.replace(cfg.mapping, max_keyframes=64, max_landmarks=8192,
                                    max_observations=32768, local_window=6, ba_iters=3),
    )


def headline_world(device="cuda"):
    """The corridor's landmarks: ``jax.random.PRNGKey(42)``'s draw, bit for bit."""
    from fitslam_tpu_torch.data import synthetic
    from fitslam_tpu_torch.utils import prng

    return synthetic.corridor_world(prng.prng_key(42), num=3000, length=40.0, width=5.0,
                                    device=device).landmarks


def headline_frames(cfg, device="cuda", n_frames: int = N_FRAMES):
    """The corridor's first ``n_frames`` stereo pairs along the straight
    trajectory (0.15 m a frame, 1.2 m high), rendered on ``device``, and
    their ground-truth camera poses as float64 4x4 matrices."""
    from fitslam_tpu_torch.bench_suite import _gt_matrices
    from fitslam_tpu_torch.data import synthetic
    from fitslam_tpu_torch.ops import lie
    from fitslam_tpu_torch.ops.geometry import Intrinsics

    K = Intrinsics.from_config(cfg.camera, device)
    world = headline_world(device)
    T_gt = synthetic.straight_trajectory(n_frames, length=n_frames * 0.15, height=1.2,
                                         start_x=0.5, device=device)
    frames = [synthetic.render_stereo(K, world, lie.SE3(T_gt.R[i], T_gt.t[i]),
                                      width=cfg.camera.width, height=cfg.camera.height)
              for i in range(n_frames)]
    return frames, _gt_matrices(T_gt)


def timed_pass(slam, frames, device) -> float:
    """``frames`` through ``slam`` (a fresh StereoSlam) by
    ``process_frame_async`` with no per-frame read: frames a second from
    frame 1 on, the clock stopped on a barrier after the last frame."""
    from fitslam_tpu_torch.bench_suite import clock

    slam.process_frame_async(*frames[0])
    t0 = clock(device)
    for pair in frames[1:]:
        slam.process_frame_async(*pair)
    return (len(frames) - 1) / (clock(device) - t0)


def measure(cfg=None, device="cuda", n_frames: int = N_FRAMES) -> dict:
    """The headline record. ``cfg`` defaults to ``headline_config()``; the
    loop block is ``bench_suite.bench_loop_slam`` at full width over 150
    ring frames and seeds 1-3."""
    from fitslam_tpu_torch import bench_suite
    from fitslam_tpu_torch.models.slam import StereoSlam
    from fitslam_tpu_torch.utils import evaluation as ev

    dev = bench_suite.resolve_device(device)
    cfg = cfg or headline_config()
    frames, gt = headline_frames(cfg, dev, n_frames)
    timed_pass(StereoSlam(cfg, dev), frames, dev)    # untimed: first calls of every path
    fps = 0.0
    for _rep in range(2):
        slam = StereoSlam(cfg, dev)
        fps = max(fps, timed_pass(slam, frames, dev))
    slam.finalize()
    ate = ev.ate_rmse(slam.trajectory, gt)
    loop = bench_suite.bench_loop_slam(small=False, n_frames=150, as_dict=True, device=dev)
    rec = {
        "metric": "stereo_slam_frames_per_s_per_chip",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / bench_suite.BASELINE_FPS, 3),
        "extra": bench_suite._tagged({
            "ate_rmse_m": round(ate, 4),
            "n_keyframes": int(slam.map.n_kf),
            "n_landmarks": int(slam.map.n_lm),
            "resolution": f"{cfg.camera.width}x{cfg.camera.height}",
            "features": cfg.orb.num_features,
            "levels": cfg.orb.num_levels,
            "loop_slam": {"frames_per_s_per_chip": round(loop["value"], 3),
                          **loop["extra"]},
        }, dev),
    }
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Stereo-SLAM frames/s on one card, with ATE.")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("[bench] no CUDA device: the bench runs on the card (--cpu for the CPU)",
              file=sys.stderr)
        return 1
    print(json.dumps(measure(device="cpu" if args.cpu else "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
