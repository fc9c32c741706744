"""The port's counterpart of ``tests/test_async_polling.py``: keyframe-event
polling of the asynchronous frame path fires callbacks with the right frame
ids across two ``finalize`` epochs, a poll with nothing new is empty, and
pipelined polls (``flush=False``) deliver the blocking polls' events; on the
CPU with the reference's assertions. The world is ``jax.random``'s draw,
bit for bit, through ``utils/prng.py``."""

import dataclasses

import torch

from fitslam_tpu_torch.data import synthetic
from fitslam_tpu_torch.models.slam import StereoSlam
from fitslam_tpu_torch.ops import lie
from fitslam_tpu_torch.ops.geometry import Intrinsics
from fitslam_tpu_torch.utils import prng
from fitslam_tpu_torch.utils.config import FitSlamConfig

# several pytest-xdist workers share the machine
torch.set_num_threads(2)

CPU = "cpu"
W, H = 160, 120


def _setup(n_frames):
    cfg = FitSlamConfig()
    cfg = dataclasses.replace(
        cfg,
        camera=dataclasses.replace(cfg.camera, width=W, height=H, fx=0.625 * W, fy=0.625 * W,
                                   cx=W / 2, cy=H / 2, baseline=0.2),
        orb=dataclasses.replace(cfg.orb, num_features=192, num_levels=2, fast_threshold=12.0),
        tracking=dataclasses.replace(cfg.tracking, min_inliers=8, keyframe_min_interval=1,
                                     keyframe_translation=0.2),
        mapping=dataclasses.replace(cfg.mapping, max_keyframes=32, max_landmarks=2048,
                                    max_observations=4096, local_window=3, ba_iters=2),
        loop=dataclasses.replace(cfg.loop, enabled=False),
    )
    K = Intrinsics.from_config(cfg.camera, CPU)
    world = synthetic.corridor_world(prng.prng_key(0), num=1500, length=18.0, width=5.0,
                                     device=CPU).landmarks
    T = synthetic.straight_trajectory(n_frames, length=n_frames * 0.12, height=1.2,
                                      start_x=0.5, device=CPU)
    frames = [synthetic.render_stereo(K, world, lie.SE3(T.R[i], T.t[i]), width=W, height=H)
              for i in range(n_frames)]
    return cfg, frames


def test_poll_event_frame_ids_survive_finalize():
    cfg, frames = _setup(12)
    slam = StereoSlam(cfg, CPU)
    seen = []   # (frame_id_at_callback, kf_idx)
    slam.keyframe_events.append(lambda s, kf: seen.append((s.last_keyframe_frame_id, kf)))

    for i in range(6):
        slam.process_frame_async(*frames[i])
    ev1 = slam.poll_keyframe_events()
    slam.finalize()                      # resets outs_log; frame ids continue
    for i in range(6, 12):
        slam.process_frame_async(*frames[i])
    ev2 = slam.poll_keyframe_events()

    events = ev1 + ev2
    assert events, "no keyframes at this cadence?"
    fids = [e["frame_id"] for e in events]
    # frame ids increase over both finalize epochs
    assert fids == sorted(fids)
    assert fids[0] < 6
    assert any(f >= 6 for f in fids), "post-finalize events lost frame ids"
    assert all(0 <= f < 12 for f in fids)
    # the callbacks saw the ids the events report
    assert [s for s, _ in seen] == fids
    # keyframe indices are the map's insertion order
    kfs = [e["kf_idx"] for e in events]
    assert kfs == sorted(kfs)
    assert int(slam.map.n_kf) == kfs[-1] + 1


def test_poll_is_idempotent_between_frames():
    cfg, frames = _setup(5)
    slam = StereoSlam(cfg, CPU)
    for i in range(5):
        slam.process_frame_async(*frames[i])
    ev = slam.poll_keyframe_events()
    assert slam.poll_keyframe_events() == []   # nothing new -> no events
    st = slam.finalize()
    # finalize's keyframe list agrees with the polled events
    assert len(st["keyframes"]) == len(ev)


def test_pipelined_poll_delivers_same_events():
    """flush=False (pipelined polls) delivers the blocking polls' event
    stream: each window one poll later, everything flushed by the final
    blocking poll."""
    cfg, frames = _setup(12)

    def collect(flush):
        slam = StereoSlam(cfg, CPU)
        evs = []
        for i, f in enumerate(frames):
            slam.process_frame_async(*f)
            if i % 3 == 2:
                evs += slam.poll_keyframe_events(flush=flush)
        evs += slam.poll_keyframe_events()   # final drain (blocking)
        slam.finalize()
        return [(e["frame_id"], e["kf_idx"]) for e in evs]

    blocking = collect(True)
    pipelined = collect(False)
    assert blocking == pipelined
    assert blocking, "no keyframes at this cadence?"


def test_pipelined_poll_pending_flushed_by_finalize():
    """A window still in flight when finalize() runs is not lost."""
    cfg, frames = _setup(8)
    slam = StereoSlam(cfg, CPU)
    seen = []
    slam.keyframe_events.append(lambda s, kf: seen.append((s.last_keyframe_frame_id, kf)))
    for i, f in enumerate(frames):
        slam.process_frame_async(*f)
        if i % 3 == 2:
            slam.poll_keyframe_events(flush=False)
    # no final blocking poll: finalize flushes the pending window
    slam.finalize()
    n_after_finalize = len(seen)
    assert n_after_finalize > 0, "pending window lost by finalize"
