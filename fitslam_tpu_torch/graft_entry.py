"""The flagship frame step as one function with example arguments, and the
multi-device dry run (port of the repo-level ``__graft_entry__.py``).

``entry(device)`` returns ``(step, (left, right, m, state))``: ``step`` is the
stereo-SLAM frame step at 320x240, 512 features and 2 levels (ORB on both
eyes, stereo matching, landmark association and the motion-only pose solve),
and the arguments are one rendered stereo pair of the corridor world of seed
0 and a map holding one keyframe of it. On the card a call of ``step``
launches K1's fused describe twice (once an eye) and K2.
``dryrun_multichip(n)`` runs ``parallel/dryrun.dryrun(n)``.
"""

from __future__ import annotations

import torch


def entry(device="cuda"):
    """(step, (img_left, img_right, map, track_state)) on ``device``;
    ``step(*args)`` returns (T_cw as a 4x4 matrix, lm_match (N,), inliers)."""
    from fitslam_tpu_torch.models import slam_map as sm
    from fitslam_tpu_torch.models import tracking as tr
    from fitslam_tpu_torch.ops import lie
    from fitslam_tpu_torch.parallel.dryrun import small_setup

    dev = torch.device(device)
    cfg, K, left, right = small_setup(320, 240, dev)
    o = cfg.orb
    kw = dict(num_features=o.num_features, num_levels=o.num_levels,
              scale_factor=o.scale_factor, fast_threshold=o.fast_threshold)

    # a small map of one keyframe, so that tracking has landmarks to match
    frame0 = tr.process_stereo(K, left, right, **kw)
    m = sm.empty_map(8, 2048, 4096, device=dev)
    m = sm.insert_keyframe(m, K, lie.SE3.identity(device=dev), frame0.feats, frame0.depth,
                           -torch.ones((o.num_features,), dtype=torch.int32, device=dev),
                           torch.tensor(0, dtype=torch.int32, device=dev),
                           torch.zeros((256,), device=dev))
    state = tr.mark_keyframe(tr.init_track_state(dev), torch.tensor(0, dtype=torch.int32,
                                                                    device=dev))

    def step(img_left, img_right, m, state):
        frame = tr.process_stereo(K, img_left, img_right, **kw)
        new_state, lm_match, n_inl = tr.track_frame(K, m, state, frame, width=cfg.camera.width,
                                                    height=cfg.camera.height)
        return new_state.T_cw.matrix(), lm_match, n_inl

    return step, (left, right, m, state)


def dryrun_multichip(n_devices: int, device="cuda:0"):
    """The multi-device step on ``n_devices`` ranks (``parallel/dryrun``):
    every rank on card 0 over gloo by default; ``device="cpu"`` for the CPU."""
    from fitslam_tpu_torch.parallel import dryrun

    return dryrun.dryrun(n_devices, device=device)
